"""Models (eval mode) in the reference state-dict layout."""
from dgcnn_tpu_torch.models.dgcnn import DGCNNCls, PointNet, init_random_

__all__ = ["DGCNNCls", "PointNet", "init_random_"]
