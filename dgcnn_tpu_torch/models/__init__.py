"""Models in the reference state-dict layout."""
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNNCls,
    DGCNNSemSeg,
    PointNet,
    init_like_flax_,
    init_random_,
)

__all__ = ["DGCNNCls", "DGCNNSemSeg", "PointNet", "init_like_flax_",
           "init_random_"]
