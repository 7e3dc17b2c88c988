"""Models in the reference state-dict layout."""
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNNCls,
    DGCNNPartSeg,
    DGCNNSemSeg,
    PointNet,
    TransformNet,
    init_like_flax_,
    init_random_,
)

__all__ = ["DGCNNCls", "DGCNNPartSeg", "DGCNNSemSeg", "PointNet",
           "TransformNet", "init_like_flax_", "init_random_"]
