"""Models in the reference state-dict layout."""
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNCls,
    DGCNNPartSeg,
    DGCNNSemSeg,
    PointNet,
    PositionEmbedding,
    TransformNet,
    init_like_flax_,
    init_random_,
)
from dgcnn_tpu_torch.models.model_partseg import MLPHead, Net
from dgcnn_tpu_torch.models.torch_transformer import (
    TorchMultiheadAttention,
    TorchTransformer,
)

__all__ = ["DGCNN", "DGCNNCls", "DGCNNPartSeg", "DGCNNSemSeg", "MLPHead",
           "Net", "PointNet", "PositionEmbedding", "TorchMultiheadAttention",
           "TorchTransformer", "TransformNet", "init_like_flax_",
           "init_random_"]
