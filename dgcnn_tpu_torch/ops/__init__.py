"""Graph ops (plain torch) and the CUDA kernels of the eval path."""
from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool, conv_pool_plain
from dgcnn_tpu_torch.ops.edge_conv import (
    edge_conv_fused,
    edge_conv_naive,
    fold_bn,
)
from dgcnn_tpu_torch.ops.edge_conv_kernel import (
    edge_conv_eval,
    edge_conv_eval_plain,
)
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import knn, pairwise_neg_sqdist
from dgcnn_tpu_torch.ops.pool import global_max, global_mean

__all__ = [
    "conv_pool",
    "conv_pool_plain",
    "edge_conv_eval",
    "edge_conv_eval_plain",
    "edge_conv_fused",
    "edge_conv_naive",
    "fold_bn",
    "gather_neighbors",
    "global_max",
    "global_mean",
    "knn",
    "pairwise_neg_sqdist",
]
