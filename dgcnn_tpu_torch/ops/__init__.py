"""Graph ops (plain torch) and the CUDA kernels of the eval and training
paths."""
from dgcnn_tpu_torch.ops.attention import (
    FusedAttention,
    attention_bwd,
    attention_bwd_plain,
    attention_fwd,
    attention_plain,
    dropout_mask,
    dropout_mask_plain,
    fused_attention,
)
from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool, conv_pool_plain
from dgcnn_tpu_torch.ops.edge_conv import (
    edge_conv_batch_stats,
    edge_conv_fused,
    edge_conv_naive,
    edge_linear,
    fold_bn,
)
from dgcnn_tpu_torch.ops.edge2_kernel import (
    edge2_z2,
    knn_edge2,
    knn_edge2_plain,
)
from dgcnn_tpu_torch.ops.edge2_reduce import Edge2Reduce, edge2_reduce
from dgcnn_tpu_torch.ops.edge2_reduce_kernel import (
    edge2_bwd,
    edge2_bwd_plain,
    edge2_fwd,
    edge2_fwd_plain,
)
from dgcnn_tpu_torch.ops.edge_conv_kernel import (
    edge_conv_eval,
    edge_conv_eval_plain,
)
from dgcnn_tpu_torch.ops.edge_sum_kernel import edge_sum, edge_sum_plain
from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import (
    edge_reduce_bwd,
    edge_reduce_bwd_plain,
)
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import knn, pairwise_neg_sqdist, use_kernel
from dgcnn_tpu_torch.ops.knn_edge_reduce import (
    KnnEdgeReduce,
    KnnEdgeReduceXW,
    knn_edge_reduce,
    knn_edge_reduce_xw,
)
from dgcnn_tpu_torch.ops.knn_reduce_kernel import (
    knn_reduce,
    knn_reduce_plain,
    knn_reduce_xw,
    knn_reduce_xw_plain,
    xw_project,
)
from dgcnn_tpu_torch.ops.knn_sum_kernel import knn_sum, knn_sum_plain
from dgcnn_tpu_torch.ops.pool import global_max, global_mean

__all__ = [
    "Edge2Reduce",
    "FusedAttention",
    "KnnEdgeReduce",
    "KnnEdgeReduceXW",
    "attention_bwd",
    "attention_bwd_plain",
    "attention_fwd",
    "attention_plain",
    "conv_pool",
    "conv_pool_plain",
    "dropout_mask",
    "dropout_mask_plain",
    "edge2_bwd",
    "edge2_bwd_plain",
    "edge2_fwd",
    "edge2_fwd_plain",
    "edge2_reduce",
    "edge2_z2",
    "edge_conv_batch_stats",
    "edge_conv_eval",
    "edge_conv_eval_plain",
    "edge_conv_fused",
    "edge_conv_naive",
    "edge_linear",
    "edge_reduce_bwd",
    "edge_reduce_bwd_plain",
    "edge_sum",
    "edge_sum_plain",
    "fold_bn",
    "fused_attention",
    "gather_neighbors",
    "global_max",
    "global_mean",
    "knn",
    "knn_edge2",
    "knn_edge2_plain",
    "knn_edge_reduce",
    "knn_edge_reduce_xw",
    "knn_reduce",
    "knn_reduce_plain",
    "knn_reduce_xw",
    "knn_reduce_xw_plain",
    "knn_sum",
    "knn_sum_plain",
    "pairwise_neg_sqdist",
    "use_kernel",
    "xw_project",
]
