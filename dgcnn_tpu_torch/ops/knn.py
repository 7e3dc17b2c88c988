"""k-nearest-neighbour graph construction (port of dgcnn_tpu/ops/knn.py).

The score is the negative squared euclidean distance
``2<xi,xj> - |xi|^2 - |xj|^2`` in f32, and the k highest-scoring columns of
each row are its neighbours, self first.  Ties go to the lowest index, as
``lax.top_k`` and ``torch.topk`` order them on the reference path; a stable
descending sort makes that order explicit instead of relying on
``torch.topk``'s unspecified tie order.
"""
from __future__ import annotations

import torch


def pairwise_neg_sqdist(x: torch.Tensor,
                        y: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B, N, M) scores, -||x_i - y_j||^2 up to
    rounding, computed in f32."""
    if y is None:
        y = x
    x = x.float()
    y = y.float()
    inner = torch.bmm(x, y.transpose(1, 2))
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    return 2.0 * inner - xx[:, :, None] - yy[:, None, :]


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, k) int64 neighbour indices, nearest (self)
    first, lowest index first among equal scores."""
    scores = pairwise_neg_sqdist(x)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k]
