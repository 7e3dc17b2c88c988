"""Neighbour gathering and edge features (port of dgcnn_tpu/ops/graph.py;
point sharding is not ported).

Modes of the reference ``get_graph_feature``:
  * default:    concat(neighbour feature, centre feature) -> (B, N, k, 2C)
  * knn_only:   neighbour features only                   -> (B, N, k, C)
  * disp_only:  neighbour feature - centre feature        -> (B, N, k, C)

The concat order [neighbour, centre] is the reference's
``torch.cat((feature, x), dim=3)``.
"""
from __future__ import annotations

import torch

from dgcnn_tpu_torch.ops.knn import knn


def gather_neighbors(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features, (B, M, k) indices -> (B, M, k, C)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k, 1).expand(b, m * k, feat.shape[-1])
    return torch.gather(feat, 1, flat).reshape(b, m, k, feat.shape[-1])


def edge_features(feat: torch.Tensor, idx: torch.Tensor, *,
                  knn_only: bool = False,
                  disp_only: bool = False) -> torch.Tensor:
    """Edge features from precomputed neighbour indices (B, N, k)."""
    nbr = gather_neighbors(feat, idx.long())
    if knn_only:
        return nbr
    centre = feat[:, :, None, :]
    if disp_only:
        return nbr - centre
    return torch.cat([nbr, centre.expand_as(nbr)], dim=-1)


def get_graph_feature(x: torch.Tensor, k: int = 20, *,
                      knn_only: bool = False, disp_only: bool = False,
                      idx: torch.Tensor | None = None) -> torch.Tensor:
    """kNN of ``x`` (B, N, C) (``ops.knn.knn``: kernel 11 on CUDA tensors,
    its plain version on CPU ones), or the ``idx`` given, then the edge
    features: (B, N, k, 2C) by default."""
    if idx is None:
        idx = knn(x, k)
    return edge_features(x, idx, knn_only=knn_only, disp_only=disp_only)
