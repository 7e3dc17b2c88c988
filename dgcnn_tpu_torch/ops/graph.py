"""Neighbour gathering (port of dgcnn_tpu/ops/graph.py)."""
from __future__ import annotations

import torch


def gather_neighbors(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features, (B, M, k) indices -> (B, M, k, C)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k, 1).expand(b, m * k, feat.shape[-1])
    return torch.gather(feat, 1, flat).reshape(b, m, k, feat.shape[-1])
