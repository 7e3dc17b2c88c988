"""Global pooling over the point axis (port of dgcnn_tpu/ops/pool.py;
point sharding is not ported)."""
from __future__ import annotations

import torch


def global_max(h: torch.Tensor, axis: int = 1,
               keepdims: bool = False) -> torch.Tensor:
    return h.amax(dim=axis, keepdim=keepdims)


def global_mean(h: torch.Tensor, axis: int = 1,
                keepdims: bool = False) -> torch.Tensor:
    return h.mean(dim=axis, keepdim=keepdims)
