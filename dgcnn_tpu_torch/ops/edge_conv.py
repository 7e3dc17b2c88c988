"""Factorized EdgeConv (port of dgcnn_tpu/ops/edge_conv.py).

The reference EdgeConv runs a 1x1 conv over the ``(B, 2C, N, k)`` edge
tensor ``concat(x_j, x_i)``.  It factors as

    conv1x1(concat(x_j, x_i)) = x_j @ W_nbr + x_i @ W_ctr

and because an affine map followed by max over k satisfies
``max_j (s*z + t) = s * (s > 0 ? max_j z : min_j z) + t`` (and LeakyReLU is
monotone), BN + LeakyReLU + max reduces to the max/min of the gathered
``a = x @ W_nbr``.  For a reference Conv2d weight W (Co, 2C, 1, 1):
``W_nbr = W[:, :C].T``, ``W_ctr = W[:, C:].T`` (concat order [neighbour,
centre]).
"""
from __future__ import annotations

import torch

from dgcnn_tpu_torch.ops.graph import gather_neighbors


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, N, C) @ (C, Co) in f32."""
    return torch.matmul(x.float(), w.float())


def edge_linear(x, idx, w_nbr, w_ctr) -> torch.Tensor:
    """Per-edge pre-activation ``conv1x1(concat(x_j, x_i))`` without the
    concat: (B, N, k, Co)."""
    a_g = gather_neighbors(_project(x, w_nbr), idx)
    return a_g + _project(x, w_ctr)[:, :, None]


def edge_conv_batch_stats(x, idx, w_nbr, w_ctr):
    """Per-channel (mean, biased var) of the virtual edge tensor
    ``a[idx] + b`` over (B, N, k), the training BatchNorm statistics,
    without building it: its cross moment factors through the per-point
    mean over k of the gathered ``a``."""
    a = _project(x, w_nbr)
    b = _project(x, w_ctr)
    a_g = gather_neighbors(a, idx)
    mean = a_g.mean(dim=(0, 1, 2)) + b.mean(dim=(0, 1))
    e_ag2 = a_g.square().mean(dim=(0, 1, 2))
    e_b2 = b.square().mean(dim=(0, 1))
    e_ab = (a_g.mean(dim=2) * b).mean(dim=(0, 1))
    var = e_ag2 + 2.0 * e_ab + e_b2 - mean.square()
    return mean, var.clamp(min=0.0)


def edge_stats_from_sums(asum, asumsq, b, k: int):
    """The same (mean, biased var) from the neighbour sums that the
    training kernels return: ``asum``/``asumsq`` (B, N, Co), the sum and
    sum of squares of the k gathered rows of ``a``, and ``b`` (B, N, Co),
    the centre term."""
    mean = asum.mean(dim=(0, 1)) / k + b.mean(dim=(0, 1))
    e_ag2 = asumsq.mean(dim=(0, 1)) / k
    e_ab = (asum / k * b).mean(dim=(0, 1))
    e_b2 = b.square().mean(dim=(0, 1))
    var = e_ag2 + 2 * e_ab + e_b2 - mean.square()
    return mean, var.clamp(min=0.0)


def edge_conv_fused(x, idx, w_nbr, w_ctr, scale, bias,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """Conv + folded-BN affine + LeakyReLU + max over k -> (B, N, Co)."""
    a = _project(x, w_nbr)
    b = _project(x, w_ctr)
    a_g = gather_neighbors(a, idx)
    a_max = a_g.amax(dim=2)
    a_min = a_g.amin(dim=2)
    sel = torch.where(scale > 0, a_max, a_min) + b
    y = sel * scale + bias
    return torch.where(y >= 0, y, negative_slope * y)


def edge_conv_naive(x, idx, w_nbr, w_ctr, scale, bias,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """Reference-shaped version that builds every edge, for tests."""
    y = edge_linear(x, idx, w_nbr, w_ctr) * scale + bias
    return torch.where(y >= 0, y, negative_slope * y).amax(dim=2)


def fold_bn(gamma, beta, mean, var, eps: float):
    """BatchNorm parameters -> per-channel affine (scale, bias)."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale
