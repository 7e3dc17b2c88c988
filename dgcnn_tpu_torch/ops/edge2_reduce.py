"""Differentiable neighbour reductions of the training two-conv EdgeConv
block (port of the ``custom_vjp`` ``_edge2_reduce`` of
dgcnn_tpu/ops/pallas_knn.py, in its exact f32 mode or, with ``amp``, its
AMP one).

The forward is kernel 7 (``edge2_fwd``), the backward kernel 8
(``edge2_bwd``); for CPU tensors each wrapper runs its plain version.  The
indices take no gradient.  In the AMP mode the forward's route
(``amp_route``) is saved and handed to the backward, which takes the same
one: its tie tests compare its z2 with the forward's max and min, bit for
bit, and raise if the two routes' z2 come from other arithmetic.
"""
from __future__ import annotations

import torch

from dgcnn_tpu_torch.ops.edge2_reduce_kernel import (
    SIMT,
    amp_route,
    edge2_bwd,
    edge2_fwd,
)


class Edge2Reduce(torch.autograd.Function):
    """(a1, b1, s1, t1, w2, idx, slope, amp) -> (max, min, sum, sum of
    squares) over the k neighbours of ``LReLU((a1[idx] + b1) * s1 + t1) @
    w2`` (``amp``: a1's rows rounded to bf16 in both kernels); gradients to
    a1, b1, s1, t1 and w2."""

    @staticmethod
    def forward(ctx, a1, b1, s1, t1, w2, idx, slope: float,
                amp: bool = False):
        out = edge2_fwd(a1, b1, s1, t1, w2, idx, slope, amp=amp)
        ctx.save_for_backward(a1, b1, s1, t1, w2, idx, out[0], out[1])
        ctx.slope = slope
        ctx.amp = amp
        ctx.route = (amp_route(a1.shape[-1], w2.shape[-1], idx.shape[-1])
                     if amp else None)
        return out

    @staticmethod
    def backward(ctx, *grads):
        cts = tuple(g.contiguous() for g in grads)
        grads_in = edge2_bwd(*ctx.saved_tensors, *cts, ctx.slope,
                             amp=ctx.amp, simt=ctx.route == SIMT,
                             fwd_route=ctx.route)
        return (*grads_in, None, None, None)


def edge2_reduce(a1: torch.Tensor, b1: torch.Tensor, s1: torch.Tensor,
                 t1: torch.Tensor, w2: torch.Tensor, idx: torch.Tensor,
                 slope: float = 0.2, amp: bool = False):
    """Differentiable (max, min, sum, sum of squares), each (B, N, C2);
    ``amp``: kernels 7 and 8 in their AMP forms."""
    return Edge2Reduce.apply(a1, b1, s1, t1, w2, idx, slope, amp)
