"""Differentiable kNN + neighbour reductions of the training path (port of
the ``custom_vjp``s ``knn_edge_reduce`` and ``knn_edge_reduce_xw`` of
dgcnn_tpu/ops/pallas_knn.py, in the exact f32 mode or, with ``amp``, the
AMP one).

The forward is kernel 3 (``knn_reduce``) or 4 (``knn_reduce_xw``), the
backward kernel 5 (``edge_reduce_bwd``), each in the one mode; for CPU
tensors each wrapper runs its plain version.  The graph gets no gradient
through the neighbour selection (``None``, as torch.topk's indices have
none), and neither do the indices.

The AMP select-x backward differs from the JAX package's on purpose.  The
TPU kernel 4 reduces ``bf16(bf16(x)[idx] @ w)`` and its backward
(``_ker_xw_bwd``, pallas_knn.py:809-823) recomputes ``a = x @ w`` from
the f32 x, so where the two round apart kernel 5 finds no selected value
equal to amax (or amin) and drops that cotangent.  Here the backward
recomputes the values the forward reduced, ``round_bf16(xw_project(
round_bf16(x), w))``, with the forward's own projection, and every max
and min finds its match; ``dx`` and ``dw`` stay on the f32 x.
"""
from __future__ import annotations

import torch

from dgcnn_tpu_torch.ops.amp_select import round_bf16
from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import edge_reduce_bwd
from dgcnn_tpu_torch.ops.knn_reduce_kernel import (
    knn_reduce,
    knn_reduce_xw,
    xw_project,
)


def _cts(grads):
    """The cotangents of (amax, amin, asum, asumsq), made contiguous for
    the kernel."""
    return tuple(g.contiguous() for g in grads)


class KnnEdgeReduce(torch.autograd.Function):
    """(graph, a, k, amp) -> (idx, amax, amin, asum, asumsq); gradient to
    ``a`` only."""

    @staticmethod
    def forward(ctx, graph, a, k: int, amp: bool = False):
        out = knn_reduce(graph, a, k, amp=amp)
        idx, amax, amin = out[:3]
        ctx.save_for_backward(idx, a, amax, amin)
        ctx.mark_non_differentiable(idx)
        ctx.amp = amp
        return out

    @staticmethod
    def backward(ctx, _, *grads):
        idx, a, amax, amin = ctx.saved_tensors
        da = edge_reduce_bwd(idx, a, amax, amin, *_cts(grads), amp=ctx.amp)
        return None, da, None, None


class KnnEdgeReduceXW(torch.autograd.Function):
    """(graph, x, w, k, amp) -> the outputs of ``KnnEdgeReduce`` over
    ``a = x @ w``, with the projection inside the forward's launch.  The
    backward recomputes the values the forward reduced through its own
    projection routine (``xw_project``; AMP: ``round_bf16(xw_project(
    round_bf16(x), w))``, module docstring) and chains kernel 5 through
    it: ``dx = da @ w.T``, ``dw = x.T @ da`` on the f32 x."""

    @staticmethod
    def forward(ctx, graph, x, w, k: int, amp: bool = False):
        out = knn_reduce_xw(graph, x, w, k, amp=amp)
        idx, amax, amin = out[:3]
        ctx.save_for_backward(x, w, idx, amax, amin)
        ctx.mark_non_differentiable(idx)
        ctx.amp = amp
        return out

    @staticmethod
    def backward(ctx, _, *grads):
        x, w, idx, amax, amin = ctx.saved_tensors
        a = (round_bf16(xw_project(round_bf16(x), w)) if ctx.amp
             else xw_project(x, w))
        da = edge_reduce_bwd(idx, a, amax, amin, *_cts(grads), amp=ctx.amp)
        dx = torch.matmul(da, w.t())
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          da.reshape(-1, da.shape[-1]))
        return None, dx, dw, None, None


def knn_edge_reduce(graph: torch.Tensor, a: torch.Tensor, k: int,
                    amp: bool = False):
    """Differentiable (idx, amax, amin, asum, asumsq) of kNN over ``graph``
    and the k neighbours of ``a``; ``amp``: kernels 3 and 5 in their AMP
    forms."""
    return KnnEdgeReduce.apply(graph, a, k, amp)


def knn_edge_reduce_xw(graph: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                       k: int, amp: bool = False):
    """``knn_edge_reduce(graph, x @ w, k, amp)`` in the select-x form."""
    return KnnEdgeReduceXW.apply(graph, x, w, k, amp)
