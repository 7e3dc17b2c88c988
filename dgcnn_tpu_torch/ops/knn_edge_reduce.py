"""Differentiable kNN + neighbour reductions of the training path (port of
the ``custom_vjp``s ``knn_edge_reduce`` and ``knn_edge_reduce_xw`` of
dgcnn_tpu/ops/pallas_knn.py, exact f32 mode).

The forward is kernel 3 (``knn_reduce``) or 4 (``knn_reduce_xw``), the
backward kernel 5 (``edge_reduce_bwd``); for CPU tensors each wrapper runs
its plain version.  The graph gets no gradient through the neighbour
selection (``None``, as torch.topk's indices have none), and neither do
the indices.
"""
from __future__ import annotations

import torch

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
    """(graph, a, k) -> (idx, amax, amin, asum, asumsq); gradient to
    ``a`` only."""

    @staticmethod
    def forward(ctx, graph, a, k: int):
        out = knn_reduce(graph, a, k)
        idx, amax, amin = out[:3]
        ctx.save_for_backward(idx, a, amax, amin)
        ctx.mark_non_differentiable(idx)
        return out

    @staticmethod
    def backward(ctx, _, *grads):
        idx, a, amax, amin = ctx.saved_tensors
        return None, edge_reduce_bwd(idx, a, amax, amin, *_cts(grads)), None


class KnnEdgeReduceXW(torch.autograd.Function):
    """(graph, x, w, k) -> the outputs of ``KnnEdgeReduce`` over
    ``a = x @ w``, with the projection inside the forward's launch.  The
    backward recomputes ``a`` through the forward's own projection routine
    (``xw_project``) and chains kernel 5 through it:
    ``dx = da @ w.T``, ``dw = x.T @ da``."""

    @staticmethod
    def forward(ctx, graph, x, w, k: int):
        out = knn_reduce_xw(graph, x, w, k)
        idx, amax, amin = out[:3]
        ctx.save_for_backward(x, w, idx, amax, amin)
        ctx.mark_non_differentiable(idx)
        return out

    @staticmethod
    def backward(ctx, _, *grads):
        x, w, idx, amax, amin = ctx.saved_tensors
        da = edge_reduce_bwd(idx, xw_project(x, w), amax, amin, *_cts(grads))
        dx = torch.matmul(da, w.t())
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          da.reshape(-1, da.shape[-1]))
        return None, dx, dw, None


def knn_edge_reduce(graph: torch.Tensor, a: torch.Tensor, k: int):
    """Differentiable (idx, amax, amin, asum, asumsq) of kNN over ``graph``
    and the k neighbours of ``a``."""
    return KnnEdgeReduce.apply(graph, a, k)


def knn_edge_reduce_xw(graph: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                       k: int):
    """``knn_edge_reduce(graph, x @ w, k)`` in the select-x form."""
    return KnnEdgeReduceXW.apply(graph, x, w, k)
