"""Kernel 5: the backward of the four neighbour reductions of kernels 3
and 4, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::edge_reduce_bwd`` (body
``_edge_reduce_bwd_kernel``) in its exact f32 mode.  The kernel is
``csrc/edge_reduce_bwd.cu``.  Its bound on an H100 is bytes: idx, a, amax,
amin and the four cotangents read once, da written once (~0.16 ms over the
four DGCNNCls training stages at B=32).  Two routes, decided from N before
the launch:

- N <= 16384 (every model: ``ops/knn.py::use_kernel`` stops at 4096), the
  slices route: a block takes one cloud and CS channels (16 at N = 1024, 8
  at 2048, 4 at 4096), holds that slice of ``a`` and of ``da`` in shared
  memory, counts each (row, channel)'s ties there and adds every edge's
  cotangent into the ``da`` slice with shared-memory atomics, then writes
  the slice once.  No global atomic.
- larger N, the atomic route: a warp a row, one global f32 atomicAdd per
  (row, neighbour, channel) into ``da``.

Either way the adds land in an order that changes from run to run, so
``da``'s last bits do too; they are exact where every addend is an integer.
The kernel writes every element of ``da``.  ``edge_reduce_bwd_plain``
beside it is the same function in plain torch with the semantics of
``_ker_bwd_xla``: autograd through the gather and the reductions, ties of
max and min splitting their cotangent evenly.  The wrapper runs it for CPU
tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.graph import gather_neighbors

MAX_CO = 256


def edge_reduce_bwd_plain(idx, a, amax, amin, ct_max, ct_min, ct_sum,
                          ct_sumsq) -> torch.Tensor:
    """Plain torch version of the kernel: ``da`` (B, N, Co).  ``amax`` and
    ``amin`` are not read: the gather recomputes them."""
    del amax, amin
    with torch.enable_grad():
        a = a.detach().requires_grad_(True)
        ag = gather_neighbors(a, idx.long())
        outs = (ag.amax(dim=2), ag.amin(dim=2), ag.sum(dim=2),
                ag.square().sum(dim=2))
        (da,) = torch.autograd.grad(outs, a,
                                    (ct_max, ct_min, ct_sum, ct_sumsq))
    return da


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"edge_reduce_bwd: {msg}")


def edge_reduce_bwd(idx: torch.Tensor, a: torch.Tensor, amax: torch.Tensor,
                    amin: torch.Tensor, ct_max: torch.Tensor,
                    ct_min: torch.Tensor, ct_sum: torch.Tensor,
                    ct_sumsq: torch.Tensor, *,
                    atomic: bool = False) -> torch.Tensor:
    """``da`` of the reductions (amax, amin, asum, asumsq) of
    ``knn_reduce`` with respect to ``a`` (B, N, Co), given their cotangents
    and the forward's ``idx`` (B, N, k) and ``amax``/``amin``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes an int32 ``idx``, f32 contiguous tensors, N a multiple of
    128 and Co <= 256, and raises on anything else.  ``atomic`` launches
    the atomic route at any shape (the checks hold the slices route
    against it)."""
    if a.device.type == "cpu":
        return edge_reduce_bwd_plain(idx, a, amax, amin, ct_max, ct_min,
                                     ct_sum, ct_sumsq)
    _require(a.is_cuda, f"no kernel for device {a.device}")
    feats = (a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq)
    _require(all(t.device == a.device for t in (idx, *feats)),
             "all tensors must be on one device")
    _require(idx.dtype == torch.int32, "idx must be int32")
    _require(all(t.dtype == torch.float32 for t in feats),
             "a, amax, amin and the cotangents must be float32")
    _require(all(t.is_contiguous() for t in (idx, *feats)),
             "tensors must be contiguous")
    b, n, co = a.shape
    _require(all(t.shape == a.shape for t in feats),
             "a, amax, amin and the cotangents must share one shape")
    _require(idx.dim() == 3 and idx.shape[:2] == (b, n),
             f"idx {tuple(idx.shape)} vs a {tuple(a.shape)}")
    k = idx.shape[2]
    _require(n % 128 == 0, f"N={n} must be a multiple of 128")
    _require(1 <= co <= MAX_CO, f"Co={co} out of 1..{MAX_CO}")
    _require(1 <= k <= n, f"k={k} out of range for N={n}")
    fn = getattr(_build.load_library(), "dg_edge_reduce_bwd_atomic"
                 if atomic else "dg_edge_reduce_bwd")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 4 + [p]
        fn.restype = i
    da = torch.empty_like(a)  # every element written
    p = _build.ptr
    with torch.cuda.device(a.device):
        rc = fn(p(idx), *map(p, feats), p(da), b, n, co, k,
                _build.stream_of(a))
    _build.check(rc, "edge_reduce_bwd")
    edge_reduce_bwd.launches += 1
    return da


# launches of the kernel since the count was last set to 0
edge_reduce_bwd.launches = 0
