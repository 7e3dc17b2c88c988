"""Kernel 5: the backward of the four neighbour reductions of kernels 3
and 4, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::edge_reduce_bwd`` (body
``_edge_reduce_bwd_kernel``) in its exact f32 mode.  The kernel is
``csrc/edge_reduce_bwd.cu``; its note states the bound on an H100, what the
design does about it and why ``da``'s last bits vary from run to run (f32
atomics).  ``edge_reduce_bwd_plain`` beside it is the same function in
plain torch with the semantics of ``_ker_bwd_xla``: autograd through the
gather and the reductions, ties of max and min splitting their cotangent
evenly.  The wrapper runs it for CPU tensors and launches the kernel for
CUDA tensors.
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
                    ct_sumsq: torch.Tensor) -> torch.Tensor:
    """``da`` of the reductions (amax, amin, asum, asumsq) of
    ``knn_reduce`` with respect to ``a`` (B, N, Co), given their cotangents
    and the forward's ``idx`` (B, N, k) and ``amax``/``amin``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes an int32 ``idx``, f32 contiguous tensors, N a multiple of
    128 and Co <= 256, and raises on anything else."""
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
    fn = _build.load_library().dg_edge_reduce_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 4 + [p]
        fn.restype = i
    # the kernel adds into da: zero it on the same stream first
    da = torch.zeros_like(a)
    p = _build.ptr
    with torch.cuda.device(a.device):
        rc = fn(p(idx), *map(p, feats), p(da), b, n, co, k,
                _build.stream_of(a))
    _build.check(rc, "edge_reduce_bwd")
    edge_reduce_bwd.launches += 1
    return da


# launches of the kernel since the count was last set to 0
edge_reduce_bwd.launches = 0
