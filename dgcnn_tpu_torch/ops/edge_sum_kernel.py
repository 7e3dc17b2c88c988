"""Kernel 9, ``edge_sum``: the sums of per-point rows over saved
neighbour indices, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::edge_sum_reduce`` (body
``_edge_sum_kernel``), the second half of the HOG moment form (the sums of
the per-point votes over each neighbourhood).  The kernel is
``csrc/edge_sum.cu``; its note states the bound on an H100 and what the
design does about it.  Each sum runs over the k neighbours in their order
t = 0..k-1 in f32, duplicates once each; the plain version beside it,
``edge_sum_plain``, sums in the same order, so the two give the same bits.
The TPU sums through a multi-hot product on its matrix unit (a 3-way bf16
split in its exact mode), whose last bits differ.  The kernel gives a warp
a few consecutive rows (three at the HOG's 18 votes, on 9 lanes of float2
each), reads their indices once, coalesced, and issues each lane's k
gathers ahead of its adds; a wider row or a longer list takes its earlier
form, one thread an output, which ``per_output=True`` forces at any shape
for the checks.  Both give the same bits.  CPU tensors take the
plain version; CUDA tensors launch the kernel, which raises on what it does
not take.  No gradient: HOG is detached, as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.graph import gather_neighbors


def ordered_neighbour_sum(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows, (B, M, k) indices -> (B, M, C): the sum over the k
    gathered rows in the order t = 0..k-1, one f32 add at a time."""
    g = gather_neighbors(a, idx.long())
    out = g[:, :, 0]
    for t in range(1, idx.shape[-1]):
        out = out + g[:, :, t]
    return out


def edge_sum_plain(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel 9: (B, N, Co) ordered sums of ``a``'s
    rows over ``idx`` (B, N, k)."""
    return ordered_neighbour_sum(a.float(), idx)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"edge_sum: {msg}")


def _lib(per_output: bool):
    fn = getattr(_build.load_library(),
                 "dg_edge_sum_per_output" if per_output else "dg_edge_sum")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def edge_sum(a: torch.Tensor, idx: torch.Tensor, *,
             per_output: bool = False) -> torch.Tensor:
    """The sums of ``a`` (B, N, Co) over each point's neighbours ``idx``
    (B, N, k), duplicates once each -> (B, N, Co) f32.

    CPU tensors take ``edge_sum_plain``; CUDA tensors launch the kernel,
    which takes a contiguous f32 ``a`` and contiguous int32 indices in
    [0, N) (it reads what they point at unchecked), and raises on anything
    else.  ``per_output`` launches the kernel's earlier form, one thread an
    output, at any shape."""
    a = a.detach()
    if a.device.type == "cpu":
        return edge_sum_plain(a, idx)
    _require(a.is_cuda and idx.device == a.device,
             f"no kernel for devices {a.device}, {idx.device}")
    _require(a.dtype == torch.float32 and idx.dtype == torch.int32,
             "a must be float32 and idx int32")
    _require(a.dim() == 3 and idx.dim() == 3 and a.is_contiguous()
             and idx.is_contiguous(),
             "a and idx must be contiguous (B, N, ...) tensors")
    b, n, co = a.shape
    _require(idx.shape[:2] == (b, n) and idx.shape[2] >= 1,
             f"idx {tuple(idx.shape)} vs a {tuple(a.shape)}")
    fn = _lib(per_output)
    out = torch.empty((b, n, co), device=a.device, dtype=torch.float32)
    q = _build.ptr
    with torch.cuda.device(a.device):
        rc = fn(q(idx), q(a), q(out), b, n, co, idx.shape[2],
                _build.stream_of(a))
    _build.check(rc, "edge_sum")
    edge_sum.launches += 1
    return out


# launches of the kernel since the count was last set to 0
edge_sum.launches = 0
