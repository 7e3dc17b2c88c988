"""Kernel 10, ``knn_sum``: the kNN graph and the sums of per-point rows
over each point's neighbours, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::fused_knn_sum`` (body
``_knn_sum_kernel``) in its exact (v1) mode, the first half of the HOG
moment form (the neighbourhood sums of the moments [x, vech(x x^T)]).  The
kernel is ``csrc/knn_sum.cu``; its note states the bound on an H100 and
what the design does about it.  The neighbours are those of ``knn``: self
first, lowest index first among equal scores.  Each sum runs over them in
the order t = 0..k-1 in f32, as the plain version ``knn_sum_plain`` sums;
the TPU sums through a 3-way bf16 split on its matrix unit, whose last bits
differ.  At k <= 64 (the Net's k = 32) the kernel selects with kernel 11's
tiled route (``csrc/knn_select.cuh``, tiled_topk: 64 query rows a block,
the cloud streamed in 128-column tiles past a running top-k a row), writes
each list in order and folds it into the sums; above, the row-warp
selection with the sum folded into its k arg-max rounds, which
``rowwarp=True`` forces at any k for the checks.  Both give the same idx
and sums, bit for bit.  CPU tensors take the plain version; CUDA tensors
launch the kernel, which raises on what it does not take.  No gradient:
HOG is detached, as in the reference.

The v2 form (``amp=True``, the AMP Net's HOG; the JAX kernel's variant is
``_extract_version("v2", ...)``, pallas_knn.py:1518: ``amp_select.
knn_sum_variant``, ``DGCNN_TPU_EXTRACT`` overriding either mode) picks the
k largest packed keys of the same exact f32 scores (``amp_select.
v2_indices``; on the card the selection's keyed mode, on the v1 form's two
routes) and sums over them in list order, f32, as the v1 form does.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.amp_select import knn_sum_variant
from dgcnn_tpu_torch.ops.edge_sum_kernel import ordered_neighbour_sum
from dgcnn_tpu_torch.ops.knn import (
    MAX_N,
    TILED_MAX_K,
    knn_plain,
    srow_count,
)


def knn_sum_plain(x: torch.Tensor, a: torch.Tensor, k: int,
                  variant: str = "v1") -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of kernel 10: (idx (B, N, k) int32, nearest
    (self) first, lowest index first among equal scores (``variant`` v2:
    the packed keys' order, ``knn_plain``'s); the ordered sums (B, N, Ca)
    of ``a``'s rows over them)."""
    idx = knn_plain(x, k, variant)
    return idx.int(), ordered_neighbour_sum(a.float(), idx)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"knn_sum: {msg}")


def _lib(rowwarp: bool, v2: bool):
    fn = getattr(_build.load_library(),
                 ("dg_knn_sum_v2" if v2 else "dg_knn_sum")
                 + ("_rowwarp" if rowwarp else ""))
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (6 if v2 else 5) + [i] * 5 + [p]
        fn.restype = i
    return fn


def knn_sum(x: torch.Tensor, a: torch.Tensor, k: int, *,
            rowwarp: bool = False,
            amp: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN over ``x`` (B, N, C) and the sums of ``a`` (B, N, Ca) over each
    point's k neighbours -> (idx (B, N, k) int32, asum (B, N, Ca) f32).

    CPU tensors take ``knn_sum_plain``; CUDA tensors launch the kernel,
    which takes f32 contiguous tensors with N a multiple of 128, N <=
    ``MAX_N`` (32768) and Ca <= 32, and raises on anything else.
    ``rowwarp`` launches the
    kernel's row-warp route at any k (k <= 64 takes the tiled route
    otherwise).  ``amp`` is the caller's mode, from which
    ``amp_select.knn_sum_variant`` takes the variant (module
    docstring)."""
    x, a = x.detach(), a.detach()
    variant = knn_sum_variant(amp)
    if x.device.type == "cpu":
        return knn_sum_plain(x, a, k, variant)
    v2 = variant == "v2"
    _require(x.is_cuda and a.device == x.device,
             f"no kernel for devices {x.device}, {a.device}")
    _require(x.dtype == torch.float32 and a.dtype == torch.float32,
             "x and a must be float32")
    _require(x.dim() == 3 and x.is_contiguous() and a.is_contiguous(),
             "x and a must be contiguous (B, N, C) tensors")
    b, n, c = x.shape
    _require(a.dim() == 3 and a.shape[:2] == (b, n) and a.shape[2] <= 32,
             f"a {tuple(a.shape)} must be (B, N, Ca <= 32) for x "
             f"{tuple(x.shape)}")
    _require(n % 128 == 0 and n <= MAX_N,
             f"N={n} must be a multiple of 128 and <= {MAX_N}")
    _require(1 <= k <= n, f"k={k} out of range for N={n}")
    ca = a.shape[2]
    fn = _lib(rowwarp, v2)
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    scratch = [torch.empty((b * n,), device=x.device, dtype=torch.float32)
               for _ in range(1 + v2)]
    idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
    asum = torch.empty((b, n, ca), device=x.device, dtype=torch.float32)
    q = _build.ptr
    srow = srow_count()
    with torch.cuda.device(x.device):
        rc = fn(q(x), q(a), *map(q, scratch), q(idx), q(asum), b, n, c, ca,
                k, _build.stream_of(x))
    _build.check(rc, "knn_sum")
    knn_sum.launches += 1
    knn_sum.v2_launches += v2
    row = rowwarp or k > TILED_MAX_K
    knn_sum.rowwarp_launches += v2 and row
    knn_sum.srow_launches += srow_count() - srow
    return idx, asum


# launches of the kernel since the count was last set to 0 (v2_launches:
# those of its v2 form; rowwarp_launches: those of its v2 form on the
# row-warp route; srow_launches: those on the row-warp route's shared row)
knn_sum.launches = knn_sum.v2_launches = knn_sum.rowwarp_launches = 0
knn_sum.srow_launches = 0
