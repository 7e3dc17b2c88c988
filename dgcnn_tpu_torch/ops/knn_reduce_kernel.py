"""Kernels 3 and 4: kNN and the max/min/sum/sum-of-squares over the k
neighbours, the forward of a training EdgeConv stage, hand-written CUDA.

Replace ``dgcnn_tpu/ops/pallas_knn.py::fused_knn_reduce`` (body
``_knn_reduce_kernel``) and ``::fused_knn_reduce_xw`` (body
``_knn_reduce_xw_kernel``) with ``with_sumsq=True``, in their exact f32
mode.  The kernels are ``csrc/knn_reduce.cu``; its note states the bound on
an H100 and what the design does about it.  ``knn_reduce_plain`` and
``knn_reduce_xw_plain`` beside them are the same functions in plain torch
(kNN, gather, then the reductions over k): the wrappers run them for CPU
tensors and launch the kernels for CUDA tensors.

The variant is the JAX kernels' (read at each call): v1, or v2 under
``DGCNN_TPU_EXTRACT=v2`` (``amp_select.training_variant``; the semseg CLI
pins it), which picks the k largest packed keys of the same f32 scores
(``amp_select.v2_indices``; on the card the tiled route's keyed mode, k <=
64, the kernels' ``v2`` entries); the reductions over the list are the
same.

``amp=True`` is the AMP form, the JAX package's default in training
(``select_dtype=bf16``, ``pallas_knn.py:371-467``): the AMP scores
(``amp_select.amp_scores``, bf16x3 of the f32 graph), v2 (the packed keys
of those scores) unless ``DGCNN_TPU_EXTRACT`` says v1, and the rows of
``a`` rounded to bf16 before max, min, sum and sum of squares, which are
f32.  ``knn_reduce_amp_plain`` and ``knn_reduce_xw_amp_plain`` are its
plain versions; the CUDA form takes v2 and k <= 64 and raises on the rest.
Its select-x form (kernel 4) rounds x to bf16, projects the cloud and
rounds each selected row of the product to bf16: the TPU kernel's
``bf16(bf16(x)[idx] @ w)``, a selection commuting with the projection.

``xw_project`` is the one projection routine of the select-x form: the
backward of ``knn_reduce_xw`` recomputes ``a = x @ w`` through it (in the
AMP form on x rounded to bf16), and on CUDA it launches the projection
that ``knn_reduce_xw``'s kernel runs, so the backward's ties (``a ==
amax``) are found on the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.amp_select import (
    amp_scores,
    round_bf16,
    training_variant,
    v1_indices,
    v2_indices,
)
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import MAX_N, knn_plain


# the longest neighbour list of the tiled selection (csrc/knn_select.cuh,
# TS_LIST): knn_reduce and knn_reduce_xw take the tiled route up to this k
# and the row-warp route above it
TILED_MAX_K = 64


def max_co(n: int) -> int:
    """The widest Co the selection kernels take at N points: 256 up to
    N=2048, 128 above (csrc/knn_select.cuh, Bucket)."""
    return 256 if n <= 2048 else 128


def knn_reduce_plain(graph: torch.Tensor, a: torch.Tensor, k: int,
                     variant: str = "v1"):
    """Plain torch version of kernel 3: (idx (B, N, k) int32, amax, amin,
    asum, asumsq (B, N, Co)); ``variant`` picks the neighbours as
    ``knn_plain``'s."""
    idx = knn_plain(graph, k, variant)
    ag = gather_neighbors(a, idx)
    return (idx.int(), ag.amax(dim=2), ag.amin(dim=2), ag.sum(dim=2),
            ag.square().sum(dim=2))


def knn_reduce_xw_plain(graph: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                        k: int, variant: str = "v1"):
    """Plain torch version of kernel 4: ``knn_reduce_plain`` over
    ``a = x @ w``."""
    return knn_reduce_plain(graph, torch.matmul(x, w), k, variant)


def knn_reduce_amp_plain(graph: torch.Tensor, a: torch.Tensor, k: int,
                         variant: str = "v2"):
    """Plain torch version of kernel 3's AMP form: the k largest packed
    keys (v2) or AMP scores (v1) of ``amp_scores(graph, graph)``, then the
    max, min, sum and sum of squares over them of ``a``'s rows rounded to
    bf16, in f32."""
    scores = amp_scores(graph, graph)
    idx = (v2_indices if variant == "v2" else v1_indices)(scores, k)
    ag = gather_neighbors(round_bf16(a), idx)
    return (idx.int(), ag.amax(dim=2), ag.amin(dim=2), ag.sum(dim=2),
            ag.square().sum(dim=2))


def knn_reduce_xw_amp_plain(graph: torch.Tensor, x: torch.Tensor,
                            w: torch.Tensor, k: int, variant: str = "v2"):
    """Plain torch version of kernel 4's AMP form: ``knn_reduce_amp_plain``
    over ``round_bf16(x) @ w``."""
    return knn_reduce_amp_plain(graph, torch.matmul(round_bf16(x), w), k,
                                variant)


def _fn(name: str, argtypes):
    fn = getattr(_build.load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _require(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_select(name, graph, feats, co: int, k: int, variant: str,
                  amp: bool = False) -> None:
    """The checks both select kernels share: device, f32, contiguity and
    the shapes the kernels take (the v2 and AMP forms: k <= 64; the AMP
    form: v2)."""
    _require(name, not amp or variant == "v2",
             f"the AMP mode's {variant} (DGCNN_TPU_EXTRACT={variant}) has "
             f"no CUDA form; ported: v2")
    _require(name, graph.is_cuda, f"no kernel for device {graph.device}")
    _require(name, all(t.device == graph.device for t in feats),
             "all tensors must be on one device")
    _require(name, all(t.dtype == torch.float32 for t in (graph, *feats)),
             "tensors must be float32")
    _require(name, all(t.is_contiguous() for t in (graph, *feats)),
             "tensors must be contiguous")
    _require(name, graph.dim() == 3, "graph must be (B, N, Cg)")
    n = graph.shape[1]
    _require(name, n % 128 == 0 and n <= MAX_N,
             f"N={n} must be a multiple of 128 and <= {MAX_N}")
    _require(name, 1 <= co <= max_co(n),
             f"Co={co} out of 1..{max_co(n)} for N={n}")
    _require(name, 1 <= k <= n, f"k={k} out of range for N={n}")
    form = "AMP form" if amp else "v2 form (DGCNN_TPU_EXTRACT=v2)"
    _require(name, not (amp or variant == "v2") or k <= TILED_MAX_K,
             f"the {form} takes k <= {TILED_MAX_K}, not {k}")


def _outputs(graph: torch.Tensor, co: int, k: int, v2: bool,
             amp: bool = False):
    """idx, the four reductions and the scratch: sq, for the v2 form the
    rows' grids, and for the AMP form before them the two score operands
    (B * N * 3 Cg floats each)."""
    b, n, cg = graph.shape
    idx = torch.empty((b, n, k), device=graph.device, dtype=torch.int32)
    red = [torch.empty((b, n, co), device=graph.device, dtype=torch.float32)
           for _ in range(4)]
    scratch = [torch.empty((b * n * 3 * cg,), device=graph.device,
                           dtype=torch.float32) for _ in range(2 * amp)]
    scratch += [torch.empty((b * n,), device=graph.device,
                            dtype=torch.float32)
                for _ in range(1 + (v2 or amp))]
    return idx, red, scratch


def knn_reduce(graph: torch.Tensor, a: torch.Tensor, k: int, *,
               amp: bool = False):
    """kNN over ``graph`` (B, N, Cg), then the max, min, sum and sum of
    squares over the k neighbours of ``a`` (B, N, Co).

    Returns (idx (B, N, k) int32, self first, lowest index first among
    equal scores; amax, amin, asum, asumsq (B, N, Co) f32).  CPU tensors
    take the plain version; CUDA tensors launch the kernel, which takes f32
    contiguous tensors with N a multiple of 128, N <= 4096 and Co <= 256
    (Co <= 128 above N=2048), and raises on anything else.  The variant is
    ``amp_select.training_variant``'s (module docstring).

    The kernel's route is decided from k before the launch: up to
    ``TILED_MAX_K`` (every model's k) the tiled selection (blocks of 64
    query rows, register-blocked score tiles, a running top-k a row), above
    it the row-warp selection (a warp a row, its N scores in registers).
    Both give the same bits.  The v2 form has the tiled route only.

    ``amp`` runs the AMP form (module docstring), tiled route only."""
    variant = training_variant(amp)
    if graph.device.type == "cpu":
        if amp:
            return knn_reduce_amp_plain(graph, a, k, variant)
        return knn_reduce_plain(graph, a, k, variant)
    v2 = variant == "v2" and not amp
    co = a.shape[-1]
    _check_select("knn_reduce", graph, (a,), co, k, variant, amp)
    b, n, cg = graph.shape
    _require("knn_reduce", a.shape == (b, n, co),
             f"a {tuple(a.shape)} vs graph {tuple(graph.shape)}")
    name = ("dg_knn_reduce_amp" if amp else
            "dg_knn_reduce_v2" if v2 else "dg_knn_reduce")
    idx, red, scratch = _outputs(graph, co, k, v2, amp)
    fn = _fn(name, [_P] * (7 + len(scratch)) + [_I] * 5 + [_P])
    p = _build.ptr
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(a), *map(p, scratch), p(idx), *map(p, red), b, n,
                cg, co, k, _build.stream_of(graph))
    _build.check(rc, "knn_reduce")
    knn_reduce.launches += 1
    knn_reduce.v2_launches += v2
    knn_reduce.amp_launches += amp
    return (idx, *red)


def knn_reduce_xw(graph: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  k: int, *, amp: bool = False):
    """``knn_reduce(graph, x @ w, k)`` with the projection inside the
    kernel's launch: ``x`` (B, N, Cin), ``w`` (Cin, Co).  Same outputs and
    the same rules for CPU and CUDA tensors as ``knn_reduce``; ``amp``:
    ``knn_reduce(graph, round_bf16(x) @ w, k, amp=True)``, whose rows of
    the product are rounded to bf16 before the reductions."""
    variant = training_variant(amp)
    if graph.device.type == "cpu":
        if amp:
            return knn_reduce_xw_amp_plain(graph, x, w, k, variant)
        return knn_reduce_xw_plain(graph, x, w, k, variant)
    v2 = variant == "v2" and not amp
    cin, co = w.shape
    _check_select("knn_reduce_xw", graph, (x, w), co, k, variant, amp)
    b, n, cg = graph.shape
    _require("knn_reduce_xw", x.shape == (b, n, cin),
             f"x {tuple(x.shape)} vs graph {tuple(graph.shape)} and w "
             f"{tuple(w.shape)}")
    name = ("dg_knn_reduce_xw_amp" if amp else
            "dg_knn_reduce_xw_v2" if v2 else "dg_knn_reduce_xw")
    idx, red, scratch = _outputs(graph, co, k, v2, amp)
    # the projection's scratch: a, after x rounded to bf16 in the AMP form
    proj = [torch.empty((b * n * cin,), device=graph.device,
                        dtype=torch.float32)] * amp + [
        torch.empty((b, n, co), device=graph.device, dtype=torch.float32)]
    fn = _fn(name, [_P] * (8 + len(proj) + len(scratch)) + [_I] * 6 + [_P])
    p = _build.ptr
    # the launch is asynchronous on torch's current stream: scratch made
    # here and freed on return is reused by the caching allocator only for
    # work queued after it on that stream
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(x), p(w), *map(p, proj), *map(p, scratch),
                p(idx), *map(p, red), b, n, cg, cin, co, k,
                _build.stream_of(graph))
    _build.check(rc, "knn_reduce_xw")
    knn_reduce_xw.launches += 1
    knn_reduce_xw.v2_launches += v2
    knn_reduce_xw.amp_launches += amp
    return (idx, *red)


def xw_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (B, N, Cin) @ ``w`` (Cin, Co) by the routine
    ``knn_reduce_xw`` projects with: ``torch.matmul`` for CPU tensors (as
    ``knn_reduce_xw_plain``), for CUDA tensors the kernel's own projection
    (f32 contiguous tensors, else it raises)."""
    if x.device.type == "cpu":
        return torch.matmul(x, w)
    name = "xw_project"
    _require(name, x.is_cuda and w.device == x.device,
             f"no kernel for devices {x.device}, {w.device}")
    _require(name, x.dtype == torch.float32 and w.dtype == torch.float32,
             "tensors must be float32")
    _require(name, x.is_contiguous() and w.is_contiguous(),
             "tensors must be contiguous")
    cin, co = w.shape
    _require(name, x.dim() == 3 and x.shape[2] == cin,
             f"x {tuple(x.shape)} vs w {tuple(w.shape)}")
    fn = _fn("dg_project", [_P] * 3 + [_I] * 3 + [_P])
    out = torch.empty(x.shape[:2] + (co,), device=x.device,
                      dtype=torch.float32)
    p = _build.ptr
    with torch.cuda.device(x.device):
        rc = fn(p(x), p(w), p(out), x.shape[0] * x.shape[1], cin, co,
                _build.stream_of(x))
    _build.check(rc, name)
    xw_project.launches += 1
    return out


# launches of each kernel since its count was last set to 0 (v2_launches:
# those of its exact v2 form, amp_launches: those of its AMP form)
knn_reduce.launches = knn_reduce.v2_launches = knn_reduce.amp_launches = 0
knn_reduce_xw.launches = knn_reduce_xw.v2_launches = 0
knn_reduce_xw.amp_launches = 0
xw_project.launches = 0
