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
(``amp_select.v2_indices``; on the card the selection's keyed mode, the
kernels' ``v2`` entries); the reductions over the list are the same.

``amp=True`` is the AMP form, the JAX package's default in training
(``select_dtype=bf16``, ``pallas_knn.py:371-467``): the AMP scores
(``amp_select.amp_scores``, bf16x3 of the f32 graph), v2 (the packed keys
of those scores) unless ``DGCNN_TPU_EXTRACT`` says v1, and the rows of
``a`` rounded to bf16 before max, min, sum and sum of squares, which are
f32.  ``knn_reduce_amp_plain`` and ``knn_reduce_xw_amp_plain`` are its
plain versions; the CUDA form takes v2 at any k and raises on v1.
On the tiled route (``amp_route``: k <= 64, Cg <= 128) its scores come
from the tensor cores in both its passes: bf16 hi and lo operands padded
to a multiple of 16 channels, bf16 ``mma.sync`` products with f32 sums;
``simt=True`` keeps the earlier form, the f32 fmaf chain on the CUDA
cores, callable (the oracle and the A/B's other side).
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
from dgcnn_tpu_torch.ops.knn import (
    MAX_CO,
    MAX_N,
    TILED_MAX_K,
    knn_plain,
    srow_count,
)


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
    the shapes the kernels take (the AMP form: v2)."""
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
    _require(name, 1 <= co <= MAX_CO, f"Co={co} out of 1..{MAX_CO}")
    _require(name, 1 <= k <= n, f"k={k} out of range for N={n}")


# the widest graph whose AMP scores take the tensor cores: its bf16
# operands, 3 Cg channels padded to 16, rest in shared memory for the v2
# grid's 128 query rows (csrc/knn_reduce.cu, RM_MAX_KP = 384)
TC_MAX_CG = 128


def amp_route(k: int, n: int, co: int, cg: int) -> str:
    """The route of kernels 3 and 4's AMP forms on the card at (k, N, Co,
    Cg): "tensor" (the tiled selection, its scores on the tensor cores) at
    k <= ``TILED_MAX_K`` and Cg <= ``TC_MAX_CG`` (every model's), "simt"
    (the tiled selection, f32 scores on the CUDA cores: the earlier form)
    at a wider graph, "rowwarp" (the row-warp selection, f32 scores on the
    CUDA cores) above k = 64, "none" where the kernels raise.
    ``simt=True`` sends the tiled route to its earlier form,
    ``rowwarp=True`` to the row-warp route."""
    if (n % 128 or n > MAX_N or not 1 <= k <= n or not 1 <= co <= MAX_CO
            or cg < 1):
        return "none"
    if k > TILED_MAX_K:
        return "rowwarp"
    return "tensor" if cg <= TC_MAX_CG else "simt"


def amp_operand_floats(cg: int) -> int:
    """The floats of each AMP score operand a point takes: 3 Cg f32 (the
    row-warp route and the earlier form) or the tensor-core route's bf16
    channels, 3 Cg padded to a multiple of 16, whichever is more."""
    return max(3 * cg, (3 * cg + 15) // 16 * 8)


def _outputs(graph: torch.Tensor, co: int, k: int, v2: bool,
             amp: bool = False):
    """idx, the four reductions and the scratch: sq, for the v2 form the
    rows' grids, and for the AMP form before them the two score operands
    (``amp_operand_floats(Cg)`` floats a point each)."""
    b, n, cg = graph.shape
    idx = torch.empty((b, n, k), device=graph.device, dtype=torch.int32)
    red = [torch.empty((b, n, co), device=graph.device, dtype=torch.float32)
           for _ in range(4)]
    scratch = [torch.empty((b * n * amp_operand_floats(cg),),
                           device=graph.device, dtype=torch.float32)
               for _ in range(2 * amp)]
    scratch += [torch.empty((b * n,), device=graph.device,
                            dtype=torch.float32)
                for _ in range(1 + (v2 or amp))]
    return idx, red, scratch


def knn_reduce(graph: torch.Tensor, a: torch.Tensor, k: int, *,
               amp: bool = False, rowwarp: bool = False, simt: bool = False):
    """kNN over ``graph`` (B, N, Cg), then the max, min, sum and sum of
    squares over the k neighbours of ``a`` (B, N, Co).

    Returns (idx (B, N, k) int32, self first, lowest index first among
    equal scores; amax, amin, asum, asumsq (B, N, Co) f32).  CPU tensors
    take the plain version; CUDA tensors launch the kernel, which takes f32
    contiguous tensors with N a multiple of 128, N <= ``MAX_N`` (32768)
    and Co <= 256, and raises on anything else.  The variant is
    ``amp_select.training_variant``'s (module docstring).

    The kernel's route is decided from k before the launch: up to
    ``TILED_MAX_K`` (every model's k) the tiled selection (blocks of 64
    query rows, register-blocked score tiles, a running top-k a row), above
    it, or with ``rowwarp`` (the oracle of the tiled one; the v2 and AMP
    forms), the row-warp selection (a warp a row, its N scores in
    registers, or in shared memory above N = 4096 or Co > 128 at N >
    2048: ``csrc/knn_select.cuh``'s ``with_npl``), in every form.  All
    give the same bits, but for the AMP form's tiled route, whose
    tensor-core scores sum in another order (its earlier form, ``simt``,
    gives the row-warp route's bits).

    ``amp`` runs the AMP form (module docstring): on the tiled route its
    scores on the tensor cores (``amp_route``), or with ``simt`` its
    earlier form (the f32 chain on the CUDA cores)."""
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
    # the v1 entry picks its route from k alone; the v2 one takes rowwarp,
    # the AMP one rowwarp and simt as flags
    forced = [rowwarp | simt << 1] if amp else [rowwarp] if v2 else []
    _require("knn_reduce", not rowwarp or forced,
             "the v1 form's row-warp route is its k > 64 route")
    _require("knn_reduce", not simt or amp,
             "simt names the AMP form's earlier form")
    fn = _fn(name, [_P] * (7 + len(scratch)) + [_I] * (5 + len(forced))
             + [_P])
    rowwarp = rowwarp or k > TILED_MAX_K
    p = _build.ptr
    srow = srow_count()
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(a), *map(p, scratch), p(idx), *map(p, red), b, n,
                cg, co, k, *forced, _build.stream_of(graph))
    _build.check(rc, "knn_reduce")
    knn_reduce.launches += 1
    knn_reduce.v2_launches += v2
    knn_reduce.amp_launches += amp
    knn_reduce.rowwarp_launches += rowwarp and (v2 or amp)
    knn_reduce.tc_launches += (amp and not (rowwarp or simt)
                           and amp_route(k, n, co, cg) == "tensor")
    knn_reduce.srow_launches += srow_count() - srow
    return (idx, *red)


def knn_reduce_xw(graph: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  k: int, *, amp: bool = False, rowwarp: bool = False,
                  simt: bool = False):
    """``knn_reduce(graph, x @ w, k)`` with the projection inside the
    kernel's launch: ``x`` (B, N, Cin), ``w`` (Cin, Co).  Same outputs and
    the same rules (routes too) for CPU and CUDA tensors as
    ``knn_reduce``; ``amp``:
    ``knn_reduce(graph, round_bf16(x) @ w, k, amp=True, simt=simt)``,
    whose rows of the product are rounded to bf16 before the
    reductions."""
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
    forced = [rowwarp | simt << 1] if amp else [rowwarp] if v2 else []
    _require("knn_reduce_xw", not rowwarp or forced,
             "the v1 form's row-warp route is its k > 64 route")
    _require("knn_reduce_xw", not simt or amp,
             "simt names the AMP form's earlier form")
    fn = _fn(name, [_P] * (8 + len(proj) + len(scratch))
             + [_I] * (6 + len(forced)) + [_P])
    rowwarp = rowwarp or k > TILED_MAX_K
    p = _build.ptr
    # the launch is asynchronous on torch's current stream: scratch made
    # here and freed on return is reused by the caching allocator only for
    # work queued after it on that stream
    srow = srow_count()
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(x), p(w), *map(p, proj), *map(p, scratch),
                p(idx), *map(p, red), b, n, cg, cin, co, k, *forced,
                _build.stream_of(graph))
    _build.check(rc, "knn_reduce_xw")
    knn_reduce_xw.launches += 1
    knn_reduce_xw.v2_launches += v2
    knn_reduce_xw.amp_launches += amp
    knn_reduce_xw.rowwarp_launches += rowwarp and (v2 or amp)
    knn_reduce_xw.tc_launches += (amp and not (rowwarp or simt)
                              and amp_route(k, n, co, cg) == "tensor")
    knn_reduce_xw.srow_launches += srow_count() - srow
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
# those of its exact v2 form, amp_launches: those of its AMP form,
# rowwarp_launches: those of either on the row-warp route; tc_launches:
# those of the AMP form with its tensor-core scores; srow_launches: those
# of any form on the row-warp route's shared row)
knn_reduce.launches = knn_reduce.v2_launches = knn_reduce.amp_launches = 0
knn_reduce_xw.launches = knn_reduce_xw.v2_launches = 0
knn_reduce_xw.amp_launches = 0
knn_reduce.rowwarp_launches = knn_reduce_xw.rowwarp_launches = 0
knn_reduce.srow_launches = knn_reduce_xw.srow_launches = 0
knn_reduce.tc_launches = knn_reduce_xw.tc_launches = 0
xw_project.launches = 0
