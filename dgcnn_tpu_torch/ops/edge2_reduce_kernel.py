"""Kernels 7 and 8: the neighbour reductions of the training two-conv
EdgeConv block and their backward, hand-written CUDA.

Replace ``dgcnn_tpu/ops/pallas_knn.py::_edge2_fwd_call`` (body
``_edge2_train_kernel``) and ``::_edge2_bwd_call`` (body
``_edge2_bwd_kernel``) in their exact f32 mode.  The kernels are
``csrc/edge2_reduce.cu`` and ``csrc/edge2_bwd.cu``; their notes state the
bounds on an H100 (operations: the per-edge second conv, 2 B N k C1 C2
flops a call, and the backward's three such products), what the designs do
about them.  Kernel 8 sums ``da1`` without float atomics by default: each
edge's addend is stored and each point's row summed over its in-edges in
ascending edge id (``csrc/reverse_lists.cu``), so ``da1`` has the same bits
from run to run; ``atomic=True`` adds them by f32 atomics instead (the
oracle), whose order, and so ``da1``'s last bits, change from run to run.
Both take the same route from the shape (``csrc/edge2_tile.cuh``,
``e2t_train_route``): C1 and C2 multiples of 4 up to 64 and k <= 128 (every
model's shapes) run tiles of whole rows' edges, whose second conv is a
register-blocked product with the row-warp form's fmaf chain; other shapes
run a warp a row.  Kernel 7's four outputs are the same bits on both
routes and from run to run.  ``edge2_fwd_plain`` and
``edge2_bwd_plain`` beside them are the same functions in plain torch (the
backward by autograd through the forward, ties of max and min splitting
their cotangent evenly): the wrappers run them for CPU tensors and launch
the kernels for CUDA tensors.

``amp=True`` is the AMP form of either kernel, the JAX package's default
in training (``exact=False``, ``pallas_knn.py:1120-1161, 1200-1285``):
a1's selected rows rounded to bf16, z1, h1, z2 and the reductions f32; in
the backward each edge's dsel rounded to bf16 before the da1 sum over a
point's in-edges (the pull form), db1, dW2, ds1 and dt1 f32.
``edge2_fwd_amp_plain`` and ``edge2_bwd_amp_plain`` are their plain
versions.  Its route (``amp_route``): at the tiled route's shapes the
tensor-core form (``csrc/edge2_reduce_tc.cu``, ``csrc/edge2_bwd.cu``'s
``edge2_bwd_tc_kernel``: z2, and the backward's dh1 and dW2, in three
TF32 terms, ``csrc/edge2_tc.cuh``; each edge's dsel stored as bf16), with
``simt=True`` the earlier tiled form (the f32 fmaf chain), and the
row-warp route at the other shapes or with ``rowwarp``.  The backward's
tie tests compare its z2 with the forward's max and min, so both must
take z2 from the same arithmetic: the tensor cores, or the fmaf chain that
the earlier tiled form and the row-warp route share.  ``Edge2Reduce``
hands the forward's route to the backward (``fwd_route``), which raises
when its own z2 would come from the other arithmetic.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.amp_select import round_bf16
from dgcnn_tpu_torch.ops.edge2_kernel import MAX_C, edge2_z2
from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import (
    reverse_list_ints,
    scatter_edges,
)
from dgcnn_tpu_torch.ops.graph import gather_neighbors

# the shapes of the tiled route (csrc/edge2_tile.cuh, e2t_train_route)
TILED_C, TILED_K = 64, 128


def tiled_route(c1: int, c2: int, k: int) -> bool:
    """Whether kernels 7 and 8 take their tiled route at these shapes
    (``e2t_train_route``); else the row-warp route."""
    return (c1 <= TILED_C and c2 <= TILED_C and c1 % 4 == 0 and c2 % 4 == 0
            and k <= TILED_K)


TENSOR_CORE, SIMT, ROWWARP = "tensor_core", "simt", "rowwarp"


def amp_route(c1: int, c2: int, k: int, *, simt: bool = False,
              rowwarp: bool = False) -> str:
    """The route of kernels 7 and 8's AMP forms at these shapes:
    ``"tensor_core"`` at the tiled route's shapes, ``"simt"`` (the earlier
    tiled form) there if ``simt`` asks, ``"rowwarp"`` at any other shape or
    if ``rowwarp`` asks (``edge2_fwd`` alone takes it)."""
    if rowwarp or not tiled_route(c1, c2, k):
        return ROWWARP
    return SIMT if simt else TENSOR_CORE


def fwd_entry(route: str, amp: bool) -> str:
    """The C entry that ``edge2_fwd`` calls on ``route`` (``simt``: the
    earlier tiled form, edge2_reduce.cu's ``dg_edge2_fwd_amp``)."""
    if route == TENSOR_CORE:
        return "dg_edge2_fwd_amp_tc"
    return (("dg_edge2_fwd_amp" if amp else "dg_edge2_fwd")
            + ("_rowwarp" if route == ROWWARP else ""))


def bwd_entry(route: str, amp: bool, atomic: bool = False) -> str:
    """The C entry that ``edge2_bwd`` calls on ``route`` (the row-warp and
    the earlier tiled form share edge2_bwd.cu's, which picks between them
    from the shape)."""
    if route == TENSOR_CORE:
        return "dg_edge2_bwd_pull_amp_tc"
    if atomic:
        return "dg_edge2_bwd"
    return "dg_edge2_bwd_pull_amp" if amp else "dg_edge2_bwd_pull"


def _check_z2_route(fwd_route: str, route: str) -> None:
    """Raise unless the forward's and the backward's z2 come from the same
    arithmetic: the tensor cores, or the fmaf chain of the other two."""
    if (fwd_route == TENSOR_CORE) != (route == TENSOR_CORE):
        raise ValueError(
            f"edge2_bwd: the forward took the {fwd_route} route and this "
            f"backward the {route} one: their z2 differ in the last bits, "
            "and the tie tests would miss the forward's max and min")


def edge2_fwd_plain(a1, b1, s1, t1, w2, idx, slope: float = 0.2):
    """Plain torch version of kernel 7: (max, min, sum, sum of squares)
    over the k neighbours of ``edge2_z2``, each (B, N, C2)."""
    z2 = edge2_z2(a1, b1, s1, t1, w2, idx, slope)
    return z2.amax(dim=2), z2.amin(dim=2), z2.sum(dim=2), z2.square().sum(
        dim=2)


def edge2_bwd_plain(a1, b1, s1, t1, w2, idx, amax, amin, ct_max, ct_min,
                    ct_sum, ct_sumsq, slope: float = 0.2):
    """Plain torch version of kernel 8: (da1, db1, ds1, dt1, dw2).
    ``amax`` and ``amin`` are not read: autograd recomputes them."""
    del amax, amin
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (a1, b1, s1, t1,
                                                             w2)]
        outs = edge2_fwd_plain(*leaves, idx, slope)
        return torch.autograd.grad(outs, leaves,
                                   (ct_max, ct_min, ct_sum, ct_sumsq))


def edge2_fwd_amp_plain(a1, b1, s1, t1, w2, idx, slope: float = 0.2):
    """Plain torch version of kernel 7's AMP form: ``edge2_fwd_plain`` on
    a1 rounded to bf16."""
    return edge2_fwd_plain(round_bf16(a1), b1, s1, t1, w2, idx, slope)


def edge2_bwd_amp_edges(a1, b1, s1, t1, w2, idx, ct_max, ct_min, ct_sum,
                        ct_sumsq, slope: float = 0.2):
    """Kernel 8's AMP form by autograd through ``edge2_fwd_amp_plain`` with
    each edge's selected row a leaf: (dsel (B, N, k, C1), each edge's da1
    addend before its bf16 rounding; db1, ds1, dt1, dw2)."""
    with torch.enable_grad():
        sel = gather_neighbors(round_bf16(a1), idx.long()).requires_grad_(
            True)
        leaves = [t.detach().requires_grad_(True) for t in (b1, s1, t1, w2)]
        bb, ss, tt, ww = leaves
        z1 = (sel + bb[:, :, None]) * ss + tt
        z2 = torch.matmul(torch.where(z1 >= 0, z1, slope * z1), ww)
        outs = (z2.amax(dim=2), z2.amin(dim=2), z2.sum(dim=2),
                z2.square().sum(dim=2))
        return torch.autograd.grad(outs, [sel, *leaves],
                                   (ct_max, ct_min, ct_sum, ct_sumsq))


def edge2_bwd_amp_plain(a1, b1, s1, t1, w2, idx, amax, amin, ct_max, ct_min,
                        ct_sum, ct_sumsq, slope: float = 0.2):
    """Plain torch version of kernel 8's AMP form: (da1, db1, ds1, dt1,
    dw2), each edge's dsel (``edge2_bwd_amp_edges``) rounded to bf16
    before the sum into da1; db1, ds1, dt1 and dw2 of the unrounded
    values.  ``amax`` and ``amin`` are not read: autograd recomputes
    them."""
    del amax, amin
    dsel, *rest = edge2_bwd_amp_edges(a1, b1, s1, t1, w2, idx, ct_max,
                                      ct_min, ct_sum, ct_sumsq, slope)
    return (scatter_edges(round_bf16(dsel), idx), *rest)


def _require(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check(name: str, a1, b1, s1, t1, w2, idx, feats=()) -> tuple:
    """The checks both kernels share; returns (B, N, C1, C2, k)."""
    _require(name, a1.is_cuda, f"no kernel for device {a1.device}")
    tensors = (a1, b1, s1, t1, w2, *feats)
    _require(name, all(t.device == a1.device for t in (*tensors, idx)),
             "all tensors must be on one device")
    _require(name, idx.dtype == torch.int32, "idx must be int32")
    _require(name, all(t.dtype == torch.float32 for t in tensors),
             "tensors must be float32")
    _require(name, all(t.is_contiguous() for t in (a1, b1, idx, *feats)),
             "a1, b1, idx and the (B, N, C2) tensors must be contiguous")
    _require(name, a1.dim() == 3 and w2.dim() == 2, "a1 (B, N, C1), w2 "
             "(C1, C2)")
    b, n, c1 = a1.shape
    c2 = w2.shape[1]
    _require(name, b1.shape == a1.shape and w2.shape[0] == c1,
             f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)} vs a1 "
             f"{tuple(a1.shape)}")
    _require(name, s1.shape == (c1,) and t1.shape == (c1,),
             "s1/t1 must be (C1,)")
    _require(name, idx.dim() == 3 and idx.shape[:2] == (b, n),
             f"idx {tuple(idx.shape)} vs a1 {tuple(a1.shape)}")
    _require(name, all(t.shape == (b, n, c2) for t in feats),
             "amax, amin and the cotangents must be (B, N, C2)")
    _require(name, c1 <= MAX_C and c2 <= MAX_C, f"C1, C2 must be <= {MAX_C}")
    k = idx.shape[2]
    _require(name, 1 <= k <= n, f"k={k} out of range for N={n}")
    return b, n, c1, c2, k


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data is not 16-byte aligned (the tensor-core
    forms gather its rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fn(name: str, argtypes):
    fn = getattr(_build.load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def edge2_fwd(a1: torch.Tensor, b1: torch.Tensor, s1: torch.Tensor,
              t1: torch.Tensor, w2: torch.Tensor, idx: torch.Tensor,
              slope: float = 0.2, *, rowwarp: bool = False,
              amp: bool = False, simt: bool = False):
    """Max, min, sum and sum of squares over the k neighbours ``idx`` (B,
    N, k) of ``z2 = LReLU((a1[idx] + b1) * s1 + t1) @ w2`` -> four (B, N,
    C2) tensors.  ``a1``/``b1`` (B, N, C1), ``s1``/``t1`` (C1,), ``w2``
    (C1, C2).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes an int32 ``idx``, f32 tensors (a1, b1 and idx contiguous)
    and C1, C2 <= 128, and raises on anything else.  C1 and C2 multiples
    of 4 up to 64 and k <= 128 (every model's shapes) take the tiled
    route, other shapes the row-warp route; ``rowwarp`` launches the
    row-warp route at any shape (the checks hold the tiled route bit-equal
    to it).  ``amp`` runs the AMP form (module docstring) on the route
    ``amp_route(C1, C2, k, simt=simt, rowwarp=rowwarp)``: the tensor-core
    form at the tiled route's shapes, the earlier tiled form with
    ``simt``."""
    _require("edge2_fwd", amp or not simt,
             "simt names the AMP form's earlier form")
    if a1.device.type == "cpu":
        plain = edge2_fwd_amp_plain if amp else edge2_fwd_plain
        return plain(a1, b1, s1, t1, w2, idx, slope)
    b, n, c1, c2, k = _check("edge2_fwd", a1, b1, s1, t1, w2, idx)
    route = (amp_route(c1, c2, k, simt=simt, rowwarp=rowwarp) if amp else
             ROWWARP if rowwarp or not tiled_route(c1, c2, k) else SIMT)
    rowwarp = route == ROWWARP
    fn = _fn(fwd_entry(route, amp), [_P] * 10 + [_I] * 5 + [_F, _P])
    if route == TENSOR_CORE:
        a1, b1 = _aligned(a1), _aligned(b1)
    small = [t.contiguous() for t in (s1, t1, w2)]
    red = [torch.empty((b, n, c2), device=a1.device, dtype=torch.float32)
           for _ in range(4)]
    p = _build.ptr
    with torch.cuda.device(a1.device):
        rc = fn(p(idx), p(a1), p(b1), *map(p, small), *map(p, red), b, n,
                c1, c2, k, float(slope), _build.stream_of(a1))
    _build.check(rc, "edge2_fwd")
    edge2_fwd.launches += 1
    edge2_fwd.amp_launches += amp
    edge2_fwd.rowwarp_launches += amp and rowwarp
    edge2_fwd.tc_launches += route == TENSOR_CORE
    return tuple(red)


def edge2_bwd(a1: torch.Tensor, b1: torch.Tensor, s1: torch.Tensor,
              t1: torch.Tensor, w2: torch.Tensor, idx: torch.Tensor,
              amax: torch.Tensor, amin: torch.Tensor, ct_max: torch.Tensor,
              ct_min: torch.Tensor, ct_sum: torch.Tensor,
              ct_sumsq: torch.Tensor, slope: float = 0.2, *,
              atomic: bool = False, amp: bool = False, simt: bool = False,
              fwd_route: str | None = None):
    """The gradients (da1, db1, ds1, dt1, dw2) of ``edge2_fwd``'s four
    reductions given their cotangents and its ``amax``/``amin``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (the same rules as ``edge2_fwd``; amax, amin and the cotangents f32
    contiguous (B, N, C2)), which raises on anything else.

    The kernel's route is decided from the shape before the launch: C1
    and C2 multiples of 4 up to 64 and k <= 128
    (every model's shapes) take the tiled kernel (whole rows' edges a
    tile, register-blocked products), other shapes the row-warp kernel (a
    warp a row).  dW2, ds1, dt1 and da1 are the same bits from call to
    call on either route: da1 is summed over each point's in-edges in
    ascending edge id from a stored addend a edge (B * N * k * C1 floats
    of scratch), unless ``atomic`` adds the addends by f32 atomics.
    ``amp`` runs the AMP form (module docstring), in the pull form, on the
    route ``amp_route(C1, C2, k, simt=simt)``: the tensor-core form at the
    tiled route's shapes (each addend stored as bf16, B * N * k * C1 of
    them), the earlier tiled form with ``simt``.  ``fwd_route``: the
    route of the AMP forward whose max and min these are; a backward whose
    z2 would come from the other arithmetic raises, on the CPU too."""
    _require("edge2_bwd", amp or not simt,
             "simt names the AMP form's earlier form")
    if amp and fwd_route is not None:
        _check_z2_route(fwd_route, amp_route(a1.shape[-1], w2.shape[-1],
                                             idx.shape[-1], simt=simt))
    if a1.device.type == "cpu":
        plain = edge2_bwd_amp_plain if amp else edge2_bwd_plain
        return plain(a1, b1, s1, t1, w2, idx, amax, amin, ct_max, ct_min,
                     ct_sum, ct_sumsq, slope)
    feats = (amax, amin, ct_max, ct_min, ct_sum, ct_sumsq)
    b, n, c1, c2, k = _check("edge2_bwd", a1, b1, s1, t1, w2, idx, feats)
    _require("edge2_bwd", not (amp and atomic),
             "the AMP form has the pull form only")
    route = amp_route(c1, c2, k, simt=simt) if amp else None
    tc = route == TENSOR_CORE
    fn = _fn(bwd_entry(route, amp, atomic),
             [_P] * (16 if atomic else 18) + [_I] * 6 + [_F, _P])
    if tc:
        a1 = _aligned(a1)
    small = [t.contiguous() for t in (s1, t1, w2)]
    # a few blocks per SM stride over the tiles (whole rows) or row groups;
    # each leaves one row of partial dW2/ds1/dt1 sums, which a second launch
    # adds up
    sms = torch.cuda.get_device_properties(a1.device).multi_processor_count
    tiles = _fn("dg_edge2_bwd_tiles", [_I] * 5)(b, n, c1, c2, k)
    g = max(1, min(tiles, 2 * sms))
    width = c1 * c2 + 2 * c1
    part = torch.empty((g, width), device=a1.device, dtype=torch.float32)
    dflat = torch.empty((width,), device=a1.device, dtype=torch.float32)
    db1 = torch.empty_like(a1)
    p = _build.ptr
    if atomic:
        da1 = torch.zeros_like(a1)  # the atomics add into da1
        scratch = []
    else:
        da1 = torch.empty_like(a1)  # every element written
        dsel_e = torch.empty((b * n * k * c1,), device=a1.device,
                             dtype=torch.bfloat16 if tc else torch.float32)
        iscratch = torch.empty((reverse_list_ints(b, n, k),),
                               device=a1.device, dtype=torch.int32)
        scratch = [p(dsel_e), p(iscratch)]
    with torch.cuda.device(a1.device):
        rc = fn(p(idx), p(a1), p(b1), *map(p, small), *map(p, feats), p(da1),
                p(db1), p(part), p(dflat), *scratch, b, n, c1, c2, k, g,
                float(slope), _build.stream_of(a1))
    _build.check(rc, "edge2_bwd")
    edge2_bwd.launches += 1
    edge2_bwd.amp_launches += amp
    edge2_bwd.rowwarp_launches += amp and not tiled_route(c1, c2, k)
    edge2_bwd.tc_launches += tc
    dw2 = dflat[:c1 * c2].view(c1, c2)
    return da1, db1, dflat[c1 * c2:c1 * c2 + c1], dflat[c1 * c2 + c1:], dw2


# launches of each kernel since its count was last set to 0 (amp_launches:
# those of its AMP form; rowwarp_launches: those of its AMP form on the
# row-warp route; tc_launches: those of its AMP form on the tensor cores)
edge2_fwd.launches = edge2_fwd.amp_launches = edge2_fwd.rowwarp_launches = 0
edge2_bwd.launches = edge2_bwd.amp_launches = edge2_bwd.rowwarp_launches = 0
edge2_fwd.tc_launches = edge2_bwd.tc_launches = 0
