"""Banded (approximate) eval EdgeConv stages, the ``--fast_extract`` path
(port of dgcnn_tpu/ops/pallas_banded.py), and kernels 12 and 13.

Each stage's candidates are pruned to a band:

  1. the points are ordered by their projection onto the leading principal
     component of the stage's graph features (``pc1_key``: 8 power
     iterations on the (C, C) covariance);
  2. the query rows of each tile of that order score only a window of
     ``band`` sorted rows centred on the tile and clamped at the ends
     (``band_starts``), ties going to the lowest window position;
  3. the stage output is un-sorted back to the input order (EdgeConv is
     permutation-equivariant, so only the windowing approximates).

The sort, the window starts and the un-sort are plain torch on either
device, as they are XLA in the JAX package.  The window starts are built
on the tensors' device once per (N, tile, band, device)
(``window_starts``), so that no banded call copies from the host or waits
for the card.  On sorted inputs, ``banded_edge_conv_eval`` launches
kernel 12 (``csrc/edge_conv_eval.cu``, ``dg_banded_edge_conv_eval``; it
replaces ``dgcnn_tpu/ops/pallas_banded.py::banded_edge_conv_eval``) and
``banded_knn_edge2`` kernel 13 (``csrc/knn_edge2.cu``,
``dg_banded_knn_edge2``; it replaces ``::banded_knn_edge2``): the exact
stage kernels with each query tile's window in the place of the cloud,
on the tiled selection at k <= 64 (kernel 13 also at C1 <= 64 and C2 <=
128) and the row-warp selection otherwise.  ``rowwarp=True`` takes the
row-warp route at any shape (``dg_banded_*_rowwarp``): at band = N in
the identity order it is the exact kernels' row-warp route, the oracle
that the tiled routes of kernels 1, 6, 12 and 13 are held to bit for bit.
The ``*_plain`` versions beside them build the (B, T, band, C) windows
of the sorted graph as the JAX package does; CPU tensors take them.  Both
take an ``order`` to share one sort between them (a sum taken in another
order can swap two close keys, which moves a point to another window).

``amp=True`` runs each kernel's AMP form (the JAX package's default: the
banded kernels run the bodies of kernels 1 and 6, ``pallas_banded.py:
109-223``), and the extraction variant is the exact kernels'
(``amp_select.stage_variant``): the CUDA forms take the exact v1 and v2
and the AMP v2 and v3 (``launch_variant`` of ``edge_conv_kernel.py`` and
``edge2_kernel.py`` with the window starts), on the exact v1's two routes
(``rowwarp=True`` forces the row-warp one).  Over a window, a row's keys
(v2) are packed for N = band, on its least score over the window, and
its classes (v3) are the window's.  ``*_amp_plain`` and the ``variant`` of
the ``*_plain`` versions select over the same windows.

The JAX package reads ``DGCNN_TPU_FAST_EXTRACT`` when it traces; here the
band is an argument of the models (``cli.common.resolve_band`` reads the
flag and the variable).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dgcnn_tpu_torch.ops import _build, edge2_kernel, edge_conv_kernel
from dgcnn_tpu_torch.ops.amp_select import (
    amp_scores,
    max_min,
    require_ported,
    round_bf16,
    select_rows,
    select_x_plan,
    stage_variant,
)
from dgcnn_tpu_torch.ops.edge2_kernel import (
    MAX_C,
    edge2_fold,
    edge2_variant,
    edge2_z2,
)
from dgcnn_tpu_torch.ops.edge_conv import _project, edge_conv_fused
from dgcnn_tpu_torch.ops.edge_conv_kernel import _amp_weights, stage_epilogue
from dgcnn_tpu_torch.ops.knn import (
    MAX_CO,
    MAX_N,
    TILED_MAX_K,
    pairwise_neg_sqdist,
    srow_count,
)

TILE_N = 128


def banded_applicable(n: int, band: int) -> bool:
    """Whether a band prunes the candidates of an N-point cloud."""
    return 0 < band < n and n % TILE_N == 0 and band % TILE_N == 0


def pick_tile(n: int) -> int:
    """The JAX package's query tile at N points
    (``pallas_knn._pick_tile``): the largest of 512, 256 and 128 that
    divides N and keeps a (tile, N) f32 score block within 2 MiB."""
    for tile in (512, 256, 128):
        if n % tile == 0 and tile * n * 4 <= 2 * 1024 * 1024:
            return tile
    return TILE_N


def band_tile(n: int, band: int) -> int:
    """The query tile whose rows share one window: ``pick_tile(n)``, at
    most the band, lowered by 128 until it divides N (256 at N=2048, 128
    at N=4096)."""
    tile = min(pick_tile(n), band)
    while n % tile:
        tile -= TILE_N
    return tile


def band_starts(n: int, tile: int, band: int) -> np.ndarray:
    """(N / tile,) int32 window starts: centred on each tile, clamped to
    [0, N - band]."""
    centers = np.arange(n // tile) * tile + tile // 2
    return np.clip(centers - band // 2, 0, n - band).astype(np.int32)


@functools.lru_cache(maxsize=64)
def window_starts(n: int, tile: int, band: int,
                  device: torch.device) -> torch.Tensor:
    """``band_starts`` as an int32 tensor built on ``device`` (arange and
    clamp there: no copy from the host), once per (N, tile, band,
    device).  Callers only read it."""
    centers = torch.arange(n // tile, device=device,
                           dtype=torch.int32) * tile + tile // 2
    return (centers - band // 2).clamp_(0, n - band)


def pc1_key(g: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, N) projection of the centred points onto the
    leading principal component (8 power iterations on the covariance, in
    f32 like every matmul of the port: torch's default, TF32 off; its sign
    does not matter)."""
    gf = g.detach().float()
    gc = gf - gf.mean(dim=1, keepdim=True)
    cov = torch.einsum("bnc,bnd->bcd", gc, gc)
    v = torch.ones(g.shape[0], g.shape[2], device=g.device)
    for _ in range(8):
        v = torch.einsum("bcd,bd->bc", cov, v)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.einsum("bnc,bc->bn", gc, v)


def sorted_order(graph: torch.Tensor) -> torch.Tensor:
    """(B, N) int64: each cloud's points in ascending ``pc1_key`` order
    (a stable sort, as ``jnp.argsort``)."""
    return torch.sort(pc1_key(graph), dim=1, stable=True).indices


def inverse_order(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    pos = torch.arange(order.shape[1], device=order.device)
    return inv.scatter_(1, order, pos.expand_as(order).contiguous())


def sort_rows(arr: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows in ``order`` (B, N)."""
    return torch.gather(arr, 1, order[..., None].expand(-1, -1, arr.shape[2]))


def banded_knn_plain(gs: torch.Tensor, k: int, band: int) -> torch.Tensor:
    """(B, N, k) int64 sorted-order neighbours of a PC1-sorted cloud ``gs``
    (B, N, C): each query tile's k best of its window, lowest window
    position first among equal scores."""
    b, n, c = gs.shape
    tile = band_tile(n, band)
    starts = window_starts(n, tile, band, gs.device).long()
    t = n // tile
    cols = (starts[:, None] + torch.arange(band, device=gs.device)).reshape(-1)
    win = gs[:, cols].reshape(b * t, band, c)
    scores = pairwise_neg_sqdist(gs.reshape(b * t, tile, c), win)
    local = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = local[..., :k].reshape(b, t, tile, k) + starts[None, :, None, None]
    return idx.reshape(b, n, k)


def window_rows(gs: torch.Tensor, payload: torch.Tensor, k: int, band: int,
                variant: str, amp: bool):
    """The selection of a PC1-sorted cloud ``gs`` (B, N, C) over each
    query tile's window: (rows (B, N, k, Cp) of ``payload`` (B, N, Cp),
    present (B, N, k)), as ``select_rows`` gives them on the (B*T, tile,
    band) scores, exact or AMP (``amp``); v1's and v2's ties go to the
    lowest window position."""
    b, n, c = gs.shape
    tile = band_tile(n, band)
    starts = window_starts(n, tile, band, gs.device).long()
    t = n // tile
    cols = (starts[:, None] + torch.arange(band, device=gs.device)).reshape(-1)
    win = gs[:, cols].reshape(b * t, band, c)
    q = gs.reshape(b * t, tile, c)
    scores = amp_scores(q, win) if amp else pairwise_neg_sqdist(q, win)
    rows, present = select_rows(
        scores, payload[:, cols].reshape(b * t, band, -1), k, variant)
    return rows.reshape(b, n, k, -1), present.reshape(b, n, k)


def _require(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check(name: str, tensors, n: int, k: int, band: int) -> None:
    graph = tensors[0]
    _require(name, graph.is_cuda, f"no kernel for device {graph.device}")
    _require(name, all(t.device == graph.device for t in tensors),
             "all tensors must be on one device")
    _require(name, all(t.dtype == torch.float32 for t in tensors),
             "tensors must be float32")
    _require(name, graph.dim() == 3, "graph must be (B, N, Cg)")
    _require(name, n % TILE_N == 0, f"N={n} must be a multiple of {TILE_N}")
    _require(name, band % TILE_N == 0 and TILE_N <= band <= min(n, MAX_N),
             f"band={band} must be a multiple of {TILE_N} in "
             f"128..min(N={n}, {MAX_N})")
    _require(name, 1 <= k <= band, f"k={k} out of range for band={band}")


def _launch_setup(graph: torch.Tensor, order, band: int):
    """The order, its inverse, the tile and the window starts on the
    device."""
    if order is None:
        order = sorted_order(graph)
    n = graph.shape[1]
    tile = band_tile(n, band)
    starts = window_starts(n, tile, band, graph.device)
    return order, inverse_order(order), tile, starts


def _entry(name: str, rowwarp: bool, nptr: int):
    """The C entry of a banded kernel (its row-warp route with
    ``rowwarp``), its argument types set."""
    fn = getattr(_build.load_library(),
                 f"dg_{name}_rowwarp" if rowwarp else f"dg_{name}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * nptr + [i] * 8 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def banded_edge_conv_eval_plain(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                                band: int, slope: float = 0.2,
                                order: torch.Tensor | None = None,
                                variant: str = "v1"):
    """Plain torch version of kernel 12: (B, N, Co) f32 in the input
    order; ``variant`` as ``edge_conv_eval_plain``'s."""
    if order is None:
        order = sorted_order(graph)
    gs, xs = sort_rows(graph, order), sort_rows(x, order)
    if variant == "v1":
        out = edge_conv_fused(xs, banded_knn_plain(gs, k, band), w_nbr,
                              w_ctr, scale, bias, slope)
    else:
        rows, present = window_rows(gs, _project(xs, w_nbr), k, band,
                                    variant, amp=False)
        out = stage_epilogue(*max_min(rows, present), _project(xs, w_ctr),
                             scale, bias, slope)
    return sort_rows(out, inverse_order(order))


def banded_edge_conv_eval_amp_plain(graph, x, w_nbr, w_ctr, scale, bias,
                                    k: int, band: int, slope: float = 0.2,
                                    order: torch.Tensor | None = None,
                                    variant: str | None = None):
    """Plain torch version of kernel 12's AMP form (kernel 1's over each
    window, ``edge_conv_eval_amp_plain``): (B, N, Co) bf16 in the input
    order."""
    if order is None:
        order = sorted_order(graph)
    select_x, plan = select_x_plan(*w_nbr.shape)
    gs, xs = sort_rows(graph, order), sort_rows(x, order)
    xf = xs.float()
    wn, wc = _amp_weights(xs, w_nbr, w_ctr, select_x)
    payload = round_bf16(xf) if select_x else round_bf16(xf @ wn)
    rows, present = window_rows(gs, payload, k, band, variant or plan,
                                amp=True)
    if select_x:
        rows = rows @ wn
    out = stage_epilogue(*max_min(rows, present), xf @ wc, scale, bias,
                         slope)
    return sort_rows(out.to(torch.bfloat16), inverse_order(order))


def banded_edge_conv_eval(graph: torch.Tensor, x: torch.Tensor,
                          w_nbr: torch.Tensor, w_ctr: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor, k: int,
                          band: int, slope: float = 0.2,
                          order: torch.Tensor | None = None, *,
                          rowwarp: bool = False,
                          amp: bool = False) -> torch.Tensor:
    """``edge_conv_eval`` (kNN over ``graph`` (B, N, Cg), factorized conv of
    ``x`` (B, N, Cin) with ``w_nbr``/``w_ctr`` (Cin, Co), max/min over the
    k neighbours, folded-BN affine, LeakyReLU) with each point's candidates
    pruned to the band of its query tile in ``order`` (B, N) (default:
    ``sorted_order(graph)``) -> (B, N, Co) in the input order.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 tensors with N a multiple of 128 (any N: the window,
    not the cloud, bounds the selection), a band that is a multiple of
    128 up to N and ``MAX_N`` (32768), k <= band and Co <= 256, and raises
    on anything else: its tiled route at k <= 64, its row-warp route
    otherwise or with ``rowwarp`` (the same bits).  ``amp`` runs the AMP
    form (f32 or bf16 graph and x, bf16 output; plain:
    ``banded_edge_conv_eval_amp_plain``); the variant is
    ``stage_variant``'s, and the forms other than the exact v1 take the
    same Co and any k <= band, on the same two routes (the AMP form at
    128 -> 256 selects the window's raw bf16 rows, select-x, as kernel 1's
    AMP form does over the cloud)."""
    name = "banded_edge_conv_eval"
    variant = stage_variant(amp, select_x_plan(*w_nbr.shape)[1])
    if graph.device.type == "cpu":
        fn = (banded_edge_conv_eval_amp_plain if amp
              else banded_edge_conv_eval_plain)
        return fn(graph, x, w_nbr, w_ctr, scale, bias, k, band, slope,
                  order, variant=variant)
    require_ported(name, amp, variant)
    if amp or variant != "v1":
        rowwarp = rowwarp or k > TILED_MAX_K
        order, inv, tile, starts = _launch_setup(graph, order, band)
        srow = srow_count()
        out = edge_conv_kernel.launch_variant(
            sort_rows(graph, order), sort_rows(x, order), w_nbr, w_ctr,
            scale, bias, k, slope, amp, variant, starts, tile, band,
            rowwarp=rowwarp)
        banded_edge_conv_eval.launches += 1
        banded_edge_conv_eval.amp_launches += amp
        banded_edge_conv_eval.v2_launches += not amp
        banded_edge_conv_eval.rowwarp_launches += rowwarp
        banded_edge_conv_eval.srow_launches += srow_count() - srow
        return sort_rows(out, inv)
    b, n, cg = graph.shape
    cin, co = w_nbr.shape
    _check(name, (graph, x, w_nbr, w_ctr, scale, bias), n, k, band)
    _require(name, x.shape == (b, n, cin) and w_ctr.shape == (cin, co)
             and scale.shape == (co,) and bias.shape == (co,),
             f"x {tuple(x.shape)}, w {tuple(w_nbr.shape)}/"
             f"{tuple(w_ctr.shape)}, scale/bias (Co,) vs graph "
             f"{tuple(graph.shape)}")
    _require(name, co <= MAX_CO, f"Co={co} > {MAX_CO}")
    order, inv, tile, starts = _launch_setup(graph, order, band)
    fn = _entry(name, rowwarp, 9)
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    gs = sort_rows(graph, order)
    xs = sort_rows(x, order)
    wcat = torch.cat([w_nbr, w_ctr], dim=1).contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    ac = torch.empty((b * n, 2 * co), device=graph.device, dtype=torch.float32)
    sq = torch.empty((b * n,), device=graph.device, dtype=torch.float32)
    out = torch.empty((b, n, co), device=graph.device, dtype=torch.float32)
    p = _build.ptr
    srow = srow_count()
    with torch.cuda.device(graph.device):
        rc = fn(p(gs), p(xs), p(wcat), p(scale), p(bias), p(starts), p(ac),
                p(sq), p(out), b, n, cg, cin, co, k, tile, band, float(slope),
                _build.stream_of(graph))
    _build.check(rc, name)
    banded_edge_conv_eval.launches += 1
    banded_edge_conv_eval.srow_launches += srow_count() - srow
    return sort_rows(out, inv)


def banded_knn_edge2_plain(graph, a1, b1, s1, t1, w2, s2, t2, k: int,
                           band: int, slope: float = 0.2,
                           order: torch.Tensor | None = None,
                           variant: str = "v1"):
    """Plain torch version of kernel 13: (B, N, C2) f32 in the input
    order; ``variant`` as ``knn_edge2_plain``'s."""
    if order is None:
        order = sorted_order(graph)
    gs, a1s, b1s = (sort_rows(t, order) for t in (graph, a1, b1))
    if variant == "v1":
        z2 = edge2_z2(a1s, b1s, s1, t1, w2, banded_knn_plain(gs, k, band),
                      slope) * s2 + t2
        out = torch.where(z2 >= 0, z2, slope * z2).amax(dim=2)
    else:
        rows, present = window_rows(gs, a1s, k, band, variant, amp=False)
        out = edge2_fold(rows, present, b1s, s1, t1, w2, s2, t2, slope)
    return sort_rows(out, inverse_order(order))


def banded_knn_edge2_amp_plain(graph, a1, b1, s1, t1, w2, s2, t2, k: int,
                               band: int, slope: float = 0.2,
                               order: torch.Tensor | None = None,
                               variant: str | None = None):
    """Plain torch version of kernel 13's AMP form (kernel 6's over each
    window, ``knn_edge2_amp_plain``): (B, N, C2) bf16 in the input
    order."""
    if order is None:
        order = sorted_order(graph)
    gs, a1s, b1s = (sort_rows(t, order) for t in (graph, a1, b1))
    rows, present = window_rows(gs, a1s, k, band,
                                variant or edge2_variant(a1.shape[-1]),
                                amp=True)
    out = edge2_fold(rows, present, b1s, s1, t1, w2, s2, t2, slope)
    return sort_rows(out.to(torch.bfloat16), inverse_order(order))


def banded_knn_edge2(graph: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor,
                     s1: torch.Tensor, t1: torch.Tensor, w2: torch.Tensor,
                     s2: torch.Tensor, t2: torch.Tensor, k: int, band: int,
                     slope: float = 0.2,
                     order: torch.Tensor | None = None, *,
                     rowwarp: bool = False,
                     amp: bool = False) -> torch.Tensor:
    """``knn_edge2`` (the two-conv block: for each neighbour j of point i
    ``LReLU((LReLU((a1[j] + b1[i]) * s1 + t1) @ w2) * s2 + t2)``, max over
    the neighbours) with each point's candidates pruned to the band of its
    query tile in ``order`` (B, N) (default: ``sorted_order(graph)``) ->
    (B, N, C2) in the input order.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 tensors with N a multiple of 128 (any N), a band
    that is a multiple of 128 up to N and ``MAX_N`` (32768), k <= band
    and C1, C2 <= 128, and
    raises on anything else: its tiled route at k <= 64, C1 <= 64 and C2
    <= 128, its row-warp route otherwise or with ``rowwarp`` (the same
    bits).  ``amp`` runs the AMP form (f32 or bf16 graph, bf16 output;
    plain: ``banded_knn_edge2_amp_plain``); the variant is
    ``stage_variant``'s, and the forms other than the exact v1 take the
    same shapes on the same two routes."""
    name = "banded_knn_edge2"
    variant = stage_variant(amp, edge2_variant(w2.shape[0]))
    if graph.device.type == "cpu":
        fn = banded_knn_edge2_amp_plain if amp else banded_knn_edge2_plain
        return fn(graph, a1, b1, s1, t1, w2, s2, t2, k, band, slope, order,
                  variant=variant)
    require_ported(name, amp, variant)
    if amp or variant != "v1":
        rowwarp = rowwarp or not edge2_kernel.tiled_route(*w2.shape, k)
        order, inv, tile, starts = _launch_setup(graph, order, band)
        gs, a1s, b1s = (sort_rows(t, order) for t in (graph, a1, b1))
        srow = srow_count()
        out = edge2_kernel.launch_variant(gs, a1s, b1s, s1, t1, w2, s2, t2,
                                          k, slope, amp, variant, starts,
                                          tile, band, rowwarp=rowwarp)
        banded_knn_edge2.launches += 1
        banded_knn_edge2.amp_launches += amp
        banded_knn_edge2.v2_launches += not amp
        banded_knn_edge2.rowwarp_launches += rowwarp
        banded_knn_edge2.srow_launches += srow_count() - srow
        return sort_rows(out, inv)
    b, n, cg = graph.shape
    c1, c2 = w2.shape
    _check(name, (graph, a1, b1, s1, t1, w2, s2, t2), n, k, band)
    _require(name, a1.shape == (b, n, c1) and b1.shape == (b, n, c1)
             and s1.shape == (c1,) and t1.shape == (c1,)
             and s2.shape == (c2,) and t2.shape == (c2,),
             f"a1 {tuple(a1.shape)}, b1 {tuple(b1.shape)}, affines vs graph "
             f"{tuple(graph.shape)} and w2 {tuple(w2.shape)}")
    _require(name, c1 <= MAX_C and c2 <= MAX_C, f"C1, C2 must be <= {MAX_C}")
    order, inv, tile, starts = _launch_setup(graph, order, band)
    fn = _entry(name, rowwarp, 11)
    gs, a1s, b1s = (sort_rows(t, order) for t in (graph, a1, b1))
    small = [t.contiguous() for t in (w2, s1, t1, s2, t2)]
    sq = torch.empty((b * n,), device=graph.device, dtype=torch.float32)
    out = torch.empty((b, n, c2), device=graph.device, dtype=torch.float32)
    p = _build.ptr
    srow = srow_count()
    with torch.cuda.device(graph.device):
        rc = fn(p(gs), p(a1s), p(b1s), *map(p, small), p(starts), p(sq),
                p(out), b, n, cg, c1, c2, k, tile, band, float(slope),
                _build.stream_of(graph))
    _build.check(rc, name)
    banded_knn_edge2.launches += 1
    banded_knn_edge2.srow_launches += srow_count() - srow
    return sort_rows(out, inv)


# launches of the kernels since the counts were last set to 0 (amp_launches:
# those of their AMP forms; v2_launches: those of their exact v2 forms;
# rowwarp_launches: those of either on the row-warp route; srow_launches:
# those of any form on the row-warp route's shared row)
for _fn in (banded_edge_conv_eval, banded_knn_edge2):
    _fn.launches = _fn.amp_launches = _fn.v2_launches = 0
    _fn.rowwarp_launches = _fn.srow_launches = 0
