"""Kernel 1: one whole eval EdgeConv stage, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::fused_edge_conv_eval`` (body
``_edge_conv1_kernel``) in its exact f32 mode.  The kernel is
``csrc/edge_conv_eval.cu``; its note states the bound on an H100 and what
the design does about it.  It picks its route from the shape: at k <= 64
the tiled selection of ``csrc/knn_select.cuh`` (a block's 64 rows scored
against the cloud in tiles of 128 columns, a running top-k a row in
registers), above it the row-warp selection; both give the same bits.
``edge_conv_eval_plain`` beside it is the same
function in plain torch (kNN, then the factorized conv and reduction): the
wrapper runs it for CPU tensors and launches the kernel for CUDA tensors.

``amp=True`` is the AMP form, the JAX package's default
(``_edge_conv1_kernel`` at ``select_dtype=bf16``): AMP scores, the
``select_x_plan`` of the stage's widths (v3 or v2, project-first or
select-x), bf16 payloads and a bf16 output (``ops/amp_select.py``; the
kernel's note says how ``csrc/edge_conv_eval.cu`` computes them).
``edge_conv_eval_amp_plain`` is its plain version.

The extraction variant is the JAX package's (``amp_select.stage_variant``:
``DGCNN_TPU_EXTRACT`` wins, v1 in the exact mode, the plan's in AMP).  The
CUDA forms take the exact v1 and v2 (the semseg CLI's pin: the packed keys
of the exact scores, f32 payload and output) and the AMP v2 and v3, and
raise on the others; the plain versions take every variant.
``launch_variant`` launches the forms other than the exact v1, for the
whole cloud or (kernel 12, ``ops/banded.py``) each query tile's window, at
any k <= N as the JAX kernel takes it: the tiled selection at k <= 64, the
row-warp selection in the same mode above (``csrc/edge_conv_amp.cu``;
``rowwarp=True`` forces it at any k, the oracle that holds the tiled
route's earlier form to its bits).

On the cloud's tiled route (``amp_route``: "tensor" at k <= 64 and Kp <=
384, every model's stages) the AMP forms' scores come from the tensor
cores in both v2 passes and in v3's (``csrc/edge_conv_amp_tc.cu``): bf16
operands, the f32 graph's hi and lo parts or the bf16 graph itself,
``mma.sync`` products with f32 sums, and v3's first tile fills each row's
class list by the sorting network.  ``simt=True`` keeps the earlier form
callable, the f32 fmaf chain on the CUDA cores (the A/B's other side; the
row-warp route's bits), as do kernel 12's windows.  ``class_lists``
shows the v3 lists of the tensor-core scores, from either fill, with
each class recounted (the checks' view of the selection).
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.amp_select import (
    TC_MAX_KP,
    amp_scores,
    max_min,
    require_ported,
    round_bf16,
    select_rows,
    select_x_plan,
    stage_variant,
    tc_channels,
    tc_scores_plain,
    v1_indices,
    v2_indices,
    v3_class_lists,
    v3_class_means,
)
from dgcnn_tpu_torch.ops.edge_conv import _project, edge_conv_fused
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import (
    MAX_CO,
    MAX_N,
    TILED_MAX_K,
    knn_plain,
    pairwise_neg_sqdist,
    srow_count,
)


def edge_conv_eval_plain(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                         slope: float = 0.2,
                         variant: str = "v1") -> torch.Tensor:
    """Plain torch version of the kernel: (B, N, Co) f32.  ``variant``
    v1 (torch.topk's order), v2 (the packed keys of the exact scores) or
    v3 (the class means of the exact scores' classes)."""
    if variant == "v1":
        return edge_conv_fused(x, knn_plain(graph, k), w_nbr, w_ctr, scale,
                               bias, slope)
    rows, present = select_rows(pairwise_neg_sqdist(graph),
                                _project(x, w_nbr), k, variant)
    return stage_epilogue(*max_min(rows, present), _project(x, w_ctr),
                          scale, bias, slope)


def stage_epilogue(vmax, vmin, centre, scale, bias, slope: float):
    """The folded BatchNorm and LeakyReLU of the selected max or min (by
    the sign of ``scale``) plus the centre term, f32."""
    y = (torch.where(scale > 0, vmax, vmin) + centre) * scale + bias
    return torch.where(y >= 0, y, slope * y)


def _amp_weights(x, w_nbr, w_ctr, select_x: bool):
    """(W_nbr, W_ctr) as the AMP stage projects with them: rounded to bf16
    where x is bf16, but W_nbr of select-x, which projects each
    selection in f32."""
    bf = x.dtype == torch.bfloat16
    wn = w_nbr.float() if select_x or not bf else round_bf16(w_nbr.float())
    wc = round_bf16(w_ctr.float()) if bf else w_ctr.float()
    return wn, wc


def edge_conv_eval_amp_plain(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                             slope: float = 0.2,
                             variant: str | None = None) -> torch.Tensor:
    """Plain torch version of the AMP form: (B, N, Co) bf16.  ``graph``
    and ``x`` are f32 or bf16; ``variant`` None takes the plan's."""
    cin, co = w_nbr.shape
    select_x, plan = select_x_plan(cin, co)
    variant = variant or plan
    scores = amp_scores(graph, graph)
    xf = x.float()
    wn, wc = _amp_weights(x, w_nbr, w_ctr, select_x)
    payload = round_bf16(xf) if select_x else round_bf16(xf @ wn)
    if variant != "v3":
        idx = (v2_indices if variant == "v2" else v1_indices)(scores, k)
        sel = gather_neighbors(payload @ wn if select_x else payload, idx)
        vmax, vmin = sel.amax(dim=2), sel.amin(dim=2)
    else:
        means, present = v3_class_means(scores, payload, k)
        if select_x:
            means = means @ wn
        vmax = torch.where(present[..., None], means, -torch.inf).amax(2)
        vmin = torch.where(present[..., None], means, torch.inf).amin(2)
    sel = torch.where(scale > 0, vmax, vmin) + xf @ wc
    y = sel * scale + bias
    return torch.where(y >= 0, y, slope * y).to(torch.bfloat16)


def amp_route(k: int, n: int, co: int, cg: int,
              bf16_graph: bool = False) -> str:
    """The route of kernel 1's AMP form on the card over a cloud at (k,
    N, Co, Cg; a bf16 graph or an f32 one): "tensor" (the tiled selection,
    its scores on the tensor cores) at k <= ``TILED_MAX_K`` and Kp =
    ``tc_channels(Cg)`` <= ``TC_MAX_KP`` (every model's stages), "simt"
    (the tiled selection, f32 scores on the CUDA cores: the earlier form)
    at a wider graph, "rowwarp" (the row-warp selection) above k = 64,
    "none" where the kernel raises.  ``simt=True`` sends the tiled route
    to its earlier form, ``rowwarp=True`` to the row-warp route."""
    if (n % 128 or n > MAX_N or not 1 <= k <= n or not 1 <= co <= MAX_CO
            or cg < 1):
        return "none"
    if k > TILED_MAX_K:
        return "rowwarp"
    return "tensor" if tc_channels(cg, bf16_graph) <= TC_MAX_KP else "simt"


def _lib():
    lib = _build.load_library()
    fn = lib.dg_edge_conv_eval
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"edge_conv_eval: {msg}")


def edge_conv_eval(graph: torch.Tensor, x: torch.Tensor, w_nbr: torch.Tensor,
                   w_ctr: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, k: int, slope: float = 0.2, *,
                   amp: bool = False, rowwarp: bool = False,
                   simt: bool = False) -> torch.Tensor:
    """kNN over ``graph`` (B, N, Cg), factorized conv of ``x`` (B, N, Cin)
    with ``w_nbr``/``w_ctr`` (Cin, Co), max/min over the k neighbours,
    folded-BN affine ``scale``/``bias`` (Co,) and LeakyReLU -> (B, N, Co).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 contiguous tensors with N a multiple of 128, N <=
    ``MAX_N`` (32768) and Co <= 256, and raises on anything else.  ``amp``
    runs the AMP form (plain: ``edge_conv_eval_amp_plain``), whose kernel
    takes f32 or bf16 ``graph`` and ``x``, the same N and Co and any k <=
    N, and returns bf16.  The extraction variant is ``stage_variant``'s; the
    exact v2 form takes the AMP form's shapes and returns f32.
    ``rowwarp`` launches those forms' row-warp route at any k (the exact
    v1's is the banded entry's at band = N); ``simt`` the AMP form's
    earlier tiled form (``amp_route``)."""
    variant = stage_variant(amp, select_x_plan(*w_nbr.shape)[1])
    if graph.device.type == "cpu":
        fn = edge_conv_eval_amp_plain if amp else edge_conv_eval_plain
        return fn(graph, x, w_nbr, w_ctr, scale, bias, k, slope,
                  variant=variant)
    require_ported("edge_conv_eval", amp, variant)
    _require(not simt or amp, "simt names the AMP form's earlier form")
    if amp or variant != "v1":
        rowwarp = rowwarp or k > TILED_MAX_K
        srow = srow_count()
        out = launch_variant(graph, x, w_nbr, w_ctr, scale, bias, k, slope,
                             amp, variant, rowwarp=rowwarp, simt=simt)
        edge_conv_eval.launches += 1
        edge_conv_eval.amp_launches += amp
        edge_conv_eval.tc_launches += _tensor(graph, w_nbr.shape[1], k, amp,
                                              None, rowwarp, simt)
        edge_conv_eval.v2_launches += not amp
        edge_conv_eval.rowwarp_launches += rowwarp
        edge_conv_eval.srow_launches += srow_count() - srow
        return out
    _require(not rowwarp, "the exact v1's row-warp route is the banded "
             "entry's at band = N")
    _require(graph.is_cuda, f"no kernel for device {graph.device}")
    tensors = (graph, x, w_nbr, w_ctr, scale, bias)
    _require(all(t.device == graph.device for t in tensors),
             "all tensors must be on one device")
    _require(all(t.dtype == torch.float32 for t in tensors),
             "tensors must be float32")
    _require(graph.is_contiguous() and x.is_contiguous(),
             "graph and x must be contiguous")
    b, n, cg = graph.shape
    cin, co = w_nbr.shape
    _require(x.shape == (b, n, cin), f"x {tuple(x.shape)} vs graph "
             f"{tuple(graph.shape)} and w_nbr {tuple(w_nbr.shape)}")
    _require(w_ctr.shape == (cin, co), "w_ctr must match w_nbr")
    _require(scale.shape == (co,) and bias.shape == (co,),
             "scale/bias must be (Co,)")
    _require(n % 128 == 0 and n <= MAX_N,
             f"N={n} must be a multiple of 128 and <= {MAX_N}")
    _require(co <= MAX_CO, f"Co={co} > {MAX_CO}")
    _require(1 <= k <= n, f"k={k} out of range for N={n}")
    fn = _lib()
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    wcat = torch.cat([w_nbr, w_ctr], dim=1).contiguous()
    scale = scale.contiguous()
    bias = bias.contiguous()
    ac = torch.empty((b * n, 2 * co), device=graph.device, dtype=torch.float32)
    sq = torch.empty((b * n,), device=graph.device, dtype=torch.float32)
    out = torch.empty((b, n, co), device=graph.device, dtype=torch.float32)
    p = _build.ptr
    srow = srow_count()
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(x), p(wcat), p(scale), p(bias), p(ac), p(sq),
                p(out), b, n, cg, cin, co, k, float(slope),
                _build.stream_of(graph))
    _build.check(rc, "edge_conv_eval")
    edge_conv_eval.launches += 1
    edge_conv_eval.srow_launches += srow_count() - srow
    return out


def _tensor(graph, co: int, k: int, amp: bool, starts, rowwarp: bool,
            simt: bool) -> bool:
    """Whether a launch of the AMP form takes the tensor-core scores: over
    the cloud (not kernel 12's windows) on ``amp_route``'s "tensor" route,
    unless ``rowwarp`` or ``simt`` ask for another."""
    b, n, cg = graph.shape
    return (amp and starts is None and not (rowwarp or simt)
            and amp_route(k, n, co, cg,
                          graph.dtype == torch.bfloat16) == "tensor")


def launch_variant(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                   slope: float, amp: bool, variant: str, starts=None,
                   tile: int = 0, band: int = 0, rowwarp: bool = False,
                   simt: bool = False) -> torch.Tensor:
    """Launches the AMP v2 / v3 form or the exact v2 form of the stage on
    CUDA tensors: over the whole cloud, or with ``starts`` (the window
    starts of each query tile of ``tile`` rows) over windows of ``band``
    rows of a sorted cloud (kernel 12).  The kernel takes its row-warp
    route at k > 64 or with ``rowwarp``, its tiled route otherwise, the
    AMP form's over the cloud with the tensor-core scores unless ``simt``
    (``_tensor``).  Checks the tensors and raises on what the kernel does
    not take."""
    name = "banded_edge_conv_eval" if starts is not None else "edge_conv_eval"

    def need(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    need(graph.is_cuda, f"no kernel for device {graph.device}")
    tensors = (graph, x, w_nbr, w_ctr, scale, bias)
    need(all(t.device == graph.device for t in tensors),
         "all tensors must be on one device")
    dtypes = (torch.float32, torch.bfloat16) if amp else (torch.float32,)
    need(all(t.dtype in dtypes for t in (graph, x)),
         f"graph and x must be {' or '.join(map(str, dtypes))}")
    need(all(t.dtype == torch.float32 for t in tensors[2:]),
         "weights, scale and bias must be float32")
    need(graph.is_contiguous() and x.is_contiguous(),
         "graph and x must be contiguous")
    b, n, cg = graph.shape
    cin, co = w_nbr.shape
    w = band or n
    need(x.shape == (b, n, cin), f"x {tuple(x.shape)} vs graph "
         f"{tuple(graph.shape)} and w_nbr {tuple(w_nbr.shape)}")
    need(w_ctr.shape == (cin, co), "w_ctr must match w_nbr")
    need(scale.shape == (co,) and bias.shape == (co,),
         "scale/bias must be (Co,)")
    # the banded forms (starts) take any N: their window bounds them
    need(n % 128 == 0 and w <= MAX_N,
         f"N={n} must be a multiple of 128 and {'the band' if band else 'N'}"
         f" <= {MAX_N}")
    rowwarp = rowwarp or k > TILED_MAX_K
    need(co <= MAX_CO, f"the {variant} form takes Co <= {MAX_CO}")
    need(1 <= k <= w, f"the {variant} form takes 1 <= k <= {w} (k={k})")
    select_x = amp and select_x_plan(cin, co)[0]
    need(not (select_x and variant == "v3"),
         "the kernel takes select-x with v2 only")
    fn = getattr(_build.load_library(), "dg_edge_conv_eval_variant")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    dev = graph.device
    gbf, xbf = graph.dtype == torch.bfloat16, x.dtype == torch.bfloat16
    if amp:
        wn, wc = _amp_weights(x, w_nbr, w_ctr, select_x)
    else:
        wn, wc = w_nbr, w_ctr
    wcat = torch.cat([wn, wc], dim=1).contiguous()
    tensor = _tensor(graph, co, k, amp, starts, rowwarp, simt)
    # the score operands: f32, Cg (a bf16 graph) or 3 Cg a point, or with
    # the tensor cores Kp bf16 (none for a bf16 graph of Kp channels)
    kp = tc_channels(cg, gbf)
    cs = kp // 2 if tensor else cg if gbf or not amp else 3 * cg
    own = amp and not (tensor and gbf and kp == cg)

    def scratch(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    gc = scratch(b * n * cs) if own else None
    gq = scratch(b * n * cs) if own and not gbf else None
    xf = scratch(b * n * cin) if xbf else None
    sq, rmin, ac = scratch(b * n), scratch(b * n), scratch(b * n * 2 * co)
    out = torch.empty((b, n, co), device=dev,
                      dtype=torch.bfloat16 if amp else torch.float32)
    flags = (gbf | xbf << 1 | select_x << 2 | (variant == "v3") << 3
             | (not amp) << 4 | rowwarp << 5 | tensor << 6)
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(p(graph), p(x), p(wcat), p(scale.contiguous()),
                p(bias.contiguous()), p(gq), p(gc), p(xf), p(sq), p(rmin),
                p(ac), p(out), p(starts), b, n, cg, cin, co, k, tile or n,
                w, float(slope), flags, _build.stream_of(graph))
    _build.check(rc, name)
    return out


def class_lists(graph: torch.Tensor, k: int, *,
                serial: bool = False) -> dict:
    """The v3 selection's class lists of ``graph`` (B, N, Cg; f32 or
    bf16) over the tensor-core scores, as the tiled route's AMP v3 forms
    of kernels 1 and 6 build them: {"values" (B, N, k) f32, -inf past a
    row's last class; "counts", "lows" (B, N, k) int32, each class's
    member count and lowest member (the list's words); "recount",
    "relow": the members that a consumer's second scoring of the row
    finds, and the lowest of them}.  ``serial``: the first tile inserted
    column by column (the earlier fill) instead of sorted; the lists are
    the same bits.  CPU tensors take the plain version
    (``v3_class_lists`` over ``tc_scores_plain``, the recount over the
    same scores).  k <= 64."""
    b, n, cg = graph.shape
    if graph.device.type == "cpu":
        scores = tc_scores_plain(graph)
        vals, cnt, low = v3_class_lists(scores, k)
        hit = scores[:, :, None, :] == vals[..., None]
        first = torch.where(hit.any(-1), hit.int().argmax(-1), -1)
        return {"values": vals, "counts": cnt, "lows": low,
                "recount": hit.sum(-1).int(), "relow": first.int()}
    _require(graph.is_cuda and graph.is_contiguous()
             and graph.dtype in (torch.float32, torch.bfloat16),
             "class_lists takes a contiguous f32 or bf16 CUDA graph")
    _require(n % 128 == 0 and n <= MAX_N and 1 <= k <= min(TILED_MAX_K, n),
             f"class_lists takes N a multiple of 128 <= {MAX_N} and k <= "
             f"{TILED_MAX_K} (N={n}, k={k})")
    gbf = graph.dtype == torch.bfloat16
    fn = getattr(_build.load_library(), "dg_knn_class_lists")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 5 + [p] * 5
        fn.restype = i
    dev = graph.device
    ops = [torch.empty(b * n * tc_channels(cg, gbf), device=dev,
                       dtype=torch.bfloat16) for _ in range(2)]
    sq = torch.empty(b * n, device=dev, dtype=torch.float32)
    vals = torch.empty((b, n, k), device=dev, dtype=torch.float32)
    words, cnt, low = (torch.empty((b, n, k), device=dev, dtype=torch.int32)
                       for _ in range(3))
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(p(graph), p(ops[0]), p(ops[1]), p(sq), b, n, cg, k,
                gbf | serial << 1, p(vals), p(words), p(cnt), p(low),
                _build.stream_of(graph))
    _build.check(rc, "class_lists")
    return {"values": vals,
            "counts": torch.bitwise_right_shift(words, 16) & 0xffff,
            "lows": words & 0xffff, "recount": cnt, "relow": low}


# launches of the kernel since the count was last set to 0 (amp_launches:
# those of its AMP form; tc_launches: those of its AMP form with the
# tensor-core scores; v2_launches: those of its exact v2 form;
# rowwarp_launches: those of either on the row-warp route; srow_launches:
# those of any form on the row-warp route's shared row)
edge_conv_eval.launches = 0
edge_conv_eval.amp_launches = 0
edge_conv_eval.tc_launches = 0
edge_conv_eval.v2_launches = 0
edge_conv_eval.rowwarp_launches = 0
edge_conv_eval.srow_launches = 0
