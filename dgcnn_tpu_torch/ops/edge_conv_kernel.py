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
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.amp_select import (
    AMP_MAX_K,
    amp_scores,
    round_bf16,
    select_x_plan,
    v2_indices,
    v3_class_means,
)
from dgcnn_tpu_torch.ops.edge_conv import edge_conv_fused
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import MAX_N, knn_plain
from dgcnn_tpu_torch.ops.knn_reduce_kernel import max_co


def edge_conv_eval_plain(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                         slope: float = 0.2) -> torch.Tensor:
    """Plain torch version of the kernel: (B, N, Co) f32."""
    return edge_conv_fused(x, knn_plain(graph, k), w_nbr, w_ctr, scale, bias,
                           slope)


def _amp_weights(x, w_nbr, w_ctr, select_x: bool):
    """(W_nbr, W_ctr) as the AMP stage projects with them: rounded to bf16
    where x is bf16, but W_nbr of select-x, which projects each
    selection in f32."""
    bf = x.dtype == torch.bfloat16
    wn = w_nbr.float() if select_x or not bf else round_bf16(w_nbr.float())
    wc = round_bf16(w_ctr.float()) if bf else w_ctr.float()
    return wn, wc


def edge_conv_eval_amp_plain(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                             slope: float = 0.2) -> torch.Tensor:
    """Plain torch version of the AMP form: (B, N, Co) bf16.  ``graph``
    and ``x`` are f32 or bf16."""
    cin, co = w_nbr.shape
    select_x, variant = select_x_plan(cin, co)
    scores = amp_scores(graph, graph)
    xf = x.float()
    wn, wc = _amp_weights(x, w_nbr, w_ctr, select_x)
    payload = round_bf16(xf) if select_x else round_bf16(xf @ wn)
    if variant == "v2":
        sel = gather_neighbors(payload @ wn if select_x else payload,
                               v2_indices(scores, k))
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
                   amp: bool = False) -> torch.Tensor:
    """kNN over ``graph`` (B, N, Cg), factorized conv of ``x`` (B, N, Cin)
    with ``w_nbr``/``w_ctr`` (Cin, Co), max/min over the k neighbours,
    folded-BN affine ``scale``/``bias`` (Co,) and LeakyReLU -> (B, N, Co).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 contiguous tensors with N a multiple of 128, N <= 4096
    and Co <= 256 (Co <= 128 above N=2048), and raises on anything
    else.  ``amp`` runs the AMP form (plain: ``edge_conv_eval_amp_plain``),
    whose kernel takes f32 or bf16 ``graph`` and ``x``, the same N, Co <=
    256 and k <= 64 (its tiled route alone), and returns bf16."""
    if graph.device.type == "cpu":
        fn = edge_conv_eval_amp_plain if amp else edge_conv_eval_plain
        return fn(graph, x, w_nbr, w_ctr, scale, bias, k, slope)
    if amp:
        return _edge_conv_eval_amp(graph, x, w_nbr, w_ctr, scale, bias, k,
                                   slope)
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
    _require(co <= max_co(n), f"Co={co} > {max_co(n)} for N={n}")
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
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(x), p(wcat), p(scale), p(bias), p(ac), p(sq),
                p(out), b, n, cg, cin, co, k, float(slope),
                _build.stream_of(graph))
    _build.check(rc, "edge_conv_eval")
    edge_conv_eval.launches += 1
    return out


def _edge_conv_eval_amp(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                        slope: float) -> torch.Tensor:
    _require(graph.is_cuda, f"no kernel for device {graph.device}")
    tensors = (graph, x, w_nbr, w_ctr, scale, bias)
    _require(all(t.device == graph.device for t in tensors),
             "all tensors must be on one device")
    _require(all(t.dtype in (torch.float32, torch.bfloat16)
                 for t in (graph, x)), "graph and x must be f32 or bf16")
    _require(all(t.dtype == torch.float32 for t in tensors[2:]),
             "weights, scale and bias must be float32")
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
    _require(co <= AMP_MAX_CO, f"the AMP form takes Co <= {AMP_MAX_CO}")
    _require(1 <= k <= AMP_MAX_K,
             f"the AMP form takes 1 <= k <= {AMP_MAX_K} (k={k})")
    select_x, variant = select_x_plan(cin, co)
    _require(not (select_x and variant == "v3"),
             "the AMP kernel does not take select-x with v3")
    fn = getattr(_build.load_library(), "dg_edge_conv_eval_amp")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 6 + [ctypes.c_float, i, p]
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    dev = graph.device
    gbf, xbf = graph.dtype == torch.bfloat16, x.dtype == torch.bfloat16
    wn, wc = _amp_weights(x, w_nbr, w_ctr, select_x)
    wcat = torch.cat([wn, wc], dim=1).contiguous()
    cs = cg if gbf else 3 * cg

    def scratch(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    gc = scratch(b * n * cs)
    gq = gc if gbf else scratch(b * n * cs)
    xf = scratch(b * n * cin) if xbf else gc
    sq, rmin, ac = scratch(b * n), scratch(b * n), scratch(b * n * 2 * co)
    out = torch.empty((b, n, co), device=dev, dtype=torch.bfloat16)
    flags = gbf | xbf << 1 | select_x << 2 | (variant == "v3") << 3
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(p(graph), p(x), p(wcat), p(scale.contiguous()),
                p(bias.contiguous()), p(gq), p(gc), p(xf), p(sq), p(rmin),
                p(ac), p(out), b, n, cg, cin, co, k, float(slope), flags,
                _build.stream_of(graph))
    _build.check(rc, "edge_conv_eval")
    edge_conv_eval.launches += 1
    edge_conv_eval.amp_launches += 1
    return out


# the AMP form's widest stage (its tiled route alone; k: AMP_MAX_K)
AMP_MAX_CO = 256

# launches of the kernel since the count was last set to 0 (amp_launches:
# those of its AMP form)
edge_conv_eval.launches = 0
edge_conv_eval.amp_launches = 0
