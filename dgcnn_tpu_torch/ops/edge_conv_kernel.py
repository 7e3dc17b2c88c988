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
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.edge_conv import edge_conv_fused
from dgcnn_tpu_torch.ops.knn import MAX_N, knn_plain
from dgcnn_tpu_torch.ops.knn_reduce_kernel import max_co


def edge_conv_eval_plain(graph, x, w_nbr, w_ctr, scale, bias, k: int,
                         slope: float = 0.2) -> torch.Tensor:
    """Plain torch version of the kernel: (B, N, Co) f32."""
    return edge_conv_fused(x, knn_plain(graph, k), w_nbr, w_ctr, scale, bias,
                           slope)


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
                   bias: torch.Tensor, k: int,
                   slope: float = 0.2) -> torch.Tensor:
    """kNN over ``graph`` (B, N, Cg), factorized conv of ``x`` (B, N, Cin)
    with ``w_nbr``/``w_ctr`` (Cin, Co), max/min over the k neighbours,
    folded-BN affine ``scale``/``bias`` (Co,) and LeakyReLU -> (B, N, Co).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 contiguous tensors with N a multiple of 128, N <= 4096
    and Co <= 256 (Co <= 128 above N=2048), and raises on anything
    else."""
    if graph.device.type == "cpu":
        return edge_conv_eval_plain(graph, x, w_nbr, w_ctr, scale, bias, k,
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


# launches of the kernel since the count was last set to 0
edge_conv_eval.launches = 0
