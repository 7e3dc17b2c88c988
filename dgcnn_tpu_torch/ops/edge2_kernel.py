"""Kernel 6: one whole eval two-conv EdgeConv block, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::fused_knn_edge2`` (body
``_knn_edge2_kernel``) in its exact f32 mode.  The kernel is
``csrc/knn_edge2.cu``; its note states the bound on an H100 and what the
design does about it.  ``knn_edge2_plain`` beside it is the same function
in plain torch (kNN, gather, both convs on every edge, max over k): the
wrapper runs it for CPU tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import knn
from dgcnn_tpu_torch.ops.knn_reduce_kernel import MAX_N

MAX_C = 128


def edge2_z2(a1, b1, s1, t1, w2, idx, slope: float = 0.2) -> torch.Tensor:
    """The second conv's pre-activation on every edge, (B, N, k, C2):
    ``LReLU((a1[idx] + b1) * s1 + t1) @ w2`` in that operation order."""
    z1 = (gather_neighbors(a1, idx.long()) + b1[:, :, None]) * s1 + t1
    return torch.matmul(torch.where(z1 >= 0, z1, slope * z1), w2)


def knn_edge2_plain(graph, a1, b1, s1, t1, w2, s2, t2, k: int,
                    slope: float = 0.2) -> torch.Tensor:
    """Plain torch version of the kernel: (B, N, C2) f32."""
    z2 = edge2_z2(a1, b1, s1, t1, w2, knn(graph, k), slope) * s2 + t2
    return torch.where(z2 >= 0, z2, slope * z2).amax(dim=2)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"knn_edge2: {msg}")


def knn_edge2(graph: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor,
              s1: torch.Tensor, t1: torch.Tensor, w2: torch.Tensor,
              s2: torch.Tensor, t2: torch.Tensor, k: int,
              slope: float = 0.2) -> torch.Tensor:
    """kNN over ``graph`` (B, N, Cg), then for each of the k neighbours j
    of point i ``LReLU((LReLU((a1[j] + b1[i]) * s1 + t1) @ w2) * s2 + t2)``
    and its max over the neighbours -> (B, N, C2).  ``a1``/``b1`` (B, N,
    C1) are the first conv's neighbour and centre projections, ``s1``/``t1``
    (C1,) and ``s2``/``t2`` (C2,) the folded BatchNorms, ``w2`` (C1, C2) the
    second conv.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 tensors (graph, a1 and b1 contiguous) with N a multiple
    of 128, N <= 4096 and C1, C2 <= 128, and raises on anything else."""
    if graph.device.type == "cpu":
        return knn_edge2_plain(graph, a1, b1, s1, t1, w2, s2, t2, k, slope)
    _require(graph.is_cuda, f"no kernel for device {graph.device}")
    tensors = (graph, a1, b1, s1, t1, w2, s2, t2)
    _require(all(t.device == graph.device for t in tensors),
             "all tensors must be on one device")
    _require(all(t.dtype == torch.float32 for t in tensors),
             "tensors must be float32")
    _require(graph.is_contiguous() and a1.is_contiguous()
             and b1.is_contiguous(), "graph, a1 and b1 must be contiguous")
    _require(graph.dim() == 3, "graph must be (B, N, Cg)")
    b, n, cg = graph.shape
    c1, c2 = w2.shape
    _require(a1.shape == (b, n, c1) and b1.shape == (b, n, c1),
             f"a1 {tuple(a1.shape)}, b1 {tuple(b1.shape)} vs graph "
             f"{tuple(graph.shape)} and w2 {tuple(w2.shape)}")
    _require(s1.shape == (c1,) and t1.shape == (c1,)
             and s2.shape == (c2,) and t2.shape == (c2,),
             "s1/t1 must be (C1,) and s2/t2 (C2,)")
    _require(n % 128 == 0 and n <= MAX_N,
             f"N={n} must be a multiple of 128 and <= {MAX_N}")
    _require(c1 <= MAX_C and c2 <= MAX_C, f"C1, C2 must be <= {MAX_C}")
    _require(1 <= k <= n, f"k={k} out of range for N={n}")
    fn = _build.load_library().dg_knn_edge2
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, p]
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    small = [t.contiguous() for t in (w2, s1, t1, s2, t2)]
    sq = torch.empty((b * n,), device=graph.device, dtype=torch.float32)
    out = torch.empty((b, n, c2), device=graph.device, dtype=torch.float32)
    p = _build.ptr
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(a1), p(b1), *map(p, small), p(sq), p(out), b, n,
                cg, c1, c2, k, float(slope), _build.stream_of(graph))
    _build.check(rc, "knn_edge2")
    knn_edge2.launches += 1
    return out


# launches of the kernel since the count was last set to 0
knn_edge2.launches = 0
