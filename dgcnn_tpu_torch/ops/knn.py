"""k-nearest-neighbour graph construction (port of dgcnn_tpu/ops/knn.py)
and kernel 11, the idx-only kNN, hand-written CUDA.

The score is the negative squared euclidean distance
``2<xi,xj> - |xi|^2 - |xj|^2`` in f32, and the k highest-scoring columns of
each row are its neighbours, self first.  Ties go to the lowest index, as
``lax.top_k`` and ``torch.topk`` order them on the reference path;
``knn_plain``'s stable descending sort makes that order explicit instead
of relying on ``torch.topk``'s unspecified tie order.

``knn`` takes the place of the JAX package's ``knn``: CPU tensors take
``knn_plain``; CUDA tensors launch ``csrc/knn_idx.cu``, which replaces
``dgcnn_tpu/ops/pallas_knn.py::knn_pallas`` (body ``_knn_only_kernel``) in
its exact mode.  The kernel's note states its bound on an H100 and what
the design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build

# the most points a cloud of the selection kernels may hold
# (csrc/knn_select.cuh: N / 32 <= 128 scores a lane)
MAX_N = 4096


def pairwise_neg_sqdist(x: torch.Tensor,
                        y: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B, N, M) scores, -||x_i - y_j||^2 up to
    rounding, computed in f32."""
    if y is None:
        y = x
    x = x.float()
    y = y.float()
    inner = torch.bmm(x, y.transpose(1, 2))
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    return 2.0 * inner - xx[:, :, None] - yy[:, None, :]


def knn_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version of kernel 11: (B, N, C) -> (B, N, k) int64
    neighbour indices, nearest (self) first, lowest index first among
    equal scores."""
    scores = pairwise_neg_sqdist(x)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"knn: {msg}")


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, k) int64 neighbour indices, nearest (self)
    first, lowest index first among equal scores.  No gradient flows
    through the selection.

    CPU tensors take ``knn_plain``; CUDA tensors launch the kernel, which
    takes f32 contiguous points with N a multiple of 128 and N <= 4096 and
    raises on anything else.  The kernel writes int32 indices; they are
    widened to int64, the index type of torch's gathers, so that both
    devices return the same type."""
    x = x.detach()
    if x.device.type == "cpu":
        return knn_plain(x, k)
    _require(x.is_cuda, f"no kernel for device {x.device}")
    _require(x.dtype == torch.float32, "x must be float32")
    _require(x.dim() == 3 and x.is_contiguous(),
             "x must be a contiguous (B, N, C) tensor")
    b, n, c = x.shape
    _require(n % 128 == 0 and n <= MAX_N,
             f"N={n} must be a multiple of 128 and <= {MAX_N}")
    _require(1 <= k <= n, f"k={k} out of range for N={n}")
    fn = _build.load_library().dg_knn_idx
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    sq = torch.empty((b * n,), device=x.device, dtype=torch.float32)
    idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr(x), _build.ptr(sq), _build.ptr(idx), b, n, c, k,
                _build.stream_of(x))
    _build.check(rc, "knn")
    knn.launches += 1
    return idx.long()


# launches of the kernel since the count was last set to 0
knn.launches = 0
