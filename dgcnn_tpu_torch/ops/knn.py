"""k-nearest-neighbour graph construction (port of dgcnn_tpu/ops/knn.py)
and kernel 11, the idx-only kNN, hand-written CUDA.

The score is the negative squared euclidean distance
``2<xi,xj> - |xi|^2 - |xj|^2`` in f32, and the k highest-scoring columns of
each row are its neighbours, self first.  Ties go to the lowest index, as
``lax.top_k`` and ``torch.topk`` order them on the reference path;
``knn_plain``'s stable descending sort makes that order explicit instead
of relying on ``torch.topk``'s unspecified tie order.

``knn`` takes the place of the JAX package's ``knn``: CPU tensors, and
clouds whose size the kernels do not take (``use_kernel``, the port of
``use_pallas``), take ``knn_plain``; other CUDA tensors launch
``csrc/knn_idx.cu``, which replaces
``dgcnn_tpu/ops/pallas_knn.py::knn_pallas`` (body ``_knn_only_kernel``) in
its exact mode.  The kernel is bound by operations on an H100 (~0.014 ms
at the partseg TransformNet's graph); what it pays beyond that is the
selection.  At k <= 64 (every model) it runs the tiled selection of
``csrc/knn_select.cuh`` (64 query rows a block, the cloud streamed in
128-column tiles past a running top-k a row, each list written in order);
above, the row-warp selection (a warp a row, k rounds of arg-max; a row's
scores in registers up to 4096 points, in shared memory above),
which ``rowwarp=True`` forces at any k for the checks.  All give the same
indices, ties included, and the same from call to call.

The variant is the JAX kernel's (``_knn_only_kernel``, read at each call):
v1 as above, or v2 under ``DGCNN_TPU_EXTRACT=v2``
(``amp_select.training_variant``): the k largest packed keys of the same
f32 scores (``amp_select.v2_indices``), the selection's keyed mode on the
card, on the same two routes as v1.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from dgcnn_tpu_torch.ops import _build

# the most points a cloud of the kNN kernels may hold (csrc/knn_select.cuh,
# MAX_N): the tiled selection takes any N, the row route's register
# buckets up to its REG_MAX_N, 4096 (N / 32 <= 128 scores a lane), and its
# shared row (a row's scores in shared memory; one row a block at 32768)
# the rest
MAX_N = 32768
# the widest Co of the kNN kernels' reductions (kernels 1, 3, 4 and 12)
MAX_CO = 256
# the longest neighbour list of the tiled selection (csrc/knn_select.cuh,
# TS_LIST): the kNN kernels take the tiled route up to this k and the
# row-warp route above it
TILED_MAX_K = 64


def use_kernel(n: int) -> bool:
    """Whether the kNN kernels take a cloud of ``n`` points (the port of
    ``dgcnn_tpu/ops/knn.py::use_pallas``, with the selection's own limit):
    N a multiple of 128 and at most ``MAX_N`` (32768: from there up the
    whole-cloud TPU kernels' two double-buffered (N, 128-lane) slabs alone
    fill their 64 MiB of VMEM, ROADMAP C.1).  The models route
    the other sizes to the port of the JAX package's XLA path, decided from
    the shape before any launch; the device of the caller's tensors decides
    the rest (CPU tensors take the plain versions anyway)."""
    return n % 128 == 0 and n <= MAX_N


def srow_count() -> int:
    """Launches on the row route's shared row since the kernels' library
    was loaded: ``with_npl`` (``csrc/knn_select.cuh``) counts each launch
    that it sends there.  A wrapper adds the difference across its launch
    to its ``srow_launches``."""
    fn = _build.load_library().dg_srow_launches
    fn.restype = ctypes.c_ulonglong
    return fn()


@contextlib.contextmanager
def force_shared_rows():
    """Inside, every launch on a kNN kernel's row route takes the shared
    row whatever N and Co are: the check of its bits against the register
    buckets' (and, through ``rowwarp=True``, the tiled route's)."""
    lib = _build.load_library()
    lib.dg_force_shared_rows.argtypes = [ctypes.c_int]
    lib.dg_force_shared_rows(1)
    try:
        yield
    finally:
        lib.dg_force_shared_rows(0)


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


def knn_plain(x: torch.Tensor, k: int, variant: str = "v1") -> torch.Tensor:
    """Plain torch version of kernel 11: (B, N, C) -> (B, N, k) int64
    neighbour indices, nearest (self) first, lowest index first among
    equal scores; ``variant`` v2: the k largest packed keys of the scores
    (``amp_select.v2_indices``)."""
    from dgcnn_tpu_torch.ops.amp_select import v1_indices, v2_indices

    scores = pairwise_neg_sqdist(x)
    return (v2_indices if variant == "v2" else v1_indices)(scores, k)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"knn: {msg}")


def knn(x: torch.Tensor, k: int, *, rowwarp: bool = False) -> torch.Tensor:
    """(B, N, C) -> (B, N, k) int64 neighbour indices, nearest (self)
    first, lowest index first among equal scores.  No gradient flows
    through the selection.

    CPU tensors, and clouds whose N the kernel does not take
    (``use_kernel``, as the JAX package's ``_knn_single`` routes them),
    take ``knn_plain``; other CUDA tensors launch the kernel, which takes
    f32 contiguous points and raises on anything else.  The kernel writes
    int32 indices; they are widened to int64, the index type of torch's
    gathers, so that both devices return the same type.  ``rowwarp``
    launches the kernel's row-warp route at any k (k <= 64 takes the tiled
    route otherwise).  The variant is ``amp_select.training_variant``'s
    where the kernel takes the cloud (module docstring)."""
    from dgcnn_tpu_torch.ops.amp_select import training_variant

    x = x.detach()
    if not use_kernel(x.shape[1]):
        return knn_plain(x, k)
    variant = training_variant()
    if x.device.type == "cpu":
        return knn_plain(x, k, variant)
    _require(x.is_cuda, f"no kernel for device {x.device}")
    _require(x.dtype == torch.float32, "x must be float32")
    _require(x.dim() == 3 and x.is_contiguous(),
             "x must be a contiguous (B, N, C) tensor")
    b, n, c = x.shape
    _require(1 <= k <= n, f"k={k} out of range for N={n}")
    v2 = variant == "v2"
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(_build.load_library(),
                 ("dg_knn_idx_v2" if v2 else "dg_knn_idx")
                 + ("_rowwarp" if rowwarp else ""))
    if fn.argtypes is None:
        fn.argtypes = [p] * (4 if v2 else 3) + [i] * 4 + [p]
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    sq = torch.empty((b * n,), device=x.device, dtype=torch.float32)
    idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
    scratch = [torch.empty((b * n,), device=x.device,
                           dtype=torch.float32)] if v2 else []
    srow = srow_count()
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr(x), _build.ptr(sq), *map(_build.ptr, scratch),
                _build.ptr(idx), b, n, c, k, _build.stream_of(x))
    _build.check(rc, "knn")
    row = rowwarp or k > TILED_MAX_K
    knn.launches += 1
    knn.v2_launches += v2
    knn.rowwarp_launches += v2 and row
    knn.srow_launches += srow_count() - srow
    return idx.long()


# launches of the kernel since the count was last set to 0 (v2_launches:
# those of its v2 form; rowwarp_launches: those of its v2 form on the
# row-warp route; srow_launches: those on the row-warp route's shared row)
knn.launches = knn.v2_launches = knn.rowwarp_launches = 0
knn.srow_launches = 0
