"""Kernel 6: one whole eval two-conv EdgeConv block, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::fused_knn_edge2`` (body
``_knn_edge2_kernel``) in its exact f32 mode.  The kernel is
``csrc/knn_edge2.cu``; its note states the bound on an H100 and what the
design does about it.  It picks its route from the shape: at k <= 64, C1
<= 64 and C2 <= 128 the tiled selection of ``csrc/knn_select.cuh``, then
the block's edges in tiles of whole rows (h1 staged, z2 = h1 w2 a
register-blocked product, the affine and LeakyReLU, then each row's max);
otherwise the row-warp selection with each edge consumed as it is picked.
Both give the same bits.  ``knn_edge2_plain`` beside it is the same function
in plain torch (kNN, gather, both convs on every edge, max over k): the
wrapper runs it for CPU tensors and launches the kernel for CUDA tensors.

``amp=True`` is the AMP form, the JAX package's default
(``_knn_edge2_kernel`` with ``_train_exact()`` false, ``pallas_knn.py:
981-1027``, its bf16 output at :1096): AMP scores (bf16x3 for an f32
graph, one product of bf16 values for a bf16 one), the selected a1 rows
in f32 (the one-hot is f32, :1026: a1 is not rounded), v3 at C1 % 128 !=
0 (each class consumed as the mean of its members' a1 rows, through both
convs, then the max) and v2 otherwise, and a bf16 output.
``knn_edge2_amp_plain`` is its plain version.  The extraction variant is
``amp_select.stage_variant``'s, as for kernel 1: the CUDA forms take the
exact v1 and v2 (the semseg CLI's pin: f32 payload and output) and the AMP
v2 and v3, each on both routes of the exact v1 (the tiled one at k <= 64,
C1 <= 64 and C2 <= 128, the row-warp one otherwise:
``csrc/knn_edge2_variant.cu``); ``launch_variant`` launches the forms but
the exact v1, for the whole cloud or (kernel 13) each query tile's window,
and ``rowwarp=True`` forces their row-warp route (the oracle of the tiled
route's earlier form).

On the cloud's tiled route (``amp_route``: "tensor" at k <= 64, C1 <= 64,
C2 <= 128 and Kp <= 384, every model's blocks) the AMP forms' scores come
from the tensor cores in both v2 passes and in v3's
(``csrc/knn_edge2_variant.cu``; kernel 1's operands, ``mma.sync`` and the
sorting network's fill of v3's first tile); ``simt=True`` keeps the
earlier form, the f32 fmaf chain on the CUDA cores, callable, as do
kernel 13's windows.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.amp_select import (
    TC_MAX_KP,
    amp_scores,
    require_ported,
    select_rows,
    stage_variant,
    tc_channels,
)
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import (
    MAX_N,
    TILED_MAX_K,
    knn_plain,
    pairwise_neg_sqdist,
    srow_count,
)

MAX_C = 128
# the widths of the tiled route
TILED_C1, TILED_C2 = 64, 128


def tiled_route(c1: int, c2: int, k: int) -> bool:
    """Whether kernels 6 and 13 take their tiled route at these widths and
    k (``csrc/edge2_consume.cuh``, ``tiled_route``); else the row-warp
    route."""
    return k <= TILED_MAX_K and c1 <= TILED_C1 and c2 <= TILED_C2


def amp_route(k: int, n: int, c1: int, c2: int, cg: int,
              bf16_graph: bool = False) -> str:
    """The route of kernel 6's AMP form on the card over a cloud at (k, N,
    C1, C2, Cg; a bf16 graph or an f32 one): "tensor" (the tiled
    selection, its scores on the tensor cores) on ``tiled_route``'s shapes
    with Kp = ``tc_channels(Cg)`` <= ``TC_MAX_KP`` (every model's blocks),
    "simt" (the tiled selection's earlier form, f32 scores on the CUDA
    cores) at a wider graph, "rowwarp" (the row-warp selection) off the
    tiled route's shapes (k > 64, C1 > 64 or C2 > 128), "none" where the
    kernel raises.  ``simt=True`` sends the tiled route to its earlier
    form, ``rowwarp=True`` to the row-warp route."""
    if (n % 128 or n > MAX_N or not 1 <= k <= n or not 1 <= c1 <= MAX_C
            or not 1 <= c2 <= MAX_C or cg < 1):
        return "none"
    if not tiled_route(c1, c2, k):
        return "rowwarp"
    return "tensor" if tc_channels(cg, bf16_graph) <= TC_MAX_KP else "simt"


def _tensor(graph, w2, k: int, amp: bool, starts, rowwarp: bool,
            simt: bool) -> bool:
    """Whether a launch of the AMP form takes the tensor-core scores: over
    the cloud (not kernel 13's windows) on ``amp_route``'s "tensor" route,
    unless ``rowwarp`` or ``simt`` ask for another."""
    b, n, cg = graph.shape
    return (amp and starts is None and not (rowwarp or simt)
            and amp_route(k, n, *w2.shape, cg,
                          graph.dtype == torch.bfloat16) == "tensor")


def edge2_variant(c1: int) -> str:
    """The AMP default of kernels 6 and 13 at C1 first-conv channels: v2
    at a multiple of 128 (no lane padding for v3's count), v3 otherwise
    (``pallas_knn.py:1021-1023``)."""
    return "v2" if c1 % 128 == 0 else "v3"


def edge2_z2(a1, b1, s1, t1, w2, idx, slope: float = 0.2) -> torch.Tensor:
    """The second conv's pre-activation on every edge, (B, N, k, C2):
    ``LReLU((a1[idx] + b1) * s1 + t1) @ w2`` in that operation order."""
    z1 = (gather_neighbors(a1, idx.long()) + b1[:, :, None]) * s1 + t1
    return torch.matmul(torch.where(z1 >= 0, z1, slope * z1), w2)


def edge2_fold(rows, present, b1, s1, t1, w2, s2, t2,
               slope: float = 0.2) -> torch.Tensor:
    """Both convs on each selected a1 row (``rows`` (B, N, k, C1), as
    ``edge2_z2`` orders the operations) and the max over the ``present``
    slots -> (B, N, C2) f32."""
    z1 = (rows + b1.float()[:, :, None]) * s1 + t1
    z2 = torch.matmul(torch.where(z1 >= 0, z1, slope * z1), w2) * s2 + t2
    h2 = torch.where(z2 >= 0, z2, slope * z2)
    return torch.where(present[..., None], h2, -torch.inf).amax(dim=2)


def knn_edge2_plain(graph, a1, b1, s1, t1, w2, s2, t2, k: int,
                    slope: float = 0.2, variant: str = "v1") -> torch.Tensor:
    """Plain torch version of the kernel: (B, N, C2) f32.  ``variant`` v1
    (torch.topk's order), v2 (the packed keys of the exact scores) or v3
    (the exact scores' classes)."""
    if variant == "v1":
        z2 = (edge2_z2(a1, b1, s1, t1, w2, knn_plain(graph, k), slope) * s2
              + t2)
        return torch.where(z2 >= 0, z2, slope * z2).amax(dim=2)
    rows, present = select_rows(pairwise_neg_sqdist(graph), a1, k, variant)
    return edge2_fold(rows, present, b1, s1, t1, w2, s2, t2, slope)


def knn_edge2_amp_plain(graph, a1, b1, s1, t1, w2, s2, t2, k: int,
                        slope: float = 0.2,
                        variant: str | None = None) -> torch.Tensor:
    """Plain torch version of the AMP form: (B, N, C2) bf16.  ``graph`` is
    f32 or bf16, ``a1``/``b1`` f32; ``variant`` None takes
    ``edge2_variant``'s."""
    variant = variant or edge2_variant(a1.shape[-1])
    rows, present = select_rows(amp_scores(graph, graph), a1, k, variant)
    return edge2_fold(rows, present, b1, s1, t1, w2, s2, t2,
                      slope).to(torch.bfloat16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"knn_edge2: {msg}")


def knn_edge2(graph: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor,
              s1: torch.Tensor, t1: torch.Tensor, w2: torch.Tensor,
              s2: torch.Tensor, t2: torch.Tensor, k: int,
              slope: float = 0.2, *, amp: bool = False,
              rowwarp: bool = False, simt: bool = False) -> torch.Tensor:
    """kNN over ``graph`` (B, N, Cg), then for each of the k neighbours j
    of point i ``LReLU((LReLU((a1[j] + b1[i]) * s1 + t1) @ w2) * s2 + t2)``
    and its max over the neighbours -> (B, N, C2).  ``a1``/``b1`` (B, N,
    C1) are the first conv's neighbour and centre projections, ``s1``/``t1``
    (C1,) and ``s2``/``t2`` (C2,) the folded BatchNorms, ``w2`` (C1, C2) the
    second conv.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 tensors (graph, a1 and b1 contiguous) with N a multiple
    of 128, N <= ``MAX_N`` (32768) and C1, C2 <= 128, and raises on
    anything else.
    ``amp`` runs the AMP form (plain: ``knn_edge2_amp_plain``): an f32 or
    bf16 graph, a bf16 output.  The extraction variant is
    ``stage_variant``'s; every form takes the exact v1's shapes.
    ``rowwarp`` launches the row-warp route of the forms but the exact v1
    at any shape (the exact v1's is the banded entry's at band = N);
    ``simt`` the AMP form's earlier tiled form (``amp_route``)."""
    variant = stage_variant(amp, edge2_variant(w2.shape[0]))
    if graph.device.type == "cpu":
        fn = knn_edge2_amp_plain if amp else knn_edge2_plain
        return fn(graph, a1, b1, s1, t1, w2, s2, t2, k, slope,
                  variant=variant)
    require_ported("knn_edge2", amp, variant)
    _require(not simt or amp, "simt names the AMP form's earlier form")
    if amp or variant != "v1":
        rowwarp = rowwarp or not tiled_route(*w2.shape, k)
        srow = srow_count()
        out = launch_variant(graph, a1, b1, s1, t1, w2, s2, t2, k, slope,
                             amp, variant, rowwarp=rowwarp, simt=simt)
        knn_edge2.launches += 1
        knn_edge2.amp_launches += amp
        knn_edge2.tc_launches += _tensor(graph, w2, k, amp, None, rowwarp,
                                         simt)
        knn_edge2.v2_launches += not amp
        knn_edge2.rowwarp_launches += rowwarp
        knn_edge2.srow_launches += srow_count() - srow
        return out
    _require(not rowwarp, "the exact v1's row-warp route is the banded "
             "entry's at band = N")
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
    srow = srow_count()
    with torch.cuda.device(graph.device):
        rc = fn(p(graph), p(a1), p(b1), *map(p, small), p(sq), p(out), b, n,
                cg, c1, c2, k, float(slope), _build.stream_of(graph))
    _build.check(rc, "knn_edge2")
    knn_edge2.launches += 1
    knn_edge2.srow_launches += srow_count() - srow
    return out


def launch_variant(graph, a1, b1, s1, t1, w2, s2, t2, k: int, slope: float,
                   amp: bool, variant: str, starts=None, tile: int = 0,
                   band: int = 0, rowwarp: bool = False,
                   simt: bool = False) -> torch.Tensor:
    """Launches the AMP v2 / v3 form or the exact v2 form of the block on
    CUDA tensors: over the whole cloud, or with ``starts`` (the window
    starts of each query tile of ``tile`` rows) over windows of ``band``
    rows of a sorted cloud (kernel 13).  The kernel takes its row-warp
    route off ``tiled_route``'s shapes or with ``rowwarp``, the AMP form's
    tiled route over the cloud the tensor-core scores unless ``simt``
    (``_tensor``).  Checks the tensors and raises on what the kernel does
    not take."""
    name = "banded_knn_edge2" if starts is not None else "knn_edge2"

    def need(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    need(graph.is_cuda, f"no kernel for device {graph.device}")
    tensors = (graph, a1, b1, s1, t1, w2, s2, t2)
    need(all(t.device == graph.device for t in tensors),
         "all tensors must be on one device")
    need(graph.dtype == torch.float32
         or (amp and graph.dtype == torch.bfloat16),
         "graph must be float32" + (" or bfloat16" if amp else ""))
    need(all(t.dtype == torch.float32 for t in tensors[1:]),
         "a1, b1, w2 and the affines must be float32")
    need(graph.is_contiguous() and a1.is_contiguous()
         and b1.is_contiguous(), "graph, a1 and b1 must be contiguous")
    need(graph.dim() == 3, "graph must be (B, N, Cg)")
    b, n, cg = graph.shape
    c1, c2 = w2.shape
    w = band or n
    need(a1.shape == (b, n, c1) and b1.shape == (b, n, c1),
         f"a1 {tuple(a1.shape)}, b1 {tuple(b1.shape)} vs graph "
         f"{tuple(graph.shape)} and w2 {tuple(w2.shape)}")
    need(s1.shape == (c1,) and t1.shape == (c1,)
         and s2.shape == (c2,) and t2.shape == (c2,),
         "s1/t1 must be (C1,) and s2/t2 (C2,)")
    # the banded forms (starts) take any N: their window bounds them
    need(n % 128 == 0 and w <= MAX_N,
         f"N={n} must be a multiple of 128 and {'the band' if band else 'N'}"
         f" <= {MAX_N}")
    need(c1 <= MAX_C and c2 <= MAX_C, f"C1, C2 must be <= {MAX_C}")
    need(1 <= k <= w, f"the {variant} form takes 1 <= k <= {w} (k={k})")
    fn = _build.load_library().dg_knn_edge2_variant
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    dev = graph.device
    gbf = graph.dtype == torch.bfloat16
    tensor = _tensor(graph, w2, k, amp, starts, rowwarp, simt)
    # the score operands: f32, Cg (a bf16 graph) or 3 Cg a point, or with
    # the tensor cores Kp bf16 (none for a bf16 graph of Kp channels)
    kp = tc_channels(cg, gbf)
    cs = kp // 2 if tensor else cg if gbf or not amp else 3 * cg
    own = amp and not (tensor and gbf and kp == cg)

    def scratch(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    gc = scratch(b * n * cs) if own else None
    gq = scratch(b * n * cs) if own and not gbf else None
    sq, rmin = scratch(b * n), scratch(b * n)
    small = [t.contiguous() for t in (w2, s1, t1, s2, t2)]
    out = torch.empty((b, n, c2), device=dev,
                      dtype=torch.bfloat16 if amp else torch.float32)
    flags = (gbf | (variant == "v3") << 1 | (not amp) << 2 | rowwarp << 3
             | tensor << 4)
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(p(graph), p(a1), p(b1), *map(p, small), p(starts), p(gq),
                p(gc), p(sq), p(rmin), p(out), b, n, cg, c1, c2, k,
                tile or n, w, float(slope), flags, _build.stream_of(graph))
    _build.check(rc, name)
    return out


# launches of the kernel since the count was last set to 0 (amp_launches:
# those of its AMP form; tc_launches: those of its AMP form with the
# tensor-core scores; v2_launches: those of its exact v2 form;
# rowwarp_launches: those of either on the row-warp route; srow_launches:
# those of any form on the row-warp route's shared row)
knn_edge2.launches = 0
knn_edge2.amp_launches = 0
knn_edge2.tc_launches = 0
knn_edge2.v2_launches = 0
knn_edge2.rowwarp_launches = 0
knn_edge2.srow_launches = 0
