"""Kernel 5: the backward of the four neighbour reductions of kernels 3
and 4, hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_knn.py::edge_reduce_bwd`` (body
``_edge_reduce_bwd_kernel``) in its exact f32 mode.  The kernel is
``csrc/edge_reduce_bwd.cu``.  Its bound on an H100 is bytes: idx, a, amax,
amin and the four cotangents read once, da written once (~0.16 ms over the
four DGCNNCls training stages at B=32).  Three routes:

- the pull route, the kernel's: each point's list of in-edges e = i * k +
  t is built on the card in ascending e (``csrc/reverse_lists.cu``); a
  warp a row counts its ties and stores each edge's cotangent (B * N * k
  * Co floats of scratch), and each ``da[j]`` is summed from zero over
  j's list in order.  No float atomic: ``da`` has the same bits from run
  to run, those of an f32 scatter-add over the edges in ascending
  order.
- ``slices=True``, the channel-slices route (N <= 16384): a
  block takes one cloud and CS channels, holds that slice of ``a`` and of
  ``da`` in shared memory and adds every edge's cotangent into the ``da``
  slice with shared-memory float atomics (above N = 16384 it takes the
  atomic route).
- ``atomic=True``, the first form: a warp a row, one global f32 atomicAdd
  per (row, neighbour, channel) into ``da``.

The two atomic routes add in an order that changes from run to run, so
their ``da``'s last bits do too; they stay as oracles for the checks.  The
kernel writes every element of ``da``.  ``edge_reduce_bwd_plain`` beside
it is the same function in plain torch with the semantics of
``_ker_bwd_xla``: autograd through the gather and the reductions, ties of
max and min splitting their cotangent evenly.  The wrapper runs it for CPU
tensors and launches the kernel for CUDA tensors.

``amp=True`` is the AMP form, the JAX package's default in training
(``_edge_reduce_bwd_kernel`` with ``exact=False``, ``pallas_knn.py:
666-718``), on the pull route only: ``a``'s values rounded to bf16, the
ties counted against the given ``amax``/``amin`` (the AMP forward's
values of ``round_bf16(a)``), and each edge's addend rounded to bf16
before the f32 sum over a point's in-edges in ascending edge order.
``edge_reduce_bwd_amp_plain`` is its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.graph import gather_neighbors

MAX_CO = 256


def edge_reduce_bwd_plain(idx, a, amax, amin, ct_max, ct_min, ct_sum,
                          ct_sumsq) -> torch.Tensor:
    """Plain torch version of the kernel: ``da`` (B, N, Co).  ``amax`` and
    ``amin`` are not read: the gather recomputes them."""
    del amax, amin
    with torch.enable_grad():
        a = a.detach().requires_grad_(True)
        ag = gather_neighbors(a, idx.long())
        outs = (ag.amax(dim=2), ag.amin(dim=2), ag.sum(dim=2),
                ag.square().sum(dim=2))
        (da,) = torch.autograd.grad(outs, a,
                                    (ct_max, ct_min, ct_sum, ct_sumsq))
    return da


def edge_reduce_bwd_amp_addends(idx, a, amax, amin, ct_max, ct_min, ct_sum,
                                ct_sumsq) -> torch.Tensor:
    """Each edge's addend of the AMP form before its bf16 rounding, (B, N,
    k, Co): with sel = round_bf16(a)[idx] and the ties counted against
    ``amax``/``amin``, ``((max term + min term) + ct_sum) + sel * 2
    ct_sumsq``."""
    from dgcnn_tpu_torch.ops.amp_select import round_bf16

    sel = gather_neighbors(round_bf16(a), idx.long())
    is_max = sel == amax[:, :, None]
    is_min = sel == amin[:, :, None]
    gmax = ct_max / is_max.sum(dim=2)
    gmin = ct_min / is_min.sum(dim=2)
    return (torch.where(is_max, gmax[:, :, None], 0.0)
            + torch.where(is_min, gmin[:, :, None], 0.0)
            + ct_sum[:, :, None]) + sel * (2.0 * ct_sumsq)[:, :, None]


def scatter_edges(addends: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, k, C) per-edge values, each added into its neighbour's row
    (``idx`` (B, N, k)), in ascending edge order on the CPU -> (B, N, C)
    f32."""
    b, n, _, c = addends.shape
    target = (idx.long() + n * torch.arange(b, device=idx.device)[:, None,
                                                                 None])
    out = torch.zeros((b * n, c), dtype=torch.float32, device=idx.device)
    out.index_add_(0, target.reshape(-1), addends.reshape(-1, c))
    return out.reshape(b, n, c)


def edge_reduce_bwd_amp_plain(idx, a, amax, amin, ct_max, ct_min, ct_sum,
                              ct_sumsq) -> torch.Tensor:
    """Plain torch version of the AMP form: ``da`` (B, N, Co), each edge's
    addend (``edge_reduce_bwd_amp_addends``) rounded to bf16 and added
    into its neighbour's row."""
    from dgcnn_tpu_torch.ops.amp_select import round_bf16

    return scatter_edges(round_bf16(edge_reduce_bwd_amp_addends(
        idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq)), idx)


def reverse_list_ints(b: int, n: int, k: int) -> int:
    """The int32 scratch of the reverse neighbour lists of ``b`` clouds of
    ``n`` points and ``k`` neighbours (``csrc/reverse_lists.cuh``)."""
    fn = _build.load_library().dg_reverse_list_ints
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    return fn(b, n, k)


def reverse_lists_plain(idx: torch.Tensor):
    """Plain torch version of the reverse neighbour lists: for ``idx`` (B,
    N, k), the (B * N + 1,) offsets and (B * N * k,) edge ids, int64, the
    list of point g = b * N + j being the edge ids (b * N + i) * k + t
    with idx[b, i, t] == j, ascending, at lst[off[g]:off[g + 1]]."""
    b, n, k = idx.shape
    target = (idx.long() + n * torch.arange(b, device=idx.device)[:, None,
                                                                  None])
    target = target.reshape(-1)
    lst = torch.sort(target, stable=True).indices
    deg = torch.bincount(target, minlength=b * n)
    off = torch.zeros(b * n + 1, dtype=torch.int64, device=idx.device)
    off[1:] = torch.cumsum(deg, 0)
    return off, lst


def reverse_lists(idx: torch.Tensor):
    """The reverse neighbour lists that the pull routes of kernels 5 and 8
    build on the card (``csrc/reverse_lists.cu``), as ``reverse_lists_plain``
    returns them: CPU tensors take the plain version; a CUDA ``idx`` (int32,
    contiguous) launches the list-building kernels, whose lists come back
    as int64."""
    if idx.device.type == "cpu":
        return reverse_lists_plain(idx)
    _require(idx.is_cuda, f"no kernel for device {idx.device}")
    _require(idx.dtype == torch.int32 and idx.is_contiguous()
             and idx.dim() == 3, "idx must be a contiguous (B, N, k) int32")
    b, n, k = idx.shape
    fn = _build.load_library().dg_reverse_lists
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p]
        fn.restype = i
    scratch = torch.empty((reverse_list_ints(b, n, k),), device=idx.device,
                          dtype=torch.int32)
    with torch.cuda.device(idx.device):
        rc = fn(_build.ptr(idx), b, n, k, _build.ptr(scratch),
                _build.stream_of(idx))
    _build.check(rc, "reverse_lists")
    reverse_lists.launches += 1
    return scratch[:b * n + 1].long(), scratch[-b * n * k:].long()


# launches of the list-building kernels on their own since the count was
# last set to 0
reverse_lists.launches = 0


def pull_sum_plain(idx: torch.Tensor, addends: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``pull_sum``: ``scatter_edges`` of the
    addends widened to f32."""
    return scatter_edges(addends.float(), idx)


def pull_sum(idx: torch.Tensor, addends: torch.Tensor) -> torch.Tensor:
    """(B, N, C) f32: each point's row summed from zero over its in-edges'
    rows of ``addends`` (B, N, k, C) in ascending edge id, the pull routes'
    sum of kernels 5 and 8 (``csrc/reverse_lists.cu``) on its own.  f32
    addends (C <= 256) or bf16 ones (C <= 64, kernel 8 AMP's tensor-core
    form), widened to f32 as they are read: the f32 sum's bits of the
    widened values.  CPU tensors take ``pull_sum_plain``."""
    if idx.device.type == "cpu":
        return pull_sum_plain(idx, addends)
    _require(idx.is_cuda and addends.device == idx.device,
             "idx and the addends must be on one CUDA device")
    _require(idx.dtype == torch.int32 and idx.is_contiguous()
             and idx.dim() == 3, "idx must be a contiguous (B, N, k) int32")
    b, n, k = idx.shape
    bf16 = addends.dtype == torch.bfloat16
    c = addends.shape[-1]
    _require(addends.shape == (b, n, k, c) and addends.is_contiguous()
             and (bf16 or addends.dtype == torch.float32)
             and c <= (64 if bf16 else 256),
             "addends must be a contiguous (B, N, k, C) f32 (C <= 256) or "
             "bf16 (C <= 64)")
    fn = _build.load_library().dg_pull_sum
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p] + [i] * 5 + [p, p, p]
        fn.restype = i
    out = torch.empty((b, n, c), device=idx.device, dtype=torch.float32)
    scratch = torch.empty((reverse_list_ints(b, n, k),), device=idx.device,
                          dtype=torch.int32)
    with torch.cuda.device(idx.device):
        rc = fn(_build.ptr(idx), _build.ptr(addends), int(bf16), b, n, k, c,
                _build.ptr(out), _build.ptr(scratch), _build.stream_of(idx))
    _build.check(rc, "pull_sum")
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"edge_reduce_bwd: {msg}")


def edge_reduce_bwd(idx: torch.Tensor, a: torch.Tensor, amax: torch.Tensor,
                    amin: torch.Tensor, ct_max: torch.Tensor,
                    ct_min: torch.Tensor, ct_sum: torch.Tensor,
                    ct_sumsq: torch.Tensor, *, atomic: bool = False,
                    slices: bool = False, amp: bool = False) -> torch.Tensor:
    """``da`` of the reductions (amax, amin, asum, asumsq) of
    ``knn_reduce`` with respect to ``a`` (B, N, Co), given their cotangents
    and the forward's ``idx`` (B, N, k) and ``amax``/``amin``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes an int32 ``idx``, f32 contiguous tensors, N a multiple of
    128 and Co <= 256, and raises on anything else.  The pull route runs
    unless ``atomic`` (the atomic route at any shape) or ``slices`` (the
    channel-slices route) asks for an oracle.  ``amp`` runs the AMP form
    (module docstring), on the pull route only."""
    if a.device.type == "cpu":
        plain = edge_reduce_bwd_amp_plain if amp else edge_reduce_bwd_plain
        return plain(idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq)
    _require(a.is_cuda, f"no kernel for device {a.device}")
    feats = (a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq)
    _require(all(t.device == a.device for t in (idx, *feats)),
             "all tensors must be on one device")
    _require(idx.dtype == torch.int32, "idx must be int32")
    _require(all(t.dtype == torch.float32 for t in feats),
             "a, amax, amin and the cotangents must be float32")
    _require(all(t.is_contiguous() for t in (idx, *feats)),
             "tensors must be contiguous")
    b, n, co = a.shape
    _require(all(t.shape == a.shape for t in feats),
             "a, amax, amin and the cotangents must share one shape")
    _require(idx.dim() == 3 and idx.shape[:2] == (b, n),
             f"idx {tuple(idx.shape)} vs a {tuple(a.shape)}")
    k = idx.shape[2]
    _require(n % 128 == 0, f"N={n} must be a multiple of 128")
    _require(1 <= co <= MAX_CO, f"Co={co} out of 1..{MAX_CO}")
    _require(1 <= k <= n, f"k={k} out of range for N={n}")
    _require(not (atomic and slices), "atomic and slices are two routes")
    pull = not (atomic or slices)
    _require(pull or not amp, "the AMP form has the pull route only")
    lib = _build.load_library()
    fn = getattr(lib, "dg_edge_reduce_bwd_pull_amp" if amp else
                 "dg_edge_reduce_bwd_pull" if pull else
                 "dg_edge_reduce_bwd_atomic" if atomic else
                 "dg_edge_reduce_bwd")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (11 if pull else 9) + [i] * 4 + [p]
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    da = torch.empty_like(a)  # every element written
    p = _build.ptr
    scratch = []
    if pull:
        wbuf = torch.empty((b * n * k * co,), device=a.device,
                           dtype=torch.float32)
        iscratch = torch.empty((reverse_list_ints(b, n, k),),
                               device=a.device, dtype=torch.int32)
        scratch = [p(wbuf), p(iscratch)]
    with torch.cuda.device(a.device):
        rc = fn(p(idx), *map(p, feats), p(da), *scratch, b, n, co, k,
                _build.stream_of(a))
    _build.check(rc, "edge_reduce_bwd")
    edge_reduce_bwd.launches += 1
    edge_reduce_bwd.amp_launches += amp
    return da


# launches of the kernel since the count was last set to 0 (amp_launches:
# those of its AMP form)
edge_reduce_bwd.launches = edge_reduce_bwd.amp_launches = 0
