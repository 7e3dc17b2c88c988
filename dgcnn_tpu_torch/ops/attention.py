"""Kernels 14, 15 and 16: multi-head softmax attention with dropout on the
probabilities, its backward and its dropout mask, hand-written CUDA.

Replaces, in ``dgcnn_tpu/ops/pallas_attention.py``, ``_attn_fwd_impl``
(body ``_attn_fwd_kernel``; ``csrc/attention_fwd.cu``), ``_attn_bwd_impl``
(body ``_attn_bwd_kernel``; ``csrc/attention_bwd.cu``) and
``dropout_mask`` (``csrc/attention_mask.cu``): the attention of the fusion
Net's ``TorchMultiheadAttention`` in evaluation and in training.  Each
kernel's note states its bound on an H100 and what the design does about
it.

The JAX package turns its kernel off in exact mode
(``dgcnn_tpu/models/torch_transformer.py::_use_fused`` under
``DGCNN_TPU_PALLAS_EXACT``): the TPU kernel's bf16 products and its core
random stream are not exact, so exact mode takes the dense XLA path.
These kernels compute the dense exact function to f32 rounding, so the
port runs them in exact mode, held to the dense path (``attention_plain``)
by the tests and ``chip_smoke.py``: kernels 14 (at head dims 128 and 256)
and 15 take their products on the tensor cores in three TF32 terms
(3xTF32, ``csrc/mma_tf32.cuh``: hi*hi + hi*lo + lo*hi of each operand
split in two), with short sums, within a few 1e-6 of each row's norm of
the f32 result (kernel 14's gate: 1e-5; kernel 15's: 1e-4); kernel 14 at
head dim 512 takes every product and sum in f32 on the CUDA cores.

Dropout: the keep bit of probability (b, h, i, j) is a pure function of
(seed, b, h, i, j), splitmix64's finalizer chained over the indices
(``csrc/attention.cuh`` spells it out), kept when its 32-bit draw is at
least round(rate * 2^32).  No tiling enters the bits, so the three kernels
pick their tiles freely and the backward regenerates the forward's mask
instead of saving it.  The port's mask is not the TPU's: the TPU kernels
draw from the TPU core's generator, with the same distribution; the tests
pin the arithmetic by materializing the port's own mask
(``dropout_mask``), as ``tests/test_pallas_attention.py`` does for the TPU
kernels.  The seed is one int64 on the device, drawn per call from the
caller's ``torch.Generator``, which the kernels read through a pointer.

Kernel 14's AMP form (``csrc/attention_fwd_bf16.cu``) takes bf16 q, k and
v, the AMP fusion Net's attention: the JAX package's ``_attn_fwd_kernel``
on bf16 inputs, scores from bf16 products with f32 sums, the softmax in
f32, in training the kept probabilities times 1 / (1 - rate) in f32, the
probabilities rounded to bf16, P V with f32 sums and the output rounded to
bf16.  Its evaluation form (rate 0) has the plain version
``attention_amp_plain``; its training form also writes each row's max m
and sum l (``attention_amp_train_plain``), and kernel 15's bf16 form
(``csrc/attention_bwd_bf16.cu``, plain version ``attention_amp_bwd_plain``)
mirrors ``_attn_bwd_kernel`` on bf16 inputs: p rebuilt from (m, l) with
the forward's instructions, Delta = sum_j dp_ij p_ij in f32 (the TPU
kernel's, not rowsum(dO o) of the bf16 output), bf16 operands, f32 sums,
bf16 gradients.  ``fused_attention`` picks the form by the inputs' dtype;
``FusedAttentionAMP`` joins the two in training.  At d = 128 and 256
(``amp_route``) kernel 14's AMP forms run on Hopper's warpgroup products
(``csrc/attention_fwd_wgmma.cu``: wgmma on tiles that TMA streams into a
ring of shared-memory stages, P in registers as the A operand of P V), the
earlier form's score sequence, tiles and sums kept, so that o, m and l are
its bits; at d = 512 the earlier form (``csrc/attention_fwd_bf16.cu``:
bf16 ``mma.sync``), which ``earlier=True`` forces at any d for the checks
and the A/B.  Kernel 15's bf16 form likewise (``amp_bwd_route``): at d =
128 and 256 ``csrc/attention_bwd_wgmma.cu`` (wgmma and TMA, two element
passes: a Delta launch stationary on the queries, a main launch
stationary on the keys that adds dk and dv and writes bf16 dS^T, and dq =
dS K in a third launch; seven products where the earlier form ran nine),
at d = 512 the earlier form (``csrc/attention_bwd_bf16.cu``), which
``earlier=True`` forces at any d.

CPU tensors take the plain versions; CUDA tensors launch the kernels,
which raise on what they do not take.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from dgcnn_tpu_torch.ops import _build

# head dims the kernels are built for: the fusion Net's 512 / h for h = 1,
# 2 and 4 (the partseg CLI's default, the bench config, the dist trainer)
HEAD_DIMS = (128, 256, 512)

# cap of one query chunk's (B, h, chunk, Nk) f32 score slab in the plain
# version (the JAX dense fallback's _DENSE_CHUNK_BYTES); a chunk's dropout
# draws take four times as many bytes (int64 temporaries)
_CHUNK_BYTES = 512 * 1024 * 1024

# splitmix64's increment and finalizer multipliers (csrc/attention.cuh)
_GAMMA = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _i64(c: int) -> int:
    """The int64 whose bits are the unsigned 64-bit ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 bit patterns: products wrap mod
    2^64, as the kernels' unsigned ones do."""
    z = (z ^ _shr(z, 30)) * _i64(_MIX1)
    z = (z ^ _shr(z, 27)) * _i64(_MIX2)
    return z ^ _shr(z, 31)


def keep_threshold(rate: float) -> int:
    """The unsigned 32-bit threshold of a dropout rate: a probability is
    kept when its draw is at least round(rate * 2^32), so P(keep) = 1 -
    rate (``_keep_mask``'s threshold, in unsigned space)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return min(round(rate * 2.0 ** 32), 2 ** 32 - 1)


def _keep_plain(b: int, h: int, r0: int, r1: int, nk: int,
                seed: torch.Tensor, rate: float,
                device) -> torch.Tensor:
    """Keep bits (B, h, r1 - r0, Nk) of query rows [r0, r1), bool."""
    s = seed.to(device=device, dtype=torch.int64).reshape(())

    def term(n: int, first: int = 0) -> torch.Tensor:
        return (torch.arange(first + 1, first + n + 1, device=device,
                             dtype=torch.int64) * _i64(_GAMMA))

    key = _mix64(s + term(b).view(b, 1, 1, 1))
    key = _mix64(key + term(h).view(1, h, 1, 1))
    key = _mix64(key + term(r1 - r0, r0).view(1, 1, r1 - r0, 1))
    draw = _shr(_mix64(key + term(nk).view(1, 1, 1, nk)), 32)
    return draw >= keep_threshold(rate)


def dropout_mask_plain(shape, seed: torch.Tensor, rate: float,
                       device=None) -> torch.Tensor:
    """Plain torch version of kernel 16: the (B, h, Nq, Nk) f32 keep mask
    (1 kept, 0 dropped) of ``seed`` (one int64) at ``rate``, the same bits
    as the kernels', on ``device`` (the seed's by default)."""
    b, h, nq, nk = shape
    device = seed.device if device is None else device
    return _keep_plain(b, h, 0, nq, nk, seed, rate, device).float()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, rate: float = 0.0,
                    seed: torch.Tensor | None = None,
                    with_lse: bool = False):
    """Plain torch version of the kernels: dropout(softmax(q k^T *
    sm_scale)) v over (B, h, N, d) f32 tensors, the JAX package's dense
    path (torch_transformer.py, its dense fallback), with the port's mask
    of ``seed`` at ``rate`` (each kept probability scaled by 1 / (1 -
    rate)).  Queries run in chunks whose f32 score slab stays under 512 MB,
    each row's softmax over the whole key axis as in one pass.  With
    ``with_lse``, (the output, each row's log-sum-exp (B, h, Nq) of its
    scaled scores): kernel 14's training form's pair.  Autograd through it
    is kernel 15's plain version."""
    if rate > 0.0 and seed is None:
        raise ValueError("attention: a dropout rate > 0 needs a seed")
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    rows = max(1, _CHUNK_BYTES // ((4 if rate == 0.0 else 16)
                                   * b * h * nk))
    kt = k.float().transpose(2, 3)
    outs, lses = [], []
    for r0 in range(0, nq, rows):
        s = torch.matmul(q[:, :, r0:r0 + rows].float(), kt) * sm_scale
        if with_lse:
            lses.append(torch.logsumexp(s, dim=-1))
        p = torch.softmax(s, dim=-1)
        if rate > 0.0:
            keep = _keep_plain(b, h, r0, min(r0 + rows, nq), nk, seed, rate,
                               q.device)
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        outs.append(torch.matmul(p, v.float()))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    if not with_lse:
        return out
    return out, lses[0] if len(lses) == 1 else torch.cat(lses, dim=2)


def attention_amp_train_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, sm_scale: float,
                              rate: float = 0.0,
                              seed: torch.Tensor | None = None):
    """Plain torch version of kernel 14's AMP training form over (B, h, N,
    d) bf16 tensors, the JAX kernel's arithmetic step by step: s = (q k^T)
    * sm_scale with the bf16 values' products summed in f32; each row's
    max m and sum l of exp(s - m), p = exp(s - m) / l, in f32; at rate > 0
    the kept probabilities (the port's mask of ``seed``) times 1 / (1 -
    rate) in f32, the others 0; those rounded to bf16, their product with v
    summed in f32 and rounded to bf16.  Returns (o, m, l), m and l (B, h,
    Nq) f32.  Queries run in chunks whose f32 score slab stays under 512
    MB."""
    if rate > 0.0 and seed is None:
        raise ValueError("attention: a dropout rate > 0 needs a seed")
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    rows = max(1, _CHUNK_BYTES // ((4 if rate == 0.0 else 16) * b * h * nk))
    kt = k.float().transpose(2, 3)
    vf = v.float()
    outs, ms, ls = [], [], []
    for r0 in range(0, nq, rows):
        s = torch.matmul(q[:, :, r0:r0 + rows].float(), kt) * sm_scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        if rate > 0.0:
            keep = _keep_plain(b, h, r0, min(r0 + rows, nq), nk, seed, rate,
                               q.device)
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        outs.append(torch.matmul(p.to(torch.bfloat16).float(), vf).to(
            torch.bfloat16))
        ms.append(m[..., 0])
        ls.append(l[..., 0])
    return tuple(t[0] if len(t) == 1 else torch.cat(t, dim=2)
                 for t in (outs, ms, ls))


def attention_amp_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """Plain torch version of kernel 14's AMP form over (B, h, N, d) bf16
    tensors, rate 0: ``attention_amp_train_plain``'s output (s = (q k^T) *
    sm_scale with the bf16 values' products summed in f32, s - its row's
    max, exp, divided by the row's sum, in f32; those probabilities rounded
    to bf16, their product with v summed in f32 and rounded to bf16)."""
    return attention_amp_train_plain(q, k, v, sm_scale)[0]


def attention_amp_bwd_plain(q, k, v, m, l, seed, do, sm_scale: float,
                            rate: float = 0.0):
    """Plain version of kernel 15's bf16 form: (dq, dk, dv) bf16 of bf16
    q, k, v and the output's cotangent ``do``, from the forward's row max
    ``m`` and sum ``l`` (B, h, Nq) f32 and its mask's ``seed``, the JAX
    ``_attn_bwd_kernel``'s arithmetic on bf16 inputs: p = exp(s * sm_scale
    - m) / l (the forward's p), p~ = keep ? p / (1 - rate) : 0, dv = bf16(p~)^T
    dO, dp = keep ? (dO v^T) / (1 - rate) : 0, Delta = sum_j dp p in f32,
    dS = p (dp - Delta), dSb = bf16(dS * sm_scale), dq = dSb k, dk = dSb^T q;
    every product of bf16 values summed in f32 and rounded to bf16 once (dk
    and dv over all query rows: the tile-free function).  Queries run in
    the forward's chunks."""
    return _attention_amp_bwd_plain(q, k, v, m, l, seed, do, sm_scale,
                                    rate)[:3]


def _attention_amp_bwd_plain(q, k, v, m, l, seed, do, sm_scale: float,
                             rate: float = 0.0):
    """``attention_amp_bwd_plain``'s (dq, dk, dv) and its Delta (B, h, Nq)
    f32, for the checks."""
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    rows = max(1, _CHUNK_BYTES // ((4 if rate == 0.0 else 16) * b * h * nk))
    kf, vf = k.float(), v.float()
    inv = 1.0 / (1.0 - rate)
    dqs, dk, dv, deltas = [], 0.0, 0.0, []
    for r0 in range(0, nq, rows):
        r1 = min(r0 + rows, nq)
        qc, doc = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        s = torch.matmul(qc, kf.transpose(2, 3)) * sm_scale
        p = torch.exp(s - m[:, :, r0:r1, None]) / l[:, :, r0:r1, None]
        dp = torch.matmul(doc, vf.transpose(2, 3))
        pt = p
        if rate > 0.0:
            keep = _keep_plain(b, h, r0, r1, nk, seed, rate, q.device)
            pt = torch.where(keep, p * inv, 0.0)
            dp = torch.where(keep, dp * inv, 0.0)
        dv = dv + torch.matmul(
            pt.to(torch.bfloat16).float().transpose(2, 3), doc)
        delta = (dp * p).sum(dim=-1, keepdim=True)
        deltas.append(delta[..., 0])
        ds = (p * (dp - delta) * sm_scale).to(torch.bfloat16).float()
        dqs.append(torch.matmul(ds, kf).to(torch.bfloat16))
        dk = dk + torch.matmul(ds.transpose(2, 3), qc)
    dq = dqs[0] if len(dqs) == 1 else torch.cat(dqs, dim=2)
    return (dq, dk.to(torch.bfloat16), dv.to(torch.bfloat16),
            torch.cat(deltas, dim=2))


def attention_bwd_plain(q, k, v, seed, do, sm_scale: float,
                        rate: float = 0.0):
    """Plain version of kernel 15: (dq, dk, dv) by torch autograd through
    ``attention_plain`` with the same mask."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_plain(*qkv, sm_scale, rate, seed)
        return torch.autograd.grad(out, qkv, do)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"attention kernels: {msg}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every (b, h, row) of t starts 16-byte aligned, d contiguous:
    the kernels copy rows 16 bytes at a time."""
    per = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in t.stride()[:3]))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy when its rows are not 16-byte aligned."""
    return t if _rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format)


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint


def _check_seed(seed, rate: float, device) -> None:
    if rate > 0.0:
        _require(seed is not None, "a dropout rate > 0 needs a seed")
        _require(seed.device == device and seed.dtype == torch.int64
                 and seed.numel() == 1,
                 f"seed must be one int64 on {device}")


def _check_qkv(q, k, v, dtype=torch.float32) -> tuple[int, int, int, int,
                                                     int]:
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             f"no kernel for devices {q.device}, {k.device}, {v.device}")
    _require(all(t.dtype == dtype for t in (q, k, v)),
             f"q, k and v must be {dtype}")
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k and v must be (B, h, N, d)")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    _require(k.shape == (b, h, nk, d) and v.shape == k.shape,
             f"k {tuple(k.shape)} and v {tuple(v.shape)} vs q "
             f"{tuple(q.shape)}")
    _require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _require(nq >= 1 and nk >= 1 and b <= 65535 and h <= 65535,
             f"shape {tuple(q.shape)} out of range")
    return b, h, nq, nk, d


def _heads(b: int, n: int, h: int, d: int, device,
           dtype=torch.float32) -> torch.Tensor:
    """A (B, h, N, d) view of a new (B, N, h, d) tensor: merging the heads
    back into (B, N, h * d) costs no copy."""
    return torch.empty((b, n, h, d), device=device,
                       dtype=dtype).transpose(1, 2)


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(*[
        s for t in ts for s in t.stride()[:3]])


def attention_fwd(q, k, v, sm_scale: float, rate: float = 0.0,
                  seed: torch.Tensor | None = None, with_lse: bool = False):
    """Kernel 14: (o, the log-sum-exp (B, h, Nq) of each row's scaled
    scores, or None).  ``with_lse`` or dropout (rate > 0) asks for its
    training form, which writes the log-sum-exp; else its evaluation form.
    CPU tensors take ``attention_plain``.  On CUDA tensors, q, k and v with
    rows that are not 16-byte aligned are copied first."""
    if q.device.type == "cpu":
        if with_lse or rate > 0.0:
            return attention_plain(q, k, v, sm_scale, rate, seed,
                                   with_lse=True)
        return attention_plain(q, k, v, sm_scale), None
    b, h, nq, nk, d = _check_qkv(q, k, v)
    q, k, v = (_aligned(t) for t in (q, k, v))
    _check_seed(seed, rate, q.device)
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    out = _heads(b, nq, h, d, q.device)
    strides = _strides(q, k, v, out)
    p = _build.ptr
    with torch.cuda.device(q.device):
        if with_lse or rate > 0.0:
            lse = torch.empty((b, h, nq), device=q.device,
                              dtype=torch.float32)
            rc = _fn("dg_attention_fwd_train",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P, _U, _F,
                      _P, _P])(
                p(q), p(k), p(v), p(out), b, h, nq, nk, d, strides,
                float(sm_scale), p(seed) if rate > 0.0 else None,
                keep_threshold(rate), 1.0 / (1.0 - rate), p(lse),
                _build.stream_of(q))
        else:
            lse = None
            rc = _fn("dg_attention_fwd",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P])(
                p(q), p(k), p(v), p(out), b, h, nq, nk, d, strides,
                float(sm_scale), _build.stream_of(q))
    _build.check(rc, "fused_attention")
    fused_attention.launches += 1
    return out, lse


def amp_route(d: int) -> str:
    """Kernel 14's AMP route at head dim ``d``: "wgmma" at 128 and 256
    (``csrc/attention_fwd_wgmma.cu``), "mma" at 512 (the earlier form,
    whose o at d = 512 alone holds 256 f32 a row of 64 per thread), "none"
    elsewhere (raises)."""
    if d in (128, 256):
        return "wgmma"
    return "mma" if d in HEAD_DIMS else "none"


def attention_fwd_amp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float, rate: float = 0.0,
                      seed: torch.Tensor | None = None,
                      with_stats: bool = False, *, earlier: bool = False):
    """Kernel 14's AMP form: (o (B, h, Nq, d) bf16, each row's max m and
    sum l (B, h, Nq) f32, or None twice) of bf16 q, k and v (module
    docstring).  ``with_stats`` or dropout (rate > 0, the mask of ``seed``)
    asks for its training form, which writes m and l; else its evaluation
    form.  At rate 0 the two give the same o, bit for bit.  CPU tensors
    take ``attention_amp_train_plain``.  On CUDA tensors, q, k and v with
    rows that are not 16-byte aligned are copied first; the output is a
    (B, h, Nq, d) view of a (B, Nq, h, d) tensor.  The route is
    ``amp_route(d)``'s; ``earlier`` launches the earlier form (mma.sync)
    at any d."""
    train = with_stats or rate > 0.0
    if q.device.type == "cpu":
        if train:
            return attention_amp_train_plain(q, k, v, sm_scale, rate, seed)
        return attention_amp_plain(q, k, v, sm_scale), None, None
    b, h, nq, nk, d = _check_qkv(q, k, v, torch.bfloat16)
    q, k, v = (_aligned(t) for t in (q, k, v))
    _check_seed(seed, rate, q.device)
    out = _heads(b, nq, h, d, q.device, torch.bfloat16)
    m = l = None
    if train:
        m, l = (torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
                for _ in range(2))
    p = _build.ptr
    wgmma = amp_route(d) == "wgmma" and not earlier
    name = "dg_attention_fwd_bf16_wgmma" if wgmma else "dg_attention_fwd_bf16"
    with torch.cuda.device(q.device):
        rc = _fn(name,
                 [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P, _U, _F, _P,
                  _P, _P])(
            p(q), p(k), p(v), p(out), b, h, nq, nk, d,
            _strides(q, k, v, out), float(sm_scale),
            p(seed) if rate > 0.0 else None, keep_threshold(rate),
            1.0 / (1.0 - rate), p(m) if train else None,
            p(l) if train else None, _build.stream_of(q))
    _build.check(rc, "fused_attention (bf16)")
    fused_attention.launches += 1
    fused_attention.amp_launches += 1
    fused_attention.wgmma_launches += wgmma
    if train:
        fused_attention.amp_train_launches += 1
    return out, m, l


def amp_bwd_route(d: int) -> str:
    """Kernel 15's bf16 route at head dim ``d``: "wgmma" at 128 and 256
    (``csrc/attention_bwd_wgmma.cu``), "mma" at 512 (the earlier form:
    dk and dv alone would take 512 registers a thread on wgmma), "none"
    elsewhere (raises)."""
    if d in (128, 256):
        return "wgmma"
    return "mma" if d in HEAD_DIMS else "none"


def _bwd_wgmma_scratch_bytes(b: int, h: int, nq: int, nk: int) -> int:
    """The scratch of kernel 15's wgmma form (``dg_attention_bwd_bf16_wgmma``):
    over Nq rounded up to 128 rows, each row's record (16 bytes), its keep
    bits over Nk rounded up to 64 keys (a bit a key) and its bf16 dS^T
    column."""
    nqa, nkp = -(-nq // 128) * 128, -(-nk // 64) * 64
    return b * h * nqa * (16 + nkp // 8 + 2 * nkp)


def attention_bwd_amp(q, k, v, m, l, seed, do, sm_scale: float,
                      rate: float = 0.0, *, earlier: bool = False):
    """Kernel 15's bf16 form: (dq, dk, dv) bf16 of ``fused_attention`` on
    bf16 q, k and v, from the forward's row max ``m`` and sum ``l`` (B, h,
    Nq) f32, the ``seed`` of its mask and the output's bf16 cotangent
    ``do``, the mask regenerated.  CPU tensors take
    ``attention_amp_bwd_plain``; CUDA tensors launch the kernel (one count
    a call): the route is ``amp_bwd_route(d)``'s (wgmma: three launches;
    the earlier form: two), ``earlier`` launches the earlier form at any
    d; q, k, v and do with rows that are not 16-byte aligned are copied
    first.  The gradients are (B, h, N, d) views of (B, N, h, d) tensors."""
    return _attention_bwd_amp(q, k, v, m, l, seed, do, sm_scale, rate,
                              earlier)[:3]


def _attention_bwd_amp(q, k, v, m, l, seed, do, sm_scale: float,
                       rate: float = 0.0, earlier: bool = False):
    """``attention_bwd_amp``'s (dq, dk, dv) and the Delta (B, h, Nq) f32
    the kernel summed, for the checks."""
    if q.device.type == "cpu":
        return _attention_amp_bwd_plain(q, k, v, m, l, seed, do, sm_scale,
                                        rate)
    b, h, nq, nk, d = _check_qkv(q, k, v, torch.bfloat16)
    _check_seed(seed, rate, q.device)
    _require(do.shape == q.shape and do.dtype == torch.bfloat16
             and do.device == q.device, "do must be bf16 like q")
    _require(all(t.shape == (b, h, nq) and t.is_contiguous()
                 and t.dtype == torch.float32 and t.device == q.device
                 for t in (m, l)),
             "m and l must be contiguous (B, h, Nq) float32 tensors")
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    dq = _heads(b, nq, h, d, q.device, torch.bfloat16)
    dk, dv = (_heads(b, nk, h, d, q.device, torch.bfloat16)
              for _ in range(2))
    delta = torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
    wgmma = amp_bwd_route(d) == "wgmma" and not earlier
    # the wgmma form's scratch: the rows' records, the keep bits, bf16 dS^T
    scratch = [torch.empty(_bwd_wgmma_scratch_bytes(b, h, nq, nk),
                           device=q.device, dtype=torch.uint8)
               for _ in range(wgmma)]
    name = ("dg_attention_bwd_bf16_wgmma" if wgmma
            else "dg_attention_bwd_bf16")
    p = _build.ptr
    with torch.cuda.device(q.device):
        rc = _fn(name, [_P] * 10 + [_I] * 5 + [_P, _F, _P, _U, _F]
                 + [_P] * (1 + wgmma))(
            p(q), p(k), p(v), p(do), p(m), p(l), p(delta), p(dq), p(dk),
            p(dv), b, h, nq, nk, d, _strides(q, k, v, do, dq, dk, dv),
            float(sm_scale), p(seed) if rate > 0.0 else None,
            keep_threshold(rate), 1.0 / (1.0 - rate),
            *(p(t) for t in scratch), _build.stream_of(q))
    _build.check(rc, "attention_bwd (bf16)")
    attention_bwd_amp.launches += 1
    attention_bwd_amp.wgmma_launches += wgmma
    return dq, dk, dv, delta


def attention_bwd(q, k, v, o, lse, seed, do, sm_scale: float,
                  rate: float = 0.0):
    """Kernel 15: (dq, dk, dv) of ``fused_attention`` from q, k, v, its
    output ``o`` and log-sum-exp ``lse`` (B, h, Nq), the ``seed`` of its
    mask and the output's cotangent ``do``, the mask regenerated.  CPU
    tensors take ``attention_bwd_plain``; CUDA tensors launch the kernel
    (three launches, one count): q, k, v and do with rows that are not
    16-byte aligned are copied first.  The gradients are (B, h, N, d)
    views of (B, N, h, d) tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, seed, do, sm_scale, rate)
    b, h, nq, nk, d = _check_qkv(q, k, v)
    _check_seed(seed, rate, q.device)
    _require(o.shape == q.shape and do.shape == q.shape
             and o.stride(3) == 1 and o.dtype == do.dtype == torch.float32
             and o.device == do.device == q.device,
             "o and do must be float32 like q, unit stride along d")
    _require(lse.shape == (b, h, nq) and lse.is_contiguous()
             and lse.dtype == torch.float32 and lse.device == q.device,
             "lse must be a contiguous (B, h, Nq) float32 tensor")
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    dq = _heads(b, nq, h, d, q.device)
    dk, dv = _heads(b, nk, h, d, q.device), _heads(b, nk, h, d, q.device)
    delta = torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
    p = _build.ptr
    with torch.cuda.device(q.device):
        rc = _fn("dg_attention_bwd",
                 [_P] * 10 + [_I] * 5 + [_P, _F, _P, _U, _F, _P])(
            p(q), p(k), p(v), p(o), p(do), p(lse), p(delta), p(dq), p(dk),
            p(dv), b, h, nq, nk, d, _strides(q, k, v, o, do, dq, dk, dv),
            float(sm_scale), p(seed) if rate > 0.0 else None,
            keep_threshold(rate), 1.0 / (1.0 - rate), _build.stream_of(q))
    _build.check(rc, "attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


def dropout_mask(shape, seed: torch.Tensor, rate: float,
                 device) -> torch.Tensor:
    """Kernel 16: the (B, h, Nq, Nk) f32 keep mask that the attention
    kernels draw under ``seed`` at ``rate`` (``dropout_mask_plain``'s
    bits).  On the CPU the plain version runs; on a CUDA device the
    kernel, with the seed (one int64) on that device."""
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_mask_plain(shape, seed, rate, device)
    b, h, nq, nk = shape
    _require(device.type == "cuda", f"no kernel for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _require(seed.device == device and seed.dtype == torch.int64
             and seed.numel() == 1, f"seed must be one int64 on {device}")
    _require(min(shape) >= 1 and b <= 65535 and h <= 65535,
             f"mask shape {tuple(shape)} out of range")
    mask = torch.empty(shape, device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        rc = _fn("dg_attention_mask", [_P, _I, _I, _I, _I, _P, _U, _P])(
            _build.ptr(mask), b, h, nq, nk, _build.ptr(seed),
            keep_threshold(rate), _build.stream_of(mask))
    _build.check(rc, "dropout_mask")
    dropout_mask.launches += 1
    return mask


class FusedAttention(torch.autograd.Function):
    """(q, k, v, sm_scale, rate, seed) -> the attention's output: kernel 14
    in its training form forward, kernel 15 backward.  It saves q, k, v,
    the output, the log-sum-exp and the seed, never a (B, h, N, N)
    tensor."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, rate: float, seed):
        out, lse = attention_fwd(q, k, v, sm_scale, rate, seed,
                                 with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.sm_scale, ctx.rate = sm_scale, rate
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse, seed = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, seed, do,
                                   ctx.sm_scale, ctx.rate)
        return dq, dk, dv, None, None, None


class FusedAttentionAMP(torch.autograd.Function):
    """(q, k, v, sm_scale, rate, seed) -> the attention's bf16 output:
    kernel 14's AMP training form forward, kernel 15's bf16 form backward.
    It saves q, k, v, each row's max and sum and the seed, never a (B, h,
    N, N) tensor; not the output, which the backward does not read (its
    Delta comes from the rebuilt p)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, rate: float, seed):
        out, m, l = attention_fwd_amp(q, k, v, sm_scale, rate, seed,
                                      with_stats=True)
        ctx.save_for_backward(q, k, v, m, l, seed)
        ctx.sm_scale, ctx.rate = sm_scale, rate
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, m, l, seed = ctx.saved_tensors
        dq, dk, dv = attention_bwd_amp(q, k, v, m, l, seed, do,
                                       ctx.sm_scale, ctx.rate)
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, rate: float = 0.0,
                    seed: torch.Tensor | None = None) -> torch.Tensor:
    """dropout(softmax(q k^T * sm_scale)) v: q (B, h, Nq, d), k and v (B,
    h, Nk, d) -> (B, h, Nq, d) f32, each kept probability scaled by 1 / (1
    - rate); ``seed`` (one int64 on the tensors' device) picks the mask and
    is required when ``rate`` > 0.

    CPU tensors take ``attention_plain`` (autograd through it).  CUDA
    tensors launch kernel 14, which takes f32 tensors with d in
    ``HEAD_DIMS`` and raises on anything else: its evaluation form when no
    gradient is wanted at rate 0, else ``FusedAttention`` (kernel 15
    backward).  It reads the heads of a (B, N, h * d) projection in place;
    an input whose rows do not start 16-byte aligned, or that is not
    contiguous along d, is copied first.  The output is a (B, h, Nq, d)
    view of a (B, Nq, h, d) tensor, so that merging the heads back into (B,
    Nq, h * d) costs no copy.

    bf16 q, k and v take kernel 14's AMP form, with a bf16 output: its
    evaluation form at rate 0 without a gradient (``attention_fwd_amp``),
    else ``FusedAttentionAMP`` (its training form, kernel 15's bf16 form
    backward); their plain versions on the CPU."""
    if rate > 0.0 and seed is None:
        raise ValueError("fused_attention: a dropout rate > 0 needs a seed")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        if rate > 0.0 or grad:
            return FusedAttentionAMP.apply(q, k, v, sm_scale, rate, seed)
        return attention_fwd_amp(q, k, v, sm_scale)[0]
    if q.device.type == "cpu":
        return attention_plain(q, k, v, sm_scale, rate, seed)
    if grad:
        return FusedAttention.apply(q, k, v, sm_scale, rate, seed)
    return attention_fwd(q, k, v, sm_scale, rate, seed)[0]


# launches of each kernel since its count was last set to 0 (kernel 15's
# CUDA launches count once a call; amp_launches: kernel 14's AMP forms,
# amp_train_launches: its AMP training form; attention_bwd_amp: kernel
# 15's bf16 form, wgmma_launches those on wgmma)
fused_attention.launches = fused_attention.amp_launches = 0
fused_attention.amp_train_launches = fused_attention.wgmma_launches = 0
attention_bwd.launches = attention_bwd_amp.launches = 0
attention_bwd_amp.wgmma_launches = 0
dropout_mask.launches = 0
