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
by the tests and ``chip_smoke.py``: kernel 14 takes every product and sum
in f32 on the CUDA cores (no TF32); kernel 15 takes its products on the
tensor cores in three TF32 terms (3xTF32, ``csrc/mma_tf32.cuh``: hi*hi +
hi*lo + lo*hi of each operand split in two), within ~1e-5 of each row's
norm of the f32 result, inside its gate of 1e-4.

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
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:3]))


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


def _check_qkv(q, k, v) -> tuple[int, int, int, int, int]:
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             f"no kernel for devices {q.device}, {k.device}, {v.device}")
    _require(all(t.dtype == torch.float32 for t in (q, k, v)),
             "q, k and v must be float32")
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


def _heads(b: int, n: int, h: int, d: int, device) -> torch.Tensor:
    """A (B, h, N, d) view of a new (B, N, h, d) tensor: merging the heads
    back into (B, N, h * d) costs no copy."""
    return torch.empty((b, n, h, d), device=device,
                       dtype=torch.float32).transpose(1, 2)


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
    Nq, h * d) costs no copy."""
    if rate > 0.0 and seed is None:
        raise ValueError("fused_attention: a dropout rate > 0 needs a seed")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, sm_scale, rate, seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedAttention.apply(q, k, v, sm_scale, rate, seed)
    return attention_fwd(q, k, v, sm_scale, rate, seed)[0]


# launches of each kernel since its count was last set to 0 (kernel 15's
# three CUDA launches count once)
fused_attention.launches = 0
attention_bwd.launches = 0
dropout_mask.launches = 0
