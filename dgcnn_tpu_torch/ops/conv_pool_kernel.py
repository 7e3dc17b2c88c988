"""Kernel 2: embedding conv + folded BN + LeakyReLU + global max/mean pool,
hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_pool.py::fused_conv_pool`` (body
``_conv_pool_kernel``) in its f32 mode.  The kernel is
``csrc/conv_pool.cu``.  It is bound by operations on an H100 (the DGCNNCls
head's product is ~69 GFLOP, ~1.0 ms at the f32 CUDA-core peak).  Every
model's shapes (input widths and E multiples of 4, aligned rows) take its
register-blocked route: 128 x 128 output tiles of ``csrc/gemm128.cuh``'s
core (the projection's), 8 x 8 registers a thread, 32-deep k chunks copied
by 16-byte ``cp.async`` into a second buffer, the grid split over row
groups of each cloud whose partial max and sum rows a second small kernel
adds in group order.  Other shapes take the first form, a 64 x 64 tile a
block walking the whole cloud (``tile64=True`` forces it at any shape, for
the checks and the A/B).  Both routes give y the same bits, so the max row
is bit-equal between them; the mean sums in another fixed order on each,
the same bits from call to call.  ``conv_pool_plain`` beside it is the same
function in plain torch: the wrapper runs it for CPU tensors and launches
the kernel for CUDA tensors.

``amp=True`` is the AMP form, ``fused_conv_pool(compute_dtype=bf16)``
(``pallas_pool.py:31-48``), the JAX package's default: bf16 inputs (the
AMP stages' outputs) and W rounded to bf16, f32 products and sums, each
input's product its own sum, added input by input; the epilogue and the
pooled rows f32.  ``conv_pool_amp_plain`` is its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.amp_select import round_bf16

MAX_INPUTS = 4


def conv_pool_plain(xs, w, scale, bias, slope: float = 0.2,
                    with_mean: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel: (B, 2 | 1, E) f32."""
    h = torch.matmul(torch.cat(tuple(xs), dim=-1), w)
    y = h * scale + bias
    y = torch.where(y >= 0, y, slope * y)
    rows = [y.amax(dim=1)] + ([y.mean(dim=1)] if with_mean else [])
    return torch.stack(rows, dim=1)


def conv_pool_amp_plain(xs, w, scale, bias, slope: float = 0.2,
                        with_mean: bool = True) -> torch.Tensor:
    """Plain torch version of the AMP form: (B, 2 | 1, E) f32."""
    wb = round_bf16(w.float())
    h, off = None, 0
    for x in xs:
        c = x.shape[-1]
        d = torch.matmul(round_bf16(x.float()), wb[off:off + c])
        h = d if h is None else h + d
        off += c
    y = h * scale + bias
    y = torch.where(y >= 0, y, slope * y)
    rows = [y.amax(dim=1)] + ([y.mean(dim=1)] if with_mean else [])
    return torch.stack(rows, dim=1)


def _fn(name: str, scratch: bool):
    fn = getattr(_build.load_library(), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 4 + [i] * 5 + [p] * (5 if scratch else 4)
                       + [i] * 3 + [ctypes.c_float, i, p])
        fn.restype = i
    return fn


def _scratch_floats(b: int, n: int, e: int) -> int:
    fn = _build.load_library().dg_conv_pool_scratch_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    return fn(b, n, e)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"conv_pool: {msg}")


def conv_pool(xs, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              slope: float = 0.2, with_mean: bool = True, *,
              tile64: bool = False, amp: bool = False) -> torch.Tensor:
    """LeakyReLU((concat(xs) @ w) * scale + bias) pooled over N.

    ``xs``: up to four (B, N, Ci) tensors whose channel concat is the conv
    input (sum Ci == w rows); ``w`` (C, E); ``scale``/``bias`` (E,).
    Returns (B, 2, E): row 0 the max over N, row 1 the mean (with_mean=False
    keeps only the max row).  CPU tensors take the plain version; CUDA
    tensors launch the kernel, which takes f32 contiguous inputs and raises
    on anything else.  The kernel's route is decided from the shape before
    the launch (the module's note); ``tile64`` launches the first form at
    any shape.  ``amp`` runs the AMP form (plain: ``conv_pool_amp_plain``),
    whose kernel takes bf16 inputs of widths, and an E, that are multiples
    of 4."""
    xs = tuple(xs)
    if xs[0].device.type == "cpu":
        fn = conv_pool_amp_plain if amp else conv_pool_plain
        return fn(xs, w, scale, bias, slope, with_mean)
    if amp:
        return _conv_pool_amp(xs, w, scale, bias, slope, with_mean)
    dev = xs[0].device
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(1 <= len(xs) <= MAX_INPUTS, f"1..{MAX_INPUTS} inputs")
    tensors = xs + (w, scale, bias)
    _require(all(t.device == dev for t in tensors),
             "all tensors must be on one device")
    _require(all(t.dtype == torch.float32 for t in tensors),
             "tensors must be float32")
    _require(all(x.is_contiguous() for x in xs), "inputs must be contiguous")
    b, n, _ = xs[0].shape
    _require(all(x.dim() == 3 and x.shape[:2] == (b, n) for x in xs),
             "inputs must share (B, N)")
    c = sum(x.shape[2] for x in xs)
    e = w.shape[1]
    _require(w.shape == (c, e), f"w {tuple(w.shape)} vs {c} input channels")
    _require(scale.shape == (e,) and bias.shape == (e,),
             "scale/bias must be (E,)")
    fn = _fn("dg_conv_pool_tile64" if tile64 else "dg_conv_pool",
             not tile64)
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    w = w.contiguous()
    scale = scale.contiguous()
    bias = bias.contiguous()
    out = torch.empty((b, 2 if with_mean else 1, e), device=dev,
                      dtype=torch.float32)
    ptrs = [_build.ptr(x) for x in xs] + [None] * (MAX_INPUTS - len(xs))
    widths = [x.shape[2] for x in xs] + [0] * (MAX_INPUTS - len(xs))
    p = _build.ptr
    scratch = []  # the row groups' partial rows (none on one group)
    if not tile64:
        floats = _scratch_floats(b, n, e)
        part = (torch.empty((floats,), device=dev, dtype=torch.float32)
                if floats else None)
        scratch = [None if part is None else p(part)]
    with torch.cuda.device(dev):
        rc = fn(*ptrs, *widths, len(xs), p(w), p(scale), p(bias), *scratch,
                p(out), b, n, e, float(slope), int(with_mean),
                _build.stream_of(w))
    _build.check(rc, "conv_pool")
    conv_pool.launches += 1
    return out


def _conv_pool_amp(xs, w, scale, bias, slope, with_mean) -> torch.Tensor:
    dev = xs[0].device
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(1 <= len(xs) <= MAX_INPUTS, f"1..{MAX_INPUTS} inputs")
    _require(all(t.device == dev for t in xs + (w, scale, bias)),
             "all tensors must be on one device")
    _require(all(x.dtype == torch.bfloat16 for x in xs),
             "the AMP form takes bf16 inputs")
    _require(all(t.dtype == torch.float32 for t in (w, scale, bias)),
             "w, scale and bias must be float32")
    _require(all(x.is_contiguous() for x in xs), "inputs must be contiguous")
    b, n, _ = xs[0].shape
    _require(all(x.dim() == 3 and x.shape[:2] == (b, n) for x in xs),
             "inputs must share (B, N)")
    widths = [x.shape[2] for x in xs]
    c = sum(widths)
    e = w.shape[1]
    _require(w.shape == (c, e), f"w {tuple(w.shape)} vs {c} input channels")
    _require(scale.shape == (e,) and bias.shape == (e,),
             "scale/bias must be (E,)")
    _require(e % 4 == 0 and all(ci % 4 == 0 for ci in widths),
             "the AMP form takes widths and E multiples of 4")
    fn = getattr(_build.load_library(), "dg_conv_pool_amp")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 4 + [i] * 5 + [p] * 7 + [i] * 3
                       + [ctypes.c_float, i, p])
        fn.restype = i
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    w, scale, bias = (t.contiguous() for t in (w, scale, bias))
    xf = torch.empty((b * n * c,), device=dev, dtype=torch.float32)
    wb = torch.empty((c * e,), device=dev, dtype=torch.float32)
    floats = _scratch_floats(b, n, e)
    part = (torch.empty((floats,), device=dev, dtype=torch.float32)
            if floats else None)
    out = torch.empty((b, 2 if with_mean else 1, e), device=dev,
                      dtype=torch.float32)
    p = _build.ptr
    ptrs = [p(x) for x in xs] + [None] * (MAX_INPUTS - len(xs))
    widths += [0] * (MAX_INPUTS - len(xs))
    with torch.cuda.device(dev):
        rc = fn(*ptrs, *widths, len(xs), p(w), p(scale), p(bias), p(xf),
                p(wb), None if part is None else p(part), p(out), b, n, e,
                float(slope), int(with_mean), _build.stream_of(w))
    _build.check(rc, "conv_pool")
    conv_pool.launches += 1
    conv_pool.amp_launches += 1
    return out


# launches of the kernel since the count was last set to 0 (amp_launches:
# those of its AMP form)
conv_pool.launches = 0
conv_pool.amp_launches = 0
