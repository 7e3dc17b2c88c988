"""Kernel 2: embedding conv + folded BN + LeakyReLU + global max/mean pool,
hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_pool.py::fused_conv_pool`` (body
``_conv_pool_kernel``) in its f32 mode.  The kernel is
``csrc/conv_pool.cu``; its note states the bound on an H100 and what the
design does about it.  ``conv_pool_plain`` beside it is the same function
in plain torch: the wrapper runs it for CPU tensors and launches the kernel
for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build

MAX_INPUTS = 4


def conv_pool_plain(xs, w, scale, bias, slope: float = 0.2,
                    with_mean: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel: (B, 2 | 1, E) f32."""
    h = torch.matmul(torch.cat(tuple(xs), dim=-1), w)
    y = h * scale + bias
    y = torch.where(y >= 0, y, slope * y)
    rows = [y.amax(dim=1)] + ([y.mean(dim=1)] if with_mean else [])
    return torch.stack(rows, dim=1)


def _lib():
    lib = _build.load_library()
    fn = lib.dg_conv_pool
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"conv_pool: {msg}")


def conv_pool(xs, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              slope: float = 0.2, with_mean: bool = True) -> torch.Tensor:
    """LeakyReLU((concat(xs) @ w) * scale + bias) pooled over N.

    ``xs``: up to four (B, N, Ci) tensors whose channel concat is the conv
    input (sum Ci == w rows); ``w`` (C, E); ``scale``/``bias`` (E,).
    Returns (B, 2, E): row 0 the max over N, row 1 the mean (with_mean=False
    keeps only the max row).  CPU tensors take the plain version; CUDA
    tensors launch the kernel, which takes f32 contiguous inputs and raises
    on anything else."""
    xs = tuple(xs)
    if xs[0].device.type == "cpu":
        return conv_pool_plain(xs, w, scale, bias, slope, with_mean)
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
    fn = _lib()
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
    with torch.cuda.device(dev):
        rc = fn(*ptrs, *widths, len(xs), p(w), p(scale), p(bias), p(out),
                b, n, e, float(slope), int(with_mean), _build.stream_of(w))
    _build.check(rc, "conv_pool")
    conv_pool.launches += 1
    return out


# launches of the kernel since the count was last set to 0
conv_pool.launches = 0
