"""Kernel 14, ``fused_attention``: multi-head softmax attention, forward,
hand-written CUDA.

Replaces ``dgcnn_tpu/ops/pallas_attention.py::_attn_fwd_impl`` (body
``_attn_fwd_kernel``) at dropout rate 0, the attention of the fusion Net's
``TorchMultiheadAttention`` in evaluation.  The kernel is
``csrc/attention_fwd.cu``; its note states the bound on an H100 and what
the design does about it.

The JAX package turns its kernel off in exact mode
(``dgcnn_tpu/models/torch_transformer.py::_use_fused`` under
``DGCNN_TPU_PALLAS_EXACT``): the TPU kernel's bf16 products and its core
random stream are not exact, so exact mode takes the dense XLA path.  This
kernel computes every product and sum in f32 (no TF32), the dense exact
function to rounding, so the port runs it in exact mode, held to the dense
path (``attention_plain``) by the tests and ``chip_smoke.py``.  Dropout on
the probabilities (training) is not ported yet.

CPU tensors take ``attention_plain``; CUDA tensors launch the kernel, which
raises on what it does not take.
"""
from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops import _build

# head dims the kernel is built for: the fusion Net's 512 / h for h = 1,
# 2 and 4 (the partseg CLI's default, the bench config, the dist trainer)
HEAD_DIMS = (128, 256, 512)

# cap of one query chunk's (B, h, chunk, Nk) f32 score slab in the plain
# version (the JAX dense fallback's _DENSE_CHUNK_BYTES)
_CHUNK_BYTES = 512 * 1024 * 1024


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Plain torch version of the kernel: softmax(q k^T * sm_scale) v over
    (B, h, N, d) f32 tensors, the JAX package's dense path
    (torch_transformer.py, its dense fallback).  Queries run in chunks
    whose f32 score slab stays under 512 MB, each row's softmax over the
    whole key axis as in one pass."""
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    rows = max(1, _CHUNK_BYTES // (4 * b * h * nk))
    kt = k.float().transpose(2, 3)
    outs = []
    for r0 in range(0, nq, rows):
        s = torch.matmul(q[:, :, r0:r0 + rows].float(), kt) * sm_scale
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v.float()))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_attention: {msg}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every (b, h, row) of t starts 16-byte aligned, d contiguous:
    the kernel copies rows 16 bytes at a time."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:3]))


def _lib():
    fn = _build.load_library().dg_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, ctypes.c_float, p]
        fn.restype = i
    return fn


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v: q (B, h, Nq, d), k and v (B, h, Nk, d)
    -> (B, h, Nq, d) f32.

    CPU tensors take ``attention_plain``.  CUDA tensors launch the kernel,
    which takes f32 tensors with d in ``HEAD_DIMS`` and raises on anything
    else.  It reads the heads of a (B, N, h * d) projection in place; an
    input whose rows do not start 16-byte aligned, or that is not
    contiguous along d, is copied first.  The output is a (B, h, Nq, d) view
    of a (B, Nq, h, d) tensor, so that merging the heads back into (B, Nq,
    h * d) costs no copy."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, sm_scale)
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
    q, k, v = (t if _rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    fn = _lib()
    # the launch is asynchronous on torch's current stream: tensors made here
    # and freed on return are reused by the caching allocator only for work
    # queued after it on that stream
    out = torch.empty((b, nq, h, d), device=q.device,
                      dtype=torch.float32).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]])
    p = _build.ptr
    with torch.cuda.device(q.device):
        rc = fn(p(q), p(k), p(v), p(out), b, h, nq, nk, d, strides,
                float(sm_scale), _build.stream_of(q))
    _build.check(rc, "fused_attention")
    fused_attention.launches += 1
    return out


# launches of the kernel since the count was last set to 0
fused_attention.launches = 0
