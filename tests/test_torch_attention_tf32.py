"""The numerical case for kernel 15's tensor-core design, on the CPU.

``csrc/attention_bwd.cu`` runs each of the attention backward's products
on the tensor cores in three TF32 terms (``csrc/mma_tf32.cuh``): every f32
operand splits into hi = tf32(a) and lo = tf32(a - hi), rounded to
nearest with ties away from zero as ``cvt.rna.tf32.f32`` does, and a
product sums lo*hi + hi*lo and then hi*hi in f32.  Here that split is
emulated on the f32 bit patterns, each of the five products of the
backward (s, dO v^T, dv, dq, dk) is taken in three terms and in one, and
the result is held against ``attention_bwd_plain`` (autograd through the
f32 dense path, the kernel's plain version) and, at rate 0, against
jax.vjp of the JAX package's Pallas attention in interpret mode.  The
card's own run of the kernel is held by ``chip_smoke.py`` (phases 28 and
31) and the ``cuda``-marked tests.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.ops import attention_bwd_plain, attention_plain
from dgcnn_tpu_torch.ops.attention import dropout_mask_plain


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero: 2^12 added to the magnitude's bits, the low 13 cut."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: lo*hi + hi*lo, then + hi*hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 term: hi*hi."""
    return tf32_rna(a) @ tf32_rna(b)


def backward(q, k, v, do, scale, rate, seed, mm):
    """(dq, dk, dv) as kernel 15 computes them, every product through
    ``mm``: P = exp(s * scale - lse), P~ = mask * P / (1 - rate), dv = P~^T
    dO, dS = P * (mask * dO v^T / (1 - rate) - Delta) * scale, dq = dS k,
    dk = dS^T q; o and the log-sum-exp from kernel 14's plain version."""
    o, lse = attention_plain(q, k, v, scale, rate, seed, with_lse=True)
    delta = (do * o).sum(-1, keepdim=True)
    kt, vt = k.transpose(2, 3), v.transpose(2, 3)
    p = torch.exp(mm(q, kt) * scale - lse[..., None])
    dp = mm(do, vt)
    if rate > 0.0:
        keep = dropout_mask_plain((*q.shape[:3], k.shape[2]), seed, rate)
        pt, dp = p * keep / (1.0 - rate), dp * keep / (1.0 - rate)
    else:
        pt = p
    ds = p * (dp - delta) * scale
    return mm(ds, k), mm(ds.transpose(2, 3), q), mm(pt.transpose(2, 3), do)


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _inputs(seed: int, b: int, h: int, nq: int, nk: int, d: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(
        np.float32)) for n in (nq, nk, nk, nq)]


def test_tf32_rounding_is_cvt_rna():
    """The emulated cvt.rna: 10 stored mantissa bits, to nearest, ties away
    from zero for either sign; hi + lo holds x to 2^-22 of |x|."""
    one = 1.0 + 2.0 ** -11   # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                         0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    hi, lo = split(y)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert ((hi - y).abs() <= 2.0 ** -11 * y.abs()).all()
    err = (hi.double() + lo.double() - y.double()).abs()
    assert (err <= 2.0 ** -22 * y.double().abs()).all()


@pytest.mark.parametrize("shape", [(2, 2, 256, 256, 128),
                                   (1, 2, 200, 200, 256)])
def test_three_term_products_hold_the_backward(shape):
    """With every product in three TF32 terms, dq, dk and dv are within rel
    1e-5 of each row's norm of the plain f32 backward at rate 0.5 (a
    ragged 200-point case too); in one term (hi*hi) the error is at least
    10x larger: the reason for three."""
    b, h, nq, nk, d = shape
    q, k, v, do = _inputs(d + nq, b, h, nq, nk, d)
    scale, rate = d ** -0.5, 0.5
    seed = torch.tensor([d + nq], dtype=torch.int64)
    want = attention_bwd_plain(q, k, v, seed, do, scale, rate)
    three = [_row_rel(g, w) for g, w in zip(
        backward(q, k, v, do, scale, rate, seed, mm3), want)]
    one = [_row_rel(g, w) for g, w in zip(
        backward(q, k, v, do, scale, rate, seed, mm1), want)]
    assert max(three) <= 1e-5, three
    assert min(one) >= 10 * max(three), (one, three)


def test_three_term_backward_matches_pallas_at_rate_0():
    """At rate 0, the three-term backward against jax.vjp of the JAX
    package's Pallas fused_attention in interpret mode (the body of the
    TPU kernel 15): rel 1e-5 of each gradient's scale."""
    from dgcnn_tpu.ops.pallas_attention import fused_attention as jfused

    q, k, v, do = _inputs(7, 1, 2, 128, 256, 128)
    scale = 128 ** -0.5
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(lambda a, b_, c: jfused(
            a, b_, c, sm_scale=scale, interpret=True),
            *(jnp.asarray(t.numpy()) for t in (q, k, v)))
        want = vjp(jnp.asarray(do.numpy()))
    got = backward(q, k, v, do, scale, 0.0, None, mm3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
