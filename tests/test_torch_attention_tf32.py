"""The numerical case for the tensor-core design of kernels 14 and 15, on
the CPU.

``csrc/attention_fwd.cu`` (at d = 128 and 256) and ``csrc/attention_bwd.cu``
run each of the attention's products on the tensor cores in three TF32
terms (``csrc/mma_tf32.cuh``): every f32 operand splits into hi = tf32(a)
and lo = tf32(a - hi), rounded to nearest with ties away from zero as
``cvt.rna.tf32.f32`` does, and a product sums lo*hi + hi*lo and then
hi*hi in f32.  Here that split is emulated on the f32 bit patterns.  The
forward's two products (s, P v) are taken in three terms and in one, with
the kernel's short sums (each 32 columns of d of a score, each key tile of
P v, added in f32 under the online softmax), and held against
``attention_plain`` (o and the log-sum-exp); the five products of the
backward (s, dO v^T, dv, dq, dk) likewise against ``attention_bwd_plain``
(autograd through the f32 dense path, the kernel's plain version).  At
rate 0 both are held against the JAX package's Pallas attention in
interpret mode (its forward, and jax.vjp of it).  The card's own run of
the kernels is held by ``chip_smoke.py`` (phases 24, 28 and 31) and the
``cuda``-marked tests.
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


def forward(q, k, v, scale, rate, seed, mm, bk=32):
    """(o, the log-sum-exp of each row) as kernel 14's tensor-core form
    computes them, every product through ``mm``: the keys in tiles of
    ``bk``, each tile's scores summed over 32-column slices of d in f32,
    the online softmax (the row sum before the mask, P dropped and scaled
    after it), and each tile's P v joining the running output in f32 after
    the rescale."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    keep = (dropout_mask_plain((b, h, nq, nk), seed, rate) > 0
            if rate > 0.0 else None)
    m = torch.full((b, h, nq, 1), float("-inf"))
    l = torch.zeros((b, h, nq, 1))
    acc = torch.zeros((b, h, nq, d))
    for k0 in range(0, nk, bk):
        kt = k[:, :, k0:k0 + bk]
        s = torch.zeros((b, h, nq, kt.shape[2]))
        for c0 in range(0, d, 32):
            s = s + mm(q[..., c0:c0 + 32], kt[..., c0:c0 + 32].transpose(2, 3))
        s = s * scale
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = mx
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + bk], p * (1.0 / (1.0 - rate)),
                            0.0)
        acc = acc * alpha + mm(p, v[:, :, k0:k0 + bk])
    return acc / l, (m + torch.log(l))[..., 0]


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


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(2, 2, 160, 192, 128),
                                   (1, 2, 128, 200, 256),
                                   (1, 1, 96, 136, 512)])
def test_three_term_products_hold_the_forward(shape, rate):
    """With both products in three TF32 terms and the kernel's short sums,
    o is within rel 1e-5 of each row's norm of the plain f32 forward and
    the log-sum-exp within rel 1e-5, at the three head dims (ragged key
    tiles too) and rates 0 and 0.5; in one term (hi*hi) o's error is at
    least 10x larger."""
    b, h, nq, nk, d = shape
    q, k, v, _ = _inputs(d + nk, b, h, nq, nk, d)
    scale = d ** -0.5
    seed = torch.tensor([d + nq], dtype=torch.int64) if rate else None
    want, lse_want = attention_plain(q, k, v, scale, rate, seed,
                                     with_lse=True)
    o3, lse3 = forward(q, k, v, scale, rate, seed, mm3)
    o1, _ = forward(q, k, v, scale, rate, seed, mm1)
    rel3 = _row_rel(o3, want)
    lse_rel = ((lse3 - lse_want).abs() / lse_want.abs()).max().item()
    assert rel3 <= 1e-5, rel3
    assert lse_rel <= 1e-5, lse_rel
    assert _row_rel(o1, want) >= 10 * rel3, (_row_rel(o1, want), rel3)


def test_three_term_forward_matches_pallas_at_rate_0():
    """At rate 0, the three-term forward against the JAX package's Pallas
    fused_attention in interpret mode (the body of the TPU kernel 14):
    rel 1e-5 of the output's scale."""
    from dgcnn_tpu.ops.pallas_attention import fused_attention as jfused

    q, k, v, _ = _inputs(11, 1, 2, 128, 256, 256)
    scale = 256 ** -0.5
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jfused(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 sm_scale=scale, interpret=True))
    got, _ = forward(q, k, v, scale, 0.0, None, mm3)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


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
