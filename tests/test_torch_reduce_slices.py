"""The arithmetic of kernel 5's channel slices and kernel 7's tiles, on the
CPU.

``csrc/edge_reduce_bwd.cu`` (kernel 5, at N <= 16384) gives a block one
cloud and CS channels, CS the largest power of two up to 32 with N * CS <=
16384, with that slice of ``a`` and of ``da`` in shared memory.  Its 1024
threads take the items q = i * CS + c in rounds of 1024; an item counts the
ties of (i, c) against amax / amin over its k neighbours, forms each edge's
cotangent w_t with the ``_rn`` operations in the atomic form's order, and
adds it into ``da[idx[i, t], c]`` with a shared-memory atomic.
``edge_reduce_bwd_slices`` emulates that in f32, the adds in one order the
block may take (round by round, t ascending, items ascending), and must
land within rel 1e-5 of ``edge_reduce_bwd_plain`` and of the Pallas
``edge_reduce_bwd`` in interpret mode on random clouds, and on them
exactly on integer duplicate-points clouds, where every addend and every
sum is an integer.

``csrc/edge2_reduce.cu`` (kernel 7, at C1, C2 <= 64 and k <= 128) takes
tiles of R = min(8, 128 // k) whole centre rows: each edge's h1, its z2 =
h1 w2 as one fused multiply-add chain over c1 ascending from +0, and each
row's max, min, sum and sum of squares over its k edges in t order.
``edge2_fwd_tiled`` emulates that (the fused multiply-add through float64,
one rounding to f32 a step) and must give ``edge2_fwd_plain`` and the
Pallas ``_edge2_fwd_call`` in interpret mode: exactly on integer clouds,
within rel 1e-5 on random ones.  The card's kernels are held to their
earlier routes by ``chip_smoke.py`` (phases 8, 13 and 18),
``dgcnn_tpu_torch/tools/reduce_ab.py --kernel edge_reduce_bwd | edge2_fwd``
and the ``cuda``-marked tests of ``tests/test_torch_port_ops.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.ops import (
    edge2_fwd_plain,
    edge_reduce_bwd_plain,
    pairwise_neg_sqdist,
)

SLICE_FLOATS, MAX_CS, THREADS = 16384, 32, 1024


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _held(got, want, kind, name):
    if kind == "ints":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert _rel(got, want) <= 1e-5, (name, _rel(got, want))


def _knn(g: np.ndarray, k: int) -> np.ndarray:
    scores = pairwise_neg_sqdist(torch.from_numpy(g)).numpy()
    return np.argsort(-scores, axis=-1, kind="stable")[..., :k].astype(
        np.int32)


def _ties_at_boundary(g: np.ndarray, k: int) -> bool:
    scores = -np.sort(-pairwise_neg_sqdist(torch.from_numpy(g)).numpy(), -1)
    return bool((scores[..., k - 1] == scores[..., k]).any())


# ------------------------------------------------------------ kernel 5
def slice_width(n: int) -> int:
    cs = 1
    while cs * 2 <= MAX_CS and n * cs * 2 <= SLICE_FLOATS:
        cs *= 2
    return cs


def edge_reduce_bwd_slices(idx, a, amax, amin, cts):
    """Kernel 5's slices route in f32: ``da`` (B, N, Co)."""
    ct_max, ct_min, ct_sum, ct_sumsq = cts
    bsz, n, co = a.shape
    k = idx.shape[2]
    cs = slice_width(n)
    da = np.zeros_like(a)
    for b in range(bsz):
        for c0 in range(0, co, cs):
            ch = np.arange(c0, min(c0 + cs, co))
            sel = a[b][:, ch][idx[b]]                      # (N, k, CS)
            vmax, vmin = amax[b][:, ch], amin[b][:, ch]   # (N, CS)
            tmax = sel == vmax[:, None]
            tmin = sel == vmin[:, None]
            # each item's tie counts, t ascending (small integers: exact)
            gmax = ct_max[b][:, ch] / tmax.sum(1).astype(np.float32)
            gmin = ct_min[b][:, ch] / tmin.sum(1).astype(np.float32)
            gsq2 = np.float32(2) * ct_sumsq[b][:, ch]
            w = ((np.where(tmax, gmax[:, None], np.float32(0))
                  + np.where(tmin, gmin[:, None], np.float32(0)))
                 + ct_sum[b][:, ch][:, None]) + sel * gsq2[:, None]
            assert w.dtype == np.float32
            ds = np.zeros((n, len(ch)), np.float32)
            items = n * cs
            for q0 in range(0, items, THREADS):   # a round of the block
                q = np.arange(q0, min(q0 + THREADS, items))
                i, c = q // cs, q % cs
                keep = c < len(ch)
                i, c = i[keep], c[keep]
                for t in range(k):              # t ascending, items in order
                    np.add.at(ds, (idx[b, i, t], c), w[i, t, c])
            da[b][:, ch] = ds
    return da


def _bwd_case(kind: str, k: int, seed: int, b=2, n=128, co=64):
    """idx, a, amax, amin and four cotangents.  ``ints``: 32 grid points
    four times each and ``a`` a function of the point with values within
    +-256; the max/min cotangents multiples of the lcm of the tie counts,
    so that every tie split, addend and sum is exact."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        g = np.concatenate([rng.integers(-2, 3, (b, n // 4, 3))] * 4, 1)
        a = np.concatenate([rng.integers(-256, 257, (b, n // 4, co))] * 4, 1)
        cts = [rng.integers(-3, 4, (b, n, co)) for _ in range(4)]
    else:
        g = rng.standard_normal((b, n, 3))
        a = rng.standard_normal((b, n, co))
        cts = [rng.standard_normal((b, n, co)) for _ in range(4)]
    g, a = g.astype(np.float32), a.astype(np.float32)
    cts = [c.astype(np.float32) for c in cts]
    idx = _knn(g, k)
    sel = np.stack([a[i][idx[i]] for i in range(b)])     # (B, N, k, Co)
    amax, amin = sel.max(2), sel.min(2)
    if kind == "ints":
        ties = np.concatenate([(sel == amax[:, :, None]).sum(2).ravel(),
                               (sel == amin[:, :, None]).sum(2).ravel()])
        lcm = np.float32(math.lcm(*np.unique(ties).tolist()))
        cts[0], cts[1] = cts[0] * lcm, cts[1] * lcm
    return idx, a, amax, amin, cts


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", [1, 20, 40])
def test_edge_reduce_bwd_slices_match_plain_and_pallas(kind, k):
    from dgcnn_tpu.ops.pallas_knn import edge_reduce_bwd

    idx, a, amax, amin, cts = _bwd_case(kind, k, 80 + k)
    if kind == "ints" and k > 1:  # tied maxima and minima in the rows
        sel = np.stack([a[i][idx[i]] for i in range(a.shape[0])])
        assert (sel == amax[:, :, None]).sum(2).max() > 1
    got = edge_reduce_bwd_slices(idx, a, amax, amin, cts)
    assert np.isfinite(got).all()
    want = edge_reduce_bwd_plain(*(torch.from_numpy(v) for v in (
        idx, a, amax, amin, *cts))).numpy()
    _held(got, want, kind, "edge_reduce_bwd_plain")
    jwant = edge_reduce_bwd(*(jnp.asarray(v) for v in (
        idx, a, amax, amin, *cts)), k, exact=True, interpret=True)
    _held(got, np.asarray(jwant), kind, "pallas edge_reduce_bwd")


# ------------------------------------------------------------ kernel 7
def _fmaf(x, y, acc):
    """f32 fused multiply-add: the product is exact in float64, one
    rounding of the sum to f32 (a double rounding only where the float64
    sum is itself inexact)."""
    return (x.astype(np.float64) * y + acc).astype(np.float32)


def edge2_fwd_tiled(a1, b1, s1, t1, w2, idx, slope=0.2):
    """Kernel 7's tiled route in f32: (max, min, sum, sum of squares) over
    each row's k edges of z2, each (B, N, C2)."""
    bsz, n, c1 = a1.shape
    c2, k = w2.shape[1], idx.shape[2]
    r = min(8, 128 // k)
    rows = bsz * n
    b1r = b1.reshape(rows, c1)
    # a1 row of each edge: its cloud's offset plus the neighbour
    jrow = (np.arange(bsz)[:, None, None] * n + idx).reshape(rows, k)
    a1r = a1.reshape(rows, c1)
    outs = [np.empty((rows, c2), np.float32) for _ in range(4)]
    slope = np.float32(slope)
    for row0 in range(0, rows, r):
        tr = np.arange(row0, min(row0 + r, rows))      # whole rows
        z1 = (a1r[jrow[tr]] + b1r[tr][:, None]) * s1 + t1   # (R, k, C1)
        h1 = np.where(z1 >= 0, z1, slope * z1).reshape(-1, c1)
        z2 = np.zeros((h1.shape[0], c2), np.float32)
        for c in range(c1):                   # one chain, c1 ascending
            z2 = _fmaf(h1[:, c:c + 1], w2[c][None], z2)
        z2 = z2.reshape(len(tr), k, c2)
        mx = np.full((len(tr), c2), -np.inf, np.float32)
        mn = np.full((len(tr), c2), np.inf, np.float32)
        sm = np.zeros((len(tr), c2), np.float32)
        s2 = np.zeros((len(tr), c2), np.float32)
        for t in range(k):                    # each row's edges in t order
            z = z2[:, t]
            mx, mn = np.maximum(mx, z), np.minimum(mn, z)
            sm, s2 = sm + z, s2 + z * z
        for out, v in zip(outs, (mx, mn, sm, s2)):
            out[tr] = v
    return tuple(o.reshape(bsz, n, c2) for o in outs)


def _fwd_case(kind: str, k: int, seed: int, b=2, n=128, c1=64, c2=64):
    """a1, b1, s1, t1, w2 and idx.  ``ints``: small integers on a cloud of
    32 points four times each (z2 ties within rows, and the k-th and
    (k+1)-th scores tie), scales +-1 and 1/2: every product and sum
    exact."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        g = np.concatenate([rng.integers(-2, 3, (b, n // 4, 3))] * 4, 1)
        a1 = np.concatenate([rng.integers(-2, 3, (b, n // 4, c1))] * 4, 1)
        b1 = rng.integers(-2, 3, (b, n, c1))
        s1 = np.where(rng.random(c1) < 0.3, -0.5, 1.0)
        t1 = rng.integers(-2, 3, c1)
        w2 = rng.integers(-1, 2, (c1, c2))
    else:
        g = rng.standard_normal((b, n, 3))
        a1, b1 = rng.standard_normal((2, b, n, c1))
        s1 = np.where(rng.random(c1) < 0.2, -1.0, 1.0) * rng.uniform(
            0.5, 1.5, c1)
        t1 = 0.1 * rng.standard_normal(c1)
        w2 = rng.standard_normal((c1, c2)) / np.sqrt(c1)
    g = g.astype(np.float32)
    if kind == "ints":
        assert _ties_at_boundary(g, k)
    return [np.asarray(v, np.float32) for v in (a1, b1, s1, t1, w2)], _knn(
        g, k)


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", [6, 20, 40])
def test_edge2_fwd_tiles_match_plain_and_pallas(kind, k):
    """R = 8, 6 and 3 rows a tile; 256 rows leave a last tile that is not
    full at k = 20 and 40."""
    from dgcnn_tpu.ops.pallas_knn import _edge2_fwd_call

    slope = 0.25 if kind == "ints" else 0.2
    (a1, b1, s1, t1, w2), idx = _fwd_case(kind, k, 90 + k)
    got = edge2_fwd_tiled(a1, b1, s1, t1, w2, idx, slope)
    assert all(np.isfinite(v).all() for v in got)
    want = edge2_fwd_plain(*(torch.from_numpy(v) for v in (
        a1, b1, s1, t1, w2, idx)), slope)
    with jax.default_matmul_precision("float32"):
        jwant = _edge2_fwd_call(*(jnp.asarray(v) for v in (
            a1, b1, s1, t1, w2, idx)), k, slope, True, interpret=True)
    for name, gv, wv, jv in zip(("max", "min", "sum", "sumsq"), got, want,
                                jwant):
        _held(gv, wv.numpy(), kind, f"edge2_fwd_plain {name}")
        _held(gv, np.asarray(jv), kind, f"_edge2_fwd_call {name}")
