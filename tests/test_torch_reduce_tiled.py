"""The arithmetic of the tiled designs of kernels 3 and 8, on the CPU.

``csrc/knn_reduce.cu`` (at k <= 64) selects each query row's k neighbours
by streaming the cloud in column tiles, ascending, past a running top-k
(``csrc/knn_select.cuh``, tiled_topk): the first k columns fill the list,
and after that a column enters only with a score strictly greater than the
k-th, after every entry whose score is >= its own.  ``streaming_topk``
below emulates that admission over blocks of R query rows and tiles of TJ
columns, on the same scores, and must give the indices of
``knn_reduce_plain`` (a stable descending sort) and of the JAX package's
``fused_knn_reduce`` in Pallas interpret mode, exact f32 selection, on
integer clouds full of duplicate points and on random ones.

``csrc/edge2_bwd.cu`` (at C1, C2 <= 64, k <= 128) sums dW2, ds1 and dt1 in
another order than the row-warp form: a tile is R = min(8, 128 // k)
whole rows, a block walks the tiles g, g + G, ..., each thread adds its
edges' products into registers, and the blocks' partials are added in
block order.  ``edge2_bwd_partitioned`` emulates that partition in f32
and must land within rel 1e-5 of ``edge2_bwd_plain`` and of the Pallas
``_edge2_bwd_call`` in interpret mode; db1 sums each row's edges in t
order, as the row-warp form does.  The card's own run of both kernels is
held by ``chip_smoke.py`` (phases 8, 12, 13 and 18),
``dgcnn_tpu_torch/tools/reduce_ab.py`` and the ``cuda``-marked tests of
``tests/test_torch_port_ops.py``.

``csrc/edge_conv_eval.cu`` (kernel 1) and ``csrc/knn_edge2.cu`` (kernel 6)
run the same selection at k <= 64 and then consume each row's list:
``edge_conv_eval_tiled`` folds the members' rows of ``a`` into max and
min in list order, adds c_i and applies the affine and the LeakyReLU;
``knn_edge2_tiled`` walks each block's rows in tiles of R = min(8, 128 //
k) whole rows, forms every edge's h1, z2 and h2 (the affine and the
LeakyReLU before the max, since s2 may be negative) and takes each row's
max.  Fed ``streaming_topk``'s lists, both must give ``edge_conv_eval_plain``
/ ``knn_edge2_plain`` and the Pallas ``fused_edge_conv_eval`` /
``fused_knn_edge2`` in interpret mode, exact f32 selection: exactly on
integer clouds, within rel 1e-5 on random ones.  ``chip_smoke.py``
(phases 3, 12, 13, 18 and 27) and ``reduce_ab --kernel edge_conv_eval |
knn_edge2`` hold the card's tiled kernels bit-equal to the row-warp form.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.ops import (
    edge2_bwd_plain,
    edge2_fwd_plain,
    edge2_z2,
    edge_conv_eval_plain,
    knn_edge2_plain,
    knn_reduce_plain,
    pairwise_neg_sqdist,
)

# (R query rows a block, TJ columns a tile): the kernel's (64, 128) and
# others, down to tiles shorter than k
TILE_SHAPES = [(64, 128), (32, 32), (128, 64), (16, 48)]


def streaming_topk(scores: np.ndarray, k: int, r: int,
                   tj: int) -> np.ndarray:
    """(rows, N) f32 scores -> (rows, k) indices by the tiled selection's
    admission: blocks of ``r`` rows, columns in tiles of ``tj``, ascending;
    each row's list sorted by (score desc, index asc).  The first tile is
    sorted into the list (the kernel's bitonic fill); while the list holds
    fewer than k entries every column enters, then only a score strictly
    greater than the k-th."""
    rows, n = scores.shape
    out = np.empty((rows, k), np.int64)
    slot = np.arange(k)
    for r0 in range(0, rows, r):
        blk = scores[r0:r0 + r]
        m = blk.shape[0]
        ls = np.full((m, k), -np.inf, np.float32)
        li = np.zeros((m, k), np.int64)
        first = min(tj, n)
        order = np.argsort(-blk[:, :first], axis=1, kind="stable")[:, :k]
        cnt = order.shape[1]
        ls[:, :cnt] = np.take_along_axis(blk[:, :first], order, 1)
        li[:, :cnt] = order
        for j0 in range(first, n, tj):
            for j in range(j0, min(j0 + tj, n)):
                s = blk[:, j]
                admit = np.ones(m, bool) if cnt < k else s > ls[:, k - 1]
                ahead = ((ls >= s[:, None]) & (slot < cnt)).sum(1)
                pos = ahead[:, None]
                new_s = np.where(slot < pos, ls, np.where(
                    slot == pos, s[:, None], np.roll(ls, 1, axis=1)))
                new_i = np.where(slot < pos, li, np.where(
                    slot == pos, j, np.roll(li, 1, axis=1)))
                ls = np.where(admit[:, None], new_s, ls)
                li = np.where(admit[:, None], new_i, li)
                cnt = min(cnt + 1, k)
        out[r0:r0 + m] = li
    return out


def _cloud(kind: str, seed: int, b: int = 2, n: int = 128, c: int = 3):
    rng = np.random.default_rng(seed)
    if kind == "ints":  # 27 distinct points at most: ties in every row
        return rng.integers(-1, 2, (b, n, c)).astype(np.float32)
    return rng.standard_normal((b, n, c)).astype(np.float32)


_PALLAS = {}


def _pallas_idx(kind: str, k: int, g: np.ndarray, a: np.ndarray):
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    if (kind, k) not in _PALLAS:
        out = fused_knn_reduce(jnp.asarray(g), jnp.asarray(a), k,
                               select_dtype=jnp.float32, with_sumsq=True,
                               interpret=True)
        _PALLAS[kind, k] = np.asarray(out[0])
    return _PALLAS[kind, k]


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", [1, 20, 40, "N"])
def test_streaming_topk_is_index_exact(monkeypatch, kind, k):
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    g = _cloud(kind, 7)
    b, n, _ = g.shape
    k = n if k == "N" else k
    a = np.random.default_rng(8).standard_normal((b, n, 16)).astype(
        np.float32)
    want = knn_reduce_plain(torch.from_numpy(g), torch.from_numpy(a),
                            k)[0].numpy()
    np.testing.assert_array_equal(want, _pallas_idx(kind, k, g, a))
    scores = pairwise_neg_sqdist(torch.from_numpy(g)).numpy()
    if kind == "ints":  # the boundary of the k nearest falls inside ties
        kth = np.take_along_axis(scores, want[..., -1:], -1)
        assert k == n or (scores == kth).sum(-1).max() > 1
    for r, tj in TILE_SHAPES:
        got = np.stack([streaming_topk(scores[i], k, r, tj)
                        for i in range(b)])
        np.testing.assert_array_equal(got, want, err_msg=f"R={r} TJ={tj}")


def _edge2_case(seed, b=2, n=128, c1=64, c2=64, k=20, dup=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n // 4 if dup else n, 3))
    a1 = rng.standard_normal((b, n // 4 if dup else n, c1))
    if dup:  # every point four times: tied distances and tied z2
        g, a1 = np.concatenate([g] * 4, 1), np.concatenate([a1] * 4, 1)
    b1 = rng.standard_normal((b, n, c1))
    s1 = np.where(rng.random(c1) < 0.2, -1.0, 1.0) * rng.uniform(0.5, 1.5,
                                                                 c1)
    t1 = 0.1 * rng.standard_normal(c1)
    w2 = rng.standard_normal((c1, c2)) / np.sqrt(c1)
    cts = [rng.standard_normal((b, n, c2)) for _ in range(4)]
    f32 = [np.asarray(v, np.float32) for v in (g, a1, b1, s1, t1, w2, *cts)]
    idx = np.argsort(-pairwise_neg_sqdist(torch.from_numpy(f32[0])).numpy(),
                     axis=-1, kind="stable")[..., :k].astype(np.int32)
    return f32[1:6], idx, f32[6:]


def edge2_bwd_partitioned(a1, b1, s1, t1, w2, idx, cts, slope=0.2,
                          blocks=3):
    """(da1, db1, ds1, dt1, dw2) of kernel 8's tiled route, summed as it
    sums them: tiles of R whole rows, block g walking tiles g, g + G, ...;
    a thread (tx, ty) of 16 x 16 adds dW2 entries (4 ty + i, 4 tx + j)
    over its tiles' edges ascending, and ds1 / dt1 of channels 4 tx + i
    over edges ty + 16 m; the 16 ty partials, then the G block partials,
    added in ascending order.  f32 throughout (each product rounded,
    without the card's fused multiply-add); the tie tests compare z2 with
    its own max and min, as the kernel compares its z2 with the forward's,
    which are the same bits."""
    t = [torch.from_numpy(v) for v in (a1, b1, s1, t1, w2)]
    a1t, b1t, s1t, t1t, w2t = t
    bsz, n, c1 = a1.shape
    k = idx.shape[2]
    idxt = torch.from_numpy(idx).long()
    sel = torch.stack([a1t[i][idxt[i]] for i in range(bsz)]) + b1t[:, :, None]
    z1 = sel * s1t + t1t
    h1 = torch.where(z1 >= 0, z1, slope * z1)
    z2 = h1 @ w2t
    ct_max, ct_min, ct_sum, ct_sumsq = (torch.from_numpy(c) for c in cts)
    tmax = z2 == z2.amax(2, keepdim=True)
    tmin = z2 == z2.amin(2, keepdim=True)
    gmax = ct_max / tmax.sum(2).float()
    gmin = ct_min / tmin.sum(2).float()
    dz2 = ((torch.where(tmax, gmax[:, :, None], 0.)
            + torch.where(tmin, gmin[:, :, None], 0.))
           + ct_sum[:, :, None]) + z2 * (2 * ct_sumsq)[:, :, None]
    dh1 = dz2 @ w2t.T
    dz1 = torch.where(z1 >= 0, dh1, dh1 * slope)
    dsel = dz1 * s1t
    db1 = torch.zeros_like(b1t)
    for tt in range(k):  # each row's edges in t order
        db1 = db1 + dsel[:, :, tt]
    da1 = torch.zeros_like(a1t)
    for i in range(bsz):
        da1[i].index_add_(0, idxt[i].reshape(-1), dsel[i].reshape(-1, c1))

    rows = bsz * n
    r = min(8, 128 // k)
    tiles = -(-rows // r)
    h1e, dz2e = h1.reshape(rows * k, c1), dz2.reshape(rows * k, -1)
    dz1e, sele = dz1.reshape(rows * k, c1), sel.reshape(rows * k, c1)
    dw2 = torch.zeros(w2.shape)
    ds1 = torch.zeros(c1)
    dt1 = torch.zeros(c1)
    for g in range(blocks):
        pw = torch.zeros(w2.shape)
        ds_ty = torch.zeros((16, c1))
        dt_ty = torch.zeros((16, c1))
        for tile in range(g, tiles, blocks):
            e0 = tile * r * k
            e1 = min(e0 + r * k, rows * k)
            for e in range(e0, e1):
                pw = pw + torch.outer(h1e[e], dz2e[e])
                ty = (e - e0) % 16
                ds_ty[ty] = ds_ty[ty] + dz1e[e] * sele[e]
                dt_ty[ty] = dt_ty[ty] + dz1e[e]
        ds_blk, dt_blk = torch.zeros(c1), torch.zeros(c1)
        for ty in range(16):
            ds_blk, dt_blk = ds_blk + ds_ty[ty], dt_blk + dt_ty[ty]
        dw2, ds1, dt1 = dw2 + pw, ds1 + ds_blk, dt1 + dt_blk
    return da1, db1, ds1, dt1, dw2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("k,dup", [(20, False), (40, False), (20, True),
                                   (6, False)])
def test_edge2_bwd_partition_matches_plain_and_pallas(k, dup):
    from dgcnn_tpu.ops.pallas_knn import _edge2_bwd_call, _edge2_fwd_call

    (a1, b1, s1, t1, w2), idx, cts = _edge2_case(50 + k, k=k, dup=dup)
    tin = [torch.from_numpy(v) for v in (a1, b1, s1, t1, w2)]
    idxt = torch.from_numpy(idx)
    amax, amin, _, _ = edge2_fwd_plain(*tin, idxt)
    if dup:  # the copies' equal z2 tie for the max in every row
        z2 = edge2_z2(*tin, idxt)
        assert (z2 == z2.amax(2, keepdim=True)).sum(2).min() >= 2
    got = edge2_bwd_partitioned(a1, b1, s1, t1, w2, idx, cts)
    want = edge2_bwd_plain(*tin, idxt, amax, amin,
                           *(torch.from_numpy(c) for c in cts))
    jin = [jnp.asarray(v) for v in (a1, b1, s1, t1, w2, idx)]
    with jax.default_matmul_precision("float32"):
        jfwd = _edge2_fwd_call(*jin, k, 0.2, True, interpret=True)
        jwant = _edge2_bwd_call(*jin, jfwd[0], jfwd[1],
                                *(jnp.asarray(c) for c in cts), k, 0.2,
                                True, interpret=True)
    for name, gv, wv, jv in zip(("da1", "db1", "ds1", "dt1", "dw2"), got,
                                want, jwant):
        assert np.isfinite(gv.numpy()).all(), name
        assert _rel(gv, wv) <= 1e-5, (name, _rel(gv, wv))
        assert _rel(gv, jv) <= 1e-5, (name, _rel(gv, jv))


# ------------------------------------------------- kernels 1 and 6, tiled
EVAL_N = 256
EVAL_KS = [1, 20, 32, 40, "N"]


def _tiled_lists(g: np.ndarray, k: int) -> np.ndarray:
    """(B, N, k) neighbour lists of the tiled selection (the kernel's 64
    rows a block, 128 columns a tile)."""
    scores = pairwise_neg_sqdist(torch.from_numpy(g)).numpy()
    return np.stack([streaming_topk(sc, k, 64, 128) for sc in scores])


def _lrelu(v, slope):
    return np.where(v >= 0, v, np.float32(slope) * v).astype(np.float32)


def edge_conv_eval_tiled(lists, x, w_nbr, w_ctr, scale, bias, slope=0.2):
    """Kernel 1's tiled consumer in f32: each row's members' rows of a =
    x w_nbr folded into max and min in list order, then (scale > 0 ? max
    : min) + c_i, the affine and the LeakyReLU."""
    a = (x @ w_nbr).astype(np.float32)
    c = (x @ w_ctr).astype(np.float32)
    out = np.empty(c.shape, np.float32)
    for bi in range(lists.shape[0]):
        mx = np.full(c.shape[1:], -np.inf, np.float32)
        mn = np.full(c.shape[1:], np.inf, np.float32)
        for t in range(lists.shape[2]):  # list order
            rows = a[bi][lists[bi, :, t]]
            mx, mn = np.maximum(mx, rows), np.minimum(mn, rows)
        sel = np.where(scale > 0, mx, mn) + c[bi]
        out[bi] = _lrelu(sel * scale + bias, slope)
    return out


def knn_edge2_tiled(lists, a1, b1, s1, t1, w2, s2, t2, slope=0.2):
    """Kernel 6's tiled consumer in f32: the rows of each 64-row block in
    tiles of R = min(8, 128 // k) whole rows (one row where k > 128, the
    row-warp form's unit); per edge of a tile h1 = LReLU((a1[j] + b1[i])
    s1 + t1), z2 = h1 w2, h2 = LReLU(z2 s2 + t2); each row's max over its
    k edges, after the affine."""
    bsz, n, k = lists.shape
    r = max(1, min(8, 128 // k))
    out = np.empty((bsz, n, w2.shape[1]), np.float32)
    for bi in range(bsz):
        for r0 in range(0, n, 64):
            for rt in range(r0, r0 + 64, r):
                rows = np.arange(rt, min(rt + r, r0 + 64))
                j = lists[bi, rows]                       # (R, k)
                h1 = _lrelu((a1[bi][j] + b1[bi][rows][:, None]) * s1 + t1,
                            slope)
                z2 = (h1.reshape(-1, h1.shape[-1]) @ w2).astype(np.float32)
                h2 = _lrelu(z2 * s2 + t2, slope).reshape(len(rows), k, -1)
                out[bi, rows] = h2.max(1)
    return out


def _eval_case(kind: str, k, seed: int, c_in=8, co=64, c1=64, c2=64):
    """A cloud of EVAL_N points and the weights of kernels 1 and 6: small
    integers (scales 2, -1, 1/2, 1 and +-1, -1/2; every product and sum
    exact) on a cloud of at most 27 distinct points, or random normals."""
    rng = np.random.default_rng(seed)
    g = _cloud(kind, seed, n=EVAL_N)
    b, n, _ = g.shape
    k = n if k == "N" else k
    if kind == "ints":
        def draw(*shape, lo=-2, hi=3):
            return rng.integers(lo, hi, shape).astype(np.float32)
        s_ = np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), co // 4)
        k1 = (draw(b, n, c_in), draw(c_in, co), draw(c_in, co), s_, draw(co))
        s1 = np.where(draw(c1) >= 0, 1.0, -0.5).astype(np.float32)
        s2 = np.where(draw(c2) >= 0, 1.0, -1.0).astype(np.float32)
        k6 = (draw(b, n, c1), draw(b, n, c1), s1, draw(c1),
              draw(c1, c2, lo=-1, hi=2), s2, draw(c2))
    else:
        def draw(*shape, scale=1.0):
            return (scale * rng.standard_normal(shape)).astype(np.float32)

        def affine(c):
            sign = np.where(rng.random(c) < 0.2, -1.0, 1.0)
            return (sign * rng.uniform(0.5, 1.5, c)).astype(np.float32)

        k1 = (draw(b, n, c_in), draw(c_in, co, scale=c_in ** -0.5),
              draw(c_in, co, scale=c_in ** -0.5), affine(co),
              draw(co, scale=0.1))
        k6 = (draw(b, n, c1), draw(b, n, c1), affine(c1),
              draw(c1, scale=0.1), draw(c1, c2, scale=c1 ** -0.5),
              affine(c2), draw(c2, scale=0.1))
    return g, k, k1, k6


def _ties_at_boundary(g: np.ndarray, k: int) -> bool:
    """Whether some row's k-th and (k+1)-th best scores are equal."""
    scores = -np.sort(-pairwise_neg_sqdist(torch.from_numpy(g)).numpy(), -1)
    return bool((scores[..., k - 1] == scores[..., k]).any())


def _held(got, want, kind, name):
    if kind == "ints":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert _rel(got, want) <= 1e-5, (name, _rel(got, want))


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", EVAL_KS)
def test_edge_conv_eval_tiled_consumer(monkeypatch, kind, k):
    """Kernel 1's tiled consumer on the streaming lists against
    edge_conv_eval_plain and the Pallas fused_edge_conv_eval."""
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    g, k, (x, wn, wc, sc, bi), _ = _eval_case(kind, k, 70)
    assert kind == "random" or k == g.shape[1] or _ties_at_boundary(g, k)
    got = edge_conv_eval_tiled(_tiled_lists(g, k), x, wn, wc, sc, bi)
    assert np.isfinite(got).all()
    want = edge_conv_eval_plain(*(torch.from_numpy(v)
                                  for v in (g, x, wn, wc, sc, bi)), k).numpy()
    _held(got, want, kind, "edge_conv_eval_plain")
    with jax.default_matmul_precision("float32"):
        jwant = fused_edge_conv_eval.__wrapped__(
            *(jnp.asarray(v) for v in (g, x, wn, wc, sc, bi)), k,
            select_dtype=jnp.float32, interpret=True)
    _held(got, np.asarray(jwant), kind, "fused_edge_conv_eval")


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", EVAL_KS)
def test_knn_edge2_tiled_consumer(monkeypatch, kind, k):
    """Kernel 6's tiled consumer on the streaming lists against
    knn_edge2_plain and the Pallas fused_knn_edge2; C2 = 128 (the
    TransformNet's) at k = 32 and 40."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_edge2

    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    c2 = 128 if k in (32, 40) else 64
    g, k, _, args = _eval_case(kind, k, 71, c2=c2)
    assert kind == "random" or k == g.shape[1] or _ties_at_boundary(g, k)
    slope = 0.25 if kind == "ints" else 0.2
    got = knn_edge2_tiled(_tiled_lists(g, k), *args, slope)
    assert got.shape == (g.shape[0], g.shape[1], c2)
    assert np.isfinite(got).all()
    want = knn_edge2_plain(*(torch.from_numpy(v) for v in (g, *args)), k,
                           slope).numpy()
    _held(got, want, kind, "knn_edge2_plain")
    with jax.default_matmul_precision("float32"):
        jwant = fused_knn_edge2.__wrapped__(
            *(jnp.asarray(v) for v in (g, *args)), k, slope, interpret=True)
    _held(got, np.asarray(jwant), kind, "fused_knn_edge2")
