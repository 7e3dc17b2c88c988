"""The tiled routes of the banded kernels 12 and 13, on the CPU.

``csrc/edge_conv_eval.cu`` (kernel 12) and ``csrc/knn_edge2.cu`` (kernel
13) run, at k <= 64 (kernel 13 also at C1 <= 64 and C2 <= 128), the tiled
selection of ``csrc/knn_select.cuh`` (tiled_topk) over each query tile's
window of the PC1-sorted cloud: a block's 64 query rows all lie in one
query tile of ``band_tile`` rows, so they share the window of ``band``
sorted rows from ``band_starts``.  Its columns stream past them in tiles
of 128: first the tile that holds the block's own query rows (sorted into
the lists), then the others in ascending order, each column admitted and
placed by (score desc, window position asc), the list order; each list
holds rows of the sorted cloud (start + window position).
``window_topk`` emulates that admission on the plain version's window
scores, and ``windowed_lists`` must give the indices of
``banded_knn_plain`` (lowest window position first among equal scores),
on random clouds and on integer clouds of duplicate points whose k-th
boundary falls inside ties within a window; so must the ascending stream
of the exact kernels (``test_torch_reduce_tiled.streaming_topk``) over
the same windows.  Fed those lists, kernels 1 and 6's tiled consumers
(``edge_conv_eval_tiled``, ``knn_edge2_tiled``; unchanged on the banded
route) must give ``banded_*_plain`` and the JAX package's Pallas
``banded_edge_conv_eval`` / ``banded_knn_edge2`` in interpret mode, exact
f32 selection: exactly on integer clouds, within rel 1e-5 on random ones.

The window starts are built on the tensors' device (``window_starts``):
they must equal ``band_starts`` and no banded call may copy them from the
host.  The ``cuda``-marked tests hold the card's tiled routes bit-equal to
the row-warp routes (``rowwarp=True``) and, at band = N in the identity
order, to the exact kernels 1 and 6; they skip without a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.ops import (
    edge_conv_eval,
    knn_edge2,
    pairwise_neg_sqdist,
)
from dgcnn_tpu_torch.ops.banded import (
    band_starts,
    band_tile,
    banded_edge_conv_eval,
    banded_edge_conv_eval_plain,
    banded_knn_edge2,
    banded_knn_edge2_plain,
    banded_knn_plain,
    inverse_order,
    sort_rows,
    sorted_order,
    window_starts,
)
from test_torch_reduce_tiled import (
    edge_conv_eval_tiled,
    knn_edge2_tiled,
    streaming_topk,
)

KS = [1, 20, 32, 40]
# (N, band): one window a tile (tile = band), and windows of 384 rows over
# tiles of 256 that overlap and start off the tile grid (0 and 128)
GEOMETRIES = [(256, 128), (512, 256), (512, 384)]


def window_topk(scores: np.ndarray, k: int, first: int) -> np.ndarray:
    """(64, W) f32 window scores of one block's query rows -> (64, k)
    window positions by the banded selection's admission: column tile
    ``first`` (of 128) sorted into each list by (score desc, position asc),
    then the other tiles in ascending order, a column entering when it
    comes before the k-th entry in that order, after every entry that comes
    before it."""
    m, w = scores.shape
    tj = 128
    cols = np.arange(first * tj, first * tj + tj)
    top = np.argsort(-scores[:, cols], axis=1, kind="stable")[:, :k]
    li = cols[top]
    ls = np.take_along_axis(scores, li, 1)
    slot = np.arange(k)
    for t in [t for t in range(w // tj) if t != first]:
        for j in range(t * tj, t * tj + tj):
            s = scores[:, j]
            admit = (s > ls[:, -1]) | ((s == ls[:, -1]) & (j < li[:, -1]))
            ahead = ((ls > s[:, None])
                     | ((ls == s[:, None]) & (li < j))).sum(1)[:, None]
            new_s = np.where(slot < ahead, ls, np.where(
                slot == ahead, s[:, None], np.roll(ls, 1, axis=1)))
            new_i = np.where(slot < ahead, li, np.where(
                slot == ahead, j, np.roll(li, 1, axis=1)))
            ls = np.where(admit[:, None], new_s, ls)
            li = np.where(admit[:, None], new_i, li)
    return li


def _window_scores(gs: np.ndarray, band: int):
    """The plain version's window scores of the sorted cloud ``gs`` (B, N,
    C): one batched product over the (B * T, band, C) windows -> (B, T,
    tile, band), the tile and the window starts."""
    b, n, c = gs.shape
    tile = band_tile(n, band)
    starts = band_starts(n, tile, band)
    t = n // tile
    cols = (starts[:, None] + np.arange(band)).reshape(-1)
    g = torch.from_numpy(gs)
    scores = pairwise_neg_sqdist(g.reshape(b * t, tile, c),
                                 g[:, cols].reshape(b * t, band, c)).numpy()
    return scores.reshape(b, t, tile, band), tile, starts


def windowed_lists(gs: np.ndarray, k: int, band: int,
                   ascending: bool = False) -> np.ndarray:
    """(B, N, k) rows of the sorted cloud ``gs`` (B, N, C) picked by the
    tiled selection over each query tile's window, blocks of 64 query rows
    (``ascending``: the exact kernels' stream, tiles in ascending order),
    each list shifted by the window's start."""
    scores, tile, starts = _window_scores(gs, band)
    b, t = scores.shape[:2]
    lists = np.empty((b, t, tile, k), np.int64)
    for bi in range(b):
        for ti, start in enumerate(starts):
            for r in range(0, tile, 64):
                sc = scores[bi, ti, r:r + 64]
                lists[bi, ti, r:r + 64] = start + (
                    streaming_topk(sc, k, 64, 128) if ascending else
                    window_topk(sc, k, (ti * tile + r - start) // 128))
    return lists.reshape(b, -1, k)


def _cloud(kind: str, seed: int, b: int = 2, n: int = 256, c: int = 3):
    """Points spread along channel 0, so that the two frameworks' PC1 keys
    sort the same way: a permuted grid of spacing 6 / N with noise of 0.3
    elsewhere, or (``ints``) N / 4 integer points, ch0 a permutation of 0 ..
    N / 4 - 1 and the others in {-1, 0, 1}, each four times: duplicates
    and equal distances put the k-th boundary inside ties."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        m = n // 4
        base = rng.integers(-1, 2, (b, m, c)).astype(np.float32)
        base[:, :, 0] = np.stack([rng.permutation(m) for _ in range(b)])
        return np.concatenate([base] * 4, axis=1)
    g = 0.3 * rng.standard_normal((b, n, c))
    g[:, :, 0] = np.stack([rng.permutation(np.linspace(-3, 3, n))
                           for _ in range(b)])
    return g.astype(np.float32)


def _window_ties(gs: np.ndarray, k: int, band: int) -> int:
    """Rows whose k-th and (k+1)-th best window scores are equal."""
    top = -np.sort(-_window_scores(gs, band)[0], axis=-1)
    return int((top[..., k - 1] == top[..., k]).sum())


def _sorted(g: np.ndarray) -> tuple[torch.Tensor, np.ndarray]:
    order = sorted_order(torch.from_numpy(g))
    return order, sort_rows(torch.from_numpy(g), order).numpy()


def _jax_order(g: np.ndarray) -> np.ndarray:
    from dgcnn_tpu.ops.pallas_banded import pc1_key

    with jax.default_matmul_precision("float32"):
        return np.argsort(np.asarray(pc1_key(jnp.asarray(g))), 1,
                          kind="stable")


def test_window_starts_built_on_the_device_equal_band_starts(monkeypatch):
    """window_starts (arange and clamp on the tensors' device) equals
    band_starts at every geometry the models and tests use, and the banded
    plain versions build their windows without a host copy."""
    for n, band in GEOMETRIES + [(1024, 256), (2048, 512), (4096, 1024),
                                 (640, 384), (2048, 2048), (4096, 4096)]:
        tile = band_tile(n, band)
        got = window_starts(n, tile, band, torch.device("cpu"))
        assert got.dtype == torch.int32 and got.shape == (n // tile,)
        np.testing.assert_array_equal(got.numpy(),
                                      band_starts(n, tile, band))
        # built once: every call hands back the same tensor
        assert window_starts(n, tile, band, torch.device("cpu")) is got

    def no_host_copy(*args, **kwargs):
        raise AssertionError("a banded call copied from a host array")

    g = torch.from_numpy(_cloud("random", 3))
    want = banded_knn_plain(g, 20, 128)
    monkeypatch.setattr(torch, "from_numpy", no_host_copy)
    assert torch.equal(banded_knn_plain(g, 20, 128), want)


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n,band", GEOMETRIES)
def test_windowed_topk_is_index_exact(kind, k, n, band):
    """The tiled selection over each query tile's window, its own tile
    first, shifted by the window's start, gives banded_knn_plain's
    indices, ties included; so does the ascending stream."""
    _, gs = _sorted(_cloud(kind, 100 + n + band + k, n=n))
    if kind == "ints":  # the k-th boundary falls inside ties in a window
        assert _window_ties(gs, k, band) > 0
    want = banded_knn_plain(torch.from_numpy(gs), k, band).numpy()
    np.testing.assert_array_equal(windowed_lists(gs, k, band), want)
    np.testing.assert_array_equal(
        windowed_lists(gs, k, band, ascending=True), want)


def _weights(kind: str, seed: int, b: int, n: int, c_in=8, co=64, c1=64,
             c2=64):
    """The inputs of kernels 12 and 13 beside the graph: small integers
    (scales 2, -1, 1/2, 1 and +-1, -1/2: every product and sum exact) or
    random normals."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        def draw(*shape, lo=-2, hi=3):
            return rng.integers(lo, hi, shape).astype(np.float32)
        s_ = np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), co // 4)
        k12 = (draw(b, n, c_in), draw(c_in, co), draw(c_in, co), s_,
               draw(co))
        s1 = np.where(draw(c1) >= 0, 1.0, -0.5).astype(np.float32)
        s2 = np.where(draw(c2) >= 0, 1.0, -1.0).astype(np.float32)
        k13 = (draw(b, n, c1), draw(b, n, c1), s1, draw(c1),
               draw(c1, c2, lo=-1, hi=2), s2, draw(c2))
        return k12, k13

    def draw(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def affine(c):
        sign = np.where(rng.random(c) < 0.2, -1.0, 1.0)
        return (sign * rng.uniform(0.5, 1.5, c)).astype(np.float32)

    k12 = (draw(b, n, c_in), draw(c_in, co, scale=c_in ** -0.5),
           draw(c_in, co, scale=c_in ** -0.5), affine(co),
           draw(co, scale=0.1))
    k13 = (draw(b, n, c1), draw(b, n, c1), affine(c1), draw(c1, scale=0.1),
           draw(c1, c2, scale=c1 ** -0.5), affine(c2), draw(c2, scale=0.1))
    return k12, k13


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _held(got, want, kind, name):
    if kind == "ints":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert _rel(got, want) <= 1e-5, (name, _rel(got, want))


def _unsort(out_sorted: np.ndarray, order: torch.Tensor) -> np.ndarray:
    return sort_rows(torch.from_numpy(out_sorted),
                     inverse_order(order)).numpy()


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n,band", [(256, 128), (512, 384)])
def test_banded_edge_conv_eval_tiled_consumer(monkeypatch, kind, k, n,
                                              band):
    """Kernel 1's tiled consumer on the windowed lists against
    banded_edge_conv_eval_plain and the Pallas banded_edge_conv_eval."""
    from dgcnn_tpu.ops.pallas_banded import banded_edge_conv_eval as jfn

    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    g = _cloud(kind, 200 + n + k, n=n)
    (x, wn, wc, sc, bi), _ = _weights(kind, 201 + k, g.shape[0], n)
    order, gs = _sorted(g)
    np.testing.assert_array_equal(order.numpy(), _jax_order(g))
    xs = sort_rows(torch.from_numpy(x), order).numpy()
    got = _unsort(edge_conv_eval_tiled(windowed_lists(gs, k, band), xs, wn,
                                       wc, sc, bi), order)
    assert np.isfinite(got).all()
    args = (g, x, wn, wc, sc, bi)
    want = banded_edge_conv_eval_plain(*(torch.from_numpy(v) for v in args),
                                       k, band, order=order).numpy()
    _held(got, want, kind, "banded_edge_conv_eval_plain")
    with jax.default_matmul_precision("float32"):
        jwant = jfn.__wrapped__(*(jnp.asarray(v) for v in args), k, band,
                                select_dtype=jnp.float32, interpret=True)
    _held(got, np.asarray(jwant), kind, "pallas banded_edge_conv_eval")


@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n,band", [(256, 128), (512, 384)])
def test_banded_knn_edge2_tiled_consumer(monkeypatch, kind, k, n, band):
    """Kernel 6's tiled consumer on the windowed lists against
    banded_knn_edge2_plain and the Pallas banded_knn_edge2 (exact mode);
    C2 = 128 (the TransformNet's width) at k = 32 and 40."""
    from dgcnn_tpu.ops.pallas_banded import banded_knn_edge2 as jfn

    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    c2 = 128 if k in (32, 40) else 64
    g = _cloud(kind, 300 + n + k, n=n)
    _, k13 = _weights(kind, 301 + k, g.shape[0], n, c2=c2)
    slope = 0.25 if kind == "ints" else 0.2
    order, gs = _sorted(g)
    np.testing.assert_array_equal(order.numpy(), _jax_order(g))
    a1s, b1s = (sort_rows(torch.from_numpy(v), order).numpy()
                for v in k13[:2])
    got = _unsort(knn_edge2_tiled(windowed_lists(gs, k, band), a1s, b1s,
                                  *k13[2:], slope), order)
    assert got.shape == (g.shape[0], n, c2) and np.isfinite(got).all()
    args = (g, *k13)
    want = banded_knn_edge2_plain(*(torch.from_numpy(v) for v in args), k,
                                  band, slope, order=order).numpy()
    _held(got, want, kind, "banded_knn_edge2_plain")
    with jax.default_matmul_precision("float32"):
        jwant = jfn.__wrapped__(*(jnp.asarray(v) for v in args), k, band,
                                slope, interpret=True)
    _held(got, np.asarray(jwant), kind, "pallas banded_knn_edge2")


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ints", "random"])
@pytest.mark.parametrize("n,band,k", [(2048, 512, 40), (4096, 1024, 20),
                                      (512, 384, 32)])
def test_banded_tiled_routes_bit_equal_to_row_warp(cuda_device, kind, n,
                                                   band, k):
    """Kernels 12 and 13 on their tiled routes give the bits of their
    row-warp routes (``rowwarp=True``) on one shared order."""
    g = _cloud(kind, 400 + n, n=n)
    k12, k13 = _weights(kind, 401 + n, g.shape[0], n)
    dev = cuda_device
    graph = torch.from_numpy(g).to(dev)
    order = sorted_order(graph)
    a12 = [torch.from_numpy(v).to(dev) for v in k12]
    a13 = [torch.from_numpy(v).to(dev) for v in k13]
    slope = 0.25 if kind == "ints" else 0.2
    for fn, args in ((banded_edge_conv_eval, a12), (banded_knn_edge2, a13)):
        got = fn(graph, *args, k, band, slope, order=order)
        want = fn(graph, *args, k, band, slope, order=order, rowwarp=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__
        if kind == "ints":  # exact arithmetic: the plain version's bits
            plain = (banded_edge_conv_eval_plain if fn is
                     banded_edge_conv_eval else banded_knn_edge2_plain)
            assert torch.equal(got, plain(graph, *args, k, band, slope,
                                          order=order)), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ints", "random"])
def test_banded_tiled_routes_at_band_n_are_the_exact_kernels(cuda_device,
                                                             kind):
    """At band = N in the identity order the banded tiled routes are the
    exact kernels 1 and 6, bit for bit."""
    n, k = 1024, 20
    g = _cloud(kind, 500, n=n)
    k12, k13 = _weights(kind, 501, g.shape[0], n)
    dev = cuda_device
    graph = torch.from_numpy(g).to(dev)
    ident = torch.arange(n, device=dev).repeat(g.shape[0], 1)
    a12 = [torch.from_numpy(v).to(dev) for v in k12]
    a13 = [torch.from_numpy(v).to(dev) for v in k13]
    got = banded_edge_conv_eval(graph, *a12, k, n, order=ident)
    assert torch.equal(got, edge_conv_eval(graph, *a12, k))
    got = banded_knn_edge2(graph, *a13, k, n, order=ident)
    assert torch.equal(got, knn_edge2(graph, *a13, k))
