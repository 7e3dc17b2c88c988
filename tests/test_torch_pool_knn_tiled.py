"""The arithmetic of the redesigned kernels 2 and 11, on the CPU.

``csrc/conv_pool.cu`` (kernel 2) splits each cloud's points into row
groups of ``per`` consecutive 128-row tiles.  A thread of a block folds
rows 4 ty + i and 64 + 4 ty + i (i < 4) of each of its group's tiles, in
tile order and then i order, into a running column max and f32 sum; the
block folds its 16 thread rows in order, and the groups' partial rows are
added in group order before the sum is divided by N.  ``pool_partitioned``
emulates that partition and order in f32 on the same y =
LeakyReLU(x @ W * s + t), with the kernel's rule for ``per``
(``pool_groups``): the max must be the bits of the plain version's max of
the same y, the mean within rel 1e-6 of its mean, and both within 1e-5 of
the Pallas ``fused_conv_pool`` in interpret mode, with and without the
mean, at N not a multiple of the tile.  (The product's bits are the first
form's on the card: one fmaf chain a y, which ``chip_smoke.py`` holds
there.)

``csrc/knn_idx.cu`` (kernel 11) at k <= 64 selects each row's neighbours
with the tiled selection (64 rows a block, 128 columns a tile) and writes
each row's list from a warp's registers in list order: position p is slot
p / 32 of lane p % 32.  ``list_order_write`` emulates that store over
``test_torch_reduce_tiled.streaming_topk``'s lists, which must give the
indices of ``knn_plain`` and of the Pallas ``knn_pallas`` in interpret
mode at C = 3 and k = 32 / 40, on random clouds and on integer clouds of
duplicate points whose k-th boundary falls inside ties.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgcnn_tpu_torch.ops import conv_pool_plain, pairwise_neg_sqdist
from dgcnn_tpu_torch.ops.knn import knn_plain
from test_torch_reduce_tiled import streaming_topk

TILE = 128          # rows and columns of kernel 2's output tile
THREAD_ROWS = 16    # ty
POOL_BLOCKS = 8 * 132  # the blocks kernel 2's row groups aim at


def pool_groups(b: int, n: int, e: int) -> tuple[int, int]:
    """(per, groups): kernel 2's row tiles a group and groups a cloud."""
    row_tiles = -(-n // TILE)
    ctiles = -(-e // TILE)
    want = min(row_tiles, -(-POOL_BLOCKS // (b * ctiles)))
    per = max(1, row_tiles // want)
    return per, -(-row_tiles // per)


def pool_partitioned(y: np.ndarray, per: int):
    """(B, N, E) f32 y -> (max, mean), each (B, E), in kernel 2's
    partition and order of operations."""
    b, n, e = y.shape
    row_tiles = -(-n // TILE)
    groups = -(-row_tiles // per)
    rows_of = [(i & 3) + (i >> 2) * 64 + 4 * np.arange(THREAD_ROWS)
               for i in range(8)]
    gmax = np.full((groups, b, e), -np.inf, np.float32)
    gsum = np.zeros((groups, b, e), np.float32)
    for g in range(groups):
        mx = np.full((b, THREAD_ROWS, e), -np.inf, np.float32)
        sm = np.zeros((b, THREAD_ROWS, e), np.float32)
        for t in range(g * per, min(row_tiles, (g + 1) * per)):
            for rows in rows_of:
                r = t * TILE + rows
                valid = r < n
                v = y[:, np.minimum(r, n - 1), :]
                mx = np.where(valid[None, :, None], np.maximum(mx, v), mx)
                sm = np.where(valid[None, :, None],
                              (sm + v).astype(np.float32), sm)
        gmax[g] = mx.max(axis=1)
        s = np.zeros((b, e), np.float32)
        for ty in range(THREAD_ROWS):
            s = (s + sm[:, ty]).astype(np.float32)
        gsum[g] = s
    total = np.zeros((b, e), np.float32)
    for g in range(groups):
        total = (total + gsum[g]).astype(np.float32)
    return gmax.max(axis=0), (total / np.float32(n)).astype(np.float32)


def _pool_case(seed: int, b: int, n: int, widths, e: int):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, c)).astype(np.float32) for c in widths]
    c = sum(widths)
    w = (rng.standard_normal((c, e)) / np.sqrt(c)).astype(np.float32)
    sc = rng.uniform(-0.5, 1.5, e).astype(np.float32)
    bi = (0.1 * rng.standard_normal(e)).astype(np.float32)
    return xs, w, sc, bi


def _y(xs, w, sc, bi, slope=0.2) -> np.ndarray:
    h = torch.matmul(torch.cat([torch.from_numpy(x) for x in xs], -1),
                     torch.from_numpy(w))
    y = h * torch.from_numpy(sc) + torch.from_numpy(bi)
    return torch.where(y >= 0, y, slope * y).numpy()


@pytest.mark.parametrize("with_mean", [True, False])
@pytest.mark.parametrize("b,n,widths,e,one_group", [
    (2, 300, (8, 8, 16, 32), 48, False),   # 3 row tiles, the last masked
    (2, 300, (8, 8, 16, 32), 48, True),    # one group writes the rows
    (3, 600, (64,), 160, False),           # 5 tiles, two column tiles
])
def test_conv_pool_partition_matches_plain_and_pallas(with_mean, b, n, widths,
                                                      e, one_group):
    from dgcnn_tpu.ops.pallas_pool import fused_conv_pool

    xs, w, sc, bi = _pool_case(20 + n + e, b, n, widths, e)
    per, groups = pool_groups(b, n, e)
    if one_group:
        per, groups = -(-n // TILE), 1
    assert n % TILE and (one_group or groups > 1)
    y = _y(xs, w, sc, bi)
    got_max, got_mean = pool_partitioned(y, per)
    # the max is order-free: the plain version's bits of the same y
    np.testing.assert_array_equal(got_max, y.max(axis=1))
    plain = conv_pool_plain([torch.from_numpy(x) for x in xs],
                            torch.from_numpy(w), torch.from_numpy(sc),
                            torch.from_numpy(bi),
                            with_mean=with_mean).numpy()
    np.testing.assert_array_equal(got_max, plain[:, 0])
    got = [got_max]
    if with_mean:
        np.testing.assert_allclose(got_mean, plain[:, 1], rtol=1e-6,
                                   atol=1e-6 * np.abs(plain[:, 1]).max())
        got.append(got_mean)
    want = fused_conv_pool(tuple(jnp.asarray(x) for x in xs), jnp.asarray(w),
                           jnp.asarray(sc), jnp.asarray(bi), 0.2,
                           compute_dtype=jnp.float32, with_mean=with_mean,
                           interpret=True)
    np.testing.assert_allclose(np.stack(got, axis=1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,e,per,groups", [
    (64, 1024, 1024, 2, 4),    # DGCNNCls conv5
    (16, 4096, 1024, 3, 11),   # DGCNNSemSeg conv6
    (16, 2048, 1024, 1, 16),   # DGCNNPartSeg conv3 / conv6, the Net's conv3
    (64, 1000, 1024, 2, 4),    # DGCNNCls at N = 1000: the last tile masked
])
def test_conv_pool_groups_fill_the_card(b, n, e, per, groups):
    """The row groups at the models' shapes: at least four waves of two
    blocks an SM on 132 SMs, each group a run of whole tiles."""
    assert pool_groups(b, n, e) == (per, groups)
    assert b * groups * (e // TILE) >= POOL_BLOCKS
    assert (groups - 1) * per < -(-n // TILE) <= groups * per


# ------------------------------------------------------------- kernel 11
KNN_N = 256


def list_order_write(lists: np.ndarray, k: int) -> np.ndarray:
    """(rows, k) lists -> (rows, k) idx as the kernel stores them: a row's
    list held in a warp's registers, slot q of lane l the entry at
    position l + 32 q (KL = ceil(k / 32) slots, lanes past k hold stale
    entries), each lane storing its slots whose position is below k."""
    rows = lists.shape[0]
    kl = -(-k // 32)
    regs = np.full((rows, kl, 32), -1, np.int64)
    for q in range(kl):
        for lane in range(32):
            if lane + 32 * q < k:
                regs[:, q, lane] = lists[:, lane + 32 * q]
    out = np.full((rows, k), -7, np.int64)
    for q in range(kl):
        for lane in range(32):
            p = lane + 32 * q
            if p < k:
                out[:, p] = regs[:, q, lane]
    return out


def _knn_cloud(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ints":  # every point four times on a small grid: ties
        base = rng.integers(-2, 3, (2, KNN_N // 4, 3)).astype(np.float32)
        return np.concatenate([base] * 4, axis=1)
    return rng.standard_normal((2, KNN_N, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ints"])
@pytest.mark.parametrize("k", [32, 40])
def test_knn_tiled_list_write_matches_plain_and_pallas(kind, k):
    from dgcnn_tpu.ops.pallas_knn import knn_pallas

    x = _knn_cloud(kind, 60 + k)
    scores = pairwise_neg_sqdist(torch.from_numpy(x)).numpy()
    want = knn_plain(torch.from_numpy(x), k).numpy()
    if kind == "ints":  # the k-th boundary falls inside ties
        kth = np.take_along_axis(scores, want[..., -1:], -1)
        assert ((scores == kth).sum(-1) > 1).any()
    got = np.stack([list_order_write(streaming_topk(sc, k, 64, TILE), k)
                    for sc in scores])
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(knn_pallas.__wrapped__(jnp.asarray(x), k,
                                               interpret=True))
    np.testing.assert_array_equal(got, pallas)
