"""The arithmetic of the redesigned kernels 10 and 9, on the CPU.

``csrc/knn_sum.cu`` (kernel 10) at k <= 64 selects each query row's
neighbours with the tiled selection of ``csrc/knn_select.cuh`` (64 rows a
block, 128-column tiles), writes each row's list in list order, as kernel
11 does, and then folds the lists of a warp's eight rows into their sums
of ``a``: the lists staged in shared memory, G = min(8, 32 // Ca) rows at
once, lane g * Ca + c summing channel c of row g over t = 0..k-1 in list
order from the t = 0 term.  ``tiled_knn_sum`` emulates that over
``test_torch_reduce_tiled.streaming_topk``'s lists and
``test_torch_pool_knn_tiled.list_order_write``'s store; it must give the
indices and the sums of ``knn_sum_plain`` bit for bit, and the indices of
the JAX package's Pallas ``fused_knn_sum`` in interpret mode (exact v1
selection) with its sums within rel 1e-5 of each row's scale (the TPU sums
through a 3-way bf16 split), on random clouds and on integer clouds of
duplicate points whose k-th boundary falls inside ties.

``csrc/edge_sum.cu`` (kernel 9) gives a warp G = min(4, 32 // P)
consecutive rows, P = Co / V lanes a row (V = 2 channels a lane where Co
is even, else 1), stages their indices once and has lane g * P + p sum
channels V p .. V p + V - 1 of row g in t order.  ``rows_edge_sum``
emulates that partition: bit-equal to ``edge_sum_plain`` and within rel
1e-5 of the Pallas ``edge_sum_reduce`` in interpret mode, on indices that
repeat.  The ``cuda``-marked tests hold the card's new routes bit-equal
to the earlier ones (``knn_sum(..., rowwarp=True)``, ``edge_sum(...,
per_output=True)``); they skip without a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.ops import (
    edge_sum,
    edge_sum_plain,
    knn_sum,
    knn_sum_plain,
    pairwise_neg_sqdist,
)
from test_torch_pool_knn_tiled import list_order_write
from test_torch_reduce_tiled import streaming_topk

N = 256
TS_R, TS_J, TS_WR = 64, 128, 8   # the tiled selection's block, tile, rows
ES_GMAX = 4                      # kernel 9's rows a warp at most


def _fold(a_rows, lists, c) -> np.ndarray:
    """Sums of a_rows[lists[..., t], c] over t in order from the t = 0
    term, one f32 add at a time."""
    acc = a_rows[lists[..., 0], c]
    for t in range(1, lists.shape[-1]):
        acc = (acc + a_rows[lists[..., t], c]).astype(np.float32)
    return acc


def tiled_knn_sum(x: np.ndarray, a: np.ndarray, k: int):
    """(B, N, C), (B, N, Ca) -> (idx, asum) as kernel 10's tiled route
    computes them; every output written exactly once."""
    b, n, _ = x.shape
    ca = a.shape[2]
    scores = pairwise_neg_sqdist(torch.from_numpy(x)).numpy()
    idx = np.stack([list_order_write(streaming_topk(sc, k, TS_R, TS_J), k)
                    for sc in scores])
    g_rows = min(TS_WR, 32 // ca)
    asum = np.zeros((b, n, ca), np.float32)
    written = np.zeros((b, n, ca), np.int64)
    # the staged lists of every warp: (B, warps, TS_WR, k)
    staged = idx.reshape(b, n // TS_WR, TS_WR, k)
    warp_row0 = TS_WR * np.arange(n // TS_WR)
    for lane in range(32):
        g, c = divmod(lane, ca)
        if g >= g_rows:
            continue
        for rr in range(g, TS_WR, g_rows):
            for bi in range(b):
                asum[bi, warp_row0 + rr, c] = _fold(a[bi], staged[bi, :, rr],
                                                    c)
                written[bi, warp_row0 + rr, c] += 1
    assert (written == 1).all()
    return idx, asum


def rows_edge_sum(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(B, N, Co), (B, N, k) -> (B, N, Co) as kernel 9's rows form sums:
    a warp's G rows, lanes over channel pairs (Co even) or channels."""
    b, n, co = a.shape
    k = idx.shape[2]
    v = 2 if co % 2 == 0 else 1
    p = co // v
    g_rows = min(ES_GMAX, 32 // p)
    rows = b * n
    warps = -(-rows // g_rows)
    # each warp's indices, read once: (warps, G, k), rows past the end -1
    staged = np.full((warps * g_rows, k), -1, np.int64)
    staged[:rows] = idx.reshape(rows, k)
    staged = staged.reshape(warps, g_rows, k)
    a_flat = a.reshape(rows, co)
    out = np.zeros((rows, co), np.float32)
    written = np.zeros((rows, co), np.int64)
    for lane in range(32):
        g, pc = divmod(lane, p)
        if g >= g_rows:
            continue
        row = np.arange(warps) * g_rows + g
        live = row < rows
        row = row[live]
        # a row's neighbours as rows of a_flat (its own cloud)
        lists = staged[live, g] + (row // n * n)[:, None]
        for c in range(pc * v, pc * v + v):
            out[row, c] = _fold(a_flat, lists, c)
            written[row, c] += 1
    assert (written == 1).all()
    return out.reshape(b, n, co)


def _hog_case(kind: str, seed: int, b: int = 2):
    """(x, a): a centred cloud and its nine moments, or an integer cloud of
    duplicate points (each four times) and integer rows."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        base = rng.integers(-2, 3, (b, N // 4, 3)).astype(np.float32)
        x = np.concatenate([base] * 4, axis=1)
        return x, rng.integers(-3, 4, (b, N, 9)).astype(np.float32)
    x = rng.standard_normal((b, N, 3)).astype(np.float32)
    x = (x - x.mean(1, keepdims=True)).astype(np.float32)
    a = np.concatenate([x, x * x, x[..., [0, 0, 1]] * x[..., [1, 2, 2]]],
                       axis=-1)
    return x, a.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ints"])
@pytest.mark.parametrize("k", [1, 20, 32, 40, 64])
def test_knn_sum_tiled_matches_plain_and_pallas(monkeypatch, kind, k):
    from dgcnn_tpu.ops.pallas_knn import fused_knn_sum

    x, a = _hog_case(kind, 150 + k)
    idx, asum = tiled_knn_sum(x, a, k)
    pidx, psum = knn_sum_plain(torch.from_numpy(x), torch.from_numpy(a), k)
    np.testing.assert_array_equal(idx, pidx.numpy())
    assert torch.equal(torch.from_numpy(asum), psum)
    if kind == "ints":  # the k-th boundary falls inside ties
        scores = pairwise_neg_sqdist(torch.from_numpy(x)).numpy()
        kth = np.take_along_axis(scores, idx[..., -1:], -1)
        assert ((scores == kth).sum(-1) > 1).any()
    # the exact (v1) selection, as tests/test_torch_port_net.py pins it
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    with jax.default_matmul_precision("float32"):
        jidx, jsum = fused_knn_sum.__wrapped__(jnp.asarray(x),
                                               jnp.asarray(a), k,
                                               interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    jsum = np.asarray(jsum)
    scale = np.abs(jsum).max(-1, keepdims=True)
    assert (np.abs(asum - jsum) <= 1e-5 * scale).all()


@pytest.mark.parametrize("co", [18, 9])
@pytest.mark.parametrize("k", [1, 32, 40])
def test_edge_sum_rows_match_plain_and_pallas(co, k):
    from dgcnn_tpu.ops.pallas_knn import edge_sum_reduce

    rng = np.random.default_rng(co * 100 + k)
    a = rng.standard_normal((3, N, co)).astype(np.float32)
    idx = rng.integers(0, N, (3, N, k)).astype(np.int32)
    idx[..., k // 2] = idx[..., k // 3]
    if k > 1:
        assert any(len(set(row)) < k for row in idx.reshape(-1, k).tolist())
    got = rows_edge_sum(a, idx)
    want = edge_sum_plain(torch.from_numpy(a), torch.from_numpy(idx))
    assert torch.equal(torch.from_numpy(got), want)
    with jax.default_matmul_precision("float32"):
        jwant = np.asarray(edge_sum_reduce.__wrapped__(
            jnp.asarray(a), jnp.asarray(idx), k, interpret=True))
    scale = np.abs(jwant).max(-1, keepdims=True)
    assert (np.abs(got - jwant) <= 1e-5 * scale).all()


@pytest.mark.parametrize("b,n,co", [(16, 2048, 18), (2, 256, 9),
                                    (1, 5, 4), (3, 7, 64)])
def test_edge_sum_rows_cover_every_output_once(b, n, co):
    """The rows partition at the HOG shape, an odd Co, G = 4 and one row a
    warp, on row counts that leave the last warp short: every output
    written once (``rows_edge_sum`` asserts it), the plain version's
    bits."""
    rng = np.random.default_rng(b * n + co)
    a = rng.integers(-4, 5, (b, n, co)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, 3)).astype(np.int32)
    got = rows_edge_sum(a, idx)
    assert torch.equal(torch.from_numpy(got), edge_sum_plain(
        torch.from_numpy(a), torch.from_numpy(idx)))


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ints"])
@pytest.mark.parametrize("k", [32, 40, 65])
def test_knn_sum_tiled_route_bit_equal_to_row_warp(cuda_device, kind, k):
    """Kernel 10's tiled route (k <= 64) gives the idx and sums of its
    row-warp route (``rowwarp=True``) bit for bit; k = 65 runs the row-warp
    route on both sides."""
    rng = np.random.default_rng(300 + k)
    if kind == "ints":
        base = rng.integers(-2, 3, (2, 512, 3)).astype(np.float32)
        x = np.concatenate([base] * 4, axis=1)
        a = rng.integers(-3, 4, (2, 2048, 9)).astype(np.float32)
    else:
        x = rng.standard_normal((4, 2048, 3)).astype(np.float32)
        x -= x.mean(1, keepdims=True)
        a = rng.standard_normal((4, 2048, 9)).astype(np.float32)
    x, a = (torch.from_numpy(v).to(cuda_device) for v in (x, a))
    idx, asum = knn_sum(x, a, k)
    ridx, rsum = knn_sum(x, a, k, rowwarp=True)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(asum, rsum)
    if kind == "ints":  # exact sums: the plain version's bits too
        pidx, psum = knn_sum_plain(x, a, k)
        assert torch.equal(idx, pidx) and torch.equal(asum, psum)


@pytest.mark.cuda
@pytest.mark.parametrize("co,k", [(18, 32), (18, 40), (9, 32), (80, 32),
                                  (18, 1)])
def test_edge_sum_rows_bit_equal_to_earlier_form(cuda_device, co, k):
    """Kernel 9's rows form gives the bits of its earlier form
    (``per_output=True``) and of the plain version, repeated indices
    included."""
    rng = np.random.default_rng(co * 10 + k)
    a = torch.from_numpy(rng.standard_normal((4, 2048, co)).astype(
        np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 2048, (4, 2048, k)).astype(
        np.int32)).to(cuda_device)
    got = edge_sum(a, idx)
    assert torch.equal(got, edge_sum(a, idx, per_output=True))
    assert torch.equal(got, edge_sum_plain(a, idx))
