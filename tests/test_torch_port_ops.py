"""Parity of the PyTorch port's ops (dgcnn_tpu_torch.ops) with the JAX
package's, on the CPU at small sizes: the same numpy inputs through both.

The Pallas kernels run as the JAX package's own tests run them here
(``interpret=True``, f32 selection); the port's kernel wrappers run their
plain versions because the tensors lie on the CPU.  Tests marked ``cuda``
hold each CUDA kernel against its plain version and skip without a card.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu.ops import edge_conv as jedge
from dgcnn_tpu.ops import graph as jgraph
from dgcnn_tpu_torch.ops import (
    Edge2Reduce,
    KnnEdgeReduce,
    KnnEdgeReduceXW,
    conv_pool,
    conv_pool_plain,
    edge2_bwd,
    edge2_bwd_plain,
    edge2_fwd,
    edge2_fwd_plain,
    edge2_z2,
    edge_conv_batch_stats,
    edge_conv_eval,
    edge_conv_eval_plain,
    edge_conv_fused,
    edge_conv_naive,
    edge_linear,
    edge_reduce_bwd,
    edge_reduce_bwd_plain,
    fold_bn,
    gather_neighbors,
    global_max,
    global_mean,
    knn,
    knn_edge2,
    knn_edge2_plain,
    knn_reduce,
    knn_reduce_plain,
    knn_reduce_xw,
    knn_reduce_xw_plain,
    pairwise_neg_sqdist,
    xw_project,
)
from dgcnn_tpu_torch.ops.banded import (
    band_starts,
    band_tile,
    banded_applicable,
    banded_edge_conv_eval,
    banded_edge_conv_eval_plain,
    banded_knn_edge2,
    banded_knn_edge2_plain,
    inverse_order,
    pc1_key,
    sorted_order,
)
from dgcnn_tpu_torch.ops.graph import get_graph_feature
from dgcnn_tpu_torch.ops.knn import knn_plain

# the package re-exports a function named knn over the module of that name
jknn = importlib.import_module("dgcnn_tpu.ops.knn")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a):
    return np.asarray(a)


def _stage_inputs(seed, b, n, cin, co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, cin)).astype(np.float32)
    wn = (rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32)
    wc = (rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32)
    sign = np.where(rng.random(co) < 0.2, -1.0, 1.0)
    sc = (sign * (rng.random(co) + 0.5)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(co)).astype(np.float32)
    return x, wn, wc, sc, bi


def _duplicate_cloud(seed, b=2, n=128, c=4):
    """Every point appears four times: distance ties in every row."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((b, n // 4, c)).astype(np.float32)
    return np.concatenate([base] * 4, axis=1)


@pytest.fixture
def pallas_exact(monkeypatch):
    """The JAX package's fused training path in its exact f32 mode
    (interpret mode on the CPU), as tests/test_pallas_train_path.py sets
    it."""
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")


def _reduce_inputs(seed, b=2, n=128, c=8, co=16, dup=False):
    """Graph, features and cotangents; with ``dup`` point 30 repeats point
    10 in the graph and in ``a`` (exact distance ties and tied values)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    a = rng.standard_normal((b, n, co)).astype(np.float32)
    if dup:
        g[:, 30] = g[:, 10]
        a[:, 30] = a[:, 10]
    cts = [rng.standard_normal((b, n, co)).astype(np.float32)
           for _ in range(4)]
    return g, a, cts


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_pairwise_neg_sqdist_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 128, 8)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want = _np(jknn.pairwise_neg_sqdist(jnp.asarray(x)))
    got = pairwise_neg_sqdist(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,k", [(3, 4), (16, 8), (64, 20)])
def test_knn_index_exact(c, k):
    x = np.random.default_rng(c).standard_normal((2, 128, c)).astype(
        np.float32)
    want = _np(jknn.knn(jnp.asarray(x), k))
    got = knn(_t(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, :, 0] == np.arange(128)).all()  # self first


def test_knn_duplicate_points_lowest_index_first():
    x = _duplicate_cloud(1)
    want = _np(jknn.knn(jnp.asarray(x), 6))
    got = knn(_t(x), 6).numpy()
    np.testing.assert_array_equal(got, want)
    # point i's first four neighbours are its four copies, in index order
    n4 = 32
    for i in (0, 5, 40, 127):
        copies = sorted({i % n4 + j * n4 for j in range(4)})
        assert list(got[0, i, :4]) == copies


def test_gather_and_pools_match_jax():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((2, 128, 8)).astype(np.float32)
    idx = rng.integers(0, 128, (2, 128, 5)).astype(np.int32)
    want = _np(jgraph.gather_neighbors(jnp.asarray(f), jnp.asarray(idx)))
    np.testing.assert_array_equal(
        gather_neighbors(_t(f), _t(idx).long()).numpy(), want)
    np.testing.assert_array_equal(global_max(_t(f)).numpy(), f.max(1))
    np.testing.assert_allclose(global_mean(_t(f)).numpy(), f.mean(1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn,jfn", [(edge_conv_fused, jedge.edge_conv_fused),
                                    (edge_conv_naive, jedge.edge_conv_naive)])
def test_edge_conv_matches_jax(fn, jfn):
    x, wn, wc, sc, bi = _stage_inputs(3, 2, 128, 16, 24)
    idx = np.asarray(jknn.knn(jnp.asarray(x), 6))
    with jax.default_matmul_precision("float32"):
        want = _np(jfn(*(jnp.asarray(a) for a in (x, idx, wn, wc, sc, bi))))
    got = fn(_t(x), _t(idx).long(), _t(wn), _t(wc), _t(sc), _t(bi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(4)
    g, b, m = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    want = jedge.fold_bn(*(jnp.asarray(a) for a in (g, b, m, v)), 1e-5)
    got = fold_bn(_t(g), _t(b), _t(m), _t(v), 1e-5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cin,co,k", [(3, 64, 8), (16, 24, 4)])
def test_edge_conv_eval_matches_pallas_interpret(cin, co, k):
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    x, wn, wc, sc, bi = _stage_inputs(5 + cin, 2, 128, cin, co)
    want = fused_edge_conv_eval.__wrapped__(
        *(jnp.asarray(a) for a in (x, x, wn, wc, sc, bi)), k,
        select_dtype=jnp.float32, interpret=True)
    before = edge_conv_eval.launches
    got = edge_conv_eval(_t(x), _t(x), _t(wn), _t(wc), _t(sc), _t(bi), k)
    assert edge_conv_eval.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_edge_conv_eval_duplicate_points_matches_pallas():
    """Graph with every point four times, features that differ between the
    copies: the output depends on which copies are picked, so agreement
    pins the lowest-index rule."""
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    graph = _duplicate_cloud(6)
    x, wn, wc, sc, bi = _stage_inputs(7, 2, 128, 8, 16)
    k = 6  # the boundary falls inside the second point's copies
    want = fused_edge_conv_eval.__wrapped__(
        *(jnp.asarray(a) for a in (graph, x, wn, wc, sc, bi)), k,
        select_dtype=jnp.float32, interpret=True)
    got = edge_conv_eval(*(_t(a) for a in (graph, x, wn, wc, sc, bi)), k)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_mean", [True, False])
def test_conv_pool_matches_pallas_interpret(with_mean):
    from dgcnn_tpu.ops.pallas_pool import fused_conv_pool

    rng = np.random.default_rng(8)
    widths = (8, 8, 16, 32)
    xs = [rng.standard_normal((2, 128, c)).astype(np.float32) for c in widths]
    w = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    sc = rng.uniform(-0.5, 1.5, 48).astype(np.float32)
    bi = (0.1 * rng.standard_normal(48)).astype(np.float32)
    want = fused_conv_pool(tuple(jnp.asarray(a) for a in xs), jnp.asarray(w),
                           jnp.asarray(sc), jnp.asarray(bi), 0.2,
                           compute_dtype=jnp.float32, with_mean=with_mean,
                           interpret=True)
    before = conv_pool.launches
    got = conv_pool(tuple(_t(a) for a in xs), _t(w), _t(sc), _t(bi), 0.2,
                    with_mean=with_mean)
    assert conv_pool.launches == before
    assert got.shape == (2, 2 if with_mean else 1, 48)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_edge_linear_and_batch_stats_match_jax():
    x, wn, wc, _, _ = _stage_inputs(12, 2, 128, 16, 24)
    idx = np.asarray(jknn.knn(jnp.asarray(x), 6))
    jargs = tuple(jnp.asarray(a) for a in (x, idx, wn, wc))
    targs = (_t(x), _t(idx).long(), _t(wn), _t(wc))
    with jax.default_matmul_precision("float32"):
        want = [_np(jedge.edge_linear(*jargs)),
                *map(_np, jedge.edge_conv_batch_stats(*jargs))]
    got = [edge_linear(*targs), *edge_conv_batch_stats(*targs)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,co,k,dup", [(3, 16, 8, False), (16, 32, 6, False),
                                        (4, 8, 6, True)])
def test_knn_reduce_matches_pallas_interpret(c, co, k, dup):
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    g, a, _ = _reduce_inputs(13 + c, c=c, co=co, dup=dup)
    want = fused_knn_reduce(jnp.asarray(g), jnp.asarray(a), k,
                            select_dtype=jnp.float32, with_sumsq=True,
                            interpret=True)
    before = knn_reduce.launches
    got = knn_reduce(_t(g), _t(a), k)
    assert knn_reduce.launches == before  # CPU: the plain version
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    for gv, wv in zip(got[1:], want[1:]):
        np.testing.assert_allclose(gv.numpy(), _np(wv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,co,k", [(8, 32, 6), (16, 24, 8)])
def test_knn_reduce_xw_matches_pallas_interpret(cin, co, k):
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce_xw

    g, _, _ = _reduce_inputs(14, c=3)
    x, w, _, _, _ = _stage_inputs(15 + cin, 2, 128, cin, co)
    with jax.default_matmul_precision("float32"):
        want = fused_knn_reduce_xw(
            jnp.asarray(g), jnp.asarray(x), jnp.asarray(w), k,
            select_dtype=jnp.float32, with_sumsq=True, interpret=True)
    before = knn_reduce_xw.launches
    got = knn_reduce_xw(_t(g), _t(x), _t(w), k)
    assert knn_reduce_xw.launches == before
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    for gv, wv in zip(got[1:], want[1:]):
        np.testing.assert_allclose(gv.numpy(), _np(wv), rtol=1e-5, atol=1e-5)
    # the backward's projection routine gives the forward's bits
    again = knn_reduce_plain(_t(g), xw_project(_t(x), _t(w)), k)
    for gv, av in zip(got, again):
        assert torch.equal(gv, av)


@pytest.mark.parametrize("dup", [False, True])
def test_edge_reduce_bwd_matches_pallas_interpret(dup):
    """Duplicate points give tied distances and tied values: the max/min
    cotangent splits evenly among the tied members on both sides."""
    from dgcnn_tpu.ops.pallas_knn import _ker_bwd_xla, edge_reduce_bwd as jbwd
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    k = 6
    g, a, cts = _reduce_inputs(16, c=4, co=8, dup=dup)
    out = fused_knn_reduce(jnp.asarray(g), jnp.asarray(a), k,
                           select_dtype=jnp.float32, with_sumsq=True,
                           interpret=True)
    jcts = tuple(jnp.asarray(c) for c in cts)
    want = _np(jbwd(out[0], jnp.asarray(a), out[1], out[2], *jcts, k,
                    exact=True, interpret=True))
    np.testing.assert_allclose(
        _np(_ker_bwd_xla(jnp.asarray(a), out[0], (None,) + jcts)), want,
        rtol=1e-5, atol=1e-5)
    idx, amax, amin = (_t(o) for o in out[:3])
    before = edge_reduce_bwd.launches
    got = edge_reduce_bwd(idx, _t(a), amax, amin, *map(_t, cts))
    assert edge_reduce_bwd.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if dup:  # the copies' rows of a are tied in every neighbourhood
        assert (np.asarray(out[0]) == 30).any()


def test_knn_edge_reduce_grad_matches_jax_vjp(pallas_exact):
    from dgcnn_tpu.ops.pallas_knn import knn_edge_reduce

    k = 6
    g, a, cts = _reduce_inputs(17, c=4, co=16, dup=True)
    with jax.default_matmul_precision("float32"):
        outs, vjp = jax.vjp(
            lambda a_: knn_edge_reduce(jnp.asarray(g), a_, k)[1:],
            jnp.asarray(a))
        (want,) = vjp(tuple(jnp.asarray(c) for c in cts))
    at = _t(a).requires_grad_(True)
    got = KnnEdgeReduce.apply(_t(g), at, k)
    assert not got[0].requires_grad
    for gv, wv in zip(got[1:], outs):
        np.testing.assert_allclose(gv.detach().numpy(), _np(wv), rtol=1e-5,
                                   atol=1e-5)
    torch.autograd.backward(got[1:], [_t(c) for c in cts])
    np.testing.assert_allclose(at.grad.numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)


def test_knn_edge_reduce_xw_grads_match_jax_vjp(pallas_exact):
    from dgcnn_tpu.ops.pallas_knn import knn_edge_reduce_xw

    k = 6
    g, _, cts = _reduce_inputs(18, c=3, co=24)
    x, w, _, _, _ = _stage_inputs(19, 2, 128, 16, 24)
    with jax.default_matmul_precision("float32"):
        outs, vjp = jax.vjp(
            lambda x_, w_: knn_edge_reduce_xw(jnp.asarray(g), x_, w_, k)[1:],
            jnp.asarray(x), jnp.asarray(w))
        want = vjp(tuple(jnp.asarray(c) for c in cts))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    gt = _t(g).requires_grad_(True)
    got = KnnEdgeReduceXW.apply(gt, xt, wt, k)
    for gv, wv in zip(got[1:], outs):
        np.testing.assert_allclose(gv.detach().numpy(), _np(wv), rtol=1e-5,
                                   atol=1e-5)
    torch.autograd.backward(got[1:], [_t(c) for c in cts])
    assert gt.grad is None  # the graph takes no gradient
    for gv, wv in zip((xt.grad, wt.grad), want):
        wv = _np(wv)
        np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-4,
                                   atol=1e-5 * np.abs(wv).max())


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises instead of taking the plain version."""
    x = torch.zeros((1, 128, 3), device="meta")
    w = torch.zeros((3, 8), device="meta")
    s = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        edge_conv_eval(x, x, w, w, s, s, 4)
    with pytest.raises(ValueError, match="no kernel"):
        conv_pool((x,), w, s, s)


def test_training_kernel_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((1, 128, 3), device="meta")
    a = torch.zeros((1, 128, 8), device="meta")
    w = torch.zeros((3, 8), device="meta")
    idx = torch.zeros((1, 128, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        knn_reduce(x, a, 4)
    with pytest.raises(ValueError, match="no kernel"):
        knn_reduce_xw(x, x, w, 4)
    with pytest.raises(ValueError, match="no kernel"):
        xw_project(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        edge_reduce_bwd(idx, a, a, a, a, a, a, a)


def test_port_imports_no_jax():
    """Every module of dgcnn_tpu_torch, and chip_smoke.py, import without
    jax, flax or dgcnn_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dgcnn_tpu_torch\n"
        "for m in pkgutil.walk_packages(dgcnn_tpu_torch.__path__, "
        "'dgcnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dgcnn_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len([n for n in sys.modules "
        "if n.startswith('dgcnn_tpu_torch.')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,co", [(3, 64), (64, 64), (64, 128), (128, 256)])
def test_edge_conv_eval_kernel_matches_plain(cuda_device, cin, co):
    x, wn, wc, sc, bi = (_t(a).to(cuda_device)
                         for a in _stage_inputs(9, 4, 1024, cin, co))
    before = edge_conv_eval.launches
    got = edge_conv_eval(x, x, wn, wc, sc, bi, 20)
    torch.cuda.synchronize()
    assert edge_conv_eval.launches == before + 1
    want = edge_conv_eval_plain(x, x, wn, wc, sc, bi, 20)
    ok = ((got - want).abs() <= 1e-4 * (want.abs() + want.pow(2).mean().sqrt())
          ).all(-1)
    assert ok.float().mean().item() >= 0.999


@pytest.mark.cuda
def test_edge_conv_eval_kernel_duplicates_exact(cuda_device):
    rng = np.random.default_rng(10)
    base = rng.integers(-4, 5, (2, 64, 3))
    graph = np.concatenate([base] * 4, 1).astype(np.float32)
    ints = [rng.integers(-3, 4, s).astype(np.float32)
            for s in [(2, 256, 8), (8, 32), (8, 32)]]
    sc = np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), 8)
    bi = rng.integers(-2, 3, 32).astype(np.float32)
    args = [_t(a).to(cuda_device) for a in (graph, *ints, sc, bi)]
    got = edge_conv_eval(*args, 6)
    assert torch.equal(got, edge_conv_eval_plain(*args, 6))


@pytest.mark.cuda
def test_conv_pool_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    xs = tuple(_t(rng.standard_normal((4, 1024, c)).astype(np.float32))
               .to(cuda_device) for c in (64, 64, 128, 256))
    w = _t((rng.standard_normal((512, 1024)) / 22).astype(np.float32)).to(
        cuda_device)
    sc, bi = (_t(rng.uniform(-0.5, 1.5, 1024).astype(np.float32)).to(
        cuda_device) for _ in range(2))
    before = conv_pool.launches
    got = conv_pool(xs, w, sc, bi)
    torch.cuda.synchronize()
    assert conv_pool.launches == before + 1
    want = conv_pool_plain(xs, w, sc, bi)
    assert ((got - want).abs()
            <= 1e-4 * (want.abs() + want.pow(2).mean().sqrt())).all()


def _row_match(got, want, rtol=1e-4):
    """Mask of the (b, i) rows whose every channel is within rtol of the
    plain version's, scaled by |want| + rms(want) (chip_smoke.row_match)."""
    scale = want.pow(2).mean().sqrt()
    return ((got - want).abs() <= rtol * (want.abs() + scale)).all(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("c,co", [(3, 64), (64, 64), (64, 128)])
def test_knn_reduce_kernel_matches_plain(cuda_device, c, co):
    g, a, _ = _reduce_inputs(20 + c, b=4, n=1024, c=c, co=co)
    g, a = _t(g).to(cuda_device), _t(a).to(cuda_device)
    before = knn_reduce.launches
    got = knn_reduce(g, a, 20)
    torch.cuda.synchronize()
    assert knn_reduce.launches == before + 1
    want = knn_reduce_plain(g, a, 20)
    same = (got[0] == want[0]).all(-1)
    assert same.float().mean().item() >= 0.999
    for gv, wv in zip(got[1:], want[1:]):
        assert torch.isfinite(gv).all()
        assert _row_match(gv, wv)[same].all()


@pytest.mark.cuda
def test_knn_reduce_xw_kernel_matches_plain(cuda_device):
    g, _, _ = _reduce_inputs(21, b=4, n=1024, c=128)
    x, w = (_t(v).to(cuda_device)
            for v in _stage_inputs(22, 4, 1024, 128, 256)[:2])
    g = _t(g).to(cuda_device)
    got = knn_reduce_xw(g, x, w, 20)
    want = knn_reduce_xw_plain(g, x, w, 20)
    same = (got[0] == want[0]).all(-1)
    assert same.float().mean().item() >= 0.999
    for gv, wv in zip(got[1:], want[1:]):
        assert _row_match(gv, wv)[same].all()
    # the backward's projection reproduces the forward's maxima bit for bit
    a = xw_project(x, w)
    amax = gather_neighbors(a, got[0].long()).amax(2)
    assert torch.equal(amax, got[1])


@pytest.mark.cuda
def test_edge_reduce_bwd_kernel_matches_plain(cuda_device):
    g, a, cts = _reduce_inputs(23, b=4, n=1024, c=64, co=128)
    g, a, *cts = (_t(v).to(cuda_device) for v in (g, a, *cts))
    idx, amax, amin, _, _ = knn_reduce(g, a, 20)
    before = edge_reduce_bwd.launches
    got = edge_reduce_bwd(idx, a, amax, amin, *cts)
    torch.cuda.synchronize()
    assert edge_reduce_bwd.launches == before + 1
    want = edge_reduce_bwd_plain(idx, a, amax, amin, *cts)
    assert torch.isfinite(got).all()
    assert _row_match(got, want).all()


@pytest.mark.cuda
def test_training_kernels_duplicates_exact(cuda_device):
    """Integer-valued duplicate points: every sum is exact, so kernel and
    plain version agree bit for bit iff they pick the same neighbours in
    the same order and split tied cotangents the same way."""
    rng = np.random.default_rng(24)
    base = rng.integers(-4, 5, (2, 64, 3))
    g = _t(np.concatenate([base] * 4, 1).astype(np.float32)).to(cuda_device)
    a = _t(rng.integers(-3, 4, (2, 256, 16)).astype(np.float32)).to(
        cuda_device)
    got = knn_reduce(g, a, 6)
    want = knn_reduce_plain(g, a, 6)
    for gv, wv in zip(got, want):
        assert torch.equal(gv, wv)
    cts = [_t(rng.integers(-3, 4, (2, 256, 16)).astype(np.float32) * 60)
           .to(cuda_device) for _ in range(4)]
    assert torch.equal(edge_reduce_bwd(got[0], a, got[1], got[2], *cts),
                       edge_reduce_bwd_plain(got[0], a, got[1], got[2], *cts))


def test_knn_index_exact_at_4096_points():
    """The plain selection at the S3DIS block size, N=4096 (one cloud over
    three channels, as the first graph's normalized coordinates).  The
    coordinates are multiples of 1/64, so that every score is exact in any
    summation order and equal distances tie exactly: the lowest index wins
    on both sides."""
    x = (np.random.default_rng(25).integers(0, 64, (1, 4096, 3)) / 64
         ).astype(np.float32)
    want = _np(jknn.knn(jnp.asarray(x), 20))
    np.testing.assert_array_equal(knn(_t(x), 20).numpy(), want)


def _edge2_inputs(seed, b=2, n=128, cg=3, c1=16, c2=24, k=6, dup=False,
                  ints=False):
    """Graph, a1/b1, the two folded affines, w2, the kNN idx and four
    cotangents of a two-conv block.  ``dup``: every point four times in
    the graph and in a1 (tied distances and tied z2).  ``ints``: small
    integers, scales of +-1 and +-1/2, max/min cotangents that are
    multiples of 60 (every tie count up to 6 divides them): with a
    LeakyReLU slope of 1/4 every product and sum is exact."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        if ints:
            return rng.integers(-2, 3, shape).astype(np.float64)
        return rng.standard_normal(shape)

    if dup:
        g = np.concatenate([draw((b, n // 4, cg))] * 4, 1)
        a1 = np.concatenate([draw((b, n // 4, c1))] * 4, 1)
    else:
        g, a1 = draw((b, n, cg)), draw((b, n, c1))
    b1 = draw((b, n, c1))
    sign1 = np.where(rng.random(c1) < 0.2, -1.0, 1.0)
    sign2 = np.where(rng.random(c2) < 0.2, -1.0, 1.0)
    if ints:
        w2 = rng.integers(-1, 2, (c1, c2)).astype(np.float64)
        s1, s2 = np.where(sign1 > 0, 1.0, -0.5), np.where(sign2 > 0, 1.0, -1.0)
        t1, t2 = draw(c1), draw(c2)
        cts = [60.0 * draw((b, n, c2)) for _ in range(2)] + [
            draw((b, n, c2)) for _ in range(2)]
    else:
        w2 = rng.standard_normal((c1, c2)) / np.sqrt(c1)
        s1 = sign1 * rng.uniform(0.5, 1.5, c1)
        s2 = sign2 * rng.uniform(0.5, 1.5, c2)
        t1, t2 = 0.1 * draw(c1), 0.1 * draw(c2)
        cts = [draw((b, n, c2)) for _ in range(4)]
    f32 = [np.asarray(v, np.float32) for v in (g, a1, b1, s1, t1, w2, s2,
                                               t2)]
    idx = _np(jknn.knn(jnp.asarray(f32[0]), k))
    return f32, idx, [c.astype(np.float32) for c in cts]


@pytest.mark.parametrize("cg,c1,c2,k,dup", [(3, 16, 24, 6, False),
                                            (8, 32, 16, 8, False),
                                            (4, 16, 16, 6, True)])
def test_knn_edge2_matches_pallas_interpret(pallas_exact, cg, c1, c2, k,
                                            dup):
    """Kernel 6's plain version against fused_knn_edge2 in its exact mode;
    with duplicate points the boundary of the k nearest falls inside a
    group of copies, so agreement pins the lowest-index rule."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_edge2

    (g, a1, b1, s1, t1, w2, s2, t2), _, _ = _edge2_inputs(
        40 + cg, cg=cg, c1=c1, c2=c2, k=k, dup=dup)
    with jax.default_matmul_precision("float32"):
        want = fused_knn_edge2.__wrapped__(
            *(jnp.asarray(v) for v in (g, a1, b1, s1, t1, w2, s2, t2)), k,
            interpret=True)
    before = knn_edge2.launches
    got = knn_edge2(*(_t(v) for v in (g, a1, b1, s1, t1, w2, s2, t2)), k)
    assert knn_edge2.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dup", [False, True])
def test_edge2_fwd_and_bwd_match_pallas_interpret(dup):
    """Kernels 7 and 8's plain versions against _edge2_fwd_call and
    _edge2_bwd_call (exact mode, interpret): the reductions, then every
    gradient; duplicate points give tied z2 whose max/min cotangent both
    sides split evenly."""
    from dgcnn_tpu.ops.pallas_knn import _edge2_bwd_call, _edge2_fwd_call

    k = 6
    (_, a1, b1, s1, t1, w2, _, _), idx, cts = _edge2_inputs(
        44, k=k, dup=dup)
    jin = [jnp.asarray(v) for v in (a1, b1, s1, t1, w2, idx)]
    with jax.default_matmul_precision("float32"):
        want = _edge2_fwd_call(*jin, k, 0.2, True, interpret=True)
        want_g = _edge2_bwd_call(*jin, want[0], want[1],
                                 *(jnp.asarray(c) for c in cts), k, 0.2,
                                 True, interpret=True)
    tin = [_t(v) for v in (a1, b1, s1, t1, w2)] + [_t(idx)]
    before = (edge2_fwd.launches, edge2_bwd.launches)
    got = edge2_fwd(*tin)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), _np(wv), rtol=1e-5, atol=1e-5)
    got_g = edge2_bwd(*tin, *(_t(v) for v in want[:2]), *map(_t, cts))
    assert (edge2_fwd.launches, edge2_bwd.launches) == before
    for gv, wv in zip(got_g, want_g):
        wv = _np(wv)
        assert np.isfinite(gv.numpy()).all()
        np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(wv).max()))
    if dup:  # the copies' equal z2 tie for the max in every row
        z2 = edge2_z2(*tin)
        assert (z2 == z2.amax(2, keepdim=True)).sum(2).min() >= 2


@pytest.mark.parametrize("ints", [False, True])
def test_edge2_reduce_grads_match_jax_vjp(pallas_exact, ints):
    """Edge2Reduce (forward kernel 7, backward kernel 8) against jax.vjp
    of the JAX package's edge2_reduce on duplicate points.  With integer
    values (and a slope of 1/4) every z2 is exact, so edges of different
    neighbours whose z2 are equal tie in both frameworks, whatever order
    each sums in, and the tie splits agree."""
    from dgcnn_tpu.ops.pallas_knn import edge2_reduce as jedge2

    k, slope = 6, (0.25 if ints else 0.2)
    (_, a1, b1, s1, t1, w2, _, _), idx, cts = _edge2_inputs(
        45, k=k, dup=True, ints=ints)
    with jax.default_matmul_precision("float32"):
        outs, vjp = jax.vjp(
            lambda *p: jedge2(*p, jnp.asarray(idx), k, slope),
            *(jnp.asarray(v) for v in (a1, b1, s1, t1, w2)))
        want = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = [_t(v).requires_grad_(True) for v in (a1, b1, s1, t1, w2)]
    got = Edge2Reduce.apply(*leaves, _t(idx), slope)
    for gv, wv in zip(got, outs):
        np.testing.assert_allclose(gv.detach().numpy(), _np(wv), rtol=1e-5,
                                   atol=1e-5)
    torch.autograd.backward(got, [_t(c) for c in cts])
    for leaf, wv in zip(leaves, want):
        wv = _np(wv)
        assert torch.isfinite(leaf.grad).all()
        np.testing.assert_allclose(leaf.grad.numpy(), wv, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(wv).max()))


def test_two_conv_kernel_wrappers_refuse_devices_without_a_kernel():
    g = torch.zeros((1, 128, 3), device="meta")
    a = torch.zeros((1, 128, 8), device="meta")
    w = torch.zeros((8, 8), device="meta")
    s = torch.zeros(8, device="meta")
    idx = torch.zeros((1, 128, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        knn_edge2(g, a, a, s, s, w, s, s, 4)
    with pytest.raises(ValueError, match="no kernel"):
        edge2_fwd(a, a, s, s, w, idx)
    with pytest.raises(ValueError, match="no kernel"):
        edge2_bwd(a, a, s, s, w, idx, a, a, a, a, a, a)


@pytest.mark.cuda
def test_selection_kernels_at_4096_points_match_plain(cuda_device):
    """Kernels 1, 3 and 5 at the semseg conv5 shapes (N=4096, Cg=Co=64)."""
    g, a, cts = _reduce_inputs(26, b=2, n=4096, c=64, co=64)
    g, a, *cts = (_t(v).to(cuda_device) for v in (g, a, *cts))
    got = knn_reduce(g, a, 20)
    want = knn_reduce_plain(g, a, 20)
    same = (got[0] == want[0]).all(-1)
    assert same.float().mean().item() >= 0.999
    for gv, wv in zip(got[1:], want[1:]):
        assert _row_match(gv, wv)[same].all()
    idx, amax, amin = got[:3]
    da = edge_reduce_bwd(idx, a, amax, amin, *cts)
    assert _row_match(da, edge_reduce_bwd_plain(idx, a, amax, amin,
                                                *cts)).all()
    x, wn, wc, sc, bi = (_t(v).to(cuda_device)
                         for v in _stage_inputs(27, 2, 4096, 64, 64))
    out = edge_conv_eval(x, x, wn, wc, sc, bi, 20)
    ok = _row_match(out, edge_conv_eval_plain(x, x, wn, wc, sc, bi, 20))
    assert ok.float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("cg", [3, 64])
def test_knn_edge2_kernel_matches_plain(cuda_device, cg):
    (g, a1, b1, s1, t1, w2, s2, t2), _, _ = _edge2_inputs(
        46, b=2, n=4096, cg=cg, c1=64, c2=64, k=20)
    args = [_t(v).to(cuda_device) for v in (g, a1, b1, s1, t1, w2, s2, t2)]
    before = knn_edge2.launches
    got = knn_edge2(*args, 20)
    torch.cuda.synchronize()
    assert knn_edge2.launches == before + 1
    ok = _row_match(got, knn_edge2_plain(*args, 20))
    assert ok.float().mean().item() >= 0.999


@pytest.mark.cuda
def test_edge2_kernels_match_plain(cuda_device):
    (g, a1, b1, s1, t1, w2, _, _), _, cts = _edge2_inputs(
        47, b=2, n=4096, cg=64, c1=64, c2=64, k=20)
    g = _t(g).to(cuda_device)
    idx = knn_reduce(g, g, 20)[0]
    tin = [_t(v).to(cuda_device) for v in (a1, b1, s1, t1, w2)] + [idx]
    got = edge2_fwd(*tin)
    for gv, wv in zip(got, edge2_fwd_plain(*tin)):
        assert _row_match(gv, wv).all()
    cts = [_t(c).to(cuda_device) for c in cts]
    grads = edge2_bwd(*tin, *got[:2], *cts)
    want = edge2_bwd_plain(*tin, *got[:2], *cts)
    for gv, wv in zip(grads[:2], want[:2]):
        assert torch.isfinite(gv).all()
        assert _row_match(gv, wv).float().mean().item() >= 0.999
    for gv, wv in zip(grads[2:], want[2:]):
        assert torch.isfinite(gv).all()
        assert ((gv - wv).norm() <= 1e-4 * wv.norm()).item()


@pytest.mark.cuda
def test_edge2_kernels_duplicates_exact(cuda_device):
    """Integer-valued duplicate points: kernel 6, 7 and 8 equal their
    plain versions bit for bit (da1 too: its atomics add integers)."""
    (g, a1, b1, s1, t1, w2, s2, t2), _, cts = _edge2_inputs(
        48, b=2, n=128, cg=3, c1=16, c2=16, k=6, dup=True, ints=True)
    dev = [_t(v).to(cuda_device) for v in (g, a1, b1, s1, t1, w2, s2, t2)]
    assert torch.equal(knn_edge2(*dev, 6, 0.25),
                       knn_edge2_plain(*dev, 6, 0.25))
    idx = knn_reduce(dev[0], dev[1], 6)[0]
    tin = dev[1:6] + [idx]
    got = edge2_fwd(*tin, 0.25)
    for gv, wv in zip(got, edge2_fwd_plain(*tin, 0.25)):
        assert torch.equal(gv, wv)
    cts = [_t(c).to(cuda_device) for c in cts]
    for gv, wv in zip(edge2_bwd(*tin, *got[:2], *cts, 0.25),
                      edge2_bwd_plain(*tin, *got[:2], *cts, 0.25)):
        assert torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1024, 20), (2048, 32), (2048, 40),
                                 (4096, 20), (1024, 65)])
@pytest.mark.parametrize("c", [3, 64])
def test_knn_reduce_kernel_at_the_models_shapes(cuda_device, n, k, c):
    """Kernel 3 at the models' N and k (cls, the Net, partseg, semseg) on
    its tiled route, and at k = 65 on its row-warp route."""
    g, a, _ = _reduce_inputs(60 + k + c, b=4, n=n, c=c, co=64)
    g, a = _t(g).to(cuda_device), _t(a).to(cuda_device)
    got = knn_reduce(g, a, k)
    want = knn_reduce_plain(g, a, k)
    same = (got[0] == want[0]).all(-1)
    assert same.float().mean().item() >= 0.999
    for gv, wv in zip(got[1:], want[1:]):
        assert torch.isfinite(gv).all()
        assert _row_match(gv, wv)[same].all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,c2", [(4096, 20, 64), (2048, 40, 64),
                                    (1024, 20, 72)])
def test_edge2_bwd_kernel_at_the_models_shapes(cuda_device, n, k, c2):
    """Kernel 8 at the semseg and partseg shapes (its tiled route) and at
    C2 = 72 (its row-warp route): against the plain version, and dW2, ds1,
    dt1 the same bits over two calls."""
    (g, a1, b1, s1, t1, w2, _, _), _, cts = _edge2_inputs(
        49 + k, b=2, n=n, cg=64, c1=64, c2=c2, k=k)
    g = _t(g).to(cuda_device)
    idx = knn_reduce(g, g, k)[0]
    tin = [_t(v).to(cuda_device) for v in (a1, b1, s1, t1, w2)] + [idx]
    mx, mn = edge2_fwd(*tin)[:2]
    cts = [_t(c).to(cuda_device) for c in cts]
    grads = edge2_bwd(*tin, mx, mn, *cts)
    again = edge2_bwd(*tin, mx, mn, *cts)
    want = edge2_bwd_plain(*tin, mx, mn, *cts)
    for gv, wv in zip(grads[:2], want[:2]):
        assert torch.isfinite(gv).all()
        assert _row_match(gv, wv).float().mean().item() >= 0.999
    for gv, av, wv in zip(grads[2:], again[2:], want[2:]):
        assert torch.equal(gv, av)
        assert ((gv - wv).norm() <= 1e-4 * wv.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,co", [(1024, 20, 64), (1024, 20, 256),
                                    (2048, 32, 128), (2048, 40, 64),
                                    (4096, 20, 64)])
def test_edge_reduce_bwd_slices_route_matches_atomic_route(cuda_device, n,
                                                           k, co):
    """Kernel 5's slices route (shared-memory adds, every model's N) at
    the models' shapes: within rel 1e-5 of each row's norm of its atomic
    route, and against the plain version."""
    g, a, cts = _reduce_inputs(70 + k, b=2, n=n, c=3, co=co)
    g, a, *cts = (_t(v).to(cuda_device) for v in (g, a, *cts))
    idx, amax, amin, _, _ = knn_reduce(g, a, k)
    got = edge_reduce_bwd(idx, a, amax, amin, *cts)
    old = edge_reduce_bwd(idx, a, amax, amin, *cts, atomic=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    rel = (got - old).norm(dim=-1) / old.norm(dim=-1).clamp_min(1e-30)
    assert rel.max().item() <= 1e-5
    want = edge_reduce_bwd_plain(idx, a, amax, amin, *cts)
    assert _row_match(got, want).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,c2", [(4096, 20, 64), (2048, 40, 64),
                                    (1024, 20, 128), (1024, 129, 64)])
def test_edge2_fwd_tiled_route_bit_equal_to_row_warp(cuda_device, n, k, c2):
    """Kernel 7 at the semseg and partseg shapes (its tiled route) and at
    C2 = 128 and k = 129 (its row-warp route): all four outputs the bits
    of the row-warp route."""
    (g, a1, b1, s1, t1, w2, _, _), _, _ = _edge2_inputs(
        75 + k, b=2, n=n, cg=3, c1=64, c2=c2, k=k)
    idx = knn_plain(_t(g).to(cuda_device), k).int()
    tin = [_t(v).to(cuda_device) for v in (a1, b1, s1, t1, w2)] + [idx]
    got = edge2_fwd(*tin)
    for gv, wv in zip(got, edge2_fwd(*tin, rowwarp=True)):
        assert torch.isfinite(gv).all()
        assert torch.equal(gv, wv)


@pytest.mark.parametrize("dup", [False, True])
def test_knn_matches_knn_pallas_at_k40(dup):
    """Kernel 11's plain version (and ``knn`` on CPU tensors) against
    knn_pallas in interpret mode at the partseg k=40, N=256; with
    duplicate points (every point four times) the k-th neighbour falls
    inside a group of copies, so agreement pins the lowest-index rule."""
    from dgcnn_tpu.ops.pallas_knn import knn_pallas

    x = (_duplicate_cloud(50, n=256, c=3) if dup else
         np.random.default_rng(50).standard_normal((2, 256, 3)).astype(
             np.float32))
    want = _np(knn_pallas.__wrapped__(jnp.asarray(x), 40, interpret=True))
    before = knn.launches
    got = knn(_t(x), 40)
    assert knn.launches == before  # CPU: the plain version
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(knn_plain(_t(x), 40).numpy(), want)


@pytest.mark.parametrize("mode", [{}, {"knn_only": True},
                                  {"disp_only": True}])
def test_get_graph_feature_matches_jax(mode):
    """The edge features of every mode, [neighbour, centre] order, from
    the kNN (k=8) and from given indices."""
    rng = np.random.default_rng(51)
    x = rng.standard_normal((2, 128, 6)).astype(np.float32)
    want = _np(jgraph.get_graph_feature(jnp.asarray(x), 8, **mode))
    np.testing.assert_array_equal(get_graph_feature(_t(x), 8, **mode).numpy(),
                                  want)
    idx = rng.integers(0, 128, (2, 128, 5)).astype(np.int32)
    want = _np(jgraph.get_graph_feature(jnp.asarray(x), 5, idx=jnp.asarray(
        idx), **mode))
    np.testing.assert_array_equal(
        get_graph_feature(_t(x), 5, idx=_t(idx), **mode).numpy(), want)


def _banded_graph(seed, b=2, n=256, c=3):
    """Points spread along channel 0 (a permuted grid of spacing 6/N) with
    noise of 0.3 elsewhere: the sorted PC1 keys of the two frameworks lie
    far more than rel 1e-5 apart, so both sort the same way."""
    rng = np.random.default_rng(seed)
    g = 0.3 * rng.standard_normal((b, n, c))
    g[:, :, 0] = np.stack([rng.permutation(np.linspace(-3, 3, n))
                           for _ in range(b)])
    return g.astype(np.float32)


def test_banded_order_and_windows_match_jax():
    """pc1_key within rel 1e-5 of JAX's, the same sorted order and its
    inverse, band_starts equal, and the tile rule of pallas_banded."""
    from dgcnn_tpu.ops import pallas_banded as jband
    from dgcnn_tpu.ops.pallas_knn import TILE_N, _pick_tile

    for c in (3, 64):
        g = _banded_graph(52 + c, c=c)
        with jax.default_matmul_precision("float32"):
            want = _np(jband.pc1_key(jnp.asarray(g)))
        got = pc1_key(_t(g)).numpy()
        np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        # the key's sign is free; both frameworks iterate from ones
        assert np.sign(got[0, 0]) == np.sign(want[0, 0])
        order = sorted_order(_t(g))
        np.testing.assert_array_equal(order.numpy(), np.argsort(want, 1))
        inv = inverse_order(order).numpy()
        np.testing.assert_array_equal(inv, np.argsort(np.argsort(want, 1), 1))
    for n, band in [(256, 128), (1024, 256), (2048, 512), (4096, 1024),
                    (640, 384), (2048, 2048)]:
        tile = min(_pick_tile(n), band)
        while n % tile:
            tile -= TILE_N
        assert band_tile(n, band) == tile
        np.testing.assert_array_equal(band_starts(n, tile, band),
                                      jband.band_starts(n, tile, band))
        assert banded_applicable(n, band) == jband.banded_applicable(n, band)
    assert (band_tile(2048, 512), band_tile(4096, 1024)) == (256, 128)


@pytest.mark.parametrize("cg,co,k", [(3, 32, 8), (16, 24, 6)])
def test_banded_edge_conv_eval_matches_pallas_interpret(pallas_exact, cg,
                                                        co, k):
    """Kernel 12's plain version against banded_edge_conv_eval (f32
    selection, interpret) at N=256, band 128 (tile 128), on equal orders;
    with band = N both give the exact stage."""
    from dgcnn_tpu.ops.pallas_banded import banded_edge_conv_eval as jfn
    from dgcnn_tpu.ops.pallas_banded import pc1_key as jkey

    g = _banded_graph(54 + cg, c=cg)
    _, wn, wc, sc, bi = _stage_inputs(55 + cg, 2, 256, cg, co)
    args = (g, g, wn, wc, sc, bi)
    with jax.default_matmul_precision("float32"):
        want_order = np.argsort(_np(jkey(jnp.asarray(g))), 1)
    np.testing.assert_array_equal(sorted_order(_t(g)).numpy(), want_order)
    for band in (128, 256):
        with jax.default_matmul_precision("float32"):
            want = _np(jfn.__wrapped__(*(jnp.asarray(a) for a in args), k,
                                       band, select_dtype=jnp.float32,
                                       interpret=True))
        before = banded_edge_conv_eval.launches
        got = banded_edge_conv_eval(*(_t(a) for a in args), k, band)
        assert banded_edge_conv_eval.launches == before
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    exact = edge_conv_eval_plain(*(_t(a) for a in args), k)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cg,c1,c2,k", [(3, 16, 24, 6), (8, 32, 16, 8)])
def test_banded_knn_edge2_matches_pallas_interpret(pallas_exact, cg, c1, c2,
                                                   k):
    """Kernel 13's plain version against banded_knn_edge2 in the exact
    mode (DGCNN_TPU_PALLAS_EXACT=1, interpret) at N=256, band 128, on equal
    orders; with band = N both give the exact block."""
    from dgcnn_tpu.ops.pallas_banded import banded_knn_edge2 as jfn

    from dgcnn_tpu.ops.pallas_banded import pc1_key as jkey

    (_, a1, b1, s1, t1, w2, s2, t2), _, _ = _edge2_inputs(
        56 + cg, n=256, cg=cg, c1=c1, c2=c2, k=k)
    g = _banded_graph(57 + cg, c=cg)
    args = (g, a1, b1, s1, t1, w2, s2, t2)
    with jax.default_matmul_precision("float32"):
        want_order = np.argsort(_np(jkey(jnp.asarray(g))), 1)
    np.testing.assert_array_equal(sorted_order(_t(g)).numpy(), want_order)
    for band in (128, 256):
        with jax.default_matmul_precision("float32"):
            want = _np(jfn.__wrapped__(*(jnp.asarray(a) for a in args), k,
                                       band, interpret=True))
        assert want.dtype == np.float32
        before = banded_knn_edge2.launches
        got = banded_knn_edge2(*(_t(a) for a in args), k, band)
        assert banded_knn_edge2.launches == before
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    exact = knn_edge2_plain(*(_t(a) for a in args), k)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_banded_plain_versions_share_an_order():
    """Given an order, the banded plain versions window that order: with
    the identity order and band = N they are the exact plain versions;
    their windows hold every row of their tile."""
    g = _banded_graph(58, c=4)
    _, wn, wc, sc, bi = _stage_inputs(59, 2, 256, 4, 16)
    ident = torch.arange(256).expand(2, 256).contiguous()
    args = [_t(a) for a in (g, g, wn, wc, sc, bi)]
    assert torch.equal(
        banded_edge_conv_eval_plain(*args, 6, 256, order=ident),
        edge_conv_eval_plain(*args, 6))
    (_, a1, b1, s1, t1, w2, s2, t2), _, _ = _edge2_inputs(60, n=256, cg=4)
    eargs = [_t(a) for a in (g, a1, b1, s1, t1, w2, s2, t2)]
    assert torch.equal(banded_knn_edge2_plain(*eargs, 6, 256, order=ident),
                       knn_edge2_plain(*eargs, 6))
    for n, band in [(256, 128), (2048, 512), (4096, 1024), (640, 384)]:
        tile = band_tile(n, band)
        for t, start in enumerate(band_starts(n, tile, band)):
            assert start <= t * tile and (t + 1) * tile <= start + band


def test_new_kernel_wrappers_refuse_devices_without_a_kernel():
    g = torch.zeros((1, 256, 3), device="meta")
    a = torch.zeros((1, 256, 8), device="meta")
    w = torch.zeros((8, 8), device="meta")
    s = torch.zeros(8, device="meta")
    order = torch.zeros((1, 256), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        knn(g, 4)
    with pytest.raises(ValueError, match="no kernel"):
        banded_knn_edge2(g, a, a, s, s, w, s, s, 4, 128, order=order)
    w3 = torch.zeros((3, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        banded_edge_conv_eval(g, g, w3, w3, s, s, 4, 128, order=order)


@pytest.mark.cuda
def test_knn_kernel_matches_plain(cuda_device):
    """Kernel 11 at the TransformNet graph's shape (N=2048, C=3, k=40), at
    N=4096, and exact on integer duplicate points."""
    rng = np.random.default_rng(61)
    for n in (2048, 4096):
        x = _t(rng.standard_normal((2, n, 3)).astype(np.float32)).to(
            cuda_device)
        before = knn.launches
        got = knn(x, 40)
        torch.cuda.synchronize()
        assert knn.launches == before + 1 and got.dtype == torch.int64
        # neighbour sets: two summation orders may swap the ranks of
        # neighbours whose scores lie a few rounding steps apart
        want = knn_plain(x, 40)
        same = (got.sort(-1).values == want.sort(-1).values).all(-1)
        assert same.float().mean().item() >= 0.999
    base = rng.integers(-4, 5, (2, 512, 3))
    x = _t(np.concatenate([base] * 4, 1).astype(np.float32)).to(cuda_device)
    assert torch.equal(knn(x, 40), knn_plain(x, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("n,band,cg", [(2048, 512, 3), (2048, 512, 64),
                                       (4096, 1024, 64)])
def test_banded_kernels_match_plain(cuda_device, n, band, cg):
    """Kernels 12 and 13 against their plain versions on one shared
    order."""
    g = _t(_banded_graph(62, n=n, c=cg)).to(cuda_device)
    order = sorted_order(g)
    (_, a1, b1, s1, t1, w2, s2, t2), _, _ = _edge2_inputs(
        63, n=n, cg=cg, c1=64, c2=64, k=20)
    args = [_t(v).to(cuda_device) for v in (a1, b1, s1, t1, w2, s2, t2)]
    before = banded_knn_edge2.launches
    got = banded_knn_edge2(g, *args, 20, band, order=order)
    torch.cuda.synchronize()
    assert banded_knn_edge2.launches == before + 1
    ok = _row_match(got, banded_knn_edge2_plain(g, *args, 20, band,
                                                order=order))
    assert ok.float().mean().item() >= 0.999
    _, wn, wc, sc, bi = (_t(v).to(cuda_device)
                         for v in _stage_inputs(64, 2, n, cg, 64))
    got = banded_edge_conv_eval(g, g, wn, wc, sc, bi, 20, band, order=order)
    ok = _row_match(got, banded_edge_conv_eval_plain(g, g, wn, wc, sc, bi, 20,
                                                     band, order=order))
    assert ok.float().mean().item() >= 0.999


def _row_warp(banded_fn, graph, *args, k, slope=0.2):
    """Kernel 1's or 6's row-warp route over the whole cloud: the banded
    entry at band = N in the identity order (every window starts at 0)."""
    b, n = graph.shape[:2]
    order = torch.arange(n, device=graph.device).repeat(b, 1)
    return banded_fn(graph, *args, k, n, slope, order=order)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,cg,co", [(1024, 20, 3, 64), (1024, 20, 128, 256),
                                       (2048, 32, 64, 128), (2048, 40, 64, 64),
                                       (4096, 20, 64, 64), (1024, 65, 64, 64)])
def test_edge_conv_eval_tiled_route_matches_row_warp(cuda_device, n, k, cg,
                                                     co):
    """Kernel 1's tiled route (k <= 64) bit-equal to its row-warp route,
    on random features and on integer duplicate points; at k = 65 both
    are the row-warp kernel."""
    x, wn, wc, sc, bi = (_t(v).to(cuda_device)
                         for v in _stage_inputs(65 + k, 2, n, cg, co))
    got = edge_conv_eval(x, x, wn, wc, sc, bi, k)
    assert torch.equal(got, _row_warp(banded_edge_conv_eval, x, x, wn, wc,
                                      sc, bi, k=k))
    rng = np.random.default_rng(k)
    g = _t(np.concatenate([rng.integers(-2, 3, (2, n // 4, 3))] * 4, 1)
           .astype(np.float32)).to(cuda_device)
    xi, wni, wci, bii = (_t(rng.integers(-2, 3, s).astype(np.float32))
                         .to(cuda_device) for s in ((2, n, 8), (8, co),
                                                    (8, co), (co,)))
    sci = torch.tensor([2.0, -1.0, 0.5, 1.0] * (co // 4), device=cuda_device)
    got = edge_conv_eval(g, xi, wni, wci, sci, bii, k)
    assert torch.equal(got, edge_conv_eval_plain(g, xi, wni, wci, sci, bii,
                                                 k))
    assert torch.equal(got, _row_warp(banded_edge_conv_eval, g, xi, wni, wci,
                                      sci, bii, k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,cg,c2", [(4096, 20, 3, 64), (4096, 20, 64, 64),
                                       (2048, 40, 3, 128), (2048, 32, 3, 128),
                                       (1024, 65, 64, 64)])
def test_knn_edge2_tiled_route_matches_row_warp(cuda_device, n, k, cg, c2):
    """Kernel 6's tiled route (k <= 64, C1 <= 64, C2 <= 128) bit-equal to
    its row-warp route, on random inputs and on integer duplicate points
    (exact against the plain version too); at k = 65 both are the
    row-warp kernel."""
    for ints in (False, True):
        f32, _, _ = _edge2_inputs(66 + k, b=2, n=n, cg=cg, c1=64, c2=c2,
                                  k=k, dup=ints, ints=ints)
        args = [_t(v).to(cuda_device) for v in f32]
        slope = 0.25 if ints else 0.2
        got = knn_edge2(*args, k, slope)
        assert torch.equal(got, _row_warp(banded_knn_edge2, *args, k=k,
                                          slope=slope))
        if ints:
            assert torch.equal(got, knn_edge2_plain(*args, k, slope))
