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
    conv_pool,
    conv_pool_plain,
    edge_conv_eval,
    edge_conv_eval_plain,
    edge_conv_fused,
    edge_conv_naive,
    fold_bn,
    gather_neighbors,
    global_max,
    global_mean,
    knn,
    pairwise_neg_sqdist,
)

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
