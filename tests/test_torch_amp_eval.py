"""The port's AMP (bf16) eval of DGCNNCls against the JAX package's
default mode, on the CPU at small sizes, and the reverse neighbour lists
of kernels 5 and 8's pull routes.

The JAX side runs its fused Pallas path in interpret mode with
``DGCNN_TPU_PALLAS_EXACT`` unset (its AMP default), under
``jax.default_matmul_precision("float32")`` so that the kernels' products
of f32 operands are f32, as on its accelerator.  The port's side is the
plain versions of the AMP kernels (``ops/amp_select.py``,
``edge_conv_eval_amp_plain``, ``conv_pool_amp_plain``), which CPU tensors
take.  Each tolerance is stated where it is held:

- the packed keys: bit-equal on the same scores;
- v2's indices through the AMP scores: equal rows on every integer and
  degenerate cloud; on random clouds the same neighbour sets on >= 0.99
  of the rows, every other row a near tie (the two frameworks sum the
  score products in other orders, which can move a score across a
  quantization step);
- a stage's bf16 output: within one bf16 ulp on >= 99.9% of the rows, and
  bit-equal on integer duplicate points (every product and sum exact);
- the pooled conv5 rows: rel 1e-5;
- the model's logits: the same argmax, and max|diff| at most a tenth of
  the JAX package's own AMP-vs-exact max|diff| on the same input.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNCls
from dgcnn_tpu_torch.ops.amp_select import (
    EXACT_ENV,
    amp_scores,
    pack_keys,
    use_amp_eval,
    use_amp_train,
    v2_indices,
)
from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool, conv_pool_amp_plain
from dgcnn_tpu_torch.ops.edge_conv_kernel import (
    edge_conv_eval,
    edge_conv_eval_amp_plain,
)
from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import (
    edge_reduce_bwd_plain,
    reverse_lists,
)
from dgcnn_tpu_torch.ops.knn_reduce_kernel import knn_reduce_plain

STAGES = [(3, 64), (64, 64), (64, 128), (128, 256)]


@pytest.fixture
def amp_env(monkeypatch):
    """The JAX package's AMP default: its fused path forced on (interpret
    mode on the CPU) and the exact pin unset."""
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.delenv(EXACT_ENV, raising=False)
    monkeypatch.delenv("DGCNN_TPU_EXTRACT", raising=False)


def _np(x):
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x)


def _clouds(case: str, b: int, n: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.standard_normal((b, n, c)).astype(np.float32)
    if case == "integer":  # duplicated grid points: exact score ties
        base = rng.integers(-4, 5, (b, n // 4, c)).astype(np.float32)
        return np.concatenate([base] * 4, axis=1)
    if case == "all_tied":  # every point the same: every score 0
        return np.ones((b, n, c), np.float32)
    # centred points, whose row minimum sits at the grid's last step
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    return x - x.mean(axis=1, keepdims=True)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps, element by element (same signs)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.parametrize("case", ["random", "integer", "all_tied",
                                  "rowmin_edge"])
def test_pack_keys_bit_equal_to_pallas(case):
    """The packed keys of the same scores: bit-equal to ``_pack_keys``."""
    from dgcnn_tpu.ops.pallas_knn import _pack_keys, _scores

    x = jnp.asarray(_clouds(case, 1, 256, 3, 11)[0])
    with jax.default_matmul_precision("float32"):
        scores = np.asarray(_scores(x, x, exact=False))
    want = np.asarray(_pack_keys(jnp.asarray(scores), 256))
    got = pack_keys(torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() > np.iinfo(np.int32).min  # above the sentinel
    assert all(len(np.unique(r)) == 256 for r in got)


@pytest.mark.parametrize("case", ["random", "integer", "all_tied",
                                  "rowmin_edge"])
def test_v2_indices_match_pallas_v2(case, amp_env):
    """v2 through the AMP scores against the Pallas v2 (kernel 3's AMP
    form) on the same clouds."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    x = _clouds(case, 2, 256, 3, 12)
    a = np.random.default_rng(13).standard_normal((2, 256, 8)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(fused_knn_reduce(
            jnp.asarray(x), jnp.asarray(a), 16, select_dtype=jnp.bfloat16,
            interpret=True)[0])
    xt = torch.from_numpy(x)
    scores = amp_scores(xt, xt).numpy()
    got = v2_indices(torch.from_numpy(scores), 16).numpy()
    if case in ("integer", "all_tied"):
        np.testing.assert_array_equal(got, want)
        return
    # elsewhere a row may differ only where its 16th and 17th neighbours
    # are a near tie: the columns the two lists disagree on score within
    # 1e-5 of the row's scale of its 16th score
    assert (np.sort(got, -1) == np.sort(want, -1)).all(-1).mean() >= 0.99
    for b, i in zip(*np.nonzero((np.sort(got, -1) != np.sort(want, -1))
                                .any(-1))):
        row = scores[b, i]
        kth = np.sort(row)[::-1][15]
        odd = np.setxor1d(got[b, i], want[b, i])
        assert np.abs(row[odd] - kth).max() <= 1e-5 * np.abs(row).max()


def _stage_args(cin: int, co: int, seed: int):
    rng = np.random.default_rng(seed)
    wn = (rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32)
    wc = (rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32)
    s = (rng.uniform(0.5, 1.5, co) * np.where(rng.random(co) < 0.15, -1, 1)
         ).astype(np.float32)
    t = (0.1 * rng.standard_normal(co)).astype(np.float32)
    return wn, wc, s, t


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cin,co", STAGES)
def test_edge_conv_amp_stage_matches_pallas(cin, co, dtype, n, amp_env):
    """Each DGCNNCls stage shape (v3 project-first, v2 project-first, v2
    select-x) on f32 and bf16 inputs, k = 20: within one bf16 ulp of
    ``fused_edge_conv_eval(select_dtype=bf16)`` on >= 99.9% of rows."""
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    rng = np.random.default_rng(cin + co + n)
    x = rng.standard_normal((2, n, cin)).astype(np.float32)
    xj = jnp.asarray(x)
    if dtype == "bf16":
        xj = xj.astype(jnp.bfloat16)
    args = _stage_args(cin, co, n)
    with jax.default_matmul_precision("float32"):
        want = fused_edge_conv_eval(xj, xj, *map(jnp.asarray, args), 20,
                                    select_dtype=jnp.bfloat16,
                                    interpret=True)
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(_np(xj))
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    got = edge_conv_eval(xt, xt, *map(torch.from_numpy, args), 20, amp=True)
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, co)
    want_t = torch.from_numpy(_np(want)).to(torch.bfloat16)
    rows = (_ulps(got, want_t).amax(-1) <= 1).float().mean().item()
    assert rows >= 0.999, rows


@pytest.mark.parametrize("cin,co", STAGES)
def test_edge_conv_amp_duplicates_exact(cin, co, amp_env):
    """Integer duplicate points and integer weights: every product and sum
    is exact, so v3's class means (duplicates and equidistant grid points
    tie) and v2's lowest-index order give the Pallas kernel's bits."""
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    rng = np.random.default_rng(cin * co)
    base = rng.integers(-3, 4, (2, 32, cin))
    x = np.concatenate([base] * 4, axis=1).astype(np.float32)
    wn = rng.integers(-2, 3, (cin, co)).astype(np.float32)
    wc = rng.integers(-2, 3, (cin, co)).astype(np.float32)
    s = np.tile(np.array([2.0, -1.0, 0.5, 1.0], np.float32), co // 4)
    t = rng.integers(-2, 3, co).astype(np.float32)
    xj = jnp.asarray(x)
    if cin > 3:  # the later stages take the bf16 stage outputs
        xj = xj.astype(jnp.bfloat16)
    with jax.default_matmul_precision("float32"):
        want = fused_edge_conv_eval(xj, xj, *map(jnp.asarray, (wn, wc, s, t)),
                                    20, select_dtype=jnp.bfloat16,
                                    interpret=True)
    xt = torch.from_numpy(x)
    if cin > 3:
        xt = xt.to(torch.bfloat16)
    got = edge_conv_eval(xt, xt, *map(torch.from_numpy, (wn, wc, s, t)), 20,
                         amp=True)
    assert torch.equal(got, torch.from_numpy(_np(want)).to(torch.bfloat16))


@pytest.mark.parametrize("n", [128, 256])
def test_conv_pool_amp_matches_pallas(n):
    """conv5 + pool in bf16 operands, f32 sums split by split: rel 1e-5 of
    ``fused_conv_pool(compute_dtype=bf16)``."""
    from dgcnn_tpu.ops.pallas_pool import fused_conv_pool

    rng = np.random.default_rng(n)
    xs = [rng.standard_normal((2, n, c)).astype(np.float32)
          for c in (64, 64, 128, 256)]
    w = (rng.standard_normal((512, 128)) / np.sqrt(512)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    t = (0.1 * rng.standard_normal(128)).astype(np.float32)
    xj = tuple(jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(fused_conv_pool(xj, jnp.asarray(w), jnp.asarray(s),
                                          jnp.asarray(t),
                                          compute_dtype=jnp.bfloat16,
                                          interpret=True))
    xt = tuple(torch.from_numpy(_np(x)).to(torch.bfloat16) for x in xj)
    got = conv_pool(xt, *map(torch.from_numpy, (w, s, t)), amp=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the plain version is what the wrapper ran
    assert torch.equal(got, conv_pool_amp_plain(
        xt, *map(torch.from_numpy, (w, s, t))))


def _flax_cls(n: int, seed: int):
    from test_torch_port_model import flax_cls_variables

    return flax_cls_variables(emb_dims=64, k=20, n=n, seed=seed)


@pytest.mark.parametrize("n,seed", [(128, 0), (256, 1)])
def test_dgcnn_cls_amp_matches_jax_amp(n, seed, amp_env, monkeypatch):
    """The whole AMP eval on weights carried across by convert.py: the same
    argmax as the JAX package's AMP forward, and logits within a tenth of
    its AMP-vs-exact max|diff|."""
    fmodel, variables = _flax_cls(n, seed)
    model = DGCNNCls(emb_dims=64, k=20, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    x = np.random.default_rng(seed + 5).standard_normal((2, n, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        amp_j = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                        train=False))
        monkeypatch.setenv(EXACT_ENV, "1")
        exact_j = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                          train=False))
    gap = np.abs(amp_j - exact_j).max()
    with torch.no_grad():
        amp_t = model(torch.from_numpy(x), amp=True).numpy()
    assert gap > 0
    np.testing.assert_array_equal(amp_t.argmax(-1), amp_j.argmax(-1))
    assert np.abs(amp_t - amp_j).max() <= gap / 10, (
        np.abs(amp_t - amp_j).max(), gap)


def test_exact_pin_gives_the_exact_path(monkeypatch):
    """DGCNN_TPU_PALLAS_EXACT: the default forward is the exact path, bit
    for bit; the mode switch's rules (AMP by default on the card only,
    the shapes the kernels refuse and k > 64 exact either way)."""
    model = DGCNNCls(emb_dims=64, k=20, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 128, 3)).astype(np.float32))
    monkeypatch.setenv(EXACT_ENV, "1")
    with torch.no_grad():
        pinned = model(x)
        exact = model(x, amp=False)
        amp = model(x, amp=True)
    assert torch.equal(pinned, exact)
    assert not torch.equal(amp, exact)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not use_amp_eval(None, cuda, 1024, 20)
    monkeypatch.delenv(EXACT_ENV)
    assert use_amp_eval(None, cuda, 1024, 20)
    assert not use_amp_eval(None, cpu, 1024, 20)
    assert use_amp_eval(True, cpu, 1024, 20)
    assert not use_amp_eval(False, cuda, 1024, 20)
    assert not use_amp_eval(None, cuda, 1000, 20)
    assert not use_amp_eval(True, cuda, 1024, 65)
    # training takes the twin switch (tests/test_torch_amp_train.py holds
    # its AMP step; the fusion Net's refusal is held in
    # tests/test_torch_amp_net.py)
    assert use_amp_train(True, cpu, 1024, 20)
    assert not use_amp_train(True, cuda, 1024, 65)


def test_reverse_lists_match_numpy():
    """The reverse neighbour lists' plain version against numpy: each
    point's in-edges e = (b N + i) k + t in ascending order."""
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 64, (3, 64, 5)).astype(np.int32)
    off, lst = reverse_lists(torch.from_numpy(idx))
    target = (idx + 64 * np.arange(3)[:, None, None]).reshape(-1)
    for g in range(3 * 64):
        want = np.flatnonzero(target == g)
        np.testing.assert_array_equal(lst[off[g]:off[g + 1]].numpy(), want)
    assert off[-1] == idx.size


def test_pull_sum_is_the_ordered_scatter():
    """Kernel 5's pull route emulated: each da[j] summed from zero over its
    list in order, every addend formed as the kernel forms it, is bit-equal
    to an f32 np.add.at over the edges in ascending order, and within rel
    1e-5 of each row's norm of the plain version."""
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.standard_normal((2, 128, 3)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 128, 16)).astype(
        np.float32))
    k = 12
    idx, amax, amin, _, _ = knn_reduce_plain(g, a, k)
    cts = [rng.standard_normal((2, 128, 16)).astype(np.float32)
           for _ in range(4)]
    an, ia = a.numpy(), idx.numpy()
    vmax, vmin = amax.numpy()[:, :, None], amin.numpy()[:, :, None]
    sel = np.stack([an[b][ia[b]] for b in range(2)])  # (B, N, k, C)
    gmax = cts[0][:, :, None] / (sel == vmax).sum(2, keepdims=True).astype(
        np.float32)
    gmin = cts[1][:, :, None] / (sel == vmin).sum(2, keepdims=True).astype(
        np.float32)
    w = ((np.where(sel == vmax, gmax, np.float32(0))
          + np.where(sel == vmin, gmin, np.float32(0)))
         + cts[2][:, :, None]) + sel * (np.float32(2) * cts[3][:, :, None])
    w = w.astype(np.float32).reshape(-1, 16)
    want = np.zeros((2 * 128, 16), np.float32)
    target = (ia + 128 * np.arange(2)[:, None, None]).reshape(-1)
    np.add.at(want, target, w)
    off, lst = reverse_lists(idx.int())
    got = np.zeros_like(want)
    for j in range(2 * 128):
        acc = np.zeros(16, np.float32)
        for e in lst[off[j]:off[j + 1]].numpy():
            acc = acc + w[e]
        got[j] = acc
    np.testing.assert_array_equal(got, want)
    plain = edge_reduce_bwd_plain(idx, a, amax, amin,
                                  *map(torch.from_numpy, cts))
    plain = plain.reshape(-1, 16).numpy()
    rel = (np.linalg.norm(got - plain, axis=-1)
           / np.linalg.norm(plain, axis=-1).clip(1e-30))
    assert rel.max() <= 1e-5, rel.max()


def test_other_models_stay_exact(monkeypatch):
    """The fusion Net's default forward on the CPU stays exact: with the
    variable unset, it hands kernel 6 (its PositionEmbedding's
    TransformNet) and kernel 1 (its backbone) amp=False and runs kernel 2's
    plain pool; with amp=True the whole forward switches, kernels 1, 6 and
    2 to their AMP forms at once."""
    from dgcnn_tpu_torch.models import Net, dgcnn, nn_layers

    monkeypatch.delenv(EXACT_ENV, raising=False)
    modes = []

    def spy(fn):
        def wrapped(*args, amp=False, **kwargs):
            modes.append((fn.__name__, amp))
            return fn(*args, amp=amp, **kwargs)
        return wrapped

    monkeypatch.setattr(dgcnn, "knn_edge2", spy(dgcnn.knn_edge2))
    monkeypatch.setattr(dgcnn, "conv_pool", spy(dgcnn.conv_pool))
    monkeypatch.setattr(nn_layers, "edge_conv_eval",
                        spy(nn_layers.edge_conv_eval))
    net = Net(emb_dim=32, k=8, n_heads=2, n_blocks=1, ff_dims=32,
              nclasses=5, device="cpu",
              generator=torch.Generator().manual_seed(71))
    pts = torch.randn(2, 128, 3, generator=torch.Generator().manual_seed(72))
    with torch.no_grad():
        net(pts, torch.eye(16)[[1, 4]])
    assert sorted(modes) == [("edge_conv_eval", False)] * 4 + [
        ("knn_edge2", False)]
    modes.clear()
    with torch.no_grad():
        net(pts, torch.eye(16)[[1, 4]], amp=True)
    assert sorted(modes) == [("conv_pool", True)] + [
        ("edge_conv_eval", True)] * 4 + [("knn_edge2", True)]
