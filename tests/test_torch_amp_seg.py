"""The port's AMP (bf16) eval of DGCNNSemSeg and DGCNNPartSeg and its
extraction variants against the JAX package, on the CPU at small sizes.

The JAX side runs its fused Pallas path in interpret mode
(``DGCNN_TPU_PALLAS=1``) under ``jax.default_matmul_precision("float32")``,
with ``DGCNN_TPU_PALLAS_EXACT`` and ``DGCNN_TPU_EXTRACT`` as each test
sets them.  Its kernels read both variables when they trace, and a jitted
function traced once at a shape keeps that trace: every test starts and
ends with ``jax.clear_caches()``, and a test that changes a variable
between two JAX calls clears the caches in between.  The port's side is
the plain versions, which CPU tensors take.  Each tolerance is stated
where it is held:

- the variant rules: ``extract_version`` equal to ``_extract_version``;
- a kernel's bf16 output: within one bf16 ulp on >= 99.9% of the rows;
  bit-equal on integer duplicate points where every product and sum is
  exact (slope 1/4, power-of-two scales, and a second conv with one
  power of two a column, so each z2 is one exact product);
- the exact v2 forms: rel 1e-5 of each row's norm on random clouds,
  bit-equal on integer duplicates;
- conv6 / conv3 + pool: rel 1e-5;
- the models' logits: the same argmax on >= 99.5% of the points, and
  max|diff| at most a tenth of the JAX package's own AMP-vs-exact
  max|diff| on the same input.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNPartSeg, DGCNNSemSeg
from dgcnn_tpu_torch.ops.amp_select import (
    EXACT_ENV,
    EXTRACT_ENV,
    VARIANTS,
    extract_version,
    require_ported,
    stage_variant,
)
from dgcnn_tpu_torch.ops.banded import banded_edge_conv_eval, banded_knn_edge2
from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool, conv_pool_amp_plain
from dgcnn_tpu_torch.ops.edge2_kernel import (
    knn_edge2,
    knn_edge2_amp_plain,
    knn_edge2_plain,
)
from dgcnn_tpu_torch.ops.edge_conv_kernel import edge_conv_eval
from dgcnn_tpu_torch.ops.knn import pairwise_neg_sqdist

from test_torch_banded_tiled import _cloud, _jax_order, _sorted
from test_torch_port_partseg import flax_partseg_variables
from test_torch_port_semseg import flax_semseg_variables

F32 = "float32"


@pytest.fixture
def jax_env(monkeypatch):
    """The JAX package's fused path forced on (interpret mode on the CPU),
    both variables unset, and no trace of an earlier setting."""
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.delenv(EXACT_ENV, raising=False)
    monkeypatch.delenv(EXTRACT_ENV, raising=False)
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


def _np(x):
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x)


def _ulp_rows(got: torch.Tensor, want) -> float:
    """Share of rows whose bf16 values are all within one ulp of
    ``want``'s (a JAX or torch array)."""
    w = torch.from_numpy(_np(want)).to(torch.bfloat16)
    d = (got.view(torch.int16).int() - w.view(torch.int16).int()).abs()
    return (d.amax(-1) <= 1).float().mean().item()


def _row_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), _np(want).astype(np.float64)
    return (np.linalg.norm(got - want, axis=-1)
            / np.linalg.norm(want, axis=-1).clip(1e-30)).max()


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("extract", [None, "v1", "v2", "v3", "v4"])
@pytest.mark.parametrize("exact", [None, "1"])
def test_extract_version_matches_jax(extract, exact, monkeypatch):
    """``extract_version`` is ``_extract_version`` over both variables."""
    from dgcnn_tpu.ops.pallas_knn import _extract_version

    for name, value in ((EXTRACT_ENV, extract), (EXACT_ENV, exact)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for default in VARIANTS:
        for allow in (VARIANTS, ("v1", "v2")):
            assert (extract_version(default, allow)
                    == _extract_version(default, allow))


def test_unported_variants_raise(monkeypatch):
    """The four ported combinations pass; the exact v3 (the variable) and
    the AMP v1 (the exact pin with amp=True) raise, naming their cause,
    in the wrappers too, before any launch (meta tensors stand for the
    card's)."""
    monkeypatch.delenv(EXTRACT_ENV, raising=False)
    monkeypatch.delenv(EXACT_ENV, raising=False)
    assert stage_variant(False, "v3") == "v1"
    assert stage_variant(True, "v3") == "v3"
    for amp, variant in [(False, "v1"), (False, "v2"), (True, "v2"),
                         (True, "v3")]:
        require_ported("knn_edge2", amp, variant)
    monkeypatch.setenv(EXTRACT_ENV, "v3")
    assert stage_variant(False, "v1") == "v3"
    with pytest.raises(ValueError, match=f"{EXTRACT_ENV}=v3"):
        require_ported("knn_edge2", False, "v3")
    g = torch.empty((1, 128, 3), device="meta")
    a = torch.empty((1, 128, 64), device="meta")
    w, s = torch.empty((64, 64), device="meta"), torch.empty(64,
                                                             device="meta")
    with pytest.raises(ValueError, match="exact mode's v3"):
        knn_edge2(g, a, a, s, s, w, s, s, 20)
    with pytest.raises(ValueError, match="exact mode's v3"):
        banded_edge_conv_eval(a, a, w, w, s, s, 20, 128)
    monkeypatch.delenv(EXTRACT_ENV)
    monkeypatch.setenv(EXACT_ENV, "1")
    assert stage_variant(True, "v3") == "v1"
    with pytest.raises(ValueError, match=f"AMP mode's v1 \\({EXACT_ENV}"):
        edge_conv_eval(a, a, w, w, s, s, 20, amp=True)
    with pytest.raises(ValueError, match="AMP mode's v1"):
        banded_knn_edge2(g, a, a, s, s, w, s, s, 20, 128, amp=True)


# ------------------------------------------------------------- kernel 6
def _edge2_args(n: int, c1: int, c2: int, seed: int, b: int = 2):
    rng = np.random.default_rng(seed)
    a1 = rng.standard_normal((b, n, c1)).astype(np.float32)
    b1 = rng.standard_normal((b, n, c1)).astype(np.float32)
    s1 = (rng.uniform(0.5, 1.5, c1) * np.where(rng.random(c1) < 0.15, -1, 1)
          ).astype(np.float32)
    t1 = (0.1 * rng.standard_normal(c1)).astype(np.float32)
    w2 = (rng.standard_normal((c1, c2)) / np.sqrt(c1)).astype(np.float32)
    s2 = (rng.uniform(0.5, 1.5, c2) * np.where(rng.random(c2) < 0.15, -1, 1)
          ).astype(np.float32)
    t2 = (0.1 * rng.standard_normal(c2)).astype(np.float32)
    return a1, b1, s1, t1, w2, s2, t2


def _edge2_ints(n: int, c1: int, c2: int, seed: int, b: int = 2):
    """Integer a1/b1, power-of-two scales, integer shifts and a w2 with one
    power of two a column (the rest zeros)."""
    rng = np.random.default_rng(seed)
    a1 = rng.integers(-3, 4, (b, n, c1)).astype(np.float32)
    b1 = rng.integers(-3, 4, (b, n, c1)).astype(np.float32)
    s1 = np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), c1 // 4)
    t1 = rng.integers(-2, 3, c1).astype(np.float32)
    w2 = np.zeros((c1, c2), np.float32)
    w2[rng.integers(0, c1, c2), np.arange(c2)] = rng.choice(
        np.float32([-2.0, -0.5, 0.5, 1.0, 2.0]), c2)
    s2 = np.tile(np.float32([1.0, -2.0, 0.5, 1.0]), c2 // 4)
    t2 = rng.integers(-2, 3, c2).astype(np.float32)
    return a1, b1, s1, t1, w2, s2, t2


def _graph(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f32-3":
        return rng.standard_normal((2, n, 3)).astype(np.float32)
    if kind == "bf16-64":
        return rng.standard_normal((2, n, 64)).astype(np.float32)
    # integer points, each four times, and equidistant grid points
    c = 3 if kind == "ints-3" else 64
    base = rng.integers(-3, 4, (2, n // 4, c)).astype(np.float32)
    return np.concatenate([base] * 4, axis=1)


def _knn_edge2_jax(g, args, k, slope, bf16):
    from dgcnn_tpu.ops.pallas_knn import fused_knn_edge2

    gj = jnp.asarray(g)
    if bf16:
        gj = gj.astype(jnp.bfloat16)
    with jax.default_matmul_precision(F32):
        return fused_knn_edge2.__wrapped__(gj, *map(jnp.asarray, args), k,
                                           slope, interpret=True)


def _torch_graph(g, bf16):
    t = torch.from_numpy(g)
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize("variant", ["v3", "v2"])
@pytest.mark.parametrize("graph", ["f32-3", "bf16-64"])
@pytest.mark.parametrize("n,k", [(128, 20), (256, 40)])
def test_knn_edge2_amp_matches_pallas(variant, graph, n, k, jax_env):
    """Kernel 6's AMP form (v3, the default at C1 = 64, and v2, the semseg
    CLI's pin) on f32 and bf16 graphs: within one bf16 ulp of
    ``fused_knn_edge2`` on >= 99.9% of rows."""
    if variant == "v2":
        jax_env.setenv(EXTRACT_ENV, "v2")
    bf16 = graph.startswith("bf16")
    g = _graph(graph, n, n + k)
    args = _edge2_args(n, 64, 64, n + k + 1)
    want = _knn_edge2_jax(g, args, k, 0.2, bf16)
    assert want.dtype == jnp.bfloat16
    got = knn_edge2(_torch_graph(g, bf16), *map(torch.from_numpy, args), k,
                    amp=True)
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, 64)
    assert _ulp_rows(got, want) >= 0.999


@pytest.mark.parametrize("variant", ["v3", "v2"])
@pytest.mark.parametrize("graph", ["ints-3", "ints-64"])
def test_knn_edge2_amp_duplicates_exact(variant, graph, jax_env):
    """Integer duplicate points (v3's tied classes: each point four times,
    and equidistant grid points; v2's lowest-index order): the Pallas
    kernel's bits, the f32 a1 rows averaged unrounded."""
    if variant == "v2":
        jax_env.setenv(EXTRACT_ENV, "v2")
    bf16 = graph == "ints-64"
    g = _graph(graph, 128, 5)
    args = _edge2_ints(128, 64, 64, 6)
    want = _knn_edge2_jax(g, args, 20, 0.25, bf16)
    got = knn_edge2(_torch_graph(g, bf16), *map(torch.from_numpy, args), 20,
                    0.25, amp=True)
    assert torch.equal(got, torch.from_numpy(_np(want)).to(torch.bfloat16))
    # a class mean is not the mean of its members' outputs: v3 against v2
    if variant == "v3":
        v2 = knn_edge2_amp_plain(_torch_graph(g, bf16),
                                 *map(torch.from_numpy, args), 20, 0.25,
                                 variant="v2")
        assert not torch.equal(got, v2)


# ------------------------------------------------------ the exact v2 pin
@pytest.mark.parametrize("kind", ["random", "ints"])
def test_exact_v2_matches_pallas(kind, jax_env):
    """Kernels 1 and 6 under DGCNN_TPU_PALLAS_EXACT=1 and
    DGCNN_TPU_EXTRACT=v2 (the semseg CLI's pin in the exact mode): the
    packed keys of the exact scores, f32 payload and output, against the
    Pallas kernels: rel 1e-5 of each row's norm, bit-equal on integer
    duplicates."""
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    jax_env.setenv(EXACT_ENV, "1")
    jax_env.setenv(EXTRACT_ENV, "v2")
    ints = kind == "ints"
    g = _graph("ints-64" if ints else "bf16-64", 256, 21)
    args6 = (_edge2_ints if ints else _edge2_args)(256, 64, 64, 22)
    slope = 0.25 if ints else 0.2
    want6 = _knn_edge2_jax(g, args6, 20, slope, False)
    got6 = knn_edge2(torch.from_numpy(g), *map(torch.from_numpy, args6), 20,
                     slope)
    rng = np.random.default_rng(23)
    w = [rng.integers(-2, 3, (64, 64)).astype(np.float32) for _ in range(2)]
    st = [np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), 16),
          rng.integers(-2, 3, 64).astype(np.float32)]
    args1 = (*w, *st) if ints else (w[0] / 8, w[1] / 8, *st)
    with jax.default_matmul_precision(F32):
        want1 = fused_edge_conv_eval.__wrapped__(
            jnp.asarray(g), jnp.asarray(g), *map(jnp.asarray, args1), 20,
            select_dtype=jnp.float32, interpret=True)
    got1 = edge_conv_eval(torch.from_numpy(g), torch.from_numpy(g),
                          *map(torch.from_numpy, args1), 20)
    assert got6.dtype == got1.dtype == torch.float32
    if ints:
        np.testing.assert_array_equal(got6.numpy(), _np(want6))
        np.testing.assert_array_equal(got1.numpy(), _np(want1))
    else:
        assert _row_rel(got6, want6) <= 1e-5
        assert _row_rel(got1, want1) <= 1e-5
    # the pin reaches the plain versions as their variant
    assert torch.equal(got6, knn_edge2_plain(
        torch.from_numpy(g), *map(torch.from_numpy, args6), 20, slope,
        variant="v2"))


def test_exact_pin_gives_the_exact_v1_path(jax_env):
    """DGCNN_TPU_PALLAS_EXACT alone: the wrappers and the models' default
    forwards are today's exact v1 path, bit for bit."""
    jax_env.setenv(EXACT_ENV, "1")
    g = torch.from_numpy(_graph("f32-3", 128, 31))
    args = tuple(map(torch.from_numpy, _edge2_args(128, 64, 64, 32)))
    assert torch.equal(knn_edge2(g, *args, 20),
                       knn_edge2_plain(g, *args, 20, variant="v1"))
    model = DGCNNSemSeg(emb_dims=32, k=20, device="cpu",
                        generator=torch.Generator().manual_seed(33))
    x = torch.rand(2, 128, 9, generator=torch.Generator().manual_seed(34))
    with torch.no_grad():
        assert torch.equal(model(x), model(x, amp=False))


# ------------------------------------------------------ kernels 12, 13
@pytest.mark.parametrize("kind", ["random", "ints"])
@pytest.mark.parametrize("n,band", [(256, 128), (512, 256)])
def test_banded_amp_matches_pallas(kind, n, band, jax_env):
    """Kernels 13 and 12's AMP forms (v3 over each query tile's window: the
    window's classes, its least score) against the Pallas banded kernels
    on one PC1 order: within one bf16 ulp on >= 99.9% of rows, bit-equal
    on integer duplicates."""
    from dgcnn_tpu.ops.pallas_banded import (
        banded_edge_conv_eval as jfn12,
    )
    from dgcnn_tpu.ops.pallas_banded import banded_knn_edge2 as jfn13

    ints = kind == "ints"
    g = _cloud(kind, 40 + n, n=n)
    order, _ = _sorted(g)
    np.testing.assert_array_equal(order.numpy(), _jax_order(g))
    args13 = (_edge2_ints if ints else _edge2_args)(n, 64, 64, 41)
    slope = 0.25 if ints else 0.2
    rng = np.random.default_rng(42)
    x = (rng.integers(-3, 4, (2, n, 64)) if ints
         else rng.standard_normal((2, n, 64))).astype(np.float32)
    w = [rng.integers(-2, 3, (64, 64)).astype(np.float32) for _ in range(2)]
    args12 = (w[0] / (1 if ints else 8), w[1] / (1 if ints else 8),
              np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), 16),
              rng.integers(-2, 3, 64).astype(np.float32))
    with jax.default_matmul_precision(F32):
        want13 = jfn13.__wrapped__(jnp.asarray(g),
                                   *map(jnp.asarray, args13), 20, band,
                                   slope, interpret=True)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        want12 = jfn12.__wrapped__(xb, xb, *map(jnp.asarray, args12), 20,
                                   band, slope, select_dtype=jnp.bfloat16,
                                   interpret=True)
    got13 = banded_knn_edge2(torch.from_numpy(g),
                             *map(torch.from_numpy, args13), 20, band, slope,
                             order=order, amp=True)
    xt = torch.from_numpy(_np(xb)).to(torch.bfloat16)
    got12 = banded_edge_conv_eval(xt, xt, *map(torch.from_numpy, args12),
                                  20, band, slope, amp=True)
    assert want13.dtype == want12.dtype == jnp.bfloat16
    assert got13.dtype == got12.dtype == torch.bfloat16
    if ints:
        for got, want in ((got13, want13), (got12, want12)):
            assert torch.equal(got, torch.from_numpy(_np(want)).to(
                torch.bfloat16))
    else:
        assert _ulp_rows(got13, want13) >= 0.999
        assert _ulp_rows(got12, want12) >= 0.999


# -------------------------------------------------------------- kernel 2
@pytest.mark.parametrize("c", [192, 128])
def test_conv_pool_amp_max_only_matches_pallas(c):
    """conv6 (192 -> E) and the TransformNet's conv3 (128 -> E) + max in
    the AMP form, one bf16 input: rel 1e-5 of ``fused_conv_pool``."""
    from dgcnn_tpu.ops.pallas_pool import fused_conv_pool

    rng = np.random.default_rng(c)
    x = jnp.asarray(rng.standard_normal((2, 256, c)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w = (rng.standard_normal((c, 128)) / np.sqrt(c)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    t = (0.1 * rng.standard_normal(128)).astype(np.float32)
    with jax.default_matmul_precision(F32):
        want = np.asarray(fused_conv_pool(
            (x,), jnp.asarray(w), jnp.asarray(s), jnp.asarray(t),
            compute_dtype=jnp.bfloat16, with_mean=False, interpret=True))
    xt = torch.from_numpy(_np(x)).to(torch.bfloat16)
    got = conv_pool((xt,), *map(torch.from_numpy, (w, s, t)),
                    with_mean=False, amp=True)
    assert got.shape == (2, 1, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert torch.equal(got, conv_pool_amp_plain(
        (xt,), *map(torch.from_numpy, (w, s, t)), with_mean=False))


# ---------------------------------------------------------------- models
def _semseg_input(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(51)
    x = rng.random((2, n, 9)).astype(np.float32)
    if kind == "duplicates":  # the drift gate's S3DIS-style blocks
        x[:, n - n // 4:] = x[:, :n // 4]
    return x


def _gap_and_port(fmodel, variables, inputs, port, jax_env, pin,
                  gap=True):
    """(JAX AMP logits, its AMP-vs-exact max|diff| (with ``gap``), the
    port's AMP logits), each JAX forward from a cleared cache."""
    if pin:
        jax_env.setenv(EXTRACT_ENV, "v2")
    with jax.default_matmul_precision(F32):
        amp_j = np.asarray(fmodel.apply(
            variables, *map(jnp.asarray, inputs), train=False))
        if gap:
            jax.clear_caches()
            jax_env.setenv(EXACT_ENV, "1")
            gap = np.abs(amp_j - np.asarray(fmodel.apply(
                variables, *map(jnp.asarray, inputs), train=False))).max()
            jax_env.delenv(EXACT_ENV)
    with torch.no_grad():
        amp_t = port(*map(torch.from_numpy, inputs), amp=True).numpy()
    return amp_j, gap, amp_t


def _held_logits(amp_t, amp_j, gap):
    assert gap > 0
    agree = (amp_t.argmax(-1) == amp_j.argmax(-1)).mean()
    assert agree >= 0.995, agree
    err = np.abs(amp_t - amp_j).max()
    assert err <= gap / 10, (err, gap)


@pytest.mark.parametrize("case", ["uniform", "pin_v2", "duplicates"])
def test_dgcnn_semseg_amp_matches_jax_amp(case, jax_env):
    """The whole AMP eval on flax-initialized weights carried across by
    convert.py, against the JAX package's AMP forward: on uniform blocks,
    under the semseg CLI's v2 pin, and on the drift gate's blocks with
    their last quarter a copy of the first."""
    n = 128
    fmodel, variables = flax_semseg_variables(emb_dims=64, k=20, n=n,
                                              randomize=False)
    model = DGCNNSemSeg(emb_dims=64, k=20, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    x = _semseg_input(case, n)
    amp_j, gap, amp_t = _gap_and_port(fmodel, variables, (x,), model,
                                      jax_env, case == "pin_v2")
    _held_logits(amp_t, amp_j, gap)


@pytest.mark.parametrize("cloud", ["grid", "normal"])
def test_dgcnn_partseg_amp_matches_jax_amp(cloud, jax_env):
    """The whole AMP eval of DGCNNPartSeg (the TransformNet's kernel 6 and
    conv3 pool in AMP too) against the JAX package's AMP forward.  On
    normal clouds rounded to a 1/64 grid the first stage's bf16x3 scores
    are exact in both frameworks, so no near tie at the k-th neighbour
    flips a neighbourhood, and the logits are held to a tenth of the gap.
    On the raw normal clouds the two frameworks' sums of the score
    products in other orders can flip such a near tie (one row then moves
    by up to 2^7 bf16 ulps, and conv6's max over the points with it;
    the kernel tests hold rows): there the argmax is held."""
    n = 128
    fmodel, variables = flax_partseg_variables(emb_dims=64, k=20, n=n,
                                               randomize=False)
    model = DGCNNPartSeg(emb_dims=64, k=20, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    rng = np.random.default_rng(61)
    x = rng.standard_normal((2, n, 3)).astype(np.float32)
    if cloud == "grid":
        x = np.round(x * 64) / 64
    lbl = np.eye(16, dtype=np.float32)[[3, 11]]
    amp_j, gap, amp_t = _gap_and_port(fmodel, variables, (x, lbl), model,
                                      jax_env, False, gap=cloud == "grid")
    if cloud == "grid":
        _held_logits(amp_t, amp_j, gap)
    else:
        assert (amp_t.argmax(-1) == amp_j.argmax(-1)).mean() >= 0.995


# ------------------------------------------------------------------- CLI
def test_semseg_cli_pins_v2_and_restores(monkeypatch, tmp_path):
    """The semseg CLI's ``main`` runs with DGCNN_TPU_EXTRACT=v2 set when
    the user set none, keeps the user's value, and leaves the variable as
    it found it."""
    from dgcnn_tpu_torch.cli import semseg

    seen = []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(semseg, "test",
                        lambda args, io: seen.append(
                            os.environ.get(EXTRACT_ENV)))
    argv = ["--exp_name=pin", "--eval=True", "--no_cuda=True"]
    monkeypatch.delenv(EXTRACT_ENV, raising=False)
    semseg.main(argv)
    assert EXTRACT_ENV not in os.environ
    monkeypatch.setenv(EXTRACT_ENV, "v1")
    semseg.main(argv)
    assert os.environ[EXTRACT_ENV] == "v1"

    def boom(args, io):
        seen.append(os.environ.get(EXTRACT_ENV))
        raise RuntimeError("stop")

    monkeypatch.delenv(EXTRACT_ENV)
    monkeypatch.setattr(semseg, "test", boom)
    with pytest.raises(RuntimeError):
        semseg.main(argv)
    assert EXTRACT_ENV not in os.environ
    assert seen == ["v2", "v1", "v2"]



def test_training_selection_honours_the_pin(jax_env):
    """Under the semseg CLI's pin the JAX package's training kernel 3 runs
    v2 in the exact mode, and so does the port's.  Row 0's two nearest
    candidates after itself score within one step of v2's grid (the row's
    far point sets the grid): v1 takes the nearer (column 2), v2 the lower
    index (column 1).  Unset, the port's kernel 3 keeps v1."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    from dgcnn_tpu_torch.ops.knn_reduce_kernel import knn_reduce

    jax_env.setenv(EXACT_ENV, "1")
    jax_env.setenv(EXTRACT_ENV, "v2")
    g = np.zeros((1, 128, 3), np.float32)
    g[0, 1, 0] = 1 + 2.0 ** -20        # d^2 = 1 + 2^-19
    g[0, 2, 0] = 1.0                   # d^2 = 1
    g[0, 3:, 1] = 5 + np.arange(125, dtype=np.float32) / 8
    g[0, 127, 1] = 31.0                # d^2 = 961: the grid's step ~6e-5
    a = np.random.default_rng(81).standard_normal((1, 128, 8)).astype(
        np.float32)
    with jax.default_matmul_precision(F32):
        want = np.asarray(fused_knn_reduce(
            jnp.asarray(g), jnp.asarray(a), 2, select_dtype=jnp.float32,
            interpret=True)[0])
    got = knn_reduce(torch.from_numpy(g), torch.from_numpy(a), 2)[0].numpy()
    assert list(want[0, 0]) == [0, 1]   # v2: the lower index
    np.testing.assert_array_equal(got, want)
    jax_env.delenv(EXTRACT_ENV)
    got = knn_reduce(torch.from_numpy(g), torch.from_numpy(a), 2)[0].numpy()
    assert list(got[0, 0]) == [0, 2]    # v1: the nearer point


def _train_cloud(kind: str, seed: int, b: int = 2, n: int = 256, c: int = 3):
    rng = np.random.default_rng(seed)
    if kind == "ints":  # integer points, each four times
        return np.concatenate([rng.integers(-3, 4, (b, n // 4, c))] * 4,
                              axis=1).astype(np.float32)
    return rng.standard_normal((b, n, c)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ints"])
@pytest.mark.parametrize("kernel", ["knn_reduce", "knn_reduce_xw", "knn"])
def test_training_kernels_v2_match_pallas(kernel, kind, jax_env):
    """Kernels 3, 4 and 11 under DGCNN_TPU_PALLAS_EXACT=1 and
    DGCNN_TPU_EXTRACT=v2 (the semseg CLI's pin): the same idx as
    ``fused_knn_reduce``, ``fused_knn_reduce_xw`` and ``knn_pallas`` on
    every row (the packed keys of the exact scores), the reductions within
    rel 1e-5 of each row's norm (bit-equal on integer duplicates, where
    every sum is exact)."""
    from dgcnn_tpu.ops import pallas_knn

    from dgcnn_tpu_torch.ops.knn import knn
    from dgcnn_tpu_torch.ops.knn_reduce_kernel import (
        knn_reduce,
        knn_reduce_xw,
    )

    jax_env.setenv(EXACT_ENV, "1")
    jax_env.setenv(EXTRACT_ENV, "v2")
    ints = kind == "ints"
    g = _train_cloud(kind, 91)
    rng = np.random.default_rng(92)
    x = (rng.integers(-3, 4, (2, 256, 16)) if ints
         else rng.standard_normal((2, 256, 16))).astype(np.float32)
    w = rng.integers(-2, 3, (16, 24)).astype(np.float32) / (1 if ints else 4)
    gj, xj, wj = map(jnp.asarray, (g, x, w))
    with jax.default_matmul_precision(F32):
        if kernel == "knn":
            want = (np.asarray(pallas_knn.knn_pallas(gj, 20,
                                                     interpret=True)),)
        elif kernel == "knn_reduce":
            want = pallas_knn.fused_knn_reduce(
                gj, xj, 20, select_dtype=jnp.float32, interpret=True,
                with_sumsq=True)
        else:
            want = pallas_knn.fused_knn_reduce_xw(
                gj, xj, wj, 20, select_dtype=jnp.float32, interpret=True,
                with_sumsq=True)
    gt, xt, wt = map(torch.from_numpy, (g, x, w))
    got = {"knn": lambda: (knn(gt, 20),),
           "knn_reduce": lambda: knn_reduce(gt, xt, 20),
           "knn_reduce_xw": lambda: knn_reduce_xw(gt, xt, wt, 20)}[kernel]()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for gr, wr in zip(got[1:], want[1:]):
        if ints:
            np.testing.assert_array_equal(gr.numpy(), _np(wr))
        else:
            assert _row_rel(gr, wr) <= 1e-5
    # the pin unset: v1, the exact scores' stable order, as before the pin
    # reached these kernels
    jax_env.delenv(EXTRACT_ENV)
    v1 = {"knn": lambda: knn(gt, 20),
          "knn_reduce": lambda: knn_reduce(gt, xt, 20)[0],
          "knn_reduce_xw": lambda: knn_reduce_xw(gt, xt, wt, 20)[0]}[kernel]()
    assert torch.equal(v1.long(), torch.sort(
        pairwise_neg_sqdist(gt), dim=-1, descending=True,
        stable=True).indices[..., :20])
