"""The port's AMP and v2 forms of the kNN kernels at k = 80, above the
tiled selection's lists (k <= 64; on the card these forms take the
row-warp selection of ``csrc/knn_select.cuh``), against the JAX package,
which runs its AMP default at any k, on the CPU at N = 256.

The JAX side runs its Pallas kernels in interpret mode
(``DGCNN_TPU_PALLAS=1``, ``DGCNN_TPU_PALLAS_EXACT`` unset, as
``tests/test_torch_amp_eval.py``'s ``amp_env``) under
``jax.default_matmul_precision("float32")``; kernel 11 and the banded
kernels 12 and 13 under ``DGCNN_TPU_EXTRACT=v2`` (the semseg CLI's pin).
The Pallas kernels unroll their k rounds when they trace, so each shape
is traced once: the caches are cleared when this module starts and ends,
not between its tests, and the kernel 1 stages share the DGCNNCls
forward's shapes, whose AMP forward then reuses their jits.  The port's
side is the plain versions, which CPU tensors take.  The tolerances are
``tests/test_torch_amp_eval.py``'s:

- a stage's bf16 output within one bf16 ulp on >= 99.9% of the rows, and
  bit-equal on integer duplicate points (every product and sum exact);
- kernels 3 and 4: the same neighbour list on every row but where the
  two frameworks' score sums part a near tie (``_same_rows``), on >= 99%
  of the rows (every row on integer points), and on the same rows max and
  min bit-equal, the sums within rel 1e-5 of the row's norm (kernel 4:
  plus one bf16 step, as ``tests/test_torch_amp_train.py`` states);
- kernels 10 and 11 (the exact scores' keys): the same neighbour sets
  (kernel 11: lists) on >= 99% of rows, each other row a near tie of its
  f32 scores, every row on integer points; kernel 10's sums within rel
  1e-5 of the row's norm;
- the model's logits: the same argmax, and max|diff| at most a tenth of
  the JAX package's own AMP-vs-exact max|diff| (its exact forward: the
  XLA path that it runs on the CPU).

The ``cuda``-marked tests hold each CUDA form at k = 80 (kernels 7 and 8
at k = 144) against its plain version, and its forced row-warp route at k
= 20 against the tiled route bit for bit; they skip without a card.
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
    EXTRACT_ENV,
    amp_scores,
    use_amp_eval,
    use_amp_train,
)
from dgcnn_tpu_torch.ops.banded import banded_edge_conv_eval, banded_knn_edge2
from dgcnn_tpu_torch.ops.edge2_kernel import knn_edge2
from dgcnn_tpu_torch.ops.edge_conv_kernel import edge_conv_eval
from dgcnn_tpu_torch.ops.knn import knn, pairwise_neg_sqdist
from dgcnn_tpu_torch.ops.knn_reduce_kernel import knn_reduce, knn_reduce_xw
from dgcnn_tpu_torch.ops.knn_sum_kernel import knn_sum

from test_torch_amp_seg import _edge2_args, _edge2_ints, _ulp_rows
from test_torch_amp_train import STEP, _cloud, _feats, _same_rows
from test_torch_banded_tiled import _cloud as _band_cloud
from test_torch_banded_tiled import _jax_order, _sorted

F32 = "float32"
K, N = 80, 256
# DGCNNCls's stages (Cin, Co): v3, v3, v2 project-first, v2 select-x
STAGES = [(3, 64), (64, 64), (64, 128), (128, 256)]


@pytest.fixture(scope="module", autouse=True)
def amp_default():
    """The JAX package's AMP default for the whole module, its jit caches
    cleared when the module starts and ends."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DGCNN_TPU_PALLAS", "1")
        mp.delenv(EXACT_ENV, raising=False)
        mp.delenv(EXTRACT_ENV, raising=False)
        jax.clear_caches()
        yield
        jax.clear_caches()


def _np(x):
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x)


def _stage(kind: str, cin: int, co: int, seed: int):
    """A stage's input (B=2, N points) and (W_nbr, W_ctr, scale, bias);
    ``ints``: integer points, each four times, and integer weights."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        base = rng.integers(-3, 4, (2, N // 4, cin))
        x = np.concatenate([base] * 4, axis=1).astype(np.float32)
        w = [rng.integers(-2, 3, (cin, co)).astype(np.float32)
             for _ in range(2)]
        st = [np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), co // 4),
              rng.integers(-2, 3, co).astype(np.float32)]
        return x, (*w, *st)
    x = rng.standard_normal((2, N, cin)).astype(np.float32)
    w = [(rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32)
         for _ in range(2)]
    s = (rng.uniform(0.5, 1.5, co) * np.where(rng.random(co) < 0.15, -1, 1)
         ).astype(np.float32)
    return x, (*w, s, (0.1 * rng.standard_normal(co)).astype(np.float32))


def _bf16_pair(x: np.ndarray, bf16: bool):
    xj = jnp.asarray(x)
    xj = xj.astype(jnp.bfloat16) if bf16 else xj
    xt = torch.from_numpy(_np(xj))
    return xj, xt.to(torch.bfloat16) if bf16 else xt


def _held(got: torch.Tensor, want, ints: bool, graph=None) -> None:
    """Integer points: bit-equal.  Else rows within one bf16 ulp on
    >= 99.9%, or on >= 99% with every other row a near tie of its AMP
    scores over ``graph`` (the cloud): two distinct points among its k + 1
    best classes whose scores lie within 1e-5 of the row's score scale,
    an exact tie included (a class of two points in one sum order may be
    two classes in the other), which the two frameworks' sum orders may
    break apart."""
    want_t = torch.from_numpy(_np(want)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want_t.shape
    if ints:
        assert torch.equal(got, want_t)
        return
    near = (got.view(torch.int16).int()
            - want_t.view(torch.int16).int()).abs().amax(-1) <= 1
    frac = near.float().mean().item()
    if frac >= 0.999:
        return
    assert frac >= 0.99 and graph is not None, frac
    s = amp_scores(graph, graph)
    for b, i in (~near).nonzero().tolist():
        top = s[b, i].topk(2 * K + 2)
        pts = graph[b, top.indices].float()
        d = top.values[:-1] - top.values[1:]
        first = (pts[:-1] != pts[1:]).any(-1) & (
            torch.cumsum((d > 0).int(), 0) <= K)
        gap = torch.where(first, d, torch.inf).min()
        assert gap <= 1e-5 * s[b, i].abs().max(), (b, i, gap)


def _exact_same_sets(graph: torch.Tensor, got, want) -> np.ndarray:
    """Rows whose neighbour sets are equal; asserts that every other row
    differs only at near ties of its f32 scores (within 1e-5 of the row's
    score scale)."""
    got, want = np.sort(np.asarray(got), -1), np.sort(np.asarray(want), -1)
    same = (got == want).all(-1)
    s = pairwise_neg_sqdist(graph).numpy()
    for b, i in zip(*np.nonzero(~same)):
        odd = np.setxor1d(got[b, i], want[b, i])
        kth = np.sort(s[b, i])[::-1][K - 1]
        assert np.abs(s[b, i, odd] - kth).max() <= 1e-5 * np.abs(
            s[b, i]).max()
    return same


# --------------------------------------------------------- kernels 1, 12
@pytest.mark.parametrize("kind", ["random", "ints"])
@pytest.mark.parametrize("cin,co", STAGES)
def test_edge_conv_amp_stage_at_large_k(cin, co, kind):
    """Kernel 1's AMP form at each DGCNNCls stage (v3 on the f32 cloud and
    a bf16 stage, v2 project-first, v2 select-x) against
    ``fused_edge_conv_eval(select_dtype=bf16)`` at k = 80."""
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    ints = kind == "ints"
    x, args = _stage(kind, cin, co, cin + co + ints)
    xj, xt = _bf16_pair(x, cin > 3)
    with jax.default_matmul_precision(F32):
        # the DGCNNCls forward's call, positional k and slope
        want = fused_edge_conv_eval(xj, xj, *map(jnp.asarray, args), K, 0.2,
                                    select_dtype=jnp.bfloat16)
    got = edge_conv_eval(xt, xt, *map(torch.from_numpy, args), K, amp=True)
    _held(got, want, ints, xt)


@pytest.mark.parametrize("kind", ["random", "ints"])
def test_banded_amp_at_large_k(kind, monkeypatch):
    """Kernels 13 and 12's AMP forms under the semseg CLI's v2 pin (the
    keys of each window's AMP scores) against the Pallas banded kernels,
    N = 256 in windows of 128, k = 80, on one PC1 order."""
    from dgcnn_tpu.ops.pallas_banded import (
        banded_edge_conv_eval as jfn12,
    )
    from dgcnn_tpu.ops.pallas_banded import banded_knn_edge2 as jfn13

    monkeypatch.setenv(EXTRACT_ENV, "v2")
    ints = kind == "ints"
    g = _band_cloud(kind, 70 + ints, n=N)
    order, _ = _sorted(g)
    np.testing.assert_array_equal(order.numpy(), _jax_order(g))
    # slope 0.2 on integer points too: the same jit, and still exact (a
    # second conv of one power of two a column, the same f32 operations)
    args13 = (_edge2_ints if ints else _edge2_args)(N, 64, 64, 71)
    slope = 0.2
    x, args12 = _stage(kind, 64, 64, 72)
    xj, xt = _bf16_pair(x, True)
    with jax.default_matmul_precision(F32):
        want13 = jfn13(jnp.asarray(g), *map(jnp.asarray, args13), K, 128,
                       slope, interpret=True)
        want12 = jfn12(xj, xj, *map(jnp.asarray, args12), K, 128, 0.2,
                       select_dtype=jnp.bfloat16, interpret=True)
    got13 = banded_knn_edge2(torch.from_numpy(g),
                             *map(torch.from_numpy, args13), K, 128, slope,
                             order=order, amp=True)
    got12 = banded_edge_conv_eval(xt, xt, *map(torch.from_numpy, args12), K,
                                  128, amp=True)
    _held(got13, want13, ints)
    _held(got12, want12, ints)


# ------------------------------------------------------------- kernel 6
@pytest.mark.parametrize("kind", ["random", "ints"])
def test_knn_edge2_amp_at_large_k(kind):
    """Kernel 6's AMP form (v3, the default at C1 = 64) on an f32 graph of
    three channels against ``fused_knn_edge2`` at k = 80."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_edge2

    ints = kind == "ints"
    g = _cloud(kind, 80 + ints, 3)
    args = (_edge2_ints if ints else _edge2_args)(N, 64, 64, 81)
    with jax.default_matmul_precision(F32):
        want = fused_knn_edge2(jnp.asarray(g), *map(jnp.asarray, args), K,
                               0.2, interpret=True)
    gt = torch.from_numpy(g)
    got = knn_edge2(gt, *map(torch.from_numpy, args), K, 0.2, amp=True)
    _held(got, want, ints, gt)


# --------------------------------------------------------- kernels 3, 4
@pytest.mark.parametrize("kind", ["random", "ints"])
def test_knn_reduce_amp_at_large_k(kind):
    """Kernel 3's AMP form (bf16x3 scores, v2, bf16 rows, f32 sums)
    against ``fused_knn_reduce(select_dtype=bf16)`` at k = 80."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    ints = kind == "ints"
    g = _cloud(kind, 30 + ints, 3)
    a = _feats(kind, 32, (2, N, 24))
    with jax.default_matmul_precision(F32):
        want = fused_knn_reduce(jnp.asarray(g), jnp.asarray(a), K,
                                select_dtype=jnp.bfloat16, interpret=True,
                                with_sumsq=True)
    gt = torch.from_numpy(g)
    got = knn_reduce(gt, torch.from_numpy(a), K, amp=True)
    same = _same_rows(gt, got[0], want[0])
    assert same.mean() >= (1.0 if ints else 0.99), same.mean()
    for i, (gr, wr) in enumerate(zip(got[1:], want[1:])):
        gr, wr = gr.numpy(), np.asarray(wr)
        if i < 2:
            np.testing.assert_array_equal(gr[same], wr[same])
        else:
            rel = (np.linalg.norm(gr - wr, axis=-1)
                   / np.linalg.norm(wr, axis=-1).clip(1e-30))
            assert rel[same].max() <= 1e-5


@pytest.mark.parametrize("kind", ["random", "ints"])
def test_knn_reduce_xw_amp_at_large_k(kind):
    """Kernel 4's AMP form (select-x, 32 -> 160 channels) against
    ``fused_knn_reduce_xw(select_dtype=bf16)`` at k = 80: the TPU
    kernel's bf16(bf16(x)[idx] @ w) from the port's whole-cloud
    projection rounded after selection."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce_xw

    ints = kind == "ints"
    g = _cloud(kind, 40 + ints, 16)
    x = _feats(kind, 42, (2, N, 32))
    w = _feats(kind, 43, (32, 160))
    w = w if ints else (w / np.sqrt(32)).astype(np.float32)
    with jax.default_matmul_precision(F32):
        want = fused_knn_reduce_xw(*map(jnp.asarray, (g, x, w)), K,
                                   select_dtype=jnp.bfloat16,
                                   interpret=True, with_sumsq=True)
    gt = torch.from_numpy(g)
    got = knn_reduce_xw(gt, torch.from_numpy(x), torch.from_numpy(w), K,
                        amp=True)
    same = _same_rows(gt, got[0], want[0])
    assert same.mean() >= (1.0 if ints else 0.99), same.mean()
    top = np.maximum(np.abs(_np(want[1])), np.abs(_np(want[2]))).max(-1)
    for i, (gr, wr) in enumerate(zip(got[1:], want[1:])):
        gr, wr = gr.numpy().astype(np.float64), _np(wr).astype(np.float64)
        bound = (1e-5 * np.linalg.norm(wr, axis=-1)
                 + STEP * top * (2 * top if i == 3 else 1.0))
        assert (np.abs(gr - wr).max(-1) <= bound)[same].all()


# -------------------------------------------------------- kernels 10, 11
@pytest.mark.parametrize("kind", ["random", "ints"])
def test_knn_sum_v2_at_large_k(kind):
    """Kernel 10's v2 form (the AMP Net's HOG: the exact scores' keys, f32
    sums in list order) against ``fused_knn_sum`` at k = 80."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_sum

    ints = kind == "ints"
    x = _cloud(kind, 50 + ints, 3)
    a = _feats(kind, 52, (2, N, 9))
    with jax.default_matmul_precision(F32):
        idx, asum = fused_knn_sum(jnp.asarray(x), jnp.asarray(a), K,
                                  interpret=True)
    xt = torch.from_numpy(x)
    got_idx, got_sum = knn_sum(xt, torch.from_numpy(a), K, amp=True)
    same = _exact_same_sets(xt, got_idx, idx)
    assert same.mean() >= (1.0 if ints else 0.99), same.mean()
    want = np.asarray(asum)
    rel = (np.linalg.norm(got_sum.numpy() - want, axis=-1)
           / np.linalg.norm(want, axis=-1).clip(1e-30))
    assert rel[same].max() <= 1e-5


@pytest.mark.parametrize("kind", ["random", "ints"])
def test_knn_v2_at_large_k(kind, monkeypatch):
    """Kernel 11's v2 form under the semseg CLI's pin (the exact scores'
    keys) against ``knn_pallas`` at k = 80."""
    from dgcnn_tpu.ops.pallas_knn import knn_pallas

    monkeypatch.setenv(EXTRACT_ENV, "v2")
    ints = kind == "ints"
    x = _cloud(kind, 60 + ints, 3)
    with jax.default_matmul_precision(F32):
        want = np.asarray(knn_pallas(jnp.asarray(x), K, interpret=True))
    xt = torch.from_numpy(x)
    got = knn(xt, K).numpy()
    same = (got == want).all(-1)
    _exact_same_sets(xt, got, want)
    assert same.mean() >= (1.0 if ints else 0.99), same.mean()


# -------------------------------------------------------------- the modes
@pytest.mark.parametrize("k", [65, 80, 256])
def test_amp_modes_take_any_k(k, monkeypatch):
    """``use_amp_eval`` and ``use_amp_train`` do not test k: AMP on a CUDA
    device by default and wherever amp=True is asked, exact on the CPU by
    default and where ``use_kernel`` refuses N (not a multiple of 128, or
    above its 32768), as the JAX package runs its kernels' AMP default at
    any k; 8192 points run AMP like 1024."""
    monkeypatch.delenv(EXACT_ENV, raising=False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for mode in (use_amp_eval, use_amp_train):
        assert mode(None, cuda, 1024, k) and mode(True, cuda, 1024, k)
        assert mode(True, cpu, 1024, k) and not mode(None, cpu, 1024, k)
        assert not mode(False, cuda, 1024, k)
        assert not mode(True, cuda, 1000, k)
        assert mode(True, cuda, 8192, k) and mode(None, cuda, 8192, k)
        assert not mode(True, cuda, 32896, k)


def test_dgcnn_cls_amp_at_large_k_matches_jax_amp(monkeypatch):
    """DGCNNCls's AMP eval at k = 80 on weights carried across by
    convert.py: the same argmax as the JAX package's AMP forward, and
    logits within a tenth of its AMP-vs-exact max|diff|."""
    from dgcnn_tpu.models import DGCNNCls as FlaxDGCNNCls

    from test_torch_port_model import randomize_flax

    fmodel = FlaxDGCNNCls(emb_dims=64, k=K)
    x = np.random.default_rng(90).standard_normal((2, N, 3)).astype(
        np.float32)
    with jax.default_matmul_precision(F32):
        # the variables' shapes (they depend on neither k nor N) from a
        # small model on the XLA path, their values drawn from a seed
        monkeypatch.setenv("DGCNN_TPU_PALLAS", "0")
        shapes = jax.eval_shape(lambda: FlaxDGCNNCls(emb_dims=64, k=4).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 16, 3), jnp.float32),
            train=False))
        variables = randomize_flax(jax.tree_util.tree_map(
            lambda v: np.zeros(v.shape, v.dtype), shapes), 91)
        exact_j = np.asarray(jax.jit(lambda v, x_: fmodel.apply(
            v, x_, train=False))(variables, jnp.asarray(x)))
        monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
        amp_j = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                        train=False))
    model = DGCNNCls(emb_dims=64, k=K, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        amp_t = model(torch.from_numpy(x), amp=True).numpy()
    gap = np.abs(amp_j - exact_j).max()
    assert gap > 0
    np.testing.assert_array_equal(amp_t.argmax(-1), amp_j.argmax(-1))
    assert np.abs(amp_t - amp_j).max() <= gap / 10, (
        np.abs(amp_t - amp_j).max(), gap)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_FORMS = ["edge_conv_eval v3", "edge_conv_eval v2",
              "edge_conv_eval select-x", "edge_conv_eval exact v2",
              "knn_edge2 v3", "knn_edge2 v2", "knn_edge2 exact v2",
              "banded_edge_conv_eval v3", "banded_knn_edge2 v2",
              "knn_reduce", "knn_reduce exact v2", "knn_reduce_xw",
              "knn_sum v2", "knn v2", "edge2_fwd", "edge2_bwd"]


def _large_k_call(form: str, dev, k: int, rowwarp: bool = False):
    """``form``'s wrapper on integer duplicate points (N = 1024; the same
    inputs on every device) on ``dev``: CPU tensors take the plain
    version."""
    from dgcnn_tpu_torch.ops.edge2_reduce_kernel import edge2_bwd, edge2_fwd

    rng = np.random.default_rng(len(form))
    n, name = 1024, form.split()[0]
    amp = "exact" not in form
    kw = {"rowwarp": True} if rowwarp else {}

    def t(a, bf16=False):
        v = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        return v.to(torch.bfloat16) if bf16 else v

    def ints(shape):
        return rng.integers(-3, 4, shape).astype(np.float32)

    def dup(c, bf16=False):
        return t(np.concatenate([ints((2, n // 4, c))] * 4, axis=1), bf16)

    if "edge_conv_eval" in name:
        cin, co = {"v3": (3, 64), "v2": (64, 128), "select-x": (128, 256),
                   "exact": (64, 64)}[form.split()[1]]
        g = dup(cin, amp and cin > 3)
        args = (g, g, t(ints((cin, co))), t(ints((cin, co))),
                t(np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), co // 4)),
                t(ints(co)))
        if name == "banded_edge_conv_eval":
            return banded_edge_conv_eval(*args, k, 512, amp=amp, **kw)
        return edge_conv_eval(*args, k, amp=amp, **kw)
    if "knn_edge2" in name:
        g = dup(3) if "v3" in form else dup(64, amp)
        e2 = [t(a) for a in _edge2_ints(n, 64, 64, 3)]
        if name == "banded_knn_edge2":
            return banded_knn_edge2(g, *e2, k, 512, 0.25, amp=amp, **kw)
        return knn_edge2(g, *e2, k, 0.25, amp=amp, **kw)
    if name == "knn_reduce":
        return knn_reduce(dup(3), dup(32), k, amp=amp, **kw)
    if name == "knn_reduce_xw":
        return knn_reduce_xw(dup(3), dup(32), t(ints((32, 64))), k, amp=amp,
                             **kw)
    if name == "knn_sum":
        return knn_sum(dup(3), t(ints((2, n, 9))), k, amp=True, **kw)
    if name == "knn":
        return knn(dup(3), k, **kw)
    e2 = [t(a) for a in _edge2_ints(n, 64, 64, 4)[:5]]
    idx = knn(dup(3), k).int()
    out = edge2_fwd(*e2, idx, 0.25, amp=True, **kw)
    if name == "edge2_fwd":
        return out
    cts = [t(ints((2, n, 64))) for _ in range(4)]
    return edge2_bwd(*e2, idx, out[0], out[1], *cts, 0.25, amp=True)


@pytest.mark.cuda
@pytest.mark.parametrize("form", CUDA_FORMS)
def test_large_k_form_matches_plain_on_cuda(form, cuda_device,
                                            monkeypatch):
    """Each CUDA form at k = 80 (kernels 7 and 8 at k = 144: their AMP
    forms' row-warp route) on integer duplicate points, where every
    product and sum is exact: the plain version's bits (kernel 8's db1,
    ds1, dt1 and dW2, divided by tie counts, within rel 1e-5); and the
    forced row-warp route at k = 20 the tiled route's bits."""
    monkeypatch.delenv(EXACT_ENV, raising=False)
    monkeypatch.delenv(EXTRACT_ENV, raising=False)
    if "v2" in form:
        monkeypatch.setenv(EXTRACT_ENV, "v2")
    if "exact" in form:
        monkeypatch.setenv(EXACT_ENV, "1")
    k = 144 if form in ("edge2_fwd", "edge2_bwd") else K
    got = _large_k_call(form, cuda_device, k)
    want = _large_k_call(form, torch.device("cpu"), k)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (gv, wv) in enumerate(zip(got, want)):
        gv = gv.cpu()
        if form == "edge2_bwd" and i > 0:
            assert (gv - wv).norm() <= 1e-5 * wv.norm(), (form, i)
        else:
            assert torch.equal(gv, wv), (form, i)
    if form != "edge2_bwd":
        tiled = _large_k_call(form, cuda_device, 20)
        rowwarp = _large_k_call(form, cuda_device, 20, rowwarp=True)
        tiled = tiled if isinstance(tiled, tuple) else (tiled,)
        rowwarp = rowwarp if isinstance(rowwarp, tuple) else (rowwarp,)
        assert all(torch.equal(a, b) for a, b in zip(tiled, rowwarp))
