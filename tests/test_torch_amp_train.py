"""The port's AMP (bf16) training kernels 3, 4, 5, 7 and 8 and its training
mode switch against the JAX package, on the CPU at small sizes.

The JAX side runs its AMP training kernels in Pallas interpret mode
(``DGCNN_TPU_PALLAS=1``, ``DGCNN_TPU_PALLAS_EXACT`` and
``DGCNN_TPU_EXTRACT`` unset) under ``jax.default_matmul_precision(
"float32")``; the port's side is the plain versions of the AMP forms, which
CPU tensors take.  Each tolerance is stated where it is held:

- kernels 3 and 4: the same neighbour list on every row, or, where a row
  differs, at each differing slot two members whose AMP scores lie within
  1e-5 of the row's score scale (a near tie: the two frameworks sum the
  score products in other orders, which can move a score across a step of
  v2's grid); on integer duplicate points every row equal;
- on rows with the same list: max and min bit-equal (the same bf16
  values), sum and sum of squares within rel 1e-5 of the row's norm;
  kernel 4 projects the whole cloud where the TPU kernel projects each
  selected row, so one of its values may round to the other side of a
  bf16 step: there each output is held within rel 1e-5 of the row's
  norm plus one bf16 step (2^-7) of the row's largest reduced magnitude
  (for the sum of squares, the move of its square: twice that times the
  magnitude);
- kernel 7 on the same idx: rel 1e-5 of each row's norm, bit-equal on
  integer data where every operation is exact (slope 1/4, power-of-two
  scales and a w2 with one power of two a column);
- kernels 5 and 8 on the same idx: each edge's addend is rounded to bf16
  after f32 arithmetic that the two frameworks may contract or order
  otherwise (an FMA, the dh1 product), so now and then an addend rounds
  to the other side of a bf16 step.  da (kernel 8's da1) is held within
  one bf16 step (2^-7) of the sum of its addends' magnitudes plus rel
  1e-5 of its row's norm, at most one value in 100 beyond rel 1e-5 of
  its row's norm, while the sum of the unrounded addends has over one in
  10 beyond it (the rounding is modelled); kernel 5 bit-equal on integer
  data; kernel 8's db1, ds1, dt1 and dW2 within rel 1e-5 (its cotangents
  are divided by tie counts, inexact on integer data too);
- kernel 4's backward: zero (row, channel) pairs whose max or min finds
  no selected value equal to it; its da that of kernel 5's AMP form on
  bf16(xw_project(bf16(x), w)), chained into dx and dw within rel 1e-6,
  and held as kernel 5's against the JAX package's edge_reduce_bwd(
  exact=False) fed bf16(bf16(x) @ w).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.ops.amp_select import (
    EXACT_ENV,
    EXTRACT_ENV,
    amp_scores,
    round_bf16,
    training_variant,
    use_amp_train,
)
from dgcnn_tpu_torch.ops.edge2_reduce_kernel import (
    edge2_bwd,
    edge2_bwd_amp_edges,
    edge2_fwd,
)
from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import (
    edge_reduce_bwd,
    edge_reduce_bwd_amp_addends,
    scatter_edges,
)
from dgcnn_tpu_torch.ops.knn_edge_reduce import knn_edge_reduce_xw
from dgcnn_tpu_torch.ops.knn_reduce_kernel import (
    knn_reduce,
    knn_reduce_xw,
    xw_project,
)

F32 = "float32"
K = 20
STEP = 2.0 ** -7  # one bf16 step, relative to a value's leading bit


@pytest.fixture
def amp_env(monkeypatch):
    """The JAX package's AMP default: its fused path forced on (interpret
    mode on the CPU), both variables unset, no trace of an earlier
    setting."""
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.delenv(EXACT_ENV, raising=False)
    monkeypatch.delenv(EXTRACT_ENV, raising=False)
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


def _np(x):
    return np.asarray(x, np.float32)


def _row_rel(got, want) -> np.ndarray:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(got - want, axis=-1)
            / np.linalg.norm(want, axis=-1).clip(1e-30))


def _cloud(kind: str, seed: int, c: int, b: int = 2, n: int = 256):
    rng = np.random.default_rng(seed)
    if kind == "ints":  # integer points, each four times
        return np.concatenate([rng.integers(-3, 4, (b, n // 4, c))] * 4,
                              axis=1).astype(np.float32)
    return rng.standard_normal((b, n, c)).astype(np.float32)


def _feats(kind: str, seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ints":
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _same_rows(graph, got_idx, want_idx) -> np.ndarray:
    """Rows whose lists are equal; asserts that every other row differs
    only at near ties of its AMP scores (module docstring)."""
    got_idx, want_idx = np.asarray(got_idx), np.asarray(want_idx)
    same = (got_idx == want_idx).all(-1)
    if not same.all():
        s = amp_scores(graph, graph).numpy()
        scale = np.abs(s).max(-1)
        for b, i in zip(*np.nonzero(~same)):
            d = np.nonzero(got_idx[b, i] != want_idx[b, i])[0]
            gap = np.abs(s[b, i, got_idx[b, i, d]] - s[b, i, want_idx[b, i, d]])
            assert gap.max() <= 1e-5 * scale[b, i], (b, i, gap, scale[b, i])
    return same


# ------------------------------------------------------------- the switch
@pytest.mark.parametrize("extract", [None, "v1", "v2"])
@pytest.mark.parametrize("exact", [None, "1"])
def test_training_variant_matches_jax(extract, exact, monkeypatch):
    """``training_variant(amp)`` is the JAX kernels 3 and 4's
    ``_extract_version("v1" if exact else "v2", ("v1", "v2"))`` in either
    mode; kernel 11 keeps the exact rule (``training_variant()``)."""
    from dgcnn_tpu.ops.pallas_knn import _extract_version

    for name, value in ((EXTRACT_ENV, extract), (EXACT_ENV, exact)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    amp = exact is None
    assert training_variant(amp) == _extract_version(
        "v2" if amp else "v1", ("v1", "v2"))
    assert training_variant() == _extract_version("v1", ("v1", "v2"))
    assert training_variant(True) == (extract or ("v1" if exact else "v2"))


def test_use_amp_train_rules(monkeypatch):
    """AMP on the card by default, exact on the CPU and under the exact
    pin; an explicit mode wins; clouds the kernels do not take and k > 64
    train exact either way."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv(EXACT_ENV, raising=False)
    assert use_amp_train(None, cuda, 1024, 20)
    assert not use_amp_train(None, cpu, 1024, 20)
    assert use_amp_train(True, cpu, 1024, 20)
    assert not use_amp_train(False, cuda, 1024, 20)
    assert not use_amp_train(None, cuda, 1000, 20)
    assert not use_amp_train(True, cuda, 1024, 65)
    monkeypatch.setenv(EXACT_ENV, "1")
    assert not use_amp_train(None, cuda, 1024, 20)
    assert use_amp_train(True, cuda, 1024, 20)


def test_amp_v1_has_no_cuda_form(monkeypatch):
    """The AMP form with DGCNN_TPU_EXTRACT=v1 raises before any launch
    (meta tensors stand for the card's); its plain version runs v1 on the
    AMP scores; the AMP forms of kernels 5, 7 and 8 raise on the routes
    they do not have."""
    monkeypatch.delenv(EXACT_ENV, raising=False)
    monkeypatch.setenv(EXTRACT_ENV, "v1")
    g = torch.empty((1, 128, 3), device="meta")
    a = torch.empty((1, 128, 64), device="meta")
    w = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="AMP mode's v1"):
        knn_reduce(g, a, 20, amp=True)
    with pytest.raises(ValueError, match="AMP mode's v1"):
        knn_reduce_xw(g, a, w, 20, amp=True)
    rng = np.random.default_rng(1)
    gc = torch.from_numpy(rng.standard_normal((1, 128, 3)).astype(
        np.float32))
    ac = torch.from_numpy(rng.standard_normal((1, 128, 8)).astype(
        np.float32))
    idx = knn_reduce(gc, ac, 6, amp=True)[0]
    want = torch.sort(amp_scores(gc, gc), dim=-1, descending=True,
                      stable=True).indices[..., :6]
    assert torch.equal(idx.long(), want)


# ------------------------------------------------------------ kernels 3, 4
@pytest.mark.parametrize("kind", ["random", "ints"])
def test_knn_reduce_amp_matches_pallas(kind, amp_env):
    """Kernel 3's AMP form against ``fused_knn_reduce(select_dtype=bf16)``
    (bf16x3 scores, v2, bf16 rows, f32 sums) on a 3-channel and a
    16-channel graph."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    ints = kind == "ints"
    a = _feats(kind, 12, (2, 256, 24))
    for c, seed in ((3, 10), (16, 11)):
        g = _cloud(kind, seed, c)
        with jax.default_matmul_precision(F32):
            want = fused_knn_reduce(jnp.asarray(g), jnp.asarray(a), K,
                                    select_dtype=jnp.bfloat16,
                                    interpret=True, with_sumsq=True)
        gt = torch.from_numpy(g)
        got = knn_reduce(gt, torch.from_numpy(a), K, amp=True)
        same = _same_rows(gt, got[0], want[0])
        assert same.mean() >= (1.0 if ints else 0.99), same.mean()
        for i, (gr, wr) in enumerate(zip(got[1:], want[1:])):
            gr, wr = gr.numpy()[same], _np(wr)[same]
            if ints or i < 2:
                np.testing.assert_array_equal(gr, wr)
            else:
                assert _row_rel(gr, wr).max() <= 1e-5


def test_knn_reduce_xw_amp_matches_pallas(amp_env):
    """Kernel 4's AMP form against ``fused_knn_reduce_xw(select_dtype=
    bf16)``, 32 -> 160 channels: the TPU kernel's bf16(bf16(x)[idx] @ w)
    from the port's whole-cloud projection rounded after selection."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce_xw

    g = _cloud("random", 13, 16)
    x = _feats("random", 14, (2, 256, 32))
    w = (_feats("random", 15, (32, 160)) / np.sqrt(32)).astype(np.float32)
    with jax.default_matmul_precision(F32):
        want = fused_knn_reduce_xw(*map(jnp.asarray, (g, x, w)), K,
                                   select_dtype=jnp.bfloat16,
                                   interpret=True, with_sumsq=True)
    gt = torch.from_numpy(g)
    got = knn_reduce_xw(gt, torch.from_numpy(x), torch.from_numpy(w), K,
                        amp=True)
    same = _same_rows(gt, got[0], want[0])
    assert same.mean() >= 0.99, same.mean()
    top = np.maximum(np.abs(_np(want[1])), np.abs(_np(want[2]))).max(-1)
    for i, (gr, wr) in enumerate(zip(got[1:], want[1:])):
        gr, wr = gr.numpy().astype(np.float64), _np(wr).astype(np.float64)
        bound = (1e-5 * np.linalg.norm(wr, axis=-1)
                 + STEP * top * (2 * top if i == 3 else 1.0))
        err = np.abs(gr - wr).max(-1)
        assert (err <= bound)[same].all()


# ------------------------------------------------------------- kernel 5
@pytest.mark.parametrize("kind", ["random", "ints"])
def test_edge_reduce_bwd_amp_matches_pallas(kind, amp_env):
    """Kernel 5's AMP form against ``edge_reduce_bwd(exact=False)`` on
    the JAX forward's idx, amax and amin: every max and min finds its
    match among the bf16 rows; da as the module docstring says."""
    from dgcnn_tpu.ops.pallas_knn import edge_reduce_bwd as jax_bwd
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    g = _cloud(kind, 16, 3)
    a = _feats(kind, 17, (2, 256, 64))
    cts = [_feats(kind, 18 + i, (2, 256, 64)) for i in range(4)]
    with jax.default_matmul_precision(F32):
        idx, amax, amin = fused_knn_reduce(
            jnp.asarray(g), jnp.asarray(a), K, select_dtype=jnp.bfloat16,
            interpret=True, with_sumsq=True)[:3]
        want = jax_bwd(idx, jnp.asarray(a), amax, amin,
                       *map(jnp.asarray, cts), K, exact=False,
                       interpret=True)
    args = [torch.from_numpy(np.asarray(t)) for t in (idx, a, amax, amin)]
    sel = round_bf16(args[1])[torch.arange(2)[:, None, None],
                              args[0].long()]
    for v in (args[2], args[3]):
        assert (sel == v[:, :, None]).any(2).all()
    got = edge_reduce_bwd(*args, *map(torch.from_numpy, cts), amp=True)
    if kind == "ints":
        np.testing.assert_array_equal(got.numpy(), _np(want))
        return
    _held_bf16_sum(got.numpy(), _np(want), edge_reduce_bwd_amp_addends(
        *args, *map(torch.from_numpy, cts)), args[0])


# ---------------------------------------------------------- kernels 7, 8
def _edge2_inputs(kind: str, seed: int):
    """a1, b1, s1, t1, w2 and idx of kernels 7 and 8 (C1 = C2 = 32); on
    integer data power-of-two scales and a w2 with one power of two a
    column, so that with slope 1/4 every operation is exact."""
    rng = np.random.default_rng(seed)
    shape = (2, 256, 32)
    if kind == "ints":
        a1 = rng.integers(-3, 4, shape).astype(np.float32)
        b1 = rng.integers(-3, 4, shape).astype(np.float32)
        s1 = np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), 8)
        t1 = rng.integers(-2, 3, 32).astype(np.float32)
        w2 = np.zeros((32, 32), np.float32)
        w2[rng.integers(0, 32, 32), np.arange(32)] = rng.choice(
            np.float32([-2.0, -0.5, 0.5, 1.0, 2.0]), 32)
    else:
        a1 = rng.standard_normal(shape).astype(np.float32)
        b1 = rng.standard_normal(shape).astype(np.float32)
        s1 = (rng.uniform(0.5, 1.5, 32)
              * np.where(rng.random(32) < 0.15, -1, 1)).astype(np.float32)
        t1 = (0.1 * rng.standard_normal(32)).astype(np.float32)
        w2 = (rng.standard_normal((32, 32)) / np.sqrt(32)).astype(np.float32)
    idx = rng.integers(0, 256, (2, 256, K)).astype(np.int32)
    return a1, b1, s1, t1, w2, idx


@pytest.mark.parametrize("kind", ["random", "ints"])
def test_edge2_amp_kernels_match_pallas(kind, amp_env):
    """Kernels 7 and 8's AMP forms against ``_edge2_fwd_call`` and
    ``_edge2_bwd_call`` with exact=False on the same idx (the backward
    given the JAX forward's max and min)."""
    from dgcnn_tpu.ops.pallas_knn import _edge2_bwd_call, _edge2_fwd_call

    ins = _edge2_inputs(kind, 20)
    cts = [_feats(kind, 21 + i, (2, 256, 32)) for i in range(4)]
    slope = 0.25 if kind == "ints" else 0.2
    with jax.default_matmul_precision(F32):
        fwd = _edge2_fwd_call(*map(jnp.asarray, ins), K, slope, False,
                              interpret=True)
        bwd = _edge2_bwd_call(*map(jnp.asarray, ins), fwd[0], fwd[1],
                              *map(jnp.asarray, cts), K, slope, False,
                              interpret=True)
    tins = [torch.from_numpy(t) for t in ins]
    got = edge2_fwd(*tins, slope, amp=True)
    for gr, wr in zip(got, fwd):
        if kind == "ints":
            np.testing.assert_array_equal(gr.numpy(), _np(wr))
        else:
            assert _row_rel(gr, wr).max() <= 1e-5
    mx, mn = (torch.from_numpy(_np(t)) for t in fwd[:2])
    gots = edge2_bwd(*tins, mx, mn, *map(torch.from_numpy, cts), slope,
                     amp=True)
    # the backward divides cotangents by tie counts: inexact on integers too
    da1, want_da1 = gots[0].numpy(), _np(bwd[0])
    for gr, wr in zip(gots[1:], bwd[1:]):
        gr = gr.detach().numpy()
        assert (np.linalg.norm(gr - _np(wr))
                <= 1e-5 * np.linalg.norm(_np(wr))), gr.shape
    dsel = edge2_bwd_amp_edges(*tins, *map(torch.from_numpy, cts), slope)[0]
    _held_bf16_sum(da1, want_da1, dsel, tins[5])


def _held_bf16_sum(got, want, addends, idx):
    """``got`` (B, N, C), a sum over each point's in-edges of bf16-rounded
    ``addends`` (B, N, k, C, unrounded), against ``want`` (module
    docstring)."""
    tol = 1e-5 * np.linalg.norm(want, axis=-1, keepdims=True)
    err = np.abs(got - want)
    mag = scatter_edges(addends.abs(), idx).numpy()
    assert (err <= STEP * mag + tol).all()
    assert (err > tol).mean() <= 1e-2, (err > tol).mean()
    unrounded = scatter_edges(addends, idx).numpy()
    assert (np.abs(unrounded - want) > tol).mean() > 0.1


# ------------------------------------------------------ kernel 4 backward
def _xw_case():
    """The shape of the record below: one cloud of 256 points, 128 -> 256
    channels, k = 20, random normal rows."""
    rng = np.random.default_rng(40)
    g = rng.standard_normal((1, 256, 128)).astype(np.float32)
    x = rng.standard_normal((1, 256, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 256)) / np.sqrt(128)).astype(np.float32)
    cts = [rng.standard_normal((1, 256, 256)).astype(np.float32)
           for _ in range(4)]
    return g, x, w, cts


def _unmatched(a_rows, idx, amax, amin) -> int:
    """(row, channel) pairs whose max or min equals none of the selected
    values of ``a_rows``."""
    sel = a_rows[torch.arange(a_rows.shape[0])[:, None, None], idx.long()]
    hit_max = (sel == amax[:, :, None]).any(2)
    hit_min = (sel == amin[:, :, None]).any(2)
    return int((~hit_max).sum() + (~hit_min).sum())


def test_knn_reduce_xw_amp_backward_finds_every_match(amp_env):
    """The port's AMP select-x backward re-selects the rows its forward
    reduced, bf16(xw_project(bf16(x), w)): no max or min lacks its match;
    its dx and dw are kernel 5's AMP da on those rows chained through w
    and x, and that da is held against the JAX package's
    edge_reduce_bwd(exact=False) fed bf16(bf16(x) @ w) and the JAX
    forward's outputs (module docstring)."""
    from dgcnn_tpu.ops.pallas_knn import edge_reduce_bwd as jax_bwd
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce_xw

    g, x, w, cts = _xw_case()
    gt, xt, wt = map(torch.from_numpy, (g, x, w))
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    out = knn_edge_reduce_xw(gt, xt, wt, K, True)
    idx, amax, amin = (t.detach() for t in out[:3])
    rows = round_bf16(xw_project(round_bf16(xt.detach()), wt.detach()))
    assert _unmatched(rows, idx, amax, amin) == 0
    torch.autograd.backward(out[1:], tuple(map(torch.from_numpy, cts)))
    da = edge_reduce_bwd(idx, rows, amax, amin, *map(torch.from_numpy, cts),
                         amp=True)
    assert _row_rel(xt.grad, da @ wt.detach().t()).max() <= 1e-6
    dw = da.reshape(-1, 256).t() @ torch.from_numpy(x).reshape(-1, 128)
    assert (torch.linalg.norm(wt.grad - dw.t())
            <= 1e-6 * torch.linalg.norm(dw))
    with jax.default_matmul_precision(F32):
        fwd = fused_knn_reduce_xw(*map(jnp.asarray, (g, x, w)), K,
                                  select_dtype=jnp.bfloat16, interpret=True,
                                  with_sumsq=True)
        xb = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
        a = (xb @ jnp.asarray(w)).astype(jnp.bfloat16).astype(jnp.float32)
        want = jax_bwd(fwd[0], a, fwd[1], fwd[2], *map(jnp.asarray, cts), K,
                       exact=False, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(fwd[0]))
    jmax, jmin = (torch.from_numpy(_np(t)) for t in fwd[1:3])
    assert torch.equal(amax, jmax) and torch.equal(amin, jmin)
    assert _unmatched(torch.from_numpy(_np(a)), idx, jmax, jmin) == 0
    _held_bf16_sum(da.numpy(), _np(want), edge_reduce_bwd_amp_addends(
        idx, rows, amax, amin, *map(torch.from_numpy, cts)), idx)


def test_jax_xw_backward_drops_matches_on_cpu(amp_env):
    """On record: the JAX package's ``_ker_xw_bwd`` recomputes ``a =
    _project(x, w)`` from the f32 x, so on the CPU (where the projection
    does not round x to bf16) many of the forward's maxima and minima,
    values of bf16(bf16(x) @ w), find no equal bf16 row, and their
    cotangents are dropped: its dx is not the contract's."""
    from dgcnn_tpu.ops import pallas_knn

    g, x, w, cts = _xw_case()
    with jax.default_matmul_precision(F32):
        args = tuple(map(jnp.asarray, (g, x, w)))
        out, vjp = jax.vjp(
            lambda xx, ww: pallas_knn.knn_edge_reduce_xw(args[0], xx, ww,
                                                         K)[1:],
            args[1], args[2])
        dx = vjp(tuple(map(jnp.asarray, cts)))[0]
        a = jnp.asarray(x) @ jnp.asarray(w)
    idx = torch.from_numpy(np.asarray(pallas_knn.fused_knn_reduce_xw(
        *args, K, select_dtype=jnp.bfloat16, interpret=True,
        with_sumsq=True)[0]))
    lost = _unmatched(round_bf16(torch.from_numpy(np.asarray(a))), idx,
                      torch.from_numpy(_np(out[0])),
                      torch.from_numpy(_np(out[1])))
    assert lost > 1000, lost  # of 2 * 256 * 256 pairs
    gt, xt, wt = map(torch.from_numpy, (g, x, w))
    xt.requires_grad_(True)
    port = knn_edge_reduce_xw(gt, xt, wt, K, True)
    torch.autograd.backward(port[1:], tuple(map(torch.from_numpy, cts)))
    assert _row_rel(xt.grad, dx).max() > 1e-2
