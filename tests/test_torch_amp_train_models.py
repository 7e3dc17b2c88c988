"""One AMP (bf16) training step of the port's DGCNNCls, DGCNNSemSeg and
DGCNNPartSeg against the JAX package's AMP step, and the training mode
switch of the models, on the CPU at small sizes.

Both sides start from the same flax variables (carried over with
``state_dict_from_flax``) and take the same numpy batch, dropout 0.  The
JAX side runs its AMP training kernels in Pallas interpret mode
(``DGCNN_TPU_PALLAS=1``, ``DGCNN_TPU_PALLAS_EXACT`` unset) under
``jax.default_matmul_precision("float32")``; the port's side is the plain
versions of the AMP forms (``amp=True``).

A stage's input carries the f32 rounding of the stages before it, which
the two frameworks sum in other orders, and a point whose k-th and
(k+1)-th AMP scores nearly tie can then pick another neighbour in each;
one such flip moves a gradient by up to 1e-2.  So the port's AMP stages
take the JAX forward's neighbour lists (recorded from
``fused_knn_reduce`` / ``fused_knn_reduce_xw``), after the port's own
list of each stage is held to them: at most one row in 100 differs, and
at each slot that differs the two members' AMP scores lie within 1e-5 of
the row's score scale.

The AMP forms round values to bf16 after f32 arithmetic whose order each
framework picks (the select-x projection of each selected row on the TPU,
of the whole cloud here; kernels 5 and 8's addends after the dh1 product
or an FMA): a difference of one f32 rounding moves a value across a bf16
step now and then, by 2^-8 of itself, and the moves spread through the
stages before and behind it.  So no gradient holds to rel 1e-4 beyond the
first rounding (measured: 2e-3 to 2e-2 of each tensor's norm, the
downstream convs and head too).  The yardstick is the AMP step's own
sensitivity: the port's AMP step on the first input moved by ~2^-22 of
each value (two f32 roundings).  The step is held by:

- the loss within rel 1e-4;
- all gradients together (those of norm over 1e-3 of the model's
  largest; the rest are rounding noise, a BatchNorm bias behind a
  training BatchNorm) at cosine >= 0.999 to the JAX step's, nearer to it
  than twice the nudged step's move, and nearer than a fifth of the
  port's exact step's distance from it (the AMP numerics, not the exact
  ones);
- each of those gradients nearer to the JAX step's than three times its
  nudged move (measured at seeds 70-72: at most 0.9 overall, 1.0 for a
  tensor; 0.09 of the exact distance);
- each running statistic within rel 1e-4 of its norm or three times its
  nudged move, and within rel 1e-4 or a fifth of the exact step's
  distance.

For DGCNNCls the JAX package's stage 4 (the select-x form) recomputes the
projection from the f32 x in its backward (pallas_knn.py:809-823), which
on the CPU loses the forward's maxima and minima
(tests/test_torch_amp_train.py holds that on record).  The test gives the
JAX model a select-x reduction that keeps the contract the port keeps: a
``jax.custom_vjp`` of the package's own ``fused_knn_reduce_xw`` whose
backward feeds ``edge_reduce_bwd(exact=False)`` the forward's rows,
bf16(bf16(x) @ w); ``nn_layers.EdgeConv`` imports it from
``dgcnn_tpu.ops.pallas_knn`` at call time.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNCls, DGCNNSemSeg
from dgcnn_tpu_torch.ops.amp_select import EXACT_ENV, EXTRACT_ENV
from dgcnn_tpu_torch.train.loss import cross_entropy

F32 = "float32"
N, K = 256, 8


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


def _contract_xw(monkeypatch):
    """``pallas_knn.knn_edge_reduce_xw`` replaced by its AMP form whose
    backward re-selects the forward's rows (module docstring)."""
    from dgcnn_tpu.ops import pallas_knn as pk

    bf16 = jnp.bfloat16

    @functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
    def ker(xg, x, w, k):
        return pk.fused_knn_reduce_xw(xg, x, w, k, select_dtype=bf16,
                                      with_sumsq=True)

    def fwd(xg, x, w, k):
        out = ker(xg, x, w, k)
        return out, (xg, x, w, out[0], out[1], out[2])

    def bwd(k, res, cts):
        xg, x, w, idx, amax, amin = res
        xb = x.astype(bf16).astype(jnp.float32)
        a = jnp.einsum("bnc,co->bno", xb, w).astype(bf16).astype(jnp.float32)
        da = pk.edge_reduce_bwd(idx, a, amax, amin, *cts[1:], k, exact=False)
        return (jnp.zeros_like(xg), jnp.einsum("bno,co->bnc", da, w),
                jnp.einsum("bnc,bno->co", x, da))

    ker.defvjp(fwd, bwd)
    monkeypatch.setattr(pk, "knn_edge_reduce_xw", ker)


def _jax_lists(monkeypatch, fmodel, variables, inputs):
    """The neighbour lists of the JAX package's AMP training forward, one
    a stage in call order."""
    from dgcnn_tpu.ops import pallas_knn as pk

    lists = []
    inner = {name: getattr(pk, name)
             for name in ("fused_knn_reduce", "fused_knn_reduce_xw")}
    for name, fn in inner.items():
        def rec(*args, _fn=fn, **kw):
            out = _fn(*args, **kw)
            lists.append(torch.from_numpy(np.asarray(out[0])).long())
            return out
        monkeypatch.setattr(pk, name, rec)
    with jax.default_matmul_precision(F32):
        fmodel.apply(variables, *map(jnp.asarray, inputs), train=True,
                     rngs={"dropout": jax.random.PRNGKey(1)},
                     mutable=["batch_stats"])
    for name, fn in inner.items():
        monkeypatch.setattr(pk, name, fn)
    return lists


def _pin_lists(monkeypatch, lists):
    """The port's AMP stages take ``lists`` in order, each after the
    port's own list is held to it (module docstring)."""
    from dgcnn_tpu_torch.ops import knn_reduce_kernel as krk

    own = krk.v2_indices

    def pinned(scores, k):
        mine, want = own(scores, k), lists.pop(0)
        same = (mine == want).all(-1)
        assert same.float().mean() >= 0.99
        s = scores.gather(-1, mine) - scores.gather(-1, want)
        scale = scores.abs().amax(-1, keepdim=True)
        assert (s.abs() <= 1e-5 * scale).all()
        return want

    monkeypatch.setattr(krk, "v2_indices", pinned)


def _jax_grads(fmodel, variables, inputs, labels):
    from dgcnn_tpu.train.loss import cross_entropy as jax_ce

    def loss_fn(params):
        logits, upd = fmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *map(jnp.asarray, inputs), train=True,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(labels)), upd["batch_stats"]

    with jax.default_matmul_precision(F32):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
    return float(loss), state_dict_from_flax({"params": grads,
                                              "batch_stats": stats})


def _port_step(model, variables, inputs, labels, amp, lists=None):
    """A fresh copy of ``model`` at ``variables``, its loss and gradients
    of one training step (``lists``: the AMP stages' pinned lists)."""
    m = copy.deepcopy(model)
    m.load_state_dict(state_dict_from_flax(variables), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        if lists is not None:
            _pin_lists(mp, lists)
        loss = cross_entropy(m(*map(torch.from_numpy, inputs), train=True,
                               amp=amp), torch.from_numpy(labels))
        loss.backward()
    return loss.item(), {n: p.grad for n, p in m.named_parameters()}, m


def _held_step(model, variables, fmodel, inputs, labels, monkeypatch,
               stages):
    """The port's AMP step against the JAX package's (module docstring)."""
    lists = _jax_lists(monkeypatch, fmodel, variables, inputs)
    assert len(lists) == stages
    if isinstance(model, DGCNNCls):
        _contract_xw(monkeypatch)
    want_loss, want = _jax_grads(fmodel, variables, inputs, labels)
    loss, grads, stepped = _port_step(model, variables, inputs, labels, True,
                                      lists)
    assert not lists
    assert loss == pytest.approx(want_loss, rel=1e-4)
    # the port's own moves: its exact step, and its AMP step on the first
    # input moved by ~2^-22 of each value
    _, exact, exact_m = _port_step(model, variables, inputs, labels, False)
    x = inputs[0]
    noise = np.random.default_rng(0).standard_normal(x.shape)
    moved = ((x * (1 + 2.0 ** -22 * noise)).astype(np.float32),
             *inputs[1:])
    _, nudged, nudged_m = _port_step(model, variables, moved, labels, True)
    floor = 1e-3 * max(torch.linalg.norm(g).item() for g in grads.values())
    kept = [n for n in grads
            if np.linalg.norm(np.asarray(want[n])) >= floor]
    for name in kept:
        g, w = grads[name], torch.as_tensor(np.asarray(want[name]))
        assert (torch.linalg.norm(g - w)
                <= 3 * torch.linalg.norm(nudged[name] - g)), name
    g, w, e, q = (torch.cat([torch.as_tensor(np.asarray(d[n])).reshape(-1)
                             for n in kept])
                  for d in (grads, want, exact, nudged))
    dist = torch.linalg.norm(g - w)
    assert (g @ w / (torch.linalg.norm(g) * torch.linalg.norm(w))) >= 0.999
    assert dist <= 2 * torch.linalg.norm(q - g)
    assert dist <= 0.2 * torch.linalg.norm(e - w)
    # the running statistics the step moved
    ex_sd, nu_sd = exact_m.state_dict(), nudged_m.state_dict()
    for name, got in stepped.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            w = np.asarray(want[name])
            err = np.linalg.norm(got.numpy() - w)
            assert err <= max(1e-4 * np.linalg.norm(w),
                              3 * np.linalg.norm(nu_sd[name] - got).item()
                              ), name
            assert err <= 0.2 * np.linalg.norm(ex_sd[name].numpy() - w) \
                or err <= 1e-4 * np.linalg.norm(w), name


def test_dgcnn_cls_amp_step_matches_jax(amp_env):
    """DGCNNCls: kernels 3, 4 (the 128 -> 256 stage) and 5 in AMP."""
    from dgcnn_tpu.models import DGCNNCls as FlaxDGCNNCls

    fmodel = FlaxDGCNNCls(emb_dims=32, k=K, dropout=0.0)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((2, N, 3), jnp.float32), train=False)
    rng = np.random.default_rng(70)
    points = rng.standard_normal((8, N, 3)).astype(np.float32)
    labels = rng.integers(0, 40, 8).astype(np.int64)
    model = DGCNNCls(emb_dims=32, k=K, dropout=0.0, device="cpu")
    _held_step(model, variables, fmodel, (points,), labels, amp_env, 4)


def test_dgcnn_semseg_amp_step_matches_jax(amp_env):
    """DGCNNSemSeg: kernels 3, 5, 7 and 8 in AMP (two two-conv stages and
    conv5)."""
    from dgcnn_tpu.models import DGCNNSemSeg as FlaxDGCNNSemSeg

    fmodel = FlaxDGCNNSemSeg(emb_dims=32, k=K, dropout=0.0)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((2, N, 9), jnp.float32), train=False)
    rng = np.random.default_rng(71)
    blocks = rng.random((4, N, 9)).astype(np.float32)
    seg = rng.integers(0, 13, (4, N)).astype(np.int64)
    model = DGCNNSemSeg(emb_dims=32, k=K, dropout=0.0, device="cpu")
    _held_step(model, variables, fmodel, (blocks,), seg, amp_env, 3)


# ------------------------------------------------------------- the switch
def _grads(model, x, *rest, **kw):
    model.zero_grad()
    out = model(x, *rest, train=True, **kw)
    out.square().mean().backward()
    return out.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("cls", [DGCNNCls, DGCNNSemSeg])
def test_training_mode_switch(cls, monkeypatch):
    """On the CPU the default training step is the exact one, bit for bit,
    and so it is under DGCNN_TPU_PALLAS_EXACT; amp=True switches every
    training kernel to its AMP form at once (kernels 3 / 4 / 5 for
    DGCNNCls, 3 / 5 / 7 / 8 for DGCNNSemSeg), and its step differs."""
    from dgcnn_tpu_torch.models import dgcnn, nn_layers

    monkeypatch.delenv(EXACT_ENV, raising=False)
    c = 3 if cls is DGCNNCls else 9
    model = cls(emb_dims=32, k=K, dropout=0.0, device="cpu",
                generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 128, c)).astype(np.float32))
    modes = []

    def spy(fn):
        def run(*args):
            modes.append((fn.__name__, args[-1]))
            return fn(*args)
        return run

    for mod, name in ((dgcnn, "knn_edge_reduce"), (dgcnn, "edge2_reduce"),
                      (nn_layers, "knn_edge_reduce"),
                      (nn_layers, "knn_edge_reduce_xw")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    exact = _grads(copy.deepcopy(model), x, amp=False)
    default = _grads(copy.deepcopy(model), x)
    assert {m for _, m in modes} == {False}
    monkeypatch.setenv(EXACT_ENV, "1")
    pinned = _grads(copy.deepcopy(model), x)
    for got in (default, pinned):
        assert torch.equal(got[0], exact[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], exact[1]))
    modes.clear()
    amp = _grads(copy.deepcopy(model), x, amp=True)
    names = sorted(n for n, _ in modes)
    assert {m for _, m in modes} == {True}
    assert names == (["knn_edge_reduce"] * 3 + ["knn_edge_reduce_xw"]
                     if cls is DGCNNCls else
                     ["edge2_reduce"] * 2 + ["knn_edge_reduce"] * 3)
    assert not torch.equal(amp[0], exact[0])


def test_net_trains_exact(monkeypatch):
    """The fusion Net's training takes the mode of ``use_amp_train``: on
    the CPU its default step is the exact one, bit for bit, and so it is
    under DGCNN_TPU_PALLAS_EXACT, every backbone stage exact and the
    attention in f32; amp=True switches every stage to the AMP forms and
    the attention to bf16 at once, and its step differs, so that no step
    mixes the two."""
    from dgcnn_tpu_torch.models import Net, nn_layers, torch_transformer

    monkeypatch.delenv(EXACT_ENV, raising=False)
    modes, dtypes = [], []

    def spy(fn):
        def run(*args):
            modes.append(args[-1])
            return fn(*args)
        return run

    attention = torch_transformer.fused_attention

    def spy_attention(q, *rest):
        dtypes.append(q.dtype)
        return attention(q, *rest)

    for name in ("knn_edge_reduce", "knn_edge_reduce_xw"):
        monkeypatch.setattr(nn_layers, name, spy(getattr(nn_layers, name)))
    monkeypatch.setattr(torch_transformer, "fused_attention", spy_attention)
    net = Net(emb_dim=128, k=8, n_heads=1, n_blocks=1, ff_dims=32,
              nclasses=5, dropout=0.0, device="cpu",
              generator=torch.Generator().manual_seed(73))
    pts = torch.randn(2, 128, 3, generator=torch.Generator().manual_seed(74))
    oh = torch.eye(16)[[1, 4]]

    def step(**kw):
        m = copy.deepcopy(net)
        out = m(pts, oh, train=True, **kw)
        out.square().mean().backward()
        return out.detach(), [p.grad for p in m.parameters()]

    exact = step(amp=False)
    default = step()
    monkeypatch.setenv(EXACT_ENV, "1")
    pinned = step()
    assert modes == [False] * 12 and set(dtypes) == {torch.float32}
    for got in (default, pinned):
        assert torch.equal(got[0], exact[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], exact[1]))
    monkeypatch.delenv(EXACT_ENV)
    modes.clear()
    dtypes.clear()
    amp = step(amp=True)
    assert modes == [True] * 4 and dtypes == [torch.bfloat16] * 4
    assert not torch.equal(amp[0], exact[0])
