"""The port's AMP (bf16) training of the fusion Net against the JAX
package's default mode, on the CPU at small sizes: kernel 14's bf16
training form and kernel 15's bf16 form (their plain versions), ``dense``'s
bf16 gradients, one AMP step of a small ``Net`` and the training mode
switch.

The JAX side runs its fused Pallas path in interpret mode
(``DGCNN_TPU_PALLAS=1``, ``DGCNN_TPU_PALLAS_EXACT`` unset: its AMP
default; the ``amp_env`` fixture) under
``jax.default_matmul_precision("float32")``.  Its random stream cannot run
on the CPU, so at rate > 0 the attention is held against the TPU kernels'
arithmetic (``pallas_attention._probs`` and the ``jnp.where`` chain of
``_attn_fwd_kernel`` / ``_attn_bwd_kernel``) given the port's own mask.
A bf16 output or gradient is held within one bf16 ulp of each value,
floored at 2^-8 of its row's norm (``_held``), on every value.

The Net step: both sides start from the port's seeded weights (through
``convert_net``) and take the same numpy batch, dropout 0.  On the CPU the
JAX transformer would take its dense attention (its fused kernel is its
accelerator's); the test routes it to the fused Pallas kernels 14 and 15,
which the port mirrors, by answering its backend check
(``torch_transformer._pallas_ok``) for the shapes those kernels take.
Its select-x stage takes the contract-keeping reduction of
``test_torch_amp_train_models._contract_xw`` (the JAX package's own AMP
backward loses maxima on the CPU: ROADMAP C).  A bf16 rounding turns a
one-ulp f32 difference into a 2^-8 move, and the moves spread through
the backbone, the transformer and the kNN lists behind them; so the step
is held to its own sensitivity, the port's AMP step on the input moved by
~2^-22 of each value (as tests/test_torch_amp_train_models.py does), and
its AMP-vs-exact gradient cosine to the JAX package's own at the same
weights and batch (at this size neither reaches the 0.995 train gate of
tools/gates.py, which holds at the gate's B=8, N=2048 config: measured on
two seeds, JAX 0.9936 and 0.9600, the port 0.9955 and 0.9660).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import Net, nn_layers
from dgcnn_tpu_torch.ops.amp_select import EXACT_ENV
from dgcnn_tpu_torch.ops.attention import (
    attention_amp_bwd_plain,
    attention_amp_plain,
    attention_amp_train_plain,
    attention_fwd_amp,
    dropout_mask_plain,
    fused_attention,
)
from dgcnn_tpu_torch.train.loss import cross_entropy

from test_torch_amp_net import amp_env  # noqa: F401
from test_torch_amp_train_models import _contract_xw

F32 = "float32"
BF16 = torch.bfloat16


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)


def _held(got: torch.Tensor, want) -> None:
    """``got`` bf16 within one bf16 ulp of every value of ``want`` (a JAX
    array or a tensor), the ulp floored at 2^-8 of the value's row's norm:
    a gradient row that sums to near zero has values far below its terms'
    rounding."""
    assert got.dtype == BF16
    w = (want if isinstance(want, torch.Tensor) else _bf16(want)).float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    floor = 2.0 ** -8 * w.norm(dim=-1, keepdim=True)
    err = (got.float() - w).abs() / torch.maximum(ulp, floor)
    assert err.max().item() <= 1, err.max()


def _qkv_do(b, h, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((b, h, n, d)).astype(np.float32)
                        ).astype(jnp.bfloat16) for n in (nq, nk, nk, nq)]


def _port_vjp(q, k, v, do, scale, rate=0.0, seed=None):
    """The port's bf16 attention output and (dq, dk, dv) by autograd
    (``FusedAttentionAMP``: the plain versions on the CPU)."""
    qkv = [_bf16(t).requires_grad_() for t in (q, k, v)]
    out = fused_attention(*qkv, scale, rate, seed)
    grads = torch.autograd.grad(out, qkv, _bf16(do))
    return [out.detach()] + list(grads)


# ------------------------------------------------------ kernels 14 and 15
@pytest.mark.parametrize("d,nq,nk", [(128, 128, 256), (128, 256, 128),
                                     (256, 128, 256), (256, 256, 128)])
def test_attention_amp_train_matches_pallas(d, nq, nk, amp_env):
    """At rate 0, the port's bf16 attention in training (kernel 14's AMP
    training form, kernel 15's bf16 form backward; their plain versions)
    against jax.vjp of the Pallas fused_attention in interpret mode on bf16
    q, k and v: o, dq, dk and dv bf16 within one ulp (``_held``); o the
    evaluation form's bits, and the row statistics the plain forward's."""
    from dgcnn_tpu.ops.pallas_attention import fused_attention as jfused

    q, k, v, do = _qkv_do(2, 2, nq, nk, d, d + nq)
    scale = d ** -0.5
    with jax.default_matmul_precision(F32):
        out, vjp = jax.vjp(lambda a, b, c: jfused(
            a, b, c, sm_scale=scale, interpret=True), q, k, v)
        want = [out] + list(vjp(do))
    got = _port_vjp(q, k, v, do, scale)
    for g, w in zip(got, want):
        assert w.dtype == jnp.bfloat16 and g.shape == w.shape
        _held(g, w)
    tq, tk, tv = map(_bf16, (q, k, v))
    o, m, l = attention_amp_train_plain(tq, tk, tv, scale)
    assert torch.equal(o, attention_amp_plain(tq, tk, tv, scale))
    assert torch.equal(got[0], o)
    s = torch.matmul(tq.float(), tk.float().transpose(2, 3)) * scale
    assert torch.equal(m, s.amax(-1))
    np.testing.assert_allclose(
        l.numpy(), torch.exp(s - m[..., None]).double().sum(-1).numpy(),
        rtol=1e-6)


@pytest.mark.parametrize("d,rate", [(128, 0.0), (256, 0.5), (512, 0.0)])
def test_attention_fwd_amp_forms_on_the_cpu(d, rate):
    """``attention_fwd_amp`` on CPU tensors takes the plain versions and
    counts no launch: its evaluation form (rate 0, no ``with_stats``)
    returns o alone, ``attention_amp_plain``'s bits; ``with_stats`` or a
    rate returns the training form's (o, m, l), ``attention_amp_train_plain``'s
    bits, with the evaluation form's o at rate 0."""
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn((1, 2, n, d), generator=g).to(BF16)
               for n in (64, 96, 96))
    seed = torch.tensor([17], dtype=torch.int64) if rate else None
    scale = d ** -0.5
    launches = fused_attention.launches
    want = attention_amp_train_plain(q, k, v, scale, rate, seed)
    got = attention_fwd_amp(q, k, v, scale, rate, seed, with_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    o, m, l = attention_fwd_amp(q, k, v, scale, rate, seed)
    if rate:
        assert all(torch.equal(a, b) for a, b in zip((o, m, l), want))
    else:
        assert m is None and l is None
        assert torch.equal(o, attention_amp_plain(q, k, v, scale))
        assert torch.equal(o, got[0])
    assert fused_attention.launches == launches


def _kernel_math(q, k, v, do, keep, scale, rate):
    """The TPU kernels' arithmetic on bf16 inputs given a keep mask:
    ``_probs`` per (b, h), then ``_attn_fwd_kernel``'s output and
    ``_attn_bwd_kernel``'s gradients (pallas_attention.py:103-180)."""
    from dgcnn_tpu.ops.pallas_attention import _probs

    f32, bf = jnp.float32, jnp.bfloat16
    inv = 1.0 / (1.0 - rate)

    def dot(eq, a, b):
        return jnp.einsum(eq, a, b, preferred_element_type=f32)

    p = jax.vmap(jax.vmap(lambda a, b: _probs(a, b, scale)))(q, k)
    pt = jnp.where(keep, p * inv, 0.0)
    o = dot("bhqk,bhkd->bhqd", pt.astype(bf), v).astype(bf)
    dv = dot("bhqk,bhqd->bhkd", pt.astype(bf), do)
    dp = jnp.where(keep, dot("bhqd,bhkd->bhqk", do, v) * inv, 0.0)
    ds = p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))
    dsb = (ds * scale).astype(bf)
    dq = dot("bhqk,bhkd->bhqd", dsb, k)
    dk = dot("bhqk,bhqd->bhkd", dsb, q)
    return [o] + [t.astype(bf) for t in (dq, dk, dv)]


@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_attention_amp_train_with_dropout_matches_kernel_math(rate,
                                                              amp_env):
    """At rates 0.5 and 0.1 (d = 128 and 256), the port's bf16 attention
    and its gradients against the TPU kernels' arithmetic given the port's
    materialized mask (``_kernel_math``): within one ulp (``_held``); the
    mask drops about ``rate`` of the probabilities."""
    seed = torch.tensor([91], dtype=torch.int64)
    for d, nq, nk in ((128, 128, 256), (256, 256, 128)):
        q, k, v, do = _qkv_do(2, 2, nq, nk, d, d + 7)
        scale = d ** -0.5
        mask = dropout_mask_plain((2, 2, nq, nk), seed, rate).numpy() > 0
        with jax.default_matmul_precision(F32):
            want = _kernel_math(q, k, v, do, jnp.asarray(mask), scale, rate)
        got = _port_vjp(q, k, v, do, scale, rate, seed)
        for g, w in zip(got, want):
            _held(g, w)
        assert abs(mask.mean() - (1 - rate)) < 0.02
    with pytest.raises(ValueError, match="needs a seed"):
        fused_attention(*map(_bf16, (q, k, v)), scale, rate)


def test_attention_amp_backward_delta_is_the_sum_of_dp_p(amp_env):
    """Kernel 15's bf16 Delta is the TPU kernel's sum_j dp_ij p_ij over
    the f32 p, not rowsum(dO o) of the bf16 output o = bf16(bf16(p) v).
    Small integers make every product exact: value rows v_j = (a_j, a_j +
    e) and cotangent rows dO_i = (b_i, -b_i) give dp_ij = -b_i . e, one
    number a row, so the true dS = p (dp - Delta) vanishes but for Delta's
    f32 rounding, and so do dq and dk; rowsum(dO o) misses Delta by o's
    bf16 roundings, and the dq it gives is >= 100x larger.  The port's dq
    and dk are as small as the Pallas backward's (interpret mode)."""
    from dgcnn_tpu.ops.pallas_attention import fused_attention as jfused

    rng = np.random.default_rng(3)
    q, k = (jnp.asarray(rng.standard_normal((2, 2, 128, 256)).astype(
        np.float32)).astype(jnp.bfloat16) for _ in range(2))
    a = rng.integers(-3, 4, (2, 2, 128, 128))
    e = rng.integers(-3, 4, (1, 1, 1, 128))
    bb = rng.integers(-3, 4, (2, 2, 128, 128))
    v, do = (jnp.asarray(np.concatenate(t, axis=-1).astype(np.float32)
                         ).astype(jnp.bfloat16)
             for t in ((a, a + e), (bb, -bb)))
    scale = 256 ** -0.5
    with jax.default_matmul_precision(F32):
        _, vjp = jax.vjp(lambda x, y, z: jfused(
            x, y, z, sm_scale=scale, interpret=True), q, k, v)
        jdq, jdk, _ = vjp(do)
    _, dq, dk, _ = _port_vjp(q, k, v, do, scale)
    # dq from Delta = rowsum(dO o), everything else the port's
    tq, tk, tv, tdo = map(_bf16, (q, k, v, do))
    o, m, l = attention_amp_train_plain(tq, tk, tv, scale)
    s = torch.matmul(tq.float(), tk.float().transpose(2, 3)) * scale
    p = torch.exp(s - m[..., None]) / l[..., None]
    dp = torch.matmul(tdo.float(), tv.float().transpose(2, 3))
    assert torch.equal(dp, dp[..., :1].expand_as(dp))
    wrong = p * (dp - (tdo.float() * o.float()).sum(-1, keepdim=True))
    dq_wrong = torch.matmul((wrong * scale).to(BF16).float(), tk.float())
    big = dq_wrong.abs().max().item()
    for ours, theirs in ((dq, jdq), (dk, jdk)):
        small = max(ours.float().abs().max().item(),
                    float(np.abs(np.asarray(theirs, np.float32)).max()))
        assert small * 100 <= big, (small, big)
    want = attention_amp_bwd_plain(tq, tk, tv, m, l, None, tdo, scale)
    assert all(torch.equal(x, y) for x, y in zip(want[:2], (dq, dk)))


# ---------------------------------------------------------------- dense
@pytest.mark.parametrize("shape,co", [((4, 64, 96), 160), ((2, 300, 256),
                                                          64)])
def test_dense_bf16_gradients_match_flax(shape, co):
    """``nn_layers.dense`` in bf16 against flax's ``nn.Dense(dtype=bf16)``
    and its jax.vjp on the same f32 input, weights and bf16 cotangent: the
    output, dx and dW within one bf16 ulp (``_held``); its backward's
    products take f32 sums (``Bf16Product``), so dx, dW and the bias's
    gradient are within one ulp of the f64 products and sums of the bf16
    values rounded once; the bias's gradient against flax's as the comment
    below says."""
    from flax import linen as fnn

    rng = np.random.default_rng(co)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((shape[-1], co)) / 8).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    g = jnp.asarray(rng.standard_normal(shape[:-1] + (co,)).astype(
        np.float32)).astype(jnp.bfloat16)
    with jax.default_matmul_precision(F32):
        out, vjp = jax.vjp(lambda p, a: fnn.Dense(co, dtype=jnp.bfloat16)
                           .apply({"params": p}, a),
                           {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                           jnp.asarray(x))
        dp, dx = vjp(g)
    xt, wt, bt = (torch.from_numpy(t).requires_grad_() for t in (x, w, b))
    y = nn_layers.dense(xt, wt, bt, BF16)
    y.backward(_bf16(g))
    _held(y.detach(), out)
    for got, want in ((xt.grad, dx), (wt.grad, dp["kernel"])):
        assert got.dtype == torch.float32
        _held(got.to(BF16), want.astype(jnp.bfloat16))
    # the f64 products and sums of the bf16 values, rounded once
    gb = _bf16(g).double()
    xb, wb = (t.detach().to(BF16).double() for t in (xt, wt))
    refs = [(gb @ wb.t()).to(BF16),
            (xb.reshape(-1, shape[-1]).t() @ gb.reshape(-1, co)).to(BF16),
            gb.reshape(-1, co).sum(0).to(BF16)]
    for got, ref in zip((xt.grad, wt.grad, bt.grad), refs):
        _held(got.to(BF16)[None], ref[None])
    # the bias's: flax's CPU reduction of the bf16 cotangent rounds as it
    # goes (up to three bf16 ulps from the f64 sum, measured); the port's
    # is no farther from flax's than flax's from the f64 sum, plus an ulp
    jb = torch.from_numpy(np.array(dp["bias"], np.float32))
    ulp = torch.exp2(torch.floor(torch.log2(jb.abs().clamp(min=1e-30))) - 7)
    assert ((bt.grad - jb).abs()
            <= (jb - refs[2].float()).abs() + ulp).all()


# --------------------------------------------------------------- the Net
NET = dict(emb_dim=256, k=16, n_heads=2, n_blocks=1, ff_dims=256)


def _fused_on_the_cpu(monkeypatch):
    """The JAX transformer's attention on the fused Pallas kernels (module
    docstring)."""
    import dgcnn_tpu.models.torch_transformer as jtt

    monkeypatch.setattr(jtt, "_pallas_ok", lambda qs, ks: (
        qs[2] % 128 == 0 and ks[2] % 128 == 0 and qs[3] % 128 == 0))


def _jax_steps(fmodel, variables, inputs, labels):
    """Loss, logits, gradients and running statistics of the JAX Net's AMP
    training step (its fused Pallas path) and of its exact step
    (``DGCNN_TPU_PALLAS_EXACT=1`` on the XLA path that it takes on the
    CPU), as one jit (eager dispatch of the whole Net takes minutes, and
    each step's trace is most of the cost): the package reads both
    variables when it traces, so the traced function sets them around the
    exact step."""
    from dgcnn_tpu.train.loss import cross_entropy as jax_ce

    def loss_fn(params, x, oh, seg):
        logits, upd = fmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            oh, train=True, rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"])
        return jax_ce(logits, seg), (upd["batch_stats"], logits)

    step = jax.value_and_grad(loss_fn, has_aux=True)

    def both(*args):
        amp = step(*args)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(EXACT_ENV, "1")
            mp.setenv("DGCNN_TPU_PALLAS", "0")
            return amp, step(*args)

    with jax.default_matmul_precision(F32):
        runs = jax.jit(both)(variables["params"], *map(jnp.asarray, inputs),
                             jnp.asarray(labels))
    return [(float(loss), np.asarray(logits),
             state_dict_from_flax({"params": grads, "batch_stats": stats}))
            for (loss, (stats, logits)), grads in runs]


def _port_step(model, variables, inputs, labels, amp):
    m = copy.deepcopy(model)
    m.load_state_dict(state_dict_from_flax(variables), strict=True)
    logits = m(*map(torch.from_numpy, inputs), train=True, amp=amp)
    loss = cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    return (loss.item(), logits.detach().numpy(),
            {n: p.grad for n, p in m.named_parameters()}, m.state_dict())


def _flat(d, names):
    return torch.cat([torch.as_tensor(np.asarray(d[n])).reshape(-1).double()
                      for n in names])


def _cos(a, b) -> float:
    return (a @ b / (a.norm() * b.norm())).item()


def test_net_amp_train_step_matches_jax(amp_env):
    """One AMP training step of a small Net (emb 256, 2 heads of d = 128,
    1 + 1 blocks, ff 256, k 16, N 256, B 4, dropout 0: kernels 3, 4 and 5
    in AMP, kernel 10 in v2, the bf16 grads_emb, transformer, attention
    (kernels 14 and 15 in bf16) and head) against the JAX Net's default
    step (module docstring), held to the port's own move under a ~2^-22
    nudge of the input:

    - the loss within rel 1e-4 or three times the nudged move;
    - the logits within twice the nudged move;
    - the gradients (those of norm over 1e-3 of the model's largest) at
      cosine >= 0.99 to JAX's, together within twice the nudged move and
      each within three times its own, and nearer to JAX's AMP step than
      the port's exact step is;
    - each running statistic within rel 1e-4 of its norm or three times
      its nudged move;
    - the port's AMP-vs-exact gradient cosine no more than 0.005 below the
      JAX package's own (its exact step: ``DGCNN_TPU_PALLAS_EXACT=1``, on
      its CPU path, in the AMP step's jit)."""
    from dgcnn_tpu.convert.torch_import import convert_net
    from dgcnn_tpu.models import Net as FlaxNet

    _fused_on_the_cpu(amp_env)
    model = Net(**NET, dropout=0.0, device="cpu",
                generator=torch.Generator().manual_seed(5))
    variables = jax.tree_util.tree_map(jnp.asarray, convert_net(
        {k: v.numpy() for k, v in model.state_dict().items()}, 1))
    fmodel = FlaxNet(**NET, dropout=0.0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 256, 3)).astype(np.float32)
    oh = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 4)]
    seg = rng.integers(0, 50, (4, 256)).astype(np.int64)
    with pytest.MonkeyPatch.context() as mp:
        _contract_xw(mp)
        (want_loss, want_logits, want), (_, _, want_exact) = _jax_steps(
            fmodel, variables, (x, oh), seg)

    loss, logits, grads, stats = _port_step(model, variables, (x, oh), seg,
                                            True)
    _, _, exact, _ = _port_step(model, variables, (x, oh), seg, False)
    noise = np.random.default_rng(0).standard_normal(x.shape)
    moved = (x * (1 + 2.0 ** -22 * noise)).astype(np.float32)
    n_loss, n_logits, nudged, n_stats = _port_step(model, variables,
                                                   (moved, oh), seg, True)
    assert abs(loss - want_loss) <= max(1e-4 * abs(want_loss),
                                        3 * abs(n_loss - loss))
    assert np.abs(logits - want_logits).max() <= 2 * np.abs(
        n_logits - logits).max()
    floor = 1e-3 * max(torch.linalg.norm(g).item() for g in grads.values())
    kept = [n for n in grads if np.linalg.norm(np.asarray(want[n])) >= floor]
    assert len(kept) >= 0.9 * len(grads)
    for name in kept:
        g, w = grads[name], torch.as_tensor(np.asarray(want[name]))
        assert (torch.linalg.norm(g - w)
                <= 3 * torch.linalg.norm(nudged[name] - g)), name
    g, w, e, q, we = (_flat(d, kept)
                      for d in (grads, want, exact, nudged, want_exact))
    dist = torch.linalg.norm(g - w)
    assert _cos(g, w) >= 0.99
    assert dist <= 2 * torch.linalg.norm(q - g)
    assert dist < torch.linalg.norm(e - w)
    assert _cos(g, e) >= _cos(w, we) - 0.005, (_cos(g, e), _cos(w, we))
    for name, got in stats.items():
        if name.endswith(("running_mean", "running_var")):
            w_ = np.asarray(want[name])
            err = np.linalg.norm(got.numpy() - w_)
            assert err <= max(1e-4 * np.linalg.norm(w_), 3 * np.linalg.norm(
                n_stats[name].numpy() - got.numpy())), name


def test_net_amp_training_resolves_through_use_amp_train(monkeypatch):
    """``Net(..., train=True)`` takes its mode from ``use_amp_train``: a k
    above the tiled selection's lists (k = 65, the row-warp route on the
    card) trains AMP with amp=True as the JAX package does at any k (every
    stage and the attention in AMP, not amp=False's bits), and so does
    amp=True at k <= 64; without a generator a dropout rate > 0 refuses,
    with one the AMP step is a function of its state."""
    from dgcnn_tpu_torch.models import torch_transformer

    monkeypatch.delenv(EXACT_ENV, raising=False)
    modes, dtypes = [], []

    def spy(fn):
        def run(*args):
            modes.append(args[-1])
            return fn(*args)
        return run

    def spy_attention(q, *rest):
        dtypes.append(q.dtype)
        return fused_attention(q, *rest)

    for name in ("knn_edge_reduce", "knn_edge_reduce_xw"):
        monkeypatch.setattr(nn_layers, name, spy(getattr(nn_layers, name)))
    monkeypatch.setattr(torch_transformer, "fused_attention", spy_attention)
    pts = torch.randn(2, 128, 3, generator=torch.Generator().manual_seed(8))
    oh = torch.eye(16)[[2, 7]]
    wide = Net(emb_dim=128, k=65, n_heads=1, n_blocks=1, ff_dims=32,
               nclasses=5, dropout=0.0, device="cpu",
               generator=torch.Generator().manual_seed(9))
    a = wide(pts, oh, train=True, amp=True)
    assert modes == [True] * 4 and set(dtypes) == {BF16}
    assert not torch.equal(a, wide(pts, oh, train=True, amp=False))
    modes.clear()
    dtypes.clear()
    net = Net(emb_dim=256, k=8, n_heads=2, n_blocks=1, ff_dims=32,
              nclasses=5, dropout=0.5, device="cpu",
              generator=torch.Generator().manual_seed(10))
    with pytest.raises(ValueError, match="torch.Generator"):
        net(pts, oh, train=True, amp=True)
    modes.clear()
    dtypes.clear()
    runs = []
    for seed in (1, 1, 2):
        m = copy.deepcopy(net)
        out = m(pts, oh, train=True, amp=True,
                generator=torch.Generator().manual_seed(seed))
        out.sum().backward()
        runs.append((out.detach(), [p.grad for p in m.parameters()]))
    assert set(modes) == {True} and set(dtypes) == {BF16}
    assert len(dtypes) == 3 * 4 and len(modes) == 3 * 4
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(u, w) for u, w in zip(runs[0][1], runs[1][1]))
    assert not torch.equal(runs[0][0], runs[2][0])
    assert all(torch.isfinite(g).all() for g in runs[0][1] if g is not None)
