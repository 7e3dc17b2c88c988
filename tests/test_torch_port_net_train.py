"""Parity of the PyTorch port's fusion Net training slice with the JAX
package's, on the CPU at small sizes: the dropout mask of the attention
kernels (its plain version), the attention forward and its gradients
against the Pallas kernels in interpret mode and the JAX dense math given
the same mask, two training steps of the ``Net`` against flax's, the
``hog_bug_compat`` switch, the shape gate that routes what the kernels do
not take to the JAX package's XLA path, and the partseg CLI's training of
``--model transformer``.

Both sides take the same numpy inputs.  Models start from the port's
seeded weights, carried into a flax tree by the JAX package's
``convert_net``.  The JAX side runs its fused exact path
(``DGCNN_TPU_PALLAS=1``, ``DGCNN_TPU_PALLAS_EXACT=1``: the Pallas kernels
in interpret mode, f32 throughout) under
``jax.default_matmul_precision("float32")``; its attention on the CPU is
the dense path.  The port's kernels run their plain versions because the
tensors lie on the CPU.  The TPU kernels' own random stream cannot run on
the CPU, so dropout is held through the port's materialized mask.  Tests
marked ``cuda`` hold the kernels against their plain versions and skip
without a card.
"""
import copy
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNCls, Net, TorchMultiheadAttention
from dgcnn_tpu_torch.ops import (
    attention_bwd,
    attention_bwd_plain,
    attention_fwd,
    attention_plain,
    dropout_mask,
    dropout_mask_plain,
    fused_attention,
    use_kernel,
)
from dgcnn_tpu_torch.ops.attention import keep_threshold
from dgcnn_tpu_torch.train import (
    make_momentum_schedule,
    make_optimizer,
    make_schedule,
    make_seg_steps,
)

from test_torch_port_model import randomize_flax
from test_torch_port_net import (  # noqa: F401
    CONFIGS,
    NET_SMALL,
    _flax_net,
    _port_net,
    _rel,
    pallas_exact,
)
from test_torch_port_partseg import (  # noqa: F401
    TEST_LINE,
    TRAIN_LINE,
    _log_lines,
    shapenet_dir,
)
from test_torch_port_train import _assert_state_close

F32 = "float32"


def _seed(s: int) -> torch.Tensor:
    return torch.tensor([s], dtype=torch.int64)


# ------------------------------------------------------- (a) the mask


def _draw_reference(seed: int, b: int, h: int, i: int, j: int) -> int:
    """The 32-bit draw of probability (b, h, i, j), spelled out in Python
    integers as csrc/attention.cuh documents it."""
    m64 = (1 << 64) - 1
    gamma = 0x9E3779B97F4A7C15

    def mix(z):
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
        return z ^ (z >> 31)

    z = seed & m64
    for v in (b, h, i):
        z = mix((z + (v + 1) * gamma) & m64)
    return mix((z + (j + 1) * gamma) & m64) >> 32


def test_dropout_mask_plain_is_a_pure_function_of_seed_and_position():
    """The plain mask is the documented stream bit for bit (int64 products
    wrap as the kernels' unsigned ones do), for seeds of either sign; the
    same seed gives the same mask and another seed another; a sub-block is
    the slice of the whole; the CPU wrapper of kernel 16 is the plain
    version."""
    rng = np.random.default_rng(0)
    shape = (2, 3, 64, 80)
    for s in (0, 12345, -7, 2 ** 62 + 3, -2 ** 63):
        mask = dropout_mask_plain(shape, _seed(s), 0.3)
        assert mask.dtype == torch.float32 and mask.shape == shape
        for _ in range(40):
            b, h, i, j = (int(rng.integers(n)) for n in shape)
            want = _draw_reference(s, b, h, i, j) >= keep_threshold(0.3)
            assert bool(mask[b, h, i, j]) == want, (s, b, h, i, j)
    whole = dropout_mask_plain(shape, _seed(5), 0.5)
    assert torch.equal(whole, dropout_mask_plain(shape, _seed(5), 0.5))
    assert not torch.equal(whole, dropout_mask_plain(shape, _seed(6), 0.5))
    assert torch.equal(dropout_mask_plain((1, 2, 30, 50), _seed(5), 0.5),
                       whole[:1, :2, :30, :50])
    assert torch.equal(dropout_mask(shape, _seed(5), 0.5, "cpu"), whole)
    assert dropout_mask_plain(shape, _seed(5), 0.0).all()
    with pytest.raises(ValueError, match="not in"):
        dropout_mask_plain(shape, _seed(5), 1.0)


@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_dropout_mask_plain_keep_share_and_independence(rate):
    """Over (2, 2, 512, 512) the keep share is within 4 sigma of 1 - rate,
    and two different (b, h) agree on r^2 + (1 - r)^2 of the entries
    within 4 sigma: the (b, h) streams are independent."""
    mask = dropout_mask_plain((2, 2, 512, 512), _seed(11), rate)
    share = mask.mean().item()
    assert abs(share - (1 - rate)) <= 4 * math.sqrt(
        rate * (1 - rate) / mask.numel())
    pa = rate ** 2 + (1 - rate) ** 2
    for b, h in ((0, 1), (1, 0), (1, 1)):
        agree = (mask[0, 0] == mask[b, h]).float().mean().item()
        assert abs(agree - pa) <= 4 * math.sqrt(pa * (1 - pa) / 512 ** 2)


# ------------------------------------------- (b) attention against JAX


def _qkv(seed, b=2, h=2, nq=128, nk=256, d=128):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (nq, nk, nk)]


def _port_vjp(q, k, v, do, scale, rate=0.0, seed=None):
    """Output and (dq, dk, dv) of the port's fused_attention (its plain
    version on the CPU) by autograd."""
    qkv = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fused_attention(*qkv, scale, rate, seed)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def test_attention_and_gradients_match_pallas_at_rate_0():
    """At rate 0, the forward and the autograd gradients of the port's
    attention against jax.vjp of the Pallas fused_attention in interpret
    mode, which runs the bodies of the TPU kernels 14 and 15: rel 1e-5 of
    each one's scale; kernel 15's CPU wrapper is the same autograd."""
    from dgcnn_tpu.ops.pallas_attention import fused_attention as jfused

    q, k, v = _qkv(1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    scale = 128 ** -0.5
    with jax.default_matmul_precision(F32):
        out, vjp = jax.vjp(lambda a, b_, c: jfused(
            a, b_, c, sm_scale=scale, interpret=True),
            *(jnp.asarray(t) for t in (q, k, v)))
        want = [out] + list(vjp(jnp.asarray(do)))
    got = _port_vjp(q, k, v, do, scale)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    wrapped = attention_bwd(tq, tk, tv, None, None, None, tdo, scale)
    for g, w in zip(wrapped, got[1:]):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_attention_and_gradients_with_dropout_match_jax_dense(rate):
    """At rates 0.5 and 0.1, the port's attention and its gradients
    against the JAX dense math (einsum, softmax, where(mask, p / (1 - r),
    0), einsum) given the port's materialized mask, as
    tests/test_pallas_attention.py pins the TPU kernels: rel 1e-5; the
    mask drops about ``rate`` of the probabilities."""
    q, k, v = _qkv(3, nq=128, nk=192, d=64)
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    scale = 64 ** -0.5
    seed = _seed(77)
    mask = dropout_mask_plain((2, 2, 128, 192), seed, rate).numpy() > 0

    def dense(a, b_, c):
        s = jnp.einsum("bhqd,bhkd->bhqk", a, b_) * scale
        p = jax.nn.softmax(s, axis=-1)
        p = jnp.where(jnp.asarray(mask), p / (1.0 - rate), 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", p, c)

    with jax.default_matmul_precision(F32):
        out, vjp = jax.vjp(dense, *(jnp.asarray(t) for t in (q, k, v)))
        want = [out] + list(vjp(jnp.asarray(do)))
    got = _port_vjp(q, k, v, do, scale, rate, seed)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    assert abs(mask.mean() - (1 - rate)) < 0.02
    with pytest.raises(ValueError, match="needs a seed"):
        fused_attention(*map(torch.from_numpy, (q, k, v)), scale, rate)


@pytest.mark.parametrize("chunk_bytes", [None, 64 * 1024])
def test_attention_fwd_on_the_cpu_returns_the_log_sum_exp(monkeypatch,
                                                          chunk_bytes):
    """Kernel 14's wrapper on CPU tensors: its training form gives the
    plain output and each row's log-sum-exp of the scaled scores, whether
    the plain version takes the queries in one chunk or in many; its
    evaluation form gives no log-sum-exp."""
    from dgcnn_tpu_torch.ops import attention as attention_mod

    q, k, v = map(torch.from_numpy, _qkv(5, nq=128, nk=192, d=64))
    scale, seed = 64 ** -0.5, _seed(5)
    want = attention_plain(q, k, v, scale, 0.5, seed)
    lse_want = torch.logsumexp(q @ k.transpose(2, 3) * scale, dim=-1)
    if chunk_bytes is not None:
        monkeypatch.setattr(attention_mod, "_CHUNK_BYTES", chunk_bytes)
    o, lse = attention_fwd(q, k, v, scale, 0.5, seed)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse_want.numpy(), rtol=1e-6)
    o0, none = attention_fwd(q, k, v, scale)
    assert none is None
    np.testing.assert_array_equal(o0.numpy(),
                                  attention_plain(q, k, v, scale).numpy())


# ------------------------------------------- (c) two Net training steps


def _record_selection_gaps(monkeypatch, k: int):
    """Wraps every neighbour selection of a Net training forward (the four
    DGCNN stages, the PositionEmbedding's kNN and HOG's) to record, per
    call, the smallest gap between any point's k-th and (k+1)-th neighbour
    score over the scale of the scores."""
    from dgcnn_tpu_torch.models import nn_layers
    from dgcnn_tpu_torch.ops import graph as graph_mod
    from dgcnn_tpu_torch.ops import hog as hog_mod

    gaps = []

    def gap(g):
        g = g.detach()
        sq = (g * g).sum(-1)
        top = (2 * torch.bmm(g, g.transpose(1, 2)) - sq[:, :, None]
               - sq[:, None, :]).topk(k + 1, dim=-1).values
        scale = sq + sq.amax(-1, keepdim=True)
        gaps.append(((top[..., k - 1] - top[..., k]) / scale).min().item())

    def wrap(fn):
        def run(graph, *rest):
            gap(graph)
            return fn(graph, *rest)
        return run

    for mod, name in [(nn_layers, "knn_edge_reduce"),
                      (nn_layers, "knn_edge_reduce_xw"),
                      (graph_mod, "knn"), (hog_mod, "knn_sum")]:
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    return gaps


def _net_batch(seed, b=8, n=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)).astype(np.float32),
            np.eye(16, dtype=np.float32)[rng.integers(0, 16, b)],
            rng.integers(0, 50, (b, n)).astype(np.int64))


# (optimizer, config, seed of the first batch): batches whose selections
# keep their gaps under that optimizer's two steps
@pytest.mark.parametrize("use_sgd,config,batch_seed", [
    (True, "bench", 30), (False, "bench", 62), (True, "cli_default", 24),
    (False, "cli_default", 30)])
def test_net_two_train_steps_match_jax(pallas_exact, monkeypatch, use_sgd,
                                       config, batch_seed):
    """Two steps of the JAX package's partseg optimizer (SGD, or AdamW
    with its decoupled decay; the lr and momentum/beta1 cycled by
    --scheduler cycle, as cli/partseg.py builds it) and make_seg_steps on
    the flax Net at dropout 0 (``train=True``, its fused exact path)
    against two port steps from the same weights (the port's seeded ones
    through convert_net) and batches: losses, parameters and running
    statistics within rel 1e-4.  Batches of 8 clouds keep the
    PositionEmbedding's and the head's batch BatchNorms well conditioned,
    and every selection of both steps (the DGCNN's four stages, the
    PositionEmbedding's kNN, HOG's) keeps its k-th and (k+1)-th neighbours
    apart by over 1e-6 of the score scale.  Under AdamW a value's update
    error is its gradient's relative error times the learning rate, so,
    as in the canonical partseg test, each tensor's update over the values
    whose gradients at both steps reach 1e-4 of the model's largest is
    held within 1e-2 of its norm, the other values to three learning rates
    a step."""
    from dgcnn_tpu.train import (
        TrainState,
        make_optimizer as jopt,
        make_schedule as jsched,
        make_seg_steps as jsteps,
    )
    from dgcnn_tpu.train.schedules import (
        make_momentum_schedule as jmomentum,
    )

    model = Net(**NET_SMALL, **CONFIGS[config], dropout=0.0, device="cpu",
                generator=torch.Generator().manual_seed(21))
    fmodel, variables = _flax_net(model, **CONFIGS[config])
    batches = [_net_batch(batch_seed), _net_batch(batch_seed + 1)]
    kw = dict(epochs=4, steps_per_epoch=1)
    state = TrainState.create(
        apply_fn=fmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jopt(use_sgd=use_sgd, schedule=jsched("cycle", 0.001,
                                                 use_sgd=use_sgd, **kw),
                momentum=0.9, adamw=True,
                momentum_schedule=jmomentum("cycle", **kw)))
    jtrain, _ = jsteps(fmodel)
    want_losses, states = [], []
    with jax.default_matmul_precision(F32):
        for points, one_hot, seg in batches:
            state, m = jtrain(state, jnp.asarray(points),
                              jnp.asarray(one_hot), jnp.asarray(seg),
                              jax.random.PRNGKey(1))
            want_losses.append(float(m["loss"]))
            states.append(state_dict_from_flax(jax.tree_util.tree_map(
                np.asarray, {"params": state.params,
                             "batch_stats": state.batch_stats})))

    gaps = _record_selection_gaps(monkeypatch, NET_SMALL["k"])
    opt = make_optimizer(
        model.parameters(), use_sgd=use_sgd,
        schedule=make_schedule("cycle", 0.001, use_sgd=use_sgd, **kw),
        adamw=True, momentum_schedule=make_momentum_schedule("cycle", **kw))
    train_step, _ = make_seg_steps(with_label=True)
    lr = make_schedule("cycle", 0.001, use_sgd=use_sgd, **kw)
    params = dict(model.named_parameters())
    init = {name: p.detach().clone() for name, p in params.items()}
    tiny = {name: torch.zeros_like(p, dtype=torch.bool)
            for name, p in params.items()}
    losses = []
    for step, (batch, want) in enumerate(zip(batches, states)):
        losses.append(train_step(model, opt, *map(torch.from_numpy, batch))[
            "loss"].item())
        top = max(p.grad.abs().max() for p in params.values())
        for name, p in params.items():
            tiny[name] |= p.grad.abs() < 1e-4 * top
        got = model.state_dict()
        _assert_state_close(got, {k: v for k, v in want.items()
                                  if k not in params})
        bound = 3 * sum(lr(t) for t in range(step + 1))
        for name in params:
            g, w, t = got[name], want[name], tiny[name]
            if use_sgd:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=name)
                continue
            upd = (w - init[name])[~t]
            assert (g - w)[~t].norm() <= 1e-2 * upd.norm(), name
            assert ((g[t] - w[t]).abs() <= bound).all(), name
    assert len(gaps) == 12 and min(gaps) > 1e-6, gaps
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)


# ------------------------------------------------ (d) hog_bug_compat


def test_net_hog_bug_compat_matches_jax(pallas_exact):
    """The Net with ``hog_bug_compat=True`` (the reference's gather of
    same-axis triples, as a reference-trained transformer.pt needs)
    against the flax Net with the same switch: eval logits within rel
    1e-4; without it the logits differ."""
    from dgcnn_tpu.models import Net as FlaxNet

    model = _port_net(24, **CONFIGS["bench"])
    _, variables = _flax_net(model, **CONFIGS["bench"])
    fmodel = FlaxNet(**NET_SMALL, **CONFIGS["bench"], dropout=0.0,
                     hog_bug_compat=True)
    x = np.random.default_rng(25).standard_normal((3, 128, 3)).astype(
        np.float32)
    oh = np.eye(16, dtype=np.float32)[[1, 5, 12]]
    with jax.default_matmul_precision(F32):
        want = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                       jnp.asarray(oh), False))
    bug = Net(**NET_SMALL, **CONFIGS["bench"], hog_bug_compat=True,
              device="cpu")
    bug.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = bug(torch.from_numpy(x), torch.from_numpy(oh)).numpy()
        plain = model(torch.from_numpy(x), torch.from_numpy(oh)).numpy()
    assert _rel(got, want) <= 1e-4
    assert _rel(plain, want) > 1e-3


# -------------------------------------------------- (e) the shape gate


@pytest.mark.parametrize("n", [1000, 1024, 2048, 2000, 4096])
def test_use_kernel_matches_use_pallas(monkeypatch, n):
    """use_kernel is the JAX package's use_pallas (under
    DGCNN_TPU_PALLAS=1) at the cloud sizes of the CLIs and around them."""
    from dgcnn_tpu.ops.knn import use_pallas

    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    assert use_kernel(n) == use_pallas(n)


def test_attention_at_head_dim_64_matches_flax():
    """A TorchMultiheadAttention of 2 heads of 64 (a head dim the kernels
    do not take; the JAX package's dense path) against flax: rel 1e-5, in
    eval and, at dropout 0, in training."""
    from dgcnn_tpu.models.torch_transformer import (
        TorchMultiheadAttention as FlaxMHA,
    )

    rng = np.random.default_rng(26)
    q_in = rng.standard_normal((3, 128, 128)).astype(np.float32)
    kv_in = rng.standard_normal((3, 200, 128)).astype(np.float32)
    mha = TorchMultiheadAttention(128, 2)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(
                np.float32) / np.sqrt(128)))
    params = {"in_proj_weight": mha.in_proj_weight.detach().numpy(),
              "in_proj_bias": mha.in_proj_bias.detach().numpy(),
              "out_proj": {"kernel": mha.out_proj.weight.detach().numpy().T,
                           "bias": mha.out_proj.bias.detach().numpy()}}
    with jax.default_matmul_precision(F32):
        want = np.asarray(FlaxMHA(128, 2).apply(
            {"params": params}, jnp.asarray(q_in), jnp.asarray(kv_in),
            jnp.asarray(kv_in)))
    inputs = [torch.from_numpy(t) for t in (q_in, kv_in, kv_in)]
    with torch.no_grad():
        assert _rel(mha(*inputs), want) <= 1e-5
        assert _rel(mha(*inputs, train=True), want) <= 1e-5


def test_dgcnn_cls_at_1000_points_matches_flax(pallas_exact):
    """DGCNNCls at N = 1000 (not a multiple of 128: the kernels' gate
    sends it to the JAX package's XLA path) against flax, eval logits and
    one training forward's logits and running statistics, rel 1e-4."""
    from dgcnn_tpu.models import DGCNNCls as FlaxDGCNNCls

    fmodel = FlaxDGCNNCls(emb_dims=32, k=8, dropout=0.0)
    variables = randomize_flax(fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 1000, 3), jnp.float32)), 27)
    model = DGCNNCls(emb_dims=32, k=8, dropout=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    x = np.random.default_rng(28).standard_normal((4, 1000, 3)).astype(
        np.float32)
    with jax.default_matmul_precision(F32):
        want = np.asarray(fmodel.apply(variables, jnp.asarray(x)))
        want_t, upd = fmodel.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_t = model(torch.from_numpy(x), train=True).numpy()
    assert _rel(got, want) <= 1e-4
    assert _rel(got_t, np.asarray(want_t)) <= 1e-4
    _assert_state_close(model.state_dict(), {
        k: v for k, v in state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, {"params": variables["params"],
                         "batch_stats": upd["batch_stats"]})).items()
        if "running" in k})


# ------------------------------------------------------------ the CLI

NET_TRAIN = ["--model=transformer", "--num_points=128", "--k=10",
             "--emb_dim=32", "--ff_dims=16", "--n_heads=2", "--n_blocks=2",
             "--test_batch_size=8"]


def test_partseg_cli_trains_resumes_and_reloads_the_net(shapenet_dir):
    """--model transformer trains (SGD under the cycle scheduler, dropout
    0.5, gradient accumulation over 2 batches), writes the JAX CLI's line
    formats, the resume checkpoint and transformer_0.checkpoint;
    --eval=True reloads the best model to the same test line; --resume
    restarts from the checkpoint."""
    from dgcnn_tpu_torch.cli import partseg

    argv = ["--exp_name=net", "--epochs=1", "--batch_size=4",
            "--dropout=0.5", "--grad_accum=2", "--no_cuda=True"] + NET_TRAIN
    partseg.main(argv)
    lines = _log_lines("net")
    train = [ln for ln in lines if ln.startswith("Train 0")]
    test = [ln for ln in lines if ln.startswith("Test 0")]
    assert len(train) == 1 and TRAIN_LINE.fullmatch(train[0]), lines
    assert len(test) == 1 and TEST_LINE.fullmatch(test[0]), lines
    assert os.path.exists("outputs/net/models/transformer_0.checkpoint")
    assert os.path.exists("outputs/net/checkpoints/ckpt.checkpoint")
    partseg.main(["--exp_name=net", "--eval=True", "--no_cuda=True",
                  "--model_path=models/transformer_0.checkpoint"]
                 + NET_TRAIN)
    acc, avg, iou = TEST_LINE.fullmatch(test[0]).groups()
    assert _log_lines("net")[-1] == (
        f"Test: test acc: {acc}, test avg acc: {avg}, test iou: {iou}")
    partseg.main(argv + ["--resume=True"])
    lines = _log_lines("net")
    assert any(ln.startswith("Resumed from outputs/net/checkpoints/"
                             "ckpt.checkpoint at epoch 0") for ln in lines)
    assert TRAIN_LINE.fullmatch([ln for ln in lines
                                 if ln.startswith("Train 0")][-1])


def test_net_training_draws_its_dropout_from_the_generator():
    """A training forward of the Net at dropout 0.5 is a function of the
    generator's state: the same seed gives the same logits and gradients,
    another seed other logits; without a generator it refuses; at dropout
    0 it equals the eval forward's math with the batch's statistics."""
    model = _port_net(29, **CONFIGS["bench"])
    x = torch.from_numpy(np.random.default_rng(30).standard_normal(
        (3, 128, 3)).astype(np.float32))
    oh = torch.eye(16)[[0, 3, 9]]

    def run(seed):
        m = copy.deepcopy(model)
        out = m(x, oh, train=True,
                generator=torch.Generator().manual_seed(seed))
        out.sum().backward()
        return out.detach(), [p.grad for p in m.parameters()]

    a, ga = run(1)
    b, gb = run(1)
    c, _ = run(2)
    assert torch.equal(a, b) and all(torch.equal(u, w)
                                     for u, w in zip(ga, gb))
    assert not torch.equal(a, c)
    assert all(torch.isfinite(g).all() for g in ga)
    with pytest.raises(ValueError, match="torch.Generator"):
        copy.deepcopy(model)(x, oh, train=True)


# ------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b, n, d", [(2, 1024, 128), (2, 1024, 256),
                                     (2, 1024, 512), (64, 2048, 256)])
def test_attention_kernels_match_plain(cuda_device, b, n, d):
    """Kernel 16 bit-equal to its plain version; kernel 14's training form
    at rate 0.5 within rel 1e-5 of each row's norm and its log-sum-exp
    within rel 1e-5; kernel 15 within rel 1e-4 of the plain autograd at
    rates 0 and 0.5, on heads views, and bit-identical across two calls
    (phases 28 and 31 of chip_smoke.py), at the three head dims and at the
    Net training step's stacked call (64, 2, 2048, 256)."""
    g = torch.Generator().manual_seed(d + b)
    h = 512 // d

    def heads():
        return torch.randn((b, n, h * d), generator=g).to(
            cuda_device).reshape(b, n, h, d).transpose(1, 2)

    seed = torch.tensor([d], dtype=torch.int64, device=cuda_device)
    assert torch.equal(dropout_mask((2, h, 1024, 1024), seed, 0.5,
                                    cuda_device),
                       dropout_mask_plain((2, h, 1024, 1024), seed, 0.5))
    q, k, v, do = heads(), heads(), heads(), heads()
    for rate in (0.0, 0.5):
        sd = seed if rate else None
        o, lse = attention_fwd(q, k, v, d ** -0.5, rate, sd, with_lse=True)
        want = attention_plain(q, k, v, d ** -0.5, rate, sd)
        assert ((o - want).norm(dim=-1) / want.norm(dim=-1)).max() <= 1e-5
        lse_want = torch.logsumexp(q @ k.transpose(2, 3) * d ** -0.5, -1)
        assert ((lse - lse_want).abs() / lse_want.abs()).max() <= 1e-5
        got = attention_bwd(q, k, v, o, lse, sd, do, d ** -0.5, rate)
        again = attention_bwd(q, k, v, o, lse, sd, do, d ** -0.5, rate)
        for a, b, w in zip(got, again,
                           attention_bwd_plain(q, k, v, sd, do, d ** -0.5,
                                               rate)):
            assert torch.equal(a, b)
            assert ((a - w).norm(dim=-1) / w.norm(dim=-1)).max() <= 1e-4


@pytest.mark.cuda
def test_net_train_step_kernel_path_matches_plain_path(cuda_device):
    """One full-width Net step (SGD, dropout 0, B = 2) on the card against
    the CPU plain path: loss rel 1e-4, gradient cosine 0.999, launches 7 /
    7 of kernels 14 / 15 (phase 29 of chip_smoke.py)."""
    from dgcnn_tpu_torch.models import init_like_flax_

    cpu = init_like_flax_(Net(emb_dim=512, k=32, n_heads=2, n_blocks=2,
                              dropout=0.0, device="cpu"),
                          torch.Generator().manual_seed(1))
    dev = copy.deepcopy(cpu).to(cuda_device)
    batch = [torch.from_numpy(a) for a in _net_batch(31, b=2, n=2048)]
    sched = make_schedule("cos", 0.001, epochs=100, steps_per_epoch=1)
    train_step, _ = make_seg_steps(with_label=True)
    fused_attention.launches = attention_bwd.launches = 0
    got = train_step(dev, make_optimizer(dev.parameters(), use_sgd=True,
                                         schedule=sched),
                     *(t.to(cuda_device) for t in batch))["loss"].item()
    assert (fused_attention.launches, attention_bwd.launches) == (7, 7)
    want = train_step(cpu, make_optimizer(cpu.parameters(), use_sgd=True,
                                          schedule=sched), *batch)["loss"]
    assert got == pytest.approx(want.item(), rel=1e-4)
    gd = torch.cat([p.grad.reshape(-1).cpu() for p in dev.parameters()])
    gc = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    assert (gd @ gc / (gd.norm() * gc.norm())).item() >= 0.999
