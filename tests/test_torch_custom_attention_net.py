"""Parity of the port's custom-attention fusion ``Net``
(``use_custom_attention``: the vector-attention transformer) with the JAX
package's, on the CPU at a small size in the exact f32 mode: its eval
logits, one SGD step (the loss, every parameter and running statistic),
and the partseg CLI's ``--model transformer --use_custom_attention
--eval=True`` line on the same weights.

The flax Net's initial variables (batch statistics drawn from a seed)
reach the port through ``convert.state_dict_from_flax``, strictly.  Both
run on their XLA paths: clouds of 120 points, not a multiple of 128, keep
both packages off their kernels (the port's ``use_kernel``, the JAX
``use_pallas``), so the HOG, kNN and EdgeConv forms are the same on both
sides.  Tolerances: logits, the loss, parameters and statistics within
rel 1e-4 (parameters after the step: absolute 1e-5 near 0); the CLI's
``Test:`` line equal.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import Net
from dgcnn_tpu_torch.models.transformer import Transformer
from dgcnn_tpu_torch.train import make_optimizer, make_schedule
from dgcnn_tpu_torch.train import make_seg_steps

from test_torch_custom_attention import DQKV, EMB, F32, FF, K, N, _rel
from test_torch_custom_attention import _stats_from_seed
from test_torch_port_partseg import _log_lines, shapenet_dir  # noqa: F401

NET = dict(emb_dim=EMB, k=K, n_heads=1, n_blocks=1, ff_dims=FF, d_qkv=DQKV)


@pytest.fixture(autouse=True)
def xla_path(monkeypatch):
    """Both packages' exact mode, the JAX one on its XLA path."""
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    monkeypatch.delenv("DGCNN_TPU_PALLAS", raising=False)


def _flax_net():
    from dgcnn_tpu.models import Net as FlaxNet

    return FlaxNet(**NET, dropout=0.0, use_custom_attention=True)


_NET_INIT = {}


def _net_variables():
    """The flax custom-attention Net's initial variables (one jitted init
    for the file), their batch statistics drawn from a seed."""
    if not _NET_INIT:
        x = jnp.zeros((2, N, 3), jnp.float32)
        oh = jnp.zeros((2, 16), jnp.float32)
        init = jax.jit(lambda x, oh: _flax_net().init(
            jax.random.PRNGKey(3), x, oh, False))(x, oh)
        _NET_INIT["v"] = _stats_from_seed(init, 4)
    return _NET_INIT["v"]


def _port_net(variables) -> Net:
    model = Net(**NET, dropout=0.0, use_custom_attention=True, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    return model


def _net_batch(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, N, 3)).astype(np.float32),
            np.eye(16, dtype=np.float32)[rng.integers(0, 16, b)],
            rng.integers(0, 50, (b, N)).astype(np.int64))


def test_custom_attention_net_eval_matches_jax():
    """The custom-attention Net's eval logits within rel 1e-4 of the flax
    Net's on the same weights (state_dict_from_flax: every key of the
    ``transformer.model.*`` tree loads strictly), and its transformer is
    the custom one."""
    variables = _net_variables()
    model = _port_net(variables)
    assert isinstance(model.transformer, Transformer)
    assert any(k.startswith("transformer.model.encoder_layer_0.sub0.norm")
               for k in model.state_dict())
    x, oh, _ = _net_batch(30, 3)
    with jax.default_matmul_precision(F32):
        want = np.asarray(jax.jit(
            lambda v, x, oh: _flax_net().apply(v, x, oh, False))(
                variables, jnp.asarray(x), jnp.asarray(oh)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(oh)).numpy()
    assert got.shape == want.shape == (3, N, 50)
    assert _rel(got, want) <= 1e-4


def _selection_gaps(monkeypatch) -> list:
    """Wraps every kNN of a Net training forward on the XLA path (the
    backbone's four stages, HOG's, the PositionEmbedding's and each
    VectorAttention's) to record the smallest gap between any point's
    k-th and (k+1)-th neighbour score over the scale of the scores."""
    from dgcnn_tpu_torch.models import attention, dgcnn, nn_layers
    from dgcnn_tpu_torch.ops import graph as graph_mod
    from dgcnn_tpu_torch.ops import hog as hog_mod

    gaps = []

    def wrap(fn):
        def run(x, k, *rest, **kw):
            g = x.detach()
            sq = (g * g).sum(-1)
            top = (2 * torch.bmm(g, g.transpose(1, 2)) - sq[:, :, None]
                   - sq[:, None, :]).topk(k + 1, dim=-1).values
            scale = sq + sq.amax(-1, keepdim=True)
            gaps.append(((top[..., k - 1] - top[..., k]) / scale).min(
                ).item())
            return fn(x, k, *rest, **kw)
        return run

    for mod in (attention, dgcnn, nn_layers, graph_mod, hog_mod):
        monkeypatch.setattr(mod, "knn", wrap(mod.knn))
    return gaps


def test_custom_attention_net_sgd_step_matches_jax(monkeypatch):
    """One SGD step of the JAX package's partseg optimizer and
    make_seg_steps on the flax custom-attention Net at dropout 0 against
    one port step from the same weights and batch (8 clouds, whose every
    selection keeps its k-th and (k+1)-th neighbours apart by over 1e-6 of
    the score scale): the loss, the parameters and every running
    statistic within rel 1e-4 (parameters: atol 1e-5); the transformer's
    BatchNorms moved twice, the others once."""
    from dgcnn_tpu.train import (
        TrainState,
        make_optimizer as jopt,
        make_schedule as jsched,
        make_seg_steps as jsteps,
    )

    variables = _net_variables()
    model = _port_net(variables)
    points, one_hot, seg = _net_batch(40, 8)
    kw = dict(epochs=4, steps_per_epoch=1)
    state = TrainState.create(
        apply_fn=_flax_net().apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jopt(use_sgd=True, schedule=jsched("cycle", 0.001, use_sgd=True,
                                              **kw), momentum=0.9))
    jtrain, _ = jsteps(_flax_net())
    with jax.default_matmul_precision(F32):
        state, m = jtrain(state, jnp.asarray(points), jnp.asarray(one_hot),
                          jnp.asarray(seg), jax.random.PRNGKey(1))
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    gaps = _selection_gaps(monkeypatch)
    opt = make_optimizer(model.parameters(), use_sgd=True,
                         schedule=make_schedule("cycle", 0.001, use_sgd=True,
                                                **kw), momentum=0.9)
    train_step, _ = make_seg_steps(with_label=True)
    loss = train_step(model, opt, *map(torch.from_numpy,
                                       (points, one_hot, seg)))["loss"]
    assert len(gaps) == 4 + 1 + 1 + 6 and min(gaps) > 1e-6, gaps
    np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=1e-4)
    got = model.state_dict()
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            moved = 2 if key.startswith("transformer.") else 1
            assert int(got[key]) == moved, key
            continue
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


# ----------------------------------------------------------------- the CLI
def test_partseg_cli_evaluates_the_custom_attention_net_as_jax_cli(
        shapenet_dir, monkeypatch):
    """--model transformer --use_custom_attention --eval=True on the same
    weights, written as msgpack for the JAX CLI and as a ``.pt`` state
    dict for the port (under outputs/<exp>/, as the reference resolves
    --model_path): the port's ``Test:`` line equals the JAX CLI's, both
    on the XLA path (--num_points 120)."""
    from dgcnn_tpu.cli import partseg as jpartseg
    from dgcnn_tpu.train.checkpoint import save_model

    from dgcnn_tpu_torch.cli import partseg

    variables = jax.tree_util.tree_map(np.asarray, _net_variables())
    args = ["--model=transformer", "--use_custom_attention",
            f"--num_points={N}", f"--k={K}", f"--emb_dim={EMB}",
            f"--ff_dims={FF}", f"--d_qkv={DQKV}", "--n_heads=1",
            "--n_blocks=1", "--test_batch_size=8", "--eval=True"]
    os.makedirs("outputs/jax/models")
    os.makedirs("outputs/port/models")
    save_model("outputs/jax/models/net.msgpack", variables)
    torch.save(state_dict_from_flax(variables),
               "outputs/port/models/net.pt")
    with jax.default_matmul_precision(F32):
        jpartseg.main(["--exp_name=jax", "--model_path=models/net.msgpack"]
                      + args)
    partseg.main(["--exp_name=port", "--no_cuda=True",
                  "--model_path=models/net.pt"] + args)
    want = [ln for ln in _log_lines("jax") if ln.startswith("Test:")]
    got = [ln for ln in _log_lines("port") if ln.startswith("Test:")]
    assert len(want) == 1 and got == want
