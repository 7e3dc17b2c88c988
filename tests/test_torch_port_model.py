"""Parity of the PyTorch port's models, layers, checkpoints, loss and
metrics with the JAX package, on the CPU at small sizes.

A flax model is initialized, its variables are randomized from a numpy
seed (so BatchNorm statistics and scales of either sign are exercised),
carried over with ``state_dict_from_flax`` and compared key for key with
``dgcnn_tpu.convert.torch_export``; then both models run the same numpy
clouds.  JAX's CPU matmuls default to bf16 multiplies here, so the JAX side
runs under ``jax.default_matmul_precision("float32")``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import load_checkpoint, state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNCls, PointNet
from dgcnn_tpu_torch.models.nn_layers import ConvBN, DenseBNReLU, EdgeConv


def randomize_flax(variables, seed: int):
    """Flax variables with every leaf redrawn from a numpy seed: weights
    N(0, 1/fan_in), BN scales of either sign, variances in [0.5, 2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = np.shape(leaf)
        name = path[-1].key
        if name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape) * np.where(
                rng.random(shape) < 0.15, -1.0, 1.0)
        elif len(shape) == 2:
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            v = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, variables)


def flax_cls_variables(emb_dims=64, k=8, n=128, seed=0):
    from dgcnn_tpu.models import DGCNNCls as FlaxDGCNNCls

    model = FlaxDGCNNCls(emb_dims=emb_dims, k=k)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, n, 3), jnp.float32), train=False)
    return model, randomize_flax(variables, seed)


def _clouds(seed, b=2, n=128):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(
        np.float32)


def _assert_same_state_dict(got, want):
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(v),
                                      err_msg=key)


def test_dgcnn_cls_state_dict_and_logits_match_jax():
    from dgcnn_tpu.convert.torch_export import export_dgcnn_cls

    fmodel, variables = flax_cls_variables()
    sd = state_dict_from_flax(variables)
    _assert_same_state_dict(sd, export_dgcnn_cls(variables))
    model = DGCNNCls(emb_dims=64, k=8, device="cpu")
    model.load_state_dict(sd, strict=True)
    x = _clouds(1)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(fmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 40)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_pointnet_state_dict_and_logits_match_jax():
    from dgcnn_tpu.convert.torch_export import export_pointnet
    from dgcnn_tpu.models import PointNet as FlaxPointNet

    fmodel = FlaxPointNet(emb_dims=64)
    variables = randomize_flax(fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 128, 3)), train=False), 2)
    sd = state_dict_from_flax(variables)
    _assert_same_state_dict(sd, export_pointnet(variables))
    model = PointNet(emb_dims=64, device="cpu")
    model.load_state_dict(sd, strict=True)
    x = _clouds(3)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(fmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_layers_match_jax():
    """ConvBN, DenseBNReLU and EdgeConv (with precomputed idx) on their own,
    their parameters carried over by hand in the reference layout."""
    from dgcnn_tpu.models import nn_layers as fl

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 128, 16)).astype(np.float32)
    v = rng.standard_normal((4, 16)).astype(np.float32)
    idx = rng.integers(0, 128, (2, 128, 5)).astype(np.int32)
    cases = [
        (fl.ConvBN(24), ConvBN(16, 24), (x,), "conv"),
        (fl.DenseBNReLU(24), DenseBNReLU(16, 24), (v,), "linear"),
        (fl.EdgeConv(24), EdgeConv(16, 24), (x, idx), None),
    ]
    for flax_layer, layer, args, dense in cases:
        jargs = tuple(jnp.asarray(a) for a in args)
        var = randomize_flax(flax_layer.init(jax.random.PRNGKey(0), *jargs),
                             5)
        p, s = var["params"], var["batch_stats"]
        bn_p, bn_s = (p["bn"], s["bn"]) if dense else (p, s)
        if dense:
            w = np.asarray(p[dense]["kernel"]).T
        else:
            w = np.concatenate([np.asarray(p["w_nbr"]).T,
                                np.asarray(p["w_ctr"]).T], 1)
        with torch.no_grad():
            layer[0].weight.copy_(torch.tensor(w).reshape(
                layer[0].weight.shape))
            for name, src in [("weight", bn_p["scale"]), ("bias", bn_p["bias"]),
                              ("running_mean", bn_s["mean"]),
                              ("running_var", bn_s["var"])]:
                getattr(layer[1], name).copy_(torch.tensor(np.asarray(src)))
            got = layer(*(torch.from_numpy(a).long() if a.dtype == np.int32
                          else torch.from_numpy(a) for a in args)).numpy()
        with jax.default_matmul_precision("float32"):
            want = np.asarray(flax_layer.apply(var, *jargs))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=type(layer).__name__)


def test_load_checkpoint_strips_prefix_and_bn_aliases(tmp_path):
    """A DataParallel-prefixed state dict carrying upstream's duplicate
    ``bnI`` BatchNorm aliases loads strictly; the aliases are dropped."""
    src = DGCNNCls(emb_dims=32, k=4, device="cpu",
                   generator=torch.Generator().manual_seed(7))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    for i in range(1, 6):
        for suffix in ("weight", "bias", "running_mean", "running_var",
                       "num_batches_tracked"):
            sd[f"module.bn{i}.{suffix}"] = sd[f"module.conv{i}.1.{suffix}"]
    path = tmp_path / "model.t7"
    torch.save(sd, path)
    dst = load_checkpoint(str(path), DGCNNCls(emb_dims=32, k=4, device="cpu"))
    x = torch.from_numpy(_clouds(8, n=64))
    with torch.no_grad():
        assert torch.equal(dst(x), src(x))


def test_models_are_seeded_and_eval_only():
    """Models are seeded.  Training is ported now, so the train forward no
    longer raises; its dropout draws only from an explicit generator, and
    the same seeds give the same training forward."""
    a = DGCNNCls(emb_dims=32, k=4, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    b = DGCNNCls(emb_dims=32, k=4, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    x = torch.from_numpy(_clouds(9, n=64))
    with pytest.raises(ValueError, match="Generator"):
        a(x, train=True)
    ya = a(x, train=True, generator=torch.Generator().manual_seed(5))
    yb = b(x, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(ya, yb)


def test_cross_entropy_and_metrics_match_jax():
    from dgcnn_tpu.train import loss as jloss
    from dgcnn_tpu.train import metrics as jmetrics
    from dgcnn_tpu_torch.train import (
        accuracy_score,
        balanced_accuracy_score,
        cross_entropy,
    )

    rng = np.random.default_rng(10)
    logits = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, 16)
    for smoothing in (True, False):
        want = float(jloss.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), smoothing))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), smoothing).item()
        assert got == pytest.approx(want, rel=1e-6)
    preds = rng.integers(0, 40, 16)
    assert accuracy_score(labels, preds) == jmetrics.accuracy_score(labels,
                                                                   preds)
    assert balanced_accuracy_score(labels, preds) == (
        jmetrics.balanced_accuracy_score(labels, preds))


@pytest.mark.cuda
def test_dgcnn_cls_kernel_path_matches_plain_path():
    """Full-width DGCNNCls on the card: 4 + 1 kernel launches per forward
    and the same predictions as the plain path on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dgcnn_tpu_torch.ops import conv_pool, edge_conv_eval

    torch.backends.cuda.matmul.allow_tf32 = False
    model = DGCNNCls(emb_dims=1024, k=20, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_clouds(11, b=8, n=1024))
    edge_conv_eval.launches = conv_pool.launches = 0
    with torch.no_grad():
        got = model(x.cuda()).cpu()
        assert (edge_conv_eval.launches, conv_pool.launches) == (4, 1)
        want = model.to("cpu")(x)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.995
