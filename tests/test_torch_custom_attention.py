"""Parity of the port's vector-attention transformer (the fusion Net's
``use_custom_attention``) with the JAX package's, on the CPU at small
sizes, in the exact f32 mode: ``VectorAttention``,
``MultiHeadVectorAttention`` and ``MultiHeadedAttention`` (outputs and
gradients), the ``Transformer`` in eval and in training (its two
applications in turn, each BatchNorm's running statistics moved twice).
The custom-attention ``Net`` is held in
``test_torch_custom_attention_net.py``.

Weights start from the flax initialization (batch statistics drawn from a
seed so that eval normalizes) and reach the port through
``convert.module_state_dict_from_flax``.  Clouds of 120 points, not a
multiple of 128, keep both packages' kNN off their kernels (the port's
``use_kernel``, the JAX ``use_pallas``).  Tolerances: outputs, gradients
and running statistics within rel 1e-4 of the largest value (a
parameter's gradient: of the larger of its own largest value and 1e-2 of
the module's largest gradient).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import module_state_dict_from_flax
from dgcnn_tpu_torch.models.attention import (
    MultiHeadedAttention,
    MultiHeadVectorAttention,
    VectorAttention,
)
from dgcnn_tpu_torch.models.transformer import Transformer

F32 = "float32"
EMB, DQKV, K, FF, N = 32, 8, 10, 16, 120


@pytest.fixture(autouse=True)
def xla_path(monkeypatch):
    """Both packages' exact mode, the JAX one on its XLA path."""
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    monkeypatch.delenv("DGCNN_TPU_PALLAS", raising=False)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _stats_from_seed(variables, seed: int):
    """The flax variables with every BatchNorm's running statistics drawn
    from ``seed`` (means near 0, variances in [0.5, 2))."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        v = np.asarray(v)
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return (0.5 + 1.5 * rng.random(v.shape)).astype(np.float32)

    out = dict(variables)
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            draw, variables["batch_stats"])
    return jax.tree_util.tree_map(jnp.asarray, out)


def _inputs(seed, b=2, n=N, c=EMB, count=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, c)).astype(np.float32)
            for _ in range(count)] + [
        rng.standard_normal((b, n, 3)).astype(np.float32)]


def _flax_grads_as_port(grads: dict) -> dict:
    return {k: v.numpy() for k, v in module_state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, grads)}).items()}


def _assert_param_grads(mod, want: dict) -> None:
    """Each parameter's gradient within rel 1e-4 of its largest value, or
    of 1e-2 of the module's largest gradient where that is larger: a
    gradient that is 0 in exact arithmetic (the grouped MLP's output bias
    under the softmax over the neighbours; in training a bias that the
    next BatchNorm's batch mean takes out) is rounding noise on both
    sides."""
    top = max(np.abs(w).max() for w in want.values())
    for pname, p in mod.named_parameters():
        w = want[pname]
        scale = max(np.abs(w).max(), 1e-2 * top)
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * scale, pname


# ------------------------------------------------------------ the modules
MODULES = {
    "vector": (lambda: VectorAttention(EMB, DQKV, K), "VectorAttention",
               dict(emb_dim=EMB, d_qkv=DQKV, k=K)),
    "multi_head_vector": (
        lambda: MultiHeadVectorAttention(EMB, 2, DQKV, K),
        "MultiHeadVectorAttention",
        dict(emb_dim=EMB, n_heads=2, dim_head=DQKV, k=K)),
    "multi_headed": (lambda: MultiHeadedAttention(4, EMB, 0.0),
                     "MultiHeadedAttention",
                     dict(h=4, d_model=EMB, dropout=0.0)),
}


@pytest.mark.parametrize("kind", list(MODULES))
def test_attention_module_matches_flax(kind):
    """The module against its flax twin on the flax weights: the output,
    the gradients of a random projection of it with respect to every
    input and every parameter, within rel 1e-4."""
    from dgcnn_tpu.models import attention as jattention

    make, name, kw = MODULES[kind]
    fmod = getattr(jattention, name)(**kw)
    arrays = _inputs(10)
    if kind == "multi_headed":
        arrays = arrays[:3]
    jin = [jnp.asarray(a) for a in arrays]
    variables = fmod.init(jax.random.PRNGKey(1), *jin)
    cot = np.random.default_rng(11).standard_normal(
        (2, N, EMB)).astype(np.float32)

    def loss(params, *xs):
        return jnp.sum(fmod.apply({"params": params}, *xs) * cot)

    with jax.default_matmul_precision(F32):
        want = np.asarray(fmod.apply(variables, *jin))
        gp, *gx = jax.grad(loss, argnums=tuple(range(len(jin) + 1)))(
            variables["params"], *jin)
    mod = make()
    mod.load_state_dict(module_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = mod(*xs)
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel(got.detach(), want) <= 1e-4
    for x, g in zip(xs, gx):
        assert _rel(x.grad, g) <= 1e-4
    _assert_param_grads(mod, _flax_grads_as_port(gp))


# (blocks, training): the reference's own gradient is NaN on thousands of
# src / tgt elements at 2 blocks in eval on these inputs (the port's is
# finite), so that case is not held
@pytest.mark.parametrize("n_blocks,train", [(1, False), (1, True),
                                            (2, True)],
                         ids=["1-eval", "1-train", "2-train"])
def test_transformer_matches_flax(n_blocks, train):
    """The custom Transformer against flax at dropout 0: both embeddings
    and the gradients of both (through the two applications) with
    respect to src, tgt and the parameters within rel 1e-4; in training
    the BatchNorms normalize with each application's own batch, and their
    running statistics, moved twice (num_batches_tracked 2), equal the
    flax ones after its two calls."""
    from dgcnn_tpu.models.transformer import Transformer as FT

    fmod = FT(EMB, n_blocks, DQKV, K, FF, 0.0)
    src, tgt, _, pc = _inputs(20 + n_blocks)
    jin = [jnp.asarray(a) for a in (src, tgt, pc)]
    variables = _stats_from_seed(fmod.init(jax.random.PRNGKey(2), *jin),
                                 21)
    rng = np.random.default_rng(22)
    cots = [rng.standard_normal((2, N, EMB)).astype(np.float32)
            for _ in range(2)]

    def loss(params, s, t):
        out = fmod.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, s, t,
                         jin[2], train, mutable=["batch_stats"])
        (a, b), new = out
        return jnp.sum(a * cots[0]) + jnp.sum(b * cots[1]), ((a, b), new)

    with jax.default_matmul_precision(F32):
        (gp, gs, gt), ((want_a, want_b), new) = jax.grad(
            loss, argnums=(0, 1, 2), has_aux=True)(variables["params"],
                                                   jin[0], jin[1])
    mod = Transformer(EMB, n_blocks, DQKV, K, FF, 0.0)
    mod.load_state_dict(module_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    s, t = (torch.tensor(a, requires_grad=True) for a in (src, tgt))
    a, b = mod(s, t, torch.from_numpy(pc), train)
    (a * torch.from_numpy(cots[0]) + b * torch.from_numpy(cots[1])).sum(
        ).backward()
    assert _rel(a.detach(), want_a) <= 1e-4
    assert _rel(b.detach(), want_b) <= 1e-4
    assert _rel(s.grad, gs) <= 1e-4 and _rel(t.grad, gt) <= 1e-4
    _assert_param_grads(mod, _flax_grads_as_port(gp))
    if train:
        after = module_state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, {"params": variables["params"], **new}))
        for key, v in mod.state_dict().items():
            if key.endswith("num_batches_tracked"):
                assert int(v) == 2, key
            elif key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), after[key].numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=key)
