"""The AMP (bf16) side of this slice on the CPU, against the JAX package:
the custom-attention fusion Net's AMP forward against the JAX Net's
default forward, kernel 12's AMP form at Co = 128 (project-first v2) and
Co = 256 (select-x v2) against the Pallas banded kernel in interpret mode,
and the kNN kernels' packed words at 15 index bits (N = 32768), emulated.

The JAX side runs its default mode (``DGCNN_TPU_PALLAS=1``, the exact pin
unset: the Pallas kernels in interpret mode, AMP) under
``jax.default_matmul_precision("float32")``; the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerances: the
AMP Net's f32 transformer outputs within rel 1e-5, its logits' argmax on
>= 99.5% of points and max|diff| within a tenth of the JAX AMP-vs-exact
gap; kernel 12's rows within one bf16 ulp on >= 99.9% of rows; the
packed words exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import Net
from dgcnn_tpu_torch.ops.amp_select import (
    EXACT_ENV,
    EXTRACT_ENV,
    index_bits,
    pack_keys,
    v2_indices,
)
from dgcnn_tpu_torch.ops.banded import banded_edge_conv_eval

from test_torch_custom_attention import _stats_from_seed

F32 = "float32"
NET = dict(emb_dim=64, k=10, n_heads=1, n_blocks=1, ff_dims=32, d_qkv=16)


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
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x)


def _ulp_rows(got: torch.Tensor, want) -> float:
    w = torch.from_numpy(_np(want)).to(torch.bfloat16)
    d = (got.view(torch.int16).int() - w.view(torch.int16).int()).abs()
    return (d.amax(-1) <= 1).float().mean().item()


# ---------------------------------------------------------------- the Net
def test_custom_attention_net_amp_matches_jax_amp(amp_env):
    """The custom-attention Net's AMP eval (kernels 1, 6, 2 and 10 in
    their AMP forms, the bf16 grads_emb, attention and head; the custom
    transformer in f32, as the JAX one computes it) against the JAX Net's
    default forward on the same weights: both transformer outputs f32 and
    within rel 1e-5 of the JAX ones; the logits' argmax the same on >=
    99.5% of the points and their max|diff| within a tenth of the JAX
    package's own AMP-vs-exact max|diff| (the DGCNNCls and segmentation
    models' rule): the f32 transformer outputs, a few f32 ulps apart, can
    round to bf16 one ulp apart in the last attention."""
    from dgcnn_tpu.models import Net as FlaxNet

    fmodel = FlaxNet(**NET, dropout=0.0, use_custom_attention=True)
    rng = np.random.default_rng(90)
    x = rng.standard_normal((2, 128, 3)).astype(np.float32)
    oh = np.eye(16, dtype=np.float32)[[4, 9]]
    amp_env.setenv("DGCNN_TPU_PALLAS", "0")     # the init on the XLA path
    variables = _stats_from_seed(jax.jit(lambda x, oh: fmodel.init(
        jax.random.PRNGKey(5), x, oh, False))(jnp.asarray(x[:, :120]),
                                              jnp.asarray(oh)), 6)
    amp_env.setenv("DGCNN_TPU_PALLAS", "1")
    with jax.default_matmul_precision(F32):
        amp_j, inter = jax.jit(lambda v, x, oh: fmodel.apply(
            v, x, oh, False, capture_intermediates=True))(
                variables, jnp.asarray(x), jnp.asarray(oh))
        jax.clear_caches()
        amp_env.setenv(EXACT_ENV, "1")
        exact_j = np.asarray(jax.jit(
            lambda v, x, oh: fmodel.apply(v, x, oh, False))(
                variables, jnp.asarray(x), jnp.asarray(oh)))
        amp_env.delenv(EXACT_ENV)
    amp_j = np.asarray(amp_j)
    want_tr = inter["intermediates"]["transformer"]["__call__"][0]
    assert all(t.dtype == jnp.float32 for t in want_tr)
    model = Net(**NET, dropout=0.0, use_custom_attention=True, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    seen = []
    model.transformer.register_forward_hook(
        lambda mod, args, out: seen.extend(out))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(oh),
                    amp=True).numpy()
    assert [t.dtype for t in seen] == [torch.float32, torch.float32]
    for t, w in zip(seen, want_tr):
        w = np.asarray(w)
        assert np.abs(t.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    gap = np.abs(amp_j - exact_j).max()
    assert got.dtype == np.float32 and got.shape == (2, 128, 50)
    agree = (got.argmax(-1) == amp_j.argmax(-1)).mean()
    assert agree >= 0.995, agree
    err = np.abs(got - amp_j).max()
    assert err <= 0.1 * gap, (err, gap)


# -------------------------------------------------------------- kernel 12
@pytest.mark.parametrize("cin,co", [(64, 128), (128, 256)],
                         ids=["project-first", "select-x"])
def test_banded_amp_at_co_above_64_matches_pallas(cin, co, amp_env):
    """Kernel 12's AMP form at the fusion Net's stages 3 (64 -> 128, v2
    project-first) and 4 (128 -> 256, v2 select-x: the window's bf16 x
    rows selected, each projected with the f32 W_nbr) on bf16 stage
    inputs (N = 256, band 128, k = 20): the plain version within one bf16
    ulp of the Pallas banded kernel on >= 99.9% of rows."""
    from dgcnn_tpu.ops.pallas_banded import banded_edge_conv_eval as jfn12

    rng = np.random.default_rng(cin)
    n, band = 256, 128
    x = rng.standard_normal((2, n, cin)).astype(np.float32)
    args = (rng.standard_normal((cin, co)).astype(np.float32) / cin ** 0.5,
            rng.standard_normal((cin, co)).astype(np.float32) / cin ** 0.5,
            (rng.random(co) - 0.2).astype(np.float32),
            rng.standard_normal(co).astype(np.float32))
    with jax.default_matmul_precision(F32):
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        want = jfn12.__wrapped__(xb, xb, *map(jnp.asarray, args), 20, band,
                                 0.2, select_dtype=jnp.bfloat16,
                                 interpret=True)
    xt = torch.from_numpy(_np(xb)).to(torch.bfloat16)
    got = banded_edge_conv_eval(xt, xt, *map(torch.from_numpy, args), 20,
                                band, 0.2, amp=True)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == (2, n, co)
    assert _ulp_rows(got, want) >= 0.999


# ------------------------------------------------------ 15 index bits
def test_packed_words_at_15_index_bits():
    """At N = 32768 (15 index bits): the tiled selection's v2 keys, q =
    max(rint(s * (-lim / rmin)), -lim) with lim = 2^16 - 1 computed in f32
    (csrc/knn_select.cuh, TS_KEYS), are integers below 2^24, exact in f32,
    and ordering by (q desc, column asc) gives ``v2_indices``'s lists
    (the packed keys q * 2^15 + (N - 1 - column) fit int32); and a v3
    list word holding one class of 32768 members, (count << 16 | lowest),
    reads back its count as unsigned (``class_count``), where an
    arithmetic shift of the int32 word reads -32768."""
    n, k = 32768, 20
    rng = np.random.default_rng(15)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    pts[100:140] = pts[7]                   # ties among the keys too
    q_pts = torch.from_numpy(pts[:8])
    cloud = torch.from_numpy(pts)
    scores = (2 * q_pts @ cloud.T - (q_pts * q_pts).sum(-1)[:, None]
              - (cloud * cloud).sum(-1)[None])
    assert index_bits(n) == 15
    lim = np.float32(2 ** 16 - 1)
    rmin = scores.numpy().min(-1, keepdims=True)
    scale = np.where(rmin < 0, -lim / rmin, np.float32(0)).astype(np.float32)
    q = np.maximum(np.rint(scores.numpy() * scale), -lim).astype(np.float32)
    assert np.abs(q).max() <= lim < 2 ** 24
    assert np.array_equal(q, np.round(q))
    cols = np.arange(n)
    order = np.lexsort((cols[None].repeat(8, 0), -q), axis=-1)[:, :k]
    np.testing.assert_array_equal(
        v2_indices(scores[None], k)[0].numpy(), order)
    keys = pack_keys(scores).numpy().astype(np.int64)
    np.testing.assert_array_equal(
        keys, q.astype(np.int64) * 2 ** 15 + (n - 1 - cols))
    assert keys.min() >= -(2 ** 31) and keys.max() < 2 ** 31
    word = np.array([(n << 16) | 7], dtype=np.uint32).view(np.int32)
    assert int(word.view(np.uint32)[0]) >> 16 == n
    assert int(word[0]) >> 16 == -n
    assert int(word[0]) & 0xFFFF == 7
