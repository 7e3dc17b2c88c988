"""The port's AMP (bf16) eval of the fusion Net against the JAX package's
default mode, on the CPU at small sizes: kernel 10's v2 form, kernel 14's
AMP form, the bf16 transformer and the whole Net.

The JAX side runs its fused Pallas path in interpret mode
(``DGCNN_TPU_PALLAS=1``) with ``DGCNN_TPU_PALLAS_EXACT`` unset (its AMP
default) under ``jax.default_matmul_precision("float32")``; its kernels
read the variables when they trace, so every test starts and ends with
``jax.clear_caches()``, and a test that changes a variable between two
JAX calls clears the caches in between.  On the CPU the JAX transformer
takes its dense path (the fused attention kernel is its accelerator's),
so kernel 14's AMP form is also held against ``fused_attention`` in
interpret mode directly.  The port's side is the plain versions, which
CPU tensors take.  Each tolerance is stated where it is held:

- kernel 10's v2: the same idx on every row (exact f32 scores in both
  frameworks, packed into the same keys), the sums within rel 1e-5 of
  each row's scale (the TPU sums through a 3-way bf16 split, the port in
  list order);
- a bf16 output (kernels 1 and 6): within one bf16 ulp on >= 99.9% of
  the rows; kernel 14's, the attention module's and the transformer's
  within one bf16 ulp of the larger of the value and its row's rms
  (``_ulp_rows_rms``; an output that cancels to near zero has ulps far
  below its terms' rounding), on >= 99.9% of rows (the transformer's: the
  share stated at its test); kernel 2's rel 1e-5;
- the Net's logits: the same argmax on >= 99.5% of the points, max|diff|
  below the JAX package's own AMP-vs-exact max|diff| and within twice the
  JAX AMP forward's own move under a perturbation of its input below bf16
  rounding (the test says why a tenth of the gap cannot hold here).
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.models import Net, TorchMultiheadAttention
from dgcnn_tpu_torch.models import TorchTransformer, init_like_flax_
from dgcnn_tpu_torch.ops.amp_select import EXACT_ENV, EXTRACT_ENV
from dgcnn_tpu_torch.ops.attention import (
    attention_amp_plain,
    fused_attention,
)
from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool
from dgcnn_tpu_torch.ops.edge2_kernel import knn_edge2
from dgcnn_tpu_torch.ops.edge_conv_kernel import edge_conv_eval
from dgcnn_tpu_torch.ops.knn_sum_kernel import knn_sum, knn_sum_plain

F32 = "float32"
BF16 = torch.bfloat16


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


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(_np(x)).to(BF16)


def _ulp_rows(got: torch.Tensor, want) -> float:
    """Share of the last axis's rows whose bf16 values are all within one
    ulp of ``want``'s (a JAX array or a tensor)."""
    w = want if isinstance(want, torch.Tensor) else _bf16(want)
    d = (got.view(torch.int16).int() - w.view(torch.int16).int()).abs()
    return (d.amax(-1) <= 1).float().mean().item()


def _rms_ulps(got: torch.Tensor, want) -> torch.Tensor:
    """Each value's distance from ``want``'s (a JAX array or a tensor) in
    bf16 ulps of the larger of ``want``'s magnitude and its row's rms: an
    attention output that cancels to near zero has ulps far below its
    terms' rounding (even an f64 reference misses the JAX kernel's bf16
    output by up to 2^15 of those ulps there)."""
    w = (want if isinstance(want, torch.Tensor) else _bf16(want)).float()
    mag = torch.maximum(w.abs(), w.square().mean(-1, keepdim=True).sqrt())
    return (got.float() - w).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                                - 7)


def _ulp_rows_rms(got: torch.Tensor, want) -> float:
    """Share of rows whose values are all within one ``_rms_ulps``."""
    return (_rms_ulps(got, want).amax(-1) <= 1).float().mean().item()


# -------------------------------------------------------------- kernel 10
def _hog_inputs(kind: str, n: int, seed: int):
    """A centred cloud and its nine moments, as the HOG hands kernel 10
    them; ``ints``: integer points, each four times."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        x = np.concatenate([rng.integers(-3, 4, (3, n // 4, 3))] * 4,
                           axis=1).astype(np.float32)
    else:
        x = rng.standard_normal((3, n, 3)).astype(np.float32)
        x -= x.mean(axis=1, keepdims=True)
    a = np.concatenate([x, x * x, x[..., [0, 0, 1]] * x[..., [1, 2, 2]]],
                       axis=-1)
    return x, a


@pytest.mark.parametrize("kind", ["random", "ints"])
@pytest.mark.parametrize("k", [1, 20, 32])
def test_knn_sum_v2_matches_pallas(kind, k, amp_env):
    """Kernel 10's AMP form (v2 over the exact f32 scores) against
    ``fused_knn_sum`` with the exact pin unset (its v2 default): the same
    idx on every row, the sums within rel 1e-5 of each row's scale; the
    exact mode's v1, and the variable overriding the mode."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_sum

    x, a = _hog_inputs(kind, 256, 10 + k)
    with jax.default_matmul_precision(F32):
        jidx, jsum = fused_knn_sum.__wrapped__(jnp.asarray(x), jnp.asarray(a),
                                               k, interpret=True)
    idx, asum = knn_sum(torch.from_numpy(x), torch.from_numpy(a), k,
                        amp=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[..., 0] == torch.arange(256)).all() or kind == "ints"
    jsum = np.asarray(jsum)
    scale = np.abs(jsum).max(-1, keepdims=True).clip(1e-30)
    assert (np.abs(asum.numpy() - jsum) <= 1e-5 * scale).all()
    assert torch.equal(idx, knn_sum_plain(torch.from_numpy(x),
                                          torch.from_numpy(a), k, "v2")[0])
    # the exact mode keeps v1 (the variable overrides either)
    v1 = knn_sum(torch.from_numpy(x), torch.from_numpy(a), k)[0]
    assert torch.equal(v1, knn_sum_plain(torch.from_numpy(x),
                                         torch.from_numpy(a), k, "v1")[0])
    amp_env.setenv(EXTRACT_ENV, "v1")
    assert torch.equal(knn_sum(torch.from_numpy(x), torch.from_numpy(a), k,
                               amp=True)[0], v1)


# -------------------------------------------------------------- kernel 14
def _qkv(b, h, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((b, h, n, d)).astype(np.float32)
                        ).astype(jnp.bfloat16) for n in (nq, nk, nk)]


@pytest.mark.parametrize("d,nq,nk", [(128, 128, 256), (256, 256, 128),
                                     (512, 128, 256)])
def test_attention_amp_matches_pallas(d, nq, nk, amp_env):
    """Kernel 14's AMP form on bf16 q, k and v (``fused_attention`` on bf16
    tensors, its plain version on the CPU) against the JAX fused kernel in
    interpret mode at rate 0: within one bf16 ulp (floored at the row's
    rms, ``_ulp_rows_rms``) on >= 99.9% of rows."""
    from dgcnn_tpu.ops.pallas_attention import fused_attention as jfused

    q, k, v = _qkv(2, 2, nq, nk, d, d + nq)
    with jax.default_matmul_precision(F32):
        want = jfused(q, k, v, sm_scale=d ** -0.5, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = fused_attention(*map(_bf16, (q, k, v)), d ** -0.5)
    assert got.dtype == BF16 and got.shape == (2, 2, nq, d)
    assert _ulp_rows_rms(got, want) >= 0.999
    assert torch.equal(got, attention_amp_plain(*map(_bf16, (q, k, v)),
                                                d ** -0.5))


def test_attention_amp_refuses_training():
    """bf16 q, k and v with a gradient or a dropout rate take kernel 14's
    AMP training form (``FusedAttentionAMP``; kernel 15's bf16 form
    backward): at rate 0 its output is the evaluation form's bit for bit
    and its gradients are bf16; a rate needs a seed, and picks the mask."""
    g = torch.Generator().manual_seed(176)
    q, k, v = (torch.randn((1, 2, 128, 128), generator=g).to(BF16)
               for _ in range(3))
    with pytest.raises(ValueError, match="needs a seed"):
        fused_attention(q, k, v, 0.1, 0.5)
    qg = q.clone().requires_grad_()
    out = fused_attention(qg, k, v, 0.1)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), fused_attention(q, k, v, 0.1))
    (dq,) = torch.autograd.grad(out.float().sum(), qg)
    assert dq.dtype == BF16 and dq.shape == q.shape
    seed = torch.zeros(1, dtype=torch.int64)
    dropped = fused_attention(q, k, v, 0.1, 0.5, seed)
    assert dropped.dtype == BF16 and not torch.equal(dropped, out.detach())
    assert torch.equal(dropped, fused_attention(q, k, v, 0.1, 0.5, seed))


def _mha_params(mha: TorchMultiheadAttention) -> dict:
    return {"in_proj_weight": mha.in_proj_weight.detach().numpy(),
            "in_proj_bias": mha.in_proj_bias.detach().numpy(),
            "out_proj": {"kernel": mha.out_proj.weight.detach().numpy().T,
                         "bias": mha.out_proj.bias.detach().numpy()}}


@pytest.mark.parametrize("e,h", [(256, 2), (256, 1), (128, 2)])
def test_attention_module_bf16_matches_flax(e, h, amp_env):
    """TorchMultiheadAttention in bf16 (the projections rounded to bf16,
    kernel 14's AMP plain version, out_proj in bf16) against flax's with
    dtype=bf16 (its dense path on the CPU: bf16 scores divided by sqrt(d),
    the softmax in f32 cast to bf16) on the same weights, query and key
    lengths apart: within one bf16 ulp (``_ulp_rows_rms``) on >= 99.9% of
    rows; and
    ``attention_amp_plain`` on the module's own bf16 heads against the JAX
    fused kernel likewise."""
    from dgcnn_tpu.models.torch_transformer import (
        TorchMultiheadAttention as FlaxMHA,
    )

    rng = np.random.default_rng(e + h)
    q_in = rng.standard_normal((2, 128, e)).astype(np.float32)
    kv_in = rng.standard_normal((2, 256, e)).astype(np.float32)
    mha = TorchMultiheadAttention(e, h)
    init_like_flax_(mha, torch.Generator().manual_seed(e + h))
    with torch.no_grad():
        mha.in_proj_bias.copy_(torch.from_numpy(
            0.1 * rng.standard_normal(3 * e).astype(np.float32)))
        mha.out_proj.bias.copy_(torch.from_numpy(
            0.1 * rng.standard_normal(e).astype(np.float32)))
    with jax.default_matmul_precision(F32):
        want = FlaxMHA(e, h, dtype=jnp.bfloat16).apply(
            {"params": _mha_params(mha)}, jnp.asarray(q_in),
            jnp.asarray(kv_in), jnp.asarray(kv_in))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = mha(*(torch.from_numpy(t) for t in (q_in, kv_in, kv_in)),
                  dtype=BF16)
    assert got.dtype == BF16
    assert _ulp_rows_rms(got, want) >= 0.999


def _transformer(e=128, heads=2, blocks=2, ff=64, seed=6):
    model = TorchTransformer(e, heads, blocks, blocks, ff, "leaky_relu",
                             "relu")
    init_like_flax_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                         .manual_seed(len(name))))
    return model


def _perturbed(x: np.ndarray, seed: int, rel: float = 2.0 ** -20,
               share: float = 0.01) -> np.ndarray:
    """``x`` with a ``share`` of its values scaled by 1 + ``rel``: by
    default a change below the rounding of any bf16 value made from it."""
    rng = np.random.default_rng(seed)
    out = x.copy()
    pick = rng.random(x.shape) < share
    out[pick] *= np.float32(1 + rel)
    return out


def test_transformer_bf16_matches_flax(amp_env):
    """TorchTransformer in bf16 (2 + 2 layers, d = 64 heads: the plain AMP
    attention) against flax's with dtype=bf16 on the weights its
    convert_torch_transformer reads, f32 inputs as the Net hands them.

    Each layer and final norm, fed the same inputs: within one bf16 ulp
    (``_rms_ulps``) on >= 98% of rows and four on every value (a softmax
    or LayerNorm in f32 may take an exp or a sum an f32 ulp apart, which
    moves a bf16 rounding).  The stack: no farther from flax's bf16 output
    than twice as far as flax's own bf16 output moves when 0.5% of its
    inputs change by one bf16 ulp, the size of the jitter one layer hands
    the next (``_perturbed``; the inputs are rounded to bf16 where the
    first projections read them): over four layers the bf16 stack moves
    by about as much as its bf16-vs-f32 gap (measured: the port 0.0625
    from flax, flax's own move 0.0625, the gap 0.044)."""
    from flax import linen as fnn

    from dgcnn_tpu.convert.torch_import import convert_torch_transformer
    from dgcnn_tpu.models.torch_transformer import (
        TorchTransformer as FlaxTransformer,
    )
    from dgcnn_tpu.models.torch_transformer import (
        TorchTransformerDecoderLayer as FlaxDec,
    )
    from dgcnn_tpu.models.torch_transformer import (
        TorchTransformerEncoderLayer as FlaxEnc,
    )

    from dgcnn_tpu_torch.models.nn_layers import layer_norm

    model = _transformer()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, _ = convert_torch_transformer(sd, "", 2, 2)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(7)
    src, tgt = (rng.standard_normal((2, 128, 128)).astype(np.float32)
                for _ in range(2))

    def tj(t):
        return (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                if t.dtype == BF16 else jnp.asarray(t.numpy()))

    def held(got, want):
        r = _rms_ulps(got, want)
        assert got.dtype == BF16
        assert (r.amax(-1) <= 1).float().mean().item() >= 0.98
        assert r.max().item() <= 4

    bf = jnp.bfloat16
    with torch.no_grad(), jax.default_matmul_precision(F32):
        x = torch.from_numpy(src)
        for i, layer in enumerate(model.encoder.layers):
            got = layer(x, dtype=BF16)
            held(got, FlaxEnc(128, 2, 64, 0.0, "leaky_relu", dtype=bf).apply(
                {"params": pj[f"encoder_layer_{i}"]}, tj(x)))
            x = got
        mem = layer_norm(model.encoder.norm, x, BF16)
        held(mem, fnn.LayerNorm(epsilon=1e-5, dtype=bf).apply(
            {"params": pj["encoder_norm"]}, tj(x)))
        y = torch.from_numpy(tgt)
        for i, layer in enumerate(model.decoder.layers):
            got = layer(y, mem, dtype=BF16)
            held(got, FlaxDec(128, 2, 64, 0.0, "relu", dtype=bf).apply(
                {"params": pj[f"decoder_layer_{i}"]}, tj(y), tj(mem)))
            y = got

        def flax_stack(s, dt=bf):
            return _np(FlaxTransformer(128, 2, 2, 2, 64, 0.0, "leaky_relu",
                                       "relu", dtype=dt).apply(
                {"params": pj}, jnp.asarray(s), jnp.asarray(tgt)))

        want = flax_stack(src)
        floor = np.abs(flax_stack(_perturbed(src, 8, 2.0 ** -8, 0.005))
                       - want).max()
        got = model(torch.from_numpy(src), torch.from_numpy(tgt),
                    dtype=BF16)
    assert got.dtype == BF16 and floor > 0
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 * floor, (err, floor)


# ----------------------------------------------------- kernels 1, 6 and 2
NET_STAGES = [(3, 64), (64, 64), (64, 128), (128, 256)]


@pytest.mark.parametrize("cin,co", NET_STAGES)
def test_edge_conv_amp_at_net_widths_matches_pallas(cin, co, amp_env):
    """Kernel 1's AMP form at the Net backbone's widths and k = 32 (the
    first stage on the f32 cloud, the others on bf16 stage outputs; v3,
    v3, v2 and select-x v2): within one bf16 ulp of
    ``fused_edge_conv_eval`` on >= 99.9% of rows, the ulp floored at the
    row's rms (``_ulp_rows_rms``: the epilogue's max + centre term can
    cancel to near zero, where an f32 sum in another order moves the bf16
    value by many of its own ulps)."""
    from dgcnn_tpu.ops.pallas_knn import fused_edge_conv_eval

    rng = np.random.default_rng(cin + co)
    x = jnp.asarray(rng.standard_normal((2, 256, cin)).astype(np.float32))
    if cin > 3:
        x = x.astype(jnp.bfloat16)
    args = [(rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32)
            for _ in range(2)]
    args += [rng.uniform(0.5, 1.5, co).astype(np.float32),
             (0.1 * rng.standard_normal(co)).astype(np.float32)]
    with jax.default_matmul_precision(F32):
        want = fused_edge_conv_eval.__wrapped__(
            x, x, *map(jnp.asarray, args), 32, select_dtype=jnp.bfloat16,
            interpret=True)
    xt = _bf16(x) if cin > 3 else torch.from_numpy(_np(x))
    got = edge_conv_eval(xt, xt, *map(torch.from_numpy, args), 32, amp=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _ulp_rows_rms(got, want) >= 0.999


def test_transform_net_amp_kernels_match_pallas(amp_env):
    """The PositionEmbedding's TransformNet in AMP at k = 32: kernel 6's
    AMP form (Cg = 3, C1 = 64, C2 = 128; v3) within one bf16 ulp of
    ``fused_knn_edge2`` on >= 99.9% of rows, then kernel 2's AMP form of
    conv3 (128 -> 1024, max only) on its output within rel 1e-5 of
    ``fused_conv_pool``."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_edge2
    from dgcnn_tpu.ops.pallas_pool import fused_conv_pool

    rng = np.random.default_rng(31)
    g = rng.standard_normal((2, 256, 3)).astype(np.float32)
    a1, b1 = (rng.standard_normal((2, 256, 64)).astype(np.float32)
              for _ in range(2))
    s1 = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    t1 = (0.1 * rng.standard_normal(64)).astype(np.float32)
    w2 = (rng.standard_normal((64, 128)) / 8).astype(np.float32)
    s2 = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    t2 = (0.1 * rng.standard_normal(128)).astype(np.float32)
    args = (a1, b1, s1, t1, w2, s2, t2)
    w3 = (rng.standard_normal((128, 1024)) / np.sqrt(128)).astype(np.float32)
    s3 = rng.uniform(0.5, 1.5, 1024).astype(np.float32)
    t3 = (0.1 * rng.standard_normal(1024)).astype(np.float32)
    with jax.default_matmul_precision(F32):
        want6 = fused_knn_edge2.__wrapped__(jnp.asarray(g),
                                            *map(jnp.asarray, args), 32,
                                            interpret=True)
        want2 = np.asarray(fused_conv_pool(
            (want6,), *map(jnp.asarray, (w3, s3, t3)),
            compute_dtype=jnp.bfloat16, with_mean=False, interpret=True))
    got6 = knn_edge2(torch.from_numpy(g), *map(torch.from_numpy, args), 32,
                     amp=True)
    assert got6.dtype == BF16 and got6.shape == (2, 256, 128)
    assert _ulp_rows(got6, want6) >= 0.999
    got2 = conv_pool((_bf16(want6),), *map(torch.from_numpy, (w3, s3, t3)),
                     with_mean=False, amp=True)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-5,
                               atol=1e-5 * np.abs(want2).max())


# ---------------------------------------------------------------- the Net
NET = dict(emb_dim=256, k=20, ff_dims=64, n_heads=2, n_blocks=2)


def _net_pair(seed: int):
    """The port's Net with seeded weights and the flax Net and variables
    the JAX package's convert_net makes of them."""
    from dgcnn_tpu.convert.torch_import import convert_net
    from dgcnn_tpu.models import Net as FlaxNet

    model = Net(**NET, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax.tree_util.tree_map(jnp.asarray, convert_net(sd, 2))
    return model, FlaxNet(**NET, dropout=0.0), variables


def test_net_amp_matches_jax_amp(amp_env):
    """The whole AMP Net eval (kernels 1, 6, 2 and 10 in their AMP forms,
    the bf16 grads_emb, transformer, attention and head) against the JAX
    Net's default forward on the same weights: the same argmax on >= 99.5%
    of the points; max|diff| below the JAX package's own AMP-vs-exact
    max|diff| on the same input, and at most twice as large as the JAX AMP
    forward's own move when 1% of the input coordinates change below their
    bf16 rounding (``_perturbed``).  A tenth of the AMP-vs-exact gap, the
    DGCNNCls and segmentation models' rule, is below that floor here: the
    transformer carries each bf16 rounding's jitter through eight layers
    (``test_transformer_bf16_matches_flax``); measured on this input, the
    port 0.0068 from JAX, JAX's own move 0.0059, the gap 0.0088."""
    model, fmodel, variables = _net_pair(81)
    rng = np.random.default_rng(82)
    x = rng.standard_normal((2, 128, 3)).astype(np.float32)
    oh = np.eye(16, dtype=np.float32)[[4, 9]]
    with jax.default_matmul_precision(F32):
        amp_j, moved = (np.asarray(fmodel.apply(
            variables, jnp.asarray(c), jnp.asarray(oh), False))
            for c in (x, _perturbed(x, 83)))
        jax.clear_caches()
        amp_env.setenv(EXACT_ENV, "1")
        exact_j = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                          jnp.asarray(oh), False))
        amp_env.delenv(EXACT_ENV)
    gap = np.abs(amp_j - exact_j).max()
    floor = np.abs(moved - amp_j).max()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(oh),
                    amp=True).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 128, 50)
    assert gap > 0 and floor > 0
    agree = (got.argmax(-1) == amp_j.argmax(-1)).mean()
    assert agree >= 0.995, agree
    err = np.abs(got - amp_j).max()
    assert err < gap and err <= 2 * floor, (err, gap, floor)


def test_net_exact_pin_and_cpu_default_are_the_exact_path(amp_env):
    """On the CPU the Net's default forward is the exact path, and with
    DGCNN_TPU_PALLAS_EXACT set too, bit for bit (kernel 10's v1 included);
    amp=True is another path, in training too."""
    model = Net(emb_dim=32, k=10, ff_dims=16, n_heads=2, n_blocks=1,
                device="cpu", generator=torch.Generator().manual_seed(91))
    x = torch.randn(2, 128, 3, generator=torch.Generator().manual_seed(92))
    oh = torch.eye(16)[[0, 5]]
    with torch.no_grad():
        exact = model(x, oh, amp=False)
        assert torch.equal(model(x, oh), exact)
        assert not torch.equal(model(x, oh, amp=True), exact)
        amp_env.setenv(EXACT_ENV, "1")
        assert torch.equal(model(x, oh), exact)
    assert "amp" in inspect.signature(Net.forward).parameters
    trained = model(x, oh, train=True, amp=True,
                    generator=torch.Generator().manual_seed(93))
    assert trained.dtype == torch.float32 and not torch.equal(
        trained.detach(), model(x, oh, train=True, amp=False,
                                generator=torch.Generator().manual_seed(93)
                                ).detach())
