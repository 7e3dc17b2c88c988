"""Parity of the PyTorch port's fusion Net slice with the JAX package's, on
the CPU at small sizes: the 3x3 eigendecomposition, the three HOG forms,
the plain versions of kernels 9 (``edge_sum``), 10 (``knn_sum``) and 14
(``fused_attention``) against the Pallas kernels in interpret mode, the
torch-style transformer, the ``Net`` logits, its checkpoint layouts and
the partseg CLI's ``--model transformer --eval=True``.

Both sides take the same numpy inputs.  Models start from the port's
seeded weights, carried into a flax tree by the JAX package's
``convert_net`` (the same tree ``export_net`` writes back).  The JAX side
runs its fused exact path (``DGCNN_TPU_PALLAS=1``,
``DGCNN_TPU_PALLAS_EXACT=1``: the Pallas kernels in interpret mode, f32
throughout) under ``jax.default_matmul_precision("float32")``, except for
the gather and ``bug_compat`` HOG forms, which its default path takes; its
attention on the CPU is always the dense path.  The port's kernels run
their plain versions because the tensors lie on the CPU.  Batches of 3
clouds keep the shapes apart from other files' jitted Pallas traces,
which a worker process shares.  Tests marked ``cuda`` hold each kernel
against its plain version and skip without a card.
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import load_checkpoint, state_dict_from_flax
from dgcnn_tpu_torch.models import (
    Net,
    TorchMultiheadAttention,
    TorchTransformer,
    init_like_flax_,
)
from dgcnn_tpu_torch.ops import (
    attention_plain,
    edge_sum,
    edge_sum_plain,
    fused_attention,
    knn_sum,
    knn_sum_plain,
)
from dgcnn_tpu_torch.ops.eig3 import principal_eig3x3_sym
from dgcnn_tpu_torch.ops.hog import compute_hog

from test_torch_port_partseg import _log_lines, shapenet_dir  # noqa: F401

F32 = "float32"
# the fusion Net at a small width: the bench config's heads and blocks
# (2, 2) and the partseg CLI's defaults (1, 1)
NET_SMALL = dict(emb_dim=32, k=10, ff_dims=16)
CONFIGS = {"bench": dict(n_heads=2, n_blocks=2),
           "cli_default": dict(n_heads=1, n_blocks=1)}


@pytest.fixture
def pallas_exact(monkeypatch):
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")


def _cloud(seed, b=3, n=128):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(
        np.float32)


def _torch_sd(sd: dict) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _port_net(seed, n_heads, n_blocks) -> Net:
    return Net(**NET_SMALL, n_heads=n_heads, n_blocks=n_blocks, device="cpu",
               generator=torch.Generator().manual_seed(seed))


def _flax_net(model: Net, n_heads, n_blocks):
    """The flax Net and its variables, converted from ``model``'s state
    dict by the JAX package's convert_net."""
    from dgcnn_tpu.convert.torch_import import convert_net
    from dgcnn_tpu.models import Net as FlaxNet

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       convert_net(sd, n_blocks))
    return FlaxNet(**NET_SMALL, n_heads=n_heads, n_blocks=n_blocks,
                   dropout=0.0), variables


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def test_principal_eig3x3_sym_matches_jax():
    """Principal eigenvector and its polished eigenvalue of random
    symmetric 3x3 matrices, isotropic and rank-one ones among them, within
    rel 1e-5 of JAX's (the same operations in the same order, the same
    sign rule)."""
    from dgcnn_tpu.ops.eig3 import principal_eig3x3_sym as jeig

    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 40, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)
    scales = np.float32([1, 2, 0, 3])[:, None, None]
    cov[0, :4] = np.eye(3, dtype=np.float32) * scales
    u = rng.standard_normal((4, 3)).astype(np.float32)
    cov[1, :4] = u[:, :, None] * u[:, None, :]
    v, lam = principal_eig3x3_sym(torch.from_numpy(cov))
    jv, jlam = jeig(jnp.asarray(cov))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jlam)).max())


@pytest.mark.parametrize("form", ["fused", "fused_degenerate", "gather",
                                  "bug_compat"])
def test_compute_hog_matches_jax(monkeypatch, form):
    """The three HOG forms against JAX's: the moment form (N = 256, kernels
    10 and 9's plain versions) against JAX's fused exact path, also on a
    cloud of 16 integer points (8 and their negations: the mean is 0 and
    every sum exact) each repeated 16 times, whose neighbourhoods are
    single points: the covariances are 0, the azimuths atan(0 / 0), and
    the zeroed votes leave all-zero histograms, not NaN; the gather form
    (N = 200, not a multiple of 128) and
    bug_compat against JAX's default path.  HOG truncates angles to whole
    degrees, so a rounding difference can move a vote to the next bin: at
    least 0.999 of the values within 1e-4, and all within (rtol 0.1, atol
    0.05), the JAX package's own tolerance for its two forms
    (tests/test_ops_hog.py)."""
    from dgcnn_tpu.ops.hog import compute_hog as jhog

    n = 200 if form == "gather" else 256
    x = _cloud(1 + n, n=n)
    if form == "fused_degenerate":
        base = np.random.default_rng(n).integers(-4, 5, (3, 8, 3))
        x = np.repeat(np.concatenate([base, -base], axis=1), 16,
                      axis=1).astype(np.float32)
    bug = form == "bug_compat"
    if form.startswith("fused"):
        monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
        monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    with jax.default_matmul_precision(F32):
        want = np.asarray(jhog.__wrapped__(jnp.asarray(x), 12,
                                           bug_compat=bug))
    got = compute_hog(torch.from_numpy(x), 12, bug_compat=bug).numpy()
    assert got.shape == want.shape == (3, n, 18)
    assert np.isfinite(got).all()
    if form == "fused_degenerate":
        assert not got.any() and not np.asarray(want).any()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.05)


def test_knn_sum_plain_matches_pallas(pallas_exact):
    """Kernel 10's plain version against fused_knn_sum in interpret mode
    (exact v1 selection): the same idx on a tie-free cloud, self first, and
    the moment sums within rel 1e-5 of each row's scale (the TPU sums
    through a 3-way bf16 split, the port in neighbour order)."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_sum

    x = _cloud(3)
    a = np.concatenate([x, x * x, x[..., [0, 0, 1]] * x[..., [1, 2, 2]]],
                       axis=-1)
    with jax.default_matmul_precision(F32):
        jidx, jsum = fused_knn_sum.__wrapped__(jnp.asarray(x),
                                               jnp.asarray(a), 10,
                                               interpret=True)
    idx, asum = knn_sum(torch.from_numpy(x), torch.from_numpy(a), 10)
    assert idx.dtype == torch.int32 and asum.shape == (3, 128, 9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[..., 0] == torch.arange(128)).all()
    jsum = np.asarray(jsum)
    scale = np.abs(jsum).max(-1, keepdims=True)
    assert (np.abs(asum.numpy() - jsum) <= 1e-5 * scale).all()


def test_edge_sum_plain_matches_pallas():
    """Kernel 9's plain version against edge_sum_reduce in interpret mode
    on indices with duplicates (each counts once): within rel 1e-5 of the
    row scale; and it is the neighbour-order sum of the gathered rows."""
    from dgcnn_tpu.ops.pallas_knn import edge_sum_reduce

    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 128, 18)).astype(np.float32)
    idx = rng.integers(0, 128, (3, 128, 10)).astype(np.int32)
    idx[:, :, 5] = idx[:, :, 2]
    with jax.default_matmul_precision(F32):
        want = np.asarray(edge_sum_reduce.__wrapped__(
            jnp.asarray(a), jnp.asarray(idx), 10, interpret=True))
    got = edge_sum(torch.from_numpy(a), torch.from_numpy(idx)).numpy()
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * scale).all()
    g = a[np.arange(3)[:, None, None], idx]                 # (3, 128, 10, 18)
    np.testing.assert_allclose(got, g.sum(2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("e,h", [(64, 2), (128, 1)])
def test_attention_matches_jax(e, h):
    """TorchMultiheadAttention (three in-projections, kernel 14's plain
    version, out_proj) against JAX's dense TorchMultiheadAttention at head
    dims 32 and 128, query and key lengths apart; at d = 128 the plain
    version also against JAX's fused_attention in interpret mode.  Rel
    1e-5 of the output's scale."""
    from dgcnn_tpu.models.torch_transformer import (
        TorchMultiheadAttention as FlaxMHA,
    )
    from dgcnn_tpu.ops.pallas_attention import fused_attention as jfused

    rng = np.random.default_rng(5 + e)
    q_in = rng.standard_normal((3, 128, e)).astype(np.float32)
    kv_in = rng.standard_normal((3, 256, e)).astype(np.float32)
    mha = TorchMultiheadAttention(e, h)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32)
                / np.sqrt(e)))
    params = {"in_proj_weight": mha.in_proj_weight.detach().numpy(),
              "in_proj_bias": mha.in_proj_bias.detach().numpy(),
              "out_proj": {"kernel": mha.out_proj.weight.detach().numpy().T,
                           "bias": mha.out_proj.bias.detach().numpy()}}
    with jax.default_matmul_precision(F32):
        want = np.asarray(FlaxMHA(e, h).apply(
            {"params": params}, jnp.asarray(q_in), jnp.asarray(kv_in),
            jnp.asarray(kv_in)))
    with torch.no_grad():
        got = mha(*(torch.from_numpy(t) for t in (q_in, kv_in, kv_in)))
    assert _rel(got, want) <= 1e-5
    if e // h == 128:
        q, k, v = (rng.standard_normal((3, h, n, 128)).astype(np.float32)
                   for n in (128, 256, 256))
        with jax.default_matmul_precision(F32):
            want = np.asarray(jfused(*(jnp.asarray(t) for t in (q, k, v)),
                                     sm_scale=128 ** -0.5, interpret=True))
        got = fused_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              128 ** -0.5)
        assert _rel(got, want) <= 1e-5
        np.testing.assert_allclose(
            attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                            128 ** -0.5).numpy(), got.numpy())


def test_torch_transformer_matches_flax():
    """TorchTransformer (2 + 2 post-norm layers, LeakyReLU(0.2) in the
    encoder and relu in the decoder) loads export_torch_transformer's
    layout strictly and matches flax within rel 1e-4."""
    from dgcnn_tpu.convert.torch_export import export_torch_transformer
    from dgcnn_tpu.convert.torch_import import convert_torch_transformer
    from dgcnn_tpu.models.torch_transformer import (
        TorchTransformer as FlaxTransformer,
    )

    model = TorchTransformer(64, 2, 2, 2, 32, "leaky_relu", "relu")
    init_like_flax_(model, torch.Generator().manual_seed(6))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape,
                                         generator=torch.Generator()
                                         .manual_seed(len(name))))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, _ = convert_torch_transformer(sd, "", 2, 2)
    export = export_torch_transformer(params, "", 2, 2)
    assert sorted(export) == sorted(sd)
    model.load_state_dict(_torch_sd(export), strict=True)
    rng = np.random.default_rng(7)
    src, tgt = (rng.standard_normal((3, 128, 64)).astype(np.float32)
                for _ in range(2))
    with jax.default_matmul_precision(F32):
        want = np.asarray(FlaxTransformer(
            64, 2, 2, 2, 32, 0.0, "leaky_relu", "relu").apply(
            {"params": jax.tree_util.tree_map(jnp.asarray, params)},
            jnp.asarray(src), jnp.asarray(tgt)))
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(tgt))
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("config", list(CONFIGS))
def test_net_logits_match_jax(pallas_exact, config):
    """The Net's eval logits against flax's on the same weights (the port's
    seeded ones through convert_net) at the bench config's heads and
    blocks (2, 2) and the CLI's default (1, 1): rel 1e-4 and the same
    per-point argmax; the eval forward stacks [src; tgt] through one
    transformer pass, as JAX does."""
    model = _port_net(8, **CONFIGS[config])
    fmodel, variables = _flax_net(model, **CONFIGS[config])
    x = _cloud(9)
    oh = np.eye(16, dtype=np.float32)[[2, 7, 15]]
    with jax.default_matmul_precision(F32):
        want = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                       jnp.asarray(oh), False))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(oh)).numpy()
    assert got.shape == want.shape == (3, 128, 50)
    assert _rel(got, want) <= 1e-4
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_net_checkpoints_load_strictly(tmp_path):
    """state_dict_from_flax equals export_net key for key but the
    PositionEmbedding's bn1-bn3 aliases; the export itself, aliases and
    all, and a torch-saved reference-style transformer.pt (DataParallel's
    module. prefix, under model_state_dict) strict-load through
    load_checkpoint; init_like_flax_ gives the flax initialization's
    LayerNorms and attention projections."""
    from dgcnn_tpu.convert.torch_export import (
        export_net,
        save_torch_checkpoint,
    )

    model = _port_net(10, **CONFIGS["bench"])
    _, variables = _flax_net(model, **CONFIGS["bench"])
    export = export_net(jax.tree_util.tree_map(np.asarray, variables), 2)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    aliases = sorted(k for k in export if k.startswith("pos_mlp.0.bn"))
    assert len(aliases) == 15
    assert sorted(sd) == sorted(k for k in export if k not in aliases)
    for key, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(export[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(v.numpy(),
                                      model.state_dict()[key].numpy())
    save_torch_checkpoint(str(tmp_path / "export.pt"),
                          {k: np.array(v) for k, v in export.items()})
    torch.save({"epoch": 3, "model_state_dict": {
        "module." + k: torch.tensor(np.array(v)) for k, v in export.items()}},
        tmp_path / "transformer.pt")
    x = torch.from_numpy(_cloud(11))
    oh = torch.eye(16)[[0, 4, 9]]
    with torch.no_grad():
        want = model(x, oh)
        for name in ("export.pt", "transformer.pt"):
            loaded = load_checkpoint(str(tmp_path / name),
                                     _port_net(99, **CONFIGS["bench"]))
            assert torch.equal(loaded(x, oh), want)
    fresh = init_like_flax_(_port_net(12, 1, 1),
                            torch.Generator().manual_seed(0))
    norm = fresh.transformer.encoder.layers[0].norm1
    assert (norm.weight == 1).all() and (norm.bias == 0).all()
    w = fresh.attention.in_proj_weight
    assert w.abs().max() <= (6 / (4 * 32)) ** 0.5
    assert (fresh.attention.in_proj_bias == 0).all()


NET_ARGS = ["--model=transformer", "--num_points=128", "--k=10",
            "--emb_dim=32", "--ff_dims=16", "--n_heads=2", "--n_blocks=2",
            "--test_batch_size=8", "--eval=True"]


def test_partseg_cli_evaluates_the_net_as_jax_cli(shapenet_dir, monkeypatch):
    """--model transformer --eval=True on the same exported transformer.pt,
    given under outputs/<exp>/ as the reference resolves --model_path: the
    port's ``Test:`` line equals the JAX CLI's in its exact mode."""
    from dgcnn_tpu.cli import partseg as jpartseg
    from dgcnn_tpu.convert.torch_export import (
        export_net,
        save_torch_checkpoint,
    )

    from dgcnn_tpu_torch.cli import partseg

    model = _port_net(13, **CONFIGS["bench"])
    _, variables = _flax_net(model, **CONFIGS["bench"])
    export = export_net(jax.tree_util.tree_map(np.asarray, variables), 2)
    for exp in ("jax", "port"):
        os.makedirs(f"outputs/{exp}/models")
        save_torch_checkpoint(f"outputs/{exp}/models/transformer.pt",
                              {k: np.array(v) for k, v in export.items()})
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    with jax.default_matmul_precision(F32):
        jpartseg.main(["--exp_name=jax"] + NET_ARGS)
    partseg.main(["--exp_name=port", "--no_cuda=True"] + NET_ARGS)
    want = [ln for ln in _log_lines("jax") if ln.startswith("Test:")]
    got = [ln for ln in _log_lines("port") if ln.startswith("Test:")]
    assert len(want) == 1 and got == want


@pytest.mark.parametrize("flag,message", [
    # training the Net parses; --device_pipeline with it is refused
    pytest.param("--eval=False", "--device_pipeline is not ported yet",
                 id="--eval=False-training the fusion Net"),
    # the custom attention and a band with the Net parse and run (they
    # were refused before they were ported; the ids are kept)
    pytest.param("--use_custom_attention", None,
                 id="--use_custom_attention---use_custom_attention is not "
                    "ported yet"),
    pytest.param("--fast_extract=128", None,
                 id="--fast_extract=128-with --model transformer is not "
                    "ported yet"),
])
def test_partseg_cli_refuses_what_of_the_net_is_not_ported(capsys, flag,
                                                           message):
    """The parser lets the Net train (--eval=False), but not with
    --device_pipeline, which it refuses with a message; the custom
    attention and a --fast_extract band with the Net parse and reach the
    model the CLI builds (the custom Transformer; the band), whose eval
    forward runs on the CPU at a small size (N = 256, band 128: the banded
    plain versions); --fast_extract=0 (exact) passes."""
    from dgcnn_tpu_torch.cli import partseg
    from dgcnn_tpu_torch.models.transformer import Transformer

    parse = partseg.build_parser().parse_args
    if flag == "--eval=False":
        ns = parse(["--model=transformer", flag])
        assert ns.model == "transformer" and not ns.eval
        with pytest.raises(SystemExit):
            parse(["--model=transformer", "--eval=True",
                   "--device_pipeline=True"])
        assert message in capsys.readouterr().err
    else:
        ns = parse(["--model=transformer", "--eval=True", "--emb_dim=32",
                    "--ff_dims=16", "--d_qkv=8", "--k=10",
                    "--num_points=256", flag])
        model = partseg.build_model(ns, "cpu")
        custom = flag == "--use_custom_attention"
        assert isinstance(model.transformer, Transformer) == custom
        assert model.band == (0 if custom else 128)
        x = torch.from_numpy(_cloud(17, b=2, n=256))
        oh = torch.eye(16)[[2, 7]]
        with torch.no_grad():
            out = model(x, oh)
        assert out.shape == (2, 256, 50) and torch.isfinite(out).all()
    assert parse(["--eval=True", "--fast_extract=0"]).model == "transformer"


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_hog_kernels_match_plain(cuda_device):
    """Kernel 10 at the HOG shape (N=2048, k=32): the plain version's
    neighbour sets and sums within rel 1e-5 of the row scale; kernel 9
    bit-equal to its plain version; integer duplicate points exact."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn((4, 2048, 3), generator=g).to(cuda_device)
    a = torch.randn((4, 2048, 9), generator=g).to(cuda_device)
    before = (knn_sum.launches, edge_sum.launches)
    idx, asum = knn_sum(x, a, 32)
    pidx, psum = knn_sum_plain(x, a, 32)
    same = (idx.sort(-1).values == pidx.sort(-1).values).all(-1)
    assert same.float().mean().item() >= 0.999
    scale = psum.abs().amax(-1, keepdim=True)
    assert ((asum - psum).abs() <= 1e-5 * scale)[same].all()
    v = torch.randn((4, 2048, 18), generator=g).to(cuda_device)
    assert torch.equal(edge_sum(v, idx), edge_sum_plain(v, idx))
    assert (knn_sum.launches, edge_sum.launches) == (before[0] + 1,
                                                     before[1] + 1)
    base = torch.randint(-4, 5, (2, 64, 3), generator=g).float()
    dup = torch.cat([base] * 4, dim=1).to(cuda_device)
    da = torch.randint(-3, 4, (2, 256, 9), generator=g).float().to(
        cuda_device)
    got, want = knn_sum(dup, da, 12), knn_sum_plain(dup, da, 12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,d", [(4, 2, 256), (2, 1, 512), (2, 4, 128)])
def test_fused_attention_kernel_matches_plain(cuda_device, b, h, d):
    """Kernel 14 against its plain version at N=2048 (and a ragged 300
    queries over 200 keys, the heads of (B, N, h * d) projections as
    TorchMultiheadAttention passes them, and rows that do not start 16-byte
    aligned, which the wrapper copies): rel 1e-5 of each row's norm."""
    g = torch.Generator().manual_seed(d)

    def make(n, layout):
        if layout == "heads":
            return torch.randn((b, n, h * d), generator=g).to(
                cuda_device).reshape(b, n, h, d).transpose(1, 2)
        pad = int(layout == "unaligned")
        return torch.randn((b, h, n, d + pad), generator=g).to(
            cuda_device)[..., pad:]

    for nq, nk, layout in [(2048, 2048, "contiguous"), (300, 200, "heads"),
                           (300, 300, "unaligned")]:
        q = make(nq, layout)
        k, v = make(nk, layout), make(nk, layout)
        got = fused_attention(q, k, v, d ** -0.5)
        want = attention_plain(q, k, v, d ** -0.5)
        err = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert err.max().item() <= 1e-5


@pytest.mark.cuda
def test_net_kernel_path_matches_plain_path():
    """The Net at the bench config's width on the card: launches 1 / 1 / 7
    / 4 / 1 / 1 of kernels 10 / 9 / 14 / 1 / 6 / 2 per forward and the CPU
    plain path's per-point predictions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dgcnn_tpu_torch.ops import conv_pool, edge_conv_eval, knn_edge2

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = init_like_flax_(Net(emb_dim=512, k=32, n_heads=2, n_blocks=2,
                              device="cpu"),
                          torch.Generator().manual_seed(1))
    dev = copy.deepcopy(cpu).to("cuda")
    x = torch.from_numpy(_cloud(15, b=2, n=2048))
    oh = torch.eye(16)[[3, 8]]
    counted = (knn_sum, edge_sum, fused_attention, edge_conv_eval, knn_edge2,
               conv_pool)
    for f in counted:
        f.launches = 0
    with torch.no_grad():
        got = dev(x.cuda(), oh.cuda()).cpu()
        want = cpu(x, oh)
    assert [f.launches for f in counted] == [1, 1, 7, 4, 1, 1]
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.995
