"""Parity of the PyTorch port's DGCNNSemSeg slice with the JAX package's,
on the CPU at small sizes: the model and its checkpoint layout, two SGD
steps, the IoU and segmentation losses, the S3DIS data and loader, and the
semseg CLI.

Both sides start from the same flax variables (carried over with
``state_dict_from_flax``) and take the same numpy blocks.  The JAX side
runs its fused exact path (``DGCNN_TPU_PALLAS=1``,
``DGCNN_TPU_PALLAS_EXACT=1``: the Pallas kernels in interpret mode) under
``jax.default_matmul_precision("float32")``; the port's kernels run their
plain versions because the tensors lie on the CPU.
"""
import copy
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNSemSeg, init_like_flax_
from dgcnn_tpu_torch.train import (
    calculate_sem_IoU,
    cross_entropy_per_example,
    make_optimizer,
    make_schedule,
    make_seg_steps,
    masked_mean_loss,
)

from test_torch_port_model import randomize_flax
from test_torch_port_train import _assert_state_close

F32 = "float32"


@pytest.fixture
def pallas_exact(monkeypatch):
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")


def _blocks(seed, b=2, n=128):
    rng = np.random.default_rng(seed)
    return (rng.random((b, n, 9)).astype(np.float32),
            rng.integers(0, 13, (b, n)).astype(np.int64))


def flax_semseg_variables(emb_dims=32, k=6, n=128, seed=0, randomize=True):
    from dgcnn_tpu.models import DGCNNSemSeg as FlaxDGCNNSemSeg

    model = FlaxDGCNNSemSeg(emb_dims=emb_dims, k=k, dropout=0.0)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, n, 9), jnp.float32), train=False)
    return model, (randomize_flax(variables, seed) if randomize
                   else variables)


def test_dgcnn_semseg_state_dict_and_logits_match_jax(pallas_exact):
    """state_dict_from_flax equals export_dgcnn_semseg key for key, loads
    strictly, and the eval logits (the two-conv blocks through knn_edge2's
    plain version) match the JAX fused exact path; so does the masked
    eval loss of make_seg_steps."""
    from dgcnn_tpu.convert.torch_export import export_dgcnn_semseg
    from dgcnn_tpu.train.loss import (
        cross_entropy_per_example as jce,
        masked_mean_loss as jmasked,
    )

    fmodel, variables = flax_semseg_variables(seed=5)
    sd = state_dict_from_flax(variables)
    want_sd = export_dgcnn_semseg(variables)
    assert sorted(sd) == sorted(want_sd)
    for key, v in want_sd.items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(v),
                                      err_msg=key)
    model = DGCNNSemSeg(emb_dims=32, k=6, device="cpu")
    model.load_state_dict(sd, strict=True)
    x, seg = _blocks(6)
    with jax.default_matmul_precision(F32):
        want = np.asarray(fmodel.apply(variables, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 128, 13)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    mask = np.array([True, False])
    _, eval_step = make_seg_steps()
    m = eval_step(model, torch.from_numpy(x), torch.from_numpy(seg),
                  torch.from_numpy(mask))
    want_loss = float(jmasked(jce(jnp.asarray(want), jnp.asarray(seg)),
                              jnp.asarray(mask)))
    assert m["loss"].item() == pytest.approx(want_loss, rel=1e-5)
    assert torch.equal(m["preds"], torch.from_numpy(want.argmax(-1)))


def _record_knn_gaps(monkeypatch, k: int):
    """Wraps the port's knn_edge_reduce (the neighbour selection of every
    training stage) to record, per call, the smallest gap between any
    point's k-th and (k+1)-th neighbour score over the scale of the scores
    (f32 rounds them at ~1e-7 of it)."""
    from dgcnn_tpu_torch.models import dgcnn, nn_layers

    gaps = []
    inner = dgcnn.knn_edge_reduce

    def recording(graph, a, kk):
        g = graph.detach()
        sq = (g * g).sum(-1)
        top = (2 * torch.bmm(g, g.transpose(1, 2)) - sq[:, :, None]
               - sq[:, None, :]).topk(k + 1, dim=-1).values
        scale = sq + sq.amax(-1, keepdim=True)
        gaps.append(((top[..., k - 1] - top[..., k]) / scale).min().item())
        return inner(graph, a, kk)

    monkeypatch.setattr(dgcnn, "knn_edge_reduce", recording)
    monkeypatch.setattr(nn_layers, "knn_edge_reduce", recording)
    return gaps


def test_dgcnn_semseg_two_sgd_steps_match_jax(pallas_exact, monkeypatch):
    """Two steps of the JAX package's make_seg_steps / make_optimizer /
    make_schedule (cos, SGD) on its fused exact training path (kernels 3,
    5, 7, 8 in interpret mode) against two port steps (their plain
    versions) from one flax init and the same blocks, dropout 0: losses,
    parameters and running statistics.  The blocks keep every stage's
    k-th and (k+1)-th neighbours apart by over 1e-6 of the score scale: a
    near tie that rounding flips moves a gradient by up to 1e-2 in either
    framework (ROADMAP.md section C)."""
    from dgcnn_tpu.train import (
        TrainState,
        make_optimizer as jopt,
        make_schedule as jsched,
        make_seg_steps as jsteps,
    )

    fmodel, variables = flax_semseg_variables(randomize=False)
    batches = [_blocks(60), _blocks(61)]
    state = TrainState.create(
        apply_fn=fmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jopt(use_sgd=True, schedule=jsched("cos", 0.001, epochs=2,
                                              steps_per_epoch=1,
                                              use_sgd=True), momentum=0.9))
    jtrain, _ = jsteps(fmodel, with_label=False)
    want_losses = []
    with jax.default_matmul_precision(F32):
        for points, seg in batches:
            state, m = jtrain(state, jnp.asarray(points), jnp.asarray(seg),
                              jax.random.PRNGKey(1))
            want_losses.append(float(m["loss"]))

    model = DGCNNSemSeg(emb_dims=32, k=6, dropout=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    gaps = _record_knn_gaps(monkeypatch, 6)
    opt = make_optimizer(model.parameters(), use_sgd=True,
                         schedule=make_schedule("cos", 0.001, epochs=2,
                                                steps_per_epoch=1))
    train_step, _ = make_seg_steps()
    losses = [train_step(model, opt, torch.from_numpy(p),
                         torch.from_numpy(s))["loss"].item()
              for p, s in batches]
    assert len(gaps) == 6 and min(gaps) > 1e-6, gaps
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_state_close(model.state_dict(), state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}))


def test_sem_iou_and_seg_losses_match_jax():
    """calculate_sem_IoU (a class absent from predictions and labels is
    nan), the per-block cross entropy and its masked mean."""
    from dgcnn_tpu.train import loss as jloss
    from dgcnn_tpu.train import metrics as jmetrics

    rng = np.random.default_rng(70)
    seg = rng.integers(0, 12, (3, 64))          # class 12 never occurs
    pred = np.where(rng.random((3, 64)) < 0.5, seg, rng.integers(0, 12,
                                                                 (3, 64)))
    for visual in (False, True):
        got = calculate_sem_IoU(pred, seg, visual=visual)
        want = jmetrics.calculate_sem_IoU(pred, seg, visual=visual)
        np.testing.assert_array_equal(got, want)
    assert np.isnan(calculate_sem_IoU(pred, seg)[12])
    logits = rng.standard_normal((3, 64, 13)).astype(np.float32)
    mask = np.array([True, False, True])
    for smoothing in (True, False):
        per = cross_entropy_per_example(torch.from_numpy(logits),
                                        torch.from_numpy(seg), smoothing)
        want = jloss.cross_entropy_per_example(
            jnp.asarray(logits), jnp.asarray(seg), smoothing)
        np.testing.assert_allclose(per.numpy(), np.asarray(want), rtol=1e-6)
        for m in (mask, None):
            got = masked_mean_loss(per, None if m is None
                                   else torch.from_numpy(m)).item()
            assert got == pytest.approx(float(jloss.masked_mean_loss(
                want, None if m is None else jnp.asarray(m))), rel=1e-6)


@pytest.fixture
def s3dis_dir(tmp_path, monkeypatch):
    """The JAX package's synthetic S3DIS h5 fixture (six areas, one room
    of two 128-point blocks each)."""
    from dgcnn_tpu.data import synthetic

    root = tmp_path / "data"
    synthetic.make_s3dis(str(root), blocks_per_room=2, rooms_per_area=1,
                         num_points=128, seed=5)
    monkeypatch.setenv("DGCNN_TPU_DATA", str(root))
    monkeypatch.setenv("DGCNN_TPU_NO_DOWNLOAD", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_s3dis_arrays_and_loader_batches_match_jax(s3dis_dir):
    """make_s3dis holds the arrays of the JAX fixture for the same seed;
    the port's reader splits them as the JAX loader does; and for the same
    seed and epoch the two loaders give the same batches bit for bit (the
    train partition's point shuffle, the test partition's padding)."""
    from dgcnn_tpu.data import S3DIS as JaxS3DIS
    from dgcnn_tpu.data import load_data_semseg as jload
    from dgcnn_tpu.data import make_loader as jax_loader

    from dgcnn_tpu_torch.data import S3DIS, load_data_semseg, make_loader
    from dgcnn_tpu_torch.data import split_semseg
    from dgcnn_tpu_torch.data.synthetic import make_s3dis

    mem = make_s3dis(blocks_per_room=2, rooms_per_area=1, num_points=128,
                     seed=5)
    for part in ("train", "test"):
        want = jload(part, "2")
        for got in (load_data_semseg(part, "2"),
                    split_semseg(*mem[part], part, "2")):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    for part, kw in [("train", dict(shuffle=True, drop_last=True)),
                     ("test", dict(shuffle=True))]:
        jds = JaxS3DIS(64, part, "2", seed=3)
        ds = S3DIS(64, part, "2")
        jl = jax_loader(jds, ["points", "seg"], 3, seed=3, **kw)
        pl = make_loader(ds, ["points", "seg"], 3, seed=3, **kw)
        assert len(pl) == len(jl)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            pairs = list(zip(jl, pl, strict=True))
            assert pairs
            for jb, pb in pairs:
                assert sorted(pb) == sorted(jb)
                for key in jb:
                    assert pb[key].dtype == jb[key].dtype, key
                    np.testing.assert_array_equal(pb[key], jb[key])


SIZE = ["--num_points=128", "--k=6", "--emb_dims=32", "--test_batch_size=3"]


def _log_lines(exp: str) -> list[str]:
    with open(os.path.join("outputs", exp, "run.log")) as f:
        return f.read().splitlines()


def test_semseg_cli_eval_lines_match_jax_cli(s3dis_dir):
    """--eval=True --test_area=all on the same exported weights: the six
    ``Test :: test area`` lines and the ``Overall Test`` line of the port
    equal the JAX CLI's."""
    from dgcnn_tpu.cli import semseg as jsemseg
    from dgcnn_tpu.convert.torch_export import (
        export_dgcnn_semseg,
        save_torch_checkpoint,
    )
    from dgcnn_tpu_torch.cli import semseg

    _, variables = flax_semseg_variables(seed=7)
    os.makedirs("weights")
    for area in range(1, 7):
        save_torch_checkpoint(f"weights/model_{area}.t7",
                              {k: np.array(v) for k, v in
                               export_dgcnn_semseg(variables).items()})
    args = ["--eval=True", "--test_area=all", "--model_root=weights"] + SIZE
    with jax.default_matmul_precision(F32):
        jsemseg.main(["--exp_name=jax"] + args)
    semseg.main(["--exp_name=port", "--no_cuda=True"] + args)
    want = [ln for ln in _log_lines("jax") if "Test ::" in ln]
    got = [ln for ln in _log_lines("port") if "Test ::" in ln]
    assert len(want) == 7 and want[-1].startswith("Overall Test :: ")
    assert got == want


# the JAX CLI's per-epoch lines (dgcnn_tpu/cli/semseg.py train)
TRAIN_LINE = re.compile(
    r"Train 0, loss: -?\d+\.\d{6}, train acc: \d\.\d{6}, "
    r"train avg acc: \d\.\d{6}, train iou: \d\.\d{6}")
TEST_LINE = re.compile(
    r"Test 0, loss: -?\d+\.\d{6}, test acc: (\d\.\d{6}), "
    r"test avg acc: (\d\.\d{6}), test iou: (\d\.\d{6})")


def test_semseg_cli_trains_and_reloads(s3dis_dir):
    """Training writes the JAX CLI's line formats and model_6.t7, which
    the CLI's evaluation reloads to the same test line."""
    from dgcnn_tpu_torch.cli import semseg

    semseg.main(["--exp_name=tr", "--epochs=1", "--batch_size=2",
                 "--dropout=0.5", "--test_area=6", "--no_cuda=True"] + SIZE)
    lines = _log_lines("tr")
    train = [ln for ln in lines if ln.startswith("Train 0")]
    test = [ln for ln in lines if ln.startswith("Test 0")]
    assert len(train) == 1 and TRAIN_LINE.fullmatch(train[0]), lines
    assert len(test) == 1 and TEST_LINE.fullmatch(test[0]), lines
    assert os.path.exists("outputs/tr/models/model_6.t7")
    semseg.main(["--exp_name=ev", "--eval=True", "--test_area=6",
                 "--model_root=outputs/tr/models", "--no_cuda=True"] + SIZE)
    acc, avg, iou = TEST_LINE.fullmatch(test[0]).groups()
    assert _log_lines("ev")[-1] == (
        f"Test :: test area: 6, test acc: {acc}, test avg acc: {avg}, "
        f"test iou: {iou}")


@pytest.mark.parametrize("flag", ["--point_shard=True",
                                  "--device_pipeline=True",
                                  "--fast_extract=1000",
                                  "--export_model=a.stablehlo",
                                  "--visu=all"])
def test_semseg_cli_refuses_what_is_not_ported(s3dis_dir, flag):
    """The JAX CLI's point sharding, device pipeline, export and
    visualization flags are not flags of the port: argparse refuses each
    by name; --fast_extract refuses a band that is not a multiple of
    128."""
    from dgcnn_tpu_torch.cli import semseg

    with pytest.raises(SystemExit):
        semseg.main(["--exp_name=t", "--eval=True", "--test_area=6",
                     "--no_cuda=True", flag])


def test_semseg_cli_needs_an_area_and_a_device(s3dis_dir, monkeypatch):
    from dgcnn_tpu_torch.cli import semseg

    with pytest.raises(ValueError, match="test_area"):
        semseg.main(["--exp_name=t", "--eval=True", "--no_cuda=True"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no_cuda"):
        semseg.main(["--exp_name=t", "--test_area=6"] + SIZE)


@pytest.mark.cuda
def test_dgcnn_semseg_kernel_path_matches_plain_path():
    """Full-width DGCNNSemSeg on the card: 2 / 1 / 1 launches per forward
    and the CPU plain path's per-point predictions; one SGD step launches
    3 / 2 / 2 / 3 and gives the CPU plain path's loss and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dgcnn_tpu_torch.ops import (
        conv_pool,
        edge2_bwd,
        edge2_fwd,
        edge_conv_eval,
        edge_reduce_bwd,
        knn_edge2,
        knn_reduce,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = init_like_flax_(DGCNNSemSeg(emb_dims=1024, k=20, dropout=0.0,
                                      device="cpu"),
                          torch.Generator().manual_seed(1))
    dev = copy.deepcopy(cpu).to("cuda")
    x, seg = (torch.from_numpy(a) for a in _blocks(62, b=2, n=4096))
    knn_edge2.launches = edge_conv_eval.launches = conv_pool.launches = 0
    with torch.no_grad():
        got = dev(x.cuda()).cpu()
        want = cpu(x)
    assert (knn_edge2.launches, edge_conv_eval.launches,
            conv_pool.launches) == (2, 1, 1)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.995
    train_step, _ = make_seg_steps()
    sched = make_schedule("cos", 0.001, epochs=100, steps_per_epoch=1)
    knn_reduce.launches = edge2_fwd.launches = edge2_bwd.launches = 0
    edge_reduce_bwd.launches = 0
    got = train_step(dev, make_optimizer(dev.parameters(), use_sgd=True,
                                         schedule=sched),
                     x.cuda(), seg.cuda())["loss"].item()
    assert (knn_reduce.launches, edge2_fwd.launches, edge2_bwd.launches,
            edge_reduce_bwd.launches) == (3, 2, 2, 3)
    want = train_step(cpu, make_optimizer(cpu.parameters(), use_sgd=True,
                                          schedule=sched), x, seg)["loss"]
    assert got == pytest.approx(want.item(), rel=1e-4)
    g_dev, g_cpu = (torch.cat([p.grad.reshape(-1).double().cpu()
                               for p in m.parameters()]) for m in (dev, cpu))
    assert torch.isfinite(g_dev).all()
    assert (g_dev @ g_cpu / (g_dev.norm() * g_cpu.norm())).item() >= 0.999
