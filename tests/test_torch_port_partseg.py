"""Parity of the PyTorch port's DGCNNPartSeg slice with the JAX package's,
on the CPU at small sizes: TransformNet and the model with their
checkpoint layout, two training steps under the cycle scheduler (SGD and
AdamW), the optimizer's momentum cycling and gradient accumulation, the
schedules, the shape IoU, the ShapeNetPart data and loaders, the partseg
CLI and the ``--fast_extract`` flags.

Both sides start from the same flax variables (carried over with
``state_dict_from_flax``) and take the same numpy clouds.  The JAX side
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

from dgcnn_tpu_torch.convert import load_checkpoint, state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNPartSeg, TransformNet
from dgcnn_tpu_torch.train import (
    calculate_shape_IoU,
    make_momentum_schedule,
    make_optimizer,
    make_schedule,
    make_seg_steps,
    one_cycle,
    one_cycle_momentum,
)

from test_torch_port_model import randomize_flax
from test_torch_port_train import _assert_state_close

F32 = "float32"
ALIAS = re.compile(r"transform_net\.bn\d\.")


@pytest.fixture
def pallas_exact(monkeypatch):
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")


def _clouds(seed, b=2, n=128):
    """Points, the category one-hot and part labels of b clouds."""
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, 16, b)
    one_hot = np.eye(16, dtype=np.float32)[cats]
    return (rng.standard_normal((b, n, 3)).astype(np.float32), one_hot,
            rng.integers(0, 50, (b, n)).astype(np.int64))


def flax_partseg_variables(emb_dims=32, k=6, n=128, seed=0, randomize=True):
    from dgcnn_tpu.models import DGCNNPartSeg as FlaxDGCNNPartSeg

    model = FlaxDGCNNPartSeg(emb_dims=emb_dims, k=k, dropout=0.0)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, n, 3), jnp.float32),
                           jnp.zeros((2, 16), jnp.float32), train=False)
    return model, (randomize_flax(variables, seed) if randomize
                   else variables)


def _torch_sd(sd: dict) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("train", [False, True])
def test_transform_net_matches_jax(pallas_exact, train):
    """TransformNet from the points: export_transform_net's layout without
    its bn1-bn3 aliases loads strictly; the 3x3 (eval: one knn_edge2 over
    the points; training: kNN, the materialised edge tensor, BatchNorm
    over B*N*k) and the running statistics after a training forward match
    flax's.  Eight clouds: the BatchNorms of linear.1 and linear.4
    normalize over the batch, and over two clouds their near-zero
    variances amplify f32 rounding past rel 1e-4 in either framework."""
    from dgcnn_tpu.convert.torch_export import export_transform_net
    from dgcnn_tpu.models import TransformNet as FlaxTransformNet

    x = _clouds(1, b=8)[0]
    fmodel = FlaxTransformNet()
    variables = randomize_flax(fmodel.init(
        jax.random.PRNGKey(0), None, False, x=jnp.asarray(x), k=6), 2)
    export = export_transform_net(variables["params"],
                                  variables["batch_stats"])
    sd = {k: v for k, v in _torch_sd(export).items()
          if not re.match(r"bn\d\.", k)}
    assert len(sd) == len(export) - 15
    model = TransformNet()
    model.load_state_dict(sd, strict=True)
    with jax.default_matmul_precision(F32):
        if train:
            want, upd = fmodel.apply(variables, None, True, x=jnp.asarray(x),
                                     k=6, mutable=["batch_stats"])
        else:
            want = fmodel.apply(variables, None, False, x=jnp.asarray(x), k=6)
    got = model(torch.from_numpy(x), 6, train=train)
    want = np.asarray(want)
    assert got.shape == (8, 3, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    if train:
        after = {k: v for k, v in _torch_sd(export_transform_net(
            variables["params"], upd["batch_stats"])).items()
            if not re.match(r"bn\d\.", k)}
        _assert_state_close(model.state_dict(), after)


def test_dgcnn_partseg_state_dict_and_logits_match_jax(pallas_exact,
                                                       tmp_path):
    """state_dict_from_flax equals export_dgcnn_partseg key for key but the
    TransformNet's bn1-bn3 aliases, loads strictly, and so does the export
    itself, aliases and all, through load_checkpoint; the eval logits
    match the JAX fused exact path."""
    from dgcnn_tpu.convert.torch_export import (
        export_dgcnn_partseg,
        save_torch_checkpoint,
    )

    fmodel, variables = flax_partseg_variables(seed=5)
    sd = state_dict_from_flax(variables)
    want_sd = export_dgcnn_partseg(variables)
    aliases = sorted(k for k in want_sd if ALIAS.match(k))
    assert len(aliases) == 15
    assert sorted(sd) == sorted(k for k in want_sd if k not in aliases)
    for key, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_sd[key]),
                                      err_msg=key)
    model = DGCNNPartSeg(emb_dims=32, k=6, device="cpu")
    model.load_state_dict(sd, strict=True)
    path = str(tmp_path / "partseg.t7")
    save_torch_checkpoint(path, {k: np.array(v) for k, v in want_sd.items()})
    reloaded = load_checkpoint(path, DGCNNPartSeg(emb_dims=32, k=6,
                                                  device="cpu"))
    x, one_hot, seg = _clouds(6)
    with jax.default_matmul_precision(F32):
        want = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                       jnp.asarray(one_hot)))
    got = model(torch.from_numpy(x), torch.from_numpy(one_hot))
    assert got.shape == (2, 128, 50)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert torch.equal(reloaded(torch.from_numpy(x),
                                torch.from_numpy(one_hot)), got)
    _, eval_step = make_seg_steps(with_label=True)
    m = eval_step(model, torch.from_numpy(x), torch.from_numpy(one_hot),
                  torch.from_numpy(seg))
    assert torch.equal(m["preds"], torch.from_numpy(want.argmax(-1)))


def test_load_checkpoint_reads_reference_partseg_files(tmp_path):
    """A reference training checkpoint ({"model_state_dict": ...} with
    DataParallel's prefix and upstream's bnI aliases of every convI.1,
    TransformNet's too) loads strictly."""
    model = DGCNNPartSeg(emb_dims=32, k=6, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    sd = {"module." + k: v.clone() for k, v in model.state_dict().items()}
    for key in list(sd):
        m = re.fullmatch(r"module\.((?:transform_net\.)?)conv(\d+)\.1\.(.+)",
                         key)
        if m:
            sd[f"module.{m.group(1)}bn{m.group(2)}.{m.group(3)}"] = sd[key]
    path = str(tmp_path / "ref.t7")
    torch.save({"epoch": 3, "model_state_dict": sd}, path)
    got = load_checkpoint(path, DGCNNPartSeg(emb_dims=32, k=6, device="cpu"))
    for key, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[key], v), key


def _record_knn_gaps(monkeypatch, k: int):
    """Wraps every neighbour selection of a training forward (the
    TransformNet's knn and each stage's knn_edge_reduce) to record, per
    call, the smallest gap between any point's k-th and (k+1)-th
    neighbour score over the scale of the scores."""
    from dgcnn_tpu_torch.models import dgcnn, nn_layers
    from dgcnn_tpu_torch.ops import graph as graph_mod

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

    monkeypatch.setattr(dgcnn, "knn_edge_reduce", wrap(dgcnn.knn_edge_reduce))
    monkeypatch.setattr(nn_layers, "knn_edge_reduce",
                        wrap(nn_layers.knn_edge_reduce))
    monkeypatch.setattr(graph_mod, "knn", wrap(graph_mod.knn))
    return gaps


@pytest.mark.parametrize("use_sgd", [True, False])
def test_dgcnn_partseg_two_cycle_steps_match_jax(pallas_exact, monkeypatch,
                                                 use_sgd):
    """Two steps of the JAX package's partseg optimizer (SGD, or AdamW with
    its decoupled decay, the lr and momentum/beta1 cycled by --scheduler
    cycle, as cli/partseg.py builds it) and make_seg_steps on its fused
    exact training path against two port steps, dropout 0, from flax's
    init and the same clouds: losses, parameters and running statistics
    within rel 1e-4.  Every stage of both batches keeps its k-th and
    (k+1)-th neighbours apart by over 1e-6 of the score scale; eight clouds
    a batch keep the TransformNet's batch BatchNorms well conditioned.

    SGD holds every value to rel 1e-4.  AdamW's per-element normalization
    divides each gradient by its own magnitude, so a value whose gradient
    is small moves a whole learning rate on that gradient's f32 rounding,
    or on a near tie of a max over neighbours that the two frameworks
    break apart, and a value's update error is its gradient's relative
    error times the learning rate.  Under AdamW each tensor's update over
    the values whose gradients at both steps reach 1e-4 of the model's
    largest is held within 1e-2 of its norm, and the other values to
    AdamW's bound, three learning rates a step (the SGD case holds the
    gradients, test_optimizer_cycling_and_accumulation_match_optax
    AdamW's arithmetic).  Flax's init zeroes the 3x3 layer, so the
    TransformNet trunk's gradients are 0 at the first step and ~1e-5 of
    the others at the second; conv6's BatchNorm bias has a gradient of 0
    but for rounding (conv8's training BatchNorm removes every per-channel
    shift of the global feature)."""
    from dgcnn_tpu.train import (
        TrainState,
        make_optimizer as jopt,
        make_schedule as jsched,
        make_seg_steps as jsteps,
    )
    from dgcnn_tpu.train.schedules import (
        make_momentum_schedule as jmomentum,
    )

    fmodel, variables = flax_partseg_variables(randomize=False)
    batches = [_clouds(92, b=8), _clouds(93, b=8)]
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
            states.append(state_dict_from_flax(
                {"params": state.params, "batch_stats": state.batch_stats}))

    model = DGCNNPartSeg(emb_dims=32, k=6, dropout=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    gaps = _record_knn_gaps(monkeypatch, 6)
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
    for step, (b, want) in enumerate(zip(batches, states)):
        losses.append(train_step(model, opt, *map(torch.from_numpy, b))[
            "loss"].item())
        top = max(p.grad.abs().max() for p in params.values())
        if not use_sgd:
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
            assert ((g - w)[~t].norm() <= 1e-2 * upd.norm()), name
            assert ((g[t] - w[t]).abs() <= bound).all(), name
    assert len(gaps) == 8 and min(gaps) > 1e-6, gaps
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)


@pytest.mark.parametrize("use_sgd,adamw,accum", [(True, False, 1),
                                                 (False, True, 1),
                                                 (False, False, 1),
                                                 (True, False, 3),
                                                 (False, True, 2)])
def test_optimizer_cycling_and_accumulation_match_optax(use_sgd, adamw,
                                                        accum):
    """The optimizer alone on fixed gradients, six micro-steps: SGD's
    momentum, AdamW's and Adam's beta1 cycled with the learning rate, and
    gradient accumulation (optax.MultiSteps: the mean of ``accum``
    micro-batch gradients, one update, the schedules advanced once per
    update)."""
    import optax

    from dgcnn_tpu.train import make_optimizer as jopt
    from dgcnn_tpu.train.schedules import (
        make_momentum_schedule as jmomentum,
        make_schedule as jsched,
    )

    rng = np.random.default_rng(72)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32)
             for _ in range(6)]
    kw = dict(epochs=2, steps_per_epoch=3)
    tx = jopt(use_sgd=use_sgd, schedule=jsched("cycle", 0.01,
                                               use_sgd=use_sgd, **kw),
              momentum=0.9, adamw=adamw, grad_accum=accum,
              momentum_schedule=jmomentum("cycle", **kw))
    params = {"w": jnp.asarray(p0)}
    st = tx.init(params)
    want = []
    for g in grads:
        upd, st = tx.update({"w": jnp.asarray(g)}, st, params)
        params = optax.apply_updates(params, upd)
        want.append(np.asarray(params["w"]))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([w], use_sgd=use_sgd,
                         schedule=make_schedule("cycle", 0.01,
                                                use_sgd=use_sgd, **kw),
                         adamw=adamw, grad_accum=accum,
                         momentum_schedule=make_momentum_schedule(
                             "cycle", **kw))
    for g, wv in zip(grads, want):
        opt.zero_grad()
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), wv, rtol=1e-5,
                                   atol=1e-6)
    assert opt.step_count == 6 // accum


@pytest.mark.parametrize("total", [7, 10, 40])
def test_one_cycle_schedules_match_jax_and_torch(total):
    """one_cycle and one_cycle_momentum at every step of a short schedule:
    within rel 1e-6 of the JAX package's, relative to the peak (JAX
    evaluates them in f32, whose rounding at 0.1 is ~1e-8), and the values
    of torch's own OneCycleLR within rel 1e-9."""
    from dgcnn_tpu.train.schedules import one_cycle as jcycle
    from dgcnn_tpu.train.schedules import one_cycle_momentum as jmom

    lr, jlr = one_cycle(0.1, total), jcycle(0.1, total)
    mom, jm = one_cycle_momentum(total), jmom(total)
    w = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)
    ref = torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=0.1,
                                              total_steps=total)
    for step in range(total):
        group = opt.param_groups[0]
        assert lr(step) == pytest.approx(group["lr"], rel=1e-9)
        assert mom(step) == pytest.approx(group["momentum"], rel=1e-9)
        opt.step()
        ref.step()
    for step in range(total + 2):
        assert abs(lr(step) - float(jlr(step))) <= 1e-6 * 0.1
        assert abs(mom(step) - float(jm(step))) <= 1e-6 * 0.95
    assert make_momentum_schedule("cos", epochs=2, steps_per_epoch=3) is None
    cyc = make_schedule("cycle", 0.001, epochs=2, steps_per_epoch=5)
    assert cyc(0) == pytest.approx(0.1 / 25)


def test_shape_iou_matches_jax():
    """calculate_shape_IoU over the 16 categories' part windows and with
    a class_choice (labels from 0)."""
    from dgcnn_tpu.train import metrics as jmetrics

    rng = np.random.default_rng(73)
    label = rng.integers(0, 16, (6, 1))
    start = np.asarray(jmetrics.INDEX_START)[label[:, 0]]
    num = np.asarray(jmetrics.SEG_NUM)[label[:, 0]]
    seg = start[:, None] + rng.integers(0, 100, (6, 64)) % num[:, None]
    pred = np.where(rng.random((6, 64)) < 0.6, seg, start[:, None])
    for args in [(pred, seg, label, None), (pred % 4, seg % 4,
                                            np.full((6, 1), 4), "chair")]:
        assert calculate_shape_IoU(*args) == jmetrics.calculate_shape_IoU(
            *args)


@pytest.fixture
def shapenet_dir(tmp_path, monkeypatch):
    """The JAX package's synthetic ShapeNetPart h5 fixture (24 train, 8
    val, 16 test clouds of 128 points)."""
    from dgcnn_tpu.data import synthetic

    root = tmp_path / "data"
    synthetic.make_shapenetpart(str(root), num_points=128, seed=5)
    monkeypatch.setenv("DGCNN_TPU_DATA", str(root))
    monkeypatch.setenv("DGCNN_TPU_NO_DOWNLOAD", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _same_batches(jl, pl):
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


def test_shapenetpart_arrays_and_loader_batches_match_jax(shapenet_dir):
    """make_shapenetpart holds the JAX fixture's arrays for the same seed
    (and make_shapenetpart_structured the structured fixture's); the
    port's reader loads them as the JAX one does; for the same seed and
    epoch the two loaders give the same batches bit for bit: ShapeNetPart
    (trainval's point shuffle, the test padding, a class_choice) and
    ShapeNetPartAugmented (its augmentation order and choices)."""
    import h5py

    from dgcnn_tpu.data import ShapeNetPart as JaxShapeNetPart
    from dgcnn_tpu.data import ShapeNetPartAugmented as JaxAugmented
    from dgcnn_tpu.data import load_data_partseg as jload
    from dgcnn_tpu.data import make_loader as jax_loader
    from dgcnn_tpu.data import synthetic as jsynthetic

    from dgcnn_tpu_torch.data import (
        ShapeNetPart,
        ShapeNetPartAugmented,
        load_data_partseg,
        make_loader,
    )
    from dgcnn_tpu_torch.data.synthetic import (
        make_shapenetpart,
        make_shapenetpart_structured,
        trainval,
    )

    mem = make_shapenetpart(num_points=128, seed=5)
    for part in ("trainval", "test"):
        want = jload(part)
        got = load_data_partseg(part)
        arrays = trainval(mem) if part == "trainval" else mem["test"]
        for g, a, w in zip(got, arrays, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(a.astype(w.dtype), w)
    jsynthetic.make_shapenetpart_structured(
        str(shapenet_dir / "structured"), n_train=5, n_val=2, n_test=3,
        num_points=96, seed=6)
    smem = make_shapenetpart_structured(n_train=5, n_val=2, n_test=3,
                                        num_points=96, seed=6)
    for part in ("train", "val", "test"):
        with h5py.File(shapenet_dir / "structured" /
                       "shapenet_part_seg_hdf5_data" /
                       f"ply_data_{part}0.h5") as f:
            for name, got in zip(("data", "label", "pid"), smem[part]):
                np.testing.assert_array_equal(got, np.asarray(f[name]))
    fields = ["points", "label", "seg"]
    for part, choice, kw in [("trainval", None, dict(shuffle=True,
                                                     drop_last=True)),
                             ("test", None, dict(shuffle=True)),
                             ("trainval", "chair", dict(shuffle=True))]:
        jds = JaxShapeNetPart(96, part, choice, seed=3)
        ds = ShapeNetPart(96, part, choice)
        assert (ds.seg_num_all, ds.seg_start_index) == (
            jds.seg_num_all, jds.seg_start_index)
        _same_batches(jax_loader(jds, fields, 3, seed=3, **kw),
                      make_loader(ds, fields, 3, seed=3, **kw))
    for part in ("trainval", "test"):
        _same_batches(
            jax_loader(JaxAugmented(part, seed=3), fields, 4, seed=4,
                       shuffle=True),
            make_loader(ShapeNetPartAugmented(part), fields, 4, seed=4,
                        shuffle=True))


def _log_lines(exp: str) -> list[str]:
    with open(os.path.join("outputs", exp, "run.log")) as f:
        return f.read().splitlines()


SIZE = ["--model=dgcnn", "--num_points=128", "--k=6", "--emb_dim=32",
        "--test_batch_size=3"]


def test_partseg_cli_eval_line_matches_jax_cli(shapenet_dir):
    """--eval=True on the same exported weights, given under outputs/<exp>/
    as the reference resolves --model_path: the port's ``Test:`` line
    equals the JAX CLI's."""
    from dgcnn_tpu.cli import partseg as jpartseg
    from dgcnn_tpu.convert.torch_export import (
        export_dgcnn_partseg,
        save_torch_checkpoint,
    )

    from dgcnn_tpu_torch.cli import partseg

    _, variables = flax_partseg_variables(seed=7)
    for exp in ("jax", "port"):
        os.makedirs(f"outputs/{exp}/models")
        save_torch_checkpoint(f"outputs/{exp}/models/best.t7", {
            k: np.array(v)
            for k, v in export_dgcnn_partseg(variables).items()})
    args = ["--eval=True", "--model_path=models/best.t7"] + SIZE
    with jax.default_matmul_precision(F32):
        jpartseg.main(["--exp_name=jax"] + args)
    partseg.main(["--exp_name=port", "--no_cuda=True"] + args)
    want = [ln for ln in _log_lines("jax") if ln.startswith("Test:")]
    got = [ln for ln in _log_lines("port") if ln.startswith("Test:")]
    assert len(want) == 1 and got == want


TRAIN_LINE = re.compile(
    r"Train 0, loss: -?\d+\.\d{6}, train acc: \d\.\d{6}, "
    r"train avg acc: \d\.\d{6}, train iou: \d\.\d{6}")
TEST_LINE = re.compile(
    r"Test 0, loss: -?\d+\.\d{6}, test acc: (\d\.\d{6}), "
    r"test avg acc: (\d\.\d{6}), test iou: (\d\.\d{6})")


def test_partseg_cli_trains_resumes_and_reloads(shapenet_dir):
    """Training (SGD under the cycle scheduler, dropout 0.5, gradient
    accumulation over 2 batches) writes the JAX CLI's line formats, the
    resume checkpoint and transformer_0.checkpoint; --resume restarts from
    the checkpoint; --eval=True reloads the best model to the same test
    line, and with --fast_extract through the banded stages."""
    from dgcnn_tpu_torch.cli import partseg

    argv = ["--exp_name=tr", "--epochs=1", "--batch_size=4", "--dropout=0.5",
            "--grad_accum=2", "--no_cuda=True"] + SIZE
    partseg.main(argv)
    lines = _log_lines("tr")
    train = [ln for ln in lines if ln.startswith("Train 0")]
    test = [ln for ln in lines if ln.startswith("Test 0")]
    assert len(train) == 1 and TRAIN_LINE.fullmatch(train[0]), lines
    assert len(test) == 1 and TEST_LINE.fullmatch(test[0]), lines
    assert os.path.exists("outputs/tr/models/transformer_0.checkpoint")
    assert os.path.exists("outputs/tr/checkpoints/ckpt.checkpoint")
    eval_argv = ["--exp_name=tr", "--eval=True", "--no_cuda=True",
                 "--model_path=models/transformer_0.checkpoint"] + SIZE
    partseg.main(eval_argv)
    acc, avg, iou = TEST_LINE.fullmatch(test[0]).groups()
    assert _log_lines("tr")[-1] == (
        f"Test: test acc: {acc}, test avg acc: {avg}, test iou: {iou}")
    partseg.main(eval_argv + ["--fast_extract=0"])
    tests = [ln for ln in _log_lines("tr") if ln.startswith("Test:")]
    assert tests[-1] == tests[-2]
    partseg.main(eval_argv + ["--fast_extract=128"])
    assert _log_lines("tr")[-1].startswith("Test: test acc: ")
    partseg.main(argv + ["--resume=True"])
    lines = _log_lines("tr")
    assert any(ln.startswith("Resumed from outputs/tr/checkpoints/"
                             "ckpt.checkpoint at epoch 0") for ln in lines)
    assert TRAIN_LINE.fullmatch([ln for ln in lines
                                 if ln.startswith("Train 0")][-1])


@pytest.mark.parametrize("flag", [None, "--model=transformer",
                                  "--device_pipeline=True",
                                  "--export_model=a.stablehlo",
                                  "--visu=all", "--profile=auto",
                                  "--num_workers=2", "--tensorboard=True",
                                  "--orbax=True", "--remat=True",
                                  "--debug_nans=True", "--fast_extract=1000"])
def test_partseg_cli_refuses_what_is_not_ported(shapenet_dir, capsys, flag):
    """The fusion Net (the parser's default model, or named) with what of
    it is not ported (a --fast_extract band; the custom attention) and the
    JAX CLI's device-pipeline, export and visualization options are
    refused by the parser with a message; its runtime flags are not flags
    of the port; a band the kernels do not take is refused."""
    from dgcnn_tpu_torch.cli import partseg

    argv = ["--exp_name=t", "--no_cuda=True"]
    if flag is None:
        argv += ["--fast_extract=128"]
    elif flag.startswith("--model="):
        argv += [flag, "--use_custom_attention"]
    else:
        argv += ["--model=dgcnn", flag]
    with pytest.raises(SystemExit):
        partseg.main(argv)
    err = capsys.readouterr().err
    if flag is None:
        assert "with --model transformer is not ported yet" in err
    elif flag.startswith("--model="):
        assert "--use_custom_attention is not ported yet" in err
    elif flag.split("=")[0] in ("--device_pipeline", "--export_model",
                                "--visu"):
        assert "is not ported yet" in err


@pytest.mark.parametrize("cli", ["partseg", "semseg"])
def test_fast_extract_flag_sets_the_models_band(monkeypatch, capsys, cli):
    """--fast_extract parses a multiple of 128 and refuses 1000; the band
    reaches the model (DGCNNPartSeg, DGCNNSemSeg); without the flag the
    DGCNN_TPU_FAST_EXTRACT variable gives it, and --fast_extract=0 pins the
    exact path over it; a band of at least N warns."""
    import importlib

    mod = importlib.import_module(f"dgcnn_tpu_torch.cli.{cli}")
    base = ["--model=dgcnn", "--num_points=256", "--k=6"] + (
        ["--emb_dim=32"] if cli == "partseg" else ["--emb_dims=32"])
    parse = mod.build_parser().parse_args

    def band(*extra):
        return mod.build_model(parse(base + list(extra)), "cpu").band

    assert band("--fast_extract=128") == 128
    with pytest.raises(SystemExit):
        parse(base + ["--fast_extract=1000"])
    assert "positive multiple of 128" in capsys.readouterr().err
    monkeypatch.delenv("DGCNN_TPU_FAST_EXTRACT", raising=False)
    assert band() == 0
    monkeypatch.setenv("DGCNN_TPU_FAST_EXTRACT", "128")
    assert band() == 128
    assert band("--fast_extract=0") == 0
    assert band("--fast_extract=256") == 256
    assert "banding cannot prune anything" in capsys.readouterr().err


def test_dgcnn_partseg_band_runs_the_banded_stages(monkeypatch):
    """With a band that prunes N points the eval forward runs the two
    two-conv blocks through banded_knn_edge2 and conv5 through
    banded_edge_conv_eval, and the TransformNet exact; a band of at least
    N gives the exact forward."""
    from dgcnn_tpu_torch.models import dgcnn, nn_layers

    calls = []

    def counting(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(dgcnn, "banded_knn_edge2",
                        counting("edge2", dgcnn.banded_knn_edge2))
    monkeypatch.setattr(nn_layers, "banded_edge_conv_eval",
                        counting("conv5", nn_layers.banded_edge_conv_eval))
    monkeypatch.setattr(dgcnn, "knn_edge2", counting("tn", dgcnn.knn_edge2))
    x, one_hot, _ = (torch.from_numpy(a) for a in _clouds(74, n=256))
    model = DGCNNPartSeg(emb_dims=32, k=6, band=128, device="cpu")
    with torch.no_grad():
        banded = model(x, one_hot)
        assert calls == ["tn", "edge2", "edge2", "conv5"]
        model.band = 256
        exact = model(x, one_hot)
        model.band = 0
        assert torch.equal(model(x, one_hot), exact)
    assert calls[4:] == ["tn"] * 3 * 2
    assert banded.shape == exact.shape and torch.isfinite(banded).all()


@pytest.mark.cuda
def test_dgcnn_partseg_kernel_path_matches_plain_path(monkeypatch):
    """Full-width DGCNNPartSeg on the card: 3 / 1 / 2 launches per forward
    and the CPU plain path's per-point predictions; one SGD step launches
    1 / 3 / 2 / 2 / 3 and gives the CPU plain path's loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dgcnn_tpu_torch.models import init_like_flax_
    from dgcnn_tpu_torch.ops import (
        conv_pool,
        edge2_bwd,
        edge2_fwd,
        edge_conv_eval,
        edge_reduce_bwd,
        knn,
        knn_edge2,
        knn_reduce,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = init_like_flax_(DGCNNPartSeg(emb_dims=1024, k=40, dropout=0.0,
                                       device="cpu"),
                          torch.Generator().manual_seed(1))
    dev = copy.deepcopy(cpu).to("cuda")
    x, one_hot, seg = (torch.from_numpy(a) for a in _clouds(75, n=2048))
    knn_edge2.launches = edge_conv_eval.launches = conv_pool.launches = 0
    with torch.no_grad():
        got = dev(x.cuda(), one_hot.cuda()).cpu()
        want = cpu(x, one_hot)
    assert (knn_edge2.launches, edge_conv_eval.launches,
            conv_pool.launches) == (3, 1, 2)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.995
    train_step, _ = make_seg_steps(with_label=True)
    sched = make_schedule("cos", 0.001, epochs=100, steps_per_epoch=1)
    # the step in the exact mode, which the CPU plain path runs (the
    # card's default is AMP)
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    for f in (knn, knn_reduce, edge2_fwd, edge2_bwd, edge_reduce_bwd):
        f.launches = 0
    got = train_step(dev, make_optimizer(dev.parameters(), use_sgd=True,
                                         schedule=sched),
                     x.cuda(), one_hot.cuda(), seg.cuda())["loss"].item()
    assert (knn.launches, knn_reduce.launches, edge2_fwd.launches,
            edge2_bwd.launches, edge_reduce_bwd.launches) == (1, 3, 2, 2, 3)
    want = train_step(cpu, make_optimizer(cpu.parameters(), use_sgd=True,
                                          schedule=sched), x, one_hot,
                      seg)["loss"]
    assert got == pytest.approx(want.item(), rel=1e-4)
