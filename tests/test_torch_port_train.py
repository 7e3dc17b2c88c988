"""Parity of the PyTorch port's training path with the JAX package's, on
the CPU at small sizes: layers in training mode, whole SGD steps of
DGCNNCls from one flax init, schedules, the batch loader and checkpoints.

Both sides start from the same flax variables (carried over with
``state_dict_from_flax``) and take the same numpy batches.  The JAX side
runs under ``jax.default_matmul_precision("float32")``; the port's
kernels run their plain versions here because the tensors lie on the CPU.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNCls, PointNet, init_like_flax_
from dgcnn_tpu_torch.models.nn_layers import ConvBN, DenseBNReLU, EdgeConv
from dgcnn_tpu_torch.ops import knn_edge_reduce, knn_edge_reduce_xw
from dgcnn_tpu_torch.train import (
    load_train_checkpoint,
    make_cls_steps,
    make_optimizer,
    make_schedule,
    save_train_checkpoint,
)

F32 = "float32"


def _t(a):
    return torch.tensor(np.asarray(a))


def _clouds(seed, b=2, n=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)).astype(np.float32),
            rng.integers(0, 40, b).astype(np.int32))


def _assert_state_close(got: dict, want: dict, rtol=1e-4, atol=1e-5):
    for key, v in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].detach().numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.fixture
def pallas_exact(monkeypatch):
    """The JAX package's fused training path, exact f32 mode (interpret on
    the CPU), as tests/test_pallas_train_path.py sets it."""
    monkeypatch.setenv("DGCNN_TPU_PALLAS", "1")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")


def _flax_train(layer, variables, *args, **kw):
    with jax.default_matmul_precision(F32):
        out, upd = layer.apply(variables, *args, train=True,
                               mutable=["batch_stats"], **kw)
    return np.asarray(out), upd["batch_stats"]


def _load_bn(bn, params, stats):
    with torch.no_grad():
        for name, src in [("weight", params["scale"]), ("bias", params["bias"]),
                          ("running_mean", stats["mean"]),
                          ("running_var", stats["var"])]:
            getattr(bn, name).copy_(_t(src))


def test_bn_layers_train_match_flax():
    """ConvBN and DenseBNReLU in training mode: batch statistics normalize,
    the running statistics move with the unbiased variance."""
    from dgcnn_tpu.models import nn_layers as fl
    from test_torch_port_model import randomize_flax

    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 128, 16)).astype(np.float32)
    v = rng.standard_normal((4, 16)).astype(np.float32)
    for flax_layer, layer, arg, dense in [
            (fl.ConvBN(24), ConvBN(16, 24), x, "conv"),
            (fl.DenseBNReLU(24), DenseBNReLU(16, 24), v, "linear")]:
        var = randomize_flax(flax_layer.init(jax.random.PRNGKey(0),
                                             jnp.asarray(arg)), 31)
        p, s = var["params"], var["batch_stats"]
        with torch.no_grad():
            layer[0].weight.copy_(_t(np.asarray(p[dense]["kernel"]).T)
                                  .reshape(layer[0].weight.shape))
        _load_bn(layer[1], p["bn"], s["bn"])
        want, stats = _flax_train(flax_layer, var, jnp.asarray(arg))
        got = layer(torch.from_numpy(arg), train=True)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        for name, key in [("running_mean", "mean"), ("running_var", "var")]:
            np.testing.assert_allclose(
                getattr(layer[1], name).numpy(), np.asarray(stats["bn"][key]),
                rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cin,co", [(16, 24), (16, 160)])
def test_edge_conv_train_matches_flax(pallas_exact, cin, co):
    """EdgeConv training from the kernel sums, in both dispatches: project
    first (16 -> 24) and select-x (16 -> 160: one 128-lane pass of raw
    features against two of the projection).  Outputs, running statistics
    and gradients against the flax layer on its fused Pallas path."""
    from dgcnn_tpu.models import nn_layers as fl
    from test_torch_port_model import randomize_flax

    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 128, cin)).astype(np.float32)
    ct = rng.standard_normal((2, 128, co)).astype(np.float32)
    flax_layer = fl.EdgeConv(co)
    var = randomize_flax(flax_layer.init(
        jax.random.PRNGKey(0), jnp.asarray(x), graph=jnp.asarray(x), k=6), 33)
    p, s = var["params"], var["batch_stats"]

    def loss(params):
        with jax.default_matmul_precision(F32):
            out, upd = flax_layer.apply(
                {"params": params, "batch_stats": s}, jnp.asarray(x),
                train=True, graph=jnp.asarray(x), k=6,
                mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(ct)), (out, upd["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss, has_aux=True)(p)
    layer = EdgeConv(cin, co)
    w = np.concatenate([np.asarray(p["w_nbr"]).T, np.asarray(p["w_ctr"]).T], 1)
    with torch.no_grad():
        layer[0].weight.copy_(_t(w).reshape(layer[0].weight.shape))
    _load_bn(layer[1], p, s)
    xt = torch.from_numpy(x)
    got = layer(xt, train=True, graph=xt, k=6)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for name, key in [("running_mean", "mean"), ("running_var", "var")]:
        np.testing.assert_allclose(getattr(layer[1], name).numpy(),
                                   np.asarray(stats[key]), rtol=1e-5,
                                   atol=1e-6)
    gw = layer[0].weight.grad.reshape(co, 2 * cin).numpy()
    for g, want_g in [(gw[:, :cin].T, grads["w_nbr"]),
                      (gw[:, cin:].T, grads["w_ctr"]),
                      (layer[1].weight.grad.numpy(), grads["scale"]),
                      (layer[1].bias.grad.numpy(), grads["bias"])]:
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(g, want_g, rtol=1e-4,
                                   atol=1e-5 * np.abs(want_g).max())


def test_edge_conv_train_with_idx_matches_fused():
    """Given neighbour indices, training takes the batch statistics of
    ops.edge_conv; from the graph it takes them from the kernel sums: the
    same layer gives the same output either way."""
    from dgcnn_tpu_torch.ops import knn

    torch.manual_seed(0)
    layer = EdgeConv(8, 16)
    with torch.no_grad():
        layer[0].weight.normal_(0.0, 0.3)
    x = torch.randn(2, 128, 8)
    want = layer(x, train=True, graph=x, k=5)
    got = layer(x, knn(x, 5), train=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_knn_edge_reduce_forms_agree():
    """The select-x form gives the project-first form's outputs."""
    rng = np.random.default_rng(34)
    g = torch.from_numpy(rng.standard_normal((2, 128, 3)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 128, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    for a, b in zip(knn_edge_reduce(g, x @ w, 5),
                    knn_edge_reduce_xw(g, x, w, 5)):
        assert torch.equal(a, b)


def _min_knn_gap(model, k: int):
    """Hooks on the model's four EdgeConvs that record, per forward, the
    smallest gap between any point's k-th and (k+1)-th neighbour score,
    over the scale of the scores (f32 rounds them at ~1e-7 of it)."""
    gaps = []

    def hook(_mod, _args, kwargs):
        g = kwargs["graph"].detach()
        sq = (g * g).sum(-1)
        top = (2 * torch.bmm(g, g.transpose(1, 2)) - sq[:, :, None]
               - sq[:, None, :]).topk(k + 1, dim=-1).values
        scale = sq + sq.amax(-1, keepdim=True)
        gaps.append(((top[..., k - 1] - top[..., k]) / scale).min().item())

    for i in range(1, 5):
        getattr(model, f"conv{i}").register_forward_pre_hook(
            hook, with_kwargs=True)
    return gaps


def _jax_cls_steps(fmodel, variables, batches, use_sgd, scheduler, epochs):
    from dgcnn_tpu.train import (
        TrainState,
        make_cls_steps as jsteps,
        make_optimizer as jopt,
        make_schedule as jsched,
    )

    schedule = jsched(scheduler, 0.001, epochs=epochs, steps_per_epoch=1,
                      use_sgd=use_sgd)
    state = TrainState.create(
        apply_fn=fmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jopt(use_sgd=use_sgd, schedule=schedule, momentum=0.9))
    train_step, _ = jsteps(fmodel)
    losses = []
    with jax.default_matmul_precision(F32):
        for points, labels in batches:
            state, m = train_step(state, jnp.asarray(points),
                                  jnp.asarray(labels), jax.random.PRNGKey(1))
            losses.append(float(m["loss"]))
    return losses, {"params": state.params, "batch_stats": state.batch_stats}


@pytest.mark.parametrize("use_sgd", [True, False])
def test_dgcnn_cls_two_train_steps_match_jax(pallas_exact, use_sgd):
    """Two steps of the JAX package's make_cls_steps / make_optimizer /
    make_schedule (cos) on its fused exact training path against two port
    steps, from one flax init and the same batches, dropout 0: losses,
    parameters and running statistics.  (JAX's unfused XLA path scores
    the deeper stages' neighbours in another summation order and flips
    near ties: its gradients differ from the fused path's by up to 1e-2.)
    Batches of 8: the head's BatchNorm over 2 clouds maps every channel to
    +-1 and its gradient is rounding noise (the port's own gradients move
    by 3e-4 relative when 4 clouds are reordered, by 2e-5 for 8).  The
    batches are ones whose every stage keeps its k-th and (k+1)-th
    neighbours apart by over 1e-6 of the score scale: a near tie that
    rounding flips moves a gradient by up to 1e-2 in either framework."""
    from dgcnn_tpu.models import DGCNNCls as FlaxDGCNNCls

    fmodel = FlaxDGCNNCls(emb_dims=32, k=8, dropout=0.0)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((2, 128, 3), jnp.float32), train=False)
    batches = [_clouds(58, b=8), _clouds(59, b=8)]
    want_losses, want_vars = _jax_cls_steps(fmodel, variables, batches,
                                            use_sgd, "cos", epochs=2)

    model = DGCNNCls(emb_dims=32, k=8, dropout=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    gaps = _min_knn_gap(model, 8)
    opt = make_optimizer(model.parameters(), use_sgd=use_sgd,
                         schedule=make_schedule("cos", 0.001, epochs=2,
                                                steps_per_epoch=1,
                                                use_sgd=use_sgd))
    train_step, _ = make_cls_steps()
    losses = [train_step(model, opt, torch.from_numpy(p),
                         torch.from_numpy(lab))["loss"].item()
              for p, lab in batches]
    assert len(gaps) == 8 and min(gaps) > 1e-6, gaps
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert opt.step_count == 2
    if use_sgd:
        # Adam moves a weight by about lr whatever the size of its
        # gradient, so a weight whose gradient is rounding noise (a BN bias
        # of the head, at 8 clouds) moves by +-lr in either framework: for
        # Adam the step-2 loss holds the first step's parameters
        _assert_state_close(model.state_dict(),
                            state_dict_from_flax(want_vars))


def test_pointnet_train_step_matches_jax():
    """PointNet has no kernel: one SGD step (step schedule)."""
    from dgcnn_tpu.models import PointNet as FlaxPointNet

    fmodel = FlaxPointNet(emb_dims=32, dropout=0.0)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((2, 128, 3), jnp.float32), train=False)
    batches = [_clouds(42, b=8)]
    want_losses, want_vars = _jax_cls_steps(fmodel, variables, batches, True,
                                            "step", epochs=1)
    model = PointNet(emb_dims=32, dropout=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    opt = make_optimizer(model.parameters(), use_sgd=True,
                         schedule=make_schedule("step", 0.001, epochs=1,
                                                steps_per_epoch=1))
    train_step, _ = make_cls_steps()
    m = train_step(model, opt, *(torch.from_numpy(a) for a in batches[0]))
    np.testing.assert_allclose(m["loss"].item(), want_losses[0], rtol=1e-4)
    _assert_state_close(model.state_dict(), state_dict_from_flax(want_vars))


@pytest.mark.parametrize("name,use_sgd", [("cos", True), ("cos", False),
                                          ("step", True), ("step", False)])
def test_schedules_match_jax(name, use_sgd):
    """Every step of 250 epochs.  The JAX schedule runs in f32 under jit,
    the port's in Python floats as torch's schedulers do: near the end of
    the cosine, 1 + cos rounds in f32 to a few 1e-6 of the lr."""
    from dgcnn_tpu.train import make_schedule as jsched

    kw = dict(epochs=250, steps_per_epoch=3, use_sgd=use_sgd)
    want, got = jsched(name, 0.001, **kw), make_schedule(name, 0.001, **kw)
    for step in range(0, 800):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5,
                                          abs=1e-12), step


def test_loader_batches_bit_identical_to_jax(tmp_path, monkeypatch):
    """For the same arrays, seed and epoch the port's loader gives the JAX
    loader's batches bit for bit: the sample order, the augmentation and
    the padding of the last test batch."""
    from dgcnn_tpu.data import ModelNet40 as JaxModelNet40
    from dgcnn_tpu.data import make_loader as jax_loader
    from dgcnn_tpu.data import synthetic

    from dgcnn_tpu_torch.data import ModelNet40, make_loader

    synthetic.make_modelnet40(str(tmp_path), n_train=10, n_test=7, seed=5)
    monkeypatch.setenv("DGCNN_TPU_DATA", str(tmp_path))
    monkeypatch.setenv("DGCNN_TPU_NO_DOWNLOAD", "1")
    for part, kw in [("train", dict(shuffle=True, drop_last=True)),
                     ("test", dict(shuffle=True))]:
        jds = JaxModelNet40(num_points=64, partition=part, seed=3)
        ds = ModelNet40(num_points=64, partition=part, data=jds.data,
                        label=jds.label)
        jl = jax_loader(jds, ["points", "label"], 4, seed=3, **kw)
        pl = make_loader(ds, ["points", "label"], 4, seed=3, **kw)
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


def test_train_checkpoint_round_trip(tmp_path):
    """A train checkpoint restores the weights, the optimizer's momentum and
    the schedule's step: the resumed run's next step equals the
    uninterrupted run's."""
    points, labels = (torch.from_numpy(a) for a in _clouds(43, n=64))

    def fresh():
        model = init_like_flax_(DGCNNCls(emb_dims=32, k=4, dropout=0.0,
                                         device="cpu"),
                                torch.Generator().manual_seed(2))
        opt = make_optimizer(model.parameters(), use_sgd=True,
                             schedule=make_schedule("cos", 0.001, epochs=4,
                                                    steps_per_epoch=1))
        return model, opt

    train_step, _ = make_cls_steps()
    model, opt = fresh()
    train_step(model, opt, points, labels)
    path = str(tmp_path / "ckpt.checkpoint")
    save_train_checkpoint(path, model, opt, epoch=0, loss=1.5)
    want = train_step(model, opt, points, labels)["loss"]
    model2, opt2 = fresh()
    assert load_train_checkpoint(path, model2, opt2) == (0, 1.5)
    assert opt2.step_count == 1
    got = train_step(model2, opt2, points, labels)["loss"]
    assert torch.equal(got, want)
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k


def test_init_like_flax_matches_flax_statistics():
    """The flax initialization's distribution: lecun-normal weights with
    each EdgeConv half on its own fan-in, zero biases, identity BatchNorm."""
    model = init_like_flax_(DGCNNCls(emb_dims=1024, k=4, device="cpu"),
                            torch.Generator().manual_seed(0))
    w = model.conv5[0].weight
    assert w.std().item() == pytest.approx((1 / 512) ** 0.5, rel=0.02)
    assert w.abs().max().item() <= 2 * (1 / 512) ** 0.5 / 0.8796 + 1e-6
    w_nbr, _ = model.conv4.split_weights()
    assert w_nbr.std().item() == pytest.approx((1 / 128) ** 0.5, rel=0.05)
    assert torch.equal(model.linear2.bias, torch.zeros(256))
    assert torch.equal(model.bn6.running_var, torch.ones(512))


@pytest.mark.cuda
def test_dgcnn_cls_train_step_kernel_path_matches_plain(monkeypatch):
    """Full-width DGCNNCls training step on the card in the exact mode (the
    pin: the card's default is AMP): 3 + 1 forward and 4 backward kernel
    launches, and the loss and gradients of the plain path on the CPU from
    the same weights and batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("DGCNN_TPU_PALLAS_EXACT", "1")
    from dgcnn_tpu_torch.ops import edge_reduce_bwd, knn_reduce, knn_reduce_xw

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = init_like_flax_(DGCNNCls(emb_dims=1024, k=20, dropout=0.0,
                                   device="cpu"),
                          torch.Generator().manual_seed(1))
    dev = copy.deepcopy(cpu).to("cuda")
    points, labels = (torch.from_numpy(a) for a in _clouds(60, b=8, n=1024))
    train_step, _ = make_cls_steps()
    sched = make_schedule("cos", 0.001, epochs=250, steps_per_epoch=1)
    knn_reduce.launches = knn_reduce_xw.launches = edge_reduce_bwd.launches = 0
    got = train_step(dev, make_optimizer(dev.parameters(), use_sgd=True,
                                         schedule=sched),
                     points.cuda(), labels.cuda())["loss"].item()
    assert (knn_reduce.launches, knn_reduce_xw.launches,
            edge_reduce_bwd.launches) == (3, 1, 4)
    want = train_step(cpu, make_optimizer(cpu.parameters(), use_sgd=True,
                                          schedule=sched),
                      points, labels)["loss"].item()
    assert got == pytest.approx(want, rel=1e-4)
    g_dev, g_cpu = (torch.cat([p.grad.reshape(-1).double().cpu()
                               for p in m.parameters()]) for m in (dev, cpu))
    assert torch.isfinite(g_dev).all()
    assert (g_dev @ g_cpu / (g_dev.norm() * g_cpu.norm())).item() >= 0.999
