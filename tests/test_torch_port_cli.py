"""The PyTorch port's cls CLI against the JAX CLI, on the CPU: the same
synthetic ModelNet40 h5 fixture and the same exported ``.t7`` weights give
the same ``Test :: test acc`` line; training writes the JAX CLI's line
formats and a checkpoint that evaluation reloads."""
import os
import re

import numpy as np
import pytest
import torch

import jax

from test_torch_port_model import flax_cls_variables

ARGS = ["--eval=True", "--model_path=model.t7", "--test_batch_size=8",
        "--num_points=128", "--k=8", "--emb_dims=32"]


@pytest.fixture
def fixture_dir(tmp_path, monkeypatch):
    from dgcnn_tpu.data import synthetic

    root = tmp_path / "data"
    synthetic.make_modelnet40(str(root), n_train=4, n_test=20, seed=3)
    monkeypatch.setenv("DGCNN_TPU_DATA", str(root))
    monkeypatch.setenv("DGCNN_TPU_NO_DOWNLOAD", "1")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _label_half_by_prediction(fmodel, variables):
    """Relabel the test fixture so that the JAX model predicts half of the
    clouds right: the accuracy line then moves with any prediction that
    differs between the two CLIs."""
    import h5py

    path = os.path.join(os.environ["DGCNN_TPU_DATA"],
                        "modelnet40_ply_hdf5_2048", "ply_data_test0.h5")
    with h5py.File(path, "r+") as f:
        points = np.asarray(f["data"])[:, :128]
        with jax.default_matmul_precision("float32"):
            preds = np.asarray(fmodel.apply(variables, points).argmax(-1))
        labels = np.where(np.arange(len(preds)) % 2 == 0, preds,
                          (preds + 1) % 40)
        f["label"][...] = labels[:, None].astype(f["label"].dtype)


def _last_line(exp: str) -> str:
    with open(os.path.join("outputs", exp, "run.log")) as f:
        return f.read().splitlines()[-1]


def test_cls_eval_line_matches_jax_cli(fixture_dir):
    from dgcnn_tpu.cli import cls as jcls
    from dgcnn_tpu.convert.torch_export import (
        export_dgcnn_cls,
        save_torch_checkpoint,
    )
    from dgcnn_tpu_torch.cli import cls

    fmodel, variables = flax_cls_variables(emb_dims=32, k=8, seed=4)
    _label_half_by_prediction(fmodel, variables)
    save_torch_checkpoint("model.t7", {k: np.array(v) for k, v in
                                      export_dgcnn_cls(variables).items()})
    with jax.default_matmul_precision("float32"):
        jcls.main(["--exp_name=jax"] + ARGS)
    cls.main(["--exp_name=port", "--no_cuda=True"] + ARGS)
    want, got = _last_line("jax"), _last_line("port")
    assert want.startswith("Test :: test acc: ")
    assert got == want
    assert want != "Test :: test acc: 0.000000, test avg acc: 0.000000"


def test_synthetic_arrays_match_jax_fixture(fixture_dir):
    from dgcnn_tpu_torch.data import ModelNet40
    from dgcnn_tpu_torch.data.synthetic import make_modelnet40

    data, label = make_modelnet40(n_train=4, n_test=20, seed=3)["test"]
    points, labels = ModelNet40(num_points=128).arrays()
    np.testing.assert_array_equal(points, data[:, :128])
    np.testing.assert_array_equal(labels, label[:, 0])


def test_cls_cli_refuses_what_is_not_ported(fixture_dir, monkeypatch):
    """What the CLI still refuses: the CUDA card where there is none, and a
    dataset that is not there (nothing is downloaded).  ``--eval=False``
    is ported now and trains (test_cls_cli_trains_and_reloads)."""
    from dgcnn_tpu_torch.cli import cls, common

    with pytest.raises(SystemExit):  # as the JAX cls CLI: no cycle scheduler
        cls.main(["--exp_name=t", "--eval=False", "--scheduler=cycle"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no_cuda"):
        cls.main(["--exp_name=t", "--eval=False"])
    with pytest.raises(RuntimeError, match="no_cuda"):
        common.pick_device(False)
    monkeypatch.setenv("DGCNN_TPU_DATA", str(fixture_dir / "absent"))
    with pytest.raises(FileNotFoundError, match="absent"):
        cls.main(["--exp_name=t", "--no_cuda=True"] + ARGS)
    with pytest.raises(FileNotFoundError, match="absent"):
        cls.main(["--exp_name=t", "--no_cuda=True", "--eval=False"])


# the JAX CLI's per-epoch lines (dgcnn_tpu/cli/cls.py train)
TRAIN_LINE = re.compile(
    r"Train 0, loss: -?\d+\.\d{6}, train acc: \d\.\d{6}, "
    r"train avg acc: \d\.\d{6}, throughput: \d+\.\d clouds/sec")
TEST_LINE = re.compile(
    r"Test 0, loss: -?\d+\.\d{6}, test acc: (\d\.\d{6}), "
    r"test avg acc: (\d\.\d{6})")


def test_cls_cli_trains_and_reloads(fixture_dir):
    from dgcnn_tpu_torch.cli import cls

    size = ["--num_points=128", "--k=8", "--emb_dims=32",
            "--test_batch_size=8", "--no_cuda=True"]
    cls.main(["--exp_name=tr", "--eval=False", "--epochs=1",
              "--batch_size=2", "--dropout=0.5"] + size)
    with open(os.path.join("outputs", "tr", "run.log")) as f:
        lines = f.read().splitlines()
    train = [ln for ln in lines if ln.startswith("Train 0")]
    test = [ln for ln in lines if ln.startswith("Test 0")]
    assert len(train) == 1 and TRAIN_LINE.fullmatch(train[0]), lines
    assert len(test) == 1 and TEST_LINE.fullmatch(test[0]), lines
    model_path = os.path.join("outputs", "tr", "models", "model.t7")
    cls.main(["--exp_name=ev", "--eval=True", f"--model_path={model_path}"]
             + size)
    acc, avg = TEST_LINE.fullmatch(test[0]).groups()
    assert _last_line("ev") == (f"Test :: test acc: {acc}, "
                                f"test avg acc: {avg}")
