"""ModelNet40 classification CLI, eval mode (port of dgcnn_tpu/cli/cls.py).

Same flags as the JAX CLI apart from its TPU-only ones, and the same
``Test :: test acc: ..., test avg acc: ...`` line.  Training is not ported
yet: ``--eval=False`` raises.

    python -m dgcnn_tpu_torch.cli.cls --eval=True \
        --model_path=pretrained/model.cls.1024.t7 --test_batch_size=32
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from dgcnn_tpu_torch.cli.common import (
    MeterAccumulator,
    init_output_dir,
    pick_device,
    str2bool,
)
from dgcnn_tpu_torch.convert import load_checkpoint
from dgcnn_tpu_torch.data import ModelNet40
from dgcnn_tpu_torch.models import DGCNNCls, PointNet
from dgcnn_tpu_torch.train import (
    accuracy_score,
    balanced_accuracy_score,
    cross_entropy,
)
from dgcnn_tpu_torch.utils import IOStream


def build_model(args, device):
    if args.model == "pointnet":
        return PointNet(emb_dims=args.emb_dims, device=device)
    if args.model == "dgcnn":
        return DGCNNCls(emb_dims=args.emb_dims, k=args.k, device=device)
    raise Exception("Not implemented")


@torch.no_grad()
def evaluate(model, points: np.ndarray, labels: np.ndarray, batch_size: int,
             device) -> MeterAccumulator:
    """The eval loop: ``points`` (n, N, 3) and ``labels`` (n,) in batches of
    ``batch_size`` through ``model`` on ``device``; returns the filled
    meter (smoothed cross entropy, labels and argmax predictions)."""
    meter = MeterAccumulator()
    for start in range(0, len(points), batch_size):
        x = torch.from_numpy(points[start:start + batch_size]).to(device)
        y = torch.from_numpy(labels[start:start + batch_size]).long()
        logits = model(x).cpu()
        meter.add_cls(cross_entropy(logits, y).item(),
                      logits.argmax(-1).numpy(), y.numpy())
    return meter


def test_line(meter: MeterAccumulator) -> str:
    t, p = meter.concat()
    return ("Test :: test acc: %.6f, test avg acc: %.6f"
            % (accuracy_score(t, p), balanced_accuracy_score(t, p)))


def test(args, io: IOStream):
    if not args.model_path:
        raise ValueError("--eval=True needs --model_path")
    points, labels = ModelNet40(num_points=args.num_points,
                                partition="test").arrays()
    device = pick_device(args.no_cuda)
    model = load_checkpoint(args.model_path, build_model(args, device))
    io.cprint(test_line(evaluate(model, points, labels,
                                 args.test_batch_size, device)))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Point Cloud Recognition")
    parser.add_argument("--exp_name", type=str, default="exp", metavar="N")
    parser.add_argument("--model", type=str, default="dgcnn", metavar="N",
                        choices=["pointnet", "dgcnn"])
    parser.add_argument("--dataset", type=str, default="modelnet40",
                        metavar="N", choices=["modelnet40"])
    parser.add_argument("--batch_size", type=int, default=32,
                        metavar="batch_size")
    parser.add_argument("--test_batch_size", type=int, default=16,
                        metavar="batch_size")
    parser.add_argument("--epochs", type=int, default=250, metavar="N")
    parser.add_argument("--use_sgd", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=0.001, metavar="LR")
    parser.add_argument("--momentum", type=float, default=0.9, metavar="M")
    parser.add_argument("--scheduler", type=str, default="cos", metavar="N",
                        choices=["cos", "step"])
    parser.add_argument("--no_cuda", type=str2bool, default=False,
                        help="run on the CPU")
    parser.add_argument("--seed", type=int, default=1, metavar="S")
    parser.add_argument("--eval", type=str2bool, default=False)
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--emb_dims", type=int, default=1024, metavar="N")
    parser.add_argument("--k", type=int, default=20, metavar="N")
    parser.add_argument("--model_path", type=str, default="", metavar="N")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.eval:
        raise NotImplementedError(
            "training is not ported to dgcnn_tpu_torch yet (see ROADMAP.md); "
            "pass --eval=True")
    init_output_dir(args.exp_name, __file__)
    io = IOStream("outputs/" + args.exp_name + "/run.log")
    io.cprint(str(args))
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    test(args, io)


if __name__ == "__main__":
    main()
