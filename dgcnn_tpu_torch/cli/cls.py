"""ModelNet40 classification CLI (port of dgcnn_tpu/cli/cls.py): training
and evaluation.

Same flags as the JAX CLI apart from its TPU-only ones, and the same
``Train %d, ...``, ``Test %d, ...`` and ``Test :: test acc: ...`` lines.
Training keeps the best test accuracy's model in the reference state-dict
layout at ``outputs/<exp>/models/model.t7``.  Training and evaluation on
the card run the AMP (bf16) mode, the JAX package's default, unless
``DGCNN_TPU_PALLAS_EXACT`` is set; on the CPU they run the exact mode
(``models.DGCNNCls``).  No flag, as the JAX CLI has none.

    python -m dgcnn_tpu_torch.cli.cls --eval=False --exp_name=cls1024
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
from dgcnn_tpu_torch.data import ModelNet40, make_loader
from dgcnn_tpu_torch.models import DGCNNCls, PointNet, init_like_flax_
from dgcnn_tpu_torch.train import (
    accuracy_score,
    balanced_accuracy_score,
    make_cls_steps,
    make_optimizer,
    make_schedule,
    save_model,
)
from dgcnn_tpu_torch.utils import IOStream, ThroughputMeter


def build_model(args, device):
    if args.model == "pointnet":
        return PointNet(emb_dims=args.emb_dims, dropout=args.dropout,
                        device=device)
    if args.model == "dgcnn":
        return DGCNNCls(emb_dims=args.emb_dims, k=args.k,
                        dropout=args.dropout, device=device)
    raise Exception("Not implemented")


def evaluate(model, points: np.ndarray, labels: np.ndarray, batch_size: int,
             device) -> MeterAccumulator:
    """The eval loop: ``points`` (n, N, 3) and ``labels`` (n,) in batches of
    ``batch_size`` through ``model`` on ``device``; returns the filled
    meter (smoothed cross entropy, labels and argmax predictions)."""
    _, eval_step = make_cls_steps()
    meter = MeterAccumulator()
    for start in range(0, len(points), batch_size):
        x = torch.from_numpy(points[start:start + batch_size]).to(device)
        y = labels[start:start + batch_size]
        m = eval_step(model, x, torch.from_numpy(y).long().to(device))
        meter.add_cls(m["loss"].item(), m["preds"].cpu().numpy(), y)
    return meter


def train_epoch(model, opt, loader, device,
                generator: torch.Generator) -> MeterAccumulator:
    """One pass of the train loop over ``loader``'s batches: one optimizer
    step each, dropout drawn from ``generator``; returns the filled meter
    (each step's loss, labels and argmax predictions)."""
    train_step, _ = make_cls_steps()
    meter = MeterAccumulator()
    for batch in loader:
        labels = batch["label"][:, 0]
        m = train_step(model, opt, torch.from_numpy(batch["points"]).to(device),
                       torch.from_numpy(labels).to(device), generator)
        meter.add_cls(m["loss"].item(), m["preds"].cpu().numpy(), labels,
                      batch["mask"])
    return meter


def test_line(meter: MeterAccumulator) -> str:
    t, p = meter.concat()
    return ("Test :: test acc: %.6f, test avg acc: %.6f"
            % (accuracy_score(t, p), balanced_accuracy_score(t, p)))


def run_training(args, io: IOStream, train_ds, test_ds, device):
    """The train loop of the JAX CLI (dgcnn_tpu/cli/cls.py ``train``) over
    the datasets given: flax-like initialization from ``--seed``, one
    ``Train`` and one ``Test`` line an epoch, and the model of the best
    test accuracy so far saved.  Returns (model, best test accuracy)."""
    train_loader = make_loader(train_ds, ["points", "label"],
                               batch_size=args.batch_size, shuffle=True,
                               drop_last=True, seed=args.seed)
    test_points, test_labels = test_ds.arrays()
    io.cprint(f"Using 1 device(s): {torch.device(device).type}")
    model = build_model(args, "cpu")
    init_like_flax_(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    schedule = make_schedule(args.scheduler, args.lr, epochs=args.epochs,
                             steps_per_epoch=len(train_loader),
                             use_sgd=args.use_sgd)
    opt = make_optimizer(model.parameters(), use_sgd=args.use_sgd,
                         schedule=schedule, momentum=args.momentum)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    best_test_acc = 0.0
    tput = ThroughputMeter()
    for epoch in range(args.epochs):
        train_loader.set_epoch(epoch)
        tput.start()
        meter = train_epoch(model, opt, train_loader, device, generator)
        rate = tput.tick(meter.count)
        t, p = meter.concat()
        io.cprint(
            "Train %d, loss: %.6f, train acc: %.6f, train avg acc: %.6f, "
            "throughput: %.1f clouds/sec"
            % (epoch, meter.mean_loss, accuracy_score(t, p),
               balanced_accuracy_score(t, p), rate))

        meter = evaluate(model, test_points, test_labels,
                         args.test_batch_size, device)
        t, p = meter.concat()
        test_acc = accuracy_score(t, p)
        io.cprint(
            "Test %d, loss: %.6f, test acc: %.6f, test avg acc: %.6f"
            % (epoch, meter.mean_loss, test_acc, balanced_accuracy_score(t, p))
        )
        if test_acc >= best_test_acc:
            best_test_acc = test_acc
            save_model(f"outputs/{args.exp_name}/models/model.t7", model)
    return model, best_test_acc


def train(args, io: IOStream):
    train_ds = ModelNet40(num_points=args.num_points, partition="train")
    test_ds = ModelNet40(num_points=args.num_points, partition="test")
    run_training(args, io, train_ds, test_ds, pick_device(args.no_cuda))


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
    init_output_dir(args.exp_name, __file__)
    io = IOStream("outputs/" + args.exp_name + "/run.log")
    io.cprint(str(args))
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if not args.eval:
        train(args, io)
    else:
        test(args, io)


if __name__ == "__main__":
    main()
