"""S3DIS semantic segmentation CLI (port of dgcnn_tpu/cli/semseg.py):
training and the 6-fold evaluation.

Same flags as the JAX CLI apart from its point sharding, device
pipeline, export and visualization ones, and the same ``Train %d, ...``,
``Test %d, ...``, ``Test :: test area:
...`` and ``Overall Test :: ...`` lines.  Training for ``--test_area=<a>``
keeps the best test IoU's model in the reference state-dict layout at
``outputs/<exp>/models/model_<a>.t7``; evaluation loads
``<model_root>/model_<a>.t7`` for each area it tests (``--test_area=all``:
areas 1-6 and the overall line).  ``--fast_extract BAND`` runs the eval
forwards (a training run's test passes too) through the banded kernels.
On the card the training steps and eval forwards run the AMP mode unless
``DGCNN_TPU_PALLAS_EXACT`` is set; ``main`` pins ``DGCNN_TPU_EXTRACT=v2``
for its run, as the JAX CLI does (the AMP training's kNN kernels take v2
anyway).

    python -m dgcnn_tpu_torch.cli.semseg --exp_name=s3dis6 --test_area=6
    python -m dgcnn_tpu_torch.cli.semseg --eval=True --test_area=all \
        --model_root=outputs/s3dis6/models [--fast_extract 1024]
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from dgcnn_tpu_torch.cli.common import (
    MeterAccumulator,
    band_arg,
    init_output_dir,
    pick_device,
    resolve_band,
    str2bool,
)
from dgcnn_tpu_torch.convert import load_checkpoint
from dgcnn_tpu_torch.data import S3DIS, make_loader
from dgcnn_tpu_torch.models import DGCNNSemSeg, init_like_flax_
from dgcnn_tpu_torch.ops.amp_select import EXTRACT_ENV
from dgcnn_tpu_torch.train import (
    accuracy_score,
    balanced_accuracy_score,
    calculate_sem_IoU,
    make_optimizer,
    make_schedule,
    make_seg_steps,
    save_model,
)
from dgcnn_tpu_torch.utils import IOStream

AREAS = ["1", "2", "3", "4", "5", "6"]


def build_model(args, device):
    if args.model == "dgcnn":
        return DGCNNSemSeg(emb_dims=args.emb_dims, k=args.k,
                           dropout=args.dropout,
                           band=resolve_band(args.fast_extract,
                                             args.num_points),
                           device=device)
    raise Exception("Not implemented")


def seg_metrics(meter: MeterAccumulator) -> tuple[float, float, float]:
    """(accuracy, balanced accuracy, mean IoU) over the points of the
    meter's blocks (the IoU's nan classes make the mean nan, as in the
    reference)."""
    t, p = meter.concat()
    ts, ps = meter.concat_seg()
    return (accuracy_score(t, p), balanced_accuracy_score(t, p),
            float(np.mean(calculate_sem_IoU(ps, ts))))


def evaluate(model, loader, device) -> MeterAccumulator:
    """The eval loop over ``loader``'s padded batches: per-point argmax
    predictions and the smoothed cross entropy of the real rows."""
    _, eval_step = make_seg_steps()
    meter = MeterAccumulator()
    for batch in loader:
        m = eval_step(model, torch.from_numpy(batch["points"]).to(device),
                      torch.from_numpy(batch["seg"]).to(device),
                      torch.from_numpy(batch["mask"]).to(device))
        meter.add_seg(m["loss"].item(), m["preds"].cpu().numpy(),
                      batch["seg"], batch["mask"])
    return meter


def train_epoch(model, opt, loader, device,
                generator: torch.Generator) -> MeterAccumulator:
    """One pass of the train loop over ``loader``'s batches: one optimizer
    step each, dropout drawn from ``generator``."""
    train_step, _ = make_seg_steps()
    meter = MeterAccumulator()
    for batch in loader:
        m = train_step(model, opt,
                       torch.from_numpy(batch["points"]).to(device),
                       torch.from_numpy(batch["seg"]).to(device), generator)
        meter.add_seg(m["loss"].item(), m["preds"].cpu().numpy(),
                      batch["seg"], batch["mask"])
    return meter


def run_training(args, io: IOStream, train_ds, test_ds, device):
    """The train loop of the JAX CLI (dgcnn_tpu/cli/semseg.py ``train``)
    over the datasets given: flax-like initialization from ``--seed``, one
    ``Train`` and one ``Test`` line an epoch, and the model of the best
    test IoU so far saved as ``model_<test_area>.t7``.  Returns (model,
    best test IoU)."""
    train_loader = make_loader(train_ds, ["points", "seg"],
                               batch_size=args.batch_size, shuffle=True,
                               drop_last=True, seed=args.seed)
    test_loader = make_loader(test_ds, ["points", "seg"],
                              batch_size=args.test_batch_size, shuffle=True,
                              seed=args.seed)
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

    best_test_iou = 0.0
    for epoch in range(args.epochs):
        train_loader.set_epoch(epoch)
        test_loader.set_epoch(epoch)
        meter = train_epoch(model, opt, train_loader, device, generator)
        io.cprint("Train %d, loss: %.6f, train acc: %.6f, train avg acc: "
                  "%.6f, train iou: %.6f"
                  % ((epoch, meter.mean_loss) + seg_metrics(meter)))
        meter = evaluate(model, test_loader, device)
        acc, avg, iou = seg_metrics(meter)
        io.cprint("Test %d, loss: %.6f, test acc: %.6f, test avg acc: %.6f, "
                  "test iou: %.6f" % (epoch, meter.mean_loss, acc, avg, iou))
        if iou >= best_test_iou:
            best_test_iou = iou
            save_model(f"outputs/{args.exp_name}/models/"
                       f"model_{args.test_area}.t7", model)
    return model, best_test_iou


def run_test(args, io: IOStream, test_set, device) -> None:
    """The 6-fold evaluation of the JAX CLI (``test``): for each area of
    ``--test_area`` (``all``: 1-6) its ``model_<area>.t7`` from
    ``--model_root`` on ``test_set(area)``, a ``Test :: test area`` line,
    and with ``all`` the ``Overall Test`` line over every area's points."""
    if args.test_area is None:
        raise ValueError("--eval=True needs --test_area (1-6 or all)")
    areas = AREAS if args.test_area == "all" else [args.test_area]
    overall = MeterAccumulator()
    for area in areas:
        loader = make_loader(test_set(area), ["points", "seg"],
                             batch_size=args.test_batch_size, shuffle=True,
                             seed=args.seed)
        model = load_checkpoint(
            os.path.join(args.model_root, f"model_{area}.t7"),
            build_model(args, device))
        meter = evaluate(model, loader, device)
        io.cprint("Test :: test area: %s, test acc: %.6f, test avg acc: "
                  "%.6f, test iou: %.6f" % ((area,) + seg_metrics(meter)))
        for name in ("true", "pred", "true_seg", "pred_seg"):
            getattr(overall, name).extend(getattr(meter, name))
    if args.test_area == "all":
        io.cprint("Overall Test :: test acc: %.6f, test avg acc: %.6f, "
                  "test iou: %.6f" % seg_metrics(overall))


def train(args, io: IOStream):
    train_ds = S3DIS(args.num_points, "train", args.test_area)
    test_ds = S3DIS(args.num_points, "test", args.test_area)
    run_training(args, io, train_ds, test_ds, pick_device(args.no_cuda))


def test(args, io: IOStream):
    run_test(args, io, lambda area: S3DIS(args.num_points, "test", area),
             pick_device(args.no_cuda))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Point Cloud Semantic Segmentation")
    parser.add_argument("--exp_name", type=str, default="exp", metavar="N")
    parser.add_argument("--model", type=str, default="dgcnn", metavar="N",
                        choices=["dgcnn"])
    parser.add_argument("--dataset", type=str, default="S3DIS", metavar="N",
                        choices=["S3DIS"])
    parser.add_argument("--test_area", type=str, default=None, metavar="N",
                        choices=AREAS + ["all"])
    parser.add_argument("--batch_size", type=int, default=32,
                        metavar="batch_size")
    parser.add_argument("--test_batch_size", type=int, default=16,
                        metavar="batch_size")
    parser.add_argument("--epochs", type=int, default=100, metavar="N")
    parser.add_argument("--use_sgd", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=0.001, metavar="LR")
    parser.add_argument("--momentum", type=float, default=0.9, metavar="M")
    parser.add_argument("--scheduler", type=str, default="cos", metavar="N",
                        choices=["cos", "step"])
    parser.add_argument("--no_cuda", type=str2bool, default=False,
                        help="run on the CPU")
    parser.add_argument("--seed", type=int, default=1, metavar="S")
    parser.add_argument("--eval", type=str2bool, default=False)
    parser.add_argument("--num_points", type=int, default=4096)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--emb_dims", type=int, default=1024, metavar="N")
    parser.add_argument("--k", type=int, default=20, metavar="N")
    parser.add_argument("--model_root", type=str, default="", metavar="N")
    parser.add_argument("--fast_extract", type=band_arg, default=None,
                        metavar="BAND",
                        help="eval forwards (a training run's test passes "
                             "too) with each point's kNN candidates pruned "
                             "to a PC1-sorted band of this width (a "
                             "positive multiple of 128; 0 = exact even if "
                             "DGCNN_TPU_FAST_EXTRACT is set; unset = that "
                             "variable, else exact)")
    return parser


@contextlib.contextmanager
def extract_pin():
    """``DGCNN_TPU_EXTRACT=v2`` for the block, as the JAX CLI pins it: S3DIS
    blocks are sampled with replacement, so they repeat points, and the
    eval kernels' packed member-by-member extraction (v2) keeps a
    duplicate's neighbourhood torch's (lowest index first) where v3 would
    average tied classes.  A value the user set wins; the variable is as
    it was afterwards, so that other entry points called in the same
    process run their own variants."""
    had = EXTRACT_ENV in os.environ
    os.environ.setdefault(EXTRACT_ENV, "v2")
    try:
        yield
    finally:
        if not had:
            os.environ.pop(EXTRACT_ENV, None)


def main(argv=None):
    args = build_parser().parse_args(argv)
    init_output_dir(args.exp_name, __file__)
    io = IOStream("outputs/" + args.exp_name + "/run.log")
    io.cprint(str(args))
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    with extract_pin():
        if not args.eval:
            train(args, io)
        else:
            test(args, io)


if __name__ == "__main__":
    main()
