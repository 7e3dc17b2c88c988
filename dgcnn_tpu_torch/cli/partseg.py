"""ShapeNetPart part segmentation CLI (port of dgcnn_tpu/cli/partseg.py):
training and evaluation of the canonical DGCNN (``--model dgcnn``) and of
the fork's fusion Net (``--model transformer``, the parser's default:
DGCNN + HOG + ``torch.nn.Transformer``, dropout ``--dropout`` on its
attention probabilities, feed-forward, residual branches and head).
Both models' evals and the canonical DGCNN's training take the JAX
package's mode as the models resolve it (``amp`` None): AMP (bf16) on
the card unless ``DGCNN_TPU_PALLAS_EXACT`` is set, exact on the CPU; the
fusion Net trains exact f32.  No flag, as the JAX CLI has none.

The JAX CLI's parser and defaults, apart from its runtime flags; the
options the port does not have yet are refused by the parser with a
message: ``--use_custom_attention``, a ``--fast_extract`` band with the
fusion Net, ``--device_pipeline``, ``--export_model`` and ``--visu``.  The
same ``Train %d, ...``, ``Test %d, ...`` and ``Test: ...`` lines.
Training keeps a resumable checkpoint at
``outputs/<exp>/checkpoints/ckpt.checkpoint`` and the best test IoU's at
``outputs/<exp>/models/transformer_<epoch>.checkpoint`` (the reference's
naming), in torch's format; evaluation loads ``--model_path`` from under
``outputs/<exp>/`` first (the reference's quirk), else as given: a
reference ``.t7`` / ``transformer.pt`` (``module.`` prefixes and all) or
such a checkpoint.  ``--fast_extract BAND`` runs the DGCNN's eval forwards
(a training run's test passes too) through the banded kernels.

    python -m dgcnn_tpu_torch.cli.partseg --model dgcnn --k 40 \
        --emb_dim 1024 --exp_name=part
    python -m dgcnn_tpu_torch.cli.partseg --model dgcnn --k 40 \
        --emb_dim 1024 --exp_name=part --eval=True \
        --model_path=models/transformer_199.checkpoint [--fast_extract 512]
    python -m dgcnn_tpu_torch.cli.partseg --model transformer --k 32 \
        --n_heads 2 --n_blocks 2 --exp_name=net
    python -m dgcnn_tpu_torch.cli.partseg --model transformer --eval=True \
        --k 32 --n_heads 2 --n_blocks 2 --model_path=transformer.pt
"""
from __future__ import annotations

import argparse
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
from dgcnn_tpu_torch.data import (
    ShapeNetPart,
    ShapeNetPartAugmented,
    make_loader,
)
from dgcnn_tpu_torch.models import DGCNNPartSeg, Net, init_like_flax_
from dgcnn_tpu_torch.train import (
    accuracy_score,
    balanced_accuracy_score,
    calculate_shape_IoU,
    load_train_checkpoint,
    make_momentum_schedule,
    make_optimizer,
    make_schedule,
    make_seg_steps,
    save_train_checkpoint,
)
from dgcnn_tpu_torch.utils import IOStream

NUM_CATEGORIES = 16
FIELDS = ["points", "label", "seg"]


def build_model(args, device):
    if args.model == "transformer":
        return Net(emb_dim=args.emb_dim, k=args.k, n_heads=args.n_heads,
                   n_blocks=args.n_blocks, ff_dims=args.ff_dims,
                   nclasses=args.nclasses, dropout=args.dropout,
                   device=device)
    return DGCNNPartSeg(emb_dims=args.emb_dim, k=args.k, dropout=args.dropout,
                        seg_num_all=args.nclasses,
                        band=resolve_band(args.fast_extract, args.num_points),
                        device=device)


def one_hot_categories(label: np.ndarray) -> np.ndarray:
    out = np.zeros((label.shape[0], NUM_CATEGORIES), np.float32)
    out[np.arange(label.shape[0]), np.ravel(label)] = 1
    return out


def part_metrics(meter: MeterAccumulator,
                 class_choice: str | None) -> tuple[float, float, float]:
    """(accuracy, balanced accuracy, mean shape IoU) of the meter's
    shapes."""
    t, p = meter.concat()
    ts, ps = meter.concat_seg()
    ious = calculate_shape_IoU(ps, ts, meter.concat_labels(), class_choice)
    return (accuracy_score(t, p), balanced_accuracy_score(t, p),
            float(np.mean(ious)))


def _inputs(batch: dict, seg_start_index: int, device):
    """(points, category one-hot, part labels from 0) of a batch on
    ``device``, and the part labels on the host."""
    seg = batch["seg"] - seg_start_index
    return ((torch.from_numpy(batch["points"]).to(device),
             torch.from_numpy(one_hot_categories(batch["label"])).to(device),
             torch.from_numpy(seg).to(device)), seg)


def evaluate(model, loader, device, seg_start_index: int) -> MeterAccumulator:
    """The eval loop over ``loader``'s padded batches: per-point argmax
    predictions and the smoothed cross entropy of the real rows."""
    _, eval_step = make_seg_steps(with_label=True)
    meter = MeterAccumulator()
    for batch in loader:
        tensors, seg = _inputs(batch, seg_start_index, device)
        m = eval_step(model, *tensors,
                      torch.from_numpy(batch["mask"]).to(device))
        meter.add_seg(m["loss"].item(), m["preds"].cpu().numpy(), seg,
                      batch["mask"], labels=batch["label"])
    return meter


def train_epoch(model, opt, loader, device, generator: torch.Generator,
                seg_start_index: int) -> MeterAccumulator:
    """One pass of the train loop over ``loader``'s batches: one optimizer
    step (micro-batch under --grad_accum) each, dropout drawn from
    ``generator``."""
    train_step, _ = make_seg_steps(with_label=True)
    meter = MeterAccumulator()
    for batch in loader:
        tensors, seg = _inputs(batch, seg_start_index, device)
        m = train_step(model, opt, *tensors, generator)
        meter.add_seg(m["loss"].item(), m["preds"].cpu().numpy(), seg,
                      batch["mask"], labels=batch["label"])
    return meter


def run_training(args, io: IOStream, train_ds, test_ds, device):
    """The train loop of the JAX CLI (dgcnn_tpu/cli/partseg.py ``train``)
    over the datasets given: flax-like initialization from ``--seed``, the
    optimizer with the cycled momentum of ``--scheduler cycle``, resume
    from ``ckpt.checkpoint`` with ``--resume``, one ``Train`` and one
    ``Test`` line an epoch, the best test IoU's checkpoint so far saved as
    ``transformer_<epoch>.checkpoint``.  Returns (model, best test
    IoU)."""
    seg_start_index = getattr(train_ds, "seg_start_index", 0)
    if args.class_choice and hasattr(train_ds, "seg_num_all"):
        args.nclasses = train_ds.seg_num_all
    train_loader = make_loader(train_ds, FIELDS, batch_size=args.batch_size,
                               shuffle=True, drop_last=len(train_ds) >= 100,
                               seed=args.seed)
    test_loader = make_loader(test_ds, FIELDS,
                              batch_size=args.test_batch_size, shuffle=True,
                              seed=args.seed)
    io.cprint(f"Using 1 device(s): {torch.device(device).type}")
    model = build_model(args, "cpu")
    init_like_flax_(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    steps = len(train_loader)
    opt = make_optimizer(
        model.parameters(), use_sgd=args.use_sgd,
        schedule=make_schedule(args.scheduler, args.lr, epochs=args.epochs,
                               steps_per_epoch=steps, use_sgd=args.use_sgd),
        momentum=args.momentum, adamw=True, grad_accum=args.grad_accum,
        momentum_schedule=make_momentum_schedule(
            args.scheduler, epochs=args.epochs, steps_per_epoch=steps))
    ckpt_path = f"outputs/{args.exp_name}/checkpoints/ckpt.checkpoint"
    start_epoch = 0
    if args.resume and os.path.isfile(ckpt_path):
        start_epoch, _ = load_train_checkpoint(ckpt_path, model, opt)
        io.cprint(f"Resumed from {ckpt_path} at epoch {start_epoch}")
    generator = torch.Generator(device=device).manual_seed(args.seed)

    best_test_iou = 0.0
    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        test_loader.set_epoch(epoch)
        meter = train_epoch(model, opt, train_loader, device, generator,
                            seg_start_index)
        io.cprint("Train %d, loss: %.6f, train acc: %.6f, train avg acc: "
                  "%.6f, train iou: %.6f"
                  % ((epoch, meter.mean_loss)
                     + part_metrics(meter, args.class_choice)))
        meter = evaluate(model, test_loader, device, seg_start_index)
        acc, avg, iou = part_metrics(meter, args.class_choice)
        io.cprint("Test %d, loss: %.6f, test acc: %.6f, test avg acc: %.6f, "
                  "test iou: %.6f" % (epoch, meter.mean_loss, acc, avg, iou))
        if iou >= best_test_iou:
            best_test_iou = iou
            save_train_checkpoint(
                f"outputs/{args.exp_name}/models/transformer_{epoch}"
                ".checkpoint", model, opt, epoch, meter.mean_loss)
        save_train_checkpoint(ckpt_path, model, opt, epoch, meter.mean_loss)
    return model, best_test_iou


def run_test(args, io: IOStream, test_ds, device) -> None:
    """The JAX CLI's ``test``: ``--model_path`` under ``outputs/<exp>/``
    (else as given) on ``test_ds``, one ``Test:`` line."""
    loader = make_loader(test_ds, FIELDS, batch_size=args.test_batch_size,
                         shuffle=True, seed=args.seed)
    model_path = f"outputs/{args.exp_name}/{args.model_path}"
    if not os.path.exists(model_path):
        model_path = args.model_path
    model = load_checkpoint(model_path, build_model(args, device))
    meter = evaluate(model, loader, device,
                     getattr(test_ds, "seg_start_index", 0))
    io.cprint("Test: test acc: %.6f, test avg acc: %.6f, test iou: %.6f"
              % part_metrics(meter, args.class_choice))


def train(args, io: IOStream):
    if args.dataset == "shapenetpart_aug":
        train_ds = ShapeNetPartAugmented("trainval")
        test_ds = ShapeNetPartAugmented("test")
    else:
        train_ds = ShapeNetPart(args.num_points, "trainval", args.class_choice)
        test_ds = ShapeNetPart(args.num_points, "test", args.class_choice)
    run_training(args, io, train_ds, test_ds, pick_device(args.no_cuda))


def test(args, io: IOStream):
    run_test(args, io, ShapeNetPart(args.num_points, "test",
                                    args.class_choice),
             pick_device(args.no_cuda))


class _Parser(argparse.ArgumentParser):
    """Refuses the options the port does not have yet, with a message."""

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        if ns.model == "transformer":
            if resolve_band(ns.fast_extract):
                self.error("--fast_extract (or DGCNN_TPU_FAST_EXTRACT) with "
                           "--model transformer is not ported yet: the "
                           "fusion Net runs exactly")
        if ns.use_custom_attention:
            self.error("--use_custom_attention is not ported yet")
        for flag in ("device_pipeline", "export_model", "visu"):
            if getattr(ns, flag):
                self.error(f"--{flag} is not ported yet")
        return ns


def build_parser() -> argparse.ArgumentParser:
    parser = _Parser(description="Point Cloud Part Segmentation")
    parser.add_argument("--exp_name", type=str, default="exp", metavar="N")
    parser.add_argument("--model", type=str, default="transformer",
                        metavar="N", choices=["dgcnn", "transformer"])
    parser.add_argument("--dataset", type=str, default="shapenetpart",
                        metavar="N",
                        choices=["shapenetpart", "shapenetpart_aug"])
    parser.add_argument("--class_choice", type=str, default=None, metavar="N",
                        choices=list(ShapeNetPart.CAT2ID))
    parser.add_argument("--batch_size", type=int, default=32,
                        metavar="batch_size")
    parser.add_argument("--test_batch_size", type=int, default=16,
                        metavar="batch_size")
    parser.add_argument("--epochs", type=int, default=200, metavar="N")
    parser.add_argument("--use_sgd", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=0.001, metavar="LR")
    parser.add_argument("--momentum", type=float, default=0.9, metavar="M")
    parser.add_argument("--scheduler", type=str, default="cycle", metavar="N",
                        choices=["cos", "step", "cycle"])
    parser.add_argument("--use_custom_attention", action="store_true")
    parser.add_argument("--no_cuda", type=str2bool, default=False,
                        help="run on the CPU")
    parser.add_argument("--seed", type=int, default=1, metavar="S")
    parser.add_argument("--ff_dims", type=int, default=512)
    parser.add_argument("--n_heads", type=int, default=1)
    parser.add_argument("--n_blocks", type=int, default=1)
    parser.add_argument("--d_qkv", type=int, default=64)
    parser.add_argument("--eval", type=str2bool, default=False)
    parser.add_argument("--num_points", type=int, default=2048)
    parser.add_argument("--nclasses", type=int, default=50)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--emb_dim", type=int, default=512, metavar="N")
    parser.add_argument("--k", type=int, default=20, metavar="N")
    parser.add_argument("--model_path", type=str,
                        default="models/transformer.pt", metavar="N")
    parser.add_argument("--visu", type=str, default="")
    parser.add_argument("--visu_format", type=str, default="ply")
    parser.add_argument("--resume", type=str2bool, default=False)
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="gradient accumulation steps")
    parser.add_argument("--export_model", type=str, default="",
                        metavar="PATH")
    parser.add_argument("--export_poly_batch", type=str2bool, default=False)
    parser.add_argument("--fast_extract", type=band_arg, default=None,
                        metavar="BAND",
                        help="eval forwards (a training run's test passes "
                             "too) with each point's kNN candidates pruned "
                             "to a PC1-sorted band of this width (a "
                             "positive multiple of 128; 0 = exact even if "
                             "DGCNN_TPU_FAST_EXTRACT is set; unset = that "
                             "variable, else exact)")
    parser.add_argument("--device_pipeline", type=str2bool, default=False)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    init_output_dir(args.exp_name, __file__)
    io = IOStream("outputs/" + args.exp_name + "/run.log")
    io.cprint(str(args))
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if args.eval:
        test(args, io)
    else:
        train(args, io)


if __name__ == "__main__":
    main()
