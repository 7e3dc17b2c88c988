"""Shared CLI plumbing (the parts of dgcnn_tpu/cli/common.py the cls,
partseg and semseg CLIs need).  Boolean flags parse "true/false/1/0"
properly, unlike the reference's ``type=bool``."""
from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def band_arg(v: str) -> int:
    """argparse type of ``--fast_extract``: 0 (exact) or a positive
    multiple of 128, a band the banded kernels take."""
    try:
        band = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(f"integer band expected, got {v!r}")
    if band < 0 or band % 128:
        raise argparse.ArgumentTypeError(
            f"band must be 0 (exact) or a positive multiple of 128, "
            f"got {band}")
    return band


def resolve_band(flag: int | None, num_points: int = 0) -> int:
    """The band of the eval forwards (the JAX package's
    ``fast_extract_pin`` precedence): ``--fast_extract`` when it is given,
    0 forcing the exact path; otherwise ``DGCNN_TPU_FAST_EXTRACT`` (0 when
    unset or not an integer).  A band of at least ``num_points`` prunes
    nothing: the models then run the exact kernels, with a warning.  Sets
    no environment variable."""
    if flag is None:
        try:
            band = int(os.environ.get("DGCNN_TPU_FAST_EXTRACT", "0"))
        except ValueError:
            band = 0
    else:
        band = flag
    if band and num_points and band >= num_points:
        print(f"WARNING: --fast_extract={band} >= num_points={num_points}: "
              f"banding cannot prune anything; running the exact path",
              file=sys.stderr)
    return band


def init_output_dir(exp_name: str, entry_file: str) -> str:
    """outputs/<exp>/{models,visualization,checkpoints} + a copy of the
    entry point's source (reference main_cls.py:32-42)."""
    exp_dir = os.path.join("outputs", exp_name)
    for sub in ["models", "visualization", "checkpoints"]:
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
    if os.path.exists(entry_file):
        shutil.copyfile(entry_file, os.path.join(
            exp_dir, os.path.basename(entry_file) + ".backup"))
    return exp_dir


def pick_device(no_cuda: bool = False) -> torch.device:
    """The CUDA card unless ``--no_cuda`` asks for the CPU; asking for CUDA
    on a host without it raises instead of falling back."""
    if no_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --no_cuda=True to "
                           "run on the CPU")
    return torch.device("cuda")


class MeterAccumulator:
    """Host-side loss and label/prediction accumulation of a train or eval
    loop, padded rows masked out."""

    def __init__(self):
        self.loss_sum = 0.0
        self.count = 0
        self.true: list[np.ndarray] = []
        self.pred: list[np.ndarray] = []
        self.true_seg: list[np.ndarray] = []
        self.pred_seg: list[np.ndarray] = []
        self.label_seg: list[np.ndarray] = []

    def add_cls(self, loss: float, preds: np.ndarray, labels: np.ndarray,
                mask: np.ndarray | None = None) -> None:
        """``loss``: the mean over the batch's real rows, those where
        ``mask`` is True (every row when it is None)."""
        if mask is None:
            mask = np.ones(len(labels), dtype=bool)
        real = int(mask.sum())
        self.loss_sum += float(loss) * real
        self.count += real
        self.true.append(np.asarray(labels)[mask])
        self.pred.append(np.asarray(preds)[mask])

    def add_seg(self, loss: float, preds: np.ndarray, seg: np.ndarray,
                mask: np.ndarray, labels: np.ndarray | None = None) -> None:
        """Per-point ``preds`` and labels ``seg`` (B, N) of a batch whose
        real rows are those where ``mask`` is True; ``loss`` is their
        mean.  The points count flat for accuracy and per block (shape)
        for the IoU, which for part segmentation needs each shape's
        category ``labels`` (B,)."""
        real = int(mask.sum())
        self.loss_sum += float(loss) * real
        self.count += real
        p = np.asarray(preds)[mask]
        t = np.asarray(seg)[mask]
        self.true.append(t.reshape(-1))
        self.pred.append(p.reshape(-1))
        self.true_seg.append(t)
        self.pred_seg.append(p)
        if labels is not None:
            self.label_seg.append(np.ravel(np.asarray(labels)[mask]))

    @property
    def mean_loss(self) -> float:
        return self.loss_sum / max(self.count, 1)

    def concat(self):
        return np.concatenate(self.true), np.concatenate(self.pred)

    def concat_seg(self):
        """(labels, predictions), each (blocks, N)."""
        return (np.concatenate(self.true_seg, 0),
                np.concatenate(self.pred_seg, 0))

    def concat_labels(self) -> np.ndarray:
        """The shapes' categories, (shapes,)."""
        return np.concatenate(self.label_seg)
