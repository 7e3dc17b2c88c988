"""Shared CLI plumbing (the parts of dgcnn_tpu/cli/common.py the cls and
semseg CLIs need).  Boolean flags parse "true/false/1/0" properly, unlike the
reference's ``type=bool``."""
from __future__ import annotations

import argparse
import os
import shutil

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
                mask: np.ndarray) -> None:
        """Per-point ``preds`` and labels ``seg`` (B, N) of a batch whose
        real rows are those where ``mask`` is True; ``loss`` is their
        mean.  The points count flat for accuracy and per block for the
        IoU."""
        real = int(mask.sum())
        self.loss_sum += float(loss) * real
        self.count += real
        p = np.asarray(preds)[mask]
        t = np.asarray(seg)[mask]
        self.true.append(t.reshape(-1))
        self.pred.append(p.reshape(-1))
        self.true_seg.append(t)
        self.pred_seg.append(p)

    @property
    def mean_loss(self) -> float:
        return self.loss_sum / max(self.count, 1)

    def concat(self):
        return np.concatenate(self.true), np.concatenate(self.pred)

    def concat_seg(self):
        """(labels, predictions), each (blocks, N)."""
        return (np.concatenate(self.true_seg, 0),
                np.concatenate(self.pred_seg, 0))
