"""Shared CLI plumbing (the parts of dgcnn_tpu/cli/common.py the cls eval
needs).  Boolean flags parse "true/false/1/0" properly, unlike the
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
    """Host-side loss and label/prediction accumulation of an eval loop."""

    def __init__(self):
        self.loss_sum = 0.0
        self.count = 0
        self.true: list[np.ndarray] = []
        self.pred: list[np.ndarray] = []

    def add_cls(self, loss: float, preds: np.ndarray,
                labels: np.ndarray) -> None:
        n = len(labels)
        self.loss_sum += float(loss) * n
        self.count += n
        self.true.append(np.asarray(labels))
        self.pred.append(np.asarray(preds))

    @property
    def mean_loss(self) -> float:
        return self.loss_sum / max(self.count, 1)

    def concat(self):
        return np.concatenate(self.true), np.concatenate(self.pred)
