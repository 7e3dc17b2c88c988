"""Learning-rate schedules (port of the cls part of
dgcnn_tpu/train/schedules.py), each a pure function of the global step:

* cosine: CosineAnnealingLR(epochs, eta_min=1e-3), stepped per epoch;
* step: StepLR(20, 0.7) that stops decaying at 1e-5.

``one_cycle`` (partseg) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable


def cosine_annealing(base_lr: float, epochs: int, steps_per_epoch: int,
                     eta_min: float = 1e-3) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        return eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * epoch / epochs)) / 2

    return schedule


def step_decay(base_lr: float, steps_per_epoch: int, step_size: int = 20,
               gamma: float = 0.7,
               floor: float = 1e-5) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return max(base_lr * gamma ** (epoch // step_size), floor)

    return schedule


def make_schedule(name: str, base_lr: float, *, epochs: int,
                  steps_per_epoch: int,
                  use_sgd: bool = True) -> Callable[[int], float]:
    """The schedule a flag set selects, lr x100 under SGD (the reference's
    convention)."""
    lr = base_lr * 100 if use_sgd else base_lr
    if name == "cos":
        return cosine_annealing(lr, epochs, steps_per_epoch)
    if name == "step":
        return step_decay(lr, steps_per_epoch)
    raise ValueError(f"unknown or not yet ported scheduler {name!r}")
