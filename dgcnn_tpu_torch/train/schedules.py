"""Learning-rate and momentum schedules (port of
dgcnn_tpu/train/schedules.py), each a pure function of the global step:

* cosine: CosineAnnealingLR(epochs, eta_min=1e-3), stepped per epoch;
* step: StepLR(20, 0.7) that stops decaying at 1e-5;
* one_cycle: OneCycleLR(max_lr, total_steps), stepped per batch, torch's
  defaults (pct_start 0.3, cosine annealing, div_factor 25,
  final_div_factor 1e4), and its momentum (or Adam's beta1) cycled
  against it, 0.95 -> 0.85 -> 0.95 (``cycle_momentum=True``).
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


def _one_cycle_phases(total_steps: int, pct_start: float):
    """torch's phase boundaries are floats (``float(pct_start * total) -
    1``, OneCycleLR._initial_step): at a small total no step lands on the
    peak, and the per-step values stay torch's at every scale."""
    up_steps = max(float(pct_start * total_steps) - 1, 1e-6)
    down_steps = max((total_steps - 1) - up_steps, 1e-6)
    return up_steps, down_steps


def _clip01(t: float) -> float:
    return min(max(t, 0.0), 1.0)


def one_cycle(max_lr: float, total_steps: int, pct_start: float = 0.3,
              div_factor: float = 25.0,
              final_div_factor: float = 1e4) -> Callable[[int], float]:
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps, down_steps = _one_cycle_phases(total_steps, pct_start)

    def schedule(step: int) -> float:
        step = min(step, total_steps - 1)
        if step <= up_steps:
            t = _clip01(step / up_steps)
            return initial_lr + (max_lr - initial_lr) * (
                1 - math.cos(math.pi * t)) / 2
        t = _clip01((step - up_steps) / down_steps)
        return max_lr + (min_lr - max_lr) * (1 - math.cos(math.pi * t)) / 2

    return schedule


def one_cycle_momentum(total_steps: int, base_momentum: float = 0.85,
                       max_momentum: float = 0.95,
                       pct_start: float = 0.3) -> Callable[[int], float]:
    """OneCycleLR's momentum: max -> base over the warm-up, base -> max
    over the decay, against the learning rate, on the same phases."""
    up_steps, down_steps = _one_cycle_phases(total_steps, pct_start)

    def schedule(step: int) -> float:
        step = min(step, total_steps - 1)
        if step <= up_steps:
            t = _clip01(step / up_steps)
            return base_momentum + (max_momentum - base_momentum) * (
                1 + math.cos(math.pi * t)) / 2
        t = _clip01((step - up_steps) / down_steps)
        return max_momentum + (base_momentum - max_momentum) * (
            1 + math.cos(math.pi * t)) / 2

    return schedule


def make_momentum_schedule(
        name: str, *, epochs: int,
        steps_per_epoch: int) -> Callable[[int], float] | None:
    """The momentum schedule of a scheduler flag: cycled under "cycle",
    None (the optimizer's constant momentum) otherwise.  The ``--momentum``
    flag does not feed the cycle: torch's OneCycleLR overwrites the
    optimizer's momentum with its own 0.95/0.85 every step."""
    if name == "cycle":
        return one_cycle_momentum(epochs * steps_per_epoch)
    return None


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
    if name == "cycle":
        return one_cycle(lr, epochs * steps_per_epoch)
    raise ValueError(f"unknown scheduler {name!r}")
