"""Optimizers and the train/eval steps of classification and semantic
segmentation (port of dgcnn_tpu/train/engine.py: ``make_optimizer``,
``make_cls_steps``, ``make_seg_steps`` for models taking the points
only).

The JAX package's optax chains map onto torch's optimizers with the same
L2 coupling: SGD is ``add_decayed_weights(1e-4)`` -> momentum trace ->
learning rate, i.e. ``torch.optim.SGD(momentum, weight_decay=1e-4)``;
Adam is ``add_decayed_weights(1e-4)`` -> Adam -> learning rate, i.e.
``torch.optim.Adam(weight_decay=1e-4)``.  As optax's
``scale_by_learning_rate(schedule)`` does, the optimizer reads the
schedule at its own step count before each step.
"""
from __future__ import annotations

from typing import Callable

import torch

from dgcnn_tpu_torch.train.loss import (
    cross_entropy,
    cross_entropy_per_example,
    masked_mean_loss,
)


class ScheduledOptimizer:
    """A torch optimizer whose learning rate is ``schedule(step)`` at each
    step, ``step`` counting the steps taken."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.step_count = 0

    @property
    def lr(self) -> float:
        """The learning rate of the next step."""
        return float(self.schedule(self.step_count))

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        self.optimizer.step()
        self.step_count += 1

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])


WEIGHT_DECAY = 1e-4


def make_optimizer(params, *, use_sgd: bool, schedule: Callable[[int], float],
                   momentum: float = 0.9) -> ScheduledOptimizer:
    """The reference's optimizers: SGD(momentum, wd 1e-4) or Adam(wd 1e-4),
    L2-coupled, the learning rate from ``schedule`` (which carries the x100
    of SGD, schedules.make_schedule)."""
    params = list(params)
    if use_sgd:
        opt = torch.optim.SGD(params, lr=0.0, momentum=momentum,
                              weight_decay=WEIGHT_DECAY)
    else:
        opt = torch.optim.Adam(params, lr=0.0, weight_decay=WEIGHT_DECAY)
    return ScheduledOptimizer(opt, schedule)


def make_cls_steps():
    """(train_step, eval_step) for classification models taking (points,),
    with the label-smoothed cross entropy.

    ``train_step(model, opt, points, labels, generator=None)``: forward in
    training mode (dropout drawn from ``generator``), loss, backward and
    one optimizer step -> {"loss", "preds"}.
    ``eval_step(model, points, labels)``: eval forward -> {"loss",
    "preds"}."""

    def train_step(model, opt: ScheduledOptimizer, points: torch.Tensor,
                   labels: torch.Tensor,
                   generator: torch.Generator | None = None) -> dict:
        logits = model(points, train=True, generator=generator)
        loss = cross_entropy(logits, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "preds": logits.detach().argmax(-1)}

    @torch.no_grad()
    def eval_step(model, points: torch.Tensor, labels: torch.Tensor) -> dict:
        logits = model(points)
        return {"loss": cross_entropy(logits, labels),
                "preds": logits.argmax(-1)}

    return train_step, eval_step


def make_seg_steps():
    """(train_step, eval_step) for segmentation models taking (points,)
    (DGCNNSemSeg), with per-point logits (B, N, classes) and the
    label-smoothed cross entropy over all points.

    ``train_step(model, opt, points, seg, generator=None)``: forward in
    training mode (dropout drawn from ``generator``), loss, backward and
    one optimizer step -> {"loss", "preds"}.
    ``eval_step(model, points, seg, mask=None)``: eval forward -> {"loss":
    the mean over the rows where ``mask`` is True, "preds"}."""

    def train_step(model, opt: ScheduledOptimizer, points: torch.Tensor,
                   seg: torch.Tensor,
                   generator: torch.Generator | None = None) -> dict:
        logits = model(points, train=True, generator=generator)
        loss = cross_entropy(logits, seg)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "preds": logits.detach().argmax(-1)}

    @torch.no_grad()
    def eval_step(model, points: torch.Tensor, seg: torch.Tensor,
                  mask: torch.Tensor | None = None) -> dict:
        logits = model(points)
        return {"loss": masked_mean_loss(
                    cross_entropy_per_example(logits, seg), mask),
                "preds": logits.argmax(-1)}

    return train_step, eval_step
