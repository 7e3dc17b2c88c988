"""Optimizers and the train/eval steps of classification and
segmentation (port of dgcnn_tpu/train/engine.py: ``make_optimizer``,
``make_cls_steps``, ``make_seg_steps``).

The JAX package's optax chains map onto torch's optimizers with the same
weight-decay coupling: SGD is ``add_decayed_weights(1e-4)`` -> momentum
trace -> learning rate, i.e. ``torch.optim.SGD(momentum,
weight_decay=1e-4)``; Adam is ``add_decayed_weights(1e-4)`` -> Adam ->
learning rate, i.e. ``torch.optim.Adam(weight_decay=1e-4)``; AdamW is
``optax.adamw(weight_decay=1e-4)``, decoupled, i.e.
``torch.optim.AdamW(weight_decay=1e-4)``.  As optax's
``scale_by_learning_rate(schedule)`` and ``inject_hyperparams`` do, the
optimizer reads the learning rate and momentum schedules at its own
update count before each update.  ``grad_accum`` is ``optax.MultiSteps``:
the running mean of k micro-batch gradients, then one update.
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
    """A torch optimizer whose learning rate is ``schedule(step)`` and,
    with a ``momentum_schedule``, whose SGD momentum (Adam's beta1) is
    ``momentum_schedule(step)`` at each update, ``step`` counting the
    updates taken.  With ``grad_accum`` k > 1 a call of ``step`` takes one
    micro-batch: the k-th call updates with the mean of the k gradients
    (optax.MultiSteps), the others only accumulate."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 momentum_schedule: Callable[[int], float] | None = None,
                 grad_accum: int = 1):
        self.optimizer = optimizer
        self.schedule = schedule
        self.momentum_schedule = momentum_schedule
        self.grad_accum = grad_accum
        self.step_count = 0
        self.micro = 0     # micro-batches accumulated for the next update
        self.acc: list[torch.Tensor | None] = []

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return float(self.schedule(self.step_count))

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def _accumulate(self) -> bool:
        """Folds this micro-batch's gradients into the running mean; True
        when the mean is in the gradients and an update is due."""
        params = self._params()
        if not self.acc:
            self.acc = [None] * len(params)
        self.micro += 1
        for j, p in enumerate(params):
            if p.grad is None:
                continue
            if self.acc[j] is None:
                self.acc[j] = torch.zeros_like(p.grad)
            self.acc[j].add_((p.grad - self.acc[j]) / self.micro)
        if self.micro < self.grad_accum:
            return False
        for p, a in zip(params, self.acc):
            p.grad = a
        self.acc, self.micro = [], 0
        return True

    def step(self) -> None:
        if self.grad_accum > 1 and not self._accumulate():
            return
        m = (None if self.momentum_schedule is None
             else float(self.momentum_schedule(self.step_count)))
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
            if m is not None and "betas" in group:
                group["betas"] = (m, group["betas"][1])
            elif m is not None:
                group["momentum"] = m
        self.optimizer.step()
        self.step_count += 1

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "step": self.step_count, "micro": self.micro,
                "acc": list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])
        self.micro = int(state.get("micro", 0))
        self.acc = list(state.get("acc", []))


WEIGHT_DECAY = 1e-4


def make_optimizer(params, *, use_sgd: bool, schedule: Callable[[int], float],
                   momentum: float = 0.9, adamw: bool = False,
                   grad_accum: int = 1,
                   momentum_schedule: Callable[[int], float] | None = None
                   ) -> ScheduledOptimizer:
    """The reference's optimizers: SGD(momentum, wd 1e-4) or Adam(wd 1e-4),
    L2-coupled, or with ``adamw`` (and not ``use_sgd``) AdamW(wd 1e-4),
    decoupled; the learning rate from ``schedule`` (which carries the x100
    of SGD, schedules.make_schedule), the momentum (beta1) from
    ``momentum_schedule`` when one is given, and ``grad_accum``
    micro-batches an update."""
    params = list(params)
    if use_sgd:
        opt = torch.optim.SGD(params, lr=0.0, momentum=momentum,
                              weight_decay=WEIGHT_DECAY)
    elif adamw:
        opt = torch.optim.AdamW(params, lr=0.0, weight_decay=WEIGHT_DECAY)
    else:
        opt = torch.optim.Adam(params, lr=0.0, weight_decay=WEIGHT_DECAY)
    return ScheduledOptimizer(opt, schedule, momentum_schedule, grad_accum)


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


def make_seg_steps(with_label: bool = False):
    """(train_step, eval_step) for segmentation models, with per-point
    logits (B, N, classes) and the label-smoothed cross entropy over all
    points.  Models take (points,) (DGCNNSemSeg) or, ``with_label``,
    (points, category one-hot) (DGCNNPartSeg).

    ``train_step(model, opt, points, [one_hot,] seg, generator=None)``:
    forward in training mode (dropout drawn from ``generator``), loss,
    backward and one optimizer step -> {"loss", "preds"}.
    ``eval_step(model, points, [one_hot,] seg, mask=None)``: eval forward
    -> {"loss": the mean over the rows where ``mask`` is True, "preds"}."""

    def _train(model, opt: ScheduledOptimizer, inputs, seg, generator):
        logits = model(*inputs, train=True, generator=generator)
        loss = cross_entropy(logits, seg)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "preds": logits.detach().argmax(-1)}

    @torch.no_grad()
    def _eval(model, inputs, seg, mask):
        logits = model(*inputs)
        return {"loss": masked_mean_loss(
                    cross_entropy_per_example(logits, seg), mask),
                "preds": logits.argmax(-1)}

    if with_label:
        def train_step(model, opt, points, one_hot, seg, generator=None):
            return _train(model, opt, (points, one_hot), seg, generator)

        def eval_step(model, points, one_hot, seg, mask=None):
            return _eval(model, (points, one_hot), seg, mask)
    else:
        def train_step(model, opt, points, seg, generator=None):
            return _train(model, opt, (points,), seg, generator)

        def eval_step(model, points, seg, mask=None):
            return _eval(model, (points,), seg, mask)

    return train_step, eval_step
