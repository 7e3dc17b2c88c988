"""Checkpoints (port of dgcnn_tpu/train/checkpoint.py in torch's format).

* ``save_model``/``load_model``: the bare model in the reference
  state-dict layout (``model.cls.1024.t7``), written with ``torch.save``;
  ``convert.load_checkpoint`` reads it, as it reads a reference ``.t7``.
* ``save_train_checkpoint``/``load_train_checkpoint``: ``{epoch, step,
  micro, acc, state_dict, optimizer, loss}``, enough to resume, the
  schedule's step and a gradient accumulation in progress included.
  ``convert.load_checkpoint`` reads its ``state_dict`` into a model.

Files are read with ``torch.load(weights_only=True)``.  Flax ``.msgpack``
checkpoints are not read yet (see ROADMAP.md).
"""
from __future__ import annotations

import os

import torch

from dgcnn_tpu_torch.convert import load_checkpoint


def _host_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_model(path: str, model: torch.nn.Module) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_host_state(model), path)


def load_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    return load_checkpoint(path, model)


def save_train_checkpoint(path: str, model: torch.nn.Module, opt, epoch: int,
                          loss: float) -> None:
    """``opt``: an ``engine.ScheduledOptimizer``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = opt.state_dict()
    torch.save({"epoch": int(epoch), "step": state["step"],
                "micro": state["micro"], "acc": state["acc"],
                "state_dict": _host_state(model),
                "optimizer": state["optimizer"], "loss": float(loss)}, path)


def load_train_checkpoint(path: str, model: torch.nn.Module,
                          opt) -> tuple[int, float]:
    """Restore ``model`` and ``opt`` in place -> (epoch, loss)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"], strict=True)
    opt.load_state_dict({key: payload[key] for key in (
        "optimizer", "step", "micro", "acc") if key in payload})
    return int(payload["epoch"]), float(payload["loss"])
