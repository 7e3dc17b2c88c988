"""Checkpoints for the port's models.

* ``state_dict_from_flax``: flax ``DGCNNCls``/``PointNet``/``DGCNNSemSeg``
  variables (as numpy) -> the reference state dict, the port's own copy of
  the ``_put_*`` logic of ``dgcnn_tpu/convert/torch_export.py`` (Dense
  kernels (Ci, Co) -> weights (Co, Ci[, 1[, 1]]); EdgeConv
  ``w_nbr``/``w_ctr`` re-joined in the [neighbour, centre] order; BN
  scale/bias + batch_stats -> weight/bias + running stats).
* ``load_checkpoint``: a reference ``.t7`` state dict into a model.

Flax ``.msgpack`` checkpoints are not read yet (see ROADMAP.md).
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _put_dense(sd, prefix: str, tree: dict, dims: int = 0) -> None:
    w = np.asarray(tree["kernel"]).T
    sd[prefix + ".weight"] = _t(w.reshape(w.shape + (1,) * dims))
    if "bias" in tree:
        sd[prefix + ".bias"] = _t(tree["bias"])


def _put_bn(sd, prefix: str, params: dict, stats: dict) -> None:
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _put_edgeconv(sd, name: str, p: dict, s: dict) -> None:
    w = np.concatenate([np.asarray(p["w_nbr"]).T, np.asarray(p["w_ctr"]).T],
                       axis=1)                                    # (Co, 2C)
    sd[name + ".0.weight"] = _t(w.reshape(w.shape + (1, 1)))
    _put_bn(sd, name + ".1", {"scale": p["scale"], "bias": p["bias"]}, s)


def _put_convbn(sd, name: str, p: dict, s: dict, dims: int) -> None:
    _put_dense(sd, name + ".0", p["conv"], dims)
    _put_bn(sd, name + ".1", p["bn"], s["bn"])


def state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of a flax ``DGCNNCls``,
    ``PointNet`` or ``DGCNNSemSeg`` -> the reference state dict of the
    port's model."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    if "conv9" in params:                                         # DGCNNSemSeg
        for name in ["conv1", "conv3", "conv5"]:
            _put_edgeconv(sd, name, params[name], stats[name])
        for name, dims in [("conv2", 2), ("conv4", 2), ("conv6", 1),
                           ("conv7", 1), ("conv8", 1)]:
            _put_convbn(sd, name, params[name], stats[name], dims)
        _put_dense(sd, "conv9", params["conv9"], dims=1)
        return sd
    if "w_nbr" in params["conv1"]:                                # DGCNNCls
        for name in ["conv1", "conv2", "conv3", "conv4"]:
            _put_edgeconv(sd, name, params[name], stats[name])
        _put_convbn(sd, "conv5", params["conv5"], stats["conv5"], dims=1)
        _put_dense(sd, "linear1", params["linear1"]["linear"])
        _put_bn(sd, "bn6", params["linear1"]["bn"], stats["linear1"]["bn"])
        _put_dense(sd, "linear2", params["linear2"])
        _put_bn(sd, "bn7", params["bn7"], stats["bn7"])
        _put_dense(sd, "linear3", params["linear3"])
        return sd
    for i in range(1, 6):                                         # PointNet
        _put_dense(sd, f"conv{i}", params[f"conv{i}"], dims=1)
        _put_bn(sd, f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    _put_dense(sd, "linear1", params["linear1"])
    _put_bn(sd, "bn6", params["bn6"], stats["bn6"])
    _put_dense(sd, "linear2", params["linear2"])
    return sd


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.t7`` state dict into ``model``, strictly.

    Strips DataParallel's ``module.`` prefix.  Upstream DGCNN_cls registers
    its BatchNorms twice (``bnI`` and ``convI.1`` over shared storage), so
    a ``bnI.*`` key whose ``convI.1.*`` twin is present is dropped first."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in obj.items()}
    for key in list(sd):
        m = re.fullmatch(r"bn(\d+)\.(.+)", key)
        if m and f"conv{m.group(1)}.1.{m.group(2)}" in sd:
            del sd[key]
    model.load_state_dict(sd, strict=True)
    return model
