"""Checkpoints for the port's models.

* ``state_dict_from_flax``: flax ``DGCNNCls``/``PointNet``/
  ``DGCNNPartSeg``/``DGCNNSemSeg``/``Net`` variables (as numpy) -> the
  reference state dict, the port's own copy of the ``_put_*`` logic of
  ``dgcnn_tpu/convert/torch_export.py`` (Dense kernels (Ci, Co) -> weights
  (Co, Ci[, 1[, 1]]); EdgeConv ``w_nbr``/``w_ctr`` re-joined in the
  [neighbour, centre] order; BN scale/bias + batch_stats -> weight/bias +
  running stats; attention ``in_proj_*`` as they are, LayerNorm
  scale/bias -> weight/bias).  The TransformNet's ``bn1``-``bn3`` aliases
  of ``export_transform_net`` are left out: the port's model registers
  each BatchNorm once.  A ``Net`` with the custom vector-attention
  transformer (``use_custom_attention``; ``export_net`` has no branch for
  it, and no reference checkpoint holds one) maps its
  ``transformer/model/{encoder,decoder}_layer_{i}/...`` tree under the
  flax names: ``transformer.model.encoder_layer_0.self_attn.w_q.weight``,
  ``transformer.model.encoder_layer_0.sub0.norm.*``, ...
* ``load_checkpoint``: a reference ``.t7`` state dict (or a checkpoint
  holding one) into a model.

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


def _put_convbn(sd, name: str, p: dict, s: dict, dims: int,
                bn_name: str | None = None) -> None:
    """A ConvBN under ``name.0`` / ``name.1``, or, with ``bn_name``, under
    ``name`` / ``bn_name`` (slots of a reference Sequential)."""
    _put_dense(sd, name if bn_name else name + ".0", p["conv"], dims)
    _put_bn(sd, bn_name or name + ".1", p["bn"], s["bn"])


def _put_densebn(sd, lin_key: str, bn_key: str, p: dict, s: dict) -> None:
    _put_dense(sd, lin_key, p["linear"])
    _put_bn(sd, bn_key, p["bn"], s["bn"])


def _put_transform_net(sd, prefix: str, p: dict, s: dict) -> None:
    for name, dims in [("conv1", 2), ("conv2", 2), ("conv3", 1)]:
        _put_convbn(sd, prefix + name, p[name], s[name], dims)
    _put_densebn(sd, prefix + "linear.0", prefix + "linear.1", p["linear1"],
                 s["linear1"])
    _put_densebn(sd, prefix + "linear.3", prefix + "linear.4", p["linear2"],
                 s["linear2"])
    _put_dense(sd, prefix + "transform", p["transform"])


def _put_mha(sd, prefix: str, p: dict) -> None:
    sd[prefix + ".in_proj_weight"] = _t(p["in_proj_weight"])
    sd[prefix + ".in_proj_bias"] = _t(p["in_proj_bias"])
    _put_dense(sd, prefix + ".out_proj", p["out_proj"])


def _put_ln(sd, prefix: str, p: dict) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _put_tree(sd, prefix: str, params: dict, stats: dict) -> None:
    """A flax subtree under its own names: each Dense (``kernel``) as a
    Linear weight (Co, Ci) and bias, each BatchNorm (``scale``) with its
    statistics, every other level a module of that name (a raw parameter,
    as the grouped MLP's, as it is)."""
    if not isinstance(params, dict):
        sd[prefix] = _t(params)
    elif "kernel" in params:
        _put_dense(sd, prefix, params)
    elif "scale" in params and stats:
        _put_bn(sd, prefix, params, stats)
    elif "scale" in params:                          # gradients: no stats
        _put_ln(sd, prefix, params)
    else:
        for name, p in params.items():
            _put_tree(sd, f"{prefix}.{name}" if prefix else name, p,
                      stats.get(name, {}))


def module_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """The variables of one flax module of the custom transformer
    (``Transformer``, ``VectorAttention``, ``MultiHeadVectorAttention``,
    ``MultiHeadedAttention``, ...) -> the state dict of the port's module
    of the same name (``_put_tree``)."""
    sd: dict[str, torch.Tensor] = {}
    _put_tree(sd, "", variables["params"], variables.get("batch_stats", {}))
    return sd


def _put_net(sd, params: dict, stats: dict) -> None:
    """The fusion Net's tree -> ``export_net``'s keys (the
    PositionEmbedding's ``bnI`` aliases left out); the custom transformer
    under its flax names."""
    for name in ["conv1", "conv2", "conv3", "conv4"]:
        _put_edgeconv(sd, f"emb_nn.{name}", params["emb_nn"][name],
                      stats["emb_nn"][name])
    _put_convbn(sd, "emb_nn.conv5", params["emb_nn"]["conv5"],
                stats["emb_nn"]["conv5"], dims=2)
    for j in range(4):
        _put_convbn(sd, f"grads_emb.{3 * j}", params[f"grads_emb_{j}"],
                    stats[f"grads_emb_{j}"], 1, f"grads_emb.{3 * j + 1}")
    _put_transform_net(sd, "pos_mlp.0.", params["pos_embed"]["tnet"],
                       stats["pos_embed"]["tnet"])
    _put_convbn(sd, "pos_mlp.1", params["pos_conv"], stats["pos_conv"], 1,
                "pos_mlp.2")
    xf = params["transformer"]
    if "model" in xf:                                 # use_custom_attention
        _put_tree(sd, "transformer.model", xf["model"],
                  stats["transformer"]["model"])
    layers = {} if "model" in xf else {
        "encoder": ["self_attn"], "decoder": ["self_attn", "multihead_attn"]}
    for stack, attns in layers.items():
        for i in range(sum(key.startswith(stack) for key in xf) - 1):
            p, lp = xf[f"{stack}_layer_{i}"], f"transformer.{stack}.layers.{i}"
            for attn in attns:
                _put_mha(sd, f"{lp}.{attn}", p[attn])
            _put_dense(sd, f"{lp}.linear1", p["ff"]["linear1"])
            _put_dense(sd, f"{lp}.linear2", p["ff"]["linear2"])
            for j in range(len(attns) + 1):
                _put_ln(sd, f"{lp}.norm{j + 1}", p[f"norm{j + 1}"])
        _put_ln(sd, f"transformer.{stack}.norm", xf[f"{stack}_norm"])
    _put_mha(sd, "attention", params["attention"])
    head, hstats = params["head"], stats["head"]
    for j, name in enumerate(["fc1", "fc2", "fc3"]):
        _put_convbn(sd, f"head.nn.{4 * j}", head[name], hstats[name], 1,
                    f"head.nn.{4 * j + 1}")
    _put_dense(sd, "head.nn.12", head["fc4"], dims=1)
    _put_convbn(sd, "head.label_conv", head["label_conv"],
                hstats["label_conv"], dims=1)


def state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of a flax ``DGCNNCls``,
    ``PointNet``, ``DGCNNPartSeg``, ``DGCNNSemSeg`` or fusion ``Net`` (with
    the torch-style transformer, or the custom one) -> the reference state
    dict of the port's model."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    if "emb_nn" in params:                                        # Net
        _put_net(sd, params, stats)
        return sd
    if "transform_net" in params:                             # DGCNNPartSeg
        _put_transform_net(sd, "transform_net.", params["transform_net"],
                           stats["transform_net"])
        for name in ["conv1", "conv3", "conv5"]:
            _put_edgeconv(sd, name, params[name], stats[name])
        for name, dims in [("conv2", 2), ("conv4", 2), ("conv6", 1),
                           ("conv7", 1), ("conv8", 1), ("conv9", 1),
                           ("conv10", 1)]:
            _put_convbn(sd, name, params[name], stats[name], dims)
        _put_dense(sd, "conv11", params["conv11"], dims=1)
        return sd
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
        _put_densebn(sd, "linear1", "bn6", params["linear1"],
                     stats["linear1"])
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

    A checkpoint dict holding the state dict under ``model_state_dict``
    (the reference's training checkpoints) or ``state_dict``
    (``train.checkpoint.save_train_checkpoint``) gives that.  Strips
    DataParallel's ``module.`` prefix.  Upstream registers BatchNorms twice
    (``bnI`` and ``convI.1`` over shared storage: DGCNN_cls, DGCNN_partseg
    and its ``transform_net``, the fusion Net's ``pos_mlp.0``), so a
    ``[prefix.]bnI.*`` key whose ``[prefix.]convI.1.*`` twin is present is
    dropped first."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict"):
        if key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in obj.items()}
    for key in list(sd):
        m = re.fullmatch(r"((?:[^.]+\.)*)bn(\d+)\.([^.]+)", key)
        if m and f"{m.group(1)}conv{m.group(2)}.1.{m.group(3)}" in sd:
            del sd[key]
    model.load_state_dict(sd, strict=True)
    return model
