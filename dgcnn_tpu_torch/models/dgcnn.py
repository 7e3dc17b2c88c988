"""Classification models (port of dgcnn_tpu/models/dgcnn.py: ``DGCNNCls``
and ``PointNet``), for evaluation and training.

Parameters use the reference ``model.cls.1024.t7`` state-dict layout
(``conv1.0.weight`` (64, 6, 1, 1), ``conv1.1.*``, ..., ``conv5.0.weight``
(emb, 512, 1), ``linear1``, ``bn6``, ``linear2``, ``bn7``, ``linear3``), the
layout ``dgcnn_tpu/convert/torch_export.py::export_dgcnn_cls`` writes.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dgcnn_tpu_torch.models.nn_layers import (
    BatchNorm,
    ConvBN,
    Dropout,
    EdgeConv,
    Linear,
    Weight,
    leaky_relu,
)
from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool
from dgcnn_tpu_torch.ops.pool import global_max, global_mean


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BatchNorm statistic of a model still on the
    CPU from ``generator`` (a CPU generator, so the same seed gives the same
    weights on any device):
    weights N(0, 1/fan_in), biases N(0, 0.1^2), BN scales of either sign,
    running means near 0 and running variances in [0.5, 2)."""

    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            f = mod.weight.shape
            sign = torch.where(torch.rand(f, generator=generator) < 0.1,
                               -1.0, 1.0)
            vals = {
                "weight": sign * (0.5 + torch.rand(f, generator=generator)),
                "bias": 0.1 * torch.randn(f, generator=generator),
                "running_mean": 0.1 * torch.randn(f, generator=generator),
                "running_var": 0.5 + 1.5 * torch.rand(f, generator=generator),
            }
            for name, v in vals.items():
                getattr(mod, name).copy_(v)
            continue
        for name, p in mod.named_parameters(recurse=False):
            std = (1.0 / math.sqrt(math.prod(p.shape[1:]))
                   if name == "weight" else 0.1)
            p.normal_(0.0, std, generator=generator)
    return model


@torch.no_grad()
def init_like_flax_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a model still on the CPU from ``generator`` with the JAX
    package's flax initialization (the distribution, not its random
    stream): every weight lecun-normal (normal with std sqrt(1 / fan_in)
    / 0.8796, truncated at two of those std; each half of an EdgeConv
    weight has its own fan_in, as ``w_nbr`` and ``w_ctr`` do), biases 0,
    BatchNorm weight 1, bias 0 and running statistics 0 and 1."""
    edge_weights = {id(m[0]) for m in model.modules()
                    if isinstance(m, EdgeConv)}
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            for name, v in [("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)]:
                getattr(mod, name).fill_(v)
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name != "weight":
                p.zero_()
                continue
            for w in (p.chunk(2, dim=1) if id(mod) in edge_weights else (p,)):
                std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
    return model


def _seeded(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class DGCNNCls(nn.Module):
    """Canonical DGCNN classification network (upstream DGCNN_cls):
    EdgeConv 3->64, 64->64, 64->128, 128->256 (each over its own input's
    kNN graph), conv5 512->emb, max+mean pool, MLP 2emb->512->256->classes.

    Input (B, N, 3) -> logits (B, classes).  In eval on CUDA the four
    stages run the edge_conv_eval kernel and conv5 + pool the conv_pool
    kernel; in training on CUDA the stages run the knn_reduce kernels
    (backward: edge_reduce_bwd) and conv5 + pool is plain torch, as in the
    JAX package.  On the CPU the kernels' plain versions run.  Dropout
    ``dp1``/``dp2`` acts in training only, drawing from the ``generator``
    given to ``forward``."""

    def __init__(self, emb_dims: int = 1024, k: int = 20,
                 dropout: float = 0.5, output_channels: int = 40,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.conv1 = EdgeConv(3, 64)
        self.conv2 = EdgeConv(64, 64)
        self.conv3 = EdgeConv(64, 128)
        self.conv4 = EdgeConv(128, 256)
        self.conv5 = ConvBN(512, emb_dims, dims=1)
        self.linear1 = Linear(2 * emb_dims, 512, bias=False)
        self.bn6 = BatchNorm(512)
        self.linear2 = Linear(512, 256)
        self.bn7 = BatchNorm(256)
        self.linear3 = Linear(256, output_channels)
        self.dp1 = Dropout(dropout)
        self.dp2 = Dropout(dropout)
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        kk = self.k
        x1 = self.conv1(x, train=train, graph=x, k=kk)
        x2 = self.conv2(x1, train=train, graph=x1, k=kk)
        x3 = self.conv3(x2, train=train, graph=x2, k=kk)
        x4 = self.conv4(x3, train=train, graph=x3, k=kk)
        if x.is_cuda and not train:
            s, t = self.conv5[1].folded()
            pm = conv_pool((x1, x2, x3, x4), self.conv5.kernel(), s, t,
                           self.conv5.negative_slope, with_mean=True)
            pooled = torch.cat([pm[:, 0], pm[:, 1]], dim=-1)
        else:
            h = self.conv5(torch.cat([x1, x2, x3, x4], dim=-1), train)
            pooled = torch.cat([global_max(h), global_mean(h)], dim=-1)
        h = leaky_relu(self.bn6(self.linear1(pooled), train))
        h = self.dp1(h, train, generator)
        h = leaky_relu(self.bn7(self.linear2(h), train))
        h = self.dp2(h, train, generator)
        return self.linear3(h)


class PointNet(nn.Module):
    """Canonical PointNet baseline: per-point 3->64->64->64->128->emb with
    BN + ReLU, global max pool, Linear 512 (BN + ReLU + dropout ``dp1``)
    -> classes.  No kernel: plain torch on every device."""

    def __init__(self, emb_dims: int = 1024, dropout: float = 0.5,
                 output_channels: int = 40, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [3, 64, 64, 64, 128, emb_dims]
        for i in range(1, 6):
            self.add_module(f"conv{i}", Weight((widths[i], widths[i - 1], 1)))
            self.add_module(f"bn{i}", BatchNorm(widths[i]))
        self.linear1 = Linear(emb_dims, 512, bias=False)
        self.bn6 = BatchNorm(512)
        self.linear2 = Linear(512, output_channels)
        self.dp1 = Dropout(dropout)
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for i in range(1, 6):
            w = getattr(self, f"conv{i}").weight[:, :, 0]
            x = torch.relu(getattr(self, f"bn{i}")(torch.matmul(x, w.t()),
                                                    train))
        x = global_max(x)
        x = torch.relu(self.bn6(self.linear1(x), train))
        x = self.dp1(x, train, generator)
        return self.linear2(x)
