"""Classification models, eval mode (port of dgcnn_tpu/models/dgcnn.py:
``DGCNNCls`` and ``PointNet``).

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
    EdgeConv,
    Linear,
    Weight,
    reject_train,
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


def _seeded(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class DGCNNCls(nn.Module):
    """Canonical DGCNN classification network (upstream DGCNN_cls):
    EdgeConv 3->64, 64->64, 64->128, 128->256 (each over its own input's
    kNN graph), conv5 512->emb, max+mean pool, MLP 2emb->512->256->classes.

    Input (B, N, 3) -> logits (B, classes).  On CUDA the four stages run
    the edge_conv_eval kernel and conv5 + pool the conv_pool kernel; on the
    CPU the plain path runs, as the JAX package's XLA fallback does."""

    def __init__(self, emb_dims: int = 1024, k: int = 20,
                 output_channels: int = 40, device="cuda",
                 generator: torch.Generator | None = None):
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
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        reject_train(train)
        kk = self.k
        x1 = self.conv1(x, graph=x, k=kk)
        x2 = self.conv2(x1, graph=x1, k=kk)
        x3 = self.conv3(x2, graph=x2, k=kk)
        x4 = self.conv4(x3, graph=x3, k=kk)
        if x.is_cuda:
            s, t = self.conv5[1].folded()
            pm = conv_pool((x1, x2, x3, x4), self.conv5.kernel(), s, t,
                           self.conv5.negative_slope, with_mean=True)
            pooled = torch.cat([pm[:, 0], pm[:, 1]], dim=-1)
        else:
            h = self.conv5(torch.cat([x1, x2, x3, x4], dim=-1))
            pooled = torch.cat([global_max(h), global_mean(h)], dim=-1)
        h = leaky_relu(self.bn6(self.linear1(pooled)))
        h = leaky_relu(self.bn7(self.linear2(h)))
        return self.linear3(h)


class PointNet(nn.Module):
    """Canonical PointNet baseline: per-point 3->64->64->64->128->emb with
    BN + ReLU, global max pool, Linear 512 (BN + ReLU) -> classes.  No
    kernel: plain torch on every device."""

    def __init__(self, emb_dims: int = 1024, output_channels: int = 40,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        widths = [3, 64, 64, 64, 128, emb_dims]
        for i in range(1, 6):
            self.add_module(f"conv{i}", Weight((widths[i], widths[i - 1], 1)))
            self.add_module(f"bn{i}", BatchNorm(widths[i]))
        self.linear1 = Linear(emb_dims, 512, bias=False)
        self.bn6 = BatchNorm(512)
        self.linear2 = Linear(512, output_channels)
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        reject_train(train)
        for i in range(1, 6):
            w = getattr(self, f"conv{i}").weight[:, :, 0]
            x = torch.relu(getattr(self, f"bn{i}")(torch.matmul(x, w.t())))
        x = global_max(x)
        x = torch.relu(self.bn6(self.linear1(x)))
        return self.linear2(x)
