"""Models of dgcnn_tpu/models/dgcnn.py (``DGCNNCls``, ``PointNet``,
``DGCNNSemSeg``), for evaluation and training.

Parameters use the reference state-dict layouts, the ones
``dgcnn_tpu/convert/torch_export.py`` writes: ``export_dgcnn_cls``
(``model.cls.1024.t7``: ``conv1.0.weight`` (64, 6, 1, 1), ``conv1.1.*``,
..., ``conv5.0.weight`` (emb, 512, 1), ``linear1``, ``bn6``, ``linear2``,
``bn7``, ``linear3``) and ``export_dgcnn_semseg`` (``conv1``-``conv8`` as
Conv + BatchNorm pairs, ``conv9.weight`` (classes, 256, 1)).
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
from dgcnn_tpu_torch.ops.edge2_kernel import knn_edge2
from dgcnn_tpu_torch.ops.edge2_reduce import edge2_reduce
from dgcnn_tpu_torch.ops.edge_conv import _project, edge_stats_from_sums
from dgcnn_tpu_torch.ops.knn_edge_reduce import knn_edge_reduce
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


def edge_block2(ec: EdgeConv, cb: ConvBN, x: torch.Tensor,
                graph: torch.Tensor, k: int, train: bool,
                slope: float = 0.2) -> torch.Tensor:
    """Two-conv EdgeConv stage (port of ``_edge_block2``, the upstream
    partseg/semseg block): conv ``ec`` on [neighbour, centre] edge features
    -> BN -> LeakyReLU -> conv ``cb`` -> BN -> LeakyReLU -> max over the k
    neighbours in ``graph``'s kNN.  No per-edge tensor is built: eval runs
    one kernel (``knn_edge2``); training runs ``knn_edge_reduce`` for the
    neighbours and the first BatchNorm's statistics in closed form, then
    ``edge2_reduce`` for the second's and the max/min the output selects
    from.  CUDA tensors launch the kernels, CPU tensors take their plain
    versions."""
    w_nbr, w_ctr = ec.split_weights()
    w2 = cb.kernel()
    a1 = _project(x, w_nbr)
    b1 = _project(x, w_ctr)
    if not train:
        s1, t1 = ec[1].folded()
        s2, t2 = cb[1].folded()
        return knn_edge2(graph, a1, b1, s1, t1, w2, s2, t2, k, slope)
    idx, _, _, asum1, asumsq1 = knn_edge_reduce(graph, a1, k)
    count = x.shape[0] * x.shape[1] * k
    s1, t1 = ec[1].push_stats(
        *edge_stats_from_sums(asum1, asumsq1, b1, k), count)
    mx2, mn2, sm2, sq2 = edge2_reduce(a1, b1, s1, t1, w2, idx, slope)
    mean2 = sm2.mean(dim=(0, 1)) / k
    var2 = (sq2.mean(dim=(0, 1)) / k - mean2.square()).clamp(min=0.0)
    s2, t2 = cb[1].push_stats(mean2, var2, count)
    # max over k of LReLU(s2 * z2 + t2) = LReLU(s2 * (s2 > 0 ? max : min)
    # + t2): LReLU is monotone
    return leaky_relu(torch.where(s2 > 0, mx2, mn2) * s2 + t2, slope)


def embed_max_pool(cb: ConvBN, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Embedding conv ``cb`` -> BN -> LeakyReLU -> max over the N points,
    (B, 1, E) (port of ``_embed_max_pool`` with keepdims): one
    ``conv_pool`` launch in eval on CUDA, plain torch otherwise (training
    too, as in the JAX package)."""
    if x.is_cuda and not train:
        s, t = cb[1].folded()
        return conv_pool((x,), cb.kernel(), s, t, cb.negative_slope,
                         with_mean=False)
    return global_max(cb(x, train), keepdims=True)


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


class DGCNNSemSeg(nn.Module):
    """Canonical semantic-segmentation network (upstream DGCNN_semseg):
    9-channel S3DIS blocks, the first graph over the normalized room
    coordinates (channels 6:9), two two-conv EdgeConv stages (each 64, 64)
    and one EdgeConv 64 -> 64, conv6 192 -> emb + max over the points, then
    per point [global feature, the three stage outputs] -> conv7 512 ->
    conv8 256 -> dropout ``dp1`` -> conv9 to the classes (no bias).

    Input (B, N, 9) -> per-point logits (B, N, classes).  In eval on CUDA
    the two-conv stages run knn_edge2, conv5 edge_conv_eval and conv6 +
    pool conv_pool; in training on CUDA the two-conv stages run
    knn_edge_reduce + edge2_reduce and conv5 knn_edge_reduce (backward:
    edge_reduce_bwd and edge2_bwd), conv6 + pool plain torch, as in the JAX
    package.  On the CPU the kernels' plain versions run."""

    def __init__(self, emb_dims: int = 1024, k: int = 20,
                 dropout: float = 0.5, num_classes: int = 13,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.conv1 = EdgeConv(9, 64)
        self.conv2 = ConvBN(64, 64, dims=2)
        self.conv3 = EdgeConv(64, 64)
        self.conv4 = ConvBN(64, 64, dims=2)
        self.conv5 = EdgeConv(64, 64)
        self.conv6 = ConvBN(192, emb_dims, dims=1)
        self.conv7 = ConvBN(emb_dims + 192, 512, dims=1)
        self.conv8 = ConvBN(512, 256, dims=1)
        self.dp1 = Dropout(dropout)
        self.conv9 = Weight((num_classes, 256, 1))
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        kk = self.k
        # first graph: neighbours by the normalized room coordinates
        x1 = edge_block2(self.conv1, self.conv2, x,
                         x[..., 6:9].contiguous(), kk, train)
        x2 = edge_block2(self.conv3, self.conv4, x1, x1, kk, train)
        x3 = self.conv5(x2, train=train, graph=x2, k=kk)
        cat = torch.cat([x1, x2, x3], dim=-1)                 # (B, N, 192)
        g = embed_max_pool(self.conv6, cat, train)            # (B, 1, emb)
        h = torch.cat([g.expand(-1, x.shape[1], -1), cat], dim=-1)
        h = self.conv8(self.conv7(h, train), train)
        h = self.dp1(h, train, generator)
        return torch.matmul(h, self.conv9.weight[:, :, 0].t())
