"""Models of dgcnn_tpu/models/dgcnn.py (``DGCNNCls``, ``PointNet``,
``TransformNet``, ``DGCNNPartSeg``, ``DGCNNSemSeg``) and the fusion Net's
``DGCNN`` backbone and ``PositionEmbedding`` (``export_dgcnn_backbone``'s
and ``export_transform_net``'s layouts), for evaluation and training.

Every model sends a cloud whose size the kNN kernels do not take
(``ops.knn.use_kernel``) to the port of the JAX package's XLA path: the
plain kNN and the per-edge tensor in torch, decided from the shape before
any launch, as the JAX package's ``use_pallas`` decides.

Parameters use the reference state-dict layouts, the ones
``dgcnn_tpu/convert/torch_export.py`` writes: ``export_dgcnn_cls``
(``model.cls.1024.t7``: ``conv1.0.weight`` (64, 6, 1, 1), ``conv1.1.*``,
..., ``conv5.0.weight`` (emb, 512, 1), ``linear1``, ``bn6``, ``linear2``,
``bn7``, ``linear3``), ``export_dgcnn_partseg`` (``transform_net.*`` in
``export_transform_net``'s layout without its ``bn1``-``bn3`` aliases,
``conv1``-``conv10`` as Conv + BatchNorm pairs, ``conv11.weight`` (parts,
128, 1)) and ``export_dgcnn_semseg`` (``conv1``-``conv8`` as Conv +
BatchNorm pairs, ``conv9.weight`` (classes, 256, 1)).

The eval forwards of ``DGCNNPartSeg`` and ``DGCNNSemSeg`` take a ``band``
(their attribute): one that prunes the N points (``banded_applicable``)
runs the EdgeConv stages of the backbone through the banded kernels of
ops/banded.py, the JAX package's ``--fast_extract`` path; 0 is exact.

The eval forwards of ``DGCNNCls``, ``DGCNNPartSeg`` and ``DGCNNSemSeg``
and their training steps have the JAX package's two numerics modes,
exact f32 and AMP (its default): ``forward``'s ``amp`` None takes AMP on
the card unless ``DGCNN_TPU_PALLAS_EXACT`` is set and exact on the CPU;
True or False asks for one (``ops.amp_select.use_amp_eval`` and
``use_amp_train``: clouds the kernels do not take stay exact; any k runs
the mode asked for, as in the JAX package).
A forward, and a training step with its backward, runs every kernel in
the one mode.  In training the AMP mode is the kernels' AMP forms (3, 4,
5, 7 and 8: bf16 selected values, f32 sums); every product outside them
stays f32, as the JAX package's training computes it on the CPU.  The
fusion ``Net``'s ``DGCNN`` backbone trains exact (the ``Net`` passes it
``amp`` False).
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
from dgcnn_tpu_torch.models.torch_transformer import TorchMultiheadAttention
from dgcnn_tpu_torch.ops.amp_select import use_amp_eval, use_amp_train
from dgcnn_tpu_torch.ops.banded import banded_applicable, banded_knn_edge2
from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool
from dgcnn_tpu_torch.ops.edge2_kernel import knn_edge2
from dgcnn_tpu_torch.ops.edge2_reduce import edge2_reduce
from dgcnn_tpu_torch.ops.edge_conv import (
    _project,
    edge_conv_batch_stats,
    edge_linear,
    edge_stats_from_sums,
)
from dgcnn_tpu_torch.ops.graph import get_graph_feature
from dgcnn_tpu_torch.ops.knn import knn, use_kernel
from dgcnn_tpu_torch.ops.knn_edge_reduce import knn_edge_reduce
from dgcnn_tpu_torch.ops.pool import global_max, global_mean


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BatchNorm statistic of a model still on the
    CPU from ``generator`` (a CPU generator, so the same seed gives the same
    weights on any device):
    weights N(0, 1/fan_in), biases N(0, 0.1^2), BN scales of either sign,
    running means near 0 and running variances in [0.5, 2), LayerNorm
    scales near 1.  A TransformNet's 3x3 bias gets the identity added, as
    its flax init has."""

    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            f = mod.weight.shape
            mod.weight.copy_(1.0 + 0.1 * torch.randn(f, generator=generator))
            mod.bias.copy_(0.1 * torch.randn(f, generator=generator))
            continue
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
                   if name.endswith("weight") else 0.1)
            p.normal_(0.0, std, generator=generator)
    for mod in model.modules():
        if isinstance(mod, TransformNet):
            mod.transform.bias.add_(torch.eye(3).reshape(9))
    return model


@torch.no_grad()
def init_like_flax_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a model still on the CPU from ``generator`` with the JAX
    package's flax initialization (the distribution, not its random
    stream): every weight lecun-normal (normal with std sqrt(1 / fan_in)
    / 0.8796, truncated at two of those std; each half of an EdgeConv
    weight has its own fan_in, as ``w_nbr`` and ``w_ctr`` do), biases 0,
    BatchNorm weight 1, bias 0 and running statistics 0 and 1, LayerNorm
    weight 1 and bias 0; an attention's packed ``in_proj_weight``
    xavier-uniform; a TransformNet's 3x3 layer weight 0 and bias the
    identity."""
    edge_weights = {id(m[0]) for m in model.modules()
                    if isinstance(m, EdgeConv)}
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            continue
        if isinstance(mod, TorchMultiheadAttention):
            nn.init.xavier_uniform_(mod.in_proj_weight, generator=generator)
            mod.in_proj_bias.zero_()
            continue
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
    for mod in model.modules():
        if isinstance(mod, TransformNet):
            mod.transform.weight.zero_()
            mod.transform.bias.copy_(torch.eye(3).reshape(9))
    return model


def edge_block2(ec: EdgeConv, cb: ConvBN, x: torch.Tensor,
                graph: torch.Tensor, k: int, train: bool,
                slope: float = 0.2, band: int = 0,
                amp: bool = False) -> torch.Tensor:
    """Two-conv EdgeConv stage (port of ``_edge_block2``, the upstream
    partseg/semseg block): conv ``ec`` on [neighbour, centre] edge features
    -> BN -> LeakyReLU -> conv ``cb`` -> BN -> LeakyReLU -> max over the k
    neighbours in ``graph``'s kNN.  No per-edge tensor is built: eval runs
    one kernel (``knn_edge2``, or ``banded_knn_edge2`` with a ``band``
    that prunes the N points); training runs ``knn_edge_reduce`` for the
    neighbours and the first BatchNorm's statistics in closed form, then
    ``edge2_reduce`` for the second's and the max/min the output selects
    from.  CUDA tensors launch the kernels, CPU tensors take their plain
    versions.  A graph of a size the kernels do not take (``use_kernel``)
    and no band that prunes it (the banded kernel takes any N) takes the
    JAX package's XLA path: ``knn``, the per-edge tensor of the
    first conv, BatchNorm over B*N*k, the second conv and the max over
    k in torch.  ``amp`` runs the eval kernel's AMP form (a bf16 output;
    ``a1``/``b1`` f32, of W rounded to bf16 where ``x`` is bf16), and in
    training kernels 3, 5, 7 and 8 in theirs: kernel 7 selects ``a1``'s
    rows rounded to bf16, as kernel 8 re-selects them, and the first
    BatchNorm's statistics come from kernel 3's AMP sums (the JAX
    package's ``_edge_block2``, dgcnn_tpu/models/dgcnn.py:66-89)."""
    w_nbr, w_ctr = ec.split_weights()
    # the band before the shape gate: the banded kernel takes any N (its
    # window bounds it), as the JAX package's does
    banded = not train and banded_applicable(graph.shape[1], band)
    if not banded and not use_kernel(graph.shape[1]):
        idx = knn(graph, k)
        if train:
            s1, t1 = ec[1].push_stats(
                *edge_conv_batch_stats(x, idx, w_nbr, w_ctr),
                x.shape[0] * x.shape[1] * k)
        else:
            s1, t1 = ec[1].folded()
        h = leaky_relu(edge_linear(x, idx, w_nbr, w_ctr) * s1 + t1,
                       ec.negative_slope)
        return cb(h, train).amax(dim=2)
    w2 = cb.kernel()
    a1 = _project(x, w_nbr)
    b1 = _project(x, w_ctr)
    if not train:
        s1, t1 = ec[1].folded()
        s2, t2 = cb[1].folded()
        if banded:
            return banded_knn_edge2(graph, a1, b1, s1, t1, w2, s2, t2, k,
                                    band, slope, amp=amp)
        return knn_edge2(graph, a1, b1, s1, t1, w2, s2, t2, k, slope,
                         amp=amp)
    idx, _, _, asum1, asumsq1 = knn_edge_reduce(graph, a1, k, amp)
    count = x.shape[0] * x.shape[1] * k
    s1, t1 = ec[1].push_stats(
        *edge_stats_from_sums(asum1, asumsq1, b1, k), count)
    mx2, mn2, sm2, sq2 = edge2_reduce(a1, b1, s1, t1, w2, idx, slope, amp)
    mean2 = sm2.mean(dim=(0, 1)) / k
    var2 = (sq2.mean(dim=(0, 1)) / k - mean2.square()).clamp(min=0.0)
    s2, t2 = cb[1].push_stats(mean2, var2, count)
    # max over k of LReLU(s2 * z2 + t2) = LReLU(s2 * (s2 > 0 ? max : min)
    # + t2): LReLU is monotone
    return leaky_relu(torch.where(s2 > 0, mx2, mn2) * s2 + t2, slope)


def embed_max_pool(cb: ConvBN, x: torch.Tensor, train: bool,
                   amp: bool = False) -> torch.Tensor:
    """Embedding conv ``cb`` -> BN -> LeakyReLU -> max over the N points,
    (B, 1, E) f32 (port of ``_embed_max_pool`` with keepdims): one
    ``conv_pool`` launch in eval on CUDA, plain torch otherwise (training
    too, as in the JAX package).  ``amp``: the AMP form on a bf16 ``x``
    (its plain version on the CPU)."""
    if (x.is_cuda or amp) and not train:
        s, t = cb[1].folded()
        return conv_pool((x,), cb.kernel(), s, t, cb.negative_slope,
                         with_mean=False, amp=amp)
    return global_max(cb(x, train), keepdims=True)


def _seeded(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class TransformNet(nn.Module):
    """Spatial transformer predicting a 3x3 alignment matrix (upstream
    Transform_Net, ``dgcnn_tpu/models/dgcnn.py::TransformNet`` built from
    the points): conv1 6 -> 64 and conv2 64 -> 128 over the [neighbour,
    centre] edge features of the points' kNN graph, max over the k
    neighbours, conv3 128 -> 1024 + max over the points, Linear 512 and
    256 (BatchNorm, LeakyReLU), then the 3x3 layer ``transform``.

    Input (B, N, 3) points -> (B, 3, 3).  In eval the two convs and the
    max over k are one ``knn_edge2`` launch over the points (conv1 of the
    concat factors into its row slices) and conv3 + max one ``conv_pool``
    launch; in training, and in eval for a cloud size the kernels do not
    take (``use_kernel``), ``get_graph_feature`` (kernel 11) builds the (B,
    N, k, 6) edge tensor, which conv1 and conv2 run on in torch with their
    BatchNorm over B*N*k, as in the JAX package.  CUDA tensors launch the
    kernels, CPU tensors take their plain versions.

    ``amp`` (eval only; ``DGCNNPartSeg`` resolves it) runs the AMP forms
    of kernels 6 and 2: the bf16 block output into conv3 + pool, whose
    pooled row is f32, and the head f32."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBN(6, 64, dims=2)
        self.conv2 = ConvBN(64, 128, dims=2)
        self.conv3 = ConvBN(128, 1024, dims=1)
        # the reference's Sequential(Linear, BN, LeakyReLU, Linear, BN,
        # LeakyReLU): keys linear.0, linear.1, linear.3 and linear.4
        self.linear = nn.Sequential(
            Linear(1024, 512, bias=False), BatchNorm(512), nn.Identity(),
            Linear(512, 256, bias=False), BatchNorm(256))
        self.transform = Linear(256, 9)

    def forward(self, x: torch.Tensor, k: int, train: bool = False,
                amp: bool = False) -> torch.Tensor:
        if train or not use_kernel(x.shape[1]):
            e = get_graph_feature(x, k)
            t = self.conv2(self.conv1(e, train), train).amax(dim=2)
        else:
            c = x.shape[-1]
            w1 = self.conv1.kernel()
            s1, t1 = self.conv1[1].folded()
            s2, t2 = self.conv2[1].folded()
            # edge concat order [neighbour, centre]
            t = knn_edge2(x, _project(x, w1[:c]), _project(x, w1[c:]), s1,
                          t1, self.conv2.kernel(), s2, t2, k,
                          self.conv1.negative_slope, amp=amp)
        t = embed_max_pool(self.conv3, t, train, amp)[:, 0]   # (B, 1024)
        for lin, bn in ((self.linear[0], self.linear[1]),
                        (self.linear[3], self.linear[4])):
            t = leaky_relu(bn(lin(t), train))
        return self.transform(t).reshape(-1, 3, 3)


class PositionEmbedding(TransformNet):
    """The fork's canonicalizer (reference models/layers.py:8-74): the
    TransformNet's 3x3 (its eval or training path) applied to the points,
    (B, N, 3) -> (B, N, 3) in f32.  Its keys are the TransformNet's.
    ``amp`` as the TransformNet's (the ``Net`` passes its mode): kernel
    6's AMP form (v3 at C1 = 64) and kernel 2's for conv3 (128 -> 1024, max
    only)."""

    def forward(self, x: torch.Tensor, k: int, train: bool = False,
                amp: bool = False) -> torch.Tensor:
        return torch.einsum("bnc,bcd->bnd", x,
                            super().forward(x, k, train, amp))


class DGCNN(nn.Module):
    """The fork's backbone (reference models/dgcnn.py:47-103): EdgeConv
    3->64, 64->64, 64->128, 128->256 (each over its own input's kNN
    graph), their concat through conv5 (512 -> emb, BatchNorm, LeakyReLU)
    per point: (B, N, 3) -> (B, N, emb).  In eval the four stages run the
    edge_conv_eval kernel on CUDA tensors, in training the knn_reduce
    kernels (the 128 -> 256 stage in the select-x form; backward:
    edge_reduce_bwd), as ``DGCNNCls`` trains, with conv5's BatchNorm on the
    batch's statistics; their plain versions on CPU tensors.  conv5 is
    plain torch, as in the JAX package.  Its keys are
    ``export_dgcnn_backbone``'s.

    ``amp`` (eval only; the ``Net`` resolves it) runs the stages in kernel
    1's AMP form (at the Net's N = 2048, k = 32: v3, v3, v2 and select-x
    v2, as ``select_x_plan`` gives), whose bf16 outputs conv5 takes
    promoted to f32, as the JAX package's f32 conv5 does
    (dgcnn_tpu/models/dgcnn.py:147-155).  A ``band`` that prunes the N
    points runs the eval stages through kernel 12 instead
    (``banded_edge_conv_eval``; the AMP form at every stage width)."""

    def __init__(self, emb_dims: int = 512, k: int = 32):
        super().__init__()
        self.k = k
        self.conv1 = EdgeConv(3, 64)
        self.conv2 = EdgeConv(64, 64)
        self.conv3 = EdgeConv(64, 128)
        self.conv4 = EdgeConv(128, 256)
        self.conv5 = ConvBN(512, emb_dims, dims=2)

    def forward(self, x: torch.Tensor, train: bool = False,
                amp: bool = False, band: int = 0) -> torch.Tensor:
        kk = self.k
        x1 = self.conv1(x, train=train, graph=x, k=kk, band=band, amp=amp)
        x2 = self.conv2(x1, train=train, graph=x1, k=kk, band=band, amp=amp)
        x3 = self.conv3(x2, train=train, graph=x2, k=kk, band=band, amp=amp)
        x4 = self.conv4(x3, train=train, graph=x3, k=kk, band=band, amp=amp)
        return self.conv5(torch.cat([x1, x2, x3, x4], dim=-1).float(), train)


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
    given to ``forward``.

    Eval has two numerics modes, as the JAX package's: the exact f32 one
    and the AMP one, its default (bf16 selection payloads and stage
    outputs, the v3 / v2 selections, bf16 operands of conv5; the head f32
    on the pooled f32 rows).  ``forward``'s ``amp`` None takes AMP on the
    card unless ``DGCNN_TPU_PALLAS_EXACT`` is set and exact on the CPU;
    True or False asks for one (``ops.amp_select.use_amp_eval``: clouds
    the kernels do not take stay exact, at any k).  Training has the same
    two modes (``ops.amp_select.use_amp_train``): in AMP the stages run
    kernels 3, 4 (the 128 -> 256 stage) and 5 in their AMP forms, and
    every product outside them stays f32."""

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
                generator: torch.Generator | None = None, *,
                amp: bool | None = None) -> torch.Tensor:
        kk = self.k
        amp = (use_amp_train if train else use_amp_eval)(
            amp, x.device, x.shape[1], kk)
        x1 = self.conv1(x, train=train, graph=x, k=kk, amp=amp)
        x2 = self.conv2(x1, train=train, graph=x1, k=kk, amp=amp)
        x3 = self.conv3(x2, train=train, graph=x2, k=kk, amp=amp)
        x4 = self.conv4(x3, train=train, graph=x3, k=kk, amp=amp)
        if amp and not train:
            s, t = self.conv5[1].folded()
            pm = conv_pool((x1, x2, x3, x4), self.conv5.kernel(), s, t,
                           self.conv5.negative_slope, with_mean=True,
                           amp=True)
            pooled = torch.cat([pm[:, 0], pm[:, 1]], dim=-1)
        elif x.is_cuda and not train:
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


class DGCNNPartSeg(nn.Module):
    """Canonical part-segmentation network (upstream DGCNN_partseg): the
    TransformNet's 3x3 applied to the points, two two-conv EdgeConv stages
    (each 64, 64) and one EdgeConv 64 -> 64, conv6 192 -> emb + max over
    the points, conv7 16 -> 64 on the category one-hot, then per point
    [global feature, label feature, the three stage outputs] -> conv8 256
    -> dropout ``dp1`` -> conv9 256 -> dropout ``dp2`` -> conv10 128 ->
    conv11 to the part labels (no bias).

    Input (B, N, 3) points and (B, 16) category one-hot -> per-point
    logits (B, N, parts).  In eval on CUDA the TransformNet and the two
    two-conv stages run knn_edge2 (with ``band``: the stages run
    banded_knn_edge2), conv5 edge_conv_eval (banded_edge_conv_eval) and
    conv3 / conv6 + pool conv_pool; in training on CUDA the TransformNet's
    graph runs kernel 11 (knn), the two-conv stages knn_edge_reduce +
    edge2_reduce and conv5 knn_edge_reduce (backward: edge_reduce_bwd and
    edge2_bwd), the pools plain torch, as in the JAX package.  On the CPU
    the kernels' plain versions run.

    Eval has the exact f32 mode and the AMP one, the JAX package's
    default, resolved as ``DGCNNCls``'s (``forward``'s ``amp``): the AMP
    forms of kernels 6 (the TransformNet and the two-conv stages), 1
    (conv5) and 2 (conv3 and conv6), or with ``band`` 13 and 12; bf16
    stage outputs, the pooled rows f32, [global, label, stages]
    concatenated in f32 and the head f32.  The 3x3 applies in f32.
    Training has the two modes too (``use_amp_train``): in AMP the two
    two-conv stages and conv5 run kernels 3, 5, 7 and 8 in their AMP
    forms; the TransformNet's graph (kernel 11) and every product outside
    the kernels stay as in the exact mode."""

    def __init__(self, emb_dims: int = 1024, k: int = 40,
                 dropout: float = 0.5, seg_num_all: int = 50, band: int = 0,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.band = band
        self.transform_net = TransformNet()
        self.conv1 = EdgeConv(3, 64)
        self.conv2 = ConvBN(64, 64, dims=2)
        self.conv3 = EdgeConv(64, 64)
        self.conv4 = ConvBN(64, 64, dims=2)
        self.conv5 = EdgeConv(64, 64)
        self.conv6 = ConvBN(192, emb_dims, dims=1)
        self.conv7 = ConvBN(16, 64, dims=1)
        self.conv8 = ConvBN(emb_dims + 64 + 192, 256, dims=1)
        self.dp1 = Dropout(dropout)
        self.conv9 = ConvBN(256, 256, dims=1)
        self.dp2 = Dropout(dropout)
        self.conv10 = ConvBN(256, 128, dims=1)
        self.conv11 = Weight((seg_num_all, 128, 1))
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, label_one_hot: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None, *,
                amp: bool | None = None) -> torch.Tensor:
        kk, band = self.k, self.band
        amp = (use_amp_train if train else use_amp_eval)(
            amp, x.device, x.shape[1], kk)
        t = self.transform_net(x, kk, train, amp)             # (B, 3, 3)
        x = torch.einsum("bnc,bcd->bnd", x, t)
        x1 = edge_block2(self.conv1, self.conv2, x, x, kk, train, band=band,
                         amp=amp)
        x2 = edge_block2(self.conv3, self.conv4, x1, x1, kk, train,
                         band=band, amp=amp)
        x3 = self.conv5(x2, train=train, graph=x2, k=kk, band=band, amp=amp)
        cat = torch.cat([x1, x2, x3], dim=-1)                 # (B, N, 192)
        g = embed_max_pool(self.conv6, cat, train, amp)       # (B, 1, emb)
        lbl = self.conv7(label_one_hot[:, None, :], train)    # (B, 1, 64)
        g = torch.cat([g, lbl], dim=-1).expand(-1, x.shape[1], -1)
        # AMP: the bf16 stage outputs join the f32 rows in f32
        h = self.conv8(torch.cat([g, cat.float()], dim=-1), train)
        h = self.conv9(self.dp1(h, train, generator), train)
        h = self.conv10(self.dp2(h, train, generator), train)
        return torch.matmul(h, self.conv11.weight[:, :, 0].t())


class DGCNNSemSeg(nn.Module):
    """Canonical semantic-segmentation network (upstream DGCNN_semseg):
    9-channel S3DIS blocks, the first graph over the normalized room
    coordinates (channels 6:9), two two-conv EdgeConv stages (each 64, 64)
    and one EdgeConv 64 -> 64, conv6 192 -> emb + max over the points, then
    per point [global feature, the three stage outputs] -> conv7 512 ->
    conv8 256 -> dropout ``dp1`` -> conv9 to the classes (no bias).

    Input (B, N, 9) -> per-point logits (B, N, classes).  In eval on CUDA
    the two-conv stages run knn_edge2 (with ``band``: banded_knn_edge2),
    conv5 edge_conv_eval (banded_edge_conv_eval) and conv6 + pool
    conv_pool; in training on CUDA the two-conv stages run
    knn_edge_reduce + edge2_reduce and conv5 knn_edge_reduce (backward:
    edge_reduce_bwd and edge2_bwd), conv6 + pool plain torch, as in the JAX
    package.  On the CPU the kernels' plain versions run.

    Eval has the exact f32 mode and the AMP one, the JAX package's
    default, resolved as ``DGCNNCls``'s (``forward``'s ``amp``): the AMP
    forms of kernels 6, 1 and 2, or with ``band`` 13 and 12; bf16 stage
    outputs, the pooled row f32, [global, stages] concatenated in f32 and
    the head f32.  Training has the two modes too (``use_amp_train``): in
    AMP the two two-conv stages and conv5 run kernels 3, 5, 7 and 8 in
    their AMP forms, every product outside them f32.

    The semseg CLI pins ``DGCNN_TPU_EXTRACT=v2`` (S3DIS blocks repeat
    points), as the JAX CLI does: the eval kernels 6, 1, 13 and 12 then
    run v2 in both modes, and training's kernel 3 too (its AMP default is
    v2 anyway)."""

    def __init__(self, emb_dims: int = 1024, k: int = 20,
                 dropout: float = 0.5, num_classes: int = 13, band: int = 0,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.band = band
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
                generator: torch.Generator | None = None, *,
                amp: bool | None = None) -> torch.Tensor:
        kk, band = self.k, self.band
        amp = (use_amp_train(amp, x.device, x.shape[1], kk) if train else
               use_amp_eval(amp, x.device, x.shape[1], kk, band=band))
        # first graph: neighbours by the normalized room coordinates
        x1 = edge_block2(self.conv1, self.conv2, x,
                         x[..., 6:9].contiguous(), kk, train, band=band,
                         amp=amp)
        x2 = edge_block2(self.conv3, self.conv4, x1, x1, kk, train,
                         band=band, amp=amp)
        x3 = self.conv5(x2, train=train, graph=x2, k=kk, band=band, amp=amp)
        cat = torch.cat([x1, x2, x3], dim=-1)                 # (B, N, 192)
        g = embed_max_pool(self.conv6, cat, train, amp)       # (B, 1, emb)
        # AMP: the bf16 stage outputs join the f32 row in f32
        h = torch.cat([g.expand(-1, x.shape[1], -1), cat.float()], dim=-1)
        h = self.conv8(self.conv7(h, train), train)
        h = self.dp1(h, train, generator)
        return torch.matmul(h, self.conv9.weight[:, :, 0].t())
