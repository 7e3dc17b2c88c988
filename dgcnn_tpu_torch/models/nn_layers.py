"""Building-block layers (port of dgcnn_tpu/models/nn_layers.py).

Channels-last throughout: a reference 1x1 Conv1d/Conv2d is a product over
the trailing feature axis.  Parameters keep the reference state-dict layout
(``<conv>.0.weight`` as a Conv weight, ``<conv>.1.*`` as a BatchNorm), so a
reference checkpoint, or a flax model exported by
``dgcnn_tpu/convert/torch_export.py``, loads with a strict
``load_state_dict``.

``train=True`` follows torch's BatchNorm: the batch's mean and biased
variance normalize, and the running statistics move by momentum 0.1 with
the unbiased variance.  The updates happen in place under ``no_grad``.

A compute dtype (the AMP eval of the fusion Net) follows flax's
``nn.Dense(dtype=bf16)`` (dgcnn_tpu/models/nn_layers.py:100-135): the
input and the f32 parameters cast down, the product rounded to bf16 and
then the bias added in bf16 (``dense``); BatchNorm and LeakyReLU after it
in f32 (a bf16 input promotes), as ``ConvBN`` with ``dtype`` does.
"""
from __future__ import annotations

import torch
from torch import nn

from dgcnn_tpu_torch.ops.banded import banded_applicable, banded_edge_conv_eval
from dgcnn_tpu_torch.ops.edge_conv import (
    _project,
    edge_conv_batch_stats,
    edge_conv_fused,
    edge_stats_from_sums,
    fold_bn,
)
from dgcnn_tpu_torch.ops.edge_conv_kernel import edge_conv_eval
from dgcnn_tpu_torch.ops.knn import knn, use_kernel
from dgcnn_tpu_torch.ops.knn_edge_reduce import (
    knn_edge_reduce,
    knn_edge_reduce_xw,
)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU in ``x``'s dtype; on bf16 values the slope is a bf16
    value too, as jnp rounds a Python scalar to its array's dtype."""
    if x.dtype == torch.bfloat16:
        return torch.where(x >= 0, x, x * torch.tensor(
            negative_slope, dtype=x.dtype, device=x.device))
    return torch.where(x >= 0, x, negative_slope * x)


def dense(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w (+ bias)`` in flax ``nn.Dense``'s compute ``dtype``.  None
    or f32: the f32 product, then the bias.  bf16: ``x``, ``w`` and the bias
    cast to bf16, the product of the bf16 values with f32 sums rounded to
    bf16 once, then the bias added in bf16.  On the CPU the product is
    taken in f32 on the bf16 values and rounded (torch's CPU bf16 matmul
    can round partial sums); on the card it is torch's bf16 matmul with
    reduced-precision reductions off for the call (torch allows cuBLAS to
    round partial sums to bf16 by default), so f32 sums on the tensor
    cores."""
    if dtype is None or dtype == torch.float32:
        y = torch.matmul(x, w)
        return y if bias is None else y + bias
    xb, wb = x.to(dtype), w.to(dtype)
    if x.device.type == "cpu":
        y = torch.matmul(xb.float(), wb.float()).to(dtype)
    else:
        flags = torch.backends.cuda.matmul
        allowed = flags.allow_bf16_reduced_precision_reduction
        flags.allow_bf16_reduced_precision_reduction = False
        try:
            y = torch.matmul(xb, wb)
        finally:
            flags.allow_bf16_reduced_precision_reduction = allowed
    return y if bias is None else y + bias.to(dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """``ln`` (eps and affine) over the last axis.  None or f32: torch's
    LayerNorm.  bf16: flax's ``nn.LayerNorm(dtype=bf16)``: the statistics in
    f32 on ``x`` promoted (mean, and the variance as the mean of the squares
    less the squared mean, floored at 0), ``(x - mean) * (rsqrt(var + eps)
    * weight) + bias`` in f32, the result cast to bf16."""
    if dtype is None or dtype == torch.float32:
        return ln(x)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True)
           - mean.square()).clamp(min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight
    return ((xf - mean) * mul + ln.bias).to(dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, keep each value with probability
    ``1 - rate`` (drawn from the caller's ``generator``, on the values'
    device) and scale it by ``1 / (1 - rate)``; the identity otherwise."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training needs a torch.Generator")
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class Weight(nn.Module):
    """Holds one weight tensor under the key ``weight`` (and, with
    ``bias``, a bias of its first axis's size): the ``.0`` slot of a
    reference ``Sequential(Conv, BatchNorm, ...)``, or a lone conv."""

    def __init__(self, shape, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))
        if bias:
            self.bias = nn.Parameter(torch.zeros(shape[0]))

    def matmul(self, x: torch.Tensor,
               dtype: torch.dtype | None = None) -> torch.Tensor:
        """The 1x1 conv over the trailing axis of ``x``, plus the bias, in
        the compute ``dtype`` (``dense``)."""
        w = self.weight
        return dense(x, w.reshape(w.shape[0], w.shape[1]).t(),
                     getattr(self, "bias", None), dtype)


class Linear(nn.Module):
    """torch.nn.Linear's parameters and math, without its implicit
    global-RNG initialization (models initialize from a Generator)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((out_features, in_features)))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """``x W^T + b``; a bf16 ``dtype`` computes as ``dense``."""
        if dtype is None or dtype == torch.float32:
            return nn.functional.linear(x, self.weight, self.bias)
        return dense(x, self.weight.t(), self.bias, dtype)


class BatchNorm(nn.Module):
    """torch BatchNorm over the trailing channel axis, eps 1e-5, momentum
    0.1."""

    momentum = 0.1

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def folded(self):
        """(scale, bias) of the affine map this layer applies."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       count: int) -> None:
        """Move the running statistics towards a batch's ``mean`` and
        biased ``var`` over ``count`` values: the running variance takes
        the unbiased one."""
        m = self.momentum
        unbiased = var * (count / max(count - 1, 1))
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        self.num_batches_tracked.add_(1)

    def push_stats(self, mean: torch.Tensor, var: torch.Tensor, count: int):
        """A batch's statistics computed elsewhere (the fused training
        paths): move the running statistics and return the (scale, bias)
        that normalizes with them."""
        self.update_running(mean, var, count)
        return fold_bn(self.weight, self.bias, mean, var, self.eps)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = (x.square().mean(dim=axes) - mean.square()).clamp(min=0.0)
            self.update_running(mean, var, x.numel() // x.shape[-1])
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class ConvBN(nn.Sequential):
    """1x1 conv + BatchNorm + LeakyReLU; keys ``.0.weight`` (Co, Ci, 1[, 1])
    and ``.1.*``."""

    def __init__(self, in_features: int, features: int, dims: int = 1,
                 negative_slope: float = 0.2):
        super().__init__(Weight((features, in_features) + (1,) * dims),
                         BatchNorm(features))
        self.negative_slope = negative_slope

    def kernel(self) -> torch.Tensor:
        """The conv as a (Ci, Co) matrix."""
        w = self[0].weight
        return w.reshape(w.shape[0], w.shape[1]).t()

    def forward(self, x: torch.Tensor, train: bool = False,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """The conv in the compute ``dtype`` (``dense``), then BatchNorm and
        LeakyReLU in f32."""
        return leaky_relu(self[1](dense(x, self.kernel(), dtype=dtype),
                                  train), self.negative_slope)


class DenseBNReLU(nn.Sequential):
    """Linear (no bias) + BatchNorm1d + LeakyReLU for (B, C) activations;
    keys ``.0.weight`` and ``.1.*``."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2):
        super().__init__(Linear(in_features, features, bias=False),
                         BatchNorm(features))
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return leaky_relu(self[1](self[0](x), train), self.negative_slope)


class EdgeConv(nn.Sequential):
    """EdgeConv block: 1x1 conv over [neighbour, centre] edge features + BN
    + LeakyReLU + max over k.  Key ``.0.weight`` is the reference Conv2d
    weight (Co, 2C, 1, 1); ``W_nbr``/``W_ctr`` are its two column halves."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2):
        super().__init__(Weight((features, 2 * in_features, 1, 1)),
                         BatchNorm(features))
        self.negative_slope = negative_slope

    def split_weights(self):
        """(W_nbr, W_ctr), each (C, Co)."""
        w = self[0].weight
        w = w.reshape(w.shape[0], w.shape[1])
        c = w.shape[1] // 2
        return w[:, :c].t(), w[:, c:].t()

    def forward(self, x: torch.Tensor, idx: torch.Tensor | None = None,
                train: bool = False, *, graph: torch.Tensor | None = None,
                k: int | None = None, band: int = 0,
                amp: bool = False) -> torch.Tensor:
        """Either neighbour ``idx`` (B, N, k), or ``graph`` + ``k`` to build
        the graph in the layer.  With ``graph`` of a size the kernels take
        (``use_kernel``), eval runs the whole stage as one kernel
        (ops/edge_conv_kernel.py; with a ``band`` that prunes N points,
        ``banded_applicable``, the banded kernel of ops/banded.py) and
        training runs the differentiable kNN reductions
        (ops/knn_edge_reduce.py): kernels for CUDA tensors and their plain
        versions for CPU tensors.  Other sizes take ``knn`` and the ``idx``
        path, as the JAX package's XLA path does.  ``amp`` runs the eval
        stage in its AMP form, banded too (bf16 output), and training's
        kernels in theirs (f32 output); the caller resolves the mode
        (``ops.amp_select.use_amp_eval`` / ``use_amp_train``)."""
        w_nbr, w_ctr = self.split_weights()
        bn = self[1]
        if idx is None:
            if graph is None or k is None:
                raise ValueError("EdgeConv needs either idx or (graph, k)")
            if not use_kernel(graph.shape[1]):
                return self(x, knn(graph, k), train)
            if train:
                return self._train_fused(x, graph, k, w_nbr, w_ctr, amp)
            s, t = bn.folded()
            if banded_applicable(graph.shape[1], band):
                return banded_edge_conv_eval(graph, x, w_nbr, w_ctr, s, t, k,
                                             band, self.negative_slope,
                                             amp=amp)
            return edge_conv_eval(graph, x, w_nbr, w_ctr, s, t, k,
                                  self.negative_slope, amp=amp)
        if train:
            mean, var = edge_conv_batch_stats(x, idx, w_nbr, w_ctr)
            s, t = bn.push_stats(mean, var,
                                 x.shape[0] * x.shape[1] * idx.shape[-1])
        else:
            s, t = bn.folded()
        return edge_conv_fused(x, idx, w_nbr, w_ctr, s, t, self.negative_slope)

    def _train_fused(self, x, graph, k: int, w_nbr, w_ctr,
                     amp: bool = False) -> torch.Tensor:
        """Training stage from the kernel sums: kNN + max/min/sum/sum² over
        the neighbours of ``a = x @ W_nbr``, the BatchNorm statistics of the
        virtual edge tensor in closed form from them, then the affine and
        LeakyReLU of max over k (dgcnn_tpu nn_layers.py:226-248, 280-282).
        Stages whose raw input needs fewer 128-lane passes than the
        projection (128 -> 256) select raw rows (the select-x form).
        ``amp``: the kernels' AMP forms (the selected values bf16, the
        sums f32); the projections stay f32 products, as the JAX
        package's are on the CPU."""
        bn = self[1]
        b = _project(x, w_ctr)
        cin, co = w_nbr.shape
        if -(-cin // 128) < -(-co // 128):
            _, amax, amin, asum, asumsq = knn_edge_reduce_xw(
                graph, x, w_nbr.contiguous(), k, amp)
        else:
            _, amax, amin, asum, asumsq = knn_edge_reduce(
                graph, _project(x, w_nbr), k, amp)
        mean, var = edge_stats_from_sums(asum, asumsq, b, k)
        s, t = bn.push_stats(mean, var, x.shape[0] * x.shape[1] * k)
        sel = torch.where(s > 0, amax, amin) + b
        return leaky_relu(sel * s + t, self.negative_slope)
