"""Building-block layers, eval mode (port of dgcnn_tpu/models/nn_layers.py).

Channels-last throughout: a reference 1x1 Conv1d/Conv2d is a product over
the trailing feature axis.  Parameters keep the reference state-dict layout
(``<conv>.0.weight`` as a Conv weight, ``<conv>.1.*`` as a BatchNorm), so a
reference checkpoint, or a flax model exported by
``dgcnn_tpu/convert/torch_export.py``, loads with a strict
``load_state_dict``.

Training is not ported yet (see ROADMAP.md): ``train=True`` raises.
"""
from __future__ import annotations

import torch
from torch import nn

from dgcnn_tpu_torch.ops.edge_conv import edge_conv_fused, fold_bn
from dgcnn_tpu_torch.ops.edge_conv_kernel import edge_conv_eval

TRAIN_NOT_PORTED = ("training is not ported to dgcnn_tpu_torch yet; "
                    "see ROADMAP.md")


def reject_train(train: bool) -> None:
    if train:
        raise NotImplementedError(TRAIN_NOT_PORTED)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


class Weight(nn.Module):
    """Holds one weight tensor under the key ``weight``: the ``.0`` slot of
    a reference ``Sequential(Conv, BatchNorm, ...)``."""

    def __init__(self, shape):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))


class Linear(nn.Module):
    """torch.nn.Linear's parameters and math, without its implicit
    global-RNG initialization (models initialize from a Generator)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((out_features, in_features)))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """torch BatchNorm in eval mode over the trailing channel axis: running
    statistics, eps 1e-5."""

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        reject_train(train)
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return leaky_relu(self[1](torch.matmul(x, self.kernel()), train),
                          self.negative_slope)


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
                k: int | None = None) -> torch.Tensor:
        """Either neighbour ``idx`` (B, N, k), or ``graph`` + ``k`` to build
        the graph in the layer: then a CUDA tensor runs the whole stage as
        one kernel (ops/edge_conv_kernel.py), which raises on shapes it does
        not take, and a CPU tensor runs the kernel's plain version."""
        reject_train(train)
        w_nbr, w_ctr = self.split_weights()
        s, t = self[1].folded()
        if idx is None:
            if graph is None or k is None:
                raise ValueError("EdgeConv needs either idx or (graph, k)")
            return edge_conv_eval(graph, x, w_nbr, w_ctr, s, t, k,
                                  self.negative_slope)
        return edge_conv_fused(x, idx, w_nbr, w_ctr, s, t,
                               self.negative_slope)
