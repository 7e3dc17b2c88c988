"""``torch.nn.Transformer`` and ``torch.nn.MultiheadAttention`` as the
fusion Net instantiates them (reference models/model_partseg.py:167-171),
for evaluation and training (port of
dgcnn_tpu/models/torch_transformer.py).

batch_first layout, post-LayerNorm residual blocks (eps 1e-5), a packed
in-projection (``in_proj_weight`` 3E x E, ``in_proj_bias`` 3E) applied as
three separate products, as the JAX package does, an output projection
with bias, and final LayerNorms after the encoder and decoder stacks; the
state-dict keys are torch's (``encoder.layers.i.self_attn.in_proj_weight``,
``decoder.layers.i.multihead_attn.*``, ``linear1``, ``norm3``,
``encoder.norm``, ...), the layout ``export_torch_transformer`` writes.

The attention itself is ``ops.attention.fused_attention``: kernel 14
(backward: kernel 15) on CUDA tensors, its plain dense version on CPU ones
and for head dims the kernels do not take (``HEAD_DIMS``; the JAX package
takes its dense path there too); never ``nn.MultiheadAttention`` or
``scaled_dot_product_attention``.

Feed-forward activation quirk, kept: the reference asks for
``nn.LeakyReLU(0.2)``, but ``nn.Transformer`` deep-copies its layers and
``TransformerDecoderLayer.__setstate__`` resets a module activation to
``F.relu``, so the trained reference ran LeakyReLU(0.2) in the encoder and
relu in the decoder; each stack takes its own activation.

Each ``forward`` takes a compute ``dtype``: f32 (the default, the exact
mode) or bf16, the AMP fusion Net in eval and in training, which mirrors
flax's ``nn.Dense(dtype=bf16)`` and ``nn.LayerNorm(dtype=bf16)`` as
dgcnn_tpu/models/torch_transformer.py:133-152,247-375 use them: the
projections in bf16 (``nn_layers.dense``: the product rounded to bf16,
then the bias added in bf16; its backward's products with f32 sums), the
attention on bf16 q, k and v (kernel 14's AMP forms on CUDA tensors with d
in ``HEAD_DIMS``, kernel 15's bf16 form backward; their plain versions
otherwise), the feed-forward's activation on bf16 values, each residual
sum in the promoted dtype of its operands (an f32 input plus a bf16 branch
is f32) and each LayerNorm's statistics in f32 with a bf16 result
(``nn_layers.layer_norm``).

Training (``train=True``) drops, at the modules' ``dropout`` rate, the
attention probabilities (in the kernels, a fresh int64 seed a call drawn
from the caller's ``generator``), the feed-forward hidden layer and every
residual branch (``nn_layers.Dropout``, from the same generator, on the
values in their compute dtype: bf16 ones in bf16), as the JAX modules do.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dgcnn_tpu_torch.models.nn_layers import (
    Dropout,
    Linear,
    dense,
    layer_norm,
    leaky_relu,
)
from dgcnn_tpu_torch.ops.attention import (
    HEAD_DIMS,
    attention_amp_train_plain,
    attention_plain,
    fused_attention,
)

F32 = torch.float32


class TorchMultiheadAttention(nn.Module):
    """``nn.MultiheadAttention(batch_first=True)``'s parameters and math: q,
    k and v projected by the three row blocks of ``in_proj_weight``, split
    into heads, dropout(softmax(q k^T / sqrt(d))) v per head (kernels 14
    and 15; dropout in training only), heads merged, ``out_proj``; in the
    compute ``dtype`` of ``forward`` (module docstring)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                dtype: torch.dtype = F32) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        d = e // h
        b, nq, _ = query.shape
        w, bias = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):
            # (B, N, E) -> (B, h, N, d), a view of the projection
            sl = slice(i * e, (i + 1) * e)
            y = dense(x, w[sl].t(), bias[sl], dtype)
            return y.reshape(b, -1, h, d).transpose(1, 2)

        rate = self.dropout if train else 0.0
        seed = None
        if rate > 0.0:
            if generator is None:
                raise ValueError("dropout in training needs a "
                                 "torch.Generator")
            seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=query.device)
        q, k, v = heads(query, 0), heads(key, 1), heads(value, 2)
        scale = 1.0 / math.sqrt(d)
        if d in HEAD_DIMS:
            out = fused_attention(q, k, v, scale, rate, seed)
        elif dtype == F32:
            out = attention_plain(q, k, v, scale, rate, seed)
        else:
            out = attention_amp_train_plain(q, k, v, scale, rate, seed)[0]
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, e), dtype)


def _activation(name: str):
    if name == "relu":
        return torch.relu
    if name == "leaky_relu":
        return lambda x: leaky_relu(x, 0.2)
    raise ValueError(name)


def _feed_forward(layer: nn.Module, x: torch.Tensor, train: bool,
                  generator: torch.Generator | None,
                  dtype: torch.dtype = F32) -> torch.Tensor:
    """linear2(dropout(act(linear1(x)))) of an encoder or decoder layer, in
    the compute ``dtype``."""
    h = layer.dropout(layer._act(layer.linear1(x, dtype)), train, generator)
    return layer.linear2(h, dtype)


class TorchTransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: x = norm1(x + dropout(self_attn(x))); x =
    norm2(x + dropout(linear2(dropout(act(linear1(x))))))."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        # torch's names: the feed-forward's hidden dropout, then one a
        # residual branch
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self._act = _activation(activation)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                dtype: torch.dtype = F32) -> torch.Tensor:
        sa = self.self_attn(x, x, x, train, generator, dtype)
        x = layer_norm(self.norm1, x + self.dropout1(sa, train, generator),
                       dtype)
        ff = _feed_forward(self, x, train, generator, dtype)
        return layer_norm(self.norm2, x + self.dropout2(ff, train, generator),
                          dtype)


class TorchTransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention, cross-attention over
    ``memory``, feed-forward, each (dropped in training) followed by its
    residual LayerNorm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = TorchMultiheadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self._act = _activation(activation)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None,
                dtype: torch.dtype = F32) -> torch.Tensor:
        sa = self.self_attn(x, x, x, train, generator, dtype)
        x = layer_norm(self.norm1, x + self.dropout1(sa, train, generator),
                       dtype)
        ca = self.multihead_attn(x, memory, memory, train, generator, dtype)
        x = layer_norm(self.norm2, x + self.dropout2(ca, train, generator),
                       dtype)
        ff = _feed_forward(self, x, train, generator, dtype)
        return layer_norm(self.norm3, x + self.dropout3(ff, train, generator),
                          dtype)


class _Stack(nn.Module):
    """``layers`` then the final ``norm`` (torch's TransformerEncoder /
    TransformerDecoder keys)."""

    def __init__(self, layers: list[nn.Module], d_model: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)


class TorchTransformer(nn.Module):
    """``torch.nn.Transformer`` (encoder-decoder, post-norm, final
    LayerNorms) as the fork instantiates it: (src, tgt) (B, N, E) ->
    decoder(tgt, encoder(src)) (B, N, E), with dropout ``dropout`` in
    training."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048,
                 encoder_activation: str = "relu",
                 decoder_activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.encoder = _Stack(
            [TorchTransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                          encoder_activation, dropout)
             for _ in range(num_encoder_layers)], d_model)
        self.decoder = _Stack(
            [TorchTransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                          decoder_activation, dropout)
             for _ in range(num_decoder_layers)], d_model)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None,
                dtype: torch.dtype = F32) -> torch.Tensor:
        mem = src
        for layer in self.encoder.layers:
            mem = layer(mem, train, generator, dtype)
        mem = layer_norm(self.encoder.norm, mem, dtype)
        out = tgt
        for layer in self.decoder.layers:
            out = layer(out, mem, train, generator, dtype)
        return layer_norm(self.decoder.norm, out, dtype)
