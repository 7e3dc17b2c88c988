"""``torch.nn.Transformer`` and ``torch.nn.MultiheadAttention`` as the
fusion Net instantiates them (reference models/model_partseg.py:167-171),
for evaluation (port of dgcnn_tpu/models/torch_transformer.py).

batch_first layout, post-LayerNorm residual blocks (eps 1e-5), a packed
in-projection (``in_proj_weight`` 3E x E, ``in_proj_bias`` 3E) applied as
three separate products, as the JAX package does, an output projection
with bias, and final LayerNorms after the encoder and decoder stacks; the
state-dict keys are torch's (``encoder.layers.i.self_attn.in_proj_weight``,
``decoder.layers.i.multihead_attn.*``, ``linear1``, ``norm3``,
``encoder.norm``, ...), the layout ``export_torch_transformer`` writes.

The attention itself is ``ops.attention.fused_attention``: kernel 14 on
CUDA tensors, its plain dense version on CPU ones; never
``nn.MultiheadAttention`` or ``scaled_dot_product_attention``.

Feed-forward activation quirk, kept: the reference asks for
``nn.LeakyReLU(0.2)``, but ``nn.Transformer`` deep-copies its layers and
``TransformerDecoderLayer.__setstate__`` resets a module activation to
``F.relu``, so the trained reference ran LeakyReLU(0.2) in the encoder and
relu in the decoder; each stack takes its own activation.

Dropout (training) is not ported yet: every module here is the eval
forward.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dgcnn_tpu_torch.models.nn_layers import Linear, leaky_relu
from dgcnn_tpu_torch.ops.attention import fused_attention


class TorchMultiheadAttention(nn.Module):
    """``nn.MultiheadAttention(batch_first=True)``'s parameters and eval
    math: q, k and v projected by the three row blocks of
    ``in_proj_weight``, split into heads, softmax(q k^T / sqrt(d)) v per
    head (kernel 14), heads merged, ``out_proj``."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        d = e // h
        b, nq, _ = query.shape
        w, bias = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):
            # (B, N, E) -> (B, h, N, d), a view of the projection
            y = torch.matmul(x, w[i * e:(i + 1) * e].t()) + bias[
                i * e:(i + 1) * e]
            return y.reshape(b, -1, h, d).transpose(1, 2)

        out = fused_attention(heads(query, 0), heads(key, 1),
                              heads(value, 2), 1.0 / math.sqrt(d))
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, e))


def _activation(name: str):
    if name == "relu":
        return torch.relu
    if name == "leaky_relu":
        return lambda x: leaky_relu(x, 0.2)
    raise ValueError(name)


class TorchTransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: x = norm1(x + self_attn(x)); x = norm2(x +
    linear2(act(linear1(x))))."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu"):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self._act = _activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, x))
        return self.norm2(x + self.linear2(self._act(self.linear1(x))))


class TorchTransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention, cross-attention over
    ``memory``, feed-forward, each followed by its residual LayerNorm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu"):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead)
        self.multihead_attn = TorchMultiheadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self._act = _activation(activation)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, x))
        x = self.norm2(x + self.multihead_attn(x, memory, memory))
        return self.norm3(x + self.linear2(self._act(self.linear1(x))))


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
    decoder(tgt, encoder(src)) (B, N, E)."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048,
                 encoder_activation: str = "relu",
                 decoder_activation: str = "relu"):
        super().__init__()
        self.encoder = _Stack(
            [TorchTransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                          encoder_activation)
             for _ in range(num_encoder_layers)], d_model)
        self.decoder = _Stack(
            [TorchTransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                          decoder_activation)
             for _ in range(num_decoder_layers)], d_model)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        mem = src
        for layer in self.encoder.layers:
            mem = layer(mem)
        mem = self.encoder.norm(mem)
        out = tgt
        for layer in self.decoder.layers:
            out = layer(out, mem)
        return self.decoder.norm(out)
