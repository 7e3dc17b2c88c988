"""The fork's custom transformer (port of dgcnn_tpu/models/transformer.py;
reference models/transformer.py): an annotated-transformer EncoderDecoder
whose norms are BatchNorms (reference transformer.py:44, 61, 79), not
LayerNorms, and whose attention is ``VectorAttention`` over the kNN
neighbourhoods of the point cloud.  The fusion ``Net`` takes it with
``use_custom_attention``.

The reference's quirks, kept:
  - ``SublayerConnection`` adds the normalized input to the sublayer's
    output, x = BN(x); x + dropout(sublayer(x)) (transformer.py:82-86):
    the residual stream is normalized again at every sublayer;
  - the feed-forward is Linear -> LeakyReLU(0.1) -> BatchNorm -> Dropout
    -> Linear (transformer.py:124-138);
  - ``Transformer`` applies the one ``EncoderDecoder`` twice, one after
    the other, to (src, tgt) and then to (tgt, src) (transformer.py:171-
    175), and returns (src_embedding, tgt_embedding).  The two
    applications are not stacked on the batch axis: in training each
    normalizes with its own batch's statistics, and every BatchNorm's
    running statistics move twice, in that order.

Training (``train=True``) drops the feed-forward's hidden layer and every
residual branch at ``dropout`` (``nn_layers.Dropout``, from the caller's
``generator``).  Everything computes in f32, in both numerics modes: the
JAX ``Transformer`` has no compute dtype, and the fusion Net hands it f32
inputs in AMP too.

State-dict keys follow the flax tree: ``model.encoder_layer_{i}.self_attn.
w_q.weight``, ``....sub0.norm.{weight,bias,running_mean,running_var}``,
``....ff.{w_1,norm,w_2}``, ``model.decoder_layer_{i}.src_attn.*``,
``model.encoder_norm.*``, ``model.decoder_norm.*``
(``convert.state_dict_from_flax`` writes them).
"""
from __future__ import annotations

import torch
from torch import nn

from dgcnn_tpu_torch.models.attention import VectorAttention
from dgcnn_tpu_torch.models.nn_layers import (
    BatchNorm,
    Dropout,
    Linear,
    leaky_relu,
)


class SublayerConnection(nn.Module):
    """x = BN(x); x + dropout(sublayer(x))."""

    def __init__(self, d_model: int, dropout: float):
        super().__init__()
        self.norm = BatchNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, x, sublayer, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.norm(x, train)
        return x + self.drop(sublayer(x), train, generator)


class PositionwiseFeedForward(nn.Module):
    """Linear -> LeakyReLU(0.1) -> BatchNorm -> Dropout -> Linear."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = Linear(d_model, d_ff)
        self.norm = BatchNorm(d_ff)
        self.drop = Dropout(dropout)
        self.w_2 = Linear(d_ff, d_model)

    def forward(self, x, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.norm(leaky_relu(self.w_1(x), 0.1), train)
        return self.w_2(self.drop(x, train, generator))


class EncoderLayer(nn.Module):
    def __init__(self, emb_dim: int, d_qkv: int, k: int, ff_dims: int,
                 dropout: float):
        super().__init__()
        self.self_attn = VectorAttention(emb_dim, d_qkv, k)
        self.ff = PositionwiseFeedForward(emb_dim, ff_dims, dropout)
        self.sub0 = SublayerConnection(emb_dim, dropout)
        self.sub1 = SublayerConnection(emb_dim, dropout)

    def forward(self, x, pointcloud, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.sub0(x, lambda y: self.self_attn(y, y, y, pointcloud,
                                                  train), train, generator)
        return self.sub1(x, lambda y: self.ff(y, train, generator), train,
                         generator)


class DecoderLayer(nn.Module):
    def __init__(self, emb_dim: int, d_qkv: int, k: int, ff_dims: int,
                 dropout: float):
        super().__init__()
        self.self_attn = VectorAttention(emb_dim, d_qkv, k)
        self.src_attn = VectorAttention(emb_dim, d_qkv, k)
        self.ff = PositionwiseFeedForward(emb_dim, ff_dims, dropout)
        self.sub0 = SublayerConnection(emb_dim, dropout)
        self.sub1 = SublayerConnection(emb_dim, dropout)
        self.sub2 = SublayerConnection(emb_dim, dropout)

    def forward(self, x, memory, pointcloud, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.sub0(x, lambda y: self.self_attn(y, y, y, pointcloud,
                                                  train), train, generator)
        x = self.sub1(x, lambda y: self.src_attn(y, memory, memory,
                                                 pointcloud, train),
                      train, generator)
        return self.sub2(x, lambda y: self.ff(y, train, generator), train,
                         generator)


class EncoderDecoder(nn.Module):
    """``n_blocks`` encoder layers over src, BN (the memory), ``n_blocks``
    decoder layers over tgt, BN."""

    def __init__(self, emb_dim: int, d_qkv: int, k: int, ff_dims: int,
                 n_blocks: int, dropout: float):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            setattr(self, f"encoder_layer_{i}",
                    EncoderLayer(emb_dim, d_qkv, k, ff_dims, dropout))
        self.encoder_norm = BatchNorm(emb_dim)
        for i in range(n_blocks):
            setattr(self, f"decoder_layer_{i}",
                    DecoderLayer(emb_dim, d_qkv, k, ff_dims, dropout))
        self.decoder_norm = BatchNorm(emb_dim)

    def forward(self, src, tgt, pointcloud, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = src
        for i in range(self.n_blocks):
            x = getattr(self, f"encoder_layer_{i}")(x, pointcloud, train,
                                                    generator)
        memory = self.encoder_norm(x, train)
        y = tgt
        for i in range(self.n_blocks):
            y = getattr(self, f"decoder_layer_{i}")(y, memory, pointcloud,
                                                    train, generator)
        return self.decoder_norm(y, train)


class Transformer(nn.Module):
    """The custom transformer (reference transformer.py:141-177):
    channels-last (B, N, emb) src and tgt, (B, N, 3) pointcloud ->
    (src_embedding, tgt_embedding), the shared ``model`` applied to (src,
    tgt) and then to (tgt, src) (module docstring)."""

    def __init__(self, emb_dim: int = 512, n_blocks: int = 1,
                 d_qkv: int = 64, k: int = 32, ff_dims: int = 512,
                 dropout: float = 0.5):
        super().__init__()
        self.model = EncoderDecoder(emb_dim, d_qkv, k, ff_dims, n_blocks,
                                    dropout)

    def forward(self, src, tgt, pointcloud, train: bool = False,
                generator: torch.Generator | None = None):
        tgt_embedding = self.model(src, tgt, pointcloud, train, generator)
        src_embedding = self.model(tgt, src, pointcloud, train, generator)
        return src_embedding, tgt_embedding
