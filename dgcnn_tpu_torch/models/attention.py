"""The fork's attention modules (port of dgcnn_tpu/models/attention.py;
reference models/attention.py), plain torch, as the JAX package leaves them
to XLA:

* ``scaled_dot_attention`` and ``MultiHeadedAttention``: annotated-
  transformer multi-head attention with four Linears (reference
  attention.py:17-71); defined by the reference, unused by its ``Net``.
* ``VectorAttention``: Point-Transformer-style subtraction attention over
  each point's kNN neighbourhood of the point cloud (reference
  attention.py:74-157), the attention of the custom ``Transformer``.
* ``MultiHeadVectorAttention``: its multi-head variant with a grouped
  (per-head) attention MLP (reference attention.py:160-255).

The kNN of the point cloud is ``ops.knn.knn``: kernel 11 (``csrc/
knn_idx.cu``) on CUDA tensors of a size the kernels take, its plain
version otherwise.  Every call computes its own graph, as the JAX modules
do.

The reference's quirks, kept as the JAX package keeps them:
  - the relative term subtracts gathered queries from gathered keys with
    one index, q_j - k_j (not the Point Transformer's q_i - k_j;
    attention.py:125-130);
  - single-head: softmax over the channels, then L2 over the k neighbours
    (attention.py:145-146); multi-head: softmax over the neighbours, then
    L2 over the points axis (attention.py:242-243).
The reference's gathers (attention.py:115-134) flatten (B, N) without a
per-batch base and read the (B, 3, N) cloud untransposed; here, as in the
JAX package, each batch gathers its own rows of the true xyz.

State-dict keys follow the flax names: ``w_q.weight`` (d_qkv, emb),
``pos_mlp_1.{weight,bias}``, ..., ``to_out.{weight,bias}``; the grouped
MLP's ``attn_mlp_1`` (h, d, 4d), ``attn_mlp_1_bias`` (h, 4d),
``attn_mlp_2`` and ``attn_mlp_2_bias`` as they are.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dgcnn_tpu_torch.models.nn_layers import Dropout, Linear
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import knn


def scaled_dot_attention(query: torch.Tensor, key: torch.Tensor,
                         value: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         dropout: Dropout | None = None, train: bool = False,
                         generator: torch.Generator | None = None):
    """softmax(q k^T / sqrt(d), masked where ``mask`` is 0) (dropped in
    training) @ v over the last two axes: (output, probabilities)
    (reference attention.py:17-28)."""
    scores = torch.matmul(query, key.transpose(-1, -2)) / math.sqrt(
        query.shape[-1])
    if mask is not None:
        scores = torch.where(mask == 0, -1e9, scores)
    p_attn = torch.softmax(scores, dim=-1)
    if dropout is not None:
        p_attn = dropout(p_attn, train, generator)
    return torch.matmul(p_attn, value), p_attn


class MultiHeadedAttention(nn.Module):
    """Four-Linear multi-head attention (reference attention.py:31-71):
    ``w_q``, ``w_k``, ``w_v`` (with bias) split into ``h`` heads,
    ``scaled_dot_attention`` (its probabilities dropped at ``dropout`` in
    training), heads merged, ``w_out``."""

    def __init__(self, h: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        if d_model % h:
            raise ValueError(f"d_model {d_model} is not a multiple of h {h}")
        self.h = h
        self.w_q = Linear(d_model, d_model)
        self.w_k = Linear(d_model, d_model)
        self.w_v = Linear(d_model, d_model)
        self.w_out = Linear(d_model, d_model)
        self.drop = Dropout(dropout)

    def forward(self, query, key, value, mask=None, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b = query.shape[0]

        def split(x, lin):
            return lin(x).reshape(b, -1, self.h,
                                  x.shape[-1] // self.h).transpose(1, 2)

        q, k, v = split(query, self.w_q), split(key, self.w_k), split(
            value, self.w_v)
        if mask is not None:
            mask = mask[:, None]
        x, _ = scaled_dot_attention(q, k, v, mask, self.drop, train,
                                    generator)
        return self.w_out(x.transpose(1, 2).reshape(b, -1, q.shape[1]
                                                    * q.shape[-1]))


def _relative_positions(canonical: torch.Tensor, k: int):
    """The kNN of the cloud (kernel 11 on the card) and each edge's
    neighbour-minus-centre offset: (idx (B, N, k), rel (B, N, k, 3))."""
    idx = knn(canonical, k)
    rel = gather_neighbors(canonical, idx) - canonical[:, :, None, :]
    return idx, rel


def _l2_normalize(attn: torch.Tensor, dim: int) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(attn * attn, dim=dim, keepdim=True))
    return attn / torch.clamp_min(norm, 1e-12)


class VectorAttention(nn.Module):
    """Single-head vector (subtraction) attention over the kNN
    neighbourhoods of ``canonical`` (reference attention.py:74-157):
    query, key, value (B, N, emb) and canonical (B, N, 3) -> (B, N, emb)."""

    def __init__(self, emb_dim: int, d_qkv: int = 64, k: int = 32,
                 pos_mlp_hidden_dim: int = 64, attn_mlp_hidden_mult: int = 4):
        super().__init__()
        self.k = k
        self.w_q = Linear(emb_dim, d_qkv, bias=False)
        self.w_k = Linear(emb_dim, d_qkv, bias=False)
        self.w_v = Linear(emb_dim, d_qkv, bias=False)
        self.pos_mlp_1 = Linear(3, pos_mlp_hidden_dim)
        self.pos_mlp_2 = Linear(pos_mlp_hidden_dim, d_qkv)
        self.attn_mlp_1 = Linear(d_qkv, d_qkv * attn_mlp_hidden_mult)
        self.attn_mlp_2 = Linear(d_qkv * attn_mlp_hidden_mult, d_qkv)
        self.to_out = Linear(d_qkv, emb_dim)

    def forward(self, query, key, value, canonical,
                train: bool = False) -> torch.Tensor:
        q, k_, v = self.w_q(query), self.w_k(key), self.w_v(value)
        idx, rel = _relative_positions(canonical, self.k)
        rel_pos_emb = self.pos_mlp_2(torch.relu(self.pos_mlp_1(rel)))
        # the reference gathers q and k with the same index (q_j - k_j)
        qk_rel = gather_neighbors(q - k_, idx)
        v_g = gather_neighbors(v, idx) + rel_pos_emb
        sim = self.attn_mlp_2(torch.relu(self.attn_mlp_1(qk_rel
                                                         + rel_pos_emb)))
        # softmax over the channels, L2 over the k neighbours
        attn = _l2_normalize(torch.softmax(sim, dim=-1), dim=-2)
        return self.to_out(torch.sum(attn * v_g, dim=2))


class MultiHeadVectorAttention(nn.Module):
    """Multi-head vector attention with a grouped (per-head) attention MLP
    (reference attention.py:160-255): ``n_heads`` heads of ``dim_head``,
    the grouped convs as block-diagonal per-head products."""

    def __init__(self, emb_dim: int, n_heads: int = 4, dim_head: int = 64,
                 k: int = 32, pos_mlp_hidden_dim: int = 64,
                 attn_mlp_hidden_mult: int = 4):
        super().__init__()
        self.k, self.h, self.d = k, n_heads, dim_head
        inner, e = n_heads * dim_head, dim_head * attn_mlp_hidden_mult
        self.w_q = Linear(emb_dim, inner, bias=False)
        self.w_k = Linear(emb_dim, inner, bias=False)
        self.w_v = Linear(emb_dim, inner, bias=False)
        self.pos_mlp_1 = Linear(3, pos_mlp_hidden_dim)
        self.pos_mlp_2 = Linear(pos_mlp_hidden_dim, inner)
        self.attn_mlp_1 = nn.Parameter(torch.zeros(n_heads, dim_head, e))
        self.attn_mlp_1_bias = nn.Parameter(torch.zeros(n_heads, e))
        self.attn_mlp_2 = nn.Parameter(torch.zeros(n_heads, e, dim_head))
        self.attn_mlp_2_bias = nn.Parameter(torch.zeros(n_heads, dim_head))
        self.to_out = Linear(inner, emb_dim)

    def forward(self, query, key, value, canonical,
                train: bool = False) -> torch.Tensor:
        b, n = query.shape[:2]
        q, k_, v = self.w_q(query), self.w_k(key), self.w_v(value)
        idx, rel = _relative_positions(canonical, self.k)
        rel_pos_emb = self.pos_mlp_2(torch.relu(self.pos_mlp_1(rel)))
        qk_rel = gather_neighbors(q - k_, idx)
        v_g = gather_neighbors(v, idx) + rel_pos_emb
        x = (qk_rel + rel_pos_emb).reshape(b, n, self.k, self.h, self.d)
        x = torch.relu(torch.einsum("bnkhd,hde->bnkhe", x, self.attn_mlp_1)
                       + self.attn_mlp_1_bias)
        sim = (torch.einsum("bnkhe,hed->bnkhd", x, self.attn_mlp_2)
               + self.attn_mlp_2_bias).reshape(b, n, self.k, -1)
        # softmax over the neighbours, L2 over the points axis
        attn = _l2_normalize(torch.softmax(sim, dim=2), dim=1)
        return self.to_out(torch.sum(attn * v_g, dim=2))
