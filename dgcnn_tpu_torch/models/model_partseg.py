"""The fork's fusion network for part segmentation, for evaluation (port of
dgcnn_tpu/models/model_partseg.py; reference models/model_partseg.py:
95-194): DGCNN features and 3D-HOG gradient features fused through a
transformer.

``Net`` (reference :174-194):
  src_embedding = DGCNN(src)                    emb_nn: kernel 1 x 4
  tgt           = HOG(src)                      kernels 10 and 9
  tgt_embedding = grads_emb(tgt)                conv 18 -> emb/8 -> emb/4
                                                -> emb/2 -> emb
  canonical     = pos_mlp(src)                  PositionEmbedding (kernels
                                                6 and 2), conv 3 -> emb
  src', tgt'    = transformer(src_e, tgt_e) and transformer(tgt_e, src_e)
                  with src_e = src_embedding + canonical, tgt_e =
                  tgt_embedding + canonical, as ONE pass over the
                  batch-stacked pair                      kernel 14 x 6
  scores        = attention(query=tgt', key=src', value=src')  kernel 14
  logits        = MLPHead(category one-hot, scores)

CUDA tensors launch the kernels, CPU tensors take their plain versions.
The state-dict keys are ``export_net``'s (``emb_nn.*``, ``grads_emb.{0,1,
3,4,6,7,9,10}``, ``pos_mlp.0.*`` as the TransformNet's, ``pos_mlp.1`` /
``pos_mlp.2``, ``transformer.*`` as torch's, ``attention.*``,
``head.nn.{0,1,4,5,8,9,12}`` and ``head.label_conv.*``), so a reference
``transformer.pt`` loads with ``convert.load_checkpoint``.  Training
(dropout on the attention probabilities, kernels 15-16) and the custom
vector-attention transformer are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    PositionEmbedding,
    _seeded,
    init_random_,
)
from dgcnn_tpu_torch.models.nn_layers import (
    BatchNorm,
    ConvBN,
    Weight,
    leaky_relu,
)
from dgcnn_tpu_torch.models.torch_transformer import (
    TorchMultiheadAttention,
    TorchTransformer,
)
from dgcnn_tpu_torch.ops.hog import compute_hog

_HOG_CHANNELS = 18


def _conv_bn(conv: Weight, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv (no bias) + BatchNorm (running statistics) + LeakyReLU(0.2)."""
    return leaky_relu(bn(conv.matmul(x)), 0.2)


class MLPHead(nn.Module):
    """Per-point segmentation head with the category one-hot as a condition
    (reference models/model_partseg.py:95-139): ``label_conv`` (16 -> 64)
    broadcast to every point and concatenated before the features, then
    ``nn``: three conv + BatchNorm + LeakyReLU (+ dropout in training)
    blocks (emb + 64 -> emb/2 -> emb/4 -> emb/8) and the conv with bias to
    the part labels (``nn.12``)."""

    def __init__(self, emb_dim: int = 512, nclasses: int = 50):
        super().__init__()
        self.label_conv = ConvBN(16, 64, dims=1)
        widths = [emb_dim + 64, emb_dim // 2, emb_dim // 4, emb_dim // 8]
        layers: list[nn.Module] = []
        for ci, co in zip(widths, widths[1:]):
            # the reference's LeakyReLU and dropout hold no parameters
            layers += [Weight((co, ci, 1)), BatchNorm(co), nn.Identity(),
                       nn.Identity()]
        layers.append(Weight((nclasses, widths[-1], 1), bias=True))
        self.nn = nn.ModuleList(layers)

    def forward(self, label_one_hot: torch.Tensor,
                attn: torch.Tensor) -> torch.Tensor:
        b, n, _ = attn.shape
        lbl = self.label_conv(label_one_hot[:, None, :])       # (B, 1, 64)
        x = torch.cat([lbl.expand(b, n, 64), attn], dim=-1)    # (B, N, emb+64)
        for ci in (0, 4, 8):
            x = _conv_bn(self.nn[ci], self.nn[ci + 1], x)
        return self.nn[12].matmul(x)                         # (B, N, classes)


class Net(nn.Module):
    """The fork's trained model (reference models/model_partseg.py:
    142-194), eval forward: (B, N, 3) points and (B, 16) category one-hot
    -> (B, N, nclasses) per-point logits (module docstring).  The
    transformer is ``torch.nn.Transformer`` with ``n_blocks`` encoder and
    decoder layers, ``n_heads`` heads of emb_dim / n_heads, feed-forward
    width ``ff_dims``, LeakyReLU(0.2) in the encoder and relu in the
    decoder (the reference's effective activations)."""

    def __init__(self, emb_dim: int = 512, k: int = 32, n_heads: int = 4,
                 n_blocks: int = 2, ff_dims: int = 512, nclasses: int = 50,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.emb_nn = DGCNN(emb_dim, k)
        widths = [_HOG_CHANNELS, emb_dim // 8, emb_dim // 4, emb_dim // 2,
                  emb_dim]
        layers: list[nn.Module] = []
        for ci, co in zip(widths, widths[1:]):
            layers += [Weight((co, ci, 1)), BatchNorm(co), nn.Identity()]
        self.grads_emb = nn.ModuleList(layers[:-1])
        self.pos_mlp = nn.ModuleList([PositionEmbedding(),
                                      Weight((emb_dim, 3, 1)),
                                      BatchNorm(emb_dim)])
        self.transformer = TorchTransformer(
            d_model=emb_dim, nhead=n_heads, num_encoder_layers=n_blocks,
            num_decoder_layers=n_blocks, dim_feedforward=ff_dims,
            encoder_activation="leaky_relu", decoder_activation="relu")
        self.attention = TorchMultiheadAttention(emb_dim, n_heads)
        self.head = MLPHead(emb_dim, nclasses)
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, src: torch.Tensor,
                label_one_hot: torch.Tensor) -> torch.Tensor:
        src_embedding = self.emb_nn(src)                       # (B, N, emb)
        h = compute_hog(src, self.k)
        for ci in range(0, len(self.grads_emb), 3):
            h = _conv_bn(self.grads_emb[ci], self.grads_emb[ci + 1], h)
        canonical = _conv_bn(self.pos_mlp[1], self.pos_mlp[2],
                             self.pos_mlp[0](src, self.k))     # (B, N, emb)
        src_e = src_embedding + canonical
        tgt_e = h + canonical
        # the reference calls the one transformer twice with (src, tgt)
        # swapped; its weights are shared and every layer acts per cloud in
        # eval, so the two passes stack on the batch axis and run as one
        both = self.transformer(torch.cat([src_e, tgt_e], dim=0),
                                torch.cat([tgt_e, src_e], dim=0))
        src_p, tgt_p = both.chunk(2, dim=0)
        scores = self.attention(tgt_p, src_p, src_p)
        return self.head(label_one_hot, scores)
