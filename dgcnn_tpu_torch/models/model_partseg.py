"""The fork's fusion network for part segmentation, for evaluation and
training (port of dgcnn_tpu/models/model_partseg.py; reference
models/model_partseg.py:95-194): DGCNN features and 3D-HOG gradient
features fused through a transformer.

``Net`` (reference :174-194):
                                   eval            training
  src_embedding = DGCNN(src)       kernel 1 x 4    kernels 3 x 3, 4; 5 x 4
  tgt           = HOG(src)         kernels 10, 9 (no gradient)
  tgt_embedding = grads_emb(tgt)   conv 18 -> emb/8 -> emb/4 -> emb/2 -> emb
  canonical     = pos_mlp(src)     PositionEmbedding: kernels 6 and 2 in
                                   eval, kernel 11 in training; conv 3 ->
                                   emb
  src', tgt'    = transformer(src_e, tgt_e) and transformer(tgt_e, src_e)
                  with src_e = src_embedding + canonical, tgt_e =
                  tgt_embedding + canonical, as ONE pass over the
                  batch-stacked pair: kernel 14 x 6 (in training also
                  15 x 6)
  scores        = attention(query=tgt', key=src', value=src'): kernel 14
                  (in training also 15)
  logits        = MLPHead(category one-hot, scores)

CUDA tensors launch the kernels, CPU tensors take their plain versions.
Training (``train=True``) drops at the model's ``dropout`` rate the
transformer's attention probabilities (in kernels 14 and 15), its
feed-forward and residual branches, the last attention's probabilities
and the head's ``dp1``-``dp3``, all drawn from the ``generator`` given to
``forward``; the BatchNorms normalize with the batch's statistics.  The
state-dict keys are ``export_net``'s (``emb_nn.*``, ``grads_emb.{0,1,3,4,
6,7,9,10}``, ``pos_mlp.0.*`` as the TransformNet's, ``pos_mlp.1`` /
``pos_mlp.2``, ``transformer.*`` as torch's, ``attention.*``,
``head.nn.{0,1,4,5,8,9,12}`` and ``head.label_conv.*``), so a reference
``transformer.pt`` loads with ``convert.load_checkpoint``.  The custom
vector-attention transformer (``use_custom_attention``) is not ported
yet.

The eval has the JAX package's two numerics modes (``Net.forward``'s
``amp``, resolved by ``ops.amp_select.use_amp_eval``): exact f32, and AMP
(the JAX ``Net``'s default, dgcnn_tpu/models/model_partseg.py:95-111):
the backbone's four stages, the PositionEmbedding's TransformNet and
conv3 pool in their AMP forms (kernels 1, 6 and 2), kernel 10 in v2, the
grads_emb convs, the transformer, the last attention (kernel 14's AMP
form) and the head's fc1-fc3 computing in bf16 (f32 parameters cast
down; BatchNorm, LayerNorm statistics and the softmax in f32), conv5, the
PositionEmbedding's conv and the label conv in f32, the logits f32.  The
whole forward switches at once: no forward mixes AMP and exact kernels.
Training is exact.
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
    Dropout,
    Weight,
    leaky_relu,
)
from dgcnn_tpu_torch.models.torch_transformer import (
    TorchMultiheadAttention,
    TorchTransformer,
)
from dgcnn_tpu_torch.ops.amp_select import use_amp_eval
from dgcnn_tpu_torch.ops.hog import compute_hog

_HOG_CHANNELS = 18


def _conv_bn(conv: Weight, bn: BatchNorm, x: torch.Tensor, train: bool,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """1x1 conv (no bias) in the compute ``dtype`` + BatchNorm (the batch's
    statistics in training, the running ones otherwise) + LeakyReLU(0.2),
    both in f32."""
    return leaky_relu(bn(conv.matmul(x, dtype), train), 0.2)


class MLPHead(nn.Module):
    """Per-point segmentation head with the category one-hot as a condition
    (reference models/model_partseg.py:95-139): ``label_conv`` (16 -> 64)
    broadcast to every point and concatenated before the features, then
    ``nn``: three conv + BatchNorm + LeakyReLU + dropout (``dp1``-``dp3``,
    training only) blocks (emb + 64 -> emb/2 -> emb/4 -> emb/8) and the
    conv with bias to the part labels (``nn.12``).  ``dtype`` is the
    compute dtype of ``nn.0``/``nn.4``/``nn.8`` (fc1-fc3); the label conv
    computes in f32 and its output joins ``attn`` in ``attn``'s dtype; the
    last conv promotes to f32."""

    def __init__(self, emb_dim: int = 512, nclasses: int = 50,
                 dropout: float = 0.5):
        super().__init__()
        self.label_conv = ConvBN(16, 64, dims=1)
        widths = [emb_dim + 64, emb_dim // 2, emb_dim // 4, emb_dim // 8]
        layers: list[nn.Module] = []
        for ci, co in zip(widths, widths[1:]):
            # the reference's LeakyReLU and dropout hold no parameters
            layers += [Weight((co, ci, 1)), BatchNorm(co), nn.Identity(),
                       Dropout(dropout)]
        layers.append(Weight((nclasses, widths[-1], 1), bias=True))
        self.nn = nn.ModuleList(layers)

    def forward(self, label_one_hot: torch.Tensor, attn: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        b, n, _ = attn.shape
        lbl = self.label_conv(label_one_hot[:, None, :], train)  # (B, 1, 64)
        x = torch.cat([lbl.to(attn.dtype).expand(b, n, 64), attn],
                      dim=-1)                                # (B, N, emb+64)
        for ci in (0, 4, 8):
            x = _conv_bn(self.nn[ci], self.nn[ci + 1], x, train, dtype)
            x = self.nn[ci + 3](x, train, generator)
        return self.nn[12].matmul(x)                         # (B, N, classes)


class Net(nn.Module):
    """The fork's trained model (reference models/model_partseg.py:
    142-194): (B, N, 3) points and (B, 16) category one-hot -> (B, N,
    nclasses) per-point logits (module docstring).  The transformer is
    ``torch.nn.Transformer`` with ``n_blocks`` encoder and decoder layers,
    ``n_heads`` heads of emb_dim / n_heads, feed-forward width ``ff_dims``,
    LeakyReLU(0.2) in the encoder and relu in the decoder (the reference's
    effective activations), and ``dropout`` in training.  HOG takes the
    reference's gather of same-axis triples with ``hog_bug_compat``, as a
    reference-trained ``transformer.pt`` needs.

    Eval has two numerics modes (module docstring): ``forward``'s ``amp``
    None takes AMP on the card unless ``DGCNN_TPU_PALLAS_EXACT`` is set
    and exact on the CPU; True or False asks for one (clouds the kNN
    kernels do not take, and k > 64, stay exact).  Training is exact (the
    AMP forms of its training kernels are not ported yet): ``train=True``
    with ``amp=True`` raises, and the backbone's training stages take the
    exact mode."""

    def __init__(self, emb_dim: int = 512, k: int = 32, n_heads: int = 4,
                 n_blocks: int = 2, ff_dims: int = 512, nclasses: int = 50,
                 dropout: float = 0.5, hog_bug_compat: bool = False,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.hog_bug_compat = hog_bug_compat
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
            encoder_activation="leaky_relu", decoder_activation="relu",
            dropout=dropout)
        self.attention = TorchMultiheadAttention(emb_dim, n_heads, dropout)
        self.head = MLPHead(emb_dim, nclasses, dropout)
        init_random_(self, _seeded(generator))
        self.to(device)
        self.eval()

    def forward(self, src: torch.Tensor, label_one_hot: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None, *,
                amp: bool | None = None) -> torch.Tensor:
        if train and amp:
            raise ValueError("Net trains in the exact mode only")
        amp = not train and use_amp_eval(amp, src.device, src.shape[1],
                                         self.k)
        dt = torch.bfloat16 if amp else torch.float32
        src_embedding = self.emb_nn(src, train, amp)           # (B, N, emb)
        h = compute_hog(src, self.k, bug_compat=self.hog_bug_compat, amp=amp)
        for ci in range(0, len(self.grads_emb), 3):
            h = _conv_bn(self.grads_emb[ci], self.grads_emb[ci + 1], h,
                         train, dt)
        canonical = _conv_bn(self.pos_mlp[1], self.pos_mlp[2],
                             self.pos_mlp[0](src, self.k, train, amp=amp),
                             train)                            # (B, N, emb)
        src_e = src_embedding + canonical
        tgt_e = h + canonical
        # the reference calls the one transformer twice with (src, tgt)
        # swapped; its weights are shared and every layer of it acts per
        # cloud (LayerNorms, no BatchNorm), so the two passes stack on the
        # batch axis and run as one; the dropout bits are keyed by the
        # stacked batch index, so each half draws its own masks, as torch's
        # two calls do
        both = self.transformer(torch.cat([src_e, tgt_e], dim=0),
                                torch.cat([tgt_e, src_e], dim=0), train,
                                generator, dt)
        src_p, tgt_p = both.chunk(2, dim=0)
        scores = self.attention(tgt_p, src_p, src_p, train, generator, dt)
        return self.head(label_one_hot, scores, train, generator, dt)
