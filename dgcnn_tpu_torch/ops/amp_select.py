"""The AMP (bf16) mode of the eval kNN kernels in plain torch: the mode
switch, the scores, the packed-key selection v2 and the class walk v3.

Ports of the JAX package's default numerics (``dgcnn_tpu/ops/
pallas_knn.py``), which its kernels run unless ``DGCNN_TPU_PALLAS_EXACT``
is set:

- ``exact_mode`` reads the variable as ``_train_exact`` (:531) does.
- ``amp_scores``: ``_scores(exact=False)`` (:293).  Two bf16 inputs give
  one f32 product of bf16 values (exact products, f32 sums); otherwise
  each input splits into a bf16 high part and a bf16 low part and the
  inner product is three such products, hi.hi + hi.lo + lo.hi, added in
  that order.  Then ``2 inner - |q|^2 - |x|^2``.
- ``pack_keys``: ``_pack_keys`` (:87).  Each row's scores are quantized to
  the grid of its minimum, ``q = max(round(s * lim / -rmin), -lim)`` with
  ``lim = 2^(31 - b) - 1`` and b the bits of an index (rounding half to
  even), and packed with the negated column into ``q * 2^b + (n - 1 -
  col)``; a row whose minimum is not negative gets scale 0.
- ``v2_indices``: ``_extract_loop_v2`` (:123), the k largest keys: the k
  largest q, lowest column first among equal ones.
- ``v3_class_means``: ``_extract_loop_v3`` (:151), the eval class walk.
  The classes of a row are its k largest distinct scores; a class is
  consumed as the mean of its members' payload rows (f32 sums of the bf16
  rows, divided by the count), and a row with fewer than k distinct scores
  walks its last class again, which the max and min it feeds ignore.
- ``select_x_plan``: ``select_x_plan`` (:244), copied.

The CUDA kernels of the AMP mode (``csrc/edge_conv_eval.cu``'s AMP
instances) compute the same selections; these are their plain versions.
"""
from __future__ import annotations

import os

import torch

EXACT_ENV = "DGCNN_TPU_PALLAS_EXACT"
# the AMP kernel's longest list (its tiled route alone)
AMP_MAX_K = 64


def exact_mode() -> bool:
    """Whether ``DGCNN_TPU_PALLAS_EXACT`` pins the exact f32 mode."""
    return bool(os.environ.get(EXACT_ENV))


def use_amp_eval(amp: bool | None, device: torch.device, n: int,
                 k: int) -> bool:
    """Whether an eval forward of ``n`` points and ``k`` neighbours runs in
    the AMP mode.  ``amp`` None takes the default, the JAX package's: AMP
    on the card unless ``DGCNN_TPU_PALLAS_EXACT`` is set, exact on the CPU
    (the JAX package's XLA path there); True or False asks for one.  Clouds
    the kNN kernels do not take (``use_kernel``), and k above the AMP
    kernel's lists, stay exact either way, as the JAX package's XLA path
    does."""
    from dgcnn_tpu_torch.ops.knn import use_kernel

    if not (use_kernel(n) and k <= AMP_MAX_K):
        return False
    if amp is None:
        return device.type == "cuda" and not exact_mode()
    return amp


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even), as f32."""
    return t.to(torch.bfloat16).float()


def index_bits(n: int) -> int:
    return max((n - 1).bit_length(), 1)


def select_x_plan(cin: int, co: int) -> tuple[bool, str]:
    """The eval EdgeConv selection plan for payload widths (Cin raw, Co
    projected): (select_x, variant).  A payload width with lane padding
    left over takes v3 (its count lane rides the padding), a multiple of
    128 v2; select-x (select raw features, project each selection) when it
    needs fewer 128-lane selection passes than the projection."""

    def lane_plan(width):
        v = "v3" if width % 128 else "v2"
        return v, -(-(width + (v == "v3")) // 128)

    va, pa = lane_plan(co)
    vb, pb = lane_plan(cin)
    select_x = pb < pa
    return select_x, (vb if select_x else va)


def amp_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, M, C), (B, N, C) -> (B, M, N) f32 AMP scores."""
    qf, xf = q.float(), x.float()
    if q.dtype == torch.bfloat16 and x.dtype == torch.bfloat16:
        inner = torch.bmm(qf, xf.transpose(1, 2))
    else:
        qh = round_bf16(qf)
        ql = round_bf16(qf - qh)
        ah = round_bf16(xf)
        al = round_bf16(xf - ah)
        inner = (torch.bmm(qh, ah.transpose(1, 2))
                 + torch.bmm(qh, al.transpose(1, 2))
                 + torch.bmm(ql, ah.transpose(1, 2)))
    qq = torch.sum(qf * qf, dim=-1)
    aa = torch.sum(xf * xf, dim=-1)
    return 2.0 * inner - qq[:, :, None] - aa[:, None, :]


def pack_keys(scores: torch.Tensor) -> torch.Tensor:
    """(..., N) f32 scores -> (..., N) int32 keys, unique within a row."""
    n = scores.shape[-1]
    b = index_bits(n)
    lim = float(2 ** (31 - b) - 1)
    rmin = scores.amin(dim=-1, keepdim=True)
    scale = torch.where(rmin < 0, torch.full_like(rmin, -lim) / rmin,
                        torch.zeros_like(rmin))
    q = torch.clamp_min(torch.round(scores * scale), -lim).to(torch.int64)
    col = torch.arange(n, device=scores.device)
    return (q * 2 ** b + (n - 1 - col)).to(torch.int32)


def v2_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, N) scores -> (B, M, k) int64 columns of the k largest keys,
    largest first."""
    return torch.topk(pack_keys(scores), k, dim=-1).indices


def v3_class_means(scores: torch.Tensor, payload: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The class walk: (means (B, M, k, C) f32, present (B, M, k) bool).

    Class c of a row is its (c + 1)-th largest distinct score; its mean is
    the sum of its members' rows of ``payload`` (B, N, C), in ascending
    column order, divided by the member count.  ``present`` is false past
    the row's last class."""
    bsz, m, n = scores.shape
    sv, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    new = torch.ones_like(sv, dtype=torch.bool)
    new[..., 1:] = sv[..., 1:] != sv[..., :-1]
    cid = torch.cumsum(new, dim=-1) - 1
    member = cid < k
    width = int(member.sum(dim=-1).max())
    cid, member = cid[..., :width], member[..., :width]
    cols = order[..., :width]
    rows = torch.gather(
        payload.float(), 1,
        cols.reshape(bsz, m * width, 1).expand(-1, -1, payload.shape[-1]))
    rows = rows.reshape(bsz, m, width, -1) * member[..., None]
    slot = torch.where(member, cid, 0)
    sums = torch.zeros((bsz, m, k, payload.shape[-1]), dtype=torch.float32,
                       device=scores.device)
    sums.scatter_add_(2, slot[..., None].expand_as(rows), rows)
    cnt = torch.zeros((bsz, m, k), dtype=torch.float32,
                      device=scores.device)
    cnt.scatter_add_(2, slot, member.float())
    return sums / cnt.clamp_min(1.0)[..., None], cnt > 0
