"""The AMP (bf16) mode of the kNN kernels in plain torch: the mode
switches of eval and training, the scores, the packed-key selection v2
and the class walk v3.

Ports of the JAX package's default numerics (``dgcnn_tpu/ops/
pallas_knn.py``), which its kernels run unless ``DGCNN_TPU_PALLAS_EXACT``
is set:

- ``exact_mode`` reads the variable as ``_train_exact`` (:531) does.
- ``extract_version``: ``_extract_version`` (:225), the extraction
  variant of one kernel: a ``DGCNN_TPU_EXTRACT`` value the kernel allows
  wins, else v1 under ``DGCNN_TPU_PALLAS_EXACT``, else the kernel's
  default.  ``stage_variant`` applies it to the eval kernels 1, 6, 12 and
  13 (default v1 in the exact mode), and ``require_ported`` names the
  combinations of mode and variant that their CUDA forms take.
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
- ``training_variant``: the variant of kernels 3 and 4 (``knn_reduce``,
  ``knn_reduce_xw``), ``_extract_version("v1" if exact else "v2", ...)``
  (:386, :431): v2 in the AMP mode and v1 in the exact one, the variable
  overriding either; kernel 11 (``knn``) takes the exact mode's rule
  whatever the mode (:1554).  ``knn_sum_variant``: kernel 10's,
  ``_extract_version("v2", ...)`` (:1518), the same rule.
- ``use_amp_train`` and ``use_amp_eval``: whether a training step or an
  eval forward runs in the AMP mode.
- ``select_x_plan``: ``select_x_plan`` (:244), copied.
- ``select_rows``: the k selected payload rows of each row under v1, v2
  or v3 (v3: the class means, and which slots hold a class), which every
  eval kernel's plain version folds in its own way.

The CUDA kernels of the AMP mode (the AMP instances of
``csrc/edge_conv_eval.cu``, ``edge_conv_amp.cu``, ``knn_edge2_variant.cu``
and, for training, ``knn_reduce.cu``) compute the same selections; these
are their plain versions.
"""
from __future__ import annotations

import os

import torch

EXACT_ENV = "DGCNN_TPU_PALLAS_EXACT"
EXTRACT_ENV = "DGCNN_TPU_EXTRACT"
VARIANTS = ("v1", "v2", "v3")
# (AMP mode, variant) of the eval kernels 1, 6, 12 and 13 that their CUDA
# forms take: the exact v1 and v2 (the semseg CLI's pin) and the AMP v2
# (the pin, and the default at widths that are multiples of 128) and v3
PORTED = ((False, "v1"), (False, "v2"), (True, "v2"), (True, "v3"))
# the AMP kernel's longest list (its tiled route alone)
AMP_MAX_K = 64


def exact_mode() -> bool:
    """Whether ``DGCNN_TPU_PALLAS_EXACT`` pins the exact f32 mode."""
    return bool(os.environ.get(EXACT_ENV))


def extract_version(default: str, allow: tuple[str, ...]) -> str:
    """The extraction variant of one kernel: a ``DGCNN_TPU_EXTRACT`` value
    in ``allow`` wins; else v1 when ``DGCNN_TPU_PALLAS_EXACT`` is set;
    else ``default``.  Read at each call."""
    env = os.environ.get(EXTRACT_ENV)
    if env in allow:
        return env
    if exact_mode():
        return "v1"
    return default


def training_variant(amp: bool = False) -> str:
    """The variant of the training kNN kernels 3 and 4 in the AMP mode
    (``amp``) or the exact one: v2 in AMP, v1 in the exact mode, each
    overridden by a ``DGCNN_TPU_EXTRACT`` of v1 or v2.  Kernel 11 takes
    the exact mode's (``amp`` False) in either mode."""
    return extract_version("v2" if amp else "v1", ("v1", "v2"))


def knn_sum_variant(amp: bool) -> str:
    """Kernel 10's variant: v2 in the AMP mode, v1 in the exact one, each
    overridden by a ``DGCNN_TPU_EXTRACT`` of v1 or v2."""
    return extract_version("v2" if amp else "v1", ("v1", "v2"))


def stage_variant(amp: bool, default: str) -> str:
    """The variant of an eval kernel (1, 6, 12 or 13) in the AMP mode
    (``amp``) or the exact one: ``default`` (the kernel's own) in AMP, v1
    in the exact mode, each overridden as ``extract_version`` says."""
    return extract_version(default if amp else "v1", VARIANTS)


def require_ported(name: str, amp: bool, variant: str) -> None:
    """Raise unless the CUDA form of ``name`` takes ``variant`` in this
    mode (``PORTED``)."""
    if (amp, variant) not in PORTED:
        mode = "AMP" if amp else "exact"
        why = (f"{EXTRACT_ENV}={os.environ[EXTRACT_ENV]}"
               if os.environ.get(EXTRACT_ENV) == variant
               else f"{EXACT_ENV} set")
        raise ValueError(f"{name}: the {mode} mode's {variant} ({why}) has "
                         f"no CUDA form; ported: exact v1, v2; AMP v2, v3")


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


def use_amp_train(amp: bool | None, device: torch.device, n: int,
                  k: int) -> bool:
    """Whether a training step of ``n`` points and ``k`` neighbours runs in
    the AMP mode (``use_amp_eval``'s twin): ``amp`` None takes the JAX
    package's default, AMP on the card unless ``DGCNN_TPU_PALLAS_EXACT``
    is set and exact on the CPU; True or False asks for one.  Clouds the
    kNN kernels do not take, and k above the AMP kernels' lists, train
    exact either way."""
    return use_amp_eval(amp, device, n, k)


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


def v1_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, N) scores -> (B, M, k) int64 columns of the k largest scores,
    largest first, lowest column first among equal ones."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


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


def select_rows(scores: torch.Tensor, payload: torch.Tensor, k: int,
                variant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The k selected rows of ``payload`` (B, N, C) for each score row
    (``scores`` (B, M, N)): (rows (B, M, k, C) f32, present (B, M, k)
    bool).  v1 and v2: the members in list order, all present; v3: the
    class means (``v3_class_means``)."""
    if variant == "v3":
        return v3_class_means(scores, payload, k)
    idx = v2_indices(scores, k) if variant == "v2" else v1_indices(scores, k)
    bsz, m, _ = idx.shape
    rows = torch.gather(
        payload.float(), 1,
        idx.reshape(bsz, m * k, 1).expand(-1, -1, payload.shape[-1]))
    return (rows.reshape(bsz, m, k, -1),
            torch.ones(idx.shape, dtype=torch.bool, device=idx.device))


def max_min(rows: torch.Tensor, present: torch.Tensor):
    """(max, min) over the present slots of ``rows`` (B, M, k, C)."""
    p = present[..., None]
    return (torch.where(p, rows, -torch.inf).amax(2),
            torch.where(p, rows, torch.inf).amin(2))
