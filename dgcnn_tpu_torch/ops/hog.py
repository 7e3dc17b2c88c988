"""3D histogram of oriented gradients, on the tensors' device (port of
dgcnn_tpu/ops/hog.py).

The reference ``compute_hog_1x1`` (models/model_partseg.py:15-92) takes,
for every point, the SVD of its centred kNN neighbourhood (on the host) and
soft-votes the zenith and azimuth of the principal direction of each
neighbour into 9 bins of 20 degrees.  Here the principal direction comes
from the closed-form 3x3 eigendecomposition of the neighbourhood
covariance (ops/eig3.py), in two forms, dispatched as the JAX package
does:

* the moment form (no ``bug_compat`` and an N the kNN kernels take,
  ``knn.use_kernel``): centre the cloud, sum the moments [x0, x1, x2,
  x0^2, x1^2, x2^2, x0x1, x0x2, x1x2] over each neighbourhood (kernel 10,
  ``knn_sum``), the covariance sum x x^T - (sum x)(sum x)^T / k, one vote
  vector per point, non-finite votes zeroed, then the sums of the votes
  over each neighbourhood (kernel 9, ``edge_sum``).  No (B, N, k, .)
  tensor exists.  CUDA tensors launch the kernels, CPU tensors take their
  plain versions;
* the gather form otherwise: the neighbourhoods gathered, the covariance
  of the centred rows, every edge's vote summed (plain torch; the kNN is
  ``knn``: kernel 11 on CUDA tensors where it takes the cloud).
  ``bug_compat`` replicates the reference's gather of same-axis
  coordinate triples without the per-batch offset.

The semantics are the reference's but for the eigenvector's sign, which
LAPACK leaves open and which is fixed here (largest-magnitude component
non-negative).  The angles keep the reference's ``atan(y / x)`` (not
atan2; NaN at x = 0) and its ``.int()`` truncation.  HOG carries no
gradient: the reference computes it on host numpy.
"""
from __future__ import annotations

import math

import torch

from dgcnn_tpu_torch.ops.edge_sum_kernel import edge_sum
from dgcnn_tpu_torch.ops.eig3 import principal_eig3x3_sym
from dgcnn_tpu_torch.ops.graph import gather_neighbors
from dgcnn_tpu_torch.ops.knn import knn, use_kernel
from dgcnn_tpu_torch.ops.knn_sum_kernel import knn_sum

_NUM_BINS = 9
_BIN_WIDTH = 20.0
_DEGREES = 180.0 / math.pi


def _covariance_eig(cov: torch.Tensor):
    """(gradients (..., 3), magnitudes (..., 1)) of unnormalized
    covariances: the principal eigenvector and lambda0 ** (1 / 4) (the
    reference's sqrt of the first singular value)."""
    grad, lam0 = principal_eig3x3_sym(cov)
    return grad, torch.pow(torch.clamp(lam0, min=0.0), 0.25)[..., None]


def _centred_covariance(x_nn: torch.Tensor) -> torch.Tensor:
    """(B, N, k, 3) neighbourhoods -> (B, N, 3, 3) sums of the outer
    products of their centred rows, in f32."""
    centered = x_nn - x_nn.mean(dim=2, keepdim=True)
    return torch.einsum("bnki,bnkj->bnij", centered, centered)


def principal_gradients(x: torch.Tensor, idx: torch.Tensor):
    """Per-point principal direction (B, N, 3) and magnitude (B, N, 1) of
    the neighbourhoods ``idx`` (B, N, k) of ``x`` (B, N, 3)."""
    return _covariance_eig(_centred_covariance(gather_neighbors(x, idx)))


def _flat_gather_no_base(feat: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """The reference's gather without the per-batch offset:
    feat.view(B*N, C)[idx.view(-1)] -- every batch indexes batch 0."""
    b, n, c = feat.shape
    k = idx.shape[-1]
    return feat.reshape(b * n, c)[idx.reshape(-1)].reshape(b, n, k, c)


def _vote_components(grad: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Soft bin votes of gradients (..., 3) with magnitudes (..., 1) ->
    (..., 2, 9) votes per (zenith / azimuth channel, bin), the reference's
    angles and binning (model_partseg.py:53-89)."""
    zenith = torch.arccos(torch.clamp(grad[..., 2], -1.0, 1.0)) * _DEGREES
    # the reference's atan(y / x), not atan2: quadrants folded, NaN at x = 0
    azimuth = torch.arctan(grad[..., 1] / grad[..., 0]) * _DEGREES
    ang = torch.trunc(torch.stack([zenith, azimuth], dim=-1))  # .int() cast
    ang = torch.where(ang < 0, ang + 180.0, ang)
    bins = torch.remainder(torch.floor(ang / _BIN_WIDTH - 0.5), _NUM_BINS)
    first_centers = _BIN_WIDTH * (torch.remainder(bins + 1, _NUM_BINS) + 0.5)
    first_votes = mag * torch.remainder(first_centers - ang,
                                        180.0) / _BIN_WIDTH
    second_centers = _BIN_WIDTH * (bins + 0.5)
    second_votes = mag * torch.remainder(ang - second_centers,
                                         180.0) / _BIN_WIDTH
    # first vote -> bin c, second vote -> (c + 1) % 9 (reference :87-89); a
    # NaN bin matches no bin, and its NaN vote reaches all nine all the same
    lanes = torch.arange(_NUM_BINS, dtype=ang.dtype, device=ang.device)
    oh_first = (bins[..., None] == lanes).to(grad.dtype)
    oh_second = (torch.remainder(bins + 1, _NUM_BINS)[..., None]
                 == lanes).to(grad.dtype)
    return (first_votes[..., None] * oh_first
            + second_votes[..., None] * oh_second)


def _normalize_hist(hist: torch.Tensor) -> torch.Tensor:
    """L2-normalize (B, N, 9, 2) over the bins (per angle channel), eps as
    F.normalize; interleave as the reference's row-major reshape."""
    b, n = hist.shape[:2]
    norm = torch.sqrt(torch.square(hist).sum(dim=2, keepdim=True))
    hist = hist / torch.clamp(norm, min=1e-12)
    return hist.reshape(b, n, _NUM_BINS * 2)


def centred_moments(x: torch.Tensor):
    """The inputs of kernel 10 in the moment form: the cloud (B, N, 3)
    centred (the moment form cancels against the coordinates' magnitude;
    covariances and neighbour sets are translation invariant) and its
    per-point moments (B, N, 9) [x0, x1, x2, x0^2, x1^2, x2^2, x0x1, x0x2,
    x1x2], both contiguous."""
    x = x - x.mean(dim=1, keepdim=True)
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    moments = torch.stack(
        [x0, x1, x2, x0 * x0, x1 * x1, x2 * x2, x0 * x1, x0 * x2, x1 * x2],
        dim=-1)
    return x.contiguous(), moments.contiguous()


def point_votes(msum: torch.Tensor, k: int) -> torch.Tensor:
    """The input of kernel 9 in the moment form: from each point's
    neighbourhood sums of the moments (B, N, 9), its covariance sum x x^T -
    (sum x)(sum x)^T / k, principal gradient and magnitude, and its vote
    vector (B, N, 18) flattened as [bin, channel], non-finite votes zeroed
    (a degenerate neighbourhood's azimuth atan(0 / 0) is NaN; zeroed, it
    adds nothing to its neighbours' sums instead of NaN), contiguous."""
    b, n, _ = msum.shape
    s = msum[..., 0:3]                                          # sum of x
    q = msum[..., 3:9]   # sums of [x0^2, x1^2, x2^2, x0x1, x0x2, x1x2]
    o = s[..., :, None] * s[..., None, :] / k                   # (B, N, 3, 3)
    cov = torch.stack([
        torch.stack([q[..., 0], q[..., 3], q[..., 4]], dim=-1),
        torch.stack([q[..., 3], q[..., 1], q[..., 5]], dim=-1),
        torch.stack([q[..., 4], q[..., 5], q[..., 2]], dim=-1),
    ], dim=-2) - o
    votes = _vote_components(*_covariance_eig(cov))             # (B, N, 2, 9)
    vflat = votes.transpose(-1, -2).reshape(b, n, _NUM_BINS * 2)
    return torch.where(torch.isfinite(vflat), vflat, 0.0).contiguous()


def _compute_hog_fused(x: torch.Tensor, k: int,
                       amp: bool = False) -> torch.Tensor:
    """The moment form (module docstring): kernel 10 (its variant from the
    mode ``amp``), the votes of each point, kernel 9."""
    b, n, _ = x.shape
    xc, moments = centred_moments(x)
    idx, msum = knn_sum(xc, moments, k, amp=amp)
    hist = edge_sum(point_votes(msum, k), idx)                  # (B, N, 18)
    return _normalize_hist(hist.reshape(b, n, _NUM_BINS, 2))


@torch.no_grad()
def compute_hog(x: torch.Tensor, k: int, bug_compat: bool = False,
                amp: bool = False) -> torch.Tensor:
    """Histograms of oriented gradients with cell size 1 (every point).

    Args:
      x: (B, N, 3) f32 points (channels last; the reference takes (B, 3, N)).
      k: neighbourhood size.
      bug_compat: replicate the reference's gather (module docstring).
      amp: the caller's mode: the moment form's kernel 10 takes its
        variant from it (``knn_sum``: v2 in the AMP mode, as the JAX
        package's kernel does by default); kernel 9 and the gather form
        are the same in both modes.
    Returns:
      (B, N, 18) L2-normalized histograms, 9 bins x (zenith, azimuth),
      interleaved as the reference's (B, N, 9, 2) row-major reshape.
    """
    b, n, _ = x.shape
    if not bug_compat and use_kernel(n):
        return _compute_hog_fused(x, k, amp)
    idx = knn(x, k)
    if bug_compat:
        # reference model_partseg.py:26-30: a view of the untransposed
        # (B, 3, N) tensor and no per-batch offset: rows are same-axis
        # coordinate triples
        rows = x.transpose(1, 2).reshape(b * n, 3)
        x_nn = rows[idx.reshape(-1)].reshape(b, n, k, 3)
        grad, mag = _covariance_eig(_centred_covariance(x_nn))
        grad_nn = _flat_gather_no_base(grad, idx)
        mag_nn = _flat_gather_no_base(mag, idx)
    else:
        grad, mag = principal_gradients(x, idx)
        grad_nn = gather_neighbors(grad, idx)                 # (B, N, k, 3)
        mag_nn = gather_neighbors(mag, idx)                   # (B, N, k, 1)
    votes = _vote_components(grad_nn, mag_nn)                 # (B, N, k, 2, 9)
    return _normalize_hist(votes.sum(dim=2).transpose(-1, -2))
