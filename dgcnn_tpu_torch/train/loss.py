"""Label-smoothing cross entropy (port of dgcnn_tpu/train/loss.py)."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: bool = True, eps: float = 0.2) -> torch.Tensor:
    """Mean cross entropy; with smoothing the target is ``1 - eps`` on the
    gold class and ``eps / (n_class - 1)`` elsewhere."""
    n_class = logits.shape[-1]
    logits2d = logits.reshape(-1, n_class)
    gold = labels.reshape(-1).long()
    log_prb = torch.log_softmax(logits2d, dim=-1)
    if smoothing:
        one_hot = torch.nn.functional.one_hot(gold, n_class).to(logits2d.dtype)
        target = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (n_class - 1)
        return -torch.mean(torch.sum(target * log_prb, dim=-1))
    return -torch.mean(torch.gather(log_prb, 1, gold[:, None]))


def cross_entropy_per_example(logits: torch.Tensor, labels: torch.Tensor,
                              smoothing: bool = True,
                              eps: float = 0.2) -> torch.Tensor:
    """Cross entropy per leading example: (B, ..., C) -> (B,), the mean
    over any middle axes (per-point segmentation losses), with
    ``cross_entropy``'s smoothing.  The eval loop masks padded rows out of
    its mean with it."""
    n_class = logits.shape[-1]
    log_prb = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    if smoothing:
        one_hot = torch.nn.functional.one_hot(labels, n_class).to(
            logits.dtype)
        target = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (n_class - 1)
        ce = -torch.sum(target * log_prb, dim=-1)
    else:
        ce = -torch.gather(log_prb, -1, labels[..., None])[..., 0]
    mid = tuple(range(1, ce.dim()))
    return ce.mean(dim=mid) if mid else ce


def masked_mean_loss(per_example: torch.Tensor,
                     mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over the real (``mask`` True) rows; the plain mean when
    ``mask`` is None."""
    if mask is None:
        return per_example.mean()
    m = mask.to(per_example.dtype)
    return (per_example * m).sum() / m.sum().clamp(min=1.0)
