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
