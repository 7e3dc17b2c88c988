"""Classification metrics with sklearn semantics and the semantic
segmentation IoU, in numpy (copy of the numpy part of
dgcnn_tpu/train/metrics.py)."""
from __future__ import annotations

import numpy as np


def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float((y_true == y_pred).mean())


def balanced_accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean per-class recall over the classes present in y_true (sklearn)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    recalls = [(y_pred[y_true == c] == c).mean() for c in np.unique(y_true)]
    return float(np.mean(recalls))


def calculate_sem_IoU(pred_np: np.ndarray, seg_np: np.ndarray,
                      visual: bool = False,
                      num_classes: int = 13) -> np.ndarray:
    """Per-class IoU over all blocks together (reference
    main_semseg.py:47-61).  A class absent from both predictions and
    labels is 0/0 = nan, as in the reference, unless ``visual`` counts it
    as 1."""
    pred_np = np.asarray(pred_np)
    seg_np = np.asarray(seg_np)
    i_all = np.zeros(num_classes)
    u_all = np.zeros(num_classes)
    for sem in range(num_classes):
        i_all[sem] = np.sum((pred_np == sem) & (seg_np == sem))
        u_all[sem] = np.sum((pred_np == sem) | (seg_np == sem))
    if visual:
        empty = u_all == 0
        i_all[empty] = 1
        u_all[empty] = 1
    with np.errstate(divide="ignore", invalid="ignore"):
        return i_all / u_all
