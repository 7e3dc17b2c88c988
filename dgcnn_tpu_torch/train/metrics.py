"""Classification metrics with sklearn semantics, the part segmentation
and semantic segmentation IoUs and the ShapeNetPart category tables, in
numpy (copy of the numpy part of dgcnn_tpu/train/metrics.py)."""
from __future__ import annotations

import numpy as np

# ShapeNetPart: the number of parts of each of the 16 categories and the
# first part label of each (reference data.py:303-304)
SEG_NUM = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]
INDEX_START = [0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30, 36, 38, 41, 44, 47]


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


def calculate_shape_IoU(pred_np: np.ndarray, seg_np: np.ndarray,
                        label: np.ndarray, class_choice: str | None,
                        visual: bool = False) -> list[float]:
    """Per shape, the mean over its category's parts of the part IoU
    (reference main_partseg.py:57-80): ``pred_np``/``seg_np`` (shapes, N)
    part labels, ``label`` the shapes' categories.  A part absent from
    both counts as IoU 1.  With ``class_choice`` the labels are the
    category's own 0..parts-1."""
    label = np.asarray(label)
    if not visual:
        label = label.squeeze()
    shape_ious: list[float] = []
    for shape_idx in range(seg_np.shape[0]):
        if not class_choice:
            start = INDEX_START[int(np.ravel(label)[shape_idx])]
            num = SEG_NUM[int(np.ravel(label)[shape_idx])]
            parts = range(start, start + num)
        else:
            parts = range(SEG_NUM[int(np.ravel(label)[0])])
        part_ious = []
        for part in parts:
            i = np.sum((pred_np[shape_idx] == part)
                       & (seg_np[shape_idx] == part))
            u = np.sum((pred_np[shape_idx] == part)
                       | (seg_np[shape_idx] == part))
            part_ious.append(1.0 if u == 0 else i / float(u))
        shape_ious.append(float(np.mean(part_ious)))
    return shape_ious
