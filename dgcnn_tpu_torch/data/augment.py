"""Whole-batch point-cloud augmentations, numpy with an explicit Generator
(the port's own copy of the batched forms of dgcnn_tpu/data/augment.py,
the ones the loader's ``batch()`` path draws; same draws in the same
order, so the same seed gives the same batches)."""
from __future__ import annotations

import numpy as np


def translate_batch(pc: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-sample anisotropic scale U(2/3, 3/2) + shift U(-0.2, 0.2) per
    axis."""
    b = pc.shape[0]
    scale = rng.uniform(2.0 / 3.0, 3.0 / 2.0, size=(b, 1, 3)).astype(np.float32)
    shift = rng.uniform(-0.2, 0.2, size=(b, 1, 3)).astype(np.float32)
    return pc * scale + shift


def shuffle_points_batch(rng: np.random.Generator, b: int,
                         n: int) -> np.ndarray:
    """(B, N) independent point permutations (argsort of random keys)."""
    return np.argsort(rng.random((b, n)), axis=1)
