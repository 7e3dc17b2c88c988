"""Synthetic ModelNet40-shaped data in memory, from a numpy seed.

``make_modelnet40`` draws the same numbers, in the same order, as
``dgcnn_tpu/data/synthetic.py::make_modelnet40`` does before it writes its
h5 fixture, so the two hold the same clouds for the same seed.  No h5py.
"""
from __future__ import annotations

import numpy as np


def make_modelnet40(n_train: int = 32, n_test: int = 16,
                    num_points: int = 2048, seed: int = 0):
    """{"train": (data, label), "test": (data, label)} with data
    (n, num_points, 3) f32 standard normal and label (n, 1) uint8."""
    rng = np.random.default_rng(seed)
    out = {}
    for part, n in [("train", n_train), ("test", n_test)]:
        data = rng.standard_normal((n, num_points, 3)).astype("float32")
        label = rng.integers(0, 40, size=(n, 1)).astype("uint8")
        out[part] = (data, label)
    return out
