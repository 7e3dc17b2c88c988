"""Synthetic ModelNet40- and S3DIS-shaped data in memory, from a numpy
seed.

``make_modelnet40`` and ``make_s3dis`` draw the same numbers, in the same
order, as ``dgcnn_tpu/data/synthetic.py``'s functions of those names do
before they write their h5 fixtures, so the two hold the same data for the
same seed.  No h5py.
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


def make_s3dis(blocks_per_room: int = 4, rooms_per_area: int = 2,
               num_points: int = 4096, seed: int = 0):
    """{"train": (data, seg, rooms), "test": (data, seg, rooms)}: the
    blocks of ``rooms_per_area`` rooms in each of the six areas, data (n,
    num_points, 9) f32 uniform in [0, 1), seg (n, num_points) uint8 in
    0..12, and each block's room name (``Area_<a>_office_<r>``).  Both
    partitions hold every area, as the reference's two block directories
    do; ``datasets.split_semseg`` picks the test area's blocks."""
    rng = np.random.default_rng(seed)
    rooms = [f"Area_{a}_office_{r}" for a in range(1, 7)
             for r in range(1, rooms_per_area + 1)
             for _ in range(blocks_per_room)]
    out = {}
    for part in ("train", "test"):
        data = rng.random((len(rooms), num_points, 9)).astype("float32")
        seg = rng.integers(0, 13, size=(len(rooms), num_points)).astype(
            "uint8")
        out[part] = (data, seg, list(rooms))
    return out
