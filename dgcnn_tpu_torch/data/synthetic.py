"""Synthetic ModelNet40-, ShapeNetPart- and S3DIS-shaped data in memory,
from a numpy seed.

``make_modelnet40``, ``make_shapenetpart``, ``make_shapenetpart_structured``
and ``make_s3dis`` draw the same numbers, in the same order, as
``dgcnn_tpu/data/synthetic.py``'s functions of those names do before they
write their h5 fixtures, so the two hold the same data for the same seed.
No h5py.
"""
from __future__ import annotations

import numpy as np

from dgcnn_tpu_torch.train.metrics import INDEX_START, SEG_NUM


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


def make_shapenetpart(n_train: int = 24, n_val: int = 8, n_test: int = 16,
                      num_points: int = 2048, seed: int = 0):
    """{"train", "val", "test": (data, label, pid)}: data (n, num_points,
    3) f32 standard normal, label (n, 1) uint8 categories, pid (n,
    num_points) uint8 part labels uniform in each shape's category
    window."""
    rng = np.random.default_rng(seed)
    out = {}
    for part, n in [("train", n_train), ("val", n_val), ("test", n_test)]:
        data = rng.standard_normal((n, num_points, 3)).astype("float32")
        label = rng.integers(0, 16, size=(n, 1)).astype("uint8")
        pid = np.stack([
            rng.integers(INDEX_START[int(c)],
                         INDEX_START[int(c)] + SEG_NUM[int(c)],
                         size=num_points)
            for c in label[:, 0]
        ]).reshape(n, num_points).astype("uint8")
        out[part] = (data, label, pid)
    return out


def _sphere_dirs(rng: np.random.Generator, n: int):
    """Uniform directions on S^2."""
    cosph = rng.uniform(-1.0, 1.0, n)
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    sinph = np.sqrt(1.0 - cosph**2)
    return np.stack(
        [sinph * np.cos(theta), sinph * np.sin(theta), cosph], axis=-1)


def _primitive(rng: np.random.Generator, kind: int, n: int) -> np.ndarray:
    """n points on one of six shapes that differ in their local
    neighbourhoods: ball, shell, disk, stick, torus, three clusters."""
    if kind == 0:    # solid ball
        dirs = _sphere_dirs(rng, n)
        return dirs * (0.8 * rng.uniform(0, 1, n) ** (1 / 3))[:, None]
    if kind == 1:    # thin spherical shell
        dirs = _sphere_dirs(rng, n)
        return dirs * (0.9 + 0.02 * rng.standard_normal(n))[:, None]
    if kind == 2:    # flat disk in the x-z plane
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = np.sqrt(rng.uniform(0, 1, n))
        return np.stack([rad * np.cos(ang),
                         0.03 * rng.standard_normal(n),
                         rad * np.sin(ang)], -1)
    if kind == 3:    # stick along y
        p = 0.05 * rng.standard_normal((n, 3))
        p[:, 1] = rng.uniform(-0.8, 0.8, n)
        return p
    if kind == 4:    # torus in the x-z plane
        u = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(0, 2 * np.pi, n)
        r = 0.08
        return np.stack([(0.8 + r * np.cos(v)) * np.cos(u),
                         r * np.sin(v),
                         (0.8 + r * np.cos(v)) * np.sin(u)], -1)
    c = rng.integers(0, 3, n)      # three tight clusters in the x-z plane
    ang = 2 * np.pi * c / 3
    ctr = 0.7 * np.stack([np.cos(ang), np.zeros(n), np.sin(ang)], -1)
    return ctr + 0.12 * rng.standard_normal((n, 3))


def structured_partseg_cloud(rng: np.random.Generator, cat: int,
                             num_points: int):
    """One category-``cat`` shape: its SEG_NUM[cat] parts are primitives
    stacked along +y, the part label the primitive's place in the
    category's label window; scaled to the unit cube and shuffled."""
    s = int(SEG_NUM[cat])
    start = int(INDEX_START[cat])
    counts = np.full(s, num_points // s)
    counts[: num_points - counts.sum()] += 1
    pts, pid = [], []
    for i in range(s):
        n_i = int(counts[i])
        center = np.array([0.0, (i - (s - 1) / 2.0) * 2.4, 0.0])
        pts.append(_primitive(rng, i, n_i) + center)
        pid.append(np.full(n_i, start + i))
    pts = np.concatenate(pts, 0)
    pid = np.concatenate(pid, 0)
    pts /= np.abs(pts).max()
    order = rng.permutation(num_points)
    return pts[order].astype("float32"), pid[order].astype("uint8")


def make_shapenetpart_structured(n_train: int = 768, n_val: int = 128,
                                 n_test: int = 256, num_points: int = 2048,
                                 seed: int = 0):
    """make_shapenetpart's layout with learnable parts: the categories in
    turn (shuffled), each shape a ``structured_partseg_cloud``."""
    rng = np.random.default_rng(seed)
    out = {}
    for part, n in [("train", n_train), ("val", n_val), ("test", n_test)]:
        label = (np.arange(n) % 16).astype("uint8")
        rng.shuffle(label)
        data = np.empty((n, num_points, 3), "float32")
        pid = np.empty((n, num_points), "uint8")
        for j, c in enumerate(label):
            data[j], pid[j] = structured_partseg_cloud(rng, int(c), num_points)
        out[part] = (data, label[:, None], pid)
    return out


def trainval(parts: dict):
    """The trainval partition of a make_shapenetpart dict: train, then
    val, as ``load_data_partseg`` concatenates them."""
    return tuple(np.concatenate([a, b], 0)
                 for a, b in zip(parts["train"], parts["val"]))


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
