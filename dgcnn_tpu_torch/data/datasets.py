"""ModelNet40 h5 reader (port of the cls part of dgcnn_tpu/data/datasets.py).

Same file glob and fields (``data``/``label``) as the reference.  The data
root is ``$DGCNN_TPU_DATA``, else ``<repo>/data``.  Nothing is downloaded:
a missing dataset raises with the path it was looked for at.  ``h5py`` is
imported only inside the reader.
"""
from __future__ import annotations

import glob
import os

import numpy as np


def data_root() -> str:
    root = os.environ.get("DGCNN_TPU_DATA")
    if root:
        return root
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, "data")


def _read_h5(path: str, fields: tuple[str, ...]):
    import h5py

    with h5py.File(path, "r") as f:
        return tuple(np.asarray(f[k]) for k in fields)


def load_data_cls(partition: str):
    """ModelNet40 h5 concat -> (data (n, 2048, 3) f32, label (n, 1) i64)."""
    pattern = os.path.join(data_root(), "modelnet40_ply_hdf5_2048",
                           f"*{partition}*.h5")
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(
            f"no ModelNet40 files match {pattern} (set DGCNN_TPU_DATA; "
            f"this package downloads nothing)")
    datas, labels = [], []
    for p in files:
        d, lab = _read_h5(p, ("data", "label"))
        datas.append(d.astype("float32"))
        labels.append(lab.astype("int64"))
    return np.concatenate(datas, 0), np.concatenate(labels, 0)


class ModelNet40:
    """The ModelNet40 test partition: the first ``num_points`` points of
    each cloud, no augmentation (reference data.py ModelNet40 with
    partition='test'; the train partition comes with training)."""

    def __init__(self, num_points: int, partition: str = "test"):
        if partition != "test":
            raise NotImplementedError(
                "only the test partition is ported; see ROADMAP.md")
        self.data, self.label = load_data_cls(partition)
        self.num_points = num_points
        self.partition = partition

    def arrays(self):
        """(points (n, num_points, 3) f32, labels (n,) i64)."""
        return (np.ascontiguousarray(self.data[:, : self.num_points]),
                self.label.reshape(-1))
