"""ModelNet40 (port of the cls part of dgcnn_tpu/data/datasets.py).

Same file glob and fields (``data``/``label``) as the reference.  The data
root is ``$DGCNN_TPU_DATA``, else ``<repo>/data``.  Nothing is downloaded:
a missing dataset raises with the path it was looked for at.  ``h5py`` is
imported only inside the reader.  A dataset can also be built from arrays
in memory.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from dgcnn_tpu_torch.data import augment


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
    """Reference data.py ModelNet40: the first ``num_points`` points of
    each cloud.  ``batch`` assembles a batch as the JAX package's
    vectorized loader path does: the train partition adds a per-cloud
    random scale and shift and a random point order.  ``data`` (n, P, 3)
    and ``label`` (n, 1) given in memory take the place of the h5 files."""

    def __init__(self, num_points: int, partition: str = "test",
                 data: np.ndarray | None = None,
                 label: np.ndarray | None = None):
        if data is None:
            data, label = load_data_cls(partition)
        self.data = np.asarray(data, dtype=np.float32)
        self.label = np.asarray(label).reshape(-1, 1).astype(np.int64)
        self.num_points = num_points
        self.partition = partition

    def __len__(self) -> int:
        return self.data.shape[0]

    def batch(self, idxs: np.ndarray, rng: np.random.Generator):
        """(points (b, num_points, 3) f32, labels (b, 1) i64) of clouds
        ``idxs``, augmented from ``rng`` in the train partition."""
        pc = self.data[idxs, : self.num_points]
        if self.partition == "train":
            pc = augment.translate_batch(pc, rng)
            order = augment.shuffle_points_batch(rng, *pc.shape[:2])
            pc = np.take_along_axis(pc, order[:, :, None], axis=1)
        else:
            pc = pc.copy()
        return pc, self.label[idxs]

    def arrays(self):
        """(points (n, num_points, 3) f32, labels (n,) i64), unaugmented."""
        return (np.ascontiguousarray(self.data[:, : self.num_points]),
                self.label.reshape(-1))
