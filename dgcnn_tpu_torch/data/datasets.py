"""ModelNet40 and S3DIS (port of those parts of dgcnn_tpu/data/datasets.py).

Same file globs, lists and fields (``data``/``label``) as the reference,
and S3DIS's Area-substring split of its rooms.  The data
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


def _s3dis_dir(partition: str) -> str:
    return os.path.join(data_root(), "indoor3d_sem_seg_hdf5_data" if
                        partition == "train"
                        else "indoor3d_sem_seg_hdf5_data_test")


def read_s3dis(partition: str):
    """S3DIS block h5s of a partition's directory -> (data (n, P, 9) f32 as
    stored, seg (n, P) as stored, the room of each block): the files of
    ``all_files.txt`` in order, their blocks concatenated, and
    ``room_filelist.txt``."""
    d = _s3dis_dir(partition)
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"no S3DIS blocks at {d} (set DGCNN_TPU_DATA; this package "
            f"downloads and prepares nothing)")
    with open(os.path.join(d, "all_files.txt")) as f:
        all_files = [line.rstrip() for line in f]
    with open(os.path.join(d, "room_filelist.txt")) as f:
        rooms = [line.rstrip() for line in f]
    datas, segs = [], []
    for fn in all_files:
        # the reference stores paths relative to its data dir
        path = fn if os.path.isabs(fn) else os.path.join(data_root(), fn)
        if not os.path.exists(path):
            path = os.path.join(d, os.path.basename(fn))
        da, la = _read_h5(path, ("data", "label"))
        datas.append(da)
        segs.append(la)
    return np.concatenate(datas, 0), np.concatenate(segs, 0), rooms


def split_semseg(data, seg, rooms, partition: str, test_area: str):
    """The blocks of ``partition``: the test partition is the blocks whose
    room names hold ``Area_<test_area>``, the train partition the others
    (reference data.py:134-169).  Returns (data, seg int64)."""
    name = "Area_" + str(test_area)
    idxs = [i for i, room in enumerate(rooms)
            if (name in room) == (partition != "train")]
    return data[idxs, ...], seg[idxs, ...].astype("int64")


def load_data_semseg(partition: str, test_area: str):
    """S3DIS h5 blocks of ``partition`` for ``test_area`` ->
    (data (n, 4096, 9), seg (n, 4096) int64)."""
    return split_semseg(*read_s3dis(partition), partition, test_area)


class S3DIS:
    """Reference data.py S3DIS: the first ``num_points`` points of each
    9-channel block and their class labels.  ``batch`` assembles a batch as
    the JAX package's vectorized loader path does: the train partition
    draws a random point order per block.  ``data`` (n, P, 9) and ``seg``
    (n, P) given in memory, already split, take the place of the h5
    files."""

    def __init__(self, num_points: int = 4096, partition: str = "train",
                 test_area: str = "1", data: np.ndarray | None = None,
                 seg: np.ndarray | None = None):
        if data is None:
            data, seg = load_data_semseg(partition, test_area)
        self.data = np.asarray(data)
        self.seg = np.asarray(seg).astype(np.int64)
        self.num_points = num_points
        self.partition = partition

    def __len__(self) -> int:
        return self.data.shape[0]

    def batch(self, idxs: np.ndarray, rng: np.random.Generator):
        """(points (b, num_points, 9), seg (b, num_points) i64) of blocks
        ``idxs``, their point order shuffled from ``rng`` in the train
        partition."""
        pc = self.data[idxs, : self.num_points]
        seg = self.seg[idxs, : self.num_points]
        if self.partition == "train":
            order = augment.shuffle_points_batch(rng, *pc.shape[:2])
            pc = np.take_along_axis(pc, order[:, :, None], axis=1)
            seg = np.take_along_axis(seg, order, axis=1)
        else:
            pc, seg = pc.copy(), seg.copy()
        return pc, seg
