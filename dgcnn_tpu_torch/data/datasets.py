"""ModelNet40, ShapeNetPart and S3DIS (port of those parts of
dgcnn_tpu/data/datasets.py).

Same file globs, lists and fields (``data``/``label``/``pid``) as the
reference, ShapeNetPart's trainval concat and S3DIS's Area-substring split
of its rooms.  The data
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
from dgcnn_tpu_torch.train.metrics import INDEX_START, SEG_NUM


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


def load_data_partseg(partition: str):
    """ShapeNetPart h5 concat -> (data (n, 2048, 3) f32, label (n, 1) i64,
    seg (n, 2048) i64); ``trainval`` is the train files, then the val
    files (reference data.py:98-122)."""
    base = os.path.join(data_root(), "shapenet_part_seg_hdf5_data")
    if partition == "trainval":
        files = (sorted(glob.glob(os.path.join(base, "*train*.h5")))
                 + sorted(glob.glob(os.path.join(base, "*val*.h5"))))
    else:
        files = sorted(glob.glob(os.path.join(base, f"*{partition}*.h5")))
    if not files:
        raise FileNotFoundError(
            f"no ShapeNetPart {partition} files under {base} (set "
            f"DGCNN_TPU_DATA; this package downloads nothing)")
    datas, labels, segs = [], [], []
    for p in files:
        d, lab, seg = _read_h5(p, ("data", "label", "pid"))
        datas.append(d.astype("float32"))
        labels.append(lab.astype("int64"))
        segs.append(seg.astype("int64"))
    return (np.concatenate(datas, 0), np.concatenate(labels, 0),
            np.concatenate(segs, 0))


class ShapeNetPart:
    """Reference data.py ShapeNetPart: the first ``num_points`` points of
    each shape, its category and its part labels; with ``class_choice``
    only that category's shapes, whose part labels then start at
    ``seg_start_index``.  ``batch`` assembles a batch as the JAX package's
    vectorized loader path does: the trainval partition draws a random
    point order per shape.  ``data`` (n, P, 3), ``label`` (n, 1) and
    ``seg`` (n, P) given in memory take the place of the h5 files."""

    CAT2ID = {
        "airplane": 0, "bag": 1, "cap": 2, "car": 3, "chair": 4,
        "earphone": 5, "guitar": 6, "knife": 7, "lamp": 8, "laptop": 9,
        "motor": 10, "mug": 11, "pistol": 12, "rocket": 13,
        "skateboard": 14, "table": 15,
    }
    SEG_NUM = SEG_NUM
    INDEX_START = INDEX_START

    def __init__(self, num_points: int, partition: str = "train",
                 class_choice: str | None = None,
                 data: np.ndarray | None = None,
                 label: np.ndarray | None = None,
                 seg: np.ndarray | None = None):
        if data is None:
            data, label, seg = load_data_partseg(partition)
        self.data = np.asarray(data, dtype=np.float32)
        self.label = np.asarray(label).reshape(-1, 1).astype(np.int64)
        self.seg = np.asarray(seg).astype(np.int64)
        self.num_points = num_points
        self.partition = partition
        self.class_choice = class_choice
        if class_choice is not None:
            cid = self.CAT2ID[class_choice]
            keep = (self.label == cid).squeeze(1)
            self.data = self.data[keep]
            self.label = self.label[keep]
            self.seg = self.seg[keep]
            self.seg_num_all = self.SEG_NUM[cid]
            self.seg_start_index = self.INDEX_START[cid]
        else:
            self.seg_num_all = 50
            self.seg_start_index = 0

    def __len__(self) -> int:
        return self.data.shape[0]

    def batch(self, idxs: np.ndarray, rng: np.random.Generator):
        """(points (b, num_points, 3) f32, labels (b, 1) i64, seg (b,
        num_points) i64) of shapes ``idxs``, their point order shuffled
        from ``rng`` in the trainval partition."""
        pc = self.data[idxs, : self.num_points]
        seg = self.seg[idxs, : self.num_points]
        if self.partition == "trainval":
            order = augment.shuffle_points_batch(rng, *pc.shape[:2])
            pc = np.take_along_axis(pc, order[:, :, None], axis=1)
            seg = np.take_along_axis(seg, order, axis=1)
        else:
            pc, seg = pc.copy(), seg.copy()
        return pc, self.label[idxs], seg


class ShapeNetPartAugmented:
    """Reference data.py ShapeNetPartAugmented: whole shapes of
    ``shapenetpart_{train,test}_dataset.npz`` under the data root (the
    ShapeNetPart h5s when it is absent), and in the train partition a
    random order of {translate, jitter, rotate}, each applied or not, per
    shape.  ``batch`` draws them as the JAX package's vectorized loader
    path does.  ``data``, ``label`` and ``seg`` given in memory take the
    place of the files."""

    def __init__(self, partition: str, data: np.ndarray | None = None,
                 label: np.ndarray | None = None,
                 seg: np.ndarray | None = None):
        if partition not in ("train", "trainval", "test"):
            raise ValueError(f"unknown partition {partition!r}")
        if partition == "trainval":
            partition = "train"
        self.partition = partition
        if data is None:
            path = os.path.join(data_root(),
                                f"shapenetpart_{partition}_dataset.npz")
            if os.path.exists(path):
                z = np.load(path)
                data, label, seg = z["data"], z["label"], z["seg"]
            else:
                data, label, seg = load_data_partseg(
                    "trainval" if partition == "train" else "test")
        self.data, self.label, self.seg = data, label, seg

    def __len__(self) -> int:
        return self.data.shape[0]

    def batch(self, idxs: np.ndarray, rng: np.random.Generator):
        """(points, labels, seg) of shapes ``idxs``: each train shape draws
        an order of the three augmentations and an on/off choice for each,
        run as three slots of three masked whole-batch passes."""
        pc = np.asarray(self.data[idxs], dtype=np.float32).copy()
        b = pc.shape[0]
        if self.partition == "train":
            batched = [augment.translate_batch, augment.jitter_batch,
                       augment.rotate_batch]
            order = np.argsort(rng.random((b, 3)), axis=1)
            choices = rng.integers(0, 2, size=(b, 3)).astype(bool)
            for slot in range(3):
                for f in range(3):
                    apply = (order[:, slot] == f) & choices[:, f]
                    if apply.any():
                        pc = batched[f](pc, rng, apply=apply)
        return pc, self.label[idxs], self.seg[idxs]


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
