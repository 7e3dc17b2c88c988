"""The batch loader (port of dgcnn_tpu/data/pipeline.py's
``PipelineLoader`` with ``num_workers=0``).

A dataset's ``batch(idxs, rng)`` assembles each batch in one vectorized
numpy pass.  The sample order of an epoch comes from
``default_rng((seed, epoch))`` and each batch's augmentation from
``default_rng((seed, epoch, batch_index))``, so a batch is a pure function
of (seed, epoch, batch index) and the same as the JAX loader's for the
same data and seed, bit for bit.  Worker processes are not ported.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class PipelineLoader:
    """Batches of ``dataset`` as dicts of the ``names`` fields plus a
    ``mask`` of real rows: torch DataLoader's shuffle and drop_last, and
    a short final batch padded with copies of its first sample (the JAX
    package pads for static shapes; the mask keeps the copies out of the
    metrics)."""

    def __init__(self, dataset, names: Sequence[str], batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.names = list(names)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _jobs(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for bi, start in enumerate(range(0, stop, self.batch_size)):
            idxs = order[start:start + self.batch_size]
            real = len(idxs)
            if real < self.batch_size:
                idxs = np.concatenate(
                    [idxs,
                     np.full(self.batch_size - real, idxs[0] if real else 0)])
            yield bi, idxs, real

    def _make_batch(self, bi: int, idxs: np.ndarray, real: int) -> dict:
        rng = np.random.default_rng((self.seed, self.epoch, bi))
        arrays = self.dataset.batch(np.asarray(idxs), rng)
        batch = {name: np.ascontiguousarray(arr)
                 for name, arr in zip(self.names, arrays)}
        mask = np.zeros(self.batch_size, dtype=bool)
        mask[:real] = True
        batch["mask"] = mask
        return batch

    def __iter__(self) -> Iterator[dict]:
        for job in self._jobs():
            yield self._make_batch(*job)


def make_loader(dataset, names, batch_size, *, shuffle=False,
                drop_last=False, seed=0) -> PipelineLoader:
    return PipelineLoader(dataset, names, batch_size, shuffle=shuffle,
                          drop_last=drop_last, seed=seed)
