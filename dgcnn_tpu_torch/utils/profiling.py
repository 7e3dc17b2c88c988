"""The training loop's throughput meter (port of ``ThroughputMeter`` of
dgcnn_tpu/utils/profiling.py)."""
from __future__ import annotations

import time


class ThroughputMeter:
    """Clouds per second, exponentially smoothed across ticks: the
    ``throughput`` of the ``Train`` line.  Host clock; the caller makes the
    device finish its work before ``tick``."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.rate: float | None = None
        self._t: float | None = None

    def start(self) -> None:
        self._t = time.perf_counter()

    def tick(self, items: int) -> float:
        now = time.perf_counter()
        if self._t is None:
            self._t = now
            return 0.0
        dt = max(now - self._t, 1e-9)
        self._t = now
        inst = items / dt
        self.rate = (inst if self.rate is None
                     else self.smoothing * self.rate
                     + (1 - self.smoothing) * inst)
        return self.rate
