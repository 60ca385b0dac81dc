"""Wall-clock timers with ETA extrapolation (timing.{h,c}; counterpart of
``ndt_tpu/utils/timing.py``)."""

from __future__ import annotations

import time


class Timer:
    """timer_start/elapsed/remaining (timing.c:12-49)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def remaining(self, done: float, total: float) -> float:
        """ETA from the completed fraction (timing.c:26-38)."""
        if done <= 0:
            return float("inf")
        return self.elapsed() * (total - done) / done
