"""Host-side timing: the port of ``impact_tpu/utils/timing.py``.

``TaskTimer`` aggregates wall-clock durations by label (ref:
impact_profiling/src/instrumentation/timing.rs:49-66) and ``EngineMetrics``
keeps smoothed frame durations (ref: engine/src/instrumentation.rs:15-75).
A label given ``block_on`` (a device, or a tensor on one) ends with a
``torch.cuda.synchronize`` of that device, so it measures the device work
its block enqueued and not only the enqueue.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from contextlib import contextmanager

import torch


def _synchronize(block_on):
    dev = block_on.device if isinstance(block_on, torch.Tensor) else torch.device(block_on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TaskTimer:
    """Aggregates wall-clock durations by label."""

    def __init__(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def time(self, label: str, block_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self._totals[label] += time.perf_counter() - start
            self._counts[label] += 1

    def drain(self) -> dict[str, tuple[float, int]]:
        """Return {label: (total_seconds, count)} and reset."""
        out = {k: (self._totals[k], self._counts[k]) for k in self._totals}
        self._totals.clear()
        self._counts.clear()
        return out


class EngineMetrics:
    """Smoothed frame-duration tracking over a ring buffer of recent frames."""

    def __init__(self, window: int = 10):
        self._durations = deque(maxlen=window)
        self.last_task_execution_times: dict[str, tuple[float, int]] = {}

    def record_frame(self, duration_s: float):
        self._durations.append(duration_s)

    @property
    def current_smooth_frame_duration(self) -> float:
        if not self._durations:
            return 0.0
        return sum(self._durations) / len(self._durations)

    @property
    def fps(self) -> float:
        d = self.current_smooth_frame_duration
        return 1.0 / d if d > 0 else 0.0
