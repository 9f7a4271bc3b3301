"""Named timers for benchmarking, port of ``Timer`` and ``Timers``
(``automodel_tpu/training/timers.py:21-124``).

One process observes the whole step, so no cross-rank reduction.
``barrier_on=`` synchronises with the device first: for a CUDA tensor
``torch.cuda.synchronize`` on its device, for a CPU tensor nothing.
``measured_bubble_fraction`` waits for the pipeline-parallel port.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import torch

# retained raw entries per timer; the aggregates (count/mean/min/max) stay
# exact for the whole run, the cap only bounds host memory
_MAX_HISTORY = 4096


def barrier(t: torch.Tensor) -> None:
    """Wait until the work queued on ``t``'s CUDA device has finished; a
    CPU tensor needs no wait."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class Timer:
    def __init__(self, name: str):
        self.name = name
        self._start: Optional[float] = None
        self.elapsed_history: deque[float] = deque(maxlen=_MAX_HISTORY)
        self._pending: deque[float] = deque(maxlen=_MAX_HISTORY)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = 0.0

    def start(self, barrier_on: Optional[torch.Tensor] = None) -> None:
        if barrier_on is not None:
            barrier(barrier_on)
        self._start = time.perf_counter()

    def stop(self, barrier_on: Optional[torch.Tensor] = None) -> float:
        if barrier_on is not None:
            barrier(barrier_on)
        assert self._start is not None, f"timer {self.name} not started"
        dt = time.perf_counter() - self._start
        self.elapsed_history.append(dt)
        self._pending.append(dt)
        self._count += 1
        self._sum += dt
        self._min = dt if dt < self._min else self._min
        self._max = dt if dt > self._max else self._max
        self._start = None
        return dt

    @property
    def count(self) -> int:
        return self._count

    def mean(self, skip_first: int = 0) -> float:
        if skip_first:  # over the retained window only
            h = list(self.elapsed_history)[skip_first:]
            return sum(h) / max(len(h), 1)
        return self._sum / max(self._count, 1)

    def min(self, skip_first: int = 0) -> float:
        if skip_first:
            h = list(self.elapsed_history)[skip_first:]
            return min(h) if h else 0.0
        return self._min if self._count else 0.0

    def max(self, skip_first: int = 0) -> float:
        if skip_first:
            h = list(self.elapsed_history)[skip_first:]
            return max(h) if h else 0.0
        return self._max

    def drain(self) -> list[float]:
        """Entries recorded since the previous drain (per-window means for
        a periodic consumer, while ``summary()`` keeps the whole run)."""
        new = list(self._pending)
        self._pending.clear()
        return new


class Timers:
    def __init__(self):
        self._timers: dict[str, Timer] = {}

    def __call__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    def drain_means(self) -> dict[str, float]:
        """Per-timer mean over the entries recorded since the last drain;
        timers with no new entries are omitted."""
        out: dict[str, float] = {}
        for n, t in self._timers.items():
            new = t.drain()
            if new:
                out[n] = sum(new) / len(new)
        return out

    def summary(self, skip_first: int = 0) -> dict[str, dict[str, float]]:
        return {
            n: {
                "mean_s": t.mean(skip_first),
                "min_s": t.min(skip_first),
                "max_s": t.max(skip_first),
                "count": t.count,
            }
            for n, t in self._timers.items()
        }
