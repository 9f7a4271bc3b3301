"""Profiling hooks, port of ``automodel_tpu/utils/profiler.py``: a
``torch.profiler`` trace opened and closed on a step window.

The trace records CPU activities and, when CUDA is available, the device's
(CUPTI: the kernels, copies and memsets on each stream), and is written as
a Chrome-trace JSON (``export_chrome_trace``; gzip'd when ``perfetto``, the
JAX key that asks for the JSON the trace analyzer parses) under
``trace_dir``, where ``telemetry/profiling/trace.py`` reads it.
``record_function`` ranges are the named scopes (``annotate``). One trace
is active at a time in a process: ``start_trace`` refuses a second.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger(__name__)

_active: Optional[tuple] = None  # (profile, trace_dir, gzip)


@dataclasses.dataclass
class ProfilerConfig:
    enabled: bool = False
    trace_dir: str = "runs/trace"
    start_step: int = 3
    end_step: int = 5
    # write the trace gzip'd (trace.json.gz); the analyzer reads either
    perfetto: bool = True


def start_trace(trace_dir: str, perfetto: bool = True, warmup: bool = False) -> None:
    """Start a ``torch.profiler`` trace (CPU, plus CUDA when available).
    With ``warmup`` the device activity is enabled now but recorded only
    from the next ``step_trace()``: the kernels that run in the first
    milliseconds after it is enabled can go unrecorded (a step's first
    projections and flash forward were missing from a window on the H100),
    so a window that must hold every kernel warms up over the step before
    it (``torch.profiler.schedule``'s warmup)."""
    global _active
    if _active is not None:
        raise RuntimeError(f"a profiler trace is already active ({_active[1]})")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=2**31) if warmup else None
    prof = torch.profiler.profile(activities=acts, schedule=schedule)
    prof.start()
    _active = (prof, str(trace_dir), perfetto)


def step_trace() -> None:
    """End a warming trace's warmup: record from here on."""
    _active[0].step()


def stop_trace() -> Path:
    """Stop the active trace and write it → the Chrome-trace file."""
    global _active
    if _active is None:
        raise RuntimeError("no profiler trace is active")
    prof, trace_dir, gz = _active
    _active = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json{'.gz' if gz else ''}"
    prof.export_chrome_trace(str(path))
    return path


class StepProfiler:
    """Traces steps in [start_step, end_step), warming the device activity
    up over the step before when there is one."""

    def __init__(self, config: ProfilerConfig):
        self.config = config
        self._active = False
        self._warming = False
        self.trace_path: Optional[Path] = None

    @property
    def active(self) -> bool:
        return self._active

    def on_step(self, step: int) -> None:
        c = self.config
        if not c.enabled:
            return
        if not self._active and step == c.start_step - 1 and step >= 1:
            start_trace(c.trace_dir, perfetto=c.perfetto, warmup=True)
            self._active = self._warming = True
            logger.info("profiler: warming up at step %d for the window at %d", step, c.start_step)
        elif self._warming and step >= c.start_step:
            step_trace()
            self._warming = False
            logger.info("profiler: trace recording from step %d → %s", step, c.trace_dir)
        # window containment, not equality: a run resumed past start_step
        # still traces the rest of its window
        elif not self._active and c.start_step <= step < c.end_step:
            start_trace(c.trace_dir, perfetto=c.perfetto)
            self._active = True
            logger.info("profiler: trace started at step %d → %s", step, c.trace_dir)
        if self._active and not self._warming and step >= c.end_step:
            self.trace_path = stop_trace()
            self._active = False
            logger.info("profiler: trace stopped at step %d → %s", step, self.trace_path)

    def close(self) -> None:
        if self._active:
            self.trace_path = stop_trace()
            self._active = self._warming = False


annotate = torch.profiler.record_function  # model-code annotation (a named scope)
