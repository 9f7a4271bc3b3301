"""Anomaly-armed profiler, port of
``automodel_tpu/telemetry/profiling/triggered.py``: capture evidence WHEN
something goes wrong.

Armed after a short warmup, it watches the host wall time between step
boundaries (which backpressure makes track device time); when a step
exceeds ``slow_step_factor ×`` the EMA (or the non-finite policy fires),
it

1. opens a ``torch.profiler`` trace (utils/profiler.py) for the NEXT
   ``capture_steps`` steps, then
2. writes a memory record beside it: on CUDA the caching allocator's
   snapshot (``torch.cuda.memory._record_memory_history`` armed at the
   capture's start without stack traces, ``_dump_snapshot`` to
   ``memory_snapshot.pickle`` at its end), on the CPU the live-tensor
   census (``memory_census.json``), and
3. stamps a ``trace_capture`` event — trigger reason, observed/EMA step
   time, capture path — into the flight recorder and the metrics JSONL.

Captures are bounded (``max_captures``) and the trigger EMA excludes fired
steps. A manual window and a triggered capture never overlap (one trace at
a time): a capture never starts while a manual window is open (the skip is
stamped), and a manual window whose start step arrives mid-capture
preempts it (``Telemetry.on_step`` closes the capture first).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Callable, Optional

import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TriggeredCaptureConfig:
    enabled: bool = True
    slow_step_factor: float = 3.0  # fire when dt > factor × EMA
    ema_alpha: float = 0.2
    warmup_steps: int = 3  # steps observed before arming (compile excluded)
    capture_steps: int = 2  # trace window length once fired
    max_captures: int = 2  # per run
    min_interval_s: float = 0.0  # optional cool-down between captures
    memory_profile: bool = True
    capture_on_nonfinite: bool = True
    capture_dir: str = "captures"  # under the run's output_dir


class TriggeredCapture:
    """``on_step(step)`` at every step boundary; ``trigger(step, reason)``
    for external anomalies (non-finite policy). ``event_hook`` receives the
    evidence records (train_ft points it at flight recorder + JSONL)."""

    def __init__(
        self,
        config: TriggeredCaptureConfig,
        event_hook: Optional[Callable[[dict], None]] = None,
        trace_active: Optional[Callable[[], bool]] = None,
        now: Callable[[], float] = time.perf_counter,
    ):
        self.config = config
        self.event_hook = event_hook
        # someone else's trace window (StepProfiler) — never double-start
        self._external_trace_active = trace_active or (lambda: False)
        self._now = now
        self._prev_t: Optional[float] = None
        self._ema: Optional[float] = None
        self._observed = 0
        # the first interval holds the kernels' builds and the allocator's
        # warm-up — feeding it to the EMA would set the baseline seconds
        # high and mask every real spike until the EMA decays; drop it
        self._skip_compile_dt = True
        # warmup intervals are collected and the EMA seeded with their MIN:
        # early steps legitimately hold one-off costs (a build, the cost
        # count of step 1), and seeding with the first or mean interval
        # would bake them into the baseline. Spikes are only ever upward, so the warmup minimum is
        # the one sample guaranteed to be a real step; the EMA then adapts
        # upward from accepted steady-state intervals.
        self._warmup_dts: list[float] = []
        self._capturing_until: Optional[int] = None
        self._pending_reason: Optional[dict] = None
        self._last_capture_t: Optional[float] = None
        self._budget_skip_emitted = False
        # phase boundaries (checkpoint save, validation, eval generation)
        # legitimately dwarf a step: the recipe calls skip_next_interval()
        # after them so the boundary-spanning dt neither triggers a capture
        # nor feeds the EMA — same idea as the watchdog's phase grace
        self._skip_next = False
        self.captures = 0
        self.active = False  # our own trace window is open
        self._last_step: Optional[int] = None

    # -- capture plumbing ----------------------------------------------------
    def _emit(self, rec: dict) -> None:
        rec = {"event": "trace_capture", "ts": time.time(), **rec}
        if self.event_hook is not None:
            try:
                self.event_hook(rec)
            except Exception:
                pass

    def _start(self, step: int, reason: dict) -> None:
        if self._external_trace_active():
            self._emit(
                {"step": step, **reason, "skipped": "manual trace window active"}
            )
            return
        out = Path(self.config.capture_dir) / f"step_{step}_{reason['reason']}"
        out.mkdir(parents=True, exist_ok=True)
        from automodel_tpu_torch.utils.profiler import start_trace

        try:
            start_trace(str(out))
            if self.config.memory_profile and torch.cuda.is_available():
                # the allocator's events without stack traces: taking Python
                # frames from the autograd engine's thread (a remat recompute
                # in the backward) fails inside torch (SystemError on the card)
                torch.cuda.memory._record_memory_history(context=None, max_entries=100000)
        except Exception as e:
            self._emit({"step": step, **reason, "skipped": f"start_trace: {e}"})
            return
        self.active = True
        self.captures += 1
        self._last_capture_t = self._now()
        self._capturing_until = step + max(self.config.capture_steps, 1)
        self._capture_path = str(out)
        self._capture_reason = reason
        logger.warning(
            "triggered capture #%d at step %d (%s) -> %s",
            self.captures, step, reason["reason"], out,
        )

    def _stop(self, step: int) -> None:
        from automodel_tpu_torch.utils.profiler import stop_trace

        rec = {
            "step": step,
            "capture_path": self._capture_path,
            "captures_total": self.captures,
            **self._capture_reason,
        }
        try:
            rec["trace_file"] = str(stop_trace())
        except Exception as e:
            logger.warning("triggered capture stop failed: %s", e)
        self.active = False
        self._capturing_until = None
        if self.config.memory_profile:
            try:
                if torch.cuda.is_available():
                    mem = str(Path(self._capture_path) / "memory_snapshot.pickle")
                    torch.cuda.memory._dump_snapshot(mem)
                    torch.cuda.memory._record_memory_history(enabled=None)
                else:
                    from automodel_tpu_torch.telemetry.memory import memory_snapshot

                    mem = str(Path(self._capture_path) / "memory_census.json")
                    Path(mem).write_text(json.dumps(memory_snapshot(), default=str))
                rec["memory_profile"] = mem
            except Exception as e:
                rec["memory_profile_error"] = str(e)
        self._emit(rec)

    def _may_fire(self, step: int, reason: str) -> bool:
        """Budget/cool-down gate. A trigger BLOCKED by the budget is itself
        evidence (the operator asking "why was this anomaly not captured?"
        must find an answer) — stamped once per run, not per slow step."""
        c = self.config
        if not c.enabled or self.active:
            return False
        if self.captures >= c.max_captures:
            if not self._budget_skip_emitted:
                self._budget_skip_emitted = True
                self._emit(
                    {
                        "step": step, "reason": reason,
                        "skipped": f"capture budget exhausted "
                        f"(max_captures={c.max_captures}); further triggers "
                        "are not stamped",
                    }
                )
            return False
        if (
            c.min_interval_s > 0
            and self._last_capture_t is not None
            and self._now() - self._last_capture_t < c.min_interval_s
        ):
            return False
        return True

    # -- hooks ---------------------------------------------------------------
    def on_step(self, step: int) -> None:
        self._last_step = step
        t = self._now()
        prev, self._prev_t = self._prev_t, t
        if self.active and self._capturing_until is not None and step >= self._capturing_until:
            self._stop(step)
            # the capture window's own wall time must not feed the EMA
            self._prev_t = self._now()
            return
        if self.active or prev is None:
            return
        if self._skip_compile_dt:
            self._skip_compile_dt = False
            return
        if self._skip_next:
            self._skip_next = False
            return
        dt = t - prev
        if self._observed < self.config.warmup_steps:
            self._warmup_dts.append(dt)
            self._observed += 1
            if self._observed == self.config.warmup_steps:
                self._ema = min(self._warmup_dts)
            return
        armed = self._ema is not None
        if armed and dt > self.config.slow_step_factor * self._ema:
            if self._may_fire(step, "slow_step"):
                self._start(
                    step,
                    {
                        "reason": "slow_step",
                        "step_time_s": round(dt, 4),
                        "ema_step_time_s": round(self._ema, 4),
                        "factor": round(dt / self._ema, 2),
                    },
                )
            # the anomalous dt stays out of the EMA whether or not the
            # capture fired (budget/cool-down blocks must not teach the
            # baseline that slow is normal either)
            return
        a = self.config.ema_alpha
        self._ema = dt if self._ema is None else a * dt + (1 - a) * self._ema

    def skip_next_interval(self) -> None:
        """The next inter-step interval spans a legitimate pause
        (checkpoint save, validation, eval generation) — drop it."""
        self._skip_next = True

    def trigger(self, step: int, reason: str) -> None:
        """External anomaly (non-finite flag): capture the next window."""
        self._last_step = step
        if reason == "nonfinite" and not self.config.capture_on_nonfinite:
            return
        if self._may_fire(step, reason):
            self._start(step, {"reason": reason})

    def close(self) -> None:
        # stamped with the last step seen: a run that ends (or rolls back)
        # inside the window never reaches the window's end step
        if self.active:
            self._stop(self._last_step if self._last_step is not None else (self._capturing_until or -1))
