"""Telemetry of the torch port, port of ``automodel_tpu/telemetry``.

Pillars, each its own module, and one facade (``Telemetry``) the recipes
wire through YAML:

- memory.py          — allocator counters + top-K live-tensor census
- anomaly.py         — nonfinite flag, non-finite count, per-group grad norms
- compile_events.py  — host-side kernel builds → per-window metrics
- flight_recorder.py — last-N step ring + fingerprint, dumped on crash
- report.py          — JSONL schema lint / summary table
- goodput.py         — the run ledger (startup / compile / step / ... segments)
- prometheus.py      — /metrics exposition (serving and training)
- profiling/         — cost attribution, trace analysis, triggered capture

YAML::

    telemetry:
      enabled: true
      anomaly_flags: true           # nonfinite + per-group grad norms
      memory_every_steps: 50        # 0 disables the periodic census
      census_top_k: 8
      goodput: true                 # goodput.jsonl beside the metrics JSONL
      flight_recorder_steps: 16     # ring capacity; 0 disables
      flight_recorder_path: flight_recorder.json
      compile_events: true
      profile: {enabled: false, trace_dir: ..., start_step: 3, end_step: 5}

Defaults are on: a recipe with no ``telemetry:`` section still gets anomaly
flags, the step-time split, build-event stamps and a crash dump. The
per-step host cost is two perf_counter pairs, one deque append and dict
merges; the memory census runs every N steps only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional

from automodel_tpu_torch.telemetry import memory as memory_telemetry
from automodel_tpu_torch.telemetry.anomaly import (  # noqa: F401  (re-export)
    anomaly_metrics,
    group_grad_norms,
    jax_groups,
    nonfinite_count,
)
from automodel_tpu_torch.telemetry.compile_events import CompileEventBridge
from automodel_tpu_torch.telemetry.flight_recorder import FlightRecorder, build_fingerprint
from automodel_tpu_torch.training.timers import Timers
from automodel_tpu_torch.utils.profiler import ProfilerConfig, StepProfiler

memory_snapshot = memory_telemetry.memory_snapshot  # re-export


@dataclasses.dataclass
class TelemetryConfig:
    enabled: bool = True
    # nonfinite flag + per-group grad norms (the recipe reads this key from
    # the YAML section directly: the step is built before the facade)
    anomaly_flags: bool = True
    memory_every_steps: int = 50
    census_top_k: int = 8
    # run-ledger goodput accounting (telemetry/goodput.py): the append-only
    # goodput.jsonl segment log in the run's output_dir, chained across
    # restart attempts. Built by the recipe (it owns output_dir), gated here
    goodput: bool = True
    flight_recorder_steps: int = 16
    flight_recorder_path: str = "flight_recorder.json"
    compile_events: bool = True
    profile: Optional[dict] = None


class Telemetry:
    """Facade the recipes drive: timers for the step-time split, a compile
    bridge drained at log boundaries, a memory sampler on a step cadence,
    a StepProfiler window, and the crash flight recorder."""

    def __init__(self, config: TelemetryConfig, fingerprint: Optional[dict] = None, device: Any = None):
        self.config = config
        # the device the memory census reads (None: every visible device)
        self.device = device
        self.timers = Timers()
        on = config.enabled
        self.flight_recorder = (
            FlightRecorder(
                capacity=config.flight_recorder_steps,
                path=config.flight_recorder_path,
                fingerprint=fingerprint,
                census_top_k=config.census_top_k,
            )
            if on and config.flight_recorder_steps > 0
            else None
        )
        self.compile_bridge = CompileEventBridge() if on and config.compile_events else None
        self.profiler = (
            StepProfiler(ProfilerConfig(**dict(config.profile)))
            if on and config.profile
            else None
        )
        self.memory_samples = 0
        # allocator scalars sampled on the step cadence, attached to the
        # next log record (sampling must not depend on the log cadence)
        self._pending_mem: Optional[tuple] = None
        # anomaly-armed profiler (telemetry/profiling/triggered.py) —
        # attached by the recipe via attach_profiling()
        self.triggered = None

    @classmethod
    def from_config(
        cls,
        section: Any,
        fingerprint: Optional[dict] = None,
        default_recorder_path: Optional[str] = None,
        default_trace_dir: Optional[str] = None,
        device: Any = None,
    ) -> "Telemetry":
        """Build from a YAML `telemetry:` section (None → all defaults).
        ``default_recorder_path`` places the crash dump next to the metrics
        JSONL unless the YAML pins a path; ``default_trace_dir`` routes a
        profile window's trace under the run's output_dir likewise."""
        d = dict(section or {})
        d.pop("_target_", None)
        if "flight_recorder_path" not in d and default_recorder_path:
            d["flight_recorder_path"] = default_recorder_path
        if d.get("profile") and default_trace_dir:
            p = dict(d["profile"])
            p.setdefault("trace_dir", default_trace_dir)
            d["profile"] = p
        return cls(TelemetryConfig(**d), fingerprint=fingerprint, device=device)

    # -- per-step hooks ------------------------------------------------------
    def on_step(self, step: int) -> None:
        """Per-step hook: profiler window management + the memory census on
        its OWN cadence (independent of the log cadence — a run with
        log_every_steps=3 and memory_every_steps=50 still samples every 50).
        The census goes to the flight-recorder ring; the two allocator
        scalars ride the next log record via enrich()."""
        # mutual exclusion both ways — one profiler trace at a time. The
        # triggered profiler defers to an OPEN manual window (its
        # trace_active check); conversely the manual window PREEMPTS an
        # in-flight triggered capture when its start step arrives: the
        # operator asked for that exact window, and waiting could consume
        # it entirely (a capture spanning [start, end) would mean the
        # manual trace silently never opens). Closing the capture early
        # still stops the trace, dumps the memory profile, and stamps the
        # evidence record.
        if self.profiler is not None:
            c = self.profiler.config
            manual_wants = (
                c.enabled
                and not self.profiler.active
                and c.start_step <= step < c.end_step
            )
            if (
                manual_wants
                and self.triggered is not None
                and self.triggered.active
            ):
                self.triggered.close()
            was_active = self.profiler.active
            if not (self.triggered is not None and self.triggered.active):
                self.profiler.on_step(step)
            # the manual window's own cost (the trace's overhead, its stop
            # writing the file inside this interval) must not read as a
            # slow step to the triggered capture
            if self.triggered is not None and (was_active or self.profiler.active):
                self.triggered.skip_next_interval()
        if self.triggered is not None:
            self.triggered.on_step(step)
        if self.should_sample_memory(step):
            # the census walks the live tensors inside the next interval
            if self.triggered is not None:
                self.triggered.skip_next_interval()
            self.memory_samples += 1
            self._pending_mem = memory_telemetry.max_bytes_in_use(self.device)
            self.record_step(
                {
                    "step": step,
                    "ts": time.time(),
                    "memory": memory_telemetry.memory_snapshot(self.config.census_top_k, self.device),
                }
            )

    def record_step(self, rec: dict[str, Any]) -> None:
        """Append a host-side record to the flight-recorder ring. Callers
        must not pass unfetched device arrays (that would force a sync)."""
        if self.flight_recorder is not None:
            self.flight_recorder.record(rec)

    def should_sample_memory(self, step: int) -> bool:
        c = self.config
        return c.enabled and c.memory_every_steps > 0 and step % c.memory_every_steps == 0

    # -- log-boundary enrichment --------------------------------------------
    def enrich(self, step: int, metrics: dict[str, Any]) -> dict[str, Any]:
        """Fold telemetry into a log-step metrics dict: window means of the
        data-wait/dispatch/device-sync timers, build events since the last
        log, and (on the memory cadence) the two allocator scalars. The full
        census goes to the flight-recorder ring, not the JSONL."""
        if not self.config.enabled:
            return metrics
        for name, mean_s in self.timers.drain_means().items():
            metrics[f"time/{name}_s"] = mean_s
        if self.compile_bridge is not None:
            d = self.compile_bridge.drain()
            if d["compiles"]:
                metrics["recompiles"] = d["compiles"]
                metrics["recompile_secs"] = round(d["compile_secs"], 4)
        if self._pending_mem is not None:
            metrics["mem_bytes_in_use"], metrics["mem_peak_bytes"] = self._pending_mem
            self._pending_mem = None
        return metrics

    # -- profiling pillar ----------------------------------------------------
    def attach_profiling(self, profiling_config, capture_dir: str, event_hook=None):
        """Arm the triggered-capture profiler (telemetry/profiling/). The
        event hook receives ``trace_capture`` records — recipes point it at
        the flight recorder + metrics JSONL. No-op when disabled."""
        if not (self.config.enabled and profiling_config.enabled):
            return
        tcfg = profiling_config.triggered_config(capture_dir)
        if not tcfg.enabled:
            return
        from automodel_tpu_torch.telemetry.profiling import TriggeredCapture

        self.triggered = TriggeredCapture(
            tcfg,
            event_hook=event_hook or self.record_step,
            # never double-start: a manual StepProfiler window wins
            trace_active=(
                (lambda: self.profiler.active) if self.profiler is not None
                else (lambda: False)
            ),
        )

    def trigger_capture(self, step: int, reason: str) -> None:
        """External anomaly (non-finite policy): capture the next window."""
        if self.triggered is not None:
            self.triggered.trigger(step, reason)

    def skip_next_interval(self) -> None:
        """A legitimate pause (checkpoint/validation/eval generation) ends
        here: the boundary-spanning interval must not read as a slow-step
        anomaly (the recipes call this where their timing windows reset)."""
        if self.triggered is not None:
            self.triggered.skip_next_interval()

    # -- lifecycle -----------------------------------------------------------
    def crash_guard(self):
        """Context manager that dumps the flight recorder on any exception
        (and re-raises). A disabled recorder degrades to a no-op."""
        return self.flight_recorder if self.flight_recorder is not None else contextlib.nullcontext()

    def close(self) -> None:
        if self.triggered is not None:
            self.triggered.close()
        if self.profiler is not None:
            self.profiler.close()


__all__ = [
    "Telemetry",
    "TelemetryConfig",
    "CompileEventBridge",
    "FlightRecorder",
    "build_fingerprint",
    "memory_snapshot",
    "anomaly_metrics",
    "group_grad_norms",
    "jax_groups",
    "nonfinite_count",
]
