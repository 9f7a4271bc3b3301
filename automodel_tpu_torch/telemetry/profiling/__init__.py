"""Performance-observability pillar of the telemetry subsystem, port of
``automodel_tpu/telemetry/profiling``.

- cost.py      — measured FLOPs/bytes of one real step (a dispatch-mode
  counter plus the kernel wrappers' own counts), roofline class and
  ``mfu_measured_pct`` beside the analytic law
- trace.py     — ``torch.profiler`` Chrome-trace parsing → structured JSON
  + generated PROFILE markdown (top-K self-time ops, busy / comm /
  host-gap decomposition, named-scope attribution)
- triggered.py — anomaly-armed capture: a slow step (k× the EMA) or a
  non-finite flag opens the next trace window + a memory record
- runner.py    — the ``profile`` command: a trace window around N steps of
  a recipe, artifacts generated under ``<output_dir>/profile/``

YAML::

    profiling:
      enabled: true
      cost_attribution: true     # mfu_measured_pct + breakdown on log records
      peak_tflops: null          # device-table override (mandatory on CPU)
      hbm_gbps: null             # bandwidth override for the roofline
      top_k: 20                  # report width
      trace_steps: 3             # `profile` window length
      trace_warmup_steps: 2      #   steps before the window opens
      triggered:                 # anomaly-armed capture (triggered.py)
        slow_step_factor: 3.0
        capture_steps: 2
        max_captures: 2

    metrics_server:              # training-side /metrics port (prometheus.py)
      port: 9100
      host: 127.0.0.1
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from automodel_tpu_torch.telemetry.profiling.cost import (  # noqa: F401
    CostCounter,
    ProgramCost,
    RooflineConfig,
    count_cost,
    mfu_measured_pct,
    roofline,
)
from automodel_tpu_torch.telemetry.profiling.trace import (  # noqa: F401
    analyze_trace,
    load_trace_events,
    render_markdown,
)
from automodel_tpu_torch.telemetry.profiling.triggered import (  # noqa: F401
    TriggeredCapture,
    TriggeredCaptureConfig,
)


def record_program_cost(store: dict, name: str, fn, *args):
    """Run ``fn(*args)`` once under a cost counter, its measured cost into
    ``store[name]`` → fn's result."""
    out, cost = count_cost(fn, *args, program=name)
    store[name] = cost.to_dict()
    return out


@dataclasses.dataclass
class ProfilingConfig:
    """The ``profiling:`` YAML section."""

    enabled: bool = True
    cost_attribution: bool = True
    peak_tflops: Optional[float] = None
    hbm_gbps: Optional[float] = None
    top_k: int = 20
    # `profile` runner knobs
    mode: str = "train"  # train | generate
    trace_steps: int = 3
    trace_warmup_steps: int = 2
    trace_dir: Optional[str] = None  # default: <output_dir>/profile/trace
    triggered: Optional[dict] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ProfilingConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TypeError(f"unknown profiling keys: {sorted(unknown)}")
        return cls(**d)

    def roofline_basis(self) -> RooflineConfig:
        return RooflineConfig(peak_tflops=self.peak_tflops, hbm_gbps=self.hbm_gbps)

    def triggered_config(self, default_dir: str) -> TriggeredCaptureConfig:
        sub = dict(self.triggered or {})
        sub.pop("_target_", None)
        sub.setdefault("capture_dir", default_dir)
        return TriggeredCaptureConfig(**sub)


__all__ = [
    "ProfilingConfig",
    "ProgramCost",
    "RooflineConfig",
    "TriggeredCapture",
    "TriggeredCaptureConfig",
    "CostCounter",
    "analyze_trace",
    "count_cost",
    "load_trace_events",
    "mfu_measured_pct",
    "record_program_cost",
    "render_markdown",
    "roofline",
]
