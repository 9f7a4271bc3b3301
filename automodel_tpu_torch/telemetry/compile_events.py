"""Host-side build events as step metrics, port of
``automodel_tpu/telemetry/compile_events.py``.

The port has no XLA compile. Its host-side builds are the ``nvcc`` builds
and ``ctypes`` loads of the CUDA kernels (``ops/_cuda_build.load``) and the
``g++`` build of the Megatron index helpers (``data/megatron/helpers.py``):
each spends seconds on the host and shows up as one slow step. The
builders report each event here (``record``); the totals are process-wide
and each consumer drains the delta since its last look, so the loop stamps
``recompiles`` / ``recompile_secs`` onto exactly the log window in which a
build happened. A build counts as one compile; a load of a library that was
already built adds its seconds only (JAX counts backend compiles and adds
every phase's seconds).
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_totals = {"count": 0, "secs": 0.0}


def record(secs: float, built: bool) -> None:
    """One build (``built``) or load event of ``secs`` wall seconds."""
    with _lock:
        if built:
            _totals["count"] += 1
        _totals["secs"] += float(secs)


class CompileEventBridge:
    """Per-consumer cursor over the process-global build counters."""

    def __init__(self):
        with _lock:
            self._seen_count = _totals["count"]
            self._seen_secs = _totals["secs"]

    def drain(self) -> dict[str, float]:
        """→ {"compiles": n, "compile_secs": s} since the previous drain."""
        with _lock:
            count, secs = _totals["count"], _totals["secs"]
        out = {"compiles": count - self._seen_count, "compile_secs": secs - self._seen_secs}
        self._seen_count, self._seen_secs = count, secs
        return out
