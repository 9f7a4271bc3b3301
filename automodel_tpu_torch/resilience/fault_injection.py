"""Fault-injection harness, port of the training side of
``automodel_tpu/resilience/fault_injection.py``: config/env-driven
failures that make the recovery paths testable, deterministically, on the
CPU and on the card.

- ``die_at_step``           — kill the process at optimizer step k
  (``die_mode: hard`` = ``os._exit``, like a SIGKILL'd host mid-save;
  ``exception`` = raise, exercising the crash guard and flight recorder)
- ``nan_grads_at_step``     — poison the gradients at step k inside the
  train step (training/train_step.py), firing the anomaly flags and
  whatever ``on_nonfinite`` policy is configured
- ``corrupt_ckpt_file``     — after a checkpoint commits, flip bytes in the
  first file under the step dir matching this glob, so the next load must
  detect the damage and walk back
- ``fail_io_attempts``/``fail_io_op`` — fail the first M attempts of any
  ``retry_io``-wrapped op whose name contains ``fail_io_op``
- ``hang_at_step``          — block the loop at step k (a bounded
  ``time.sleep``, which releases the GIL like a wedged device call),
  driving the hang watchdog's detect → dump → requeue-exit path
- ``slow_collate_ms``       — sleep that long inside every batch collate
  (``DataLoader.batch_for``), a stand-in for an expensive host input
  pipeline, so the prefetch overlap is provable
- ``desync_batch_at_step``  — perturb this host's rolling batch hash at
  step k (on ``desync_on_host`` only), driving the consensus check
- ``straggle_host``/``straggle_ms`` (``straggle_at_step``: that one step
  only) — sleep per step on one host: the straggler metrics, and with one
  step the step-time spike the triggered capture arms on

The serving and fleet knobs of the JAX module (``serve_*``,
``trace_delay_*``, ``slo_breach_*``, ``weights_stream_abort_after``,
``kv_push_drop_ack``, ``hf_load_delay_ms``) are refused by name: the port's
serving engine has no injection sites yet.

Activation: a ``fault_injection:`` YAML section (the recipes call
``activate_from_config``) or the ``AUTOMODEL_FAULT_INJECTION`` env var
holding the same dict as JSON (for subprocesses, where no recipe code runs
before the fault must be armed). Inactive (the default) every hook is one
None check.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "AUTOMODEL_FAULT_INJECTION"
# distinctive code so tests can tell an injected hard death from a real crash
HARD_DEATH_EXIT_CODE = 113

# the JAX module's serving and fleet knobs, refused by name
SERVING_KNOBS = (
    "serve_hang_at_step", "serve_hang_seconds", "serve_exception_at_step",
    "serve_exhaust_blocks_at_step", "serve_exhaust_hold_steps",
    "trace_delay_stage", "trace_delay_ms",
    "slo_breach_stage", "slo_breach_ms", "slo_breach_from_step", "slo_breach_for_s",
    "weights_stream_abort_after", "kv_push_drop_ack", "hf_load_delay_ms",
    "serve_tenant_flood_at_step", "serve_tenant_flood_requests",
    "serve_tenant_flood_tenant", "serve_tenant_flood_tier",
)


class InjectedFault(RuntimeError):
    """Raised by ``die_mode: exception`` and by injected I/O failures."""


@dataclasses.dataclass
class FaultInjectionConfig:
    die_at_step: Optional[int] = None
    die_mode: str = "hard"  # hard (os._exit, no cleanup) | exception
    nan_grads_at_step: Optional[int] = None
    corrupt_ckpt_file: Optional[str] = None  # glob under the step dir
    fail_io_attempts: int = 0
    fail_io_op: str = ""  # substring of the retry_io op name; "" = every op
    hang_at_step: Optional[int] = None
    hang_seconds: float = 3600.0  # bounded — the watchdog exits long before
    slow_collate_ms: float = 0.0
    desync_batch_at_step: Optional[int] = None
    desync_on_host: int = 0  # rank whose data hash is perturbed
    straggle_host: Optional[int] = None
    straggle_ms: float = 0.0  # per-step sleep on the straggling host
    # None → every step; an int → that one step only (the spike the
    # triggered capture arms on, telemetry/profiling/triggered.py)
    straggle_at_step: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "FaultInjectionConfig":
        d = {k: v for k, v in d.items() if k != "_target_"}
        serving = sorted(k for k in d if k in SERVING_KNOBS)
        if serving:
            raise ValueError(
                f"fault_injection ({', '.join(serving)}): the serving and fleet fault knobs are not "
                "ported to the torch backend yet"
            )
        return cls(**d)


def _process_index() -> int:
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    except Exception:
        return 0


class FaultInjector:
    def __init__(self, config: FaultInjectionConfig):
        self.config = config
        self._io_attempts: dict[str, int] = {}
        self._hung = False

    # -- step-loop hooks ----------------------------------------------------
    def maybe_die(self, step: int) -> None:
        c = self.config
        if c.die_at_step is None or step != c.die_at_step:
            return
        if c.die_mode == "exception":
            raise InjectedFault(f"injected crash at step {step}")
        logger.error("fault injection: hard death at step %d", step)
        os._exit(HARD_DEATH_EXIT_CODE)  # no atexit, no finally — like SIGKILL

    @property
    def nan_grads_at_step(self) -> Optional[int]:
        return self.config.nan_grads_at_step

    def maybe_hang(self, step: int) -> None:
        """Block the loop like a wedged device call would (sleep releases
        the GIL, so the watchdog thread stays runnable). Fires once; the
        watchdog is expected to end the process."""
        c = self.config
        if c.hang_at_step is None or step != c.hang_at_step or self._hung:
            return
        self._hung = True
        logger.error("fault injection: hanging at step %d for up to %.0fs", step, c.hang_seconds)
        time.sleep(c.hang_seconds)

    def maybe_slow_collate(self) -> None:
        """Per-batch collate delay (``DataLoader.batch_for``: the sync path
        and the prefetch collate workers alike)."""
        ms = self.config.slow_collate_ms
        if ms > 0:
            time.sleep(ms / 1000.0)

    def should_desync(self, step: int) -> bool:
        c = self.config
        if c.desync_batch_at_step is None or step != c.desync_batch_at_step:
            return False
        return _process_index() == c.desync_on_host

    def maybe_straggle(self, step: int) -> None:
        c = self.config
        if c.straggle_host is None or c.straggle_ms <= 0:
            return
        if c.straggle_at_step is not None and step != c.straggle_at_step:
            return
        if _process_index() == c.straggle_host:
            time.sleep(c.straggle_ms / 1000.0)

    # -- checkpoint hook ----------------------------------------------------
    def after_checkpoint_save(self, step_dir: Path) -> None:
        """Corrupt the first file under ``step_dir`` matching the configured
        glob (called after the manifest commits, so the damage is exactly
        what integrity verification exists to catch)."""
        pat = self.config.corrupt_ckpt_file
        if not pat:
            return
        for p in sorted(Path(step_dir).rglob("*")):
            if p.is_file() and fnmatch.fnmatch(str(p.relative_to(step_dir)), pat):
                corrupt_file(p)
                logger.error("fault injection: corrupted %s", p)
                return

    # -- retry_io hook ------------------------------------------------------
    def check_io(self, op: str) -> None:
        c = self.config
        if c.fail_io_attempts <= 0 or c.fail_io_op not in op:
            return
        n = self._io_attempts.get(op, 0)
        if n < c.fail_io_attempts:
            self._io_attempts[op] = n + 1
            raise OSError(f"injected I/O failure {n + 1}/{c.fail_io_attempts} for {op}")


def corrupt_file(path: Path | str, offset_fraction: float = 0.5, n_bytes: int = 64) -> None:
    """Flip ``n_bytes`` in the middle of a file in place (bounded by size)."""
    path = Path(path)
    size = path.stat().st_size
    if size == 0:
        path.write_bytes(b"\xff")
        return
    off = int(size * offset_fraction) % size
    n = min(n_bytes, size - off)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


# -- process-global activation ----------------------------------------------
_ACTIVE: Optional[FaultInjector] = None
_ENV_CHECKED = False


def activate(config: FaultInjectionConfig | dict | None) -> Optional[FaultInjector]:
    """Install (or, with None, clear) the process-global injector."""
    global _ACTIVE, _ENV_CHECKED
    _ENV_CHECKED = True  # explicit activation wins over the env var
    if config is None:
        _ACTIVE = None
        return None
    if isinstance(config, dict):
        config = FaultInjectionConfig.from_dict(config)
    armed = (
        config.die_at_step is not None
        or config.nan_grads_at_step is not None
        or config.corrupt_ckpt_file
        or config.fail_io_attempts > 0
        or config.hang_at_step is not None
        or config.slow_collate_ms > 0
        or config.desync_batch_at_step is not None
        or config.straggle_host is not None
    )
    if not armed:
        # an empty `fault_injection: {}` section must not put a do-nothing
        # injector (and its ACTIVE warning) into a production run
        _ACTIVE = None
        return None
    _ACTIVE = FaultInjector(config)
    logger.warning("fault injection ACTIVE: %s", config)
    return _ACTIVE


def activate_from_config(section: Any) -> Optional[FaultInjector]:
    """From a YAML ``fault_injection:`` section (None → env var → inactive)."""
    if section is None:
        return active_injector()
    return activate(dict(section))


def active_injector() -> Optional[FaultInjector]:
    """The process-global injector, arming from ``AUTOMODEL_FAULT_INJECTION``
    (JSON) on first use so subprocesses need no in-process setup."""
    global _ACTIVE, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        raw = os.environ.get(ENV_VAR)
        if raw:
            try:
                _ACTIVE = FaultInjector(FaultInjectionConfig.from_dict(json.loads(raw)))
                logger.warning("fault injection ACTIVE from env: %s", raw)
            except (ValueError, TypeError) as e:
                raise ValueError(f"bad {ENV_VAR} value {raw!r}: {e}") from e
    return _ACTIVE
