"""Heartbeat watchdog, port of ``WatchdogConfig``, ``Watchdog`` and
``EngineWatchdog`` of ``automodel_tpu/resilience/watchdog.py``.

A daemon thread watches a heartbeat the owner *pets* at every step
boundary (two attribute stores on the host). The deadline adapts: an EMA
of the observed step time times a multiplier, clamped by the config, with
a grace budget while the first kernels build. On expiry the watchdog
writes the evidence a post-mortem needs — all-thread stacks through
``faulthandler`` and a flight-recorder dump stamped with the event — and
hands it to its observer (``on_hang``; the serving engine's stall flag,
which fails the stalled wave and keeps serving). Only this record-only
behaviour is ported: JAX's training-side expiry (the peer-preemption
marker and a requeue exit) waits for a training caller.

The poll thread only reads the heartbeat: it never touches the device, so
a CUDA call that blocks the scheduler thread cannot block the watchdog
(the blocking CUDA calls release the GIL, as does ``time.sleep``).
"""

from __future__ import annotations

import dataclasses
import faulthandler
import logging
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

# phase name → config field holding its grace budget
_PHASE_GRACE_FIELDS = {"compile": "compile_grace_s"}


@dataclasses.dataclass
class WatchdogConfig:
    enabled: bool = True
    # adaptive deadline = clamp(ema_step_time * multiplier, min, max)
    multiplier: float = 12.0
    min_deadline_s: float = 120.0
    max_deadline_s: float = 3600.0
    ema_alpha: float = 0.2
    # the deadline while the first kernels build
    compile_grace_s: float = 1800.0
    poll_interval_s: float = 5.0
    # where the all-thread stack dump lands; None → next to the flight
    # recorder (the front passes a default beside the metrics JSONL)
    stacks_path: Optional[str] = None


class Watchdog:
    """Heartbeat watchdog. ``start()`` arms the compile grace and spawns the
    poll thread; the loop calls ``pet(step)`` at every step boundary. On
    expiry the evidence goes to ``on_hang``, which owns what happens next.

    All cross-thread state is plain attribute stores (atomic under the
    GIL); the poll thread tolerates reading a slightly stale pet."""

    # stamped on the evidence record and the flight-recorder dump reason
    EVENT = "hang"

    def __init__(
        self,
        config: WatchdogConfig,
        on_hang: Callable[[dict], None],
        flight_recorder: Any = None,
        metric_logger: Any = None,
    ):
        self.config = config
        self.on_hang = on_hang
        self.flight_recorder = flight_recorder
        self.metric_logger = metric_logger
        self.fired: Optional[dict] = None
        self._last_pet = 0.0
        self._last_step = 0
        self._pets = 0
        self._ema_s: Optional[float] = None
        self._skip_next_ema = False
        self._phase: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- hot-path API --------------------------------------------------------
    def pet(self, step: int) -> None:
        """Heartbeat from the training loop: two attribute stores plus an
        EMA update — strictly host-side, nothing touches the device."""
        now = time.monotonic()
        prev = self._last_pet
        if prev and not self._skip_next_ema:
            dt = now - prev
            a = self.config.ema_alpha
            self._ema_s = dt if self._ema_s is None else a * dt + (1 - a) * self._ema_s
        self._skip_next_ema = False
        self._last_step = step
        self._last_pet = now
        self._pets += 1
        # compile grace ends at the SECOND pet, not the first: the pet
        # lands after async dispatch, but the first real execution blocks
        # at the first log/ckpt barrier AFTER it — one full warm
        # boundary-to-boundary interval must complete before the tight
        # adaptive deadline takes over
        if self._phase == "compile" and self._pets >= 2:
            self._phase = None

    # -- introspection -------------------------------------------------------
    @property
    def ema_step_time_s(self) -> Optional[float]:
        return self._ema_s

    @property
    def heartbeat_age_s(self) -> float:
        return time.monotonic() - self._last_pet if self._last_pet else 0.0

    @property
    def deadline_s(self) -> float:
        """The current permissible heartbeat age."""
        c = self.config
        base = c.min_deadline_s
        if self._ema_s is not None:
            base = min(max(self._ema_s * c.multiplier, c.min_deadline_s),
                       c.max_deadline_s)
        if self._phase is not None:
            base = max(base, getattr(c, _PHASE_GRACE_FIELDS[self._phase]))
        return base

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Watchdog":
        if not self.config.enabled or self._thread is not None:
            return self
        self._phase = "compile"  # until the second pet (see pet())
        self._pets = 0
        self._last_pet = time.monotonic()
        self._skip_next_ema = True  # first dt is compile time, not step time
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hang-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.config.poll_interval_s + 1.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the poll thread -----------------------------------------------------
    def _loop(self) -> None:
        poll = max(self.config.poll_interval_s, 0.01)
        while not self._stop.wait(poll):
            age = self.heartbeat_age_s
            deadline = self.deadline_s
            if age > deadline:
                self._fire(age, deadline)
                return

    def _fire(self, age: float, deadline: float) -> None:
        """Deadline expired: dump the evidence and hand it to ``on_hang``.
        Every step is best-effort — a broken disk must not keep the
        observer from hearing of the stall."""
        rec = {
            "event": self.EVENT,
            "step": self._last_step,
            "heartbeat_age_s": round(age, 3),
            "deadline_s": round(deadline, 3),
            "phase": self._phase,
            "ema_step_time_s": self._ema_s,
            "ts": time.time(),
        }
        self.fired = rec
        print(
            f"[watchdog] {self.EVENT.upper()}: no heartbeat for {age:.1f}s "
            f"(deadline {deadline:.1f}s, last step {self._last_step}"
            + (f", phase {self._phase}" if self._phase else "")
            + ") — dumping stacks + flight recorder",
            file=sys.stderr, flush=True,
        )
        stacks = self._dump_stacks()
        if stacks is not None:
            rec["stacks_path"] = str(stacks)
        if self.flight_recorder is not None:
            try:
                self.flight_recorder.record(rec)
                path = self.flight_recorder.dump(reason=self.EVENT)
                print(f"[watchdog] flight recorder dumped to {path}",
                      file=sys.stderr, flush=True)
            except Exception:
                pass
        if self.metric_logger is not None:
            try:
                self.metric_logger.log(dict(rec))
            except Exception:
                pass
        try:
            self.on_hang(rec)
        except Exception:
            pass

    def set_phase(self, name: Optional[str]) -> None:
        """Pin (or clear) the current phase — the serving engine holds the
        ``compile`` grace until its decode program has actually run once,
        which the second-pet rule cannot know about."""
        if name is not None and name not in _PHASE_GRACE_FIELDS:
            raise ValueError(f"unknown watchdog phase {name!r}")
        self._phase = name

    def touch(self) -> None:
        """Refresh the heartbeat WITHOUT counting a step: used by pollers
        that are legitimately idle (a serving loop with no work) so silence
        that means "nothing to do" is never mistaken for a wedge. The next
        real pet's interval is excluded from the EMA — idle time is not a
        step time."""
        self._last_pet = time.monotonic()
        self._skip_next_ema = True

    def _dump_stacks(self) -> Optional[Path]:
        """All-thread stack traces via faulthandler — the smoking gun for
        'where was everyone when the world stopped'."""
        path = Path(self.config.stacks_path or "watchdog_stacks.txt")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                f.write(
                    f"hang at step {self._last_step}: heartbeat age "
                    f"{self.heartbeat_age_s:.1f}s > deadline "
                    f"{self.deadline_s:.1f}s\n\n"
                )
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
            return path
        except Exception:
            try:  # last resort: stderr
                faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            except Exception:
                pass
            return None


class EngineWatchdog(Watchdog):
    """Serving-side stall watchdog: the same adaptive-deadline EMA, compile
    grace, and evidence machinery as :class:`Watchdog`, with the lifecycle
    a RECOVERING consumer needs:

    - firing is an observation: ``on_hang`` (the serving scheduler's stall
      flag) receives the evidence and the watchdog KEEPS WATCHING. The
      engine fails the stalled wave's requests, rebuilds its pool/slot
      state, and serving continues.
    - it re-arms only after the NEXT pet: one wedged step fires exactly
      once, however long the silence lasts, and the eventual recovery
      interval is excluded from the EMA (a 30s stall must not teach the
      deadline that 30s steps are normal).
    - ``touch()`` (inherited) keeps an IDLE serving loop — no queue, no
      running slots, nothing to pet — from reading as a hang.

    Evidence lands in the same places: all-thread stacks file, flight
    recorder (when given one) with an ``engine_stall`` event, metrics
    JSONL record, ``fired``/``fired_total`` for scrape-time counters.
    """

    EVENT = "engine_stall"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fired_total = 0

    def _loop(self) -> None:
        poll = max(self.config.poll_interval_s, 0.01)
        fired_at_pet = -1
        while not self._stop.wait(poll):
            if self._pets == fired_at_pet:
                # already fired for this silence: stay quiet until the
                # wedged call returns and the scheduler pets us again
                continue
            age = self.heartbeat_age_s
            deadline = self.deadline_s
            if age > deadline:
                self._fire(age, deadline)
                self.fired_total += 1
                fired_at_pet = self._pets
                # the recovery pet's interval includes the stall — keep it
                # out of the EMA
                self._skip_next_ema = True
