"""Hang watchdog, port of ``automodel_tpu/resilience/watchdog.py``:
detect the failure that never announces itself.

- A daemon thread watches a heartbeat the training loop *pets* at every
  step boundary. The pet is two attribute stores on the host — nothing
  touches the device.
- The deadline ADAPTS: an EMA of observed step time × a multiplier,
  floored/ceilinged by config, with separate grace budgets for the phases
  that are legitimately slow (the first step's kernel builds, checkpoint
  saves, validation/generation, shutdown).
- On expiry the watchdog collects the evidence a post-mortem needs —
  all-thread stacks via ``faulthandler``, a forced flight-recorder dump
  stamped with a ``hang`` event — then hard-exits with the requeue exit
  code (75) so slurm/k8s recycle the job. A run that never committed a
  checkpoint exits 1 instead (requeueing it would hang again from
  scratch).
- ``EngineWatchdog`` (serving) keeps the record-only behaviour: it hands
  the evidence to its ``on_hang`` observer and keeps watching.

The watchdog thread needs the GIL to run; the blocking CUDA calls
(synchronize, a copy to the host) release it, as does ``time.sleep``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import logging
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

from automodel_tpu_torch.resilience.preemption import (
    REQUEUE_EXIT_CODE,
    write_peer_preemption_marker,
)

logger = logging.getLogger(__name__)

# phase name → config field holding its grace budget
_PHASE_GRACE_FIELDS = {
    "compile": "compile_grace_s",
    "checkpoint": "checkpoint_grace_s",
    "eval": "eval_grace_s",
    "shutdown": "shutdown_grace_s",
}


@dataclasses.dataclass
class WatchdogConfig:
    enabled: bool = True
    # adaptive deadline = clamp(ema_step_time * multiplier, min, max)
    multiplier: float = 12.0
    min_deadline_s: float = 120.0
    max_deadline_s: float = 3600.0
    ema_alpha: float = 0.2
    # phase grace budgets: the deadline while the loop is legitimately slow
    compile_grace_s: float = 1800.0
    checkpoint_grace_s: float = 900.0
    eval_grace_s: float = 900.0
    shutdown_grace_s: float = 600.0
    poll_interval_s: float = 5.0
    # where the all-thread stack dump lands; None → next to the flight
    # recorder (the recipe passes a default beside the metrics JSONL)
    stacks_path: Optional[str] = None
    # False = diagnose (stacks + flight recorder + hang event) but do not
    # exit — for embedding in processes that own their own lifecycle
    exit_on_hang: bool = True


class Watchdog:
    """Heartbeat watchdog. ``start()`` arms the compile grace and spawns the
    poll thread; the loop calls ``pet(step)`` at every step boundary and
    wraps slow sections in ``phase("checkpoint"|"eval"|"shutdown")``.

    All cross-thread state is plain attribute stores (atomic under the
    GIL); the poll thread tolerates reading a slightly stale pet."""

    # stamped on the evidence record and the flight-recorder dump reason;
    # EngineWatchdog (serving) overrides it so a serving stall and a
    # training hang stay distinguishable in the JSONL / report summary
    EVENT = "hang"

    def __init__(
        self,
        config: WatchdogConfig,
        flight_recorder: Any = None,
        metric_logger: Any = None,
        requeue_eligible: Optional[Callable[[], bool]] = None,
        peer_marker_root: Optional[str] = None,
        on_hang: Optional[Callable[[dict], None]] = None,
    ):
        self.config = config
        self.flight_recorder = flight_recorder
        self.metric_logger = metric_logger
        # requeue only pays off when there is a committed checkpoint to
        # resume from — the recipe wires this to the checkpointer
        self.requeue_eligible = requeue_eligible
        # shared checkpoint root: stamped with the peer-preemption
        # marker before exiting, so peers dying of the broken collectives
        # this host just abandoned requeue as collateral instead of
        # burning the launcher's backoff budget
        self.peer_marker_root = peer_marker_root
        self.on_hang = on_hang  # test seam: observe instead of exiting
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

    @contextlib.contextmanager
    def phase(self, name: str):
        """Mark a legitimately-slow section (checkpoint/eval/shutdown): the
        deadline becomes at least that phase's grace budget, and the time
        spent inside never pollutes the step-time EMA."""
        if name not in _PHASE_GRACE_FIELDS:
            raise ValueError(f"unknown watchdog phase {name!r}")
        outer, self._phase = self._phase, name
        self._last_pet = time.monotonic()  # the phase starts fresh
        try:
            yield
        finally:
            # reset the heartbeat BEFORE dropping the phase grace: the
            # other order has a window where the poll thread sees
            # age = the whole phase duration against the tight adaptive
            # deadline and kills a healthy run
            self._last_pet = time.monotonic()
            self._phase = outer
            self._skip_next_ema = True  # phase wall time is not a step time

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
        """Deadline expired: dump the evidence, then get the job recycled.
        Every step is individually best-effort — a broken disk must not
        stop the exit that frees the reservation."""
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
        if self.on_hang is not None:
            try:
                self.on_hang(rec)
            except Exception:
                pass
            return  # the observer owns what happens next
        if not self.config.exit_on_hang:
            return
        if self.peer_marker_root:
            # peers are (or will be) stuck in the collectives this host is
            # about to abandon; the marker lets their crashes requeue
            write_peer_preemption_marker(self.peer_marker_root)
        eligible = True
        if self.requeue_eligible is not None:
            try:
                eligible = bool(self.requeue_eligible())
            except Exception:
                eligible = False
        code = REQUEUE_EXIT_CODE if eligible else 1
        print(
            f"[watchdog] exiting {code} "
            + ("(requeue — committed checkpoint available)" if eligible else
               "(REAL failure — nothing committed to resume from, a requeue "
               "would hang again at zero progress)"),
            file=sys.stderr, flush=True,
        )
        # os._exit, not sys.exit: the main thread is hung — no finally
        # block or atexit hook is coming to help, and raising in THIS
        # thread would kill only the watchdog
        os._exit(code)

    def set_phase(self, name: Optional[str]) -> None:
        """Pin (or clear) the current phase outside the context-manager
        form — the serving engine holds the ``compile`` grace until its
        decode step has actually run once, which
        the training loop's second-pet rule cannot know about."""
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
    """Serving-side stall watchdog: the same adaptive-deadline EMA, phase
    grace, and evidence machinery as the training :class:`Watchdog`, with
    the lifecycle a RECOVERING consumer needs:

    - firing is an observation, not a death sentence: ``on_hang`` (required
      here — the serving scheduler's stall flag) receives the evidence and
      the watchdog KEEPS WATCHING. The engine fails the stalled wave's
      requests, rebuilds its pool/slot state, and serving continues; the
      training watchdog's requeue-exit path is wrong for a server that can
      shed one wave and keep its queue.
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
        if self.on_hang is None and self.config.exit_on_hang:
            raise ValueError(
                "EngineWatchdog needs an on_hang observer (the serving "
                "scheduler's stall flag) — it never exits the process"
            )
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
