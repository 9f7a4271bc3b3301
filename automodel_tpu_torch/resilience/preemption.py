"""Preemption handling, port of ``automodel_tpu/resilience/preemption.py``:
SIGTERM → emergency checkpoint → requeue exit code.

- SIGTERM flips ``PreemptionHandler.preempted`` — distinct from the step
  scheduler's graceful ``shutdown_requested`` (a graceful stop saves on the
  normal cadence and exits 0; a preemption saves an emergency checkpoint at
  the next step boundary regardless of cadence and exits with
  ``REQUEUE_EXIT_CODE`` so the launcher requeues the job). The serving
  front reuses the handler for its drain.
- Handlers CHAIN: a previously installed handler still runs, and
  ``restore()`` puts the old handlers back so a recipe running inside a
  larger process (tests, a notebook) does not keep the signal table.
- The recipe raises ``TrainingPreempted`` after the emergency save; the CLI
  translates it to ``REQUEUE_EXIT_CODE`` (75, BSD EX_TEMPFAIL — "transient
  failure, retry").
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

logger = logging.getLogger(__name__)

# BSD sysexits EX_TEMPFAIL: the canonical "temporary failure; re-run me".
REQUEUE_EXIT_CODE = 75

DEFAULT_PREEMPTION_SIGNALS = ("SIGTERM",)

# Multi-host requeue wiring: when ONE host of a multi-host job is preempted
# it exits REQUEUE_EXIT_CODE, but its PEERS die of broken collectives with
# ordinary exit codes — indistinguishable, by exit code alone, from a real
# crash. slurm disarms that rc-masking with a marker file on the submit dir
# (launcher/slurm.py); k8s podFailurePolicy has no cross-pod state at all,
# so the marker lives on the one filesystem every host of a multi-host run
# already shares: the checkpoint root. The preempted host touches it AT
# SIGTERM TIME (before peers can possibly break — they die only after it
# stops participating in collectives, which is at exit, a grace window
# later); a peer whose training loop then crashes checks the marker's age
# and exits REQUEUE_EXIT_CODE too (cli/app.py), so every pod of a
# preemption event requeues and the launcher's backoff budget is spent on
# real crashes only. The freshness window bounds the blast radius of a
# stale marker: a genuine crash more than PEER_MARKER_MAX_AGE_S after the
# last preemption is never excused by it.
PEER_PREEMPTION_MARKER = ".preempted"
PEER_MARKER_MAX_AGE_S = 900.0


def write_peer_preemption_marker(root: Path | str) -> None:
    """Drop/refresh the shared-FS marker naming this run preempted.
    Best-effort: the marker upgrades peer exits from 'crash' to 'requeue';
    losing it costs one launcher backoff count, never correctness."""
    try:
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        (root / PEER_PREEMPTION_MARKER).touch()
    except OSError as e:
        logger.warning("could not write preemption marker under %s: %r", root, e)


def peer_preemption_fresh(
    root: Path | str, max_age_s: float = PEER_MARKER_MAX_AGE_S
) -> bool:
    """A fresh marker means a peer host was just preempted: a crash NOW is
    preemption collateral (broken collectives), not a bug. Negative ages
    pass — shared-FS clocks can sit slightly ahead of ours."""
    try:
        mtime = (Path(root) / PEER_PREEMPTION_MARKER).stat().st_mtime
    except OSError:
        return False
    return (time.time() - mtime) <= max_age_s


class TrainingPreempted(Exception):
    """Raised (after the emergency checkpoint committed) to unwind the
    recipe; the CLI maps it to REQUEUE_EXIT_CODE."""

    def __init__(self, step: int, checkpoint_dir: Optional[str] = None):
        super().__init__(
            f"preempted at step {step}"
            + (f"; emergency checkpoint: {checkpoint_dir}" if checkpoint_dir else
               "; no checkpointer configured — restart loses progress")
        )
        self.step = step
        self.checkpoint_dir = checkpoint_dir


class NonFiniteError(FloatingPointError):
    """A non-finite loss or gradient the training policy does not absorb
    (``on_nonfinite: raise``, the ``skip`` policy's consecutive budget
    blown, or ``rollback`` with no checkpoint or no budget left)."""


def resolve_signals(names: Sequence[str | int]) -> list[signal.Signals]:
    out = []
    for n in names:
        out.append(signal.Signals(n) if isinstance(n, int) else getattr(signal, str(n)))
    return out


class PreemptionHandler:
    """Chaining signal handler that flips a flag at signal time and lets the
    training loop act at the next step boundary (never from inside the
    handler — async dispatch means arbitrary device work is in flight)."""

    def __init__(
        self,
        signals: Sequence[str | int] = DEFAULT_PREEMPTION_SIGNALS,
        on_preempt: Optional[Callable[[], None]] = None,
        log_message: Optional[str] = None,
    ):
        self.signals = resolve_signals(signals)
        self.on_preempt = on_preempt
        # what receiving the signal means for THIS consumer (the scheduler
        # reuses the chaining machinery for plain graceful shutdown)
        self.log_message = log_message or (
            "emergency checkpoint at next step boundary, then exit "
            f"{REQUEUE_EXIT_CODE} (requeue)"
        )
        self._preempted = threading.Event()
        self._prior: dict[signal.Signals, object] = {}
        self._installed = False

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def _handle(self, signum, frame) -> None:
        first = not self._preempted.is_set()
        self._preempted.set()
        if first:
            logger.warning(
                "received %s — %s", signal.Signals(signum).name, self.log_message
            )
            if self.on_preempt is not None:
                self.on_preempt()
        prior = self._prior.get(signal.Signals(signum))
        if callable(prior) and prior not in (signal.SIG_IGN, signal.SIG_DFL):
            prior(signum, frame)

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for sig in self.signals:
            self._prior[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def restore(self) -> None:
        if not self._installed:
            return
        for sig, prior in self._prior.items():
            # only restore if we are still the installed handler — don't
            # clobber something installed on top of us since
            if signal.getsignal(sig) == self._handle:
                signal.signal(sig, prior)
        self._prior.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()
