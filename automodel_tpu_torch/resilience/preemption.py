"""Chaining signal handler for the serving drain (SIGTERM → drain), port of
``resolve_signals`` and ``PreemptionHandler`` of
``automodel_tpu/resilience/preemption.py``.

- A signal flips ``PreemptionHandler.preempted``; the owner acts at its
  next step boundary, never inside the handler.
- Handlers CHAIN: a previously installed handler still runs, and
  ``restore()`` puts the old handlers back so a server running inside a
  larger process (tests, a notebook) does not keep the signal table.
- ``REQUEUE_EXIT_CODE`` (75, BSD EX_TEMPFAIL) is the launchers' requeue
  code; a drained server under slurm/k8s exits with it.

The training side of the JAX module (the emergency checkpoint,
``TrainingPreempted`` and the peer-preemption marker) is not ported.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Callable, Optional, Sequence

logger = logging.getLogger(__name__)

# BSD sysexits EX_TEMPFAIL: the canonical "temporary failure; re-run me".
REQUEUE_EXIT_CODE = 75

DEFAULT_PREEMPTION_SIGNALS = ("SIGTERM",)

class NonFiniteError(FloatingPointError):
    """A non-finite loss or gradient the training policy does not absorb
    (``on_nonfinite: raise``, or ``rollback`` with no checkpoint or no
    budget left); JAX ``resilience/preemption.py:96``."""


def resolve_signals(names: Sequence[str | int]) -> list[signal.Signals]:
    out = []
    for n in names:
        out.append(signal.Signals(n) if isinstance(n, int) else getattr(signal, str(n)))
    return out


class PreemptionHandler:
    """Chaining signal handler that flips a flag at signal time and lets the
    owner act at the next step boundary (never from inside the handler:
    device work may be in flight)."""

    def __init__(
        self,
        signals: Sequence[str | int] = DEFAULT_PREEMPTION_SIGNALS,
        on_preempt: Optional[Callable[[], None]] = None,
        log_message: Optional[str] = None,
    ):
        self.signals = resolve_signals(signals)
        self.on_preempt = on_preempt
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
            logger.warning("received %s — %s", signal.Signals(signum).name, self.log_message)
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
