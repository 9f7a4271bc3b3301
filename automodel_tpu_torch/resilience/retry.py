"""Retrying I/O: bounded exponential backoff with jitter.

Port of ``retry_io`` of ``automodel_tpu/resilience/retry.py``, which the
checkpoint modules use at every storage touchpoint (safetensors reads and
writes, the DCP state save and load, the manifest commit). Only typed
retryable exceptions are absorbed (the ``OSError`` family by default): a
``ValueError`` from a corrupt header is corruption or a bug and propagates
at once. The fault injector's ``fail_io_attempts`` fails the first attempts
of a matching op here (resilience/fault_injection.py).
"""

from __future__ import annotations

import functools
import logging
import random
import time
from typing import Any, Callable, Iterable, Optional, Type

logger = logging.getLogger(__name__)

DEFAULT_RETRYABLE: tuple[Type[BaseException], ...] = (OSError,)


class RetriesExhausted(Exception):
    """All attempts failed; ``__cause__`` is the last underlying error."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        super().__init__(f"{op}: {attempts} attempt(s) failed; last error: {last!r}")
        self.op = op
        self.attempts = attempts
        self.last = last


def backoff_delays(
    max_attempts: int,
    base_delay_s: float,
    max_delay_s: float,
    jitter: float,
    rng: Optional[random.Random] = None,
) -> Iterable[float]:
    """The sleeps between attempts (``max_attempts - 1`` of them): base *
    2^i capped at ``max_delay_s``, each scaled by a uniform [1 - jitter, 1 +
    jitter] factor."""
    rng = rng or random
    for i in range(max(max_attempts - 1, 0)):
        d = min(base_delay_s * (2.0**i), max_delay_s)
        if jitter > 0:
            d *= rng.uniform(1.0 - jitter, 1.0 + jitter)
        yield max(d, 0.0)


def retry_io(
    op: Optional[str] = None,
    max_attempts: int = 3,
    base_delay_s: float = 0.5,
    max_delay_s: float = 8.0,
    jitter: float = 0.25,
    retryable: tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE,
    sleep: Callable[[float], None] = time.sleep,
) -> Callable:
    """Decorator (or ``retry_io(...)(fn)``) retrying transient I/O failures.
    After ``max_attempts`` failures the last error is raised, chained under
    ``RetriesExhausted``. ``sleep`` is injectable for tests."""

    def decorate(fn: Callable) -> Callable:
        name = op or getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            from automodel_tpu_torch.resilience.fault_injection import active_injector

            delays = list(backoff_delays(max_attempts, base_delay_s, max_delay_s, jitter))
            last: Optional[BaseException] = None
            for attempt in range(max_attempts):
                try:
                    inj = active_injector()
                    if inj is not None:
                        inj.check_io(name)
                    return fn(*args, **kwargs)
                except retryable as e:
                    last = e
                    if attempt == max_attempts - 1:
                        break
                    d = delays[attempt]
                    logger.warning(
                        "%s: attempt %d/%d failed (%r); retrying in %.2fs",
                        name, attempt + 1, max_attempts, e, d,
                    )
                    sleep(d)
            raise RetriesExhausted(name, max_attempts, last) from last

        wrapped.__wrapped__ = fn
        return wrapped

    return decorate
