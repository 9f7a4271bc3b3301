"""Timed collectives, port of ``automodel_tpu/resilience/timed_sync.py``:
a dead peer becomes a diagnosed timeout, not a hang.

A multi-process run has host-side sync points where every process must
show up — checkpoint commit, emergency save, shutdown — and when one
process died the others block inside the collective forever. The wrappers
here run the blocking call on a helper thread and bound the wait: on
expiry they raise :class:`SyncTimeout` naming the sync point.

The helper thread cannot be cancelled — a timed-out collective leaks its
thread. Every caller is on a failure path that ends in process exit, and a
leaked daemon thread dies with the process.

The gather is ``torch.distributed.all_gather`` of a small float64 vector
when a process group is initialised; a single process (no group, or a
world of one) short-circuits before any thread is spawned.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_SYNC_TIMEOUT_S = 600.0


class SyncTimeout(RuntimeError):
    """A cross-host sync point did not complete within its deadline —
    almost always a dead or wedged peer. The message names the sync point
    so the operator (and the flight recorder) knows WHERE the world hung."""

    def __init__(self, name: str, timeout_s: float, detail: str = ""):
        super().__init__(
            f"cross-host sync point {name!r} timed out after {timeout_s:.0f}s"
            + (f" — {detail}" if detail else "")
            + "; a peer host is likely dead or wedged (check per-host logs / "
            "the flight recorder of the host that stopped heartbeating)"
        )
        self.name = name
        self.timeout_s = timeout_s


def timed_call(
    fn: Callable[[], Any],
    *,
    name: str,
    timeout_s: float = DEFAULT_SYNC_TIMEOUT_S,
) -> Any:
    """Run a blocking (collective) call with a wall-clock bound. Returns the
    call's result, re-raises its exception, or raises :class:`SyncTimeout`.

    The call runs on a daemon thread so a timeout leaves the main thread in
    control; the abandoned thread is reaped at process exit (see module
    docstring for why that is acceptable)."""
    result: list = []
    error: list = []

    def _run() -> None:
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            error.append(e)

    t = threading.Thread(target=_run, name=f"timed-{name}", daemon=True)
    start = time.monotonic()
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise SyncTimeout(
            name, timeout_s,
            detail=f"still blocked after {time.monotonic() - start:.0f}s",
        )
    if error:
        raise error[0]
    return result[0] if result else None


def world() -> tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed`` group,
    else (0, 1)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:
        pass
    return 0, 1


def _default_gather(vec: np.ndarray) -> np.ndarray:
    """all_gather a small host-side vector → [world size, len(vec)]."""
    _, n = world()
    if n == 1:
        return np.asarray(vec)[None, :]
    import torch
    import torch.distributed as dist

    t = torch.as_tensor(np.asarray(vec, dtype=np.float64))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def barrier_with_timeout(
    name: str,
    timeout_s: float = DEFAULT_SYNC_TIMEOUT_S,
    gather_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> int:
    """Host barrier with a deadline: every process contributes its rank and
    waits for the rest; a missing peer raises :class:`SyncTimeout` instead
    of blocking forever. Returns the number of processes seen.
    Single-process: returns 1 with zero work — no thread, no collective."""
    rank, n = world()
    if gather_fn is None and n == 1:
        return 1
    gather = gather_fn or _default_gather
    vec = np.asarray([rank], dtype=np.float64)
    out = timed_call(lambda: gather(vec), name=name, timeout_s=timeout_s)
    n = int(np.asarray(out).shape[0])
    logger.debug("barrier %s: %d host(s)", name, n)
    return n


def slowest_host(step_times_s: Sequence[float]) -> tuple[int, float]:
    """Straggler attribution over a per-host step-time vector (one allgather
    row per host): → (slowest host index, max/median ratio). A ratio near
    1.0 means the pod is balanced; MegaScale-style monitoring flags a host
    whose ratio stays above ~1.2–2× as the straggler dragging every peer
    (in synchronous data parallelism every rank waits for the slowest)."""
    arr = np.asarray(step_times_s, dtype=np.float64)
    if arr.size == 0:
        return 0, 1.0
    worst = int(np.argmax(arr))
    med = float(np.median(arr))
    ratio = float(arr[worst] / med) if med > 0 else 1.0
    return worst, ratio
