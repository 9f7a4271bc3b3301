"""JSONL metric logging, port of ``MetricLogger`` (:136) of
``automodel_tpu/loggers/metric_logger.py``.

Strict JSON: a non-finite float is written as ``null`` with a sidecar
``<key>_nonfinite: true`` (element-wise for lists), and the write uses
``allow_nan=False``, so a diverged run still leaves a parseable file.
Under a process group only rank 0 writes. Each
record gets a ``ts``, and the ``envelope`` keys (the goodput ledger's
``attempt_id`` / ``restart_count``) are stamped on every record so a
requeued run's appended records stay joinable per attempt; a caller's
explicit key wins. Appends hold an ``flock`` (``_append_line``), so the
goodput ledger and a second process may share a file. The JAX logger's
wandb/MLflow sinks and its retried append are not ported."""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Optional

try:
    import fcntl
except ImportError:  # non-POSIX: appends go unlocked
    fcntl = None


def _to_scalar(v: Any) -> Any:
    if hasattr(v, "tolist"):  # tensors and numpy values
        return v.tolist()
    return v


def _definite(v: Any) -> tuple[Any, bool]:
    """→ (strict-JSON-safe value, had a non-finite float)."""
    if isinstance(v, float):
        return (v, False) if math.isfinite(v) else (None, True)
    if isinstance(v, (list, tuple)):
        pairs = [_definite(x) for x in v]
        return [p[0] for p in pairs], any(p[1] for p in pairs)
    if isinstance(v, dict):
        pairs = {k: _definite(x) for k, x in v.items()}
        return {k: p[0] for k, p in pairs.items()}, any(p[1] for p in pairs.values())
    return v, False


def _append_line(path: Path | str, line: str) -> None:
    """Append one line under an exclusive ``flock`` (whole records never
    interleave between writers on one host)."""
    with open(path, "a") as f:
        if fcntl is not None:
            try:
                fcntl.flock(f, fcntl.LOCK_EX)
            except OSError:
                pass
        f.write(line)


class MetricLogger:
    """Append-only JSONL metrics file; one record per ``log`` call."""

    def __init__(self, path: str, envelope: Optional[dict[str, Any]] = None):
        self.path = Path(path)
        # under a process group one writer, rank 0: the others' records are its
        from automodel_tpu_torch.resilience.timed_sync import world

        self.writer = world()[0] == 0
        if self.writer:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.touch()  # the file exists even before the first record
        self.envelope = dict(envelope or {})

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        if not self.writer:
            return
        rec: dict[str, Any] = {}
        for k, v in metrics.items():
            cv, bad = _definite(_to_scalar(v))
            rec[k] = cv
            if bad:
                rec[f"{k}_nonfinite"] = True
        if step is not None:
            rec.setdefault("step", step)
        for k, v in self.envelope.items():
            rec.setdefault(k, v)
        rec.setdefault("ts", time.time())
        _append_line(self.path, json.dumps(rec, allow_nan=False) + "\n")
