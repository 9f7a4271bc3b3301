"""JSONL metric logging, port of ``MetricLogger`` (:136) of
``automodel_tpu/loggers/metric_logger.py``.

Strict JSON: a non-finite float is written as ``null`` with a sidecar
``<key>_nonfinite: true`` (element-wise for lists), and the write uses
``allow_nan=False``, so a diverged run still leaves a parseable file. Each
record gets a ``ts``. The JAX logger's wandb/MLflow sinks and its retried,
multi-writer-safe append are not ported: one process appends."""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any


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


class MetricLogger:
    """Append-only JSONL metrics file; one record per ``log`` call."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.touch()  # the file exists even before the first record

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        rec: dict[str, Any] = {}
        for k, v in metrics.items():
            cv, bad = _definite(_to_scalar(v))
            rec[k] = cv
            if bad:
                rec[f"{k}_nonfinite"] = True
        if step is not None:
            rec.setdefault("step", step)
        rec.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, allow_nan=False) + "\n")
