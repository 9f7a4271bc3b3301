"""Flight recorder: a ring of the last-N records and a run fingerprint,
dumped to JSON on demand (the serving watchdog's stall evidence) or when
the guarded loop dies. Port of ``FlightRecorder`` and
``build_fingerprint`` of ``automodel_tpu/telemetry/flight_recorder.py``.

The dump bundles (a) the last N host-side records, (b) a config/device/env
fingerprint so the run is reproducible, and (c) a memory snapshot taken at
dump time (telemetry/memory.py: allocator counters and a census of the
live tensors), which names the buffers that filled the card after an
out-of-memory error. Nothing here synchronises the device.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
import traceback
from collections import deque
from pathlib import Path
from typing import Any, Optional

from automodel_tpu_torch.telemetry import memory as mem_telemetry

# env vars worth fingerprinting: device selection and allocator tuning.
# True = record the VALUE; False = record only that it is set
_ENV_KEYS = {
    "CUDA_VISIBLE_DEVICES": True,
    "PYTORCH_CUDA_ALLOC_CONF": True,
    "CUDA_LAUNCH_BLOCKING": True,
    "NCCL_DEBUG": True,
}

# the dump is an artifact people attach to bug reports: mask config values
# whose key looks credential-shaped (wandb api keys, dataset auth tokens, …)
_SECRET_KEY_RE = re.compile(
    r"(?i)(token|secret|password|passwd|credential|api_?key|access_key|auth)"
)


def _redact(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {
            k: (
                "<redacted>"
                if isinstance(k, str) and _SECRET_KEY_RE.search(k)
                else _redact(v)
            )
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [_redact(x) for x in obj]
    return obj


def build_fingerprint(config: Optional[dict] = None, mesh_ctx: Any = None) -> dict[str, Any]:
    """Config/device/env fingerprint stamped into every dump; ``mesh`` is
    the degrees of a ``parallel.MeshContext`` (None without one)."""
    import torch

    try:
        if torch.cuda.is_available():
            device = {
                "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            }
        else:
            device = {"platform": "cpu", "device_kind": "cpu", "count": 1}
    except Exception as e:  # device init can itself be the failure
        device = {"error": repr(e)}
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": device,
        "mesh": dict(mesh_ctx.shape) if mesh_ctx is not None else None,
        "env": {
            k: (os.environ[k] if keep_value else "<set>")
            for k, keep_value in _ENV_KEYS.items()
            if k in os.environ
        },
        "config": _redact(config) if config is not None else None,
    }


def _jsonable(v: Any) -> Any:
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:
            pass
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if v == v and v not in (float("inf"), float("-inf")) else None
    return str(v)


class FlightRecorder:
    """Bounded ring of step records; dumps on exception (context manager)
    or on demand (`dump`). Recording is a deque append of already-host-side
    values — it must never force a device sync, so callers only pass
    host-known fields (step number, wall times, fetched metrics)."""

    def __init__(
        self,
        capacity: int = 16,
        path: str = "flight_recorder.json",
        fingerprint: Optional[dict] = None,
        census_top_k: int = 8,
    ):
        self.capacity = capacity
        self.path = Path(path)
        self.fingerprint = fingerprint or {}
        self.census_top_k = census_top_k
        self._ring: deque = deque(maxlen=max(capacity, 1))

    def record(self, rec: dict[str, Any]) -> None:
        self._ring.append(_jsonable(rec))

    @property
    def records(self) -> list[dict]:
        return list(self._ring)

    def dump(self, reason: str = "exception", exc: Optional[BaseException] = None) -> Path:
        try:
            snapshot = mem_telemetry.memory_snapshot(self.census_top_k)
        except Exception as e:  # never let the dump re-crash the crash path
            snapshot = {"error": repr(e)}
        payload = {
            "reason": reason,
            "ts": time.time(),
            "exception": (
                {
                    "type": type(exc).__name__,
                    "message": str(exc),
                    "traceback": "".join(
                        traceback.format_exception(type(exc), exc, exc.__traceback__)
                    ),
                }
                if exc is not None
                else None
            ),
            "fingerprint": _jsonable(self.fingerprint),
            "records": self.records,
            "memory": _jsonable(snapshot),
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return self.path

    # -- context manager: dump on any exception, then re-raise --------------
    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            try:
                path = self.dump(reason=exc_type.__name__, exc=exc)
                print(
                    f"[telemetry] flight recorder dumped to {path} "
                    f"({len(self._ring)} step records + memory census)",
                    file=sys.stderr,
                    flush=True,
                )
            except Exception:
                pass
        return False  # never swallow
