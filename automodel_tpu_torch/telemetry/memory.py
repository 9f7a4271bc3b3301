"""Device-memory telemetry: allocator counters and a live-tensor census.

Port of ``automodel_tpu/telemetry/memory.py`` with the same keys. The
allocator counters come from torch's CUDA caching allocator:

- ``bytes_in_use``: ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``;
- ``peak_bytes_in_use``: ``memory_stats()["allocated_bytes.all.peak"]``
  (since the process started or ``torch.cuda.reset_peak_memory_stats``);
- ``largest_alloc_size``: the largest block in use, from
  ``torch.cuda.memory_snapshot()`` (blocks in state ``active_allocated``);
- ``bytes_limit``: the card's total memory, ``torch.cuda.mem_get_info()[1]``;
- ``num_allocs``: ``memory_stats()["allocation.all.allocated"]``, the
  allocations made so far.

A CPU device has no allocator counters and gets ``{}``, as JAX's CPU
devices do. The census groups the live tensors on the device, found by
walking ``gc.get_objects()``, by (dtype, shape); a view is counted with
the tensor it views, not again.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Optional

import torch

# the allocator counters forwarded, as JAX's memory_stats() names them
_STAT_KEYS = (
    "bytes_in_use",
    "peak_bytes_in_use",
    "largest_alloc_size",
    "bytes_limit",
    "num_allocs",
)


def _devices(device: Any) -> list[torch.device]:
    """The devices a reading covers: the given one, else every CUDA device
    (the CPU when there is none)."""
    if device is not None:
        return [torch.device(device)]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _key(dev: torch.device) -> str:
    return "cpu" if dev.type == "cpu" else str(dev.index if dev.index is not None else torch.cuda.current_device())


def _cuda_stats(dev: torch.device) -> dict[str, int]:
    stats = torch.cuda.memory_stats(dev)
    index = int(_key(dev))
    largest = 0
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device") != index:
            continue
        for blk in seg.get("blocks", ()):
            if blk.get("state") == "active_allocated":
                largest = max(largest, int(blk.get("size", 0)))
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "largest_alloc_size": largest,
        "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
        "num_allocs": int(stats.get("allocation.all.allocated", 0)),
    }


def device_memory_stats(device: Any = None) -> dict[str, dict[str, int]]:
    """Allocator counters keyed by device index (as a string, so the dict
    JSON-serialises; ``"cpu"`` for the CPU, whose entry is empty)."""
    return {_key(d): (_cuda_stats(d) if d.type == "cuda" else {}) for d in _devices(device)}


def _same_device(t: torch.Tensor, devs: list[torch.device]) -> bool:
    d = t.device
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    for want in devs:
        if want.type == d.type and (want.type == "cpu" or want.index in (None, d.index)):
            return True
    return False


def live_array_census(top_k: int = 8, device: Any = None) -> dict[str, Any]:
    """Group the live tensors on the device(s) by (dtype, shape): the top-K
    groups by total bytes plus an ``other_bytes`` remainder. A view (a
    tensor with a ``_base``) is skipped: its bytes belong to its base."""
    devs = _devices(device)
    groups: dict[tuple[str, tuple], dict[str, int]] = {}
    n_arrays = 0
    total = 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: isinstance reads __class__, which some
            # module proxies answer with a deprecation warning
            if not issubclass(type(obj), torch.Tensor) or obj._base is not None or obj.is_meta:
                continue
            if not _same_device(obj, devs):
                continue
            key = (str(obj.dtype).replace("torch.", ""), tuple(int(s) for s in obj.shape))
            nbytes = int(obj.numel() * obj.element_size())
        except Exception:
            continue  # freed or otherwise unreadable between listing and reading
        n_arrays += 1
        total += nbytes
        g = groups.setdefault(key, {"count": 0, "bytes": 0})
        g["count"] += 1
        g["bytes"] += nbytes
    ranked = sorted(groups.items(), key=lambda kv: kv[1]["bytes"], reverse=True)
    top = [
        {"dtype": k[0], "shape": list(k[1]), "count": g["count"], "bytes": g["bytes"]}
        for k, g in ranked[:top_k]
    ]
    return {
        "n_arrays": n_arrays,
        "total_bytes": total,
        "top": top,
        "other_bytes": total - sum(e["bytes"] for e in top),
    }


def memory_snapshot(top_k: int = 8, device: Any = None) -> dict[str, Any]:
    """Allocator counters, the census and a timestamp in one record."""
    return {
        "ts": time.time(),
        "devices": device_memory_stats(device),
        "census": live_array_census(top_k, device),
    }


def max_bytes_in_use(device: Optional[Any] = None) -> tuple[int, int]:
    """(max bytes_in_use, max peak_bytes_in_use) over the devices; the
    census total where there are no allocator counters (the CPU)."""
    stats = device_memory_stats(device)
    in_use = [s["bytes_in_use"] for s in stats.values() if "bytes_in_use" in s]
    peak = [s["peak_bytes_in_use"] for s in stats.values() if "peak_bytes_in_use" in s]
    if not in_use:
        total = live_array_census(top_k=0, device=device)["total_bytes"]
        return total, total
    return max(in_use), max(peak) if peak else max(in_use)
