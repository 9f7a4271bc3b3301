"""The percentile every quantile consumer shares, a copy of ``percentile``
(``automodel_tpu/telemetry/report.py:26-40``); the rest of the report
linter is not ported yet."""

from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy's default method), so a
    p50/p99 means the same thing in every consumer. ``q`` in [0, 1]; →
    None on an empty input."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    if not (0.0 <= q <= 1.0):
        raise ValueError(f"percentile q={q} (want 0..1)")
    pos = q * (len(vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac
