"""Cross-host desync detection, port of
``automodel_tpu/resilience/consensus.py``: agree, or abort naming the
culprit.

At log/checkpoint boundaries every process contributes a tiny fingerprint
vector to an all-gather and a plurality rule names any process that
disagrees. The fingerprint (one float64 per component):

- ``step``    — the optimizer step this process believes it is on
- ``config``  — CRC of the run's config/device fingerprint, computed once
- ``data``    — a rolling CRC folded from every batch's ``input_ids`` bytes
  (host-side numpy the loop already holds)
- ``params``  — a global parameter checksum (fp32 sum of squares over the
  parameters); replicas must agree bit for bit

Checks run only at boundaries that already synchronise with the device
(the log record, the pre-commit point of a checkpoint save), never on the
step's hot path. On disagreement the guard raises :class:`DesyncError`
naming the offending process(es) and component before a desynced
checkpoint can commit.

The gather is ``torch.distributed.all_gather`` (timed_sync.py). A single
process short-circuits to a no-op — unless the fault injector's
``desync_batch_at_step`` is armed, in which case the guard simulates two
healthy peers beside the perturbed local fingerprint, so the detection and
attribution path runs in one process.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import zlib
from typing import Any, Callable, Optional

import numpy as np

from automodel_tpu_torch.resilience.fault_injection import active_injector
from automodel_tpu_torch.resilience.timed_sync import _default_gather, slowest_host, timed_call, world

logger = logging.getLogger(__name__)

# fingerprint vector layout: name → column. Columns in _COMPARED must agree
# across hosts; STEP_TIME rides the same allgather but feeds straggler
# attribution instead (hosts legitimately differ there).
COLUMNS = ("step", "config", "data", "params", "step_time")
_COMPARED = ("step", "config", "data", "params")
STEP_TIME_COL = COLUMNS.index("step_time")


def _fmt(v: float) -> str:
    """Exact rendering for the integral components (steps, CRCs — two
    different 32-bit hashes must never print identically); %.6g only for
    genuinely fractional values (the param checksum)."""
    return str(int(v)) if float(v).is_integer() else f"{v:.6g}"


class DesyncError(RuntimeError):
    """Cross-host fingerprint disagreement. ``hosts`` are the offending
    process indices (minority vs the majority value per component)."""

    def __init__(self, step: int, where: str, findings: list[dict]):
        self.step = step
        self.where = where
        self.findings = findings
        self.hosts = sorted({f["host"] for f in findings})
        lines = [
            f"host {f['host']}: {f['component']}={_fmt(f['value'])} "
            f"(majority={_fmt(f['majority'])})"
            for f in findings
        ]
        super().__init__(
            f"cross-host desync detected at step {step} ({where}): "
            + "; ".join(lines)
            + " — aborting before a desynced checkpoint can commit"
        )


def config_crc(fingerprint: Optional[dict]) -> int:
    """Stable CRC of the run fingerprint (config + mesh + env), computed
    once at setup. Canonical JSON so dict ordering can't desync the CRC
    itself."""
    try:
        blob = json.dumps(fingerprint or {}, sort_keys=True, default=str)
    except Exception:
        blob = str(fingerprint)
    return zlib.crc32(blob.encode())


def fold_array_crc(h: int, arr: Any) -> int:
    """Fold one host-side array into a rolling CRC. ``np.ascontiguousarray``
    because tobytes on a non-contiguous view would copy anyway."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.tobytes(), h & 0xFFFFFFFF)


def find_divergent(matrix: np.ndarray) -> list[dict]:
    """Plurality rule over the compared fingerprint columns of an
    allgathered ``[num_hosts, len(COLUMNS)]`` matrix → findings naming each
    host whose value differs from its column's UNIQUE most-common value —
    even a 2-of-4 plurality attributes correctly when the two divergers
    disagree with each other too. Only when the top count is tied (or
    every host differs) are ALL hosts reported: the pod has shattered and
    the operator needs the full picture, not a coin flip."""
    m = np.asarray(matrix, dtype=np.float64)
    findings: list[dict] = []
    for name in _COMPARED:
        col = m[:, COLUMNS.index(name)]
        values, counts = np.unique(col, return_counts=True)
        if len(values) <= 1:
            continue
        top = counts.max()
        if top > 1 and int((counts == top).sum()) == 1:
            majority = float(values[np.argmax(counts)])
            offenders = np.nonzero(col != majority)[0]
        else:
            majority = float(np.median(col))
            offenders = np.arange(len(col))
        for h in offenders:
            findings.append({
                "host": int(h),
                "component": name,
                "value": float(col[h]),
                "majority": majority,
            })
    return findings


@dataclasses.dataclass
class ConsensusConfig:
    enabled: bool = True
    data_hash: bool = True
    param_checksum: bool = True
    # deadline for the consensus allgather itself: a peer that died right
    # before the boundary must surface as a diagnosed SyncTimeout here, not
    # an infinite wait inside the check that exists to catch it
    timeout_s: float = 300.0


class ConsensusGuard:
    def __init__(
        self,
        config: ConsensusConfig,
        fingerprint: Optional[dict] = None,
        gather_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        event_hook: Optional[Callable[[dict], None]] = None,
    ):
        self.config = config
        self.config_crc = config_crc(fingerprint)
        # test/multi-process seam: None → torch.distributed all_gather (timed_sync)
        self._gather = gather_fn
        self.event_hook = event_hook
        self._data_hash = 0
        # the unperturbed shadow of _data_hash: identical unless the fault
        # injector desynced us, and the basis of the simulated healthy
        # peers in single-process injection runs
        self._clean_hash = 0
        self._param_fn = None
        self.checks = 0

    # -- hot path (host-side, off the device) --------------------------------
    def active(self) -> bool:
        """Whether per-step folding buys anything: multi-host, a test
        gather seam, or an armed desync injection."""
        if not self.config.enabled:
            return False
        if self._gather is not None:
            return True
        inj = active_injector()
        if inj is not None and inj.config.desync_batch_at_step is not None:
            return True
        return world()[1] > 1

    def fold_batch(self, step: int, stacked: dict[str, Any]) -> None:
        """Fold this step's batch into the rolling data hash (host-side
        numpy, already materialized by the loop). The injector's
        ``desync_batch_at_step`` perturbs the REPORTED hash only — the
        clean shadow keeps tracking what a healthy host would report."""
        if not (self.config.enabled and self.config.data_hash):
            return
        for k in sorted(stacked):
            if k.endswith("input_ids"):
                self._clean_hash = fold_array_crc(self._clean_hash, stacked[k])
        self._data_hash = self._clean_hash
        inj = active_injector()
        if inj is not None and inj.should_desync(step):
            self._data_hash = zlib.crc32(b"desync", self._clean_hash)
            logger.error(
                "fault injection: desynced data hash at step %d", step
            )

    def install_param_checksum(self, params_example: Any) -> None:
        """Arm the global parameter checksum (fp32 sum of squares over the
        floating-point parameters, one device reduction read at a
        boundary). ``params_example`` is unused: the checksum reads the
        parameters the boundary passes."""
        if not (self.config.enabled and self.config.param_checksum):
            return
        self._param_fn = param_checksum

    # -- boundary check ------------------------------------------------------
    def fingerprint_vector(
        self, step: int, params: Any = None, step_time_s: float = 0.0
    ) -> np.ndarray:
        param_ck = 0.0
        if self._param_fn is not None and params is not None:
            param_ck = float(self._param_fn(params))
        return np.array(
            [float(step), float(self.config_crc), float(self._data_hash),
             param_ck, float(step_time_s)],
            dtype=np.float64,
        )

    def check(
        self,
        step: int,
        params: Any = None,
        step_time_s: float = 0.0,
        where: str = "log",
    ) -> dict[str, Any]:
        """Gather fingerprints and enforce agreement. Returns straggler/
        liveness metrics for the log record; raises :class:`DesyncError`
        when any host diverges. Call ONLY at host-synchronous boundaries
        (log barrier, pre-commit, shutdown)."""
        if not self.active():
            return {}
        vec = self.fingerprint_vector(step, params=params, step_time_s=step_time_s)
        matrix = self._gather_matrix(vec, where)
        self.checks += 1
        if matrix.shape[0] <= 1:
            return {}
        findings = find_divergent(matrix)
        if findings:
            rec = {
                "event": "desync",
                "step": step,
                "where": where,
                "desync_hosts": sorted({f["host"] for f in findings}),
                "findings": findings,
            }
            if self.event_hook is not None:
                try:
                    self.event_hook(rec)
                except Exception:
                    pass
            raise DesyncError(step, where, findings)
        times = matrix[:, STEP_TIME_COL]
        worst, ratio = slowest_host(times)
        return {
            "slowest_host": worst,
            "host_step_time_max_s": float(times[worst]),
            "host_step_time_median_s": float(np.median(times)),
            "straggler_ratio": round(ratio, 4),
        }

    def _gather_matrix(self, vec: np.ndarray, where: str) -> np.ndarray:
        if self._gather is not None:
            return np.asarray(self._gather(vec), dtype=np.float64)
        if world()[1] == 1:
            inj = active_injector()
            if (
                inj is not None
                and inj.config.desync_batch_at_step is not None
                and self._data_hash != self._clean_hash
            ):
                # injection-driven single-process mode: simulate two healthy
                # peers reporting the clean shadow so the plurality rule
                # localizes THIS process — the same arithmetic a real
                # 3-process gather would produce
                clean = vec.copy()
                clean[COLUMNS.index("data")] = float(self._clean_hash)
                return np.stack([clean, clean, vec])
            return vec[None, :]
        return np.asarray(timed_call(
            lambda: _default_gather(vec),
            name=f"consensus_{where}",
            timeout_s=self.config.timeout_s,
        ), dtype=np.float64)


def param_checksum(params: Any) -> float:
    """fp32 sum of squares over the floating-point tensors of ``params``
    (a list of tensors, or a module's parameters), as one host float. A
    sharded tensor (DTensor) counts whole: its shards' sums are summed over
    the ranks holding them, so every rank of a mesh reports the same."""
    import torch

    from automodel_tpu_torch.parallel.plans import global_sums, is_sharded, local

    leaves = params.parameters() if hasattr(params, "parameters") else params
    total = None
    sharded, sums = [], []
    with torch.no_grad():
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                s = local(x).float().square().sum()
                if is_sharded(x):
                    sharded.append(x)
                    sums.append(s)
                    continue
                total = s if total is None else total + s
        if sharded:
            s = global_sums(sharded, sums).sum()
            total = s if total is None else total + s
    return float(total) if total is not None else 0.0
