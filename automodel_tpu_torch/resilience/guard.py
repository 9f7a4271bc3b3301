"""Distributed guard facade, port of ``automodel_tpu/resilience/guard.py``:
the one object the recipes drive.

Bundles the three distributed-guard pillars (watchdog.py, consensus.py,
timed_sync.py) behind the same from_config/lifecycle shape as Telemetry
and Resilience, so every recipe subclass inherits the wiring from
train_ft's loop:

- ``on_step(step, stacked)``   — heartbeat pet + data-hash fold, every step
  (host-side only)
- ``on_log(step, ...)``        — consensus check + straggler attribution +
  ``heartbeat_age_s`` folded into the log record
- ``pre_commit(step, params)`` — consensus at the checkpoint pre-commit
  point: a desynced checkpoint never commits
- ``barrier(name)``            — timed barrier at the commit/emergency/
  shutdown sync points (a dead peer → diagnosed SyncTimeout)
- ``phase(name)``              — watchdog grace for checkpoint/eval/shutdown

YAML::

    distributed_guard:
      enabled: true
      sync_timeout_s: 600          # commit/shutdown barrier deadline
      watchdog:
        multiplier: 12.0           # deadline = EMA step time x this
        min_deadline_s: 120
        compile_grace_s: 1800
        checkpoint_grace_s: 900
        eval_grace_s: 900
      consensus:
        data_hash: true            # rolling per-process batch hash
        param_checksum: true       # global param checksum
        timeout_s: 300

Defaults are on: a YAML with no ``distributed_guard:`` section still gets
the watchdog and (on multi-process runs) the consensus checks. Unknown keys
raise ``TypeError`` as the dataclasses do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any, Callable, Optional

from automodel_tpu_torch.resilience.consensus import ConsensusConfig, ConsensusGuard
from automodel_tpu_torch.resilience.timed_sync import barrier_with_timeout
from automodel_tpu_torch.resilience.watchdog import Watchdog, WatchdogConfig

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DistributedGuardConfig:
    enabled: bool = True
    sync_timeout_s: float = 600.0
    watchdog: Optional[dict] = None
    consensus: Optional[dict] = None


def _sub(section: Optional[dict]) -> dict:
    d = dict(section or {})
    d.pop("_target_", None)
    return d


class DistributedGuard:
    def __init__(
        self,
        config: DistributedGuardConfig,
        fingerprint: Optional[dict] = None,
        flight_recorder: Any = None,
        metric_logger: Any = None,
        default_stacks_path: Optional[str] = None,
    ):
        self.config = config
        wd_cfg = WatchdogConfig(**_sub(config.watchdog))
        if wd_cfg.stacks_path is None and default_stacks_path:
            wd_cfg.stacks_path = default_stacks_path
        on = config.enabled
        self.watchdog: Optional[Watchdog] = (
            Watchdog(
                wd_cfg,
                flight_recorder=flight_recorder,
                metric_logger=metric_logger,
            )
            if on and wd_cfg.enabled
            else None
        )
        cs_cfg = ConsensusConfig(**_sub(config.consensus))
        self.consensus: Optional[ConsensusGuard] = (
            ConsensusGuard(cs_cfg, fingerprint=fingerprint)
            if on and cs_cfg.enabled
            else None
        )

    @classmethod
    def from_config(
        cls,
        section: Any,
        fingerprint: Optional[dict] = None,
        flight_recorder: Any = None,
        metric_logger: Any = None,
        default_stacks_path: Optional[str] = None,
    ) -> "DistributedGuard":
        d = _sub(section)
        return cls(
            DistributedGuardConfig(**d),
            fingerprint=fingerprint,
            flight_recorder=flight_recorder,
            metric_logger=metric_logger,
            default_stacks_path=default_stacks_path,
        )

    # -- late binding (the checkpointer is built after the guard) ------------
    def bind_runtime(
        self,
        requeue_eligible: Optional[Callable[[], bool]] = None,
        peer_marker_root: Optional[str] = None,
        event_hook: Optional[Callable[[dict], None]] = None,
        params_example: Any = None,
    ) -> None:
        if self.watchdog is not None:
            if requeue_eligible is not None:
                self.watchdog.requeue_eligible = requeue_eligible
            if peer_marker_root is not None:
                self.watchdog.peer_marker_root = peer_marker_root
        if self.consensus is not None:
            if event_hook is not None:
                self.consensus.event_hook = event_hook
            if params_example is not None and self.consensus.active():
                self.consensus.install_param_checksum(params_example)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DistributedGuard":
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()

    # -- loop hooks ----------------------------------------------------------
    def on_step(self, step: int, stacked: Optional[dict] = None) -> None:
        """Every optimizer step: pet the heartbeat, fold the batch hash.
        Host-side attribute stores + (when consensus is live) one crc32
        over already-materialized numpy — nothing on the device."""
        if self.watchdog is not None:
            self.watchdog.pet(step)
        if (
            self.consensus is not None
            and stacked is not None
            and self.consensus.active()
        ):
            self.consensus.fold_batch(step, stacked)

    def on_log(
        self, step: int, metrics: dict, params: Any = None
    ) -> dict:
        """Log-boundary hook (the loop is already at a device barrier):
        liveness + consensus + straggler metrics folded into the record."""
        if self.watchdog is not None:
            metrics["heartbeat_age_s"] = round(self.watchdog.heartbeat_age_s, 4)
        if self.consensus is not None:
            ema = (
                self.watchdog.ema_step_time_s
                if self.watchdog is not None
                else None
            )
            metrics.update(
                self.consensus.check(
                    step, params=params, step_time_s=ema or 0.0, where="log"
                )
            )
        return metrics

    def pre_commit(self, step: int, params: Any = None) -> None:
        """The checkpoint pre-commit resolution point (same boundary where
        the non-finite policy resolves its pending flag): every host must
        agree on (step, config, data order, params) BEFORE the manifest
        commits, or the checkpoint tree inherits the desync."""
        if self.consensus is not None:
            self.consensus.check(step, params=params, where="checkpoint")

    def barrier(self, name: str) -> None:
        """Timed host barrier for the init/emergency-save/shutdown sync
        points. Single-process: free."""
        if self.config.enabled:
            barrier_with_timeout(name, timeout_s=self.config.sync_timeout_s)

    def phase(self, name: str):
        """Watchdog grace phase (checkpoint/eval/shutdown); a disabled
        watchdog degrades to a no-op context."""
        if self.watchdog is not None:
            return self.watchdog.phase(name)
        return contextlib.nullcontext()
