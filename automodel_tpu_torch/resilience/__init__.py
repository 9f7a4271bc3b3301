"""Resilience of the torch port (port of ``automodel_tpu/resilience``):
keep goodput up when the world misbehaves.

- preemption.py      — SIGTERM → ``preempted`` flag (distinct from graceful
  shutdown) → emergency checkpoint at the next step boundary → exit
  REQUEUE_EXIT_CODE (75)
- manifest.py        — MANIFEST.json commit marker + integrity record
- retry.py           — bounded-exponential-backoff around storage I/O
- the non-finite-step policy — ``fault_tolerance.on_nonfinite:
  raise|skip|rollback``: ``skip`` discards the update inside the train
  step, ``rollback`` restores the last verified checkpoint and
  fast-forwards the dataloader
- fault_injection.py — config/env-driven training faults (die, NaN grads,
  corrupt a checkpoint file, fail I/O, hang, slow collate, desync,
  straggle) so the recovery paths are testable
- watchdog.py / consensus.py / timed_sync.py, behind guard.py's
  ``DistributedGuard`` (the ``distributed_guard:`` section)

YAML::

    fault_tolerance:
      enabled: true
      preemption_signals: [SIGTERM]
      emergency_checkpoint: true
      on_nonfinite: raise            # raise | skip | rollback
      max_consecutive_nonfinite: 3   # skip: raise after N in a row
      max_rollbacks: 2               # rollback: then raise
    fault_injection: {}              # tests only; see fault_injection.py

Defaults are on: a recipe with no ``fault_tolerance:`` section still gets
preemption handling and the ``raise`` policy.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional, Sequence

from automodel_tpu_torch.resilience.fault_injection import (  # noqa: F401
    FaultInjectionConfig,
    FaultInjector,
    InjectedFault,
    activate_from_config,
    active_injector,
    corrupt_file,
)
from automodel_tpu_torch.resilience.manifest import (  # noqa: F401
    MANIFEST_NAME,
    classify_step_dirs,
    has_manifest,
    verify_manifest,
    write_manifest,
)
from automodel_tpu_torch.resilience.preemption import (  # noqa: F401
    DEFAULT_PREEMPTION_SIGNALS,
    PEER_PREEMPTION_MARKER,
    REQUEUE_EXIT_CODE,
    NonFiniteError,
    PreemptionHandler,
    TrainingPreempted,
    peer_preemption_fresh,
    write_peer_preemption_marker,
)
from automodel_tpu_torch.resilience.retry import RetriesExhausted, retry_io  # noqa: F401
from automodel_tpu_torch.resilience.consensus import (  # noqa: F401
    ConsensusConfig,
    ConsensusGuard,
    DesyncError,
    find_divergent,
)
from automodel_tpu_torch.resilience.guard import (  # noqa: F401
    DistributedGuard,
    DistributedGuardConfig,
)
from automodel_tpu_torch.resilience.timed_sync import (  # noqa: F401
    SyncTimeout,
    barrier_with_timeout,
    timed_call,
)
from automodel_tpu_torch.resilience.watchdog import Watchdog, WatchdogConfig  # noqa: F401

logger = logging.getLogger(__name__)

NONFINITE_POLICIES = ("raise", "skip", "rollback")


@dataclasses.dataclass
class FaultToleranceConfig:
    enabled: bool = True
    preemption_signals: Sequence[str] = DEFAULT_PREEMPTION_SIGNALS
    emergency_checkpoint: bool = True
    on_nonfinite: str = "raise"  # raise | skip | rollback
    max_consecutive_nonfinite: int = 3
    max_rollbacks: int = 2

    def __post_init__(self) -> None:
        if self.on_nonfinite not in NONFINITE_POLICIES:
            raise ValueError(
                f"fault_tolerance.on_nonfinite must be one of "
                f"{NONFINITE_POLICIES}, got {self.on_nonfinite!r}"
            )


class Resilience:
    """Facade the recipes drive: the installed preemption handler, the
    non-finite policy bookkeeping (consecutive/total skip counters, rollback
    budget), and the active fault injector."""

    def __init__(
        self,
        config: FaultToleranceConfig,
        injector: Optional[FaultInjector] = None,
    ):
        self.config = config
        self.injector = injector
        self.preemption = (
            PreemptionHandler(config.preemption_signals) if config.enabled else None
        )
        self.skipped_steps = 0
        self.rollbacks = 0
        self._consecutive_nonfinite = 0

    @classmethod
    def from_config(
        cls, section: Any, fault_injection_section: Any = None
    ) -> "Resilience":
        d = dict(section or {})
        d.pop("_target_", None)
        injector = activate_from_config(fault_injection_section)
        return cls(FaultToleranceConfig(**d), injector=injector)

    # -- lifecycle ----------------------------------------------------------
    def install(self) -> "Resilience":
        if self.preemption is not None:
            self.preemption.install()
        return self

    def arm_peer_marker(self, checkpoint_root: Any) -> None:
        """Multi-host requeue wiring: at SIGTERM time, drop a marker into
        the SHARED checkpoint root so peer hosts that later die of broken
        collectives (this host stops participating once it exits) can
        classify their crash as preemption collateral and exit with the
        requeue code too — see preemption.write_peer_preemption_marker.
        CHAINS with any on_preempt already installed (the recipe points it
        at the step scheduler's request_shutdown); the marker goes first —
        it is the one action another host depends on."""
        if self.preemption is None:
            return
        root, prior = checkpoint_root, self.preemption.on_preempt

        def _on_preempt() -> None:
            write_peer_preemption_marker(root)
            if prior is not None:
                prior()

        self.preemption.on_preempt = _on_preempt

    def close(self) -> None:
        if self.preemption is not None:
            self.preemption.restore()

    @property
    def preempted(self) -> bool:
        return self.preemption is not None and self.preemption.preempted

    # -- non-finite-step policy ---------------------------------------------
    @property
    def on_nonfinite(self) -> str:
        return self.config.on_nonfinite if self.config.enabled else "raise"

    @property
    def nan_grads_at_step(self) -> Optional[int]:
        return self.injector.nan_grads_at_step if self.injector is not None else None

    def observe_step_flag(self, step: int, is_nonfinite: bool) -> Optional[str]:
        """Fold one step's non-finite flag into the policy. Returns the
        action the loop must take: None (continue), ``"rollback"``, or
        ``"raise"`` (the caller raises NonFiniteError)."""
        if not is_nonfinite:
            self._consecutive_nonfinite = 0
            return None
        self._consecutive_nonfinite += 1
        policy = self.on_nonfinite
        if policy == "raise" or not self.config.enabled:
            return "raise"
        if policy == "skip":
            self.skipped_steps += 1
            if self._consecutive_nonfinite >= self.config.max_consecutive_nonfinite:
                logger.error(
                    "on_nonfinite=skip: %d consecutive non-finite steps "
                    "(budget %d) — raising",
                    self._consecutive_nonfinite,
                    self.config.max_consecutive_nonfinite,
                )
                return "raise"
            logger.warning(
                "on_nonfinite=skip: discarded update at step %d "
                "(%d skipped total)", step, self.skipped_steps,
            )
            return None
        # rollback
        if self.rollbacks >= self.config.max_rollbacks:
            logger.error(
                "on_nonfinite=rollback: rollback budget (%d) exhausted — raising",
                self.config.max_rollbacks,
            )
            return "raise"
        self.rollbacks += 1
        self._consecutive_nonfinite = 0
        return "rollback"


__all__ = [
    "FaultToleranceConfig",
    "Resilience",
    "PreemptionHandler",
    "TrainingPreempted",
    "NonFiniteError",
    "REQUEUE_EXIT_CODE",
    "PEER_PREEMPTION_MARKER",
    "write_peer_preemption_marker",
    "peer_preemption_fresh",
    "retry_io",
    "RetriesExhausted",
    "write_manifest",
    "verify_manifest",
    "has_manifest",
    "classify_step_dirs",
    "MANIFEST_NAME",
    "FaultInjectionConfig",
    "FaultInjector",
    "InjectedFault",
    "activate_from_config",
    "active_injector",
    "corrupt_file",
    "DistributedGuard",
    "DistributedGuardConfig",
    "Watchdog",
    "WatchdogConfig",
    "ConsensusGuard",
    "ConsensusConfig",
    "DesyncError",
    "find_divergent",
    "SyncTimeout",
    "barrier_with_timeout",
    "timed_call",
]
