"""LLM finetune / pretrain recipe, port of the core of
``TrainFinetuneRecipeForNextTokenPrediction`` in
``automodel_tpu/recipes/train_ft.py`` (setup :74, loop :1109, checkpoint
save and restore :785-864, ``run_validation`` :1389).

    python -m automodel_tpu_torch.cli.app finetune llm -c cfg.yaml [--device=cpu]

Sections read: ``seed``, ``device`` (``cuda`` unless ``cpu``), ``model``
(``hf_config`` + ``backend``, random weights from the seed, or
``pretrained_model_name_or_path``, a local HF directory), ``dataset``
(a ``_target_``: ``MockSFTDataset``, ``MegatronPretraining``,
``NanogptDataset``, ``BlendedNanogptDataset``, ...), ``dataloader``
(``global_batch_size``, ``shuffle``, ``drop_last``, ``infinite``),
``validation_dataset`` and ``validation_dataloader`` (default:
``dataloader``), ``data`` (``prefetch``, below), ``step_scheduler``
(``ckpt_every_steps`` and ``val_every_steps`` among its keys),
``optimizer``, ``loss_fn``, ``checkpoint``, ``logging.metrics_path``
(default ``<output_dir>/train_metrics.jsonl``),
``fault_tolerance`` (``on_nonfinite``: ``raise`` | ``skip`` | ``rollback``,
and ``max_rollbacks``), ``generation``.

``on_nonfinite: rollback`` (JAX :1002-1070) restores the newest verified
checkpoint saved strictly before a non-finite step, fast-forwards the
loader past the window the failed step came from (replaying the
scheduler's consumption, epoch tails included), logs ``{"event":
"rollback", "fail_step": N}`` and trains on; step records then carry
``rollbacks_total``. With no checkpoint, or after ``max_rollbacks``
rollbacks (default 2), it raises ``NonFiniteError``. The host RNG state
(``training/rng.StatefulRNG``) rides a checkpoint's extras under
``"rng"``.

With ``checkpoint.enabled`` the run resumes at setup from the newest
committed step dir of ``checkpoint_dir`` (or bootstraps from
``restore_from`` when there is none) and logs ``{"event": "resume",
"resumed_from_step": N}``; it saves every ``ckpt_every_steps`` and at the
end of the loop (unless the last step was just saved), and a save after a
validation that beat ``BEST.json`` marks its dir best. Validation runs
every ``val_every_steps`` and logs ``val_loss`` and ``val_tokens``.

The ``generation:`` section (JAX :540-620) samples completions of its
``prompt_ids`` with the live weights at each validation step, through the
KV-cache ``GenerationEngine``, and logs ``{"event": "generation",
"gen_samples": [...], "ttft_s", "decode_tps", "gen_tokens",
"gen_cache_bytes"}``; a failed sampling is logged and the run goes on. A
model without a KV-cache decode path, or ``enabled: false``, records the
reason instead (the benchmark's decode leg reports it).

``data: {prefetch: {depth, collate_workers}}`` (JAX :260-290) wraps the
train and validation loaders in ``data/prefetch.PrefetchingLoader`` before
the scheduler is built: collate threads and a producer thread stack each
grad-acc group and copy it to the device ahead of the step
(``DevicePlacer``), and the loop pops it. The checkpointed cursor is the
consumption cursor, the rollback's ``seek`` flushes the run-ahead, and the
producers are joined at loop exit, normal or not (``_close_prefetch``).
Prefetch on and off give the same batches and losses bit for bit.

One log record per ``log_every_steps`` carries
``loss``, ``grad_norm``, ``lr``, ``num_label_tokens``, ``step``,
``step_time_s``, ``tps`` and ``host_input_wait_s`` (the host's seconds a
step spent getting the next batch: collate, stack and copy when sync, a
queue pop when prefetched; not on the first step's record), with
``prefetch_depth`` (batches ready in the queue) when prefetching; an MoE
model's steps add ``moe_aux_loss``, ``expert_load_imbalance`` and
``expert_load_imbalance_per_layer`` (a JSON array), and its
``post_step_fn`` (aux-free router-bias balancing) runs after each applied
update.

Observability and resilience (JAX :217-520, 881-990), each on by default
with JAX's defaults, each inert with ``enabled: false``, each refusing an
unknown key with JAX's ``TypeError``; with all of them off a run's losses
and grad norms are bit for bit the same as with them on:

- ``telemetry`` (telemetry/__init__.py): the anomaly flags in the step
  (``nonfinite``, ``grad_nonfinite_count``, ``grad_norm/<group>``), the
  ``time/{data_wait,dispatch,device_sync}_s`` window means, build events
  (``recompiles``), the memory census on its cadence (``mem_bytes_in_use``,
  ``mem_peak_bytes``), a manual ``profile`` window, the crash flight
  recorder (``flight_recorder.json`` beside the metrics JSONL) and the
  goodput ledger (``goodput.jsonl`` beside it; every record carries the
  ``attempt_id`` / ``restart_count`` envelope, and the run ends with a
  ``goodput_tail`` record when boundary time follows the last log record);
- ``profiling`` (telemetry/profiling/): step 1 runs under the cost counter
  (a ``cost_attribution`` event; ``mfu_measured_pct`` beside the analytic
  ``mfu_pct`` on each record) and the triggered capture (a slow step or a
  non-finite flag opens a trace and a memory record under
  ``<output_dir>/captures``, stamped as a ``trace_capture`` event);
- ``metrics_server`` (present = on): ``automodel_train_*`` on a standalone
  ``GET /metrics`` port;
- ``distributed_guard`` (resilience/guard.py): the hang watchdog petted
  each step (``heartbeat_age_s``; on expiry stacks, a ``hang`` event, a
  flight-recorder dump and ``os._exit(75)`` when a checkpoint is committed,
  else 1), consensus at log and checkpoint boundaries (a desynced
  checkpoint never commits), timed barriers at commit and shutdown;
- ``fault_tolerance`` whole (``preemption_signals``,
  ``emergency_checkpoint``, ``on_nonfinite``, ``max_consecutive_nonfinite``,
  ``max_rollbacks``): a preemption signal drains the loop at the next step
  boundary, joins the prefetch producers and drops their run-ahead
  (``_close_prefetch``), commits the emergency checkpoint at the
  consumption cursor and raises ``TrainingPreempted``, which the CLI turns
  into exit 75;
- ``fault_injection`` (resilience/fault_injection.py): the training knobs.

A ``distributed:`` section (JAX :82-108) runs the step on a mesh: the
process group from torchrun's environment (one process without it; NCCL
on the card, gloo under ``device: cpu``), the device mesh of its degrees
(``parallel/mesh.py``, ``dp_shard: -1`` inferred), the model's sharding
rules applied (``parallel/plans.py``: DTensor tensor parallelism where a
rule names ``tensor``, FSDP2 over the ``fsdp`` grouping, HSDP with
``dp_replicate``), ``attn: ring`` bound to the ``cp`` group
(``parallel/cp.py``, zigzag under ``cp_zigzag``), each rank's rows and
sequence slice of the global batch (``data/loader.local_batch``), the
token count and loss all-reduced over ``loss_dp`` and the optimizer on
the local shards. Without the section the run is one device with no
process group, as before.

Sections the port does not run are refused with a ``ValueError`` naming
them, never ignored: ``peft``, ``qat``, a ``data`` key other than
``prefetch`` (an unknown ``data.prefetch`` key raises JAX's ``TypeError``),
``distributed.pp > 1`` and ``ep > 1`` (the pipeline schedules and the
expert-parallel experts), ``tp > 1`` on an MoE family, ``adafactor`` and
``muon`` on a mesh of more than one device (they read whole matrices),
``checkpoint.is_async`` there, and ``attn: ring`` without the section.
"""

from __future__ import annotations

import json
import logging
import sys
import time
import weakref
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from automodel_tpu_torch.checkpoint.checkpointer import Checkpointer, CheckpointingConfig
from automodel_tpu_torch.data.collators import stack_microbatches
from automodel_tpu_torch.data.loader import DataLoader
from automodel_tpu_torch.data.prefetch import DevicePlacer, PrefetchConfig, PrefetchingLoader, PreparedBatch
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.device import resolve_device
from automodel_tpu_torch.generation.engine import (
    GenerationConfig,
    GenerationEngine,
    GenerationUnsupported,
    build_auto_from_model_section,
    resolve_tokenizer,
)
from automodel_tpu_torch.loggers.metric_logger import MetricLogger
from automodel_tpu_torch.optim.builders import build_optimizer
from automodel_tpu_torch.parallel.mesh import MeshConfig
from automodel_tpu_torch.resilience import NonFiniteError, Resilience, TrainingPreempted
from automodel_tpu_torch.resilience.fault_injection import FaultInjectionConfig
from automodel_tpu_torch.resilience.guard import DistributedGuard, DistributedGuardConfig
from automodel_tpu_torch.parallel.plans import local
from automodel_tpu_torch.resilience.manifest import step_dir_key
from automodel_tpu_torch.telemetry import Telemetry, TelemetryConfig, build_fingerprint, jax_groups
from automodel_tpu_torch.telemetry.goodput import GoodputLedger
from automodel_tpu_torch.telemetry.profiling import ProfilingConfig
from automodel_tpu_torch.telemetry.prometheus import MetricsServerConfig
from automodel_tpu_torch.training.rng import StatefulRNG
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.train_state import TrainState
from automodel_tpu_torch.training.train_step import build_eval_step, build_train_step, make_causal_lm_loss
from automodel_tpu_torch.utils.flops_utils import flops_per_token_for_config

logger = logging.getLogger(__name__)

# top-level sections the recipe reads; every other one is refused
READ_SECTIONS = (
    "seed", "device", "output_dir", "model", "dataset", "dataloader", "validation_dataset",
    "validation_dataloader", "step_scheduler", "optimizer", "loss_fn", "logging", "checkpoint",
    "fault_tolerance", "distributed", "generation", "data",
    "telemetry", "profiling", "distributed_guard", "metrics_server", "fault_injection",
)
DEGREES = ("dp_replicate", "dp_shard", "tp", "cp", "pp", "ep")


class _RollbackRequested(Exception):
    def __init__(self, fail_step: int):
        super().__init__(fail_step)
        self.fail_step = fail_step


def _weak_method(method) -> Any:
    """A callable that calls ``method`` while its object lives, else nothing."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        m = ref()
        return m(*args, **kwargs) if m is not None else None

    return call


def _plain(section: Any) -> Any:
    return section.to_dict() if hasattr(section, "to_dict") else section


def _refuse(name: str, why: str) -> None:
    raise ValueError(f"{name}: {why} is not ported to the torch backend yet")


def check_sections(cfg: Any, read_sections: tuple = READ_SECTIONS, parallel: bool = True) -> None:
    """Raise ``ValueError`` naming the first section the port does not run
    (``parallel``: whether the recipe runs a ``distributed:`` mesh)."""
    for name in cfg:
        if name not in read_sections and cfg[name] is not None:
            section = _plain(cfg[name])
            keys = f" ({', '.join(map(str, section))})" if isinstance(section, dict) and section else ""
            _refuse(f"{name}{keys}", f"the {name} section")
    checkpointing_config(cfg)
    check_observability_sections(cfg)
    dist = dict(_plain(cfg.get("distributed", None)) or {})
    if parallel:
        MeshConfig.from_section(dist).check_ported()
    else:
        other = {k: v for k, v in dist.items() if k not in DEGREES or v not in (None, 1)}
        if other:
            _refuse(f"distributed {other}", "this recipe on more than one device")
    data = dict(_plain(cfg.get("data", None)) or {})
    other = sorted(k for k in data if k != "prefetch")
    if other:
        _refuse(f"data ({', '.join(other)})", "a data key other than prefetch")
    PrefetchConfig.from_data_section(data)
    log_cfg = dict(_plain(cfg.get("logging", None)) or {})
    log_cfg.pop("metrics_path", None)
    if log_cfg:
        _refuse(f"logging ({', '.join(log_cfg)})", "a metrics sink other than the JSONL file")


def _section(cfg: Any, name: str) -> dict:
    d = dict(_plain(cfg.get(name, None)) or {})
    d.pop("_target_", None)
    return d


def check_observability_sections(cfg: Any) -> None:
    """Build the configs of ``fault_tolerance``, ``fault_injection``,
    ``telemetry``, ``profiling``, ``distributed_guard`` and
    ``metrics_server`` once, so an unknown key or a bad value raises
    (JAX's ``TypeError`` / ``ValueError``) before the model is built."""
    from automodel_tpu_torch.resilience import FaultToleranceConfig
    from automodel_tpu_torch.resilience.consensus import ConsensusConfig
    from automodel_tpu_torch.resilience.watchdog import WatchdogConfig
    from automodel_tpu_torch.utils.profiler import ProfilerConfig

    FaultToleranceConfig(**_section(cfg, "fault_tolerance"))
    if cfg.get("fault_injection", None) is not None:
        FaultInjectionConfig.from_dict(_section(cfg, "fault_injection"))
    tel = TelemetryConfig(**_section(cfg, "telemetry"))
    if tel.profile:
        ProfilerConfig(**dict(tel.profile))
    ProfilingConfig.from_dict(_section(cfg, "profiling")).triggered_config("captures")
    guard = DistributedGuardConfig(**_section(cfg, "distributed_guard"))
    WatchdogConfig(**dict(guard.watchdog or {}))
    ConsensusConfig(**dict(guard.consensus or {}))
    if cfg.get("metrics_server", None) is not None:
        MetricsServerConfig.from_dict(_section(cfg, "metrics_server"))


def checkpointing_config(cfg: Any) -> Optional[CheckpointingConfig]:
    """The ``checkpoint:`` section → its config when enabled (None when
    absent or disabled); an unknown key or format raises naming it."""
    ckpt = dict(_plain(cfg.get("checkpoint", None)) or {})
    known = set(CheckpointingConfig.__dataclass_fields__)
    unknown = sorted(set(ckpt) - known)
    if unknown:
        raise ValueError(f"checkpoint keys {unknown} are unknown (it takes {sorted(known)})")
    config = CheckpointingConfig(**ckpt)
    return config if ckpt.get("enabled", False) else None


def build_dataset(section: Any, name: str = "dataset") -> Any:
    """A dataset section (``dataset:``, ``validation_dataset:``) built by
    ``ConfigNode.instantiate``: its ``_target_`` (a JAX package path
    resolves to the port's twin, e.g. ``MockSFTDataset`` from either
    package) plus its arguments."""
    node = section if isinstance(section, ConfigNode) else ConfigNode(_plain(section) or {})
    if "_target_" not in node:
        raise ValueError(f"{name}: a _target_ naming the dataset is required")
    return node.instantiate()


class TrainFinetuneRecipeForNextTokenPrediction:
    read_sections = READ_SECTIONS
    runs_parallel = True  # reads a distributed: section (the KD and benchmark recipes do not yet)

    def __init__(self, cfg: Any):
        self.cfg = cfg

    def setup(self) -> None:
        cfg = self.cfg
        # the goodput ledger's epoch: the attempt's wall clock starts here,
        # so model build and data setup land in its `startup` segment
        self._setup_t0 = time.time()
        check_sections(cfg, self.read_sections, parallel=self.runs_parallel)
        self.device = resolve_device(cfg.get("device", None))
        self.mesh_ctx = self._setup_mesh()
        seed = int(cfg.get("seed", 42))
        self.auto = build_auto_from_model_section(cfg.model, self.device, seed=seed, trainable=True)
        self.model = self.auto.model
        self._setup_parallel()
        self.rng = StatefulRNG(seed=seed)
        named = list(self.model.named_parameters())
        params = [p for _, p in named]

        ocfg = dict(_plain(cfg.get("optimizer", None)) or {"name": "adamw"})
        ocfg.pop("_target_", None)
        if self.mesh_ctx is not None and self.mesh_ctx.world_size > 1 and ocfg.get("name") in ("adafactor", "muon"):
            raise ValueError(
                f"optimizer {ocfg['name']!r} on a mesh of {self.mesh_ctx.world_size} devices: it reads whole "
                "matrices (factored moments, Newton-Schulz), and its sharded form is not ported to the torch "
                "backend yet"
            )
        # the optimizer updates each parameter's local shard (elementwise rules)
        optimizer = build_optimizer([local(p) for p in params], names=[n for n, _ in named], **ocfg)
        self.lr_schedule = optimizer.schedule
        self.state = TrainState(params=params, optimizer=optimizer)

        # telemetry.{enabled,anomaly_flags} govern the step's anomaly
        # metrics (read here: the step is built before the facade)
        tcfg = _section(cfg, "telemetry")
        self._anomaly_flags = bool(tcfg.get("enabled", True)) and bool(tcfg.get("anomaly_flags", True))
        # preemption handling, the non-finite policy and fault injection;
        # built before the step, which takes the skip policy and NaN arm
        self.resilience = Resilience.from_config(
            _section(cfg, "fault_tolerance"),
            _section(cfg, "fault_injection") if cfg.get("fault_injection", None) is not None else None,
        )
        if self.resilience.config.enabled and self.resilience.on_nonfinite == "raise" and not self._anomaly_flags:
            logger.warning(
                "telemetry.anomaly_flags is disabled: fault_tolerance.on_nonfinite=raise cannot detect "
                "non-finite steps — divergence will train through silently"
            )
        self.rollbacks = 0  # the policy's count, mirrored from self.resilience
        self._groups = jax_groups(self.model, [n for n, _ in named])
        # the counterpart of JAX's _make_train_step: both steps from one loss
        self.loss_fn = self._make_loss_fn()
        self.train_step = build_train_step(
            self.loss_fn, self.lr_schedule, on_nonfinite=self.resilience.on_nonfinite,
            post_step_fn=getattr(self.model, "post_step_fn", None),
            anomaly_flags=self._anomaly_flags, groups=self._groups,
            nan_grads_at_step=self.resilience.nan_grads_at_step, mesh_ctx=self.mesh_ctx,
        )
        self.eval_step = build_eval_step(self.loss_fn, mesh_ctx=self.mesh_ctx)

        if cfg.get("dataset", None) is None:
            raise ValueError("A `dataset:` section is required")
        dl = dict(_plain(cfg.get("dataloader", None)) or {})
        dl.pop("_target_", None)
        self.dataloader = DataLoader(build_dataset(cfg.dataset), seed=seed, **dl)
        self.val_dataloader = None
        if cfg.get("validation_dataset", None) is not None:
            vdl = dict(_plain(cfg.get("validation_dataloader", None)) or dl)
            vdl.pop("_target_", None)
            self.val_dataloader = DataLoader(
                build_dataset(cfg.validation_dataset, "validation_dataset"), seed=seed, **vdl
            )
        scfg = dict(_plain(cfg.get("step_scheduler", None)) or {})
        # the input pipeline, wrapped before the scheduler is built (JAX :260-290)
        self._placer = DevicePlacer(self.device, select=self._local_batch if self.mesh_ctx is not None else None)
        self.prefetch_config = PrefetchConfig.from_data_section(_plain(cfg.get("data", None)))
        if self.prefetch_config.enabled:
            self.dataloader = PrefetchingLoader(
                self.dataloader, self.prefetch_config, prepare=self._prepare_group, place=self._placer,
                group_size=int(scfg.get("grad_acc_steps", 1)),
            )
            if self.val_dataloader is not None:
                self.val_dataloader = PrefetchingLoader(
                    self.val_dataloader, self.prefetch_config, prepare=self._prepare_group, place=self._placer,
                    group_size=1,
                )
            logger.info(
                "prefetch: depth=%d collate_workers=%d",
                self.prefetch_config.depth, self.prefetch_config.collate_workers,
            )
        # SIGTERM means preemption when resilience is on (the handler asks
        # the scheduler to stop at the next step boundary; the loop then
        # saves the emergency checkpoint and exits 75); otherwise the
        # scheduler's own graceful-shutdown handler
        self.step_scheduler = StepScheduler(dataloader=self.dataloader, **scfg)
        if self.resilience.preemption is not None:
            self.resilience.preemption.on_preempt = self.step_scheduler.request_shutdown
            self.resilience.install()
        else:
            self.step_scheduler.install_signal_handler()

        # everything a run writes lands under one output_dir, keyed on the
        # config so a requeued run lands in the same dir (JAX :316-338)
        out_dir = cfg.get("output_dir", None)
        if out_dir is None:
            fp = zlib.crc32(json.dumps(_plain(cfg), sort_keys=True, default=str).encode())
            out_dir = str(Path("runs") / f"run_{fp:08x}")
        self.output_dir = Path(out_dir)
        metrics_path = Path(cfg.get("logging.metrics_path", None) or str(self.output_dir / "train_metrics.jsonl"))

        # the goodput ledger beside the metrics JSONL, chained across
        # restart attempts; its envelope stamps every record
        self.ledger = GoodputLedger(
            metrics_path.parent / "goodput.jsonl",
            t_start=self._setup_t0,
            enabled=bool(tcfg.get("enabled", True)) and bool(tcfg.get("goodput", True)),
        )
        self.metric_logger = MetricLogger(
            str(metrics_path), envelope=self.ledger.envelope if self.ledger.enabled else None
        )
        logger.info("training on %s, metrics to %s", self.device, metrics_path)

        fingerprint = build_fingerprint(_plain(cfg), self.mesh_ctx)
        # what every rank must agree on (the ledger, and its attempt, is rank 0's)
        consensus_fingerprint = dict(fingerprint)
        if self.ledger.enabled:
            fingerprint["attempt"] = dict(self.ledger.envelope)
        self.telemetry = Telemetry.from_config(
            tcfg,
            fingerprint=fingerprint,
            default_recorder_path=str(self.metric_logger.path.parent / "flight_recorder.json"),
            default_trace_dir=str(self.output_dir / "trace"),
            device=self.device,
        )
        # cost-attributed MFU (step 1 counted) and the triggered capture
        self.profiling = ProfilingConfig.from_dict(_section(cfg, "profiling"))
        self._step_cost: Optional[dict] = None
        self._flops_per_token: Optional[float] = None
        # the hooks that point back at the recipe hold it weakly: a cycle
        # would keep the model's tensors alive after the last reference
        # drops, until the cyclic collector happens to run
        guard_event = _weak_method(self._guard_event)
        self.telemetry.attach_profiling(
            self.profiling, capture_dir=str(self.output_dir / "captures"), event_hook=guard_event
        )
        # metrics_server: a standalone scrape port; the section's presence opts in
        self._prom = None
        self._prom_server = None
        if cfg.get("metrics_server", None) is not None:
            from automodel_tpu_torch.telemetry.prometheus import TrainMetricsExporter, start_metrics_server

            mscfg = MetricsServerConfig.from_dict(_section(cfg, "metrics_server"))
            if mscfg.enabled:
                try:
                    exporter = TrainMetricsExporter()
                    self._prom_server = start_metrics_server(exporter.registry, mscfg.port, mscfg.host)
                    self._prom = exporter
                    logger.info("metrics server listening on %s:%d", mscfg.host, self._prom_server.server_address[1])
                except OSError as e:
                    # a busy scrape port must never kill training
                    logger.warning(
                        "metrics server failed to bind %s:%d (%s) — continuing WITHOUT a scrape port",
                        mscfg.host, mscfg.port, e,
                    )
        # the hang watchdog, consensus and timed barriers; the stacks file
        # and desync evidence land beside the metrics JSONL
        self.guard = DistributedGuard.from_config(
            _section(cfg, "distributed_guard"),
            fingerprint=consensus_fingerprint if self.telemetry.flight_recorder else None,
            flight_recorder=self.telemetry.flight_recorder,
            metric_logger=self.metric_logger,
            default_stacks_path=str(self.metric_logger.path.parent / "watchdog_stacks.txt"),
        )

        # in-training eval sampling (generation: section); any skip reason is
        # recorded for the benchmark's decode leg
        self._gen_engine = None
        self._gen_prompt_ids = None
        self._gen_section: dict = {}
        self._gen_skip_reason: Optional[str] = None
        if cfg.get("generation", None) is not None:
            self._setup_eval_generation(dict(_plain(cfg.generation) or {}))

        # checkpointing after telemetry, so a walk-back at the startup
        # resume reaches the flight recorder
        ccfg = checkpointing_config(cfg)
        self.checkpointer = Checkpointer(ccfg) if ccfg is not None else None
        # the newest validation loss; a save that beats BEST.json marks its dir
        self._last_val_metric: Optional[float] = None
        if self.checkpointer is not None:
            self.checkpointer.event_hook = self.telemetry.record_step
            self.checkpointer.timing_hook = self.ledger.on_ckpt_timing
            self.resilience.arm_peer_marker(self.checkpointer.root)
            self.checkpointer.commit_barrier = self.guard.barrier
        ckpt = self.checkpointer
        self.guard.bind_runtime(
            requeue_eligible=(lambda: ckpt.latest_committed_dir() is not None) if ckpt is not None else (lambda: False),
            peer_marker_root=str(ckpt.root) if ckpt else None,
            event_hook=guard_event,
            params_example=self.state.params,
        )
        if self.checkpointer is not None and self.checkpointer.has_checkpoint():
            self._restore()
            # the previous attempt's step time past the resumed step is
            # preemption-lost work
            self.ledger.on_resume(int(self.state.step))
        elif self.ledger.restart_count > 0:
            # a restart with nothing to resume from: all of it was lost
            self.ledger.on_resume(0)

    def _setup_mesh(self) -> Any:
        """The ``distributed:`` section → the process group and the device
        mesh (None without the section: one device, no group). Under NCCL
        the training device becomes this rank's card."""
        section = self.cfg.get("distributed", None)
        if section is None:
            return None
        from automodel_tpu_torch.parallel.mesh import build_mesh, initialize_distributed

        mcfg = MeshConfig.from_section(_plain(section))
        mcfg.check_ported()
        initialize_distributed(self.device)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        ctx = build_mesh(mcfg, device_type=self.device.type)
        logger.info("mesh: %s", ctx.shape)
        return ctx

    def _setup_parallel(self) -> None:
        """The model's plans on the mesh (tensor parallelism, FSDP2) and the
        ``ring`` backend on its ``cp`` group; zigzag permutes the data."""
        backend = self.model.backend
        ctx = self.mesh_ctx
        self._zigzag_cp = ctx.cp_size if ctx is not None and backend.cp_zigzag and ctx.cp_size > 1 else 0
        if backend.attn == "ring":
            if ctx is None:
                raise ValueError("attn='ring' (context parallel) requires a mesh: add a distributed: section")
            from automodel_tpu_torch.parallel.cp import install_ring_backend

            install_ring_backend(ctx, zigzag=backend.cp_zigzag)
        elif ctx is not None and ctx.cp_size > 1:
            raise ValueError(f"distributed.cp={ctx.cp_size} needs backend.attn: ring, not {backend.attn!r}")
        if ctx is not None:
            if self.cfg.get("checkpoint.is_async", False) and ctx.world_size > 1:
                raise ValueError("checkpoint.is_async on a mesh of more than one device is not ported to the torch "
                                 "backend yet")
            from automodel_tpu_torch.parallel.plans import parallelize

            parallelize(self.model, ctx)

    def _local_batch(self, stacked: dict) -> dict:
        from automodel_tpu_torch.data.loader import local_batch

        return local_batch(self.mesh_ctx, stacked)

    def _guard_event(self, rec: dict) -> None:
        """Anomaly evidence (desync, hang, trace_capture) goes to the
        flight recorder, the metrics JSONL and the /metrics event counters."""
        self.telemetry.record_step(rec)
        try:
            self.metric_logger.log(dict(rec), step=rec.get("step"))
        except Exception:  # evidence is best-effort; the abort is not
            pass
        # a skipped capture did not happen: it does not advance the counter
        if self._prom is not None and rec.get("event") and not rec.get("skipped"):
            self._prom.event(str(rec["event"]))

    def _compute_step_cost(self, cost) -> None:
        """Step 1's counted cost (telemetry/profiling/cost.py) → the static
        summary behind ``mfu_measured_pct``, logged whole as a
        ``cost_attribution`` event (JAX :625-656)."""
        from automodel_tpu_torch.telemetry import profiling as prof

        basis = self.profiling.roofline_basis()
        self._step_cost = {**cost.to_dict(), **prof.roofline(cost, basis)}
        # null fields (an unknown roofline basis on the CPU) are dropped: the
        # JSONL lint reads a bare null numeric as corruption
        rec = {"event": "cost_attribution", "program": "train_step",
               **{k: v for k, v in self._step_cost.items() if v is not None}}
        self.telemetry.record_step({**rec, "ts": time.time()})
        try:
            self.metric_logger.log(rec)
        except Exception:
            pass

    def _fold_mfu(self, metrics: dict) -> dict:
        """Both MFU provenances on a log record (JAX :656-684): ``mfu_pct``
        from the analytic law × tokens/s, ``mfu_measured_pct`` from step 1's
        counted FLOPs over the amortized step time."""
        from automodel_tpu_torch.telemetry import profiling as prof

        basis = self.profiling.roofline_basis()
        peak, _ = basis.resolve()
        tpsd = metrics.get("tps_per_device")
        if self._flops_per_token is not None and isinstance(tpsd, (int, float)) and peak == peak:
            metrics["mfu_pct"] = round(100.0 * tpsd * self._flops_per_token / (peak * 1e12), 3)
        if self._step_cost is not None and isinstance(metrics.get("step_time_s"), (int, float)):
            m = prof.mfu_measured_pct(self._step_cost["flops"], metrics["step_time_s"], 1, basis)
            if m is not None:
                metrics["mfu_measured_pct"] = round(m, 3)
        return metrics

    def _make_loss_fn(self):
        """The loss the train and eval steps take, over ``self.model``: the
        ``loss_fn:`` section's. A recipe with another objective (the KD
        recipe, recipes/kd.py) overrides this one method."""
        lcfg = dict(_plain(self.cfg.get("loss_fn", None)) or {})
        lcfg.pop("_target_", None)
        loss_name = lcfg.pop("name", "masked_ce")
        return make_causal_lm_loss(self.model, loss=loss_name, mesh_ctx=self.mesh_ctx, **lcfg)

    def _prepare_group(self, group: list) -> tuple[dict, int]:
        """One grad-acc group of collated microbatches → (the [A]-stacked
        global host batch, its token count over every ``*input_ids``
        leaf). The sync loop, validation and the prefetch producer all go
        through here, so both paths build the same batches (JAX
        :723-767). Under ``cp > 1`` a batch without ``position_ids`` gets
        the global positions, so RoPE sees them on every rank; under zigzag
        the sequence leaves are permuted into the zigzag layout (labels were
        shifted before, so the loss is the same)."""
        stacked = stack_microbatches(group)
        ctx = getattr(self, "mesh_ctx", None)
        if ctx is not None and ctx.cp_size > 1 and "position_ids" not in stacked:
            ids = stacked["input_ids"]
            stacked["position_ids"] = np.broadcast_to(np.arange(ids.shape[-1], dtype=np.int32), ids.shape).copy()
        if getattr(self, "_zigzag_cp", 0):
            from automodel_tpu_torch.parallel.cp import apply_zigzag

            stacked = {
                k: apply_zigzag(v, self._zigzag_cp, axis=2)
                if k in ("input_ids", "labels", "position_ids", "segment_ids") else v
                for k, v in stacked.items()
            }
        n_tokens = int(sum(v.size for k, v in stacked.items() if k.endswith("input_ids") and isinstance(v, np.ndarray)))
        return stacked, n_tokens

    def _place(self, stacked: dict) -> dict:
        """[A]-stacked numpy batch → tensors on the training device (this
        rank's part under a mesh), on the sync path (JAX's
        ``_place_group``; the prefetch producer places through
        ``self._placer``)."""
        if getattr(self, "mesh_ctx", None) is not None:
            stacked = self._local_batch(stacked)
        return {
            k: torch.from_numpy(v).to(self.device, non_blocking=True)
            for k, v in stacked.items()
            if isinstance(v, np.ndarray)
        }

    def _next_batch(self, it) -> Optional[tuple]:
        """The next step's (host batch, device batch, tokens), or None at
        the end: a queue pop when prefetched, else collate, stack and copy."""
        try:
            group = next(it)
        except StopIteration:
            return None
        if isinstance(group, PreparedBatch):
            return group.host, self._placer.adopt(group.device), group.n_tokens
        stacked, n_tokens = self._prepare_group(group)
        return stacked, self._place(stacked), n_tokens

    def _close_prefetch(self) -> None:
        """Join the prefetch producers and drop their run-ahead (idempotent;
        the consumption cursor survives for the end-of-loop save)."""
        for dl in (self.dataloader, self.val_dataloader):
            if isinstance(dl, PrefetchingLoader):
                dl.close()

    # -- eval generation ----------------------------------------------------
    def _setup_eval_generation(self, gcfg: dict) -> None:
        gcfg.pop("_target_", None)
        self._gen_section = dict(gcfg)
        if gcfg.pop("enabled", True) is False:
            self._gen_skip_reason = "generation.enabled: false"
            return
        prompts = gcfg.pop("prompts", None)
        prompt_ids = gcfg.pop("prompt_ids", None)
        resolve_tokenizer(
            gcfg.pop("tokenizer", None),
            self.cfg.model.get("pretrained_model_name_or_path", None) if prompts is not None else None,
        )
        try:
            self._gen_engine = GenerationEngine(self.auto, GenerationConfig.from_dict(gcfg))
        except GenerationUnsupported as e:
            self._gen_skip_reason = str(e)
            logger.warning("generation: %s", e)
            return
        if prompts is not None:
            logger.warning(
                "generation.prompts given without a tokenizer (none is ported): use "
                "generation.prompt_ids"
            )
        self._gen_prompt_ids = [[int(t) for t in p] for p in prompt_ids] if prompt_ids else None

    def _log_eval_generation(self) -> None:
        """Sample completions with the live weights and log them. A failure
        is logged and swallowed: eval sampling never ends a training run."""
        try:
            out = self._gen_engine.generate_ids(self._gen_prompt_ids)
        except Exception as e:
            logger.warning("eval generation failed: %s", e)
            return
        shown = [" ".join(map(str, p)) for p in self._gen_prompt_ids]
        texts = [" ".join(map(str, t)) for t in out["tokens"]]
        for p, t in zip(shown, texts):
            logger.info("sample @%d | %s -> %s", self.step_scheduler.step, p, t)
        self.metric_logger.log(
            {
                "event": "generation",
                "gen_samples": [{"prompt": p, "completion": t} for p, t in zip(shown, texts)],
                "ttft_s": out["ttft_s"],
                "decode_tps": out["decode_tps"],
                "gen_tokens": out["gen_tokens"],
                "gen_cache_bytes": out["cache_bytes"],
            },
            step=self.step_scheduler.step,
        )

    # -- checkpoint ---------------------------------------------------------
    def checkpoint_state(self) -> dict:
        """The training state a checkpoint holds, as a tree over the live
        tensors: the model's state dict (parameters and persistent
        buffers, such as the aux-free router bias), the optimizer's state
        (Adam's moments keyed by parameter name, adafactor's and muon's by
        JAX leaf path) and its count, and the step."""
        named = list(self.model.named_parameters())
        optim = self.state.optimizer.state_tree([n for n, _ in named])
        if self.mesh_ctx is not None:
            # the optimizer keeps local shards: wrap them as their params are
            # sharded, so DCP writes (and reshards on load) the whole tensors
            from automodel_tpu_torch.parallel.plans import shard_like

            optim = shard_like(optim, dict(named))
        return {
            "model": self.model.state_dict(),
            "optim": optim,
            "step": self.state.step,
        }

    def save_checkpoint(self) -> Path:
        out = self.checkpointer.save(
            self.checkpoint_state(),
            epoch=self.step_scheduler.epoch,
            step=self.step_scheduler.step,
            extra_state={
                "dataloader": self.dataloader.state_dict(),
                "step_scheduler": self.step_scheduler.state_dict(),
                "rng": self.rng.state_dict(),
            },
            hf_export=(self.auto.adapter, self.model.state_dict()),
            config_snapshot=_plain(self.cfg),
            hf_meta={"hf_config": self.auto.hf_config, "source_dir": self.auto.source_dir},
            layout_markers=getattr(self.model, "native_layout_markers", None),
        )
        # only saved checkpoints can be best; BEST.json is re-read, so a
        # resumed run never clobbers a better earlier best
        if self._last_val_metric is not None:
            best = self.checkpointer.best_info()
            if best is None or self._last_val_metric < float(best["value"]):
                self.checkpointer.mark_best(out, "val_loss", self._last_val_metric)
        logger.info("saved checkpoint at step %d", self.step_scheduler.step)
        return out

    def _restore(self, before_step: Optional[int] = None) -> None:
        state, extra = self.checkpointer.load(
            self.checkpoint_state(),
            expected_layout_markers=getattr(self.model, "native_layout_markers", None),
            before_step=before_step,
        )
        # the tensors were loaded in place; the plain values come back in the tree
        self.state.optimizer.count = int(state["optim"]["count"])
        self.state.step = int(state["step"])
        if "dataloader" in extra:
            self.dataloader.load_state_dict(extra["dataloader"])
        if "step_scheduler" in extra:
            self.step_scheduler.load_state_dict(extra["step_scheduler"])
        if "rng" in extra:
            self.rng.load_state_dict(extra["rng"])
        logger.info("restored checkpoint at step %d", self.state.step)
        # step numbers may go backwards after this marker (a walk-back)
        self.metric_logger.log({"event": "resume", "resumed_from_step": self.state.step})

    # -- loop ---------------------------------------------------------------
    def run_train_validation_loop(self) -> dict:
        """The loop (JAX :822-990). A preemption signal drains it at the next
        step boundary; the prefetch producers are joined and their run-ahead
        dropped; the end-of-loop save becomes the emergency checkpoint,
        committed before ``TrainingPreempted`` unwinds to the CLI (exit 75).
        The ledger's attempt closes last."""
        tel, res = self.telemetry, self.resilience
        self.guard.start()
        try:
            try:
                with tel.crash_guard():
                    last = self._loop_with_rollback()
            finally:
                tel.close()
                # join the producers before the emergency save; their
                # run-ahead is dropped (the consumption cursor excludes it).
                # The join waits on the input pipeline: input_wait time
                with self.ledger.segment("input_wait", step=self.step_scheduler.step):
                    self._close_prefetch()
            if self.checkpointer is not None and (not res.preempted or res.config.emergency_checkpoint):
                with self.guard.phase("checkpoint"):
                    # drain and commit an in-flight save, then skip the
                    # end-of-loop save when it already covers this step:
                    # save() begins by uncommitting its dir
                    self.checkpointer.wait()
                    latest = self.checkpointer.latest_committed_dir()
                    if latest is None or step_dir_key(latest)[1] != self.step_scheduler.step:
                        self.guard.pre_commit(self.step_scheduler.step, self.state.params)
                        self.save_checkpoint()
            with self.guard.phase("shutdown"):
                self.guard.barrier("shutdown")
        finally:
            # always drain and commit an async save, even when the loop died;
            # signal handlers are restored only after the emergency save
            try:
                if self.checkpointer is not None:
                    with self.guard.phase("checkpoint"):
                        self.checkpointer.close()
            finally:
                # boundary time after the last log record rides one closing
                # goodput_tail record, so the records sum to wall clock
                tail = self.ledger.pop_pending()
                excluded = getattr(self, "_tail_excluded_s", 0.0)
                if excluded > 0:
                    tail["window_excluded_s"] = round(excluded, 6)
                    self._tail_excluded_s = 0.0
                if tail:
                    try:
                        self.metric_logger.log({"event": "goodput_tail", **tail}, step=self.step_scheduler.step)
                    except Exception:  # accounting is best-effort at exit
                        pass
                    if self._prom is not None:
                        self._prom.update(tail)
                self.guard.close()
                res.close()
                self.step_scheduler.restore_signal_handlers()
                if self._prom_server is not None:
                    self._prom_server.shutdown()
                self.ledger.close(
                    reason="preempted" if res.preempted else ("crash" if sys.exc_info()[0] is not None else "exit")
                )
        if res.preempted:
            # run-local committed dir only: a run that committed nothing
            # must not look requeue-eligible
            out = self.checkpointer.latest_committed_dir() if self.checkpointer else None
            raise TrainingPreempted(self.step_scheduler.step, str(out) if out else None)
        return last

    def _loop_with_rollback(self) -> dict:
        while True:
            try:
                return self._loop(restarted=self.resilience.rollbacks > 0)
            except _RollbackRequested as rb:
                self._rollback(rb.fail_step)

    def _rollback(self, fail_step: int) -> None:
        """``on_nonfinite: rollback`` (JAX :1010-1070): restore the newest
        verified checkpoint saved strictly before ``fail_step`` and move
        the loader past the window that led to it, so the retrained steps
        see fresh data."""
        if not (self.checkpointer and self.checkpointer.has_checkpoint()):
            raise NonFiniteError(
                f"non-finite step {fail_step}: rollback requested but no "
                "checkpoint is available (enable checkpointing or use "
                "on_nonfinite: skip)"
            )
        self.metric_logger.log({"event": "rollback", "fail_step": fail_step, "ts": time.time()})
        # getattr: unit tests drive _rollback on a bare recipe object
        tel = getattr(self, "telemetry", None)
        if tel is not None:
            tel.record_step({"event": "rollback", "fail_step": fail_step, "ts": time.time()})
        self.checkpointer.wait()  # an in-flight async save commits first
        self._restore(before_step=fail_step)
        ckpt_step = self.step_scheduler.step
        # the step time of (ckpt_step, fail_step] is re-done: rollback_discard
        led = getattr(self, "ledger", None)
        if led is not None:
            led.on_rollback(fail_step, ckpt_step)
        dl, ga = self.dataloader, self.step_scheduler.grad_acc_steps
        nb = len(dl)
        # replay the scheduler's consumption, not steps x grad_acc: an epoch
        # whose length grad_acc does not divide drops its tail batches, so
        # a window across an epoch edge consumes more batches than it makes
        # steps, and undercounting would land inside the bad group again
        epoch, pos = dl.epoch, dl.batch_in_epoch
        steps_left = max(fail_step - ckpt_step, 0)
        while steps_left and nb >= ga:
            in_epoch = (nb - pos) // ga
            if steps_left <= in_epoch:
                pos += steps_left * ga
                steps_left = 0
            else:
                steps_left -= in_epoch
                epoch += 1
                pos = 0
        # on the prefetch pipeline, seek flushes the run-ahead and restarts
        # fetching at this cursor, so no stale batch reaches a step
        dl.seek(epoch, pos)
        # the skipped window may hold epoch edges the scheduler never sees
        self.step_scheduler.epoch = epoch
        logger.warning(
            "rollback #%d: restored step %d, fast-forwarded the loader to epoch %d batch %d, past the "
            "non-finite window ending at step %d", self.rollbacks, ckpt_step, epoch, pos, fail_step,
        )

    def _check_nonfinite(self, metrics: dict, step: int) -> None:
        """Fold the step's ``nonfinite`` flag into the policy (JAX
        :549-586): raise, ask for a rollback while the budget lasts, or count
        a skip (the train step itself discarded the update). A non-finite
        step arms a triggered capture of the next window."""
        res = self.resilience
        if not res.config.enabled or "nonfinite" not in metrics:
            return
        if not bool(metrics["nonfinite"]):
            res.observe_step_flag(step, False)
            return
        action = res.observe_step_flag(step, True)
        self.rollbacks = res.rollbacks
        self.telemetry.record_step({"event": "nonfinite_step", "step": step, "policy": res.on_nonfinite,
                                    "action": action or "continue", "ts": time.time()})
        self.telemetry.trigger_capture(step, "nonfinite")
        if self._prom is not None:
            self._prom.event("nonfinite_step")
        if action == "raise":
            raise NonFiniteError(
                f"non-finite loss or gradient at step {step} (fault_tolerance.on_nonfinite: {res.on_nonfinite}) — "
                "see the flight recorder for the per-group grad norms of the offending step"
            )
        if action == "rollback":
            raise _RollbackRequested(step)

    def _train_step_counted(self, batch: dict) -> dict:
        """Step 1 under the cost counter (JAX :1190-1205): the counted step
        is the real one; a failure of the count is logged, never load-bearing."""
        from automodel_tpu_torch.telemetry.profiling import count_cost

        metrics, cost = count_cost(self.train_step, self.state, batch, program="train_step")
        try:
            self._compute_step_cost(cost)
        except Exception as e:
            logger.warning("cost attribution failed: %s", e)
        return metrics

    def _loop(self, restarted: bool = False) -> dict:
        """The step loop (JAX :1109-1345). Each log record reports the window
        since the last one, amortized: ``step_time_s`` = window seconds /
        ``steps_spanned``, ``tps`` = window tokens / window seconds; step 1
        is reported as ``compile_time_s`` (the kernels' builds and the cost
        count land there) and stays out of every throughput window, as do
        validation and checkpoint pauses (their wall time rides the next
        record as ``window_excluded_s``)."""
        tel, res = self.telemetry, self.resilience
        last: dict = {}
        tokens_window = steps_window = 0
        input_wait_window = 0.0
        excluded_window = 0.0
        self._tail_excluded_s = 0.0
        # after a rollback the kernels are built: step 1 of the restart is no compile
        first = not restarted
        self.ledger.loop_started()
        t_window = time.perf_counter()

        def flush_window(at_step: int) -> None:
            if steps_window:
                self.ledger.window(time.perf_counter() - t_window, input_wait_window, steps_window, at_step)

        it = iter(self.step_scheduler)
        while True:
            t_input = time.perf_counter()
            tel.timers("data_wait").start()
            got = self._next_batch(it)
            if got is None:
                input_wait_window += time.perf_counter() - t_input
                break
            tel.timers("data_wait").stop()
            stacked, batch, n_tokens = got
            input_wait_window += time.perf_counter() - t_input
            step = self.step_scheduler.step
            tel.on_step(step)
            tel.timers("dispatch").start()
            if first and self.profiling.enabled and self.profiling.cost_attribution and self._step_cost is None:
                metrics = self._train_step_counted(batch)
            else:
                metrics = self.train_step(self.state, batch)
            tel.timers("dispatch").stop()
            # step boundary: pet the watchdog, fold the batch hash
            self.guard.on_step(step, stacked)
            if res.injector is not None:
                res.injector.maybe_die(step)
                res.injector.maybe_straggle(step)
                res.injector.maybe_hang(step)
            self._check_nonfinite(metrics, step)
            tokens_window += n_tokens
            steps_window += 1
            host_rec = {"step": step, "tokens": n_tokens, "ts": time.time()}
            is_log = self.step_scheduler.is_log_step
            if first or is_log:
                tel.timers("device_sync").start()
                rec = {k: v.tolist() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
                tel.timers("device_sync").stop()
                dt = time.perf_counter() - t_window
                if first:
                    if self._flops_per_token is None and "input_ids" in stacked:
                        try:
                            self._flops_per_token = flops_per_token_for_config(
                                self.model.config, int(stacked["input_ids"].shape[-1])
                            )
                        except Exception:
                            pass
                    rec["compile_time_s"] = dt
                    host_rec.update(compile_time_s=dt, loss=rec["loss"])
                    self.ledger.compile_window(dt, input_wait_window, step=step)
                    # step 1's timer entries and build events are the compile's
                    tel.timers.drain_means()
                    if tel.compile_bridge is not None:
                        tel.compile_bridge.drain()
                else:
                    rec.update(steps_spanned=steps_window, step_time_s=dt / steps_window, tps=tokens_window / dt,
                               tps_per_device=tokens_window / dt / (self.mesh_ctx.world_size if self.mesh_ctx else 1),
                               host_input_wait_s=input_wait_window / steps_window)
                    if isinstance(self.dataloader, PrefetchingLoader):
                        rec["prefetch_depth"] = self.dataloader.queue_depth
                    if res.skipped_steps:
                        rec["skipped_steps_total"] = res.skipped_steps
                    if res.rollbacks:
                        rec["rollbacks_total"] = res.rollbacks
                    rec = self._fold_mfu(rec)
                    self.ledger.window(dt, input_wait_window, steps_window, step)
                    if excluded_window > 0:
                        rec["window_excluded_s"] = round(excluded_window, 6)
                        excluded_window = 0.0
                if is_log:
                    rec.update(self.ledger.pop_pending())
                    rec = tel.enrich(step, rec)
                    rec = self.guard.on_log(step, rec, params=self.state.params)
                    self.metric_logger.log(rec, step=step)
                    if self._prom is not None:
                        self._prom.update(rec)
                        self._prom.update_goodput(self.ledger.snapshot())
                    last = rec
                else:
                    logger.info("first step %.3fs", dt)
                host_rec.update({k: rec[k] for k in ("loss", "grad_norm", "step_time_s", "tps", "nonfinite") if k in rec})
                tel.record_step(host_rec)
                first = False
                tokens_window = steps_window = 0
                input_wait_window = 0.0
                t_window = time.perf_counter()
            else:
                tel.record_step(host_rec)
            gen_active = self._gen_engine is not None and self._gen_prompt_ids is not None
            if self.step_scheduler.is_val_step and (self.val_dataloader is not None or gen_active):
                flush_window(step)
                t_boundary = time.perf_counter()
                with self.guard.phase("eval"):
                    if self.val_dataloader is not None:
                        with self.ledger.segment("eval", step=step):
                            val = self.run_validation()
                        if tel.compile_bridge is not None:
                            d = tel.compile_bridge.drain()
                            if d["compiles"]:
                                val["eval_compiles"] = d["compiles"]
                                val["eval_compile_secs"] = round(d["compile_secs"], 4)
                        self.metric_logger.log(val, step=step)
                    if gen_active:
                        with self.ledger.segment("generation", step=step):
                            self._log_eval_generation()
                if tel.compile_bridge is not None:
                    tel.compile_bridge.drain()
                tel.skip_next_interval()
                excluded_window += time.perf_counter() - t_boundary
                tokens_window = steps_window = 0
                input_wait_window = 0.0
                t_window = time.perf_counter()
            if self.checkpointer is not None and self.step_scheduler.is_ckpt_step:
                flush_window(step)
                t_boundary = time.perf_counter()
                # every process agrees on (step, config, data, params) before
                # the manifest commits
                self.guard.pre_commit(step, self.state.params)
                with self.guard.phase("checkpoint"):
                    self.save_checkpoint()
                tel.skip_next_interval()
                excluded_window += time.perf_counter() - t_boundary
                tokens_window = steps_window = 0
                input_wait_window = 0.0
                t_window = time.perf_counter()
        # the tail window (steps since the last log record) closes like any other
        if steps_window:
            flush_window(self.step_scheduler.step)
        elif input_wait_window > 0:
            self.ledger.add("input_wait", input_wait_window, step=self.step_scheduler.step)
        self._tail_excluded_s = excluded_window
        if res.skipped_steps:
            last["skipped_steps_total"] = res.skipped_steps
        if res.rollbacks:
            last["rollbacks_total"] = res.rollbacks
        return last

    def run_validation(self) -> dict:
        tot_loss, tot_n = 0.0, 0
        for vb in self.val_dataloader:
            if isinstance(vb, PreparedBatch):
                batch = self._placer.adopt(vb.device)
            else:
                batch = self._place(self._prepare_group([vb])[0])
            out = self.eval_step(self.state, batch)
            tot_loss += float(out["loss_sum"])
            tot_n += int(out["num_label_tokens"])
        val_loss = tot_loss / max(tot_n, 1)
        if isinstance(self.val_dataloader, PrefetchingLoader):
            # no run-ahead of the next pass held on the device until then
            self.val_dataloader.suspend()
        if val_loss == val_loss:  # a NaN eval must never look best
            self._last_val_metric = val_loss
        return {"val_loss": val_loss, "val_tokens": tot_n}


def main(cfg: Any) -> dict:
    recipe = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    return recipe.run_train_validation_loop()
