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

Sections the port does not run are refused with a ``ValueError`` naming
them, never ignored: ``peft``, ``qat``, ``telemetry``, ``profiling``,
``distributed_guard``, ``metrics_server``, ``fault_injection``, any other
``fault_tolerance`` key, a ``data`` key other than ``prefetch`` (an unknown
``data.prefetch`` key raises JAX's ``TypeError``), and any ``distributed``
degree other than 1. SIGTERM's emergency save and its prefetch drain (JAX
:881-911) are not ported.
"""

from __future__ import annotations

import logging
import time
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
from automodel_tpu_torch.resilience.manifest import step_dir_key
from automodel_tpu_torch.resilience.preemption import NonFiniteError
from automodel_tpu_torch.training.rng import StatefulRNG
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.train_state import TrainState
from automodel_tpu_torch.training.train_step import build_eval_step, build_train_step, make_causal_lm_loss

logger = logging.getLogger(__name__)

# top-level sections the recipe reads; every other one is refused
READ_SECTIONS = (
    "seed", "device", "output_dir", "model", "dataset", "dataloader", "validation_dataset",
    "validation_dataloader", "step_scheduler", "optimizer", "loss_fn", "logging", "checkpoint",
    "fault_tolerance", "distributed", "generation", "data",
)
DEGREES = ("dp_replicate", "dp_shard", "tp", "cp", "pp", "ep")
NONFINITE_POLICIES = ("raise", "skip", "rollback")


class _RollbackRequested(Exception):
    def __init__(self, fail_step: int):
        super().__init__(fail_step)
        self.fail_step = fail_step


def _plain(section: Any) -> Any:
    return section.to_dict() if hasattr(section, "to_dict") else section


def _refuse(name: str, why: str) -> None:
    raise ValueError(f"{name}: {why} is not ported to the torch backend yet")


def check_sections(cfg: Any, read_sections: tuple = READ_SECTIONS) -> None:
    """Raise ``ValueError`` naming the first section the port does not run."""
    for name in cfg:
        if name not in read_sections and cfg[name] is not None:
            section = _plain(cfg[name])
            keys = f" ({', '.join(map(str, section))})" if isinstance(section, dict) and section else ""
            _refuse(f"{name}{keys}", f"the {name} section")
    checkpointing_config(cfg)
    ft = dict(_plain(cfg.get("fault_tolerance", None)) or {})
    policy = ft.pop("on_nonfinite", "raise")
    if policy not in NONFINITE_POLICIES:
        raise ValueError(f"fault_tolerance.on_nonfinite must be one of {NONFINITE_POLICIES}, got {policy!r}")
    ft.pop("max_rollbacks", None)
    if ft:
        _refuse(f"fault_tolerance ({', '.join(ft)})", "resilience beyond on_nonfinite and max_rollbacks")
    dist = dict(_plain(cfg.get("distributed", None)) or {})
    other = {k: v for k, v in dist.items() if k not in DEGREES or v not in (None, 1)}
    if other:
        _refuse(f"distributed {other}", "running on more than one device")
    data = dict(_plain(cfg.get("data", None)) or {})
    other = sorted(k for k in data if k != "prefetch")
    if other:
        _refuse(f"data ({', '.join(other)})", "a data key other than prefetch")
    PrefetchConfig.from_data_section(data)
    log_cfg = dict(_plain(cfg.get("logging", None)) or {})
    log_cfg.pop("metrics_path", None)
    if log_cfg:
        _refuse(f"logging ({', '.join(log_cfg)})", "a metrics sink other than the JSONL file")


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

    def __init__(self, cfg: Any):
        self.cfg = cfg

    def setup(self) -> None:
        cfg = self.cfg
        check_sections(cfg, self.read_sections)
        self.device = resolve_device(cfg.get("device", None))
        seed = int(cfg.get("seed", 42))
        self.auto = build_auto_from_model_section(cfg.model, self.device, seed=seed, trainable=True)
        self.model = self.auto.model
        self.rng = StatefulRNG(seed=seed)
        named = list(self.model.named_parameters())
        params = [p for _, p in named]

        ocfg = dict(_plain(cfg.get("optimizer", None)) or {"name": "adamw"})
        ocfg.pop("_target_", None)
        optimizer = build_optimizer(params, names=[n for n, _ in named], **ocfg)
        self.lr_schedule = optimizer.schedule
        self.state = TrainState(params=params, optimizer=optimizer)

        ft = _plain(cfg.get("fault_tolerance", None)) or {}
        self.on_nonfinite = ft.get("on_nonfinite", "raise")
        self.max_rollbacks = int(ft.get("max_rollbacks", 2))
        self.rollbacks = 0
        # the counterpart of JAX's _make_train_step: both steps from one loss
        self.loss_fn = self._make_loss_fn()
        self.train_step = build_train_step(
            self.loss_fn, self.lr_schedule, on_nonfinite=self.on_nonfinite,
            post_step_fn=getattr(self.model, "post_step_fn", None),
        )
        self.eval_step = build_eval_step(self.loss_fn)

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
        self._placer = DevicePlacer(self.device)
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
        self.step_scheduler = StepScheduler(dataloader=self.dataloader, **scfg)

        out_dir = Path(cfg.get("output_dir", None) or "runs/torch_finetune")
        path = cfg.get("logging.metrics_path", None) or str(out_dir / "train_metrics.jsonl")
        self.metric_logger = MetricLogger(path)
        logger.info("training on %s, metrics to %s", self.device, path)

        # in-training eval sampling (generation: section); any skip reason is
        # recorded for the benchmark's decode leg
        self._gen_engine = None
        self._gen_prompt_ids = None
        self._gen_section: dict = {}
        self._gen_skip_reason: Optional[str] = None
        if cfg.get("generation", None) is not None:
            self._setup_eval_generation(dict(_plain(cfg.generation) or {}))

        ccfg = checkpointing_config(cfg)
        self.checkpointer = Checkpointer(ccfg) if ccfg is not None else None
        # the newest validation loss; a save that beats BEST.json marks its dir
        self._last_val_metric: Optional[float] = None
        if self.checkpointer is not None and self.checkpointer.has_checkpoint():
            self._restore()

    def _make_loss_fn(self):
        """The loss the train and eval steps take, over ``self.model``: the
        ``loss_fn:`` section's. A recipe with another objective (the KD
        recipe, recipes/kd.py) overrides this one method."""
        lcfg = dict(_plain(self.cfg.get("loss_fn", None)) or {})
        lcfg.pop("_target_", None)
        loss_name = lcfg.pop("name", "masked_ce")
        return make_causal_lm_loss(self.model, loss=loss_name, **lcfg)

    def _prepare_group(self, group: list) -> tuple[dict, int]:
        """One grad-acc group of collated microbatches → (the [A]-stacked
        host batch, its token count over every ``*input_ids`` leaf). The
        sync loop, validation and the prefetch producer all go through
        here, so both paths build the same batches (JAX :723-767; the
        port runs no zigzag context parallelism, so JAX's validation
        variant is this one)."""
        stacked = stack_microbatches(group)
        n_tokens = int(sum(v.size for k, v in stacked.items() if k.endswith("input_ids") and isinstance(v, np.ndarray)))
        return stacked, n_tokens

    def _place(self, stacked: dict) -> dict:
        """[A]-stacked numpy batch → tensors on the training device, on the
        sync path (JAX's ``_place_group``; the prefetch producer places
        through ``self._placer``)."""
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
        names = [n for n, _ in self.model.named_parameters()]
        return {
            "model": self.model.state_dict(),
            "optim": self.state.optimizer.state_tree(names),
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
        try:
            try:
                last = self._loop_with_rollback()
            finally:
                self._close_prefetch()
            if self.checkpointer is not None:
                # drain and commit an in-flight save, then skip the end-of-loop
                # save when it already covers this step: save() begins by
                # uncommitting its dir
                self.checkpointer.wait()
                latest = self.checkpointer.latest_committed_dir()
                if latest is None or step_dir_key(latest)[1] != self.step_scheduler.step:
                    self.save_checkpoint()
        finally:
            # always drain and commit an async save, even when the loop died
            if self.checkpointer is not None:
                self.checkpointer.close()
        return last

    def _loop_with_rollback(self) -> dict:
        while True:
            try:
                return self._loop()
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
        self.checkpointer.wait()  # an in-flight async save commits first
        self._restore(before_step=fail_step)
        ckpt_step = self.step_scheduler.step
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
        """The host side of ``on_nonfinite``: raise, or ask for a rollback
        while the budget lasts (``skip`` is the train step's own)."""
        if self.on_nonfinite not in ("raise", "rollback") or not bool(metrics["nonfinite"]):
            return
        if self.on_nonfinite == "rollback":
            if self.rollbacks < self.max_rollbacks:
                self.rollbacks += 1
                raise _RollbackRequested(step)
            logger.error("on_nonfinite=rollback: rollback budget (%d) exhausted — raising", self.max_rollbacks)
        raise NonFiniteError(
            f"non-finite loss or gradient at step {step} (fault_tolerance.on_nonfinite: {self.on_nonfinite})"
        )

    def _loop(self) -> dict:
        last: dict = {}
        tokens_window = steps_window = 0
        input_wait_window = 0.0
        first = True
        t_window = time.perf_counter()
        it = iter(self.step_scheduler)
        while True:
            t_input = time.perf_counter()
            got = self._next_batch(it)
            if got is None:
                break
            stacked, batch, n_tokens = got
            input_wait_window += time.perf_counter() - t_input
            metrics = self.train_step(self.state, batch)
            step = self.step_scheduler.step
            self._check_nonfinite(metrics, step)
            tokens_window += n_tokens
            steps_window += 1
            if first or self.step_scheduler.is_log_step:
                rec = {k: v.tolist() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
                if self.rollbacks:
                    rec["rollbacks_total"] = self.rollbacks
                dt = time.perf_counter() - t_window
                if first:
                    # kernel builds and allocator warm-up land here, as the first
                    # JAX step's compile does in compile_time_s
                    rec["first_step_s"] = dt
                else:
                    rec.update(steps_spanned=steps_window, step_time_s=dt / steps_window, tps=tokens_window / dt,
                               host_input_wait_s=input_wait_window / steps_window)
                    if isinstance(self.dataloader, PrefetchingLoader):
                        rec["prefetch_depth"] = self.dataloader.queue_depth
                if first and not self.step_scheduler.is_log_step:
                    logger.info("first step %.3fs", dt)
                else:
                    self.metric_logger.log(rec, step=step)
                    last = rec
                first = False
                tokens_window = steps_window = 0
                input_wait_window = 0.0
                t_window = time.perf_counter()
            boundary = False
            gen_active = self._gen_engine is not None and self._gen_prompt_ids is not None
            if self.step_scheduler.is_val_step and (self.val_dataloader is not None or gen_active):
                if self.val_dataloader is not None:
                    self.metric_logger.log(self.run_validation(), step=step)
                if gen_active:
                    self._log_eval_generation()
                boundary = True
            if self.checkpointer is not None and self.step_scheduler.is_ckpt_step:
                self.save_checkpoint()
                boundary = True
            if boundary:
                # validation, sampling and save time must not read as step time
                tokens_window = steps_window = 0
                input_wait_window = 0.0
                t_window = time.perf_counter()
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
