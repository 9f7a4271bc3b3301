"""LLM finetune / pretrain recipe, port of the core of
``TrainFinetuneRecipeForNextTokenPrediction`` in
``automodel_tpu/recipes/train_ft.py`` (setup :74, loop :1109, checkpoint
save and restore :785-864, ``run_validation`` :1389).

    python -m automodel_tpu_torch.cli.app finetune llm -c cfg.yaml [--device=cpu]

Sections read: ``seed``, ``device`` (``cuda`` unless ``cpu``), ``model``
(``hf_config`` + ``backend``, random weights from the seed, or
``pretrained_model_name_or_path``, a local HF directory), ``dataset``
(``MockSFTDataset``), ``dataloader``, ``validation_dataset`` and
``validation_dataloader`` (default: ``dataloader``), ``step_scheduler``
(``ckpt_every_steps`` and ``val_every_steps`` among its keys),
``optimizer``, ``loss_fn``, ``checkpoint``, ``logging.metrics_path``
(default ``<output_dir>/train_metrics.jsonl``),
``fault_tolerance.on_nonfinite`` (``raise`` | ``skip``), ``generation``.

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

One log record per ``log_every_steps`` carries
``loss``, ``grad_norm``, ``lr``, ``num_label_tokens``, ``step``,
``step_time_s`` and ``tps``; an MoE model's steps add ``moe_aux_loss``,
``expert_load_imbalance`` and ``expert_load_imbalance_per_layer`` (a JSON
array), and its ``post_step_fn`` (aux-free router-bias balancing) runs
after each applied update.

Sections the port does not run are refused with a ``ValueError`` naming
them, never ignored: ``peft``, ``qat``, ``telemetry``, ``profiling``,
``distributed_guard``, ``metrics_server``, ``data`` (prefetch),
``fault_injection``, any other ``fault_tolerance`` key, and any
``distributed`` degree other than 1.
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
from automodel_tpu_torch.data.sft import MockSFTDataset
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
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.resilience.manifest import step_dir_key
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.train_state import TrainState
from automodel_tpu_torch.training.train_step import build_eval_step, build_train_step, make_causal_lm_loss

logger = logging.getLogger(__name__)

# top-level sections the recipe reads; every other one is refused
READ_SECTIONS = (
    "seed", "device", "output_dir", "model", "dataset", "dataloader", "validation_dataset",
    "validation_dataloader", "step_scheduler", "optimizer", "loss_fn", "logging", "checkpoint",
    "fault_tolerance", "distributed", "generation",
)
DEGREES = ("dp_replicate", "dp_shard", "tp", "cp", "pp", "ep")
DATASETS = {"MockSFTDataset": MockSFTDataset}


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
    if ft.pop("on_nonfinite", "raise") not in ("raise", "skip"):
        _refuse("fault_tolerance.on_nonfinite", "a policy other than raise|skip")
    if ft:
        _refuse(f"fault_tolerance ({', '.join(ft)})", "resilience beyond on_nonfinite")
    dist = dict(_plain(cfg.get("distributed", None)) or {})
    other = {k: v for k, v in dist.items() if k not in DEGREES or v not in (None, 1)}
    if other:
        _refuse(f"distributed {other}", "running on more than one device")
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
    """A dataset section (``dataset:``, ``validation_dataset:``):
    ``_target_`` naming ``MockSFTDataset`` (of either package) plus its
    arguments."""
    kw = dict(_plain(section) or {})
    target = str(kw.pop("_target_", ""))
    cls = DATASETS.get(target.rsplit(".", 1)[-1])
    if cls is None:
        _refuse(f"{name}._target_={target!r}", f"a dataset other than {sorted(DATASETS)}")
    return cls(**kw)


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
        params = list(self.model.parameters())

        ocfg = dict(_plain(cfg.get("optimizer", None)) or {"name": "adamw"})
        ocfg.pop("_target_", None)
        self.lr_schedule = build_lr_schedule(lr=ocfg.get("lr", 1e-4), **dict(ocfg.get("lr_schedule") or {}))
        self.state = TrainState(params=params, optimizer=build_optimizer(params, **ocfg))

        self.on_nonfinite = (_plain(cfg.get("fault_tolerance", None)) or {}).get("on_nonfinite", "raise")
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

    def _place(self, stacked: dict) -> dict:
        """[A]-stacked numpy batch → tensors on the training device."""
        return {
            k: torch.from_numpy(v).to(self.device, non_blocking=True)
            for k, v in stacked.items()
            if isinstance(v, np.ndarray)
        }

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
        buffers, such as the aux-free router bias), the optimizer's fp32
        moments keyed by parameter name and its count, and the step."""
        opt = self.state.optimizer
        names = [n for n, _ in self.model.named_parameters()]
        return {
            "model": self.model.state_dict(),
            "optim": {"mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)), "count": opt.count},
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

    def _restore(self) -> None:
        state, extra = self.checkpointer.load(
            self.checkpoint_state(),
            expected_layout_markers=getattr(self.model, "native_layout_markers", None),
        )
        # the tensors were loaded in place; the plain values come back in the tree
        self.state.optimizer.count = int(state["optim"]["count"])
        self.state.step = int(state["step"])
        if "dataloader" in extra:
            self.dataloader.load_state_dict(extra["dataloader"])
        if "step_scheduler" in extra:
            self.step_scheduler.load_state_dict(extra["step_scheduler"])
        logger.info("restored checkpoint at step %d", self.state.step)
        # step numbers may go backwards after this marker (a walk-back)
        self.metric_logger.log({"event": "resume", "resumed_from_step": self.state.step})

    # -- loop ---------------------------------------------------------------
    def run_train_validation_loop(self) -> dict:
        try:
            last = self._loop()
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

    def _loop(self) -> dict:
        last: dict = {}
        tokens_window = steps_window = 0
        first = True
        t_window = time.perf_counter()
        for group in self.step_scheduler:
            stacked = stack_microbatches(group)
            metrics = self.train_step(self.state, self._place(stacked))
            step = self.step_scheduler.step
            if self.on_nonfinite == "raise" and bool(metrics["nonfinite"]):
                raise FloatingPointError(
                    f"non-finite loss or gradient at step {step} (fault_tolerance.on_nonfinite: raise)"
                )
            tokens_window += int(stacked["input_ids"].size)
            steps_window += 1
            if first or self.step_scheduler.is_log_step:
                rec = {k: v.tolist() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
                dt = time.perf_counter() - t_window
                if first:
                    # kernel builds and allocator warm-up land here, as the first
                    # JAX step's compile does in compile_time_s
                    rec["first_step_s"] = dt
                else:
                    rec.update(steps_spanned=steps_window, step_time_s=dt / steps_window, tps=tokens_window / dt)
                if first and not self.step_scheduler.is_log_step:
                    logger.info("first step %.3fs", dt)
                else:
                    self.metric_logger.log(rec, step=step)
                    last = rec
                first = False
                tokens_window = steps_window = 0
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
                t_window = time.perf_counter()
        return last

    def run_validation(self) -> dict:
        tot_loss, tot_n = 0.0, 0
        for vb in self.val_dataloader:
            out = self.eval_step(self.state, self._place(stack_microbatches([vb])))
            tot_loss += float(out["loss_sum"])
            tot_n += int(out["num_label_tokens"])
        val_loss = tot_loss / max(tot_n, 1)
        if val_loss == val_loss:  # a NaN eval must never look best
            self._last_val_metric = val_loss
        return {"val_loss": val_loss, "val_tokens": tot_n}


def main(cfg: Any) -> dict:
    recipe = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    return recipe.run_train_validation_loop()
