"""Knowledge-distillation recipe, port of ``automodel_tpu/recipes/kd.py``.

    python -m automodel_tpu_torch.cli.app kd llm -c cfg.yaml [--device=cpu]

A frozen teacher is built beside the student, and the step's loss blends
forward-KL distillation with the CE objective over the summed tokens:
``(1 - ratio) * CE + ratio * KD`` (``ops/losses.kd_loss``), plus an MoE
student's aux loss times the token count, as JAX's ``make_kd_loss`` does
(:31-55). The teacher runs in ``eval()`` under ``torch.no_grad()`` with
``requires_grad=False`` parameters: its logits enter the student's graph as
constants (``torch.inference_mode`` would make them tensors autograd
refuses to save), it has no optimizer state, and it is not part of
``checkpoint_state()``. Under ``no_grad`` its layers never recompute,
whatever its backend's ``remat``.

Sections read over ``finetune llm``'s (recipes/train_ft.py):

- ``teacher_model:`` (required; JAX's message when missing): ``hf_config``
  (random weights from ``seed + 100``, as JAX :77) or
  ``pretrained_model_name_or_path`` (a local HF directory), and
  ``backend``;
- ``kd: {ratio: 0.5, temperature: 1.0}``;
- ``loss_fn:`` only as ``{name: masked_ce}``, the CE the blend takes.

Refused by name: a ``teacher:`` section (the spelling of the committed
``examples/kd/llama_kd.yaml``, which JAX's recipe refuses too), any other
``kd`` key (``alpha`` among them), ``peft:`` (LoRA is not ported), another
``loss_fn``, and a teacher whose vocabulary differs from the student's.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import torch

from automodel_tpu_torch.generation.engine import build_auto_from_model_section
from automodel_tpu_torch.ops import losses as L
from automodel_tpu_torch.recipes.train_ft import READ_SECTIONS, TrainFinetuneRecipeForNextTokenPrediction, _plain

logger = logging.getLogger(__name__)

KD_KEYS = ("ratio", "temperature")
TEACHER_KEYS = ("hf_config", "pretrained_model_name_or_path", "backend")


def make_kd_loss(student: Any, teacher: Any, ratio: float, temperature: float) -> Callable[[dict], tuple]:
    """microbatch → ``(loss_sum, n[, extras])`` of the blend
    ``(1 - ratio) * CE + ratio * KD``, with an MoE student's ``aux_loss x
    n`` added and its ``moe_aux_loss`` / ``expert_counts`` returned as
    extras (JAX :45-52). The teacher's forward runs under
    ``torch.no_grad``."""

    def loss_fn(mb: dict):
        kw = {k: mb[k] for k in ("position_ids", "segment_ids") if mb.get(k) is not None}
        s_out = student(mb["input_ids"], **kw)
        s_logits, maux = s_out if isinstance(s_out, tuple) else (s_out, None)
        with torch.no_grad():
            t_out = teacher(mb["input_ids"], **kw)
        t_logits = t_out[0] if isinstance(t_out, tuple) else t_out
        ce_sum, n = L.masked_cross_entropy(s_logits, mb["labels"])
        kd_sum, _ = L.kd_loss(s_logits, t_logits, mb["labels"], temperature)
        loss_sum = (1.0 - ratio) * ce_sum + ratio * kd_sum
        if maux is None:
            return loss_sum, n
        loss_sum = loss_sum + maux.aux_loss * n.float()
        return loss_sum, n, {"moe_aux_loss": maux.aux_loss.detach(), "expert_counts": maux.expert_counts}

    return loss_fn


class KDRecipeForNextTokenPrediction(TrainFinetuneRecipeForNextTokenPrediction):
    read_sections = READ_SECTIONS + ("teacher_model", "kd")
    runs_parallel = False  # a distributed: section past one device is refused

    def setup(self) -> None:
        cfg = self.cfg
        if cfg.get("teacher", None) is not None:
            raise ValueError(
                "KD recipe: a `teacher:` section is not read; the teacher goes under `teacher_model:` "
                "(hf_config or pretrained_model_name_or_path, and backend)"
            )
        if cfg.get("teacher_model", None) is None:
            raise ValueError("KD recipe requires a `teacher_model:` section")
        if cfg.get("peft", None) is not None:
            raise ValueError("KD recipe: peft (LoRA adapters on the student) is not ported to the torch backend yet")
        lcfg = dict(_plain(cfg.get("loss_fn", None)) or {})
        lcfg.pop("_target_", None)
        if lcfg and lcfg != {"name": "masked_ce"}:
            raise ValueError(
                f"KD recipe: loss_fn {lcfg} is not read; the blend's CE is masked_ce over the full logits"
            )
        super().setup()

    def _make_loss_fn(self):
        cfg = self.cfg
        tcfg = _plain(cfg.teacher_model)
        unknown = sorted(set(tcfg) - set(TEACHER_KEYS))
        if unknown:
            raise ValueError(f"teacher_model keys {unknown} are not ported to the torch backend (it takes {TEACHER_KEYS})")
        self.teacher = build_auto_from_model_section(
            tcfg, self.device, seed=int(cfg.get("seed", 42)) + 100, trainable=False
        )
        self.teacher.model.eval()
        s_vocab, t_vocab = self.model.config.vocab_size, self.teacher.model.config.vocab_size
        if s_vocab != t_vocab:
            raise ValueError(f"KD recipe: the teacher's vocab_size {t_vocab} differs from the student's {s_vocab}")
        kd = dict(_plain(cfg.get("kd", None)) or {})
        unknown = sorted(set(kd) - set(KD_KEYS))
        if unknown:
            raise ValueError(f"kd keys {unknown} are not ported to the torch backend (it takes {list(KD_KEYS)})")
        ratio = float(kd.get("ratio", 0.5))
        temperature = float(kd.get("temperature", 1.0))
        logger.info("KD: ratio=%.2f temperature=%.2f", ratio, temperature)
        return make_kd_loss(self.model, self.teacher.model, ratio, temperature)


def main(cfg: Any) -> dict:
    recipe = KDRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    return recipe.run_train_validation_loop()
