"""The ``generation:`` config section and the model builder the ``serve``
CLI uses.

Port of ``GenerationConfig`` (:44), ``build_auto_from_model_section``
(:315) and ``build_auto_from_cfg`` (:342) of
``automodel_tpu/generation/engine.py``. The single-wave
``GenerationEngine`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from automodel_tpu_torch.generation.sampling import SamplingConfig


class GenerationUnsupported(ValueError):
    """The model family has no KV-cache decode path."""


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """The `generation:` YAML section."""

    max_new_tokens: int = 64
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False
    eos_token_id: Any = None  # int | [int] | None
    pad_token_id: int = 0
    seed: int = 0

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "GenerationConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        if d.get("tokenizer") is not None:
            raise ValueError(
                "generation.tokenizer is not ported to the torch backend: "
                "prompts are token ids"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def eos_ids(self) -> tuple:
        e = self.eos_token_id
        if e is None:
            return ()
        return tuple(int(x) for x in e) if isinstance(e, (list, tuple)) else (int(e),)

    @property
    def sampling(self) -> SamplingConfig:
        return SamplingConfig(
            temperature=0.0 if self.greedy else self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
        )


def model_max_positions(mcfg: Any) -> Optional[int]:
    v = getattr(mcfg, "max_position_embeddings", None)
    return int(v) if v else None


def build_auto_from_model_section(mcfg: Any, device: Any, seed: int = 0, trainable: bool = False) -> Any:
    """AutoModel from a ``model:``-shaped section on ``device``:
    ``pretrained_model_name_or_path`` (a local HF checkpoint directory) or
    ``hf_config`` (random weights from ``seed``), with ``backend``;
    ``trainable`` for the finetune recipe."""
    from automodel_tpu_torch import auto_model

    get = mcfg.get if hasattr(mcfg, "get") else dict(mcfg).get
    backend = get("backend", {}) or {}
    backend = backend.to_dict() if hasattr(backend, "to_dict") else dict(backend)
    if get("pretrained_model_name_or_path"):
        return auto_model.from_pretrained(
            get("pretrained_model_name_or_path"), backend, device=device, trainable=trainable
        )
    hf = get("hf_config")
    if hf is None:
        raise ValueError("model section needs pretrained_model_name_or_path or hf_config")
    return auto_model.from_config(
        hf.to_dict() if hasattr(hf, "to_dict") else dict(hf), backend,
        device=device, seed=seed, trainable=trainable,
    )


def build_auto_from_cfg(cfg: Any) -> Any:
    """Model from the YAML's ``model:`` section on the top-level ``device``
    (``cuda`` unless the config says ``cpu``). A ``distributed:`` section
    asking for more than one device is refused: the port runs one device."""
    dist = cfg.get("distributed", None) or {}
    many = {
        k: v for k, v in dict(dist).items()
        if k in ("dp_replicate", "dp_shard", "tp", "cp", "pp", "ep") and v not in (None, 1, -1)
    }
    if many:
        raise ValueError(
            f"distributed: {many} is not ported to the torch backend (one device only)"
        )
    return build_auto_from_model_section(
        cfg.model, cfg.get("device", None), seed=cfg.get("seed", 0)
    )
