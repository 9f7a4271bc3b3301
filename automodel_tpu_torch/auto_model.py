"""AutoModel entry point, port of ``automodel_tpu/auto_model.py``
``from_config``: a model built on its device with random weights from a
seeded ``torch.Generator`` on that device. ``from_pretrained`` is not
ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from automodel_tpu_torch.device import resolve_device
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.registry import resolve_architecture


@dataclasses.dataclass
class AutoModel:
    """A built model on its device."""

    model: Any
    device: torch.device
    hf_config: Optional[dict] = None

    @property
    def config(self):
        return self.model.config


def _as_backend(backend: BackendConfig | dict | None) -> BackendConfig:
    if backend is None:
        return BackendConfig()
    if isinstance(backend, BackendConfig):
        return backend
    return BackendConfig.from_dict(dict(backend))


def from_config(
    hf_config: Any,
    backend: BackendConfig | dict | None = None,
    device: str | torch.device | None = None,
    seed: int = 0,
    trainable: bool = False,
) -> AutoModel:
    """Random-init constructor. ``device`` defaults to CUDA (and raises
    without it); the weights are drawn on that device from
    ``torch.Generator(device).manual_seed(seed)``. ``trainable`` builds the
    parameters with ``requires_grad`` (the finetune recipe); serving builds
    them frozen."""
    dev = resolve_device(device)
    model = resolve_architecture(hf_config)(
        hf_config, _as_backend(backend), device=dev, trainable=trainable
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    model.init_weights(gen)
    return AutoModel(
        model=model, device=dev,
        hf_config=dict(hf_config) if isinstance(hf_config, dict) else None,
    )
