"""AutoModel entry points, port of ``automodel_tpu/auto_model.py``:

- ``from_config``: a model built on its device with random weights from a
  seeded ``torch.Generator`` on that device;
- ``from_pretrained``: a model built on its device with uninitialised
  storage, then the weights of a local HF checkpoint directory streamed in
  at the backend's param dtype, one tensor at a time.

A hub id is refused: the JAX package would download it, and the port has
no download path.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
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
    # the checkpoint directory a from_pretrained model came from; the
    # consolidated save copies its tokenizer files
    source_dir: Optional[str] = None
    # the device mesh a parallel entry point sharded the model over
    mesh_ctx: Any = None

    @property
    def config(self):
        return self.model.config

    @property
    def adapter(self):
        """The model family's HF key map over this model's state dict."""
        return self.model.state_dict_adapter(self.model)


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


def _resolve_checkpoint_dir(path_or_id: str | Path) -> Path:
    p = Path(path_or_id)
    if p.is_dir():
        return p
    raise ValueError(
        f"pretrained_model_name_or_path={str(path_or_id)!r} is not a local directory: "
        "loading from the HF hub (a download) is not ported to the torch backend; "
        "give a directory holding config.json and *.safetensors"
    )


def from_pretrained(
    pretrained_model_name_or_path: str | Path,
    backend: BackendConfig | dict | None = None,
    device: str | torch.device | None = None,
    hf_config_overrides: Optional[dict] = None,
    trainable: bool = False,
) -> AutoModel:
    """Load a local HF checkpoint directory (its ``config.json`` and
    safetensors) into the port's model on ``device`` (CUDA unless told
    otherwise). ``hf_config_overrides`` merges keys over the directory's
    ``config.json``. Variant layouts (fused qkv / gate_up, mixtral's
    ``block_sparse_moe``, qwen2-moe's ``shared_expert``) load through the
    conversion mapping; FP8-blockwise and MXFP4 tensors are dequantized to
    bf16 on ``device`` as they are read (``checkpoint/quant_io.py``)."""
    from automodel_tpu_torch.checkpoint.conversion_mapping import detect_remaps
    from automodel_tpu_torch.checkpoint.hf_io import HFCheckpointReader, load_params_from_hf

    ckpt_dir = _resolve_checkpoint_dir(pretrained_model_name_or_path)
    hf_config = json.loads((ckpt_dir / "config.json").read_text())
    if hf_config_overrides:
        hf_config = {**hf_config, **dict(hf_config_overrides)}
    backend = _as_backend(backend)
    dev = resolve_device(device)
    model = resolve_architecture(hf_config)(hf_config, backend, device=dev, trainable=trainable)
    reader = HFCheckpointReader(ckpt_dir, device=dev)
    reader = detect_remaps(reader, hf_config) or reader
    load_params_from_hf(
        model.state_dict_adapter(model), reader, model.state_dict(), dtype=backend.param_torch_dtype
    )
    return AutoModel(model=model, device=dev, hf_config=hf_config, source_dir=str(ckpt_dir))
