"""Offline DCP → consolidated-HF conversion, port of
``automodel_tpu/checkpoint/consolidate.py``: turn a training run's step dir
into an HF model dir without re-running the recipe.

Usage:
    python -m automodel_tpu_torch.checkpoint.consolidate <step_dir> <out_dir> [--device=cpu]

``step_dir`` is an ``epoch_E_step_S`` directory holding ``state/`` (DCP)
and ``config.json`` (the recipe config written at save time). The model is
built from that config on ``device`` (CUDA unless ``--device=cpu``), only
the state's ``model`` entries are read into it, and the adapter writes HF
safetensors plus the add-ons.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def consolidate(step_dir: str | Path, out_dir: str | Path, device: str | None = None) -> Path:
    from automodel_tpu_torch.checkpoint.addons import write_hf_addons
    from automodel_tpu_torch.checkpoint.checkpointer import _dcp_load
    from automodel_tpu_torch.checkpoint.hf_io import save_hf_checkpoint
    from automodel_tpu_torch.device import resolve_device
    from automodel_tpu_torch.models.common.config import BackendConfig
    from automodel_tpu_torch.models.registry import resolve_architecture

    dev = resolve_device(device)
    step_dir = Path(step_dir)
    snap = json.loads((step_dir / "config.json").read_text())
    mcfg = snap.get("model", {})
    hf_config = mcfg.get("hf_config")
    source_dir = None
    if hf_config is None:
        # from_pretrained runs: read the source checkpoint's config
        source_dir = mcfg.get("pretrained_model_name_or_path")
        cfg_file = Path(source_dir or "") / "config.json"
        if not cfg_file.exists():
            raise FileNotFoundError(
                "config snapshot has no model.hf_config and the source dir "
                f"config is unavailable ({cfg_file})"
            )
        hf_config = json.loads(cfg_file.read_text())
    backend = BackendConfig.from_dict({k: v for k, v in dict(mcfg.get("backend", {}) or {}).items() if k != "_target_"})
    model = resolve_architecture(hf_config)(hf_config, backend, device=dev)
    sd = model.state_dict()
    # DCP reads only the entries the target names: the model, not the moments
    _dcp_load(step_dir / "state", {"model": sd})
    out = Path(out_dir)
    save_hf_checkpoint(out, model.state_dict_adapter(model).to_hf(sd))
    write_hf_addons(out, hf_config=hf_config, source_dir=source_dir)
    return out


def main(argv: list[str]) -> int:
    devices = [a.split("=", 1)[1] for a in argv if a.startswith("--device=")]
    paths = [a for a in argv if not a.startswith("--device=")]
    if len(paths) != 2 or len(devices) > 1:
        print(__doc__)
        return 2
    out = consolidate(paths[0], paths[1], device=devices[0] if devices else None)
    print(f"consolidated HF checkpoint written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
