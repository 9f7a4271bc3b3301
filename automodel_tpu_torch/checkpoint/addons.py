"""Consolidated-HF export add-ons, port of
``automodel_tpu/checkpoint/addons.py``: the consolidated ``hf/`` directory
is a self-sufficient HF model dir, with ``config.json``,
``generation_config.json`` and the tokenizer files beside the safetensors
weights. The PEFT adapter export waits for the LoRA port.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional

TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "tokenizer.model",
    "vocab.json",
    "vocab.txt",
    "merges.txt",
    "generation_config.json",
    "preprocessor_config.json",  # VLM processors
    "chat_template.json",
)


def write_hf_addons(
    out_dir: str | Path,
    hf_config: Optional[dict] = None,
    source_dir: Optional[str | Path] = None,
) -> list[str]:
    """Make ``out_dir`` a self-sufficient HF model dir: write config.json
    (from the ingested config) and copy tokenizer/generation artifacts from
    the source checkpoint when available. Returns the file names written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list[str] = []
    if hf_config is not None:
        (out / "config.json").write_text(json.dumps(hf_config, indent=2, default=str))
        written.append("config.json")
    if source_dir is not None:
        src = Path(source_dir)
        for name in TOKENIZER_FILES:
            f = src / name
            if f.exists() and not (out / name).exists():
                shutil.copy2(f, out / name)
                written.append(name)
        if hf_config is None and (src / "config.json").exists():
            shutil.copy2(src / "config.json", out / "config.json")
            written.append("config.json")
    return written
