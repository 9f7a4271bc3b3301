"""HF checkpoint key-conversion mappings, port of
``automodel_tpu/checkpoint/conversion_mapping.py``.

Some checkpoints store keys under other HF conventions than the adapters
read: renames (mixtral's ``block_sparse_moe``, qwen2-moe's singular
``shared_expert``) and fused tensors (``qkv_proj``, ``gate_up_proj``) that
split into the canonical per-projection keys. ``RemappedReader`` wraps
``HFCheckpointReader`` and presents the canonical view, so state-dict
adapters never see the variant layout. It wraps any reader, so the Phi-3
and Mistral aliases need only their registry entries.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Sequence

import torch

from automodel_tpu_torch.checkpoint.hf_io import _TORCH_TO_ST


@dataclasses.dataclass(frozen=True)
class Rename:
    """Key regex rename: canonical key ``sub`` of ``pattern``."""

    pattern: str
    sub: str


@dataclasses.dataclass(frozen=True)
class Split:
    """A fused on-disk tensor serving several canonical keys.

    ``pattern``: regex over the fused on-disk key, with groups usable in the
    target templates. ``targets``: canonical key template → slicer taking
    (fused tensor, sizes dict) → split tensor. ``sizes`` names are resolved
    from the model's HF config by the caller.
    """

    pattern: str
    targets: dict[str, Callable[[torch.Tensor, dict], torch.Tensor]]


# phi3 / fused-qkv style checkpoints: qkv_proj.weight = [q; k; v] rows,
# gate_up_proj.weight = [gate; up] rows (torch Linear [out, in])
FUSED_QKV = Split(
    pattern=r"^(?P<p>.*\.self_attn\.)qkv_proj\.weight$",
    targets={
        r"\g<p>q_proj.weight": lambda a, s: a[: s["q"]],
        r"\g<p>k_proj.weight": lambda a, s: a[s["q"] : s["q"] + s["kv"]],
        r"\g<p>v_proj.weight": lambda a, s: a[s["q"] + s["kv"] :],
    },
)
FUSED_GATE_UP = Split(
    pattern=r"^(?P<p>.*\.mlp\.)gate_up_proj\.weight$",
    targets={
        r"\g<p>gate_proj.weight": lambda a, s: a[: a.shape[0] // 2],
        r"\g<p>up_proj.weight": lambda a, s: a[a.shape[0] // 2 :],
    },
)


class RemappedReader:
    """Reader wrapper presenting canonical keys over a variant checkpoint."""

    def __init__(
        self,
        reader: Any,
        renames: Sequence[Rename] = (),
        splits: Sequence[Split] = (),
        sizes: Optional[dict] = None,
    ):
        self.reader = reader
        self.sizes = sizes or {}
        self._rename_to_raw: dict[str, str] = {}
        self._split_sources: dict[str, tuple[str, Callable]] = {}
        raw_keys = list(reader.keys())
        consumed: set[str] = set()
        for raw in raw_keys:
            for r in renames:
                if re.match(r.pattern, raw):
                    self._rename_to_raw[re.sub(r.pattern, r.sub, raw)] = raw
                    consumed.add(raw)
                    break
            for sp in splits:
                m = re.match(sp.pattern, raw)
                if m:
                    for tmpl, slicer in sp.targets.items():
                        self._split_sources[m.expand(tmpl)] = (raw, slicer)
                    consumed.add(raw)
        self._passthrough = [k for k in raw_keys if k not in consumed]

    def keys(self) -> list[str]:
        return (
            self._passthrough
            + list(self._rename_to_raw)
            + list(self._split_sources)
        )

    def get_tensor(self, key: str) -> torch.Tensor:
        if key in self._split_sources:
            raw, slicer = self._split_sources[key]
            return slicer(self.reader.get_tensor(raw), self.sizes).contiguous()
        raw = self._rename_to_raw.get(key, key)
        return self.reader.get_tensor(raw)

    def info(self, key: str):
        if key in self._split_sources:
            t = self.get_tensor(key)
            return _TORCH_TO_ST[t.dtype], tuple(t.shape)
        return self.reader.info(self._rename_to_raw.get(key, key))

    def close(self) -> None:
        self.reader.close()


# mixtral stores the MoE block as block_sparse_moe with w1/w3/w2 experts —
# rename to the canonical qwen3-moe-style keys the MoE adapter reads
MIXTRAL_RENAMES = (
    Rename(r"^(.*\.)block_sparse_moe\.gate\.weight$", r"\1mlp.gate.weight"),
    # MiniMax-M2 keeps the mixtral block layout and adds the DeepSeek-style
    # aux-free correction bias on the router
    Rename(
        r"^(.*\.)block_sparse_moe\.gate\.e_score_correction_bias$",
        r"\1mlp.gate.e_score_correction_bias",
    ),
    Rename(
        r"^(.*\.)block_sparse_moe\.experts\.(\d+)\.w1\.weight$",
        r"\1mlp.experts.\2.gate_proj.weight",
    ),
    Rename(
        r"^(.*\.)block_sparse_moe\.experts\.(\d+)\.w3\.weight$",
        r"\1mlp.experts.\2.up_proj.weight",
    ),
    Rename(
        r"^(.*\.)block_sparse_moe\.experts\.(\d+)\.w2\.weight$",
        r"\1mlp.experts.\2.down_proj.weight",
    ),
)

# qwen2-moe: singular shared_expert → the adapter's shared_experts keys
QWEN2_MOE_RENAMES = (
    Rename(r"^(.*\.mlp\.)shared_expert\.(.*)$", r"\1shared_experts.\2"),
)


def detect_remaps(reader: Any, hf_config: Optional[dict] = None) -> Optional[RemappedReader]:
    """Wrap `reader` when a known variant layout is detected (fused qkv /
    gate_up, mixtral block_sparse_moe, qwen2-moe shared_expert); None when
    the checkpoint is already canonical."""
    keys = reader.keys()
    get = lambda k, d=None: (hf_config or {}).get(k, d)
    renames: tuple = ()
    if any(".block_sparse_moe." in k for k in keys):
        renames += MIXTRAL_RENAMES
    if any(".mlp.shared_expert." in k for k in keys):
        renames += QWEN2_MOE_RENAMES
    has_fused = any(k.endswith(".self_attn.qkv_proj.weight") for k in keys) or any(
        k.endswith(".mlp.gate_up_proj.weight") for k in keys
    )
    if not has_fused and not renames:
        return None
    heads = get("num_attention_heads") or 1
    head_dim = get("head_dim") or (get("hidden_size", 0) // heads)
    sizes = {
        "q": heads * head_dim,
        "kv": (get("num_key_value_heads") or heads) * head_dim,
    }
    splits = (FUSED_QKV, FUSED_GATE_UP) if has_fused else ()
    return RemappedReader(reader, renames=renames, splits=splits, sizes=sizes)
