"""Dense-transformer config and the backend choices the port takes.

Port of ``automodel_tpu/models/common/config.py``. ``BackendConfig`` keeps
the attention backend and the param and compute dtypes; ``attn`` is
``sdpa`` (plain torch) or ``flash`` (the flash-attention kernels,
ops/ring_flash.py) for the no-cache forward that training runs.
``experts`` names the MoE experts backend (default ``gspmd``, as in JAX;
an MoE model runs ``ragged``, the grouped-matmul kernels, ``ragged_fused``,
the fused expert-MLP kernels, or ``dense``, and raises naming any other)
and ``fake_balanced_gate`` swaps the router for deterministic balanced
routing. ``remat`` is the activation-recompute policy of each decoder
layer (``none | full | selective | full_save_dispatch``,
models/common/stacking.py). ``scan_layers`` is accepted and changes
nothing: the port always loops over the layers' ``nn.ModuleList``, JAX's
unrolled path, whose numbers are the scanned path's. ``attn_block_q`` and
``attn_block_kv`` take only JAX's default, 512 (in JAX it leaves splash's
tiles to its tuning table), and change nothing: the flash kernels' tiles
are fixed by their template (csrc/flash_attention.cu), so any other value,
which would ask for a tiling, is refused. ``TransformerConfig.from_hf`` reads the rope
scaling (yarn included), an explicit ``head_dim``, ``attention_bias``, the
sliding window and ``partial_rotary_factor`` (Phi-3: only the first
``rope_dim`` channels of a head rotate). Any other attention value, or any
key the JAX backend has but the port does not (``fp8``, ``fp8_experts``,
``cp_zigzag``, ``pp_microbatches``, ...), is refused rather than ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from automodel_tpu_torch.models.common.stacking import REMAT_POLICIES
from automodel_tpu_torch.ops.rope import RopeConfig

ATTN_BACKENDS = ("sdpa", "flash")
# every experts backend the JAX package names; moe/experts.py runs the first
# three and refuses the rest by name
EXPERTS_NAMES = ("dense", "ragged", "ragged_fused", "gspmd", "a2a", "a2a_fused")

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_from_str(s: str | torch.dtype) -> torch.dtype:
    if isinstance(s, torch.dtype):
        return s
    return _DTYPES[str(s).replace("torch.", "").replace("jnp.", "")]


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    attn: str = "sdpa"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    experts: str = "gspmd"
    fake_balanced_gate: bool = False
    remat: str = "none"
    scan_layers: bool = True
    attn_block_q: int = 512
    attn_block_kv: int = 512

    def __post_init__(self):
        if self.experts not in EXPERTS_NAMES:
            raise ValueError(f"backend.experts={self.experts!r} (want one of {list(EXPERTS_NAMES)})")
        if self.attn not in ATTN_BACKENDS:
            raise ValueError(
                f"backend.attn={self.attn!r} is not ported to the torch backend "
                f"(it takes {list(ATTN_BACKENDS)})"
            )
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"Unknown remat policy {self.remat!r} (want one of {list(REMAT_POLICIES)})")
        for key in ("attn_block_q", "attn_block_kv"):
            value = getattr(self, key)
            if isinstance(value, bool) or value != 512:
                raise ValueError(
                    f"backend.{key}={value!r}: the torch backend takes only JAX's default 512, since the flash "
                    "kernels' tiles are fixed by their template (csrc/flash_attention.cu)"
                )
        for key in ("param_dtype", "compute_dtype"):
            if getattr(self, key) not in _DTYPES:
                raise ValueError(f"backend.{key}={getattr(self, key)!r} (want {sorted(_DTYPES)})")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "BackendConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"backend keys {sorted(unknown)} are not ported to the torch "
                f"backend (it takes {sorted(known)})"
            )
        return cls(**d)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return dtype_from_str(self.param_dtype)

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return dtype_from_str(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Llama-family dense transformer hyperparameters, HF-ingestible."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope: RopeConfig = RopeConfig()
    rms_eps: float = 1e-6
    max_position_embeddings: int = 8192
    tie_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    act: str = "silu"
    embed_scale: float = 1.0  # gemma multiplies embeddings by sqrt(hidden)
    logits_soft_cap: Optional[float] = None
    attn_soft_cap: Optional[float] = None
    sliding_window: Optional[int] = None
    # HF qwen2 convention: the first `max_window_layers` layers attend fully
    max_window_layers: int = 0
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    # Phi-3 / GLM-4 partial rotary: only the first head_dim * factor
    # channels rotate
    partial_rotary_factor: float = 1.0

    @classmethod
    def from_hf(cls, hf_cfg: Any) -> "TransformerConfig":
        """Ingest an HF transformers config (LlamaConfig/Qwen2Config/...)."""
        get = lambda k, d=None: (
            hf_cfg.get(k, d) if isinstance(hf_cfg, dict) else getattr(hf_cfg, k, d)
        )
        heads = get("num_attention_heads")
        hidden = get("hidden_size")
        model_type = get("model_type", "llama")
        return cls(
            vocab_size=get("vocab_size"),
            hidden_size=hidden,
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=heads,
            num_kv_heads=get("num_key_value_heads", heads),
            head_dim=get("head_dim") or hidden // heads,
            rope=RopeConfig.from_hf(hf_cfg),
            rms_eps=get("rms_norm_eps", 1e-6),
            max_position_embeddings=get("max_position_embeddings", 8192),
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            attention_bias=bool(get("attention_bias", model_type in ("qwen2", "qwen2_moe"))),
            mlp_bias=bool(get("mlp_bias", False)),
            qk_norm=model_type in ("qwen3", "qwen3_moe"),
            act=get("hidden_act", "silu"),
            sliding_window=(
                get("sliding_window", None)
                if get("use_sliding_window", model_type in ("mistral", "mixtral", "phi3"))
                else None
            ),
            max_window_layers=get("max_window_layers", 0) or 0,
            partial_rotary_factor=get("partial_rotary_factor", 1.0) or 1.0,
        )

    @property
    def rope_dim(self) -> Optional[int]:
        """Rotary channel count when partial (None: the whole head_dim)."""
        if self.partial_rotary_factor and self.partial_rotary_factor < 1.0:
            return int(self.head_dim * self.partial_rotary_factor)
        return None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim
