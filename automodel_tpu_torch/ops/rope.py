"""Rotary position embeddings, port of ``automodel_tpu/ops/rope.py``.

Rotate-half layout (HF transformers convention). Scalings: none, ``linear``,
``llama3`` and ``yarn`` (GPT-OSS), whose cos and sin carry the attention
factor. As in the JAX package, yarn always floors and ceils the ramp's ends
and ignores HF's ``truncate`` key. ``yarn_mscale`` is the softmax-scale
correction of YaRN models that fold it there (DeepSeek MLA),
``mrope_table`` the interleaved multi-axis tables (Qwen3-VL), and
``apply_rope`` rotates only the table's channels when the table is
narrower than the head (partial rotary, Phi-3 / GLM-4).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    theta: float = 10000.0
    scaling: str | None = None  # None | "llama3" | "linear"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    attention_factor: float | None = None  # HF yarn cos/sin multiplier

    SUPPORTED_SCALINGS = (None, "llama3", "linear", "yarn")

    def __post_init__(self):
        if self.scaling not in self.SUPPORTED_SCALINGS:
            raise ValueError(
                f"Unsupported rope_scaling type {self.scaling!r} in the torch "
                f"port; supported: {self.SUPPORTED_SCALINGS}"
            )

    @staticmethod
    def from_hf(cfg) -> "RopeConfig":
        """Build from an HF config object / dict (rope_scaling conventions)."""
        get = lambda k, d=None: (cfg.get(k, d) if isinstance(cfg, dict) else getattr(cfg, k, d))
        rs = get("rope_scaling") or {}
        rtype = rs.get("rope_type", rs.get("type"))
        return RopeConfig(
            theta=get("rope_theta", 10000.0),
            scaling=None if rtype in (None, "default") else rtype,
            factor=rs.get("factor", 1.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position=rs.get(
                "original_max_position_embeddings", get("max_position_embeddings", 8192)
            ),
            beta_fast=rs.get("beta_fast", 32.0),
            beta_slow=rs.get("beta_slow", 1.0),
            mscale=rs.get("mscale", 1.0),
            mscale_all_dim=rs.get("mscale_all_dim", 0.0),
            attention_factor=rs.get("attention_factor"),
        )


def inv_freq(head_dim: int, cfg: RopeConfig, device=None) -> torch.Tensor:
    """[head_dim // 2] fp32 inverse frequencies, scaling applied."""
    inv = 1.0 / (
        cfg.theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    if cfg.scaling == "linear":
        inv = inv / cfg.factor
    elif cfg.scaling == "llama3":
        # HF Llama-3 frequency-dependent scaling
        low = cfg.original_max_position / cfg.low_freq_factor
        high = cfg.original_max_position / cfg.high_freq_factor
        wavelen = 2 * math.pi / inv
        smooth = (cfg.original_max_position / wavelen - cfg.low_freq_factor) / (
            cfg.high_freq_factor - cfg.low_freq_factor
        )
        inv = torch.where(
            wavelen < high,
            inv,
            torch.where(
                wavelen > low, inv / cfg.factor, (1 - smooth) * inv / cfg.factor + smooth * inv
            ),
        )
    elif cfg.scaling == "yarn":
        # the DeepSeek/Qwen YaRN ramp (JAX :86-100)
        def find_dim(n_rot: float) -> float:
            return (head_dim * math.log(cfg.original_max_position / (n_rot * 2 * math.pi))) / (
                2 * math.log(cfg.theta)
            )

        low = max(math.floor(find_dim(cfg.beta_fast)), 0)
        high = min(math.ceil(find_dim(cfg.beta_slow)), head_dim - 1)
        ramp = torch.clamp(
            (torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low) / max(high - low, 1e-3), 0, 1
        )
        inv = inv / cfg.factor * ramp + inv * (1 - ramp)
    return inv


def attention_factor(cfg: RopeConfig) -> float:
    """HF yarn multiplies cos and sin by ``attention_factor``, 0.1 ln(factor)
    + 1 when unset (JAX ``_attention_factor``, :106-116); 1 otherwise."""
    if cfg.scaling != "yarn":
        return 1.0
    if cfg.attention_factor is not None:
        return cfg.attention_factor
    return 0.1 * math.log(cfg.factor) + 1.0 if cfg.factor > 1.0 else 1.0


def yarn_mscale(cfg: RopeConfig) -> float:
    """The attention magnitude correction of YaRN models that fold it into
    the softmax scale (DeepSeek MLA; JAX :119): 1 unless yarn with factor >
    1."""
    if cfg.scaling != "yarn" or cfg.factor <= 1.0:
        return 1.0

    def get(scale: float) -> float:
        return 0.1 * scale * math.log(cfg.factor) + 1.0 if scale > 0 else 1.0

    return get(cfg.mscale) / get(cfg.mscale_all_dim)


def rope_table(
    position_ids: torch.Tensor, head_dim: int, cfg: RopeConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., seq, head_dim] for given positions (fp32)."""
    inv = inv_freq(head_dim, cfg, device=position_ids.device)
    freqs = position_ids[..., None].float() * inv  # [..., S, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    f = attention_factor(cfg)
    return torch.cos(emb) * f, torch.sin(emb) * f


def mrope_table(
    position_ids: torch.Tensor, head_dim: int, cfg: RopeConfig, mrope_section: tuple[int, int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved multi-axis RoPE (Qwen3-VL; JAX :141): position_ids [3, B,
    S] are the t/h/w grid positions; frequency slot i takes the h axis when
    i = 1 (mod 3) and i < 3 * section_h, the w axis when i = 2 (mod 3) and i
    < 3 * section_w, else the t axis. → cos/sin [B, S, head_dim] (fp32)."""
    inv = inv_freq(head_dim, cfg, device=position_ids.device)
    freqs = position_ids[..., None].float() * inv  # [3, B, S, hd/2]
    i = torch.arange(head_dim // 2, device=position_ids.device)
    take_h = (i % 3 == 1) & (i < 3 * mrope_section[1])
    take_w = (i % 3 == 2) & (i < 3 * mrope_section[2])
    half = torch.where(take_h, freqs[1], freqs[0])
    half = torch.where(take_w, freqs[2], half)
    emb = torch.cat([half, half], dim=-1)
    f = attention_factor(cfg)
    return torch.cos(emb) * f, torch.sin(emb) * f


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[x0, y0, x1, y1, ...] → [x0, x1, ..., y0, y1, ...] on the last dim."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleave: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply rotate-half RoPE in q's dtype. q/k: [B, S, N, H]; cos/sin:
    [B, S, R]. With R < H (partial rotary) only the first R channels
    rotate and the rest pass through, as HF's apply_rotary_pos_emb slices
    (JAX :163-200). ``interleave``: the checkpoint stores the rotary
    channels pair-interleaved (DeepSeek MLA's ``rope_interleave``), so
    they are de-interleaved before the rotation, as JAX's are."""
    rotary_dim = cos.shape[-1]
    c = cos[..., None, :].to(q.dtype)
    s = sin[..., None, :].to(q.dtype)
    if interleave:
        if rotary_dim != q.shape[-1]:
            raise ValueError("interleaved RoPE rotates the whole of q and k (the MLA block's rope parts)")
        q, k = _deinterleave(q), _deinterleave(k)
    if rotary_dim == q.shape[-1]:
        return q * c + _rotate_half(q) * s, k * c + _rotate_half(k) * s
    (qr, q_pass), (kr, k_pass) = (x.split([rotary_dim, x.shape[-1] - rotary_dim], dim=-1) for x in (q, k))
    return (
        torch.cat([qr * c + _rotate_half(qr) * s, q_pass], dim=-1),
        torch.cat([kr * c + _rotate_half(kr) * s, k_pass], dim=-1),
    )
