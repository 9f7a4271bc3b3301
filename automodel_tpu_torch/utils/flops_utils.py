"""FLOP laws and MFU, port of ``automodel_tpu/utils/flops_utils.py``.

The laws are the JAX module's, copied as they are
(``dense_transformer_flops_per_token`` :42-69, ``avg_attended_context``
:72-79, ``moe_transformer_flops_per_token`` :82-126,
``flops_per_token_for_config`` :129-164, ``calculate_mfu`` :234-242): the
dense law counts every layer at full causal attention, windows included;
the MoE law counts windowed layers by their attended pairs. The pipeline
bubble laws are not ported yet.

The peak is keyed by ``torch.cuda.get_device_name``. The table holds one
card, the dense BF16 peak of the H100 SXM (JAX's ``_H100_PEAK_TFLOPS``,
:26); any other name, and a CPU device, give NaN, and the benchmark then
reports ``mfu: null`` rather than a ratio over a guessed peak.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

# dense BF16 tensor-core peak, TFLOP/s, by torch.cuda.get_device_name
GPU_PEAK_BF16_TFLOPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def device_peak_tflops(device: Any = None) -> float:
    """Peak BF16 TFLOP/s of ``device`` (default: the current CUDA device,
    when there is one). A name the table lacks, or a CPU device, → NaN."""
    if device is None:
        if not torch.cuda.is_available():
            return float("nan")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return float("nan")
    return GPU_PEAK_BF16_TFLOPS.get(torch.cuda.get_device_name(device), float("nan"))


def dense_transformer_flops_per_token(
    hidden_size: int,
    num_layers: int,
    intermediate_size: int,
    vocab_size: int,
    seq_len: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    num_gated_linear: int = 3,
    causal: bool = True,
) -> float:
    """Training FLOPs per token (fwd + bwd = 3x the forward's matmul
    FLOPs) of a dense llama-style decoder."""
    q_dim = num_heads * head_dim
    kv_dim = num_kv_heads * head_dim
    # per-token forward matmul MACs x2 = FLOPs
    attn_proj = 2 * (hidden_size * (q_dim + 2 * kv_dim) + q_dim * hidden_size)
    # attention scores and values: 2 matmuls of [S, H]x[H, S]; causal halves them
    attn_sdp = 2 * 2 * q_dim * seq_len * (0.5 if causal else 1.0)
    mlp = 2 * num_gated_linear * hidden_size * intermediate_size
    per_layer = attn_proj + attn_sdp + mlp
    lm_head = 2 * hidden_size * vocab_size
    fwd = num_layers * per_layer + lm_head
    return 3.0 * fwd


def avg_attended_context(seq_len: int, window: Optional[int] = None) -> float:
    """Average attended positions per token under a causal mask, with a
    sliding window if given: w(w+1)/2 + (S-w)·w attended pairs over S."""
    if window is not None and window < seq_len:
        pairs = window * (window + 1) / 2 + (seq_len - window) * window
        return pairs / seq_len
    return seq_len * 0.5


def moe_transformer_flops_per_token(
    hidden_size: int,
    num_layers: int,
    moe_intermediate_size: int,
    num_active_experts: int,
    shared_expert_intermediate: int,
    vocab_size: int,
    seq_len: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    dense_intermediate_size: int = 0,
    num_dense_layers: int = 0,
    causal: bool = True,
    layer_windows: Optional[list] = None,
) -> float:
    """Training FLOPs per token of an MoE decoder: only the active experts
    count. ``layer_windows`` gives each layer's sliding window (None: full
    attention); a windowed layer attends ~window positions, not seq/2."""
    q_dim = num_heads * head_dim
    kv_dim = num_kv_heads * head_dim
    attn_proj = 2 * (hidden_size * (q_dim + 2 * kv_dim) + q_dim * hidden_size)
    if layer_windows is None:
        layer_windows = [None] * num_layers
    attn_sdp_total = sum(
        2 * 2 * q_dim * (avg_attended_context(seq_len, w) if causal else seq_len)
        for w in layer_windows
    )
    moe_mlp = 2 * 3 * hidden_size * (
        moe_intermediate_size * num_active_experts + shared_expert_intermediate
    )
    dense_mlp = 2 * 3 * hidden_size * dense_intermediate_size
    n_moe = num_layers - num_dense_layers
    fwd = (
        num_layers * attn_proj
        + attn_sdp_total
        + n_moe * moe_mlp
        + num_dense_layers * dense_mlp
        + 2 * hidden_size * vocab_size
    )
    return 3.0 * fwd


def flops_per_token_for_config(cfg: Any, seq_len: int) -> float:
    """Dispatch on a TransformerConfig-like object (dense or MoE)."""
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        layer_types = getattr(cfg, "layer_types", None) or None
        windows = None
        if layer_types and getattr(cfg, "sliding_window", None):
            windows = [
                cfg.sliding_window if lt == "sliding_attention" else None
                for lt in layer_types
            ]
        return moe_transformer_flops_per_token(
            layer_windows=windows,
            hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers,
            moe_intermediate_size=moe.moe_intermediate_size,
            num_active_experts=moe.num_experts_per_tok,
            shared_expert_intermediate=moe.shared_expert_intermediate_size,
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            dense_intermediate_size=cfg.intermediate_size,
            num_dense_layers=getattr(moe, "num_dense_layers", 0),
        )
    return dense_transformer_flops_per_token(
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers,
        intermediate_size=cfg.intermediate_size,
        vocab_size=cfg.vocab_size,
        seq_len=seq_len,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
    )


def calculate_mfu(
    tokens_per_second_per_chip: float,
    flops_per_token: float,
    peak_tflops: Optional[float] = None,
) -> float:
    """Model FLOPs utilization in [0, 1]."""
    peak = peak_tflops if peak_tflops is not None else device_peak_tflops()
    return tokens_per_second_per_chip * flops_per_token / (peak * 1e12)
