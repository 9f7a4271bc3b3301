"""RMSNorm, Gemma's zero-centered RMSNorm and LayerNorm, port of
``automodel_tpu/ops/norms.py``: fp32 accumulation, cast back to the input
dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, cast back to x.dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm_gemma(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm, zero-centered: x̂ · (1 + scale) in fp32, cast
    back to x.dtype."""
    return rms_norm(x, 1.0 + scale.float(), eps)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Full LayerNorm (mean and variance) with fp32 accumulation, cast back
    to x.dtype (JAX :33)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
