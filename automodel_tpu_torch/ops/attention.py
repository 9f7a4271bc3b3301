"""Cache-attending attention in plain torch, port of the ``repeat_kv`` /
``sdpa`` / ``sdpa_decode`` part of ``automodel_tpu/ops/attention.py``.

The same arithmetic as the JAX code: einsum logits in fp32, scale, soft
cap, mask with ``DEFAULT_MASK_VALUE``, fp32 softmax, probabilities cast to
q's dtype before the value product. Chunked prefill and the gather decode
backend run through ``sdpa_decode``; it is the plain reference the paged
kernel is held to, not a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, N_kv, H] → [B, S, N_kv*n_rep, H] (GQA expansion)."""
    if n_rep == 1:
        return x
    b, s, nkv, h = x.shape
    return x[:, :, :, None, :].expand(b, s, nkv, n_rep, h).reshape(b, s, nkv * n_rep, h)


def sdpa_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: torch.Tensor,
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Attention of q over a cache. q: [B, Sq, N, H]; k/v: [B, C, Nkv, H];
    kv_mask: [B, C] (one mask for every query) or [B, Sq, C] (per-query,
    the chunked-prefill form). The mask already encodes causality and any
    window, so no causal mask is applied here. → [B, Sq, N, H] in q.dtype."""
    n, h = q.shape[2], q.shape[3]
    n_kv = k.shape[2]
    k = repeat_kv(k, n // n_kv)
    v = repeat_kv(v, n // n_kv)
    scale = scale if scale is not None else 1.0 / (h**0.5)
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = kv_mask[:, None, :, :] if kv_mask.dim() == 3 else kv_mask[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, DEFAULT_MASK_VALUE))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v.to(q.dtype))
