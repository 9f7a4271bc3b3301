"""Attention backends, port of ``automodel_tpu/ops/attention.py``.

- ``sdpa``: plain torch scaled dot-product attention in the JAX arithmetic
  (einsum logits in fp32, scale, soft cap, mask with
  ``DEFAULT_MASK_VALUE``, fp32 softmax, probabilities cast to q's dtype
  before the value product), with gpt-oss sinks as an extra softmax
  column. It is the reference the flash kernels' plain version is held to;
  chunked prefill and the gather decode backend run through ``sdpa_decode``.
  ``bidir_groups`` ORs a bidirectional mask over token groups (Gemma 3's
  image blocks) onto the causal and window mask.
- ``flash``: the flash-attention kernels of ``ops/ring_flash.py``
  (``csrc/flash_attention.cu`` on a CUDA tensor, their plain version on a
  CPU tensor), with the logits soft cap applied inside them (Gemma 2) and
  sinks folded around them (gpt-oss), at head_dim 64, 128 and 256. It
  never goes to ``sdpa``: what the kernels do not take (another head_dim,
  another dtype on the card) raises.

``windowed_attention`` is the entry of the layer stacks that mix full and
windowed layers (Gemma 2/3): the layer's flag picks its window. A call
with ``bidir_groups`` runs under ``sdpa`` and raises under ``flash``: the
mask depends on the data and the flash kernels mask by position only
(JAX runs such a call on sdpa rather than splash, :421-460).

The JAX ``ring`` backend waits for the context-parallel port.
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


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    kv_mask: Optional[torch.Tensor] = None,
    sinks: Optional[torch.Tensor] = None,
    bidir_groups: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q [B, Sq, N, H], k/v [B, Sk, Nkv, H] → [B, Sq, N, H] in q.dtype.
    Causal and window masks align the last query with the last key, as in
    JAX; ``segment_ids`` [B, S] keep packed documents apart; ``kv_mask``
    [B, Sk] (one mask for every query) or [B, Sq, Sk] ANDs onto the rest.
    ``sinks`` [N]: per-head learned logits of a virtual key that absorbs
    probability mass (gpt-oss): a column of the softmax, dropped after it
    (:110-117). ``bidir_groups`` [B, S] int group ids, -1 for ordinary
    tokens: tokens of one nonnegative group see each other both ways, ORed
    onto the causal and window mask before the segment mask (:97-100)."""
    sq, n, h = q.shape[1], q.shape[2], q.shape[3]
    sk, n_kv = k.shape[1], k.shape[2]
    k = repeat_kv(k, n // n_kv)
    v = repeat_kv(v, n // n_kv)
    scale = scale if scale is not None else 1.0 / (h**0.5)
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask, diagonal=sk - sq)
    if sliding_window is not None:
        pos_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        pos_k = torch.arange(sk, device=q.device)[None, :]
        mask = mask & (pos_q - pos_k < sliding_window)
    mask = mask[None, None]
    if bidir_groups is not None:
        gq = bidir_groups[:, None, :, None]
        gk = bidir_groups[:, None, None, :]
        mask = mask | ((gq >= 0) & (gq == gk))
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None] == segment_ids[:, None, None, :])
    if kv_mask is not None:
        mask = mask & (kv_mask[:, None, :, :] if kv_mask.dim() == 3 else kv_mask[:, None, None, :])
    logits = torch.where(mask, logits, torch.full_like(logits, DEFAULT_MASK_VALUE))
    if sinks is not None:
        sink_col = sinks.float()[None, :, None, None].expand(logits.shape[0], n, sq, 1)
        probs = torch.softmax(torch.cat([logits, sink_col], dim=-1), dim=-1)[..., :-1].to(q.dtype)
    else:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v.to(q.dtype))


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
    return sdpa(q, k, v, causal=False, scale=scale, logits_soft_cap=logits_soft_cap, kv_mask=kv_mask)


def flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention through ``ops/ring_flash.flash_attention``: the CUDA
    kernels for CUDA tensors, their plain version for CPU tensors, the
    logits soft cap applied inside them and sinks folded around them."""
    from automodel_tpu_torch.ops import ring_flash

    return ring_flash.flash_attention(
        q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
        sliding_window=sliding_window, sinks=sinks, soft_cap=logits_soft_cap,
    )


ATTENTION_BACKENDS = {"sdpa": sdpa, "flash": flash}


def windowed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    backend: str,
    is_sliding: bool,
    window: Optional[int],
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    bidir_groups: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of one layer of a stack that mixes full and windowed
    layers (JAX :421): ``window`` when ``is_sliding``, else none, through
    ``backend``. ``bidir_groups`` (a mask that depends on the data) is
    taken by ``sdpa`` only: the flash kernels mask by position alone, so
    under ``flash`` it raises rather than leave the kernels."""
    kw = dict(
        causal=causal, scale=scale, segment_ids=segment_ids, logits_soft_cap=logits_soft_cap,
        sliding_window=window if is_sliding else None, sinks=sinks,
    )
    fn = _backend_fn(backend)
    if bidir_groups is not None:
        if fn is not sdpa:
            raise ValueError(
                f"bidir_groups (a bidirectional mask over token groups, which depends on the data) is not "
                f"taken by the {backend!r} backend: its kernels mask by position only; use attn: sdpa"
            )
        kw["bidir_groups"] = bidir_groups
    return fn(q, k, v, **kw)


def _backend_fn(backend: str):
    fn = ATTENTION_BACKENDS.get(backend)
    if fn is None:
        raise ValueError(
            f"Unknown attention backend {backend!r}; the torch backend has {sorted(ATTENTION_BACKENDS)} "
            "(ring waits for the context-parallel port)"
        )
    return fn


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, backend: str = "sdpa", **kwargs) -> torch.Tensor:
    """Dispatch on ``backend`` (``sdpa`` | ``flash``); anything else raises."""
    return _backend_fn(backend)(q, k, v, **kwargs)
