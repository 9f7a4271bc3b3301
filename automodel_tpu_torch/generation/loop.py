"""Prefill and token-at-a-time decode over the contiguous KV cache.

Port of ``automodel_tpu/generation/loop.py``. Two programs (Pope et al.
§3.1's prefill/generate split):

- **prefill**: the whole padded prompt batch through the model's ordinary
  packed segment-ids attention (pads in segment 0, prompts in segment 1;
  right padding and causality keep real tokens clean), writing every
  layer's post-RoPE K/V into the cache, returning each slot's
  last-real-token logits.
- **decode**: each sampled token fed back through the model with the
  cache, one token per slot a step, RoPE at the slot's own position. JAX's
  ``lax.while_loop`` becomes a Python loop over the same carry and the
  same stop rule: a slot is done once it emits a stop id (later tokens are
  the pad id and are not counted), and the loop ends at
  ``max_new_tokens`` or as soon as every slot is done. The every-slot
  check reads the device only when there are stop ids: without them no
  slot can finish early, and the loop runs without a host sync.

Sampling is ``generation/sampling.py``'s: greedy takes the argmax; a
sampled step draws from a generator seeded by (seed, step), the prefill's
first token being step 0.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from automodel_tpu_torch.generation import kv_cache
from automodel_tpu_torch.generation.sampling import SamplingConfig, sample, step_generator


def _primary(out: Any) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def build_prefill_fn(model) -> Callable:
    """→ ``prefill(input_ids [B, S], lengths [B], cache)`` → ``(last_logits
    [B, V] fp32, cache)``; the returned cache holds the prompt's tags and
    lengths over the same key/value tensors, written in place."""

    @torch.inference_mode()
    def prefill(input_ids: torch.Tensor, lengths: torch.Tensor, cache: kv_cache.KVCache):
        B, S = input_ids.shape
        positions = torch.arange(S, device=input_ids.device)[None, :].expand(B, S)
        segment_ids = (positions < lengths[:, None]).to(torch.int32)
        kvc, ctx = kv_cache.prefill_ctx(cache, S, lengths)
        h = _primary(model.hidden(input_ids, positions, cache=kv_cache.CacheLayers(kvc, ctx),
                                  segment_ids=segment_ids))
        last = h[torch.arange(B, device=h.device), lengths.long() - 1]
        return _primary(model.logits(last)).float(), kvc

    return prefill


def build_decode_fn(
    model,
    sampling: SamplingConfig,
    max_new_tokens: int,
    eos_ids: Sequence[int] = (),
    pad_id: int = 0,
) -> Callable:
    """→ ``decode(cache, first_token [B], seed)`` → ``(result, cache)``.

    ``first_token`` is the token sampled from the prefill logits (generated
    token 0); each step writes the current token's K/V at its slot's
    position and samples the next. ``result`` holds ``tokens`` [B,
    max_new_tokens] int32 (pad past a slot's stop), ``n_generated`` [B]
    and ``steps``, the decode forwards run (the early exit shows here)."""
    eos = torch.tensor([int(e) for e in eos_ids], dtype=torch.int32)

    def is_eos(tok: torch.Tensor) -> torch.Tensor:
        if not len(eos):
            return torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
        return torch.isin(tok, eos.to(tok.device))

    @torch.inference_mode()
    def decode(cache: kv_cache.KVCache, first_token: torch.Tensor, seed: int = 0):
        B = first_token.shape[0]
        dev = first_token.device
        tokens = torch.full((B, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
        tokens[:, 0] = first_token
        done = is_eos(first_token)
        n_gen = torch.ones((B,), dtype=torch.int32, device=dev)
        cur = first_token
        i = 1
        while i < max_new_tokens and not (len(eos) and bool(done.all())):
            cache, ctx = kv_cache.decode_ctx(cache)
            logits = _primary(model(cur[:, None].long(), ctx.q_pos[:, None].long(),
                                    cache=kv_cache.CacheLayers(cache, ctx)))
            gen = None if sampling.greedy else step_generator(seed, i, dev)
            nxt = sample(logits[:, -1].float(), gen, sampling)
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            tokens[:, i] = nxt
            n_gen += (~done).to(torch.int32)
            done = done | is_eos(nxt)
            cur = nxt
            i += 1
        return {"tokens": tokens, "n_generated": n_gen, "steps": i - 1}, cache

    return decode
