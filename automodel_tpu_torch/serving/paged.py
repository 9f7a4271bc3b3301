"""Paged-KV programs: chunked prefill and the paged decode step (fused
kernel or gather backend).

Port of ``automodel_tpu/serving/paged.py`` (``PagedKV``, ``init_pool``,
``build_chunk_prefill_fn``, ``build_paged_decode_fn``). The pool is a
:class:`PagedKV`: per-layer k/v block tensors ``[L, NB, BS, Nkv, H]`` in the
model's compute dtype, or int8 values with per-(token row, kv head) fp32
scales ``[L, NB, BS, Nkv]`` beside them. The programs update the pool in
place (the JAX programs donate it).

- **chunk prefill**: one prompt chunk of ONE sequence through the model's
  cached attend over the gathered (dequantized) view; the chunk's rows are
  written back, quantizing on write. The JAX program writes the whole view
  back instead; the rows outside the chunk are the ones it gathered, and
  quantize∘dequantize is idempotent on rows written in the compute dtype,
  so both leave earlier and shared prefix blocks bit-identical.
- **paged decode**: one token per slot. ``fused``: each layer scatters its
  token row into the pool and runs the paged-attention kernel over the
  pool in place. ``gather``: each layer gathers the slots' tables into a
  view, attends with ``sdpa_decode``, and scatters the token row back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from automodel_tpu_torch.generation import kv_cache
from automodel_tpu_torch.generation.sampling import SamplingConfig, sample, step_generator
from automodel_tpu_torch.ops.paged_attention import dequantize_kv


@dataclasses.dataclass
class PagedKV:
    """The device block pool. ``k``/``v`` are each a tensor ``[L, NB, BS,
    Nkv, H]`` or, when quantized, an ``(int8 values, fp32 scales [L, NB,
    BS, Nkv])`` pair."""

    k: Any
    v: Any

    @property
    def quantized(self) -> bool:
        return isinstance(self.k, tuple)

    @property
    def values_shape(self) -> tuple:
        return tuple((self.k[0] if self.quantized else self.k).shape)

    @property
    def nbytes(self) -> int:
        total = 0
        for side in (self.k, self.v):
            for t in side if isinstance(side, tuple) else (side,):
                total += t.numel() * t.element_size()
        return total

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (k side, v side), views into the pool."""

        def one(side):
            return (side[0][i], side[1][i]) if isinstance(side, tuple) else side[i]

        return one(self.k), one(self.v)


def init_pool(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    device=None,
) -> PagedKV:
    """Zeroed pool; ``quantized`` stores int8 values + fp32 row scales."""
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    if quantized:

        def side():
            return (
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            )

        return PagedKV(k=side(), v=side())
    return PagedKV(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def _gather_side(side, tables: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One layer's pool side + tables [B, NBseq] → contiguous view
    [B, NBseq*BS, Nkv, H] in ``dtype`` (int8 blocks dequantize here)."""
    t = tables.long()
    if isinstance(side, tuple):
        vals, scales = side
        g = dequantize_kv(vals[t], scales[t], dtype)
    else:
        g = side[t].to(dtype)
    B, NBseq, BS, Nkv, H = g.shape
    return g.reshape(B, NBseq * BS, Nkv, H)


class _LayerCache:
    """The model's cache hook: per layer, ``write`` hands the context that
    layer's cache and ``attend`` runs the context's attention. On the view
    paths (chunk prefill, gather decode: ``view_dtype`` set) the cache is a
    view gathered from the pool in that dtype, and the new rows are also
    written into the pool at ``rows_at`` (block, offset) targets."""

    def __init__(self, pool: PagedKV, ctx, view_tables=None, view_dtype=None, rows_at=None):
        self.pool = pool
        self.ctx = ctx
        self.view_tables = view_tables
        self.view_dtype = view_dtype
        self.rows_at = rows_at

    def write(self, i: int, k: torch.Tensor, v: torch.Tensor):
        sk, sv = self.pool.layer(i)
        if self.view_dtype is None:
            return self.ctx.write(sk, sv, k, v)
        view_k = _gather_side(sk, self.view_tables, self.view_dtype)
        view_v = _gather_side(sv, self.view_tables, self.view_dtype)
        blk, off = self.rows_at
        kv_cache.paged_scatter(sk, k.to(self.view_dtype), blk, off)
        kv_cache.paged_scatter(sv, v.to(self.view_dtype), blk, off)
        return self.ctx.write(view_k, view_v, k, v)

    def attend(self, i: int, q: torch.Tensor, layer_kv, **kw) -> torch.Tensor:
        return self.ctx.attend(q, layer_kv, **kw)


def _gather_forward(
    model, pool: PagedKV, tables, lengths, tokens, active, compute_dtype, block_size: int
) -> torch.Tensor:
    """tokens [B, S] at per-slot offsets through the GATHERED view, writing
    the S rows back into the pool. → logits [B, S, V] fp32."""
    B, S = tokens.shape
    C = tables.shape[1] * block_size
    ctx = kv_cache.chunk_ctx(C, S, lengths, torch.where(active, S, 0))
    cache = _LayerCache(
        pool, ctx, view_tables=tables, view_dtype=compute_dtype,
        rows_at=kv_cache.paged_write_targets(tables, lengths, S, active, block_size),
    )
    positions = lengths.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
    return model(tokens, positions, cache=cache).float()


def _fused_forward(model, pool: PagedKV, tables, lengths, tokens, active, block_size: int):
    """tokens [B, S] through the paged context: per-layer writes scatter
    into the pool and attention runs the paged kernel over it, no view.
    → logits [B, S, V] fp32."""
    B, S = tokens.shape
    ctx = kv_cache.paged_ctx(tables, lengths, S, active, block_size)
    positions = lengths.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
    return model(tokens, positions, cache=_LayerCache(pool, ctx)).float()


def decode_logits(
    model, pool: PagedKV, tables, lengths, tokens, active, *,
    backend: str, block_size: int, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """tokens [B, S] at per-slot offsets ``lengths`` through one backend,
    their K/V written into the pool. → logits [B, S, V] fp32."""
    if backend == "fused":
        return _fused_forward(model, pool, tables, lengths, tokens, active, block_size)
    return _gather_forward(model, pool, tables, lengths, tokens, active, compute_dtype, block_size)


def build_chunk_prefill_fn(model, chunk_len: int, compute_dtype=None) -> Callable:
    """→ ``chunk(pool, table [NBseq], chunk_ids [chunk_len], start,
    real_len)`` → ``last_logits [V] fp32`` for ONE sequence, the pool
    updated in place. ``start`` is the absolute position of the chunk's
    first token, ``real_len`` the unpadded chunk length; ``last_logits``
    are those of token ``start + real_len - 1``."""

    @torch.inference_mode()
    def chunk(pool: PagedKV, table: torch.Tensor, chunk_ids: torch.Tensor, start: int, real_len: int):
        BS = pool.values_shape[2]
        cd = compute_dtype or (pool.k.dtype if not pool.quantized else torch.bfloat16)
        dev = chunk_ids.device
        tables = table[None, :]
        starts = torch.tensor([start], device=dev)
        ctx = kv_cache.chunk_ctx(
            table.shape[0] * BS, chunk_len, starts, torch.tensor([real_len], device=dev)
        )
        every = torch.ones((1,), dtype=torch.bool, device=dev)
        cache = _LayerCache(
            pool, ctx, view_tables=tables, view_dtype=cd,
            rows_at=kv_cache.paged_write_targets(tables, starts, chunk_len, every, BS),
        )
        positions = (start + torch.arange(chunk_len, device=dev))[None, :]
        h = model.hidden(chunk_ids[None, :], positions, cache=cache)
        return model.logits(h[0, real_len - 1]).float()

    return chunk


def build_paged_decode_fn(
    model,
    sampling: SamplingConfig,
    pad_id: int = 0,
    *,
    backend: str = "gather",
    block_size: int = 16,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``step(pool, tables [B, NBseq], lengths [B], cur [B], active [B]
    bool, seed, step_idx)`` → next tokens [B] int32 on the device, the pool
    updated in place. Every ACTIVE slot advances one token (its K/V written
    at ``(table[len // BS], len % BS)``); inactive slots compute junk that
    is masked from the output and written into scratch block 0."""
    if backend not in ("fused", "gather"):
        raise ValueError(f"paged decode backend {backend!r} (want fused|gather)")

    @torch.inference_mode()
    def step(pool, tables, lengths, cur, active, seed: int, step_idx: int):
        logits = decode_logits(
            model, pool, tables, lengths, cur[:, None], active,
            backend=backend, block_size=block_size, compute_dtype=compute_dtype,
        )
        gen = None if sampling.greedy else step_generator(seed, step_idx, logits.device)
        nxt = sample(logits[:, -1], gen, sampling)
        return torch.where(active, nxt, torch.full_like(nxt, pad_id))

    return step
