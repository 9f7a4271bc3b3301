"""KV caches and their per-forward write/attend plans.

Port of ``automodel_tpu/generation/kv_cache.py``: the contiguous cache of
the ``generate`` path (``KVCache`` :47, ``init_cache`` :81,
``CacheContext`` :143 in its prefill and decode modes, ``prefill_ctx``
:299, ``decode_ctx`` :440) and the serving plans (``paged_write_targets``
:391, the chunk plan ``chunk_ctx`` :325, the paged plan ``paged_ctx``
:413). A context is derived once per forward and shared by every layer;
the model's attention calls ``write`` with the layer's cache and its new
post-RoPE keys/values, then ``attend`` (or, when the context does not
attend the cache, attends over the incoming block itself).

- contiguous (``KVCache``): per-layer keys/values ``[L, B, C, Nkv, H]``
  and per-slot position tags ``pos [B, C]`` (-1 = empty). In the full
  layout C = prompt + new tokens and slot j holds position j; a model
  whose every layer has one sliding window gets the ring layout, C capped
  at the window and position p in slot p % C. Prefill writes the padded
  prompt block (ring: its last C positions, rolled into slot order) and
  attends over the block as the training forward does (packed segment
  ids keep the pads out); decode writes one token per slot at its own
  offset and attends the cache through ``sdpa_decode`` under the tag mask
  ``tag >= 0 & tag <= q_pos & q_pos - tag < window``. Padded-prompt junk
  is written but tagged -1, so it is never attended; a ragged batch whose
  padded prompt wraps the ring is refused by the engine
  (generation/engine.py), since its pads would evict real history.
- chunk: the layer cache is a contiguous full-layout VIEW ``[B, C, Nkv,
  H]`` (slot j holds absolute position j); ``write`` puts S rows at each
  slot's own offset, ``attend`` runs ``sdpa_decode`` under per-query
  masks. Positions at or past ``start + real_len`` are never attended.
- paged: the layer cache IS the block pool ``[NB, BS, Nkv, H]`` (or int8
  values + fp32 scales); ``write`` scatters the S rows through the block
  tables, quantizing on write, and ``attend`` runs the paged-attention
  kernel in place. Inactive slots write into scratch block 0.

Unlike the JAX functions, writes update the tensors in place: the cache
or pool is the one copy of the KV, and a functional update would double
it. A planned cache (``prefill_ctx``, ``decode_ctx``) is a new ``KVCache``
with new tags and lengths over the same key/value tensors. On a mesh
(``place_cache``) each tensor-parallel rank keeps its own kv heads' cache,
the layout where no cache collective ever runs; the batch stays whole on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from automodel_tpu_torch.ops.attention import sdpa_decode
from automodel_tpu_torch.ops.paged_attention import paged_attend, quantize_kv_rows


@dataclasses.dataclass
class KVCache:
    """The contiguous cache. ``window`` is set for the ring layout (the
    capacity equals it and every layer is windowed alike)."""

    k: torch.Tensor  # [L, B, C, Nkv, H], post-RoPE
    v: torch.Tensor  # [L, B, C, Nkv, H]
    pos: torch.Tensor  # [B, C] int32 position tags; -1 = empty slot
    lengths: torch.Tensor  # [B] int32 tokens committed per slot
    window: Optional[int] = None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k, self.v, self.pos, self.lengths))

    def replace(self, **kw) -> "KVCache":
        return dataclasses.replace(self, **kw)


def init_cache(
    num_layers: int,
    batch: int,
    capacity: int,
    num_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    window: Optional[int] = None,
    device=None,
) -> KVCache:
    """Empty cache on ``device``. ``window`` (every layer windowed alike)
    marks the ring layout; callers pass ``capacity=min(window, total)``."""
    shape = (num_layers, batch, capacity, num_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        window=window,
    )


def place_cache(cache: KVCache, mesh_ctx) -> KVCache:
    """A cache built for every kv head → this rank's heads under ``tp``
    (JAX :119-140 shards the kv-head dim over ``tensor``; a head count
    ``tp`` does not divide is refused earlier, parallel/plans.check_tp).
    Without a mesh, or at tp = 1, the cache itself."""
    if mesh_ctx is None or mesh_ctx.tp_size == 1:
        return cache
    tp, r = mesh_ctx.tp_size, mesh_ctx.coordinate("tp")
    n = cache.k.shape[3] // tp
    return cache.replace(k=cache.k[:, :, :, r * n:(r + 1) * n].contiguous(),
                         v=cache.v[:, :, :, r * n:(r + 1) * n].contiguous())


@dataclasses.dataclass
class CacheContext:
    """The write/attend plan of one forward over a ``KVCache``.

    ``mode``: ``prefill`` (write the incoming prompt block; the model
    attends over the block itself) or ``decode`` (write one token per
    slot, attend the query over the cache under the tag mask)."""

    mode: str  # "prefill" | "decode"
    capacity: int
    q_pos: torch.Tensor  # [B] decode query position / [B] prompt lengths
    pos: torch.Tensor  # [B, C] tags AFTER this call's write
    slots: Optional[torch.Tensor] = None  # [B] decode write slot
    prompt_len: int = 0  # the padded prompt length (prefill)

    @property
    def attends_cache(self) -> bool:
        """True when attention runs over the cache (decode); prefill
        attends over the incoming block."""
        return self.mode == "decode"

    def write(self, ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """Write this layer's new keys/values into its cache slices ck/cv
        [B, C, Nkv, H], in place; k/v: [B, S, Nkv, H] (S the padded
        prompt in prefill, 1 in decode)."""
        if self.mode == "prefill":
            S, C = self.prompt_len, self.capacity
            if S <= C:
                ck[:, :S] = k.to(ck.dtype)
                cv[:, :S] = v.to(cv.dtype)
            else:
                # ring: only the last C positions survive; position p lands
                # in slot p % C, which for the tail [S-C, S) is a roll
                shift = (S - C) % C
                ck.copy_(torch.roll(k[:, S - C :].to(ck.dtype), shift, dims=1))
                cv.copy_(torch.roll(v[:, S - C :].to(cv.dtype), shift, dims=1))
            return ck, cv
        b = torch.arange(k.shape[0], device=k.device)
        ck[b, self.slots.long()] = k[:, 0].to(ck.dtype)
        cv[b, self.slots.long()] = v[:, 0].to(cv.dtype)
        return ck, cv

    def attend(self, q, layer_kv, *, sliding_window=None, scale=None, logits_soft_cap=None):
        """The query over the cache (decode): ``sdpa_decode`` under the tag
        mask."""
        return sdpa_decode(
            q, layer_kv[0], layer_kv[1], kv_mask=self.attend_mask(sliding_window),
            scale=scale, logits_soft_cap=logits_soft_cap,
        )

    def attend_mask(self, sliding_window: Optional[int] = None) -> torch.Tensor:
        """[B, C]: which cache slots the single query may attend. A layer's
        ``sliding_window`` narrows it; the ring needs nothing more, since
        eviction and window expiry coincide."""
        tags = self.pos
        q = self.q_pos[:, None]
        valid = (tags >= 0) & (tags <= q)
        if sliding_window is not None:
            valid = valid & (q - tags < sliding_window)
        return valid


class CacheLayers:
    """The model's cache hook over a ``KVCache`` and its context: layer
    ``i``'s ``write`` goes into the cache's layer-``i`` slices, ``attend``
    runs the context's attention."""

    def __init__(self, cache: KVCache, ctx: CacheContext):
        self.cache = cache
        self.ctx = ctx

    @property
    def attends_cache(self) -> bool:
        return self.ctx.attends_cache

    def write(self, i: int, k: torch.Tensor, v: torch.Tensor):
        return self.ctx.write(self.cache.k[i], self.cache.v[i], k, v)

    def attend(self, i: int, q: torch.Tensor, layer_kv, **kw) -> torch.Tensor:
        return self.ctx.attend(q, layer_kv, **kw)


def prefill_ctx(cache: KVCache, prompt_len: int, lengths: torch.Tensor) -> tuple[KVCache, CacheContext]:
    """Plan the prompt write → (the cache with its tags and lengths set,
    the shared context); the keys/values are written by the forward."""
    C = cache.capacity
    S = int(prompt_len)
    lengths = lengths.to(torch.int32)
    dev = cache.pos.device
    if S <= C:
        written = torch.arange(S, dtype=torch.int32, device=dev)  # slot j holds position j
        tags = torch.where(written[None, :] < lengths[:, None], written[None, :], -1)
        pos = cache.pos.clone()
        pos[:, :S] = tags.to(torch.int32)
    else:
        # ring tail [S-C, S): slot j holds position S-C + ((j-(S-C)) % C)
        j = torch.arange(C, dtype=torch.int32, device=dev)
        written = S - C + torch.remainder(j - (S - C), C)
        pos = torch.where(written[None, :] < lengths[:, None], written[None, :], -1).to(torch.int32)
    new_cache = cache.replace(pos=pos, lengths=lengths)
    ctx = CacheContext(mode="prefill", capacity=C, q_pos=lengths, pos=pos, prompt_len=S)
    return new_cache, ctx


def decode_ctx(cache: KVCache) -> tuple[KVCache, CacheContext]:
    """Plan a single-token step: the new token sits at position
    lengths[b], slot lengths[b] % C; its tag is set BEFORE attention, so
    the token attends to itself."""
    C = cache.capacity
    q_pos = cache.lengths
    slots = torch.remainder(q_pos, C).to(torch.int32)
    pos = cache.pos.clone()
    pos[torch.arange(pos.shape[0], device=pos.device), slots.long()] = q_pos
    new_cache = cache.replace(pos=pos, lengths=cache.lengths + 1)
    ctx = CacheContext(mode="decode", capacity=C, q_pos=q_pos, pos=pos, slots=slots)
    return new_cache, ctx


def paged_write_targets(
    tables: torch.Tensor,
    lengths: torch.Tensor,
    q_len: int,
    active: torch.Tensor,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(block, offset) ``[B, S]`` int64 for S token rows written at absolute
    positions ``lengths..lengths+S-1`` through the block tables; inactive
    slots route to scratch block 0. Both decode backends resolve their
    write targets here, so they can never write to different cells."""
    pos = lengths.long()[:, None] + torch.arange(q_len, device=tables.device)[None, :]
    idx = torch.clamp(pos // block_size, 0, tables.shape[1] - 1)
    act = active[:, None]
    blk = torch.where(act, torch.gather(tables.long(), 1, idx), torch.zeros_like(idx))
    off = torch.where(act, pos % block_size, torch.zeros_like(pos))
    return blk, off


def paged_scatter(side, new: torch.Tensor, blk: torch.Tensor, off: torch.Tensor) -> None:
    """Write ``new`` [B, S, Nkv, H] rows into one layer's pool slice at
    (blk, off) [B, S], in place. ``side`` is the pool tensor [NB, BS, Nkv,
    H] or, when int8, ``(values, scales)`` with quantize-on-write."""
    if isinstance(side, tuple):
        vals, scales = side
        q, s = quantize_kv_rows(new)
        vals[blk, off] = q
        scales[blk, off] = s.to(scales.dtype)
    else:
        side[blk, off] = new.to(side.dtype)


@dataclasses.dataclass
class ChunkContext:
    """``chunk_len`` (padded) tokens per slot written at absolute positions
    ``start..start+chunk_len-1`` of a full-layout view; ``end = start +
    real_len`` bounds what is attended."""

    capacity: int
    chunk_len: int
    start: torch.Tensor  # [B] int64
    end: torch.Tensor  # [B] int64

    def write(self, ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        B = k.shape[0]
        b = torch.arange(B, device=k.device)[:, None]
        pos = self.start[:, None] + torch.arange(self.chunk_len, device=k.device)[None, :]
        ck[b, pos] = k.to(ck.dtype)
        cv[b, pos] = v.to(cv.dtype)
        return ck, cv

    def attend_mask(self, sliding_window: Optional[int] = None) -> torch.Tensor:
        """[B, S, C]: query s (absolute position start+s) may attend slot j
        iff j < end, j <= start+s, and (window) start+s - j < window."""
        dev = self.start.device
        j = torch.arange(self.capacity, device=dev)
        q_abs = self.start[:, None] + torch.arange(self.chunk_len, device=dev)[None, :]
        valid = (j[None, :] < self.end[:, None])[:, None, :] & (
            j[None, None, :] <= q_abs[:, :, None]
        )
        if sliding_window is not None:
            valid = valid & (q_abs[:, :, None] - j[None, None, :] < sliding_window)
        return valid

    def attend(self, q, layer_kv, *, sliding_window=None, scale=None, logits_soft_cap=None):
        return sdpa_decode(
            q, layer_kv[0], layer_kv[1], kv_mask=self.attend_mask(sliding_window),
            scale=scale, logits_soft_cap=logits_soft_cap,
        )


def chunk_ctx(
    capacity: int, chunk_len: int, start: torch.Tensor, real_len: torch.Tensor
) -> ChunkContext:
    """Plan a chunked write+attend over a full-layout view. ``start`` /
    ``real_len``: [B] (the gather decode step is the chunk of length 1 with
    ``real_len`` 0 for inactive slots)."""
    start = start.long()
    return ChunkContext(
        capacity=int(capacity), chunk_len=int(chunk_len),
        start=start, end=start + real_len.long(),
    )


@dataclasses.dataclass
class PagedContext:
    """``q_len`` tokens per slot written straight into the block pool at
    positions ``lengths..lengths+q_len-1``; attention runs the paged kernel
    over the pool through the tables."""

    tables: torch.Tensor  # [B, NBseq] int32
    lengths: torch.Tensor  # [B] int32, position of query row 0
    q_len: int
    write_block: torch.Tensor  # [B, S]
    write_off: torch.Tensor  # [B, S]

    def write(self, ck, cv, k: torch.Tensor, v: torch.Tensor):
        paged_scatter(ck, k, self.write_block, self.write_off)
        paged_scatter(cv, v, self.write_block, self.write_off)
        return ck, cv

    def attend(self, q, layer_kv, *, sliding_window=None, scale=None, logits_soft_cap=None):
        ck, cv = layer_kv
        kq, ks = ck if isinstance(ck, tuple) else (ck, None)
        vq, vs = cv if isinstance(cv, tuple) else (cv, None)
        return paged_attend(
            q, kq, vq, self.tables, self.lengths, ks, vs,
            scale=scale, sliding_window=sliding_window, logits_soft_cap=logits_soft_cap,
        )


def paged_ctx(
    tables: torch.Tensor,
    lengths: torch.Tensor,
    q_len: int,
    active: torch.Tensor,
    block_size: int,
) -> PagedContext:
    """Plan a paged decode/verify call (1 token per slot for decode)."""
    blk, off = paged_write_targets(tables, lengths, q_len, active, block_size)
    return PagedContext(
        tables=tables.to(torch.int32).contiguous(),
        lengths=lengths.to(torch.int32).contiguous(),
        q_len=int(q_len), write_block=blk, write_off=off,
    )
