"""Write/attend plans for the paged KV cache that serving uses.

Port of the serving part of ``automodel_tpu/generation/kv_cache.py``:
``paged_write_targets`` (:391), the chunk plan (``chunk_ctx`` :325) and the
paged plan (``paged_ctx`` :413). A context is derived once per forward and
shared by every layer; the model's attention calls ``write`` with the
layer's cache and its new post-RoPE keys/values, then ``attend``.

- chunk: the layer cache is a contiguous full-layout VIEW ``[B, C, Nkv,
  H]`` (slot j holds absolute position j); ``write`` puts S rows at each
  slot's own offset, ``attend`` runs ``sdpa_decode`` under per-query
  masks. Positions at or past ``start + real_len`` are never attended.
- paged: the layer cache IS the block pool ``[NB, BS, Nkv, H]`` (or int8
  values + fp32 scales); ``write`` scatters the S rows through the block
  tables, quantizing on write, and ``attend`` runs the paged-attention
  kernel in place. Inactive slots write into scratch block 0.

Unlike the JAX functions, writes update the tensors in place: the pool is
the engine's one copy of the KV, and a functional update would double it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from automodel_tpu_torch.ops.attention import sdpa_decode
from automodel_tpu_torch.ops.paged_attention import paged_attend, quantize_kv_rows


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
