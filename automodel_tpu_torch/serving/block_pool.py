"""Paged KV-cache block allocator and prefix cache (host side).

Port of ``automodel_tpu/serving/block_pool.py`` without the host spill
tier. The device holds ONE pool of fixed-size blocks (serving/paged.py owns
the tensors); each sequence owns a block table. Completed prompt blocks
stay in a prefix cache keyed on a chain hash of their tokens, so a request
with the same prompt prefix shares them by reference count; zero-ref
cached blocks sit in an LRU and are evicted only when the free list runs
dry, so caching never makes an allocation fail.

Block 0 is the scratch block: a decode step writes a row for every slot,
and inactive slots write into block 0, which no sequence reads. The
allocator never hands it out.

Invariants (``check_invariants``): every non-scratch block is in exactly
one of {free list, LRU, in use}; free and LRU blocks have ref 0; freeing a
ref-0 block (double free) or the scratch block raises.
"""

from __future__ import annotations

import hashlib
import struct
from collections import OrderedDict
from typing import Optional, Sequence


class BlockPoolError(RuntimeError):
    """Allocator misuse: double free, freeing scratch, corrupt accounting."""


def _chain_hash(parent: Optional[int], tokens: Sequence[int]) -> int:
    """One chain link: hash of (parent chain hash, this block's tokens),
    deterministic across processes (blake2b, not builtin ``hash``)."""
    buf = struct.pack("<q", -1 if parent is None else int(parent))
    buf += struct.pack(f"<{len(tokens)}q", *(int(t) for t in tokens))
    return int.from_bytes(hashlib.blake2b(buf, digest_size=8).digest(), "little", signed=True)


def prompt_chain(tokens: Sequence[int], block_size: int) -> list[int]:
    """Cumulative chain hashes of a prompt's matchable full blocks, capped
    at ``len(tokens) - 1`` tokens (the last prompt token is always
    recomputed: its logits seed the first sampled token)."""
    bs = int(block_size)
    out: list[int] = []
    parent: Optional[int] = None
    for i in range((max(len(tokens) - 1, 0)) // bs):
        parent = _chain_hash(parent, tokens[i * bs : (i + 1) * bs])
        out.append(parent)
    return out


def blocks_needed(total_tokens: int, block_size: int, write_overhang: int = 0) -> int:
    """Whole-budget block count for a request: ``ceil((tokens + overhang) /
    block_size)``."""
    return -(-(int(total_tokens) + int(write_overhang)) // int(block_size))


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int, prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: need >= 2 (block 0 is scratch)")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache_enabled = bool(prefix_cache)
        # LIFO free list: recently freed blocks are handed out first
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {b: 0 for b in range(num_blocks)}
        self._cached: dict[int, int] = {}  # chain hash -> block id
        self._hash_of: dict[int, int] = {}  # block id -> chain hash
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # hash -> ref-0 block
        self.counters = {
            "allocated": 0,
            "freed": 0,
            "prefix_hits": 0,  # requests that matched >= 1 block
            "prefix_blocks_reused": 0,
            "prefix_tokens_reused": 0,
            # matchable prompt tokens served from cache vs recomputed
            "prefix_hit_tokens": 0,
            "prefix_miss_tokens": 0,
            "evictions": 0,
            "failed_allocs": 0,
        }

    # -- capacity -------------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # minus scratch

    def available(self) -> int:
        """Blocks an allocate() could hand out right now (free + evictable)."""
        return len(self._free) + len(self._lru)

    def in_use(self) -> int:
        return self.usable_blocks - self.available()

    def occupancy(self) -> float:
        """Fraction of the usable pool referenced by live sequences."""
        return self.in_use() / max(self.usable_blocks, 1)

    # -- prefix cache ---------------------------------------------------------
    def match_prefix(self, tokens: Sequence[int]) -> tuple[list[int], int]:
        """→ (block ids, matched token count) for the longest cached
        block-aligned prefix of ``tokens``, each hit INCREF'd for the caller.
        Capped at ``len(tokens) - 1`` tokens."""
        if not self.prefix_cache_enabled:
            return [], 0
        bs = self.block_size
        hits: list[int] = []
        parent: Optional[int] = None
        for i in range((max(len(tokens) - 1, 0)) // bs):
            h = _chain_hash(parent, tuple(tokens[i * bs : (i + 1) * bs]))
            bid = self._cached.get(h)
            if bid is None:
                break
            if self._ref[bid] == 0:
                self._lru.pop(h)
            self._ref[bid] += 1
            hits.append(bid)
            parent = h
        if hits:
            self.counters["prefix_hits"] += 1
            self.counters["prefix_blocks_reused"] += len(hits)
            self.counters["prefix_tokens_reused"] += len(hits) * bs
        return hits, len(hits) * bs

    def register_prefix(self, tokens: Sequence[int], blocks: Sequence[int]) -> None:
        """Make a prefilled prompt's FULL blocks matchable by later requests
        (no refcount taken: a registered block freed to ref 0 parks in the
        LRU). First writer wins for a hash or a block already registered."""
        if not self.prefix_cache_enabled:
            return
        bs = self.block_size
        parent: Optional[int] = None
        for i in range(len(tokens) // bs):
            bid = blocks[i]
            h = _chain_hash(parent, tuple(tokens[i * bs : (i + 1) * bs]))
            if h not in self._cached and bid not in self._hash_of:
                self._cached[h] = bid
                self._hash_of[bid] = h
            parent = h

    def note_prefix_tokens(self, hit_tokens: int, miss_tokens: int) -> None:
        """Token-weighted prefix accounting, once per admission."""
        if hit_tokens < 0 or miss_tokens < 0:
            raise ValueError(f"note_prefix_tokens({hit_tokens}, {miss_tokens})")
        self.counters["prefix_hit_tokens"] += int(hit_tokens)
        self.counters["prefix_miss_tokens"] += int(miss_tokens)

    def clear_prefix_cache(self) -> None:
        """Forget every cached prefix; ref-0 parked blocks return to the free
        list."""
        for bid in self._lru.values():
            self._free.append(bid)
        self._lru.clear()
        self._cached.clear()
        self._hash_of.clear()

    # -- allocate / free ------------------------------------------------------
    def allocate(self, n: int) -> Optional[list[int]]:
        """n fresh blocks (ref = 1 each), or None when the pool can't satisfy
        the request. Evicts LRU cached blocks only when the free list is
        empty."""
        if n < 0:
            raise ValueError(f"allocate({n})")
        if n > self.available():
            self.counters["failed_allocs"] += 1
            return None
        out: list[int] = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                h, bid = self._lru.popitem(last=False)  # oldest cached
                del self._cached[h]
                del self._hash_of[bid]
                self.counters["evictions"] += 1
            self._ref[bid] = 1
            out.append(bid)
        self.counters["allocated"] += n
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Decref every block; a block reaching ref 0 returns to the free
        list, or parks in the LRU when it is prefix-cache registered."""
        for bid in blocks:
            if bid == 0:
                raise BlockPoolError("freeing the scratch block")
            if self._ref.get(bid, 0) <= 0:
                raise BlockPoolError(f"double free of block {bid}")
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                h = self._hash_of.get(bid)
                if h is not None:
                    self._lru[h] = bid
                else:
                    self._free.append(bid)
        self.counters["freed"] += len(blocks)

    # -- audit ----------------------------------------------------------------
    def check_invariants(self) -> None:
        free_set = set(self._free)
        lru_set = set(self._lru.values())
        used_set = {b for b in range(1, self.num_blocks) if self._ref[b] > 0}
        if free_set & lru_set or free_set & used_set or lru_set & used_set:
            raise BlockPoolError("block in two states at once")
        everything = set(range(1, self.num_blocks))
        if free_set | lru_set | used_set != everything:
            raise BlockPoolError(f"leaked blocks: {everything - (free_set | lru_set | used_set)}")
        for b in free_set | lru_set:
            if self._ref[b] != 0:
                raise BlockPoolError(f"available block {b} has ref {self._ref[b]}")
        if self._ref[0] != 0:
            raise BlockPoolError("scratch block acquired a refcount")
        for h, bid in self._cached.items():
            if self._hash_of.get(bid) != h:
                raise BlockPoolError(f"cache maps desynced on block {bid}")
        for h in self._lru:
            if h not in self._cached:
                raise BlockPoolError("LRU entry not in prefix cache")
