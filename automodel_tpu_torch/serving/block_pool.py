"""Paged KV-cache block allocator and prefix cache (host side).

Port of ``automodel_tpu/serving/block_pool.py``. The device holds ONE pool of fixed-size blocks (serving/paged.py owns
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

**Host spill tier** (``serving.kv_spill:``): when a zero-ref prefix block
is evicted from the LRU, the engine's hook (``on_evict``, called inside
``allocate()`` before the caller can write the block) copies its rows
device→host into a bounded :class:`HostSpillTier` keyed by the same chain
hash the prefix cache used, so an evicted prefix reloads from host memory
(``paged.inject_blocks``) instead of prefilling again. The tier is an
opaque byte store here (payloads are what ``paged.extract_blocks``
returned: the pool's own bytes, so a reload is bit-identical to
recompute); its byte ledger and counters are audited by
``check_invariants`` beside the pool's.
"""

from __future__ import annotations

import hashlib
import logging
import struct
from collections import OrderedDict
from typing import Optional, Sequence

logger = logging.getLogger(__name__)


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


class HostSpillTier:
    """Bounded host-RAM parking lot for evicted prefix blocks.

    One entry per chain hash, holding the opaque per-block KV payload the
    engine extracted at eviction time (pool-native bytes: int8 values +
    fp32 scales for int8 pools, bf16 rows otherwise). LRU within the byte
    budget: a ``put`` past ``max_bytes`` evicts the least recently touched
    entries; a payload larger than the whole budget is rejected (counted,
    never stored). ``get`` refreshes recency and leaves the entry resident
    — the tier is a cache, not a queue: one spilled prefix can serve many
    reloads across its lifetime."""

    def __init__(self, max_bytes: int):
        if max_bytes < 1:
            raise ValueError(f"HostSpillTier(max_bytes={max_bytes})")
        self.max_bytes = int(max_bytes)
        self.bytes = 0
        self._entries: "OrderedDict[int, tuple[int, object]]" = OrderedDict()
        self.counters = {
            "spill_puts": 0,  # blocks copied in (overwrites included)
            "spill_gets": 0,  # reload lookups that hit
            "spill_evicted": 0,  # entries dropped to fit the byte budget
            "spill_rejected": 0,  # payloads larger than the whole budget
        }

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: int) -> bool:
        return h in self._entries

    def put(self, h: int, payload: object, nbytes: int) -> bool:
        """Park one evicted block's rows under its chain hash. → False when
        the payload alone exceeds the byte budget (rejected, counted)."""
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            self.counters["spill_rejected"] += 1
            return False
        old = self._entries.pop(h, None)
        if old is not None:
            self.bytes -= old[0]
        while self.bytes + nbytes > self.max_bytes:
            _, (evicted_bytes, _) = self._entries.popitem(last=False)
            self.bytes -= evicted_bytes
            self.counters["spill_evicted"] += 1
        self._entries[h] = (nbytes, payload)
        self.bytes += nbytes
        self.counters["spill_puts"] += 1
        return True

    def get(self, h: int):
        """→ the parked payload (recency refreshed), or None on a miss."""
        entry = self._entries.get(h)
        if entry is None:
            return None
        self._entries.move_to_end(h)
        self.counters["spill_gets"] += 1
        return entry[1]

    def chain_hashes(self) -> list[int]:
        """Resident chain hashes, most recently touched first — the order
        ``hot_prefixes`` advertisement wants (the MRU end is farthest from
        eviction, so advertising it promises affinity the tier will keep)."""
        return list(reversed(self._entries))

    def clear(self) -> None:
        self._entries.clear()
        self.bytes = 0

    def check_invariants(self) -> None:
        if self.bytes != sum(n for n, _ in self._entries.values()):
            raise BlockPoolError(
                f"host spill tier byte ledger desynced: {self.bytes} != "
                f"sum of entry sizes"
            )
        if self.bytes > self.max_bytes:
            raise BlockPoolError(
                f"host spill tier over budget: {self.bytes} > {self.max_bytes}"
            )
        if any(v < 0 for v in self.counters.values()):
            raise BlockPoolError(f"negative spill counter: {self.counters}")
        if self.counters["spill_puts"] < len(self._entries):
            raise BlockPoolError(
                "host spill tier holds more entries than were ever put"
            )


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
        # host spill tier (attached by the engine when serving.kv_spill is
        # enabled) and the eviction hook that feeds it: called with a list
        # of (chain_hash, block_id) pairs BEFORE allocate() returns the
        # evicted blocks, while their device rows are still intact
        self.spill: Optional[HostSpillTier] = None
        self.on_evict = None
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
            # hierarchical tier traffic: blocks spilled device→host at
            # eviction, blocks reloaded host→device at admission, reload
            # admissions; the peer-fetch counters stay 0 (peer fetch needs
            # the fleet's KV-transfer path, which is not ported)
            "spilled_blocks": 0,
            "spill_reloaded_blocks": 0,
            "spill_reloads": 0,
            "peer_fetch_blocks": 0,
            "peer_fetches": 0,
            "peer_fetch_failures": 0,
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

    def cached_block(self, h: int) -> Optional[int]:
        """Block id currently caching chain hash ``h`` (resident tier only,
        no refcount taken)."""
        return self._cached.get(int(h))

    def cached_chain_hashes(self, limit: Optional[int] = None) -> list[int]:
        """The chain hashes this pool can currently serve, as ``/stats``
        advertises them (``hot_prefixes``): chains whose blocks are
        referenced (never evictable) first, then the most recently parked
        end of the LRU, then the spill tier's resident chains (MRU first)."""
        pinned = [h for h in self._cached if h not in self._lru]
        parked = list(self._lru)
        seen = set(pinned) | set(parked)
        spilled = (
            [h for h in self.spill.chain_hashes() if h not in seen]
            if self.spill is not None
            else []
        )
        if limit is None:
            return pinned + parked + spilled
        n = int(limit)
        room = max(n - len(pinned), 0)
        out = (pinned + (parked[-room:] if room else []))[:n]
        return out + spilled[: n - len(out)]

    def note_prefix_tokens(self, hit_tokens: int, miss_tokens: int) -> None:
        """Token-weighted prefix accounting, once per admission."""
        if hit_tokens < 0 or miss_tokens < 0:
            raise ValueError(f"note_prefix_tokens({hit_tokens}, {miss_tokens})")
        self.counters["prefix_hit_tokens"] += int(hit_tokens)
        self.counters["prefix_miss_tokens"] += int(miss_tokens)

    def clear_prefix_cache(self) -> None:
        """Forget every cached prefix (the engine's rebuild: the pool's
        contents are no longer trusted). Ref-0 parked blocks return to the
        free list; a registered block still referenced loses its hash and
        frees normally later. The host spill tier is dropped too: its
        payloads came from the pool this call declares untrusted."""
        for bid in self._lru.values():
            self._free.append(bid)
        self._lru.clear()
        self._cached.clear()
        self._hash_of.clear()
        if self.spill is not None:
            self.spill.clear()

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
        evicted: list[tuple[int, int]] = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                h, bid = self._lru.popitem(last=False)  # oldest cached
                del self._cached[h]
                del self._hash_of[bid]
                self.counters["evictions"] += 1
                evicted.append((h, bid))
            self._ref[bid] = 1
            out.append(bid)
        if evicted and self.on_evict is not None:
            # spill hook: the engine copies the evicted blocks' rows
            # device→host in one batch. The blocks are handed out above, but
            # nothing writes them until this allocate()'s caller injects or
            # prefills, so extraction here comes strictly before any
            # overwrite. A spill failure loses cached bytes, never
            # correctness, so it does not fail the allocation.
            try:
                self.on_evict(evicted)
            except Exception:
                logger.warning(
                    "KV spill hook failed; %d evicted blocks not spilled", len(evicted), exc_info=True
                )
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
        for key in ("prefix_hit_tokens", "prefix_miss_tokens"):
            if self.counters[key] < 0:
                raise BlockPoolError(f"negative counter {key}")
        if self.counters["spill_reloaded_blocks"] < self.counters["spill_reloads"]:
            raise BlockPoolError(
                "spill_reloads admissions exceed spill_reloaded_blocks — "
                "every reload admission moves >= 1 block"
            )
        if self.spill is not None:
            self.spill.check_invariants()
            if self.counters["spilled_blocks"] != self.spill.counters["spill_puts"]:
                raise BlockPoolError(
                    f"spill ledger desynced: pool spilled {self.counters['spilled_blocks']} blocks but the "
                    f"host tier recorded {self.spill.counters['spill_puts']} puts"
                )
            if self.counters["spill_reloaded_blocks"] > self.spill.counters["spill_gets"]:
                raise BlockPoolError("more blocks reloaded than the host tier ever served")
