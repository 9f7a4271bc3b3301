"""Continuous-batching serving engine over the paged KV pool.

Port of the core of ``automodel_tpu/serving/engine.py``. One ``step()`` is
one scheduler iteration:

1. **expire**: requests whose ``deadline_s`` / ``max_queue_wait_s``
   elapsed end with a ``timeout`` record wherever they are.
2. **admit** (FIFO): queued requests take free slots. A request's WHOLE
   block budget ``ceil((prompt + max_new) / block_size)`` is allocated at
   admission (minus any prefix-cache hit), so a running sequence never
   allocates mid-flight; a request the pool cannot cover stays queued.
3. **prefill tick**: every mid-prefill slot advances one chunk of
   ``prefill_chunk`` tokens; the last chunk samples the first token.
4. **decode tick**: one paged decode step over all slots; each active slot
   advances one token. A slot that hits a stop id or spends its budget
   completes, frees its blocks (prompt blocks stay matchable in the prefix
   cache) and the slot refills on the next iteration.

Every submitted request produces exactly one terminal record carrying
``completion_reason``, ``retriable``, ``tenant``, ``tier``, ``tokens``
and, once it has a first token, ``ttft_s``. Sections of the JAX engine this port does not have
(speculative decoding, spill tier, QoS, warm start, HTTP front, drain,
watchdog, KV transfer) are refused when a config enables them. A failing
program raises out of ``step``; there is no rebuild-and-continue yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from automodel_tpu_torch.generation.engine import (
    GenerationConfig,
    GenerationUnsupported,
    model_max_positions,
)
from automodel_tpu_torch.generation.sampling import sample, step_generator
from automodel_tpu_torch.serving import paged
from automodel_tpu_torch.serving.block_pool import BlockPool, blocks_needed

# terminal `completion_reason` values this engine produces:
#   stop    — hit a configured eos id
#   length  — spent its max_new_tokens budget
#   timeout — deadline_s / max_queue_wait_s expired
# A record's `retriable` says whether the client may resubmit it as is; the
# reasons JAX's engine marks so (shed, quota, draining, cancelled and the
# engine failures) come from sections the port refuses, so none of the
# three above is retriable.
_RETRIABLE_REASONS = frozenset(
    {"shed", "quota", "draining", "cancelled", "engine_stall", "engine_error"}
)

# QoS tiers, highest priority first; a record names its request's tenant
# and tier. QoS itself (fair queuing, quotas, shedding) is not ported: every
# request is admitted FIFO whatever it names.
TIERS = ("interactive", "batch", "best_effort")
DEFAULT_TENANT = "anonymous"
DEFAULT_TIER = "interactive"


def tier_index(tier: str) -> int:
    """Priority rank of a tier (0 = highest). An unknown tier raises, as in
    the JAX engine: a typo must never silently demote a tenant."""
    if tier not in TIERS:
        raise ValueError(f"unknown QoS tier {tier!r} (want one of {'|'.join(TIERS)})")
    return TIERS.index(tier)

# sections of the JAX engine's config that this port does not run
UNPORTED_SERVING_SECTIONS = (
    "speculative", "kv_spill", "qos", "warm_start", "http", "drain", "watchdog",
    "kv_transfer",
)


def section_enabled(name: str, value: Any) -> bool:
    """Whether a config section asks for its feature. An empty or absent
    section is off; ``enabled: false`` is off; ``http`` is on when it names
    a port, ``warm_start`` when it names a peer, ``fleet`` when it names
    replicas, ``slo`` when it has objectives; any other non-empty section
    is on."""
    if not value:
        return False
    if not isinstance(value, dict):
        value = dict(value) if hasattr(value, "keys") else {"enabled": value}
    if "enabled" in value:
        return bool(value["enabled"])
    if name == "http":
        return value.get("port") is not None
    if name == "warm_start":
        return value.get("peer_host") is not None
    if name == "fleet":
        return bool(value.get("replicas")) or value.get("dns") is not None
    if name == "slo":
        return bool(value.get("objectives"))
    return True


def _strict(cls, d: Optional[dict], section: str):
    d = dict(d or {})
    d.pop("_target_", None)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise TypeError(f"unknown {section} keys: {sorted(unknown)}")
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class LimitsConfig:
    """The ``serving.limits:`` section — per-request time budgets; 0/None
    disables a bound. Per-request values on submit override these."""

    deadline_s: Optional[float] = None  # submit → completion wall cap
    max_queue_wait_s: Optional[float] = None  # submit → admission wall cap

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LimitsConfig":
        return _strict(cls, d, "serving.limits")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The `serving:` YAML section (sampling and stop tokens come from the
    `generation:` section)."""

    slots: int = 4  # decode batch width
    block_size: int = 16  # tokens per KV block
    num_blocks: int = 512  # pool size (block 0 is scratch)
    prefill_chunk: int = 64  # prompt tokens per engine iteration per slot
    max_seq_len: int = 1024  # per-request prompt + generated cap
    prefix_cache: bool = True
    kv_cache_dtype: str = "bf16"  # bf16 (model compute dtype) | int8
    decode_kernel: str = "auto"  # auto (= fused) | fused (paged kernel) | gather
    limits: LimitsConfig = dataclasses.field(default_factory=LimitsConfig)

    def __post_init__(self):
        if self.slots < 1 or self.block_size < 1 or self.prefill_chunk < 1:
            raise ValueError(
                f"serving: slots/block_size/prefill_chunk must be >= 1 "
                f"({self.slots}/{self.block_size}/{self.prefill_chunk})"
            )
        if self.max_seq_len < 2:
            raise ValueError(f"serving.max_seq_len={self.max_seq_len}")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"serving.kv_cache_dtype={self.kv_cache_dtype!r} (want bf16|int8)")
        if self.decode_kernel not in ("auto", "fused", "gather"):
            raise ValueError(
                f"serving.decode_kernel={self.decode_kernel!r} (want auto|fused|gather)"
            )

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ServeConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        for name in UNPORTED_SERVING_SECTIONS:
            if section_enabled(name, d.pop(name, None)):
                raise ValueError(
                    f"serving.{name} is enabled, but the {name} section is not "
                    "ported to the torch backend yet"
                )
        role = d.pop("role", "mixed")
        if role != "mixed":
            raise ValueError(f"serving.role={role!r}: only 'mixed' is ported to the torch backend")
        if d.get("limits") is not None and not isinstance(d["limits"], LimitsConfig):
            d["limits"] = LimitsConfig.from_dict(dict(d["limits"]))
        return _strict(cls, d, "serving")

    @property
    def table_blocks(self) -> int:
        """Static per-sequence block-table width, with ``prefill_chunk`` of
        headroom past ``max_seq_len`` so a padded chunk's writes never run
        past the table."""
        return -(-(self.max_seq_len + self.prefill_chunk) // self.block_size)


@dataclasses.dataclass
class _Queued:
    rid: str
    prompt: list[int]
    max_new: int
    t_submit: float
    deadline_at: Optional[float] = None  # perf_counter absolute
    queue_deadline_at: Optional[float] = None
    tenant: str = DEFAULT_TENANT
    tier: str = DEFAULT_TIER


@dataclasses.dataclass
class _Slot:
    request_id: str
    prompt: list[int]
    max_new: int
    blocks: list[int]  # every block this sequence holds a ref on
    hit_tokens: int  # prefix-cache reused tokens
    prefill_pos: int  # next absolute prompt position to compute
    t_submit: float
    t_admit: float
    deadline_at: Optional[float] = None
    decoding: bool = False
    generated: Optional[list[int]] = None
    t_first: Optional[float] = None
    tenant: str = DEFAULT_TENANT
    tier: str = DEFAULT_TIER


class ServingEngine:
    """Facade over (AutoModel, ServeConfig, GenerationConfig).

    ``submit`` enqueues token-id prompts; ``step`` runs one scheduler
    iteration and returns the records of requests that ended in it;
    ``run`` drains everything. ``on_record`` (optional) receives one dict
    per terminal request."""

    def __init__(
        self,
        auto: Any,
        config: Optional[ServeConfig] = None,
        gen_config: Optional[GenerationConfig] = None,
        on_record: Optional[Callable[[dict], None]] = None,
    ):
        if not getattr(auto.model, "supports_kv_cache", False):
            raise GenerationUnsupported(
                f"{type(auto.model).__name__} has no KV-cache decode path"
            )
        self.auto = auto
        self.model = auto.model
        self.device = auto.device
        self.config = config or ServeConfig()
        self.gen_config = gen_config or GenerationConfig()
        self.on_record = on_record
        mcfg = self.model.config
        self._max_positions = model_max_positions(mcfg)
        if self._max_positions and self.config.max_seq_len > self._max_positions:
            raise ValueError(
                f"serving.max_seq_len={self.config.max_seq_len} exceeds the "
                f"model context limit {self._max_positions}"
            )
        self.pool = BlockPool(
            self.config.num_blocks, self.config.block_size,
            prefix_cache=self.config.prefix_cache,
        )
        self._quantized = self.config.kv_cache_dtype == "int8"
        self._compute_dtype = self.model.compute_dtype
        # auto resolves to the paged kernel; gather runs only when named
        self.decode_backend = (
            "gather" if self.config.decode_kernel == "gather" else "fused"
        )
        self._pool = paged.init_pool(
            int(mcfg.num_layers), self.config.num_blocks, self.config.block_size,
            int(mcfg.num_kv_heads), int(mcfg.head_dim), dtype=self._compute_dtype,
            quantized=self._quantized, device=self.device,
        )
        self._chunk = paged.build_chunk_prefill_fn(
            self.model, self.config.prefill_chunk, self._compute_dtype
        )
        self._decode = paged.build_paged_decode_fn(
            self.model, self.gen_config.sampling, pad_id=self.gen_config.pad_token_id,
            backend=self.decode_backend, block_size=self.config.block_size,
            compute_dtype=self._compute_dtype,
        )
        self._seed = int(self.gen_config.seed)
        self._eos = set(self.gen_config.eos_ids)

        B, NB = self.config.slots, self.config.table_blocks
        self._tables = np.zeros((B, NB), np.int32)
        self._lengths = np.zeros((B,), np.int32)
        self._cur = np.full((B,), self.gen_config.pad_token_id, np.int32)
        self._active = np.zeros((B,), bool)
        self._slots: list[Optional[_Slot]] = [None] * B
        self._queue: deque[_Queued] = deque()
        self._ids = itertools.count()
        self._step_counter = 0
        # program calls: each decode forward runs every layer's attention
        # once (on the fused backend, one paged-kernel launch per layer)
        self.decode_forwards = 0
        self.prefill_chunks = 0

    # -- stats ---------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def kv_pool(self) -> paged.PagedKV:
        """The device block pool (every program updates it in place)."""
        return self._pool

    @property
    def pool_bytes(self) -> int:
        return self._pool.nbytes

    def idle(self) -> bool:
        return not self._queue and self.busy_slots == 0

    def check_invariants(self) -> None:
        self.pool.check_invariants()

    def _device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- submission ----------------------------------------------------------
    def submit(
        self,
        prompt_ids: Sequence[int],
        request_id: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
        t_submit: Optional[float] = None,
        deadline_s: Optional[float] = None,
        max_queue_wait_s: Optional[float] = None,
        tenant: Optional[str] = None,
        tier: Optional[str] = None,
    ) -> str:
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt (every request needs >= 1 token)")
        tenant = str(tenant) if tenant is not None else DEFAULT_TENANT
        tier = str(tier) if tier is not None else DEFAULT_TIER
        tier_index(tier)  # an unknown tier is refused at submission
        vocab = int(self.model.config.vocab_size)
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        max_new = (
            self.gen_config.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
        )
        if max_new < 1:
            raise ValueError(f"max_new_tokens={max_new}")
        total = len(prompt) + max_new
        cap = min(self.config.max_seq_len, self._max_positions or self.config.max_seq_len)
        if total > cap:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) = {total} "
                f"exceeds the serving limit {cap}"
            )
        need = blocks_needed(total, self.config.block_size)
        if need > self.pool.usable_blocks:
            raise ValueError(
                f"request needs {need} blocks but the pool only has "
                f"{self.pool.usable_blocks} — raise serving.num_blocks"
            )
        now = time.perf_counter() if t_submit is None else t_submit
        rid = request_id if request_id is not None else f"req-{next(self._ids)}"
        lim = self.config.limits
        ddl = lim.deadline_s if deadline_s is None else float(deadline_s)
        qw = lim.max_queue_wait_s if max_queue_wait_s is None else float(max_queue_wait_s)
        self._queue.append(
            _Queued(
                rid=rid, prompt=prompt, max_new=max_new, t_submit=now,
                deadline_at=now + ddl if ddl and ddl > 0 else None,
                queue_deadline_at=now + qw if qw and qw > 0 else None,
                tenant=tenant, tier=tier,
            )
        )
        return rid

    # -- terminal records ----------------------------------------------------
    def _emit(self, rec: dict) -> None:
        if self.on_record is not None:
            self.on_record(dict(rec))

    def _rejection_record(self, q: _Queued, reason: str) -> dict:
        """Terminal record for a request that never reached a slot."""
        rec = {
            "event": "serve_request",
            "request_id": q.rid,
            "tokens": [],
            "n_generated": 0,
            "prompt_tokens": len(q.prompt),
            "completion_reason": reason,
            "retriable": reason in _RETRIABLE_REASONS,
            "tenant": q.tenant,
            "tier": q.tier,
            "queue_s": time.perf_counter() - q.t_submit,
            "queue_depth": self.queue_depth,
            "ts": time.time(),
        }
        self._emit(rec)
        return rec

    def _terminate(self, b: int, reason: str) -> dict:
        """Free slot ``b`` and produce its one terminal record."""
        slot = self._slots[b]
        now = time.perf_counter()
        gen = slot.generated or []
        self.pool.free(slot.blocks)
        self._slots[b] = None
        self._tables[b] = 0
        self._lengths[b] = 0
        self._active[b] = False
        self._cur[b] = self.gen_config.pad_token_id
        rec = {
            "event": "serve_request",
            "request_id": slot.request_id,
            "tokens": list(gen),
            "n_generated": len(gen),
            "prompt_tokens": len(slot.prompt),
            "prefix_hit_tokens": slot.hit_tokens,
            "completion_reason": reason,
            "retriable": reason in _RETRIABLE_REASONS,
            "tenant": slot.tenant,
            "tier": slot.tier,
            "queue_s": slot.t_admit - slot.t_submit,
            "queue_depth": self.queue_depth,
            "block_occupancy": round(self.pool.occupancy(), 4),
            "ts": time.time(),
        }
        if slot.t_first is not None:
            decode_s = now - slot.t_first
            rec["ttft_s"] = slot.t_first - slot.t_submit
            # the first token is charged to ttft
            rec["decode_tps"] = (
                (len(gen) - 1) / decode_s if decode_s > 0 and len(gen) > 1 else 0.0
            )
        self._emit(rec)
        return rec

    # -- scheduler -----------------------------------------------------------
    def _expire_tick(self) -> list[dict]:
        now = time.perf_counter()
        done: list[dict] = []
        if any(q.deadline_at is not None or q.queue_deadline_at is not None for q in self._queue):
            keep: deque[_Queued] = deque()
            for q in self._queue:
                expired = (q.deadline_at is not None and now >= q.deadline_at) or (
                    q.queue_deadline_at is not None and now >= q.queue_deadline_at
                )
                if expired:
                    done.append(self._rejection_record(q, "timeout"))
                else:
                    keep.append(q)
            self._queue = keep
        for b, slot in enumerate(self._slots):
            if slot is not None and slot.deadline_at is not None and now >= slot.deadline_at:
                done.append(self._terminate(b, "timeout"))
        return done

    def _admit(self) -> None:
        bs = self.config.block_size
        for b in range(self.config.slots):
            if self._slots[b] is not None or not self._queue:
                continue
            q = self._queue[0]
            hits, hit_tokens = self.pool.match_prefix(q.prompt)
            need = blocks_needed(len(q.prompt) + q.max_new, bs)
            fresh = self.pool.allocate(need - len(hits))
            if fresh is None:
                # the pool can't cover the head of the queue: undo the hit
                # refs and stop admitting this step (no overtaking)
                if hits:
                    self.pool.free(hits)
                break
            self._queue.popleft()
            matchable = max(len(q.prompt) - 1, 0) // bs * bs
            self.pool.note_prefix_tokens(hit_tokens, max(matchable - hit_tokens, 0))
            blocks = hits + fresh
            row = np.zeros((self.config.table_blocks,), np.int32)
            row[: len(blocks)] = blocks
            self._tables[b] = row
            self._lengths[b] = hit_tokens
            self._active[b] = False
            self._slots[b] = _Slot(
                request_id=q.rid, prompt=q.prompt, max_new=q.max_new,
                blocks=blocks, hit_tokens=hit_tokens, prefill_pos=hit_tokens,
                t_submit=q.t_submit, t_admit=time.perf_counter(), deadline_at=q.deadline_at,
                tenant=q.tenant, tier=q.tier,
            )

    def _prefill_tick(self) -> list[dict]:
        done: list[dict] = []
        chunk_len = self.config.prefill_chunk
        pad = self.gen_config.pad_token_id
        for b, slot in enumerate(self._slots):
            if slot is None or slot.decoding:
                continue
            p = len(slot.prompt)
            start = slot.prefill_pos
            real = min(chunk_len, p - start)
            ids = np.full((chunk_len,), pad, np.int32)
            ids[:real] = slot.prompt[start : start + real]
            last = self._chunk(
                self._pool, self._device(self._tables[b]), self._device(ids).long(), start, real
            )
            self.prefill_chunks += 1
            slot.prefill_pos = start + real
            self._lengths[b] = slot.prefill_pos
            if slot.prefill_pos < p:
                continue
            # prompt fully in: sample the first token (charged to ttft),
            # publish the prompt blocks to the prefix cache, flip to decode
            gen = step_generator(self._seed, self._step_counter, last.device)
            first = int(sample(last[None, :], gen, self.gen_config.sampling)[0])
            self.pool.register_prefix(slot.prompt, slot.blocks)
            slot.t_first = time.perf_counter()
            slot.generated = [first]
            slot.decoding = True
            self._cur[b] = first
            self._active[b] = True
            self._lengths[b] = p
            if first in self._eos:
                done.append(self._terminate(b, "stop"))
            elif slot.max_new <= 1:
                done.append(self._terminate(b, "length"))
        return done

    def decode_batch(self) -> tuple[torch.Tensor, ...]:
        """The next decode step's inputs on the device: (tables, lengths,
        current tokens, active mask), one row per slot."""
        return (
            self._device(self._tables), self._device(self._lengths),
            self._device(self._cur).long(), self._device(self._active),
        )

    def _decode_tick(self) -> list[dict]:
        if not self._active.any():
            return []
        tokens = self._decode(self._pool, *self.decode_batch(), self._seed, self._step_counter)
        self.decode_forwards += 1
        tokens = tokens.cpu().numpy()
        done: list[dict] = []
        for b, slot in enumerate(self._slots):
            if slot is None or not self._active[b]:
                continue
            tok = int(tokens[b])
            slot.generated.append(tok)
            self._lengths[b] += 1
            self._cur[b] = tok
            if tok in self._eos:
                done.append(self._terminate(b, "stop"))
            elif len(slot.generated) >= slot.max_new:
                done.append(self._terminate(b, "length"))
        return done

    def step(self) -> list[dict]:
        """One scheduler iteration → the records of requests that ended in
        it."""
        done = self._expire_tick()
        self._admit()
        done += self._prefill_tick()
        done += self._decode_tick()
        self._step_counter += 1
        return done

    def run(self, max_iterations: Optional[int] = None) -> list[dict]:
        """Drain the queue and every running slot. ``max_iterations`` guards
        against scheduler bugs (default: a generous analytic bound)."""
        if max_iterations is None:
            n_req = len(self._queue) + self.busy_slots
            per_req = -(-self.config.max_seq_len // self.config.prefill_chunk) + self.config.max_seq_len
            max_iterations = 64 + (n_req + 1) * (per_req + 2)
        out: list[dict] = []
        for _ in range(max_iterations):
            if self.idle():
                return out
            out.extend(self.step())
        raise RuntimeError(
            f"serving engine failed to drain within {max_iterations} iterations "
            f"(queue={self.queue_depth}, busy={self.busy_slots})"
        )
