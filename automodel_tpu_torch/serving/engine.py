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
   cache) and the slot refills on the next iteration. With
   ``serving.speculative`` (``SpeculativeConfig``) the tick is one
   speculative round instead (``_spec_decode_tick``, JAX :2277-2352): the
   draft model proposes ``k`` tokens a slot over its own pool (the same
   block geometry and tables), ONE verify forward of the target commits the
   accepted prefix plus a correction or bonus token, 1 to k+1 tokens a
   slot; a stop id or the length budget inside the committed block ends the
   request there. Rejected rows need no rollback: the committed length only
   moves forward by what was kept, and the next round overwrites the rest.
   The draft prefills every prompt chunk beside the target.

Every submitted request produces exactly one terminal record carrying
``completion_reason``, ``retriable``, ``tenant``, ``tier``, ``tokens``
and, once it has a first token, ``ttft_s``; a speculative engine adds
``spec_proposed``, ``spec_accepted`` and ``spec_accept_rate``.

The operational half of JAX's engine:

- **QoS** (``serving.qos``, JAX :357-461, :1169-1349, :1874-1989): with QoS
  on, admission picks by effective tier (aging promotes long-queued work
  to the top tier), then weighted-fair service over weight across
  tenants, then earliest deadline, then FIFO; per-tenant token buckets
  refuse over-quota submissions (``QuotaExceeded``, retriable ``quota``);
  a full queue (``max_queue``) sheds strictly lowest-tier-first. With QoS
  off admission is the plain FIFO.
- **drain** (``serving.drain``, JAX :182, :1049-1077, :2472-2491):
  ``begin_drain`` refuses new submissions (``EngineDraining``), flushes
  the queue with retriable ``draining`` records, lets in-flight requests
  finish within ``grace_s`` and then cancels them, and stamps
  ``drain_duration_s``.
- **watchdog and rebuild** (``serving.watchdog``, JAX :211, :1006-1048,
  :2354-2541): the serving fronts start an ``EngineWatchdog``
  (resilience/watchdog.py) that ``step`` pets; a stall it detects, or an
  exception out of a tick, fails only the in-flight wave (``engine_stall``
  / ``engine_error``, retriable), frees the pool tensors and allocates
  fresh ones, clears the prefix cache and keeps the queue.
  ``MAX_CONSECUTIVE_REBUILDS`` back-to-back rebuilds re-raise. A failed
  admission frees its blocks and fails only that request.
- **host spill tier** (``serving.kv_spill``, JAX :251-282, :1381-1400,
  :1481-1582): prefix blocks evicted from the pool's LRU are copied to a
  bounded host tier (serving/block_pool.py ``HostSpillTier``) inside
  ``allocate()``; an admission whose prefix match ends short of the
  prompt's chain reloads the spilled blocks that follow into its fresh
  blocks (``paged.inject_blocks``) instead of prefilling them. Peer fetch
  (``kv_peer``) needs the fleet's KV-transfer path and is refused.
- **metrics**: ``engine.metrics`` (telemetry/prometheus.py
  ``ServingMetrics``) is observed per terminal record; ``/metrics``
  renders it.

Sections of the JAX engine this port does not have (warm start, the KV
transfer listener, a prefill or decode role) are refused when a config
enables them.

``run_workload`` (JAX :2569-2632) drives timed arrivals through the engine
for the benchmark's serving leg, with the speculative counters
(``spec_proposed``, ``spec_accepted``, ``accept_rate``, ``draft_tps``) on
a speculative engine; its ``prefix_cache`` block carries the spill
counters. ``release_pools`` frees the device pools (target and draft) of
an engine that is done.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
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
from automodel_tpu_torch.serving.block_pool import BlockPool, HostSpillTier, blocks_needed, prompt_chain
from automodel_tpu_torch.telemetry.prometheus import _LABEL_VALUE_OK, ServingMetrics
from automodel_tpu_torch.telemetry.report import percentile

logger = logging.getLogger(__name__)

# terminal `completion_reason` values every request record carries one of:
#   stop         — hit a configured eos id
#   length       — spent its max_new_tokens budget
#   timeout      — deadline_s / max_queue_wait_s expired (not retriable)
#   shed         — rejected at submit, admission queue full (retriable)
#   quota        — rejected at submit, the tenant's token bucket is empty
#                  (retriable after Retry-After)
#   draining     — rejected because the server is draining (retriable)
#   cancelled    — in flight when the drain grace expired (retriable)
#   engine_stall — failed by a watchdog-detected wedged step (retriable)
#   engine_error — failed by a scheduler/program exception (retriable)
# (JAX's `prefilled`, a prefill-only fleet request, has no producer here)
_COMPLETED_REASONS = frozenset({"stop", "length"})
_RETRIABLE_REASONS = frozenset(
    {"shed", "quota", "draining", "cancelled", "engine_stall", "engine_error"}
)

# QoS tiers, highest priority first: admission, shedding and the
# Retry-After scaling key off the tier's index in this tuple
TIERS = ("interactive", "batch", "best_effort")
_TIER_INDEX = {t: i for i, t in enumerate(TIERS)}


def tier_index(tier: str) -> int:
    """Priority rank of a tier (0 = highest). An unknown tier raises, as in
    the JAX engine: a typo must never silently demote a tenant."""
    try:
        return _TIER_INDEX[tier]
    except KeyError:
        raise ValueError(f"unknown QoS tier {tier!r} (want one of {'|'.join(TIERS)})") from None


class QueueFull(RuntimeError):
    """Admission queue at ``max_queue``: overload is shed back to the caller
    as a retriable signal (HTTP 503 + Retry-After, a stdin error line)."""


class EngineDraining(RuntimeError):
    """Submissions refused while the server drains (retriable: the client
    should go to another replica)."""


class QuotaExceeded(RuntimeError):
    """The tenant's token bucket (requests/s or decode tokens/s) is empty:
    retriable after it refills. Carries ``tenant`` and ``tier`` so the
    front can label the rejection."""

    def __init__(self, message: str, tenant: str, tier: str):
        super().__init__(message)
        self.tenant = tenant
        self.tier = tier


def section_enabled(name: str, value: Any) -> bool:
    """Whether a config section asks for its feature. An empty or absent
    section is off; ``enabled: false`` (or null) is off; ``http`` is on
    when it names a port, ``warm_start`` when it names a peer, ``fleet``
    when it names replicas, ``slo`` when it has objectives; any other
    non-empty section is on."""
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
class DrainConfig:
    """The ``serving.drain:`` section (JAX :182-207). SIGTERM flips the
    server to draining: new and queued requests are rejected retriable,
    in-flight requests finish within ``grace_s``, then the front exits.
    ``requeue_exit``: ``auto`` exits 75 (the launchers' requeue code)
    under slurm/k8s and 0 otherwise; ``always``/``never`` force it."""

    grace_s: float = 30.0
    install_signal_handler: bool = True
    requeue_exit: str = "auto"  # auto | always | never

    def __post_init__(self):
        if self.requeue_exit not in ("auto", "always", "never"):
            raise ValueError(f"serving.drain.requeue_exit={self.requeue_exit!r} (want auto|always|never)")
        if self.grace_s < 0:
            raise ValueError(f"serving.drain.grace_s={self.grace_s}")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "DrainConfig":
        return _strict(cls, d, "serving.drain")


@dataclasses.dataclass(frozen=True)
class StallConfig:
    """The ``serving.watchdog:`` section (JAX :211-228): scheduler-level
    stall detection through resilience/watchdog.py's ``EngineWatchdog``.
    The serving fronts start it (``start_watchdog``); engine construction
    does not."""

    enabled: bool = True
    multiplier: float = 20.0
    min_deadline_s: float = 30.0
    max_deadline_s: float = 600.0
    ema_alpha: float = 0.2
    compile_grace_s: float = 1800.0  # until the first decode step has run
    poll_interval_s: float = 0.25
    stacks_path: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "StallConfig":
        return _strict(cls, d, "serving.watchdog")


@dataclasses.dataclass(frozen=True)
class KVSpillConfig:
    """The ``serving.kv_spill:`` section (JAX :251-282): prefix blocks
    evicted from the device pool's LRU spill to a host tier of at most
    ``max_host_mb``, keyed by their chain hashes; an admission whose
    prefix extends past the resident blocks reloads them with
    ``paged.inject_blocks`` instead of prefilling (greedy output
    bit-identical). ``peer_fetch`` and ``fetch_timeout_s`` are accepted and
    stay inert: nothing supplies a peer hint without the fleet's router."""

    enabled: bool = False
    max_host_mb: float = 256.0  # host tier budget (LRU beyond this)
    peer_fetch: bool = True
    fetch_timeout_s: float = 5.0

    def __post_init__(self):
        if self.max_host_mb <= 0:
            raise ValueError(f"serving.kv_spill.max_host_mb={self.max_host_mb} (want > 0)")
        if self.fetch_timeout_s <= 0:
            raise ValueError(f"serving.kv_spill.fetch_timeout_s={self.fetch_timeout_s} (want > 0)")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "KVSpillConfig":
        return _strict(cls, d, "serving.kv_spill")


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """The ``serving.speculative:`` section (JAX :324-353): draft-and-verify
    speculative decoding. A draft model proposes ``k`` tokens a slot each
    engine iteration; one verify forward of the target accepts a prefix
    plus one correction or bonus token. Greedy output is bit-identical to
    non-speculative decoding; sampled output keeps the target
    distribution. ``draft`` is a ``model:``-shaped section (``hf_config`` +
    ``backend``, or ``pretrained_model_name_or_path``), built on the
    engine's device; it must have a KV-cache decode path and the target's
    vocabulary."""

    enabled: bool = False
    k: int = 4  # draft tokens proposed a slot an engine step
    draft: Optional[Any] = None  # model: section of the draft

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"serving.speculative.k={self.k} (want >= 1)")
        if self.enabled and not self.draft:
            raise ValueError(
                "serving.speculative.enabled needs a draft model section "
                "(serving.speculative.draft: {hf_config: ...} or "
                "{pretrained_model_name_or_path: ...})"
            )

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SpeculativeConfig":
        return _strict(cls, d, "serving.speculative")


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One ``serving.qos.tenants:`` entry (JAX :357-382): the tenant's
    default tier, its weighted-fair-queuing share and its token-bucket
    quotas (None = unlimited)."""

    tier: Optional[str] = None  # default tier; null = qos.default_tier
    weight: float = 1.0  # WFQ share within the tenant's tier
    requests_per_s: Optional[float] = None  # admission token bucket
    decode_tokens_per_s: Optional[float] = None  # decode-budget bucket
    burst_s: float = 2.0  # bucket depth, in seconds of the rate

    def __post_init__(self):
        if self.tier is not None:
            tier_index(self.tier)  # raises on a typo
        if self.weight <= 0:
            raise ValueError(f"qos tenant weight={self.weight} (want > 0)")
        for name in ("requests_per_s", "decode_tokens_per_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"qos tenant {name}={v} (want > 0 or null)")
        if self.burst_s <= 0:
            raise ValueError(f"qos tenant burst_s={self.burst_s} (want > 0)")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TenantConfig":
        return _strict(cls, d, "serving.qos.tenants entry")


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """The ``serving.qos:`` section (JAX :386-436). Enabled, the admission
    queue is tiered (``TIERS`` order) with weighted fair queuing across
    tenants and EDF inside a tier; per-tenant token buckets reject
    over-quota submissions; a full queue sheds lowest-tier-first; work
    queued past ``aging_s`` orders as the top tier. Disabled (the default),
    admission is the plain FIFO."""

    enabled: bool = False
    default_tier: str = "interactive"  # tier when request + tenant name none
    default_tenant: str = "anonymous"  # tenant when the request names none
    aging_s: float = 30.0  # queued longer than this → ordered as top tier
    tenants: Any = dataclasses.field(default_factory=dict)  # name → TenantConfig

    def __post_init__(self):
        tier_index(self.default_tier)
        if self.aging_s <= 0:
            raise ValueError(f"serving.qos.aging_s={self.aging_s} (want > 0)")
        for name in list(self.tenants) + [self.default_tenant]:
            # tenant names become /metrics label values: refuse anything the
            # exposition would rewrite
            if not _LABEL_VALUE_OK.match(str(name)):
                raise ValueError(
                    f"qos tenant name {name!r} is not a valid metrics label value (want [a-zA-Z0-9_.+-]+)"
                )

    def tenant(self, name: str) -> TenantConfig:
        return self.tenants.get(name) or TenantConfig()

    def tier_for(self, name: str) -> str:
        t = self.tenants.get(name)
        return t.tier if t is not None and t.tier else self.default_tier

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "QoSConfig":
        d = dict(d or {})
        tenants = d.get("tenants")
        if tenants is not None:
            d["tenants"] = {
                str(name): (sub if isinstance(sub, TenantConfig) else TenantConfig.from_dict(dict(sub or {})))
                for name, sub in dict(tenants).items()
            }
        return _strict(cls, d, "serving.qos")


class _TokenBucket:
    """Per-tenant rate limiter: ``rate`` units/s refill a bucket of ``rate *
    burst_s``; ``take`` spends or refuses. rate None = unlimited. Times are
    the caller's perf_counter values."""

    def __init__(self, rate: Optional[float], burst_s: float):
        self.rate = rate
        self.capacity = (rate or 0.0) * burst_s
        self.tokens = self.capacity
        self.t_last: Optional[float] = None

    def take(self, n: float, now: float) -> bool:
        if self.rate is None:
            return True
        if self.t_last is not None and now > self.t_last:
            self.tokens = min(self.capacity, self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


_SUBSECTIONS = (
    ("limits", LimitsConfig),
    ("drain", DrainConfig),
    ("watchdog", StallConfig),
    ("speculative", SpeculativeConfig),
    ("kv_spill", KVSpillConfig),
    ("qos", QoSConfig),
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The `serving:` YAML section (sampling and stop tokens come from the
    `generation:` section)."""

    slots: int = 4  # decode batch width
    block_size: int = 16  # tokens per KV block
    num_blocks: int = 512  # pool size (block 0 is scratch)
    prefill_chunk: int = 64  # prompt tokens per engine iteration per slot
    max_seq_len: int = 1024  # per-request prompt + generated cap
    max_queue: int = 4096  # admission queue bound (QueueFull / shed past it)
    prefix_cache: bool = True
    kv_cache_dtype: str = "bf16"  # bf16 (model compute dtype) | int8
    decode_kernel: str = "auto"  # auto (= fused) | fused (paged kernel) | gather
    role: str = "mixed"  # only mixed: the prefill/decode fleet roles are not ported
    hot_prefix_advertise: int = 512  # cached chain heads /stats advertises
    # the sustained-throughput workload of the benchmark's serving leg
    # (recipes/benchmark.py, run_workload)
    bench_requests: int = 16
    bench_rate: float = 8.0  # Poisson arrival rate, requests/second
    bench_prompt_len_min: int = 8
    bench_prompt_len_max: int = 48
    bench_max_new_tokens: int = 16
    limits: LimitsConfig = dataclasses.field(default_factory=LimitsConfig)
    drain: DrainConfig = dataclasses.field(default_factory=DrainConfig)
    watchdog: StallConfig = dataclasses.field(default_factory=StallConfig)
    speculative: SpeculativeConfig = dataclasses.field(default_factory=SpeculativeConfig)
    kv_spill: KVSpillConfig = dataclasses.field(default_factory=KVSpillConfig)
    qos: QoSConfig = dataclasses.field(default_factory=QoSConfig)

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
        if self.role != "mixed":
            raise ValueError(f"serving.role={self.role!r}: only 'mixed' is ported to the torch backend")
        if self.hot_prefix_advertise < 0:
            raise ValueError(f"serving.hot_prefix_advertise={self.hot_prefix_advertise}")
        if self.kv_spill.enabled and self.speculative.enabled:
            # JAX's refusal (:693-702): a reloaded prefix fills only the
            # target pool, so the draft's pool would miss the prompt KV
            raise ValueError(
                "serving.kv_spill cannot be enabled together with "
                "serving.speculative: the draft pool has no spill tier, so "
                "a reloaded prefix would leave it without the prompt KV"
            )

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ServeConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        d.pop("http", None)  # the front's section (serving/server.py)
        # the fleet's KV-transfer listener and warm start (a peer's weights
        # over that path) are not ported: JAX's auto mode of kv_transfer
        # (on with kv_spill) starts nothing here, so /stats reports
        # kv_transfer_port: null
        for name in ("kv_transfer", "warm_start"):
            v = d.pop(name, None)
            if section_enabled(name, v.to_dict() if hasattr(v, "to_dict") else v):
                raise ValueError(
                    f"serving.{name} is enabled, but the {name} section is not "
                    "ported to the torch backend yet"
                )
        for key, sub in _SUBSECTIONS:
            v = d.get(key)
            if v is not None and not isinstance(v, sub):
                d[key] = sub.from_dict(dict(v.to_dict() if hasattr(v, "to_dict") else v))
        return _strict(cls, d, "serving")

    @property
    def spec_overhang(self) -> int:
        """Positions a speculative round may WRITE past a sequence's final
        committed length (rejected drafts' rows, never attended): the
        admission block budget and the table width both cover them, so
        those writes land in blocks the sequence owns."""
        return self.speculative.k if self.speculative.enabled else 0

    @property
    def table_blocks(self) -> int:
        """Static per-sequence block-table width, with headroom past
        ``max_seq_len`` (``prefill_chunk``, or the verify chunk when
        larger) so a padded chunk's writes never run past the table."""
        headroom = max(self.prefill_chunk, self.spec_overhang + 1)
        return -(-(self.max_seq_len + headroom) // self.block_size)


@dataclasses.dataclass
class _Queued:
    rid: str
    prompt: list[int]
    max_new: int
    t_submit: float
    deadline_at: Optional[float] = None  # perf_counter absolute
    queue_deadline_at: Optional[float] = None
    tenant: str = "anonymous"
    tier: str = "interactive"
    tier_idx: int = 0


@dataclasses.dataclass
class _Slot:
    request_id: str
    prompt: list[int]
    max_new: int
    blocks: list[int]  # every block this sequence holds a ref on
    hit_tokens: int  # prefix-cache reused tokens (resident or reloaded)
    prefill_pos: int  # next absolute prompt position to compute
    t_submit: float
    t_admit: float
    deadline_at: Optional[float] = None
    decoding: bool = False
    generated: Optional[list[int]] = None
    t_first: Optional[float] = None
    tenant: str = "anonymous"
    tier: str = "interactive"
    spec_proposed: int = 0  # draft tokens proposed for this request
    spec_accepted: int = 0  # draft tokens the verify rule accepted


class ServingEngine:
    """Facade over (AutoModel, ServeConfig, GenerationConfig).

    ``submit`` enqueues token-id prompts; ``step`` runs one scheduler
    iteration and returns the records of requests that ended in it;
    ``run`` drains everything. ``on_record`` (optional) receives one dict
    per terminal request and per engine event (a rebuild)."""

    # back-to-back rebuild budget: a fault that survives this many fresh
    # pools in a row is systemic, and step re-raises instead of looping
    MAX_CONSECUTIVE_REBUILDS = 8

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
        sp = self.config.kv_spill
        if sp.enabled:
            self.pool.spill = HostSpillTier(max(int(sp.max_host_mb * 1024 * 1024), 1))
            self.pool.on_evict = self._spill_evicted
        self._quantized = self.config.kv_cache_dtype == "int8"
        self._compute_dtype = self.model.compute_dtype
        # auto resolves to the paged kernel; gather runs only when named
        self.decode_backend = (
            "gather" if self.config.decode_kernel == "gather" else "fused"
        )
        spec = self.config.speculative
        self._spec_enabled = bool(spec.enabled)
        self.draft_auto = None
        if self._spec_enabled:
            self.draft_auto = self._build_draft(spec, mcfg)
        self._init_pool_arrays()
        self._chunk = paged.build_chunk_prefill_fn(
            self.model, self.config.prefill_chunk, self._compute_dtype
        )
        pk = dict(
            pad_id=self.gen_config.pad_token_id, backend=self.decode_backend,
            block_size=self.config.block_size, compute_dtype=self._compute_dtype,
        )
        self._decode = paged.build_paged_decode_fn(self.model, self.gen_config.sampling, **pk)
        if self._spec_enabled:
            d_model = self.draft_auto.model
            d_dtype = d_model.compute_dtype
            self._draft_chunk = paged.build_chunk_prefill_fn(d_model, self.config.prefill_chunk, d_dtype)
            self._propose = paged.build_draft_propose_fn(
                d_model, self.gen_config.sampling, spec.k, **dict(pk, compute_dtype=d_dtype)
            )
            self._verify = paged.build_verify_fn(self.model, self.gen_config.sampling, spec.k, **pk)
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
        # once (on the fused backend, one paged-kernel launch per layer); a
        # speculative round (``spec_rounds``) runs k + 1 draft forwards and
        # one verify forward of the target, each the same
        self.decode_forwards = 0
        self.prefill_chunks = 0
        # speculative accounting (the accept-rate gauge and the bench keys)
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_rounds = 0
        # terminal accounting (/stats and /metrics)
        self.completed_total = 0  # stop/length completions
        self.failed_total = 0  # every other terminal record
        self.shed_total = 0
        self.quota_total = 0  # tenant token-bucket rejections
        self.timeout_total = 0
        # QoS: per-tenant token buckets (built on first submission),
        # per-(tier, tenant) weighted-fair service (token budget / weight,
        # never reset: the order is all WFQ needs) and the per-tier /
        # per-tenant rollups of /stats
        self._req_buckets: dict[str, _TokenBucket] = {}
        self._decode_buckets: dict[str, _TokenBucket] = {}
        self._wfq_served: dict[tuple[str, str], float] = {}
        self.tier_counters: dict[str, dict[str, int]] = {
            t: {"completed": 0, "shed": 0, "timeout": 0, "quota": 0} for t in TIERS
        }
        self.tenant_counters: dict[str, dict[str, int]] = {}
        self.stall_total = 0  # watchdog-detected wedged steps
        self.error_total = 0  # recovered scheduler exceptions
        self.spill_errors = 0  # eviction hooks whose device→host copy raised
        self.last_fault: Optional[str] = None  # the detail of the last of these
        # drain state (begin_drain / drain_complete)
        self.draining = False
        self.drain_duration_s: Optional[float] = None
        self._drain_started: Optional[float] = None
        self._drain_deadline: Optional[float] = None
        # stall watchdog (start_watchdog): evidence handed over from the
        # watchdog thread, consumed at the next step boundary
        self._watchdog = None
        self._stall_evidence: Optional[dict] = None
        self._consecutive_rebuilds = 0
        self.first_decode_done = False  # readiness: one decode step has run
        self.last_step_t: Optional[float] = None  # monotonic, health age
        # the fleet's /stats fields, at a mixed replica's values: no
        # KV-transfer listener, no handoffs, a cold boot, the first weights
        self.kv_transfer_port: Optional[int] = None
        self.kv_injected_total = 0
        self.boot_t: Optional[float] = None  # perf_counter at process start
        self.boot_source = "cold_hf"
        self.time_to_ready_s: Optional[float] = None
        self.weights_version = 0
        # /metrics: histograms observed per terminal record; gauges and
        # pool counters synced at scrape time
        self.metrics = ServingMetrics()

    def _build_draft(self, spec: SpeculativeConfig, mcfg: Any) -> Any:
        """The draft AutoModel on the engine's device (seeded by the
        generation seed, as JAX's), with JAX's checks (:715-740): a KV-cache
        decode path, the target's vocabulary, and a context that holds
        ``max_seq_len + k``."""
        from automodel_tpu_torch.generation.engine import build_auto_from_model_section

        draft = build_auto_from_model_section(spec.draft, self.device, seed=self.gen_config.seed)
        if not getattr(draft.model, "supports_kv_cache", False):
            raise GenerationUnsupported(
                f"serving.speculative.draft model {type(draft.model).__name__} has no KV-cache decode path"
            )
        dv, tv = int(draft.model.config.vocab_size), int(mcfg.vocab_size)
        if dv != tv:
            raise ValueError(
                f"speculative draft vocab_size {dv} != target vocab_size {tv} — "
                "draft and target must share a vocabulary"
            )
        dmax = model_max_positions(draft.model.config)
        if dmax and self.config.max_seq_len + spec.k > dmax:
            # a too-short draft context would extrapolate RoPE past dmax and
            # collapse the accept rate without an error
            raise ValueError(
                f"serving.max_seq_len={self.config.max_seq_len} + speculative.k={spec.k} "
                f"exceeds the draft model's context limit {dmax}"
            )
        return draft

    def _init_pool_arrays(self) -> None:
        """(Re)create the device pools: at construction, and on a rebuild
        after a stalled or failed program whose pool can no longer be
        trusted. The old tensors are dropped before the new ones are
        allocated, so a card never holds two pools at once; the draft's
        pool rebuilds beside the target's."""
        mcfg = self.model.config
        self._pool = self._draft_pool = None
        self._pool = paged.init_pool(
            int(mcfg.num_layers), self.config.num_blocks, self.config.block_size,
            int(mcfg.num_kv_heads), int(mcfg.head_dim), dtype=self._compute_dtype,
            quantized=self._quantized, device=self.device,
        )
        if self._spec_enabled:
            d_model = self.draft_auto.model
            dcfg = d_model.config
            # the draft's own pool over the same block geometry
            self._draft_pool = paged.init_pool(
                int(dcfg.num_layers), self.config.num_blocks, self.config.block_size,
                int(dcfg.num_kv_heads), int(dcfg.head_dim), dtype=d_model.compute_dtype,
                quantized=self._quantized, device=self.device,
            )

    def release_pools(self) -> None:
        """Drop the engine's device pools (target and draft), for a caller
        that is done with this engine but keeps the process (the
        benchmark's serving leg, before the next engine builds its own).
        The engine is unusable after."""
        self._pool = None
        self._draft_pool = None

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

    @property
    def draft_kv_pool(self) -> Optional[paged.PagedKV]:
        """The draft's device block pool (None without speculative decoding)."""
        return self._draft_pool

    @property
    def draft_pool_bytes(self) -> int:
        return self._draft_pool.nbytes if self._spec_enabled else 0

    @property
    def spec_accept_rate(self) -> Optional[float]:
        """Engine-lifetime draft acceptance rate (None when speculative
        decoding is off or no round has run yet)."""
        if not self._spec_enabled or not self.spec_proposed_total:
            return None
        return self.spec_accepted_total / self.spec_proposed_total

    @property
    def watchdog(self):
        return self._watchdog

    @property
    def last_step_age_s(self) -> Optional[float]:
        return time.monotonic() - self.last_step_t if self.last_step_t is not None else None

    def idle(self) -> bool:
        return not self._queue and self.busy_slots == 0

    def hot_prefixes(self) -> list[int]:
        """Cached chain heads /stats advertises (JAX :1375)."""
        return self.pool.cached_chain_hashes(self.config.hot_prefix_advertise)

    def note_ready(self) -> None:
        """Stamp ``time_to_ready_s`` at the first readiness (idempotent;
        after the warm-up and from /readyz), with one ``replica_ready``
        record."""
        if self.time_to_ready_s is not None or not self.first_decode_done or self.boot_t is None:
            return
        self.time_to_ready_s = time.perf_counter() - self.boot_t
        logger.info("replica ready in %.3fs (boot source: %s)", self.time_to_ready_s, self.boot_source)
        self._emit_event({
            "event": "replica_ready", "ts": time.time(), "boot_source": self.boot_source,
            "time_to_ready_s": round(self.time_to_ready_s, 6),
        })

    def check_invariants(self) -> None:
        """Allocator and scheduler audit: the pool's (and spill tier's) own
        invariants, queue entries unique by request id and carrying a valid
        tier, WFQ service never negative. Raises on a violation."""
        self.pool.check_invariants()
        rids = [q.rid for q in self._queue]
        if len(rids) != len(set(rids)):
            raise AssertionError(f"duplicate queued request ids: {rids}")
        for q in self._queue:
            tier_index(q.tier)
        for served in self._wfq_served.values():
            if served < 0:
                raise AssertionError(f"negative WFQ service accumulator: {self._wfq_served}")

    def _device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- stall watchdog -------------------------------------------------------
    def start_watchdog(self, flight_recorder: Any = None, metric_logger: Any = None,
                       stacks_path: Optional[str] = None):
        """Arm the scheduler-level stall watchdog (the serving fronts call
        this). → the EngineWatchdog, or None when serving.watchdog.enabled
        is false."""
        c = self.config.watchdog
        if not c.enabled or self._watchdog is not None:
            return self._watchdog
        from automodel_tpu_torch.resilience.watchdog import EngineWatchdog, WatchdogConfig

        wcfg = WatchdogConfig(
            enabled=True, multiplier=c.multiplier, min_deadline_s=c.min_deadline_s,
            max_deadline_s=c.max_deadline_s, ema_alpha=c.ema_alpha, compile_grace_s=c.compile_grace_s,
            poll_interval_s=c.poll_interval_s, stacks_path=c.stacks_path or stacks_path,
        )
        self._watchdog = EngineWatchdog(
            wcfg, self._note_stall, flight_recorder=flight_recorder, metric_logger=metric_logger,
        )
        self._watchdog.start()
        return self._watchdog

    def stop_watchdog(self) -> None:
        wd, self._watchdog = self._watchdog, None
        if wd is not None:
            wd.stop()

    def touch_watchdog(self) -> None:
        """Idle heartbeat: a serving loop with no work calls this, so an
        empty server never reads as a wedged one."""
        if self._watchdog is not None:
            self._watchdog.touch()

    def _note_stall(self, rec: dict) -> None:
        # called from the WATCHDOG thread while the scheduler thread is
        # blocked inside the wedged call; consumed at the next step boundary
        self._stall_evidence = dict(rec)

    # -- drain ----------------------------------------------------------------
    def begin_drain(self) -> None:
        """Flip to draining: new submissions raise ``EngineDraining``, the
        queue is flushed with retriable records at the next step, and
        in-flight requests get ``drain.grace_s`` to finish before they are
        cancelled. Idempotent."""
        if self.draining:
            return
        self.draining = True
        self._drain_started = time.perf_counter()
        self._drain_deadline = self._drain_started + max(self.config.drain.grace_s, 0.0)
        logger.warning(
            "serving drain started: %d queued rejected retriable, %d in flight, grace %.1fs",
            self.queue_depth, self.busy_slots, self.config.drain.grace_s,
        )

    def drain_complete(self) -> bool:
        """True once every in-flight request ended after ``begin_drain``;
        stamps ``drain_duration_s`` on the first such call."""
        done = self.draining and self.idle()
        if done and self.drain_duration_s is None:
            self.drain_duration_s = time.perf_counter() - self._drain_started
            logger.warning("serving drain complete in %.3fs", self.drain_duration_s)
        return done

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
        return_logprobs: bool = False,
        kv_peer: Optional[dict] = None,
    ) -> str:
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt (every request needs >= 1 token)")
        qos = self.config.qos
        tenant = str(tenant) if tenant is not None else qos.default_tenant
        tier = str(tier) if tier is not None else qos.tier_for(tenant)
        tier_idx = tier_index(tier)  # an unknown tier is refused at submission
        if qos.enabled and not _LABEL_VALUE_OK.match(tenant):
            raise ValueError(f"tenant {tenant!r} is not a valid metrics label value (want [a-zA-Z0-9_.+-]+)")
        if kv_peer:
            raise ValueError(
                "kv_peer: peer prefix fetch needs the fleet's KV-transfer path, which is not ported "
                "to the torch backend yet"
            )
        if return_logprobs and self._spec_enabled:
            # committed tokens mix draft proposals and verify corrections (JAX :1200-1206)
            raise GenerationUnsupported(
                "return_logprobs is not supported on a speculative engine: "
                "committed tokens mix draft proposals and verify "
                "corrections, so no single behavior-policy logprob exists"
            )
        if return_logprobs:
            raise GenerationUnsupported("return_logprobs is not ported to the torch backend")
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
        need = blocks_needed(total, self.config.block_size, self.config.spec_overhang)
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
        q = _Queued(
            rid=rid, prompt=prompt, max_new=max_new, t_submit=now,
            deadline_at=now + ddl if ddl and ddl > 0 else None,
            queue_deadline_at=now + qw if qw and qw > 0 else None,
            tenant=tenant, tier=tier, tier_idx=tier_idx,
        )
        if self.draining:
            # no record here: the rejection goes back to the client
            # directly, and a client honouring Retry-After would otherwise
            # add one record a retry. The draining check comes before any
            # priority handling: no tier jumps a drain.
            raise EngineDraining("server is draining — retry against another replica")
        if qos.enabled:
            # quotas, charged up front: one admission token and the
            # request's whole decode budget (a worst-case reservation)
            tc = qos.tenant(tenant)
            rb = self._req_buckets.get(tenant)
            if rb is None:
                rb = self._req_buckets[tenant] = _TokenBucket(tc.requests_per_s, tc.burst_s)
            db = self._decode_buckets.get(tenant)
            if db is None:
                db = self._decode_buckets[tenant] = _TokenBucket(tc.decode_tokens_per_s, tc.burst_s)
            if not rb.take(1.0, now):
                raise QuotaExceeded(
                    f"tenant {tenant!r} over requests_per_s={tc.requests_per_s} quota", tenant=tenant, tier=tier,
                )
            if not db.take(float(max_new), now):
                raise QuotaExceeded(
                    f"tenant {tenant!r} over decode_tokens_per_s={tc.decode_tokens_per_s} quota",
                    tenant=tenant, tier=tier,
                )
        if len(self._queue) >= self.config.max_queue:
            if not qos.enabled:
                raise QueueFull(f"admission queue at serving.max_queue={self.config.max_queue}")
            # shed strictly lowest-tier-first: evict the worst queued entry
            # when it ranks strictly below the newcomer, else refuse the
            # newcomer. The evicted entry was accepted, so it is owed its
            # terminal `shed` record here.
            victim = self._shed_victim(tier_idx, now)
            if victim is None:
                raise QueueFull(
                    f"admission queue at serving.max_queue={self.config.max_queue} (tier {tier!r} sheds first)"
                )
            self._queue.remove(victim)
            self.shed_total += 1
            self._rejection_record(victim, "shed")
        self._queue.append(q)
        return rid

    def _effective_tier(self, q: _Queued, now: float) -> int:
        """Tier rank for ordering and shedding: work queued past
        ``qos.aging_s`` orders as the top tier (a busy high tier delays low
        tiers but never starves them)."""
        if now - q.t_submit >= self.config.qos.aging_s:
            return 0
        return q.tier_idx

    def _shed_victim(self, newcomer_tier_idx: int, now: float) -> Optional[_Queued]:
        """The queued entry a full queue evicts for a strictly higher-tier
        newcomer: lowest effective tier, latest submission among ties. None
        when nothing queued ranks strictly below the newcomer."""
        victim = None
        victim_key = None
        for q in self._queue:
            key = (self._effective_tier(q, now), q.t_submit)
            if victim_key is None or key > victim_key:
                victim, victim_key = q, key
        if victim is None or victim_key[0] <= newcomer_tier_idx:
            return None
        return victim

    def record_shed(self, request_id: Optional[str] = None, prompt_ids: Optional[Sequence[int]] = None,
                    tenant: Optional[str] = None, tier: Optional[str] = None) -> dict:
        """Account a shed the caller returned to the client (after a
        ``QueueFull`` it gave up on): one labelled record, however many
        times the front retried ``submit``."""
        self.shed_total += 1
        return self._rejection_record(self._rejected(request_id, prompt_ids, tenant, tier), "shed")

    def record_quota(self, request_id: Optional[str] = None, prompt_ids: Optional[Sequence[int]] = None,
                     tenant: Optional[str] = None, tier: Optional[str] = None) -> dict:
        """``record_shed``'s twin for ``QuotaExceeded``: ``submit`` raises
        without a record; the front that answers the client calls this
        once."""
        self.quota_total += 1
        return self._rejection_record(self._rejected(request_id, prompt_ids, tenant, tier), "quota")

    def _rejected(self, request_id, prompt_ids, tenant, tier) -> _Queued:
        qos = self.config.qos
        tenant = tenant if tenant is not None else qos.default_tenant
        tier = tier if tier is not None else qos.tier_for(tenant)
        return _Queued(
            rid=request_id if request_id is not None else f"req-{next(self._ids)}",
            prompt=[int(t) for t in (prompt_ids or [])], max_new=0, t_submit=time.perf_counter(),
            tenant=tenant, tier=tier, tier_idx=tier_index(tier),
        )

    # -- host spill tier ------------------------------------------------------
    def _spill_evicted(self, evicted: list) -> None:
        """BlockPool eviction hook: copy the evicted prefix blocks' rows
        device→host into the spill tier, keyed by chain hash. Runs inside
        ``allocate()``, strictly before the caller can overwrite the blocks
        it was handed: one ``index_select`` and one copy to host memory a
        pool tensor for the whole eviction."""
        tier = self.pool.spill
        if tier is None:
            return
        try:
            k, v = paged.extract_blocks(self._pool, [bid for _, bid in evicted])
        except Exception as e:
            # the pool logs this and keeps the allocation (a lost spill
            # costs cached bytes, not correctness); counted so that
            # check_healthy cannot read the run as a clean one
            self.spill_errors += 1
            self.last_fault = f"spill extract: {type(e).__name__}: {e}"
            raise
        for (h, _), payload in zip(evicted, paged.split_kv_blocks({"k": k, "v": v})):
            if tier.put(h, payload, paged.kv_nbytes(payload)):
                self.pool.counters["spilled_blocks"] += 1

    def _resolve_hierarchy(self, q: _Queued, hits: list, hit_tokens: int, fresh: list) -> int:
        """Admission-time resolution of a prefix match that ends short of
        the prompt's chain (JAX :1481-1582, the local tier): the spilled
        blocks that follow the resident hits reload into the leading
        ``fresh`` blocks with one ``inject_blocks``, so greedy output is
        bit-identical to recompute. → the updated hit_tokens (prefill
        resumes past everything reloaded)."""
        tier = self.pool.spill
        if tier is None or not fresh:
            return hit_tokens
        chain = prompt_chain(q.prompt, self.config.block_size)
        pieces: list[dict] = []
        for h in chain[len(hits):]:
            if len(pieces) >= len(fresh):
                break
            p = tier.get(h)
            if p is None:
                break
            pieces.append(p)
        if not pieces:
            return hit_tokens
        n = len(pieces)
        paged.inject_blocks(self._pool, fresh[:n], paged.concat_kv_blocks(pieces))
        self.pool.counters["spill_reloads"] += 1
        self.pool.counters["spill_reloaded_blocks"] += n
        return hit_tokens + n * self.config.block_size

    # -- terminal records ----------------------------------------------------
    def _emit_event(self, rec: dict) -> None:
        """on_record for an event that is not a request's terminal record."""
        if self.on_record is not None:
            try:
                self.on_record(dict(rec))
            except Exception:  # telemetry must never break serving
                pass

    def _emit(self, rec: dict) -> None:
        try:
            if rec.get("completion_reason") in _COMPLETED_REASONS:
                self.metrics.observe_request(rec)
            else:
                self.metrics.observe_failure(rec.get("completion_reason", ""))
            self.metrics.observe_qos(rec)
            self._note_qos(rec)
        except Exception:  # telemetry must never break serving
            pass
        self._emit_event(rec)

    def _note_qos(self, rec: dict) -> None:
        """Fold one terminal record into the per-tier / per-tenant /stats
        rollups."""
        tier, tenant, reason = rec.get("tier"), rec.get("tenant"), rec.get("completion_reason")
        if tier is None or tenant is None or reason is None:
            return
        tc = self.tier_counters.get(tier)
        if tc is not None:
            if reason in _COMPLETED_REASONS:
                tc["completed"] += 1
            elif reason in tc:
                tc[reason] += 1
        nc = self.tenant_counters.setdefault(
            tenant, {"requests": 0, "completed": 0, "shed": 0, "quota": 0, "timeout": 0}
        )
        nc["requests"] += 1
        if reason in _COMPLETED_REASONS:
            nc["completed"] += 1
        elif reason in nc:
            nc[reason] += 1

    def qos_snapshot(self) -> dict:
        """The /stats ``qos`` block: the queue by tier and tenant and the
        cumulative terminal rollups."""
        queued_by_tier: dict[str, int] = {t: 0 for t in TIERS}
        queued_by_tenant: dict[str, int] = {}
        for q in self._queue:
            queued_by_tier[q.tier] = queued_by_tier.get(q.tier, 0) + 1
            queued_by_tenant[q.tenant] = queued_by_tenant.get(q.tenant, 0) + 1
        return {
            "enabled": self.config.qos.enabled,
            "queued_by_tier": queued_by_tier,
            "queued_by_tenant": queued_by_tenant,
            "tiers": {t: dict(c) for t, c in self.tier_counters.items()},
            "tenants": {n: dict(c) for n, c in self.tenant_counters.items()},
        }

    def _rejection_record(self, q: _Queued, reason: str, detail: Optional[str] = None) -> dict:
        """Terminal record for a request that never reached a slot (shed,
        quota, draining, queue timeout, a failed admission)."""
        self.failed_total += 1
        if reason == "timeout":
            self.timeout_total += 1
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
        if detail:
            rec["detail"] = detail
        self._emit(rec)
        return rec

    def _terminate(self, b: int, reason: str, detail: Optional[str] = None) -> dict:
        """Free slot ``b`` and produce its one terminal record; a failure
        reason frees the blocks all the same."""
        slot = self._slots[b]
        now = time.perf_counter()
        gen = slot.generated or []
        self.pool.free(slot.blocks)
        self._slots[b] = None
        self._tables[b] = 0
        self._lengths[b] = 0
        self._active[b] = False
        self._cur[b] = self.gen_config.pad_token_id
        if reason in _COMPLETED_REASONS:
            self.completed_total += 1
        else:
            self.failed_total += 1
            if reason == "timeout":
                self.timeout_total += 1
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
        if self._spec_enabled and slot.spec_proposed:
            rec["spec_proposed"] = slot.spec_proposed
            rec["spec_accepted"] = slot.spec_accepted
            rec["spec_accept_rate"] = round(slot.spec_accepted / slot.spec_proposed, 4)
        if detail:
            rec["detail"] = detail
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

    def _select_queued(self, now: float) -> int:
        """Index of the next queued request to admit: the head (FIFO) with
        QoS off; with QoS on, effective tier → least weighted service
        across tenants → earliest deadline → FIFO (JAX :1967-1989)."""
        if not self.config.qos.enabled or len(self._queue) <= 1:
            return 0
        best_i, best_key = 0, None
        for i, q in enumerate(self._queue):
            key = (
                self._effective_tier(q, now),
                self._wfq_served.get((q.tier, q.tenant), 0.0) / self.config.qos.tenant(q.tenant).weight,
                q.deadline_at if q.deadline_at is not None else float("inf"),
                q.t_submit,
                i,
            )
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        return best_i

    def _admit(self, done: list[dict]) -> None:
        bs = self.config.block_size
        for b in range(self.config.slots):
            if self._slots[b] is not None or not self._queue:
                continue
            idx = self._select_queued(time.perf_counter())
            q = self._queue[idx]
            hits, hit_tokens = self.pool.match_prefix(q.prompt)
            need = blocks_needed(len(q.prompt) + q.max_new, bs, self.config.spec_overhang)
            fresh = self.pool.allocate(need - len(hits))
            if fresh is None:
                # the pool can't cover the selected request: undo the hit
                # refs and stop admitting this step (no overtaking the head
                # of the scheduling order)
                if hits:
                    self.pool.free(hits)
                break
            del self._queue[idx]
            # WFQ: charge the admitted request's whole token budget to its lane
            lane = (q.tier, q.tenant)
            self._wfq_served[lane] = self._wfq_served.get(lane, 0.0) + float(len(q.prompt) + q.max_new)
            blocks = hits + fresh
            try:
                hit_tokens = self._resolve_hierarchy(q, hits, hit_tokens, fresh)
                # token-weighted prefix accounting after the hierarchy:
                # hit = matchable prompt tokens served from any tier
                matchable = max(len(q.prompt) - 1, 0) // bs * bs
                self.pool.note_prefix_tokens(hit_tokens, max(matchable - hit_tokens, 0))
                self._bind_slot(b, q, blocks, hit_tokens)
            except Exception as e:
                # an exception between allocation and binding returns every
                # block and fails only this request
                self.pool.free(blocks)
                self.error_total += 1
                logger.exception("admission failed for %s", q.rid)
                done.append(self._rejection_record(q, "engine_error", detail=f"admission: {type(e).__name__}: {e}"))

    def _bind_slot(self, b: int, q: _Queued, blocks: list[int], hit_tokens: int) -> None:
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
            table, ids_t = self._device(self._tables[b]), self._device(ids).long()
            last = self._chunk(self._pool, table, ids_t, start, real)
            self.prefill_chunks += 1
            if self._spec_enabled:
                # the draft prefills the same chunk into its own pool (same
                # table, same offsets), so its proposals see the whole
                # prompt; the first token always comes from the target
                self._draft_chunk(self._draft_pool, table, ids_t, start, real)
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
        if self._spec_enabled:
            return self._spec_decode_tick()
        tokens = self._decode(self._pool, *self.decode_batch(), self._seed, self._step_counter)
        self.decode_forwards += 1
        tokens = tokens.cpu().numpy()
        self.first_decode_done = True
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

    def _spec_decode_tick(self) -> list[dict]:
        """One speculative round for the whole decode wave: the draft
        proposes ``k`` tokens a slot, one verify forward of the target
        commits the accepted prefix and a correction or bonus token. The
        committed length moves forward by what was kept (a stop id or the
        length budget may cut the block short, ending the request); the
        rejected tail needs no cache surgery."""
        k = self.config.speculative.k
        tables, lengths, cur, active = self.decode_batch()
        drafts, draft_logits = self._propose(
            self._draft_pool, tables, lengths, cur, active, self._seed, self._step_counter
        )
        tokens, n_commit = self._verify(
            self._pool, tables, lengths, cur, drafts, draft_logits, active, self._seed, self._step_counter
        )
        tokens, n_commit = tokens.cpu().numpy(), n_commit.cpu().numpy()
        self.first_decode_done = True
        self.spec_rounds += 1  # one propose + verify round a wave, not a slot
        done: list[dict] = []
        for b, slot in enumerate(self._slots):
            if slot is None or not self._active[b]:
                continue
            n = int(n_commit[b])
            slot.spec_proposed += k
            slot.spec_accepted += n - 1
            self.spec_proposed_total += k
            self.spec_accepted_total += n - 1
            reason, used = None, 0
            for tok in (int(t) for t in tokens[b, :n]):
                slot.generated.append(tok)
                used += 1
                if tok in self._eos:
                    reason = "stop"
                    break
                if len(slot.generated) >= slot.max_new:
                    reason = "length"
                    break
            self._lengths[b] += used
            self._cur[b] = slot.generated[-1]
            if reason is not None:
                done.append(self._terminate(b, reason))
        return done

    def _rebuild(self, reason: str, detail: Optional[str] = None) -> list[dict]:
        """Recover from a stalled or failed program (JAX :2354-2402): fail
        the in-flight wave, clear the prefix cache (its contents are no
        longer trusted), audit the allocator, free the pool tensors and
        allocate fresh ones, and keep the queue (queued requests hold no
        device state). → the failed wave's records."""
        done: list[dict] = []
        affected = 0
        for b, slot in enumerate(self._slots):
            if slot is not None:
                done.append(self._terminate(b, reason, detail=detail))
                affected += 1
        self.pool.clear_prefix_cache()
        self.pool.check_invariants()
        self._init_pool_arrays()
        self._tables[:] = 0
        self._lengths[:] = 0
        self._active[:] = False
        self._cur[:] = self.gen_config.pad_token_id
        if reason == "engine_stall":
            self.stall_total += 1
        else:
            self.error_total += 1
        self.last_fault = f"{reason}: {detail or ''}"
        try:
            self.metrics.observe_engine_event(reason)
        except Exception:
            pass
        logger.error(
            "serving engine %s at step %d: failed %d in-flight request(s), pool rebuilt, queue (%d) kept — %s",
            reason, self._step_counter, affected, self.queue_depth, detail or "",
        )
        rec = {
            "event": "serve_engine_event", "reason": reason, "step": self._step_counter,
            "requests_failed": affected, "ts": time.time(),
        }
        if detail:
            rec["detail"] = detail
        self._emit_event(rec)
        return done

    def step(self) -> list[dict]:
        """One scheduler iteration → the records of requests that ended in
        it (JAX :2452-2541). An exception out of a tick, or a stall the
        watchdog reported while the step was blocked, rebuilds the pool and
        fails only the in-flight wave; more than
        ``MAX_CONSECUTIVE_REBUILDS`` in a row re-raise."""
        if self._watchdog is not None:
            self._watchdog.pet(self._step_counter)
            if not self.first_decode_done:
                # the first prefill chunk and the first decode step build
                # and load kernels at different steps: hold the grace until
                # a decode step has run once
                self._watchdog.set_phase("compile")
        done: list[dict] = []
        try:
            done += self._expire_tick()
            if self.draining:
                while self._queue:
                    done.append(self._rejection_record(self._queue.popleft(), "draining"))
                if self._drain_deadline is not None and time.perf_counter() >= self._drain_deadline:
                    for b, slot in enumerate(self._slots):
                        if slot is not None:
                            done.append(self._terminate(
                                b, "cancelled", detail=f"drain grace {self.config.drain.grace_s}s expired"
                            ))
            else:
                self._admit(done)
            done += self._prefill_tick()
            done += self._decode_tick()
            rebuilt = False
        except Exception as e:
            rebuilt = True
            self._consecutive_rebuilds += 1
            if self._consecutive_rebuilds > self.MAX_CONSECUTIVE_REBUILDS:
                raise  # systemic: the serving front reports scheduler death
            done += self._rebuild("engine_error", detail=f"{type(e).__name__}: {e}")
        ev, self._stall_evidence = self._stall_evidence, None
        if ev is not None:
            # the wedged call returned after the watchdog fired: its wave is
            # suspect. Stalls draw on the same consecutive budget as errors.
            rebuilt = True
            self._consecutive_rebuilds += 1
            if self._consecutive_rebuilds > self.MAX_CONSECUTIVE_REBUILDS:
                raise RuntimeError(
                    f"serving engine stalled {self._consecutive_rebuilds} consecutive scheduler "
                    "iterations — systemic fault, refusing to rebuild-loop"
                )
            done += self._rebuild(
                "engine_stall",
                detail=f"no step-boundary heartbeat for {ev.get('heartbeat_age_s')}s "
                f"(deadline {ev.get('deadline_s')}s)",
            )
        if not rebuilt:
            self._consecutive_rebuilds = 0
        self._step_counter += 1
        self.last_step_t = time.monotonic()
        if self.draining:
            self.drain_complete()  # stamps drain_duration_s when reached
        return done

    def check_healthy(self) -> None:
        """Raise if the engine has recovered from a fault since it was
        built. A rebuild fails only the in-flight wave and keeps serving,
        and a failed spill only loses cached bytes, so a measurement taken
        across either reads the survivors, not the engine."""
        if self.error_total or self.stall_total or self.spill_errors:
            raise RuntimeError(
                f"serving engine recovered from faults (error_total {self.error_total}, stall_total "
                f"{self.stall_total}, spill_errors {self.spill_errors}); last: {self.last_fault}"
            )

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

    # -- timed workload (the benchmark's serving leg) -------------------------
    def run_workload(
        self, arrivals: Sequence[tuple[float, Sequence[int], Optional[int]]]
    ) -> tuple[list[dict], dict]:
        """Drive a timed workload: ``arrivals`` is [(offset_s, prompt_ids,
        max_new_tokens|None)]. Requests are submitted when their offset
        elapses (wall clock); the engine steps continuously in between. →
        (terminal records, stats: sustained tokens/s, ttft p50/p99, peak
        occupancy and queue depth, the prefix-cache counters, and on a
        speculative engine the proposed and accepted drafts, the accept
        rate and the drafts proposed a second). Raises after the window
        when the engine has recovered from any fault since it was built
        (``check_healthy``)."""
        arrivals = sorted(arrivals, key=lambda a: a[0])
        t0 = time.perf_counter()
        spec_proposed0, spec_accepted0 = self.spec_proposed_total, self.spec_accepted_total
        pending = deque(arrivals)
        out: list[dict] = []
        occ_peak, q_peak = 0.0, 0
        while pending or not self.idle():
            now = time.perf_counter() - t0
            while pending and pending[0][0] <= now:
                _, prompt, max_new = pending.popleft()
                self.submit(prompt, max_new_tokens=max_new)
            if self.idle():
                if pending:
                    time.sleep(min(0.001, max(pending[0][0] - now, 0.0)))
                continue
            out.extend(self.step())
            occ_peak = max(occ_peak, self.pool.occupancy())
            q_peak = max(q_peak, self.queue_depth)
        dt = time.perf_counter() - t0
        completions = [r for r in out if r.get("completion_reason") in ("stop", "length")]
        gen = sum(r["n_generated"] for r in completions)
        ttfts = [r["ttft_s"] for r in completions if isinstance(r.get("ttft_s"), float)]
        stats = {
            "requests": len(completions),
            "gen_tokens": gen,
            "wall_s": dt,
            "sustained_tokens_per_s": gen / dt if dt > 0 else 0.0,
            "ttft_p50_s": percentile(ttfts, 0.50),
            "ttft_p99_s": percentile(ttfts, 0.99),
            "block_occupancy_peak": round(occ_peak, 4),
            "queue_depth_peak": q_peak,
            "prefix_cache": dict(self.pool.counters),
        }
        if self._spec_enabled:
            proposed = self.spec_proposed_total - spec_proposed0
            accepted = self.spec_accepted_total - spec_accepted0
            stats["spec_proposed"] = proposed
            stats["spec_accepted"] = accepted
            stats["accept_rate"] = round(accepted / proposed, 4) if proposed else None
            stats["draft_tps"] = proposed / dt if dt > 0 else 0.0
        if len(completions) != len(out):
            stats["failed_requests"] = len(out) - len(completions)
        self.check_healthy()
        return out, stats
