"""Minimal Prometheus text-exposition registry (no client library), port
of the metric types, ``MetricsRegistry`` and ``ServingMetrics`` of
``automodel_tpu/telemetry/prometheus.py``.

The serving front mounts ``GET /metrics`` (serving/server.py) on this
registry: queue depth, running/prefilling slots, block-pool occupancy and
allocator counters, the spill tier's bytes and entries, the drain, stall
and error counters, the QoS tier/tenant families and the ttft / decode
tokens-per-second histograms. Exposition follows the text format 0.0.4
(``# HELP``/``# TYPE`` headers, ``_bucket{le=...}``/``_sum``/``_count``
for histograms). One lock per registry: the scheduler thread observes
while HTTP handler threads scrape. The training side: ``MetricsServerConfig``
(the ``metrics_server:`` section), ``TrainMetricsExporter`` (the
``automodel_train_*`` families, folded from each log record, the goodput
snapshot and the guard's events) and ``start_metrics_server`` (a
standalone ``GET /metrics`` port).
"""

from __future__ import annotations

import dataclasses
import math
import re
import threading
from typing import Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# Default ttft/latency buckets (seconds): sub-ms CPU smoke tests up to the
# multi-second prefills of long prompts on a card.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)
# decode tokens/sec per request — spans CPU smoke (~1e1) to a card (~1e3+)
THROUGHPUT_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, name: str, help_text: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid prometheus metric name {name!r}")
        self.name = name
        # raw text; render() escapes per the exposition spec
        self.help = help_text


class Counter(_Metric):
    """Monotonic counter. ``set_total`` exists for sources that already
    maintain a cumulative value (e.g. BlockPool.counters) — it refuses to
    go backwards, preserving counter semantics at the exposition."""

    kind = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self.value += v

    def set_total(self, total: float) -> None:
        if total > self.value:
            self.value = float(total)

    def render(self) -> list[str]:
        return [f"{self.name}_total {_fmt(self.value)}"]

    @property
    def render_name(self) -> str:
        return f"{self.name}_total"


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]

    @property
    def render_name(self) -> str:
        return self.name


_LABEL_VALUE_OK = re.compile(r"^[a-zA-Z0-9_.+-]+$")


def _label_value(v: str) -> str:
    """Sanitize a label value to the charset the exposition lint (and a
    conservative scraper) accepts — replica names like ``r0`` pass through;
    anything exotic (a raw URL) degrades to dashes instead of breaking the
    scrape."""
    v = str(v)
    if _LABEL_VALUE_OK.match(v):
        return v
    return re.sub(r"[^a-zA-Z0-9_.+-]", "-", v) or "unknown"


class _Labeled(_Metric):
    """One metric name fanned out over one or more labels (e.g. the fleet
    router's ``automodel_route_requests_total{replica="r0",outcome="ok"}``).
    Child values are created on first touch and render as one sample line
    per label-value tuple. Mutations take a per-metric lock: unlike the
    scalar float updates, inserting a NEW label key (a replica joining via
    DNS) during a concurrent /metrics render would die with "dictionary
    changed size during iteration"."""

    def __init__(self, name: str, help_text: str, label):
        super().__init__(name, help_text)
        labels = (label,) if isinstance(label, str) else tuple(label)
        for l in labels:
            if not _NAME_RE.match(l):
                raise ValueError(f"invalid prometheus label name {l!r}")
        if not labels:
            raise ValueError(f"labeled metric {name}: no labels")
        self.labels = labels
        self.values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def _key(self, label_value) -> tuple:
        vals = (
            (label_value,)
            if isinstance(label_value, str) else tuple(label_value)
        )
        if len(vals) != len(self.labels):
            raise ValueError(
                f"metric {self.name} takes {len(self.labels)} label "
                f"value(s) {self.labels}, got {vals!r}"
            )
        return tuple(_label_value(v) for v in vals)

    def _label_str(self, key: tuple) -> str:
        return ",".join(
            f'{l}="{v}"' for l, v in zip(self.labels, key)
        )

    def _lines(self, suffix: str) -> list[str]:
        with self._lock:
            items = sorted(self.values.items())
        return [
            f"{self.name}{suffix}{{{self._label_str(k)}}} {_fmt(v)}"
            for k, v in items
        ]


class LabeledCounter(_Labeled):
    kind = "counter"

    def inc(self, label_value, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        key = self._key(label_value)
        with self._lock:
            self.values[key] = self.values.get(key, 0.0) + v

    def render(self) -> list[str]:
        return self._lines("_total")

    @property
    def render_name(self) -> str:
        return f"{self.name}_total"


class LabeledGauge(_Labeled):
    kind = "gauge"

    def set(self, label_value, v: float) -> None:
        with self._lock:
            self.values[self._key(label_value)] = float(v)

    def render(self) -> list[str]:
        return self._lines("")

    @property
    def render_name(self) -> str:
        return self.name


class LabeledHistogram(_Labeled):
    """One histogram per label-value tuple under a shared bucket layout —
    e.g. the per-stage latency histograms
    (``automodel_serve_stage_seconds_bucket{stage="prefill",le=...}``)
    that make a stage regression visible at scrape time, not just in the
    span JSONL."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        label,
        buckets: Sequence[float] = LATENCY_BUCKETS,
    ):
        super().__init__(name, help_text, label)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name}: empty buckets")
        self.buckets = bs
        self.children: dict[tuple, Histogram] = {}

    def observe(self, label_value, v: float) -> None:
        key = self._key(label_value)
        with self._lock:
            child = self.children.get(key)
            if child is None:
                child = self.children[key] = Histogram(
                    self.name, self.help, buckets=self.buckets
                )
            child.observe(v)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self.children.items())
        lines: list[str] = []
        for key, child in items:
            labels = self._label_str(key)
            cum = 0
            for b, c in zip(child.buckets, child.counts):
                cum += c
                lines.append(
                    f'{self.name}_bucket{{{labels},le="{_fmt(b)}"}} {cum}'
                )
            lines.append(
                f'{self.name}_bucket{{{labels},le="+Inf"}} '
                f"{cum + child.inf_count}"
            )
            lines.append(f"{self.name}_sum{{{labels}}} {_fmt(child.sum)}")
            lines.append(f"{self.name}_count{{{labels}}} {child.count}")
        return lines

    @property
    def render_name(self) -> str:
        return self.name


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self, name: str, help_text: str, buckets: Sequence[float] = LATENCY_BUCKETS
    ):
        super().__init__(name, help_text)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name}: empty buckets")
        self.buckets = bs
        self.counts = [0] * len(bs)  # non-cumulative per-bucket counts
        self.inf_count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        if v != v:  # NaN observations poison sum and help nobody
            return
        self.sum += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.inf_count += 1

    @property
    def count(self) -> int:
        return sum(self.counts) + self.inf_count

    def render(self) -> list[str]:
        lines, cum = [], 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum + self.inf_count}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {self.count}")
        return lines

    @property
    def render_name(self) -> str:
        return self.name


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self.lock = threading.Lock()

    def _register(self, metric: _Metric) -> _Metric:
        existing = self._metrics.get(metric.name)
        if existing is not None:
            if type(existing) is not type(metric):
                raise ValueError(
                    f"metric {metric.name} already registered as {existing.kind}"
                )
            return existing
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help_text: str) -> Counter:
        with self.lock:
            return self._register(Counter(name, help_text))  # type: ignore[return-value]

    def gauge(self, name: str, help_text: str) -> Gauge:
        with self.lock:
            return self._register(Gauge(name, help_text))  # type: ignore[return-value]

    def labeled_counter(
        self, name: str, help_text: str, label: str
    ) -> LabeledCounter:
        with self.lock:
            return self._register(LabeledCounter(name, help_text, label))  # type: ignore[return-value]

    def labeled_gauge(self, name: str, help_text: str, label) -> LabeledGauge:
        with self.lock:
            return self._register(LabeledGauge(name, help_text, label))  # type: ignore[return-value]

    def labeled_histogram(
        self,
        name: str,
        help_text: str,
        label,
        buckets: Sequence[float] = LATENCY_BUCKETS,
    ) -> LabeledHistogram:
        with self.lock:
            return self._register(
                LabeledHistogram(name, help_text, label, buckets)
            )  # type: ignore[return-value]

    def histogram(
        self, name: str, help_text: str, buckets: Sequence[float] = LATENCY_BUCKETS
    ) -> Histogram:
        with self.lock:
            return self._register(Histogram(name, help_text, buckets))  # type: ignore[return-value]

    def render(self) -> str:
        """→ the full exposition body (text format 0.0.4). HELP text is
        escaped per the spec (``\\`` → ``\\\\``, newline → ``\\n``) so the
        a federation parser round-trips it exactly."""
        with self.lock:
            out: list[str] = []
            for name in sorted(self._metrics):
                m = self._metrics[name]
                help_text = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                out.append(f"# HELP {m.render_name} {help_text}")
                out.append(f"# TYPE {m.render_name} {m.kind}")
                out.extend(m.render())
            return "\n".join(out) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- serving-side metric set ---------------------------------------------------


class ServingMetrics:
    """The serving registry: histograms observed per completed request (from
    the scheduler thread), gauges + pool counters synced from engine state
    at scrape time (``sync`` — called under the engine lock, so a scrape is
    a consistent snapshot and the hot loop pays nothing per step)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry or MetricsRegistry()
        self.registry = r
        self.ttft = r.histogram(
            "automodel_serve_ttft_seconds",
            "Time from submit to first token, per completed request",
        )
        self.decode_tps = r.histogram(
            "automodel_serve_decode_tps",
            "Decode tokens/second per completed request",
            buckets=THROUGHPUT_BUCKETS,
        )
        self.queue_wait = r.histogram(
            "automodel_serve_queue_seconds",
            "Time from submit to admission, per completed request",
        )
        self.completed = r.counter(
            "automodel_serve_requests_completed",
            "Requests completed since engine start",
        )
        self.gen_tokens = r.counter(
            "automodel_serve_generated_tokens",
            "Tokens generated since engine start",
        )
        self.queue_depth = r.gauge(
            "automodel_serve_queue_depth", "Requests waiting for admission"
        )
        self.running = r.gauge(
            "automodel_serve_running_slots", "Slots in the decode wave"
        )
        self.prefilling = r.gauge(
            "automodel_serve_prefilling_slots", "Slots mid-prefill"
        )
        self.occupancy = r.gauge(
            "automodel_serve_block_occupancy",
            "Fraction of the usable KV block pool referenced by live sequences",
        )
        self.blocks_in_use = r.gauge(
            "automodel_serve_blocks_in_use", "KV blocks referenced by live sequences"
        )
        # robustness counters (serving/engine.py drain/deadline/shed/stall)
        self.failed = r.counter(
            "automodel_serve_requests_failed",
            "Requests terminated without completing (timeout/drain/stall/error)",
        )
        self.shed = r.counter(
            "automodel_serve_requests_shed",
            "Requests rejected at submit because the admission queue was full",
        )
        self.timeouts = r.counter(
            "automodel_serve_requests_timeout",
            "Requests cancelled by deadline_s / max_queue_wait_s expiry",
        )
        # multi-tenant QoS (serving.qos: — docs/serving.md "Multi-tenant
        # QoS"): per-tier / per-tenant terminal outcomes plus the per-tier
        # ttft histogram the per-tier SLO burn objectives judge. Labeled
        # families federate into automodel_fleet_* with labels intact.
        self.quota = r.counter(
            "automodel_serve_requests_quota",
            "Requests rejected by a tenant token-bucket quota",
        )
        self.tier_requests = r.labeled_counter(
            "automodel_serve_tier_requests",
            "Terminal requests by QoS tier and completion_reason",
            ("tier", "reason"),
        )
        self.tenant_requests = r.labeled_counter(
            "automodel_serve_tenant_requests",
            "Terminal requests by tenant and completion_reason",
            ("tenant", "reason"),
        )
        self.tier_ttft = r.labeled_histogram(
            "automodel_serve_tier_ttft_seconds",
            "Time from submit to first token by QoS tier, per completed "
            "request",
            "tier",
            buckets=LATENCY_BUCKETS,
        )
        self.stalls = r.counter(
            "automodel_serve_engine_stalls",
            "Wedged decode/prefill steps detected by the engine watchdog",
        )
        self.engine_errors = r.counter(
            "automodel_serve_engine_errors",
            "Scheduler exceptions recovered by a pool rebuild",
        )
        self.draining = r.gauge(
            "automodel_serve_draining", "1 while the server is draining"
        )
        self.drain_duration = r.gauge(
            "automodel_serve_drain_duration_seconds",
            "Wall time from drain start to the last in-flight completion "
            "(0 until a drain finishes)",
        )
        # speculative decoding (serving.speculative:) — draft acceptance
        self.spec_accepted = r.counter(
            "automodel_serve_spec_accepted",
            "Draft tokens accepted by the speculative verify rule",
        )
        self.spec_rejected = r.counter(
            "automodel_serve_spec_rejected",
            "Draft tokens rejected by the speculative verify rule",
        )
        self.spec_accept_rate = r.gauge(
            "automodel_serve_spec_accept_rate",
            "Engine-lifetime draft acceptance rate (0 until a round runs)",
        )
        # per-stage latency from request trace spans (the engine's Tracer
        # ``observe`` hook, observe_stage)
        self.stage_seconds = r.labeled_histogram(
            "automodel_serve_stage_seconds",
            "Per-stage latency from request trace spans, by stage name",
            "stage",
        )
        # host spill tier occupancy (serving.kv_spill:) — gauges because the
        # tier's own LRU both grows and shrinks it
        self.spill_bytes = r.gauge(
            "automodel_serve_spill_bytes",
            "Host spill tier resident bytes (0 when serving.kv_spill is off)",
        )
        self.spill_entries = r.gauge(
            "automodel_serve_spill_entries",
            "Prefix blocks resident in the host spill tier",
        )
        # disaggregated prefill→decode handoffs (the /stats front always
        # reported this; the drift guard surfaced the missing metric)
        self.kv_injected = r.counter(
            "automodel_serve_kv_injected",
            "Prefill→decode KV handoffs admitted into this pool",
        )
        # elastic fleet (serving.warm_start:): startup→first-readiness
        # wall time — the peer-warm-start-vs-cold-load A/B number (0 until
        # the replica's first readiness)
        self.time_to_ready = r.gauge(
            "automodel_serve_time_to_ready_seconds",
            "Wall time from process start to first /readyz true "
            "(0 until ready; boot source rides /stats boot_source)",
        )
        # live weight hot-swap (engine.swap_weights): the weights
        # generation this replica serves — per-replica version skew during
        # a rolling update is this gauge federated across the fleet
        self.weights_version = r.gauge(
            "automodel_serve_weights_version",
            "Monotonic weights generation currently being served "
            "(bumps on each applied hot-swap)",
        )
        self._pool_counters = {
            key: r.counter(f"automodel_serve_block_{key}", help_text)
            for key, help_text in (
                ("allocated", "KV blocks handed out by the allocator"),
                ("freed", "KV blocks returned to the allocator"),
                ("evictions", "Prefix-cache blocks evicted to satisfy allocations"),
                ("failed_allocs", "Allocations the pool could not satisfy"),
                ("prefix_hits", "Requests that matched >= 1 cached prefix block"),
                ("prefix_blocks_reused", "Prefix-cache blocks reused by admissions"),
                ("prefix_tokens_reused", "Prompt tokens served from the prefix cache"),
                # hierarchical KV cache (serving.kv_spill:) — token-weighted
                # hit accounting + host-tier / peer-fetch traffic
                ("prefix_hit_tokens", "Matchable prompt tokens served from any cache tier"),
                ("prefix_miss_tokens", "Matchable prompt tokens that recomputed"),
                ("spilled_blocks", "Evicted prefix blocks copied device->host into the spill tier"),
                ("spill_reloaded_blocks", "Spilled blocks reloaded host->device at admission"),
                ("spill_reloads", "Admissions that reloaded >= 1 spilled block"),
                ("peer_fetch_blocks", "Prefix blocks fetched from a peer replica over /kv_fetch"),
                ("peer_fetches", "Completed peer /kv_fetch RPCs"),
                ("peer_fetch_failures", "Peer /kv_fetch attempts that fell back to local recompute"),
            )
        }

    def observe_request(self, rec: dict) -> None:
        """Per-completion observation (serving/engine.py ``_finish``)."""
        with self.registry.lock:
            if isinstance(rec.get("ttft_s"), (int, float)):
                self.ttft.observe(rec["ttft_s"])
            if isinstance(rec.get("decode_tps"), (int, float)):
                self.decode_tps.observe(rec["decode_tps"])
            if isinstance(rec.get("queue_s"), (int, float)):
                self.queue_wait.observe(rec["queue_s"])
            self.completed.inc()
            self.gen_tokens.inc(rec.get("n_generated", 0) or 0)

    def observe_stage(self, stage: str, duration_s: float) -> None:
        """Per-span stage observation (the engine's Tracer ``observe``
        hook). A negative duration is a clock bug the JSONL lint flags; it
        must not also poison the histogram sum. The labelled histogram
        takes its own lock."""
        if duration_s < 0:
            return
        self.stage_seconds.observe(stage, duration_s)

    def observe_failure(self, reason: str) -> None:
        """Per-termination observation for a request that did NOT complete
        (serving/engine.py failure paths)."""
        with self.registry.lock:
            self.failed.inc()
            if reason == "timeout":
                self.timeouts.inc()
            elif reason == "shed":
                self.shed.inc()
            elif reason == "quota":
                self.quota.inc()

    def observe_qos(self, rec: dict) -> None:
        """Per-terminal tier/tenant observation (every serve_request record
        carries both; records without them — engine events — no-op). The
        labeled metrics take their own per-metric locks."""
        tier = rec.get("tier")
        tenant = rec.get("tenant")
        reason = rec.get("completion_reason")
        if not tier or not tenant or not reason:
            return
        self.tier_requests.inc((str(tier), str(reason)))
        self.tenant_requests.inc((str(tenant), str(reason)))
        if isinstance(rec.get("ttft_s"), (int, float)):
            self.tier_ttft.observe(str(tier), rec["ttft_s"])

    def observe_engine_event(self, reason: str) -> None:
        """Once per engine-level recovery (pool rebuild after a stall or a
        scheduler exception), not per affected request."""
        with self.registry.lock:
            if reason == "engine_stall":
                self.stalls.inc()
            else:
                self.engine_errors.inc()

    def sync(self, engine) -> None:
        """Pull current scheduler/allocator state (call under the engine
        lock; the serving HTTP handler does this per scrape)."""
        with self.registry.lock:
            self.queue_depth.set(engine.queue_depth)
            running = sum(
                1 for s in engine._slots if s is not None and s.decoding
            )
            prefilling = engine.busy_slots - running
            self.running.set(running)
            self.prefilling.set(prefilling)
            self.occupancy.set(engine.pool.occupancy())
            self.blocks_in_use.set(engine.pool.in_use())
            self.draining.set(1.0 if getattr(engine, "draining", False) else 0.0)
            self.drain_duration.set(
                float(getattr(engine, "drain_duration_s", None) or 0.0)
            )
            for key, counter in self._pool_counters.items():
                counter.set_total(engine.pool.counters.get(key, 0))
            tier = getattr(engine.pool, "spill", None)
            self.spill_bytes.set(float(tier.bytes) if tier is not None else 0.0)
            self.spill_entries.set(float(len(tier)) if tier is not None else 0.0)
            self.kv_injected.set_total(getattr(engine, "kv_injected_total", 0))
            self.time_to_ready.set(
                float(getattr(engine, "time_to_ready_s", None) or 0.0)
            )
            self.weights_version.set(
                float(getattr(engine, "weights_version", 0))
            )
            proposed = getattr(engine, "spec_proposed_total", 0)
            accepted = getattr(engine, "spec_accepted_total", 0)
            self.spec_accepted.set_total(accepted)
            self.spec_rejected.set_total(proposed - accepted)
            self.spec_accept_rate.set(
                accepted / proposed if proposed else 0.0
            )


@dataclasses.dataclass
class MetricsServerConfig:
    """The ``metrics_server:`` YAML section — a standalone training-side
    scrape port (the serving server mounts /metrics on its existing HTTP
    front and needs no section). The section's PRESENCE opts in; port 0
    lets the OS pick (tests)."""

    enabled: bool = True
    port: int = 9100
    host: str = "127.0.0.1"

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "MetricsServerConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TypeError(f"unknown metrics_server keys: {sorted(unknown)}")
        return cls(**d)


# -- training-side metric set --------------------------------------------------

# log-record key → (metric name, help). Gauges: last-logged value.
_TRAIN_GAUGES = {
    "step": ("automodel_train_step", "Last logged optimizer step"),
    "loss": ("automodel_train_loss", "Last logged training loss"),
    "step_time_s": (
        "automodel_train_step_time_seconds",
        "Amortized step time over the last log window",
    ),
    "tps": (
        "automodel_train_tokens_per_second",
        "Tokens/second over the last log window",
    ),
    "tps_per_device": (
        "automodel_train_tokens_per_second_per_device",
        "Tokens/second/device over the last log window",
    ),
    "grad_norm": ("automodel_train_grad_norm", "Last logged global gradient norm"),
    "mfu_pct": (
        "automodel_train_mfu_pct",
        "Analytic MFU percent (flops_utils law) over the last log window",
    ),
    "mfu_measured_pct": (
        "automodel_train_mfu_measured_pct",
        "Measured MFU percent (cost-attributed step program) over the last log window",
    ),
    "heartbeat_age_s": (
        "automodel_train_heartbeat_age_seconds",
        "Watchdog heartbeat age at the last log barrier",
    ),
    "host_input_wait_s": (
        "automodel_train_host_input_wait_seconds",
        "Amortized host time per step acquiring the next batch over the "
        "last log window (collate+stack+H2D when sync; a queue pop when "
        "prefetched)",
    ),
    "prefetch_depth": (
        "automodel_train_prefetch_queue_depth",
        "Device-ready batches the input pipeline holds ahead of the train "
        "loop, sampled at the last log barrier",
    ),
}
_TRAIN_CUMULATIVE = {
    "skipped_steps_total": (
        "automodel_train_skipped_steps",
        "Steps discarded by the non-finite policy",
    ),
    "rollbacks_total": (
        "automodel_train_rollbacks",
        "Checkpoint rollbacks taken by the non-finite policy",
    ),
    "recompiles": (
        "automodel_train_recompiles",
        "Host-side kernel builds after the initial step",
    ),
}
# checkpoint-timing record keys → histogram (name, help) — the goodput
# ledger stamps these on the log record after each operation
_TRAIN_CKPT_HISTOGRAMS = {
    "ckpt_save_s": (
        "automodel_train_ckpt_save_seconds",
        "Checkpoint save wall time (sync write or async staging), per save",
    ),
    "ckpt_restore_s": (
        "automodel_train_ckpt_restore_seconds",
        "Checkpoint restore wall time, per load",
    ),
    "ckpt_drain_s": (
        "automodel_train_ckpt_drain_seconds",
        "Async checkpoint drain + commit wall time, per drained save",
    ),
}
_TRAIN_EVENT_COUNTERS = {
    "hang": ("automodel_train_hang_events", "Watchdog hang detections"),
    "desync": ("automodel_train_desync_events", "Cross-host desync detections"),
    "nonfinite_step": (
        "automodel_train_nonfinite_steps",
        "Steps whose loss/grads were non-finite",
    ),
    "trace_capture": (
        "automodel_train_trace_captures",
        "Triggered profiler captures",
    ),
}


class TrainMetricsExporter:
    """Folds train-loop log records and telemetry events into the registry.
    ``update(record)`` at each log barrier; ``event(name)`` from the guard/
    telemetry event hooks."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry or MetricsRegistry()
        self.registry = r
        self._gauges = {k: r.gauge(*spec) for k, spec in _TRAIN_GAUGES.items()}
        self._cumulative = {
            k: r.counter(*spec) for k, spec in _TRAIN_CUMULATIVE.items()
        }
        self._events = {
            k: r.counter(*spec) for k, spec in _TRAIN_EVENT_COUNTERS.items()
        }
        self._ckpt_hists = {
            k: r.histogram(*spec) for k, spec in _TRAIN_CKPT_HISTOGRAMS.items()
        }
        # goodput run ledger (telemetry/goodput.py): live goodput fraction +
        # net per-segment wall-clock totals for THIS attempt
        self._goodput_fraction = r.gauge(
            "automodel_train_goodput_fraction",
            "Productive step seconds / attempt wall clock so far "
            "(goodput ledger, net of rollback-discarded work)",
        )
        self._goodput_seconds = r.labeled_gauge(
            "automodel_train_goodput_seconds",
            "Attempt wall clock accounted to each goodput segment so far",
            "segment",
        )

    def update(self, record: dict) -> None:
        with self.registry.lock:
            for k, g in self._gauges.items():
                v = record.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    g.set(v)
            for k, c in self._cumulative.items():
                v = record.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    if k == "recompiles":  # per-window count, not cumulative
                        c.inc(v)
                    else:
                        c.set_total(v)
            for k, h in self._ckpt_hists.items():
                v = record.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    h.observe(v)

    def update_goodput(self, snapshot: dict) -> None:
        """Fold a ``GoodputLedger.snapshot()`` (called at each log barrier;
        the labeled gauge takes its own per-metric lock)."""
        frac = snapshot.get("goodput_fraction")
        segments = snapshot.get("segments") or {}
        with self.registry.lock:
            if isinstance(frac, (int, float)):
                self._goodput_fraction.set(frac)
        for kind, seconds in segments.items():
            if isinstance(seconds, (int, float)):
                self._goodput_seconds.set(kind, max(float(seconds), 0.0))

    def event(self, name: str) -> None:
        c = self._events.get(name)
        if c is not None:
            with self.registry.lock:
                c.inc()


# -- standalone metrics port (training side) -----------------------------------


def start_metrics_server(
    registry: MetricsRegistry, port: int, host: str = "127.0.0.1"
):
    """Serve ``GET /metrics`` from a daemon thread → the started
    ThreadingHTTPServer (``.server_address[1]`` has the bound port; pass
    port 0 to let the OS pick — the tests do). ``shutdown()`` stops it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass  # scrapes are not stderr news

        def do_GET(self):
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = registry.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    # a short poll: shutdown() waits one poll, and a run's ledger closes after it
    t = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    return server
