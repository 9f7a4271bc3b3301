"""Lint and summarize a metrics JSONL; validate bench results. A copy of
``automodel_tpu/telemetry/report.py`` (stdlib only), whose rules and
summaries it keeps line for line.

- ``python -m automodel_tpu_torch.cli.app report <path.jsonl> [--strict]``
  prints the summary table and the schema problems (``--strict`` exits 1
  on any): training rows, ``serve_request`` records and the span records
  request tracing writes (``telemetry/tracing.py`` owns their required
  keys).
- ``percentile`` is the linear-interpolation percentile every quantile
  consumer of the port shares (the serving engine's workload stats, the
  benchmark legs, these summaries).
- ``validate_bench_result``: a 0.0 or None leg with no recorded failure
  reason is a reporting bug.

The linter is strict about JSON: bare ``NaN`` / ``Infinity`` tokens (which
``json.dumps`` emits by default and strict readers reject) are flagged per
line; the port's MetricLogger writes a non-finite float as ``null`` with a
``<key>_nonfinite`` marker instead.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy's default method), shared by
    every quantile consumer in the tree — engine/router workload stats, the
    bench serving legs, and the report summaries — so a p50/p99 means the
    same thing everywhere. ``q`` in [0, 1]; → None on an empty input."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    if not (0.0 <= q <= 1.0):
        raise ValueError(f"percentile q={q} (want 0..1)")
    pos = q * (len(vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac

# keys whose presence implies a numeric (or null-with-marker) value
_NUMERIC_KEYS = (
    "loss",
    "grad_norm",
    "tps",
    "tps_per_device",
    "step_time_s",
    "compile_time_s",
    "lr",
    "mfu",
    # input pipeline (data/prefetch.py): per-log-window host input wait
    # beside step_time_s, + the prefetch run-ahead gauge
    "host_input_wait_s",
    "prefetch_depth",
    "pp_bubble_fraction",
    "expert_load_imbalance",
    # generation records (in-training eval sampling + the bench decode leg)
    "ttft_s",
    "decode_tps",
    "gen_tokens",
    "gen_cache_bytes",
    # serving records (serving/: per-request `serve_request` events + the
    # sustained-throughput bench leg)
    "queue_s",
    "queue_depth",
    "block_occupancy",
    "prefix_hit_tokens",
    "prefix_miss_tokens",
    "serve_tokens_per_s",
    "serve_ttft_p50_s",
    "serve_ttft_p99_s",
    "serve_block_occupancy_peak",
    "serve_requests",
    # speculative decoding (serving.speculative:): per-request acceptance
    # + the bench leg's aggregate accept-rate/draft-throughput keys
    "spec_proposed",
    "spec_accepted",
    "spec_accept_rate",
    "serve_accept_rate",
    "serve_draft_tps",
    # serving robustness: drain/deadline/stall evidence
    "drain_duration_s",
    "requests_failed",
    # fleet router (serving/fleet/): per-request `route_request` events +
    # the routed bench sub-leg's aggregate keys
    "retries",
    "prefix_match_blocks",
    "route_s",
    "serve_fleet_tokens_per_s",
    "serve_route_prefix_hit_rate",
    "serve_fleet_retries",
    "serve_fleet_replicas",
    "serve_fleet_requests",
    "serve_fleet_kv_handoffs",
    # hierarchical KV cache (serving.kv_spill:): the spill A/B bench
    # sub-leg's aggregate keys — spill-on throughput/ttft on the replayed
    # arrival schedule, the token-weighted effective hit rate, and how many
    # admissions reloaded spilled blocks
    "serve_spill_tokens_per_s",
    "serve_spill_ttft_p50_s",
    "serve_effective_hit_rate",
    "serve_spill_reloads",
    # distributed guard (watchdog liveness, consensus/straggler attribution)
    "heartbeat_age_s",
    "deadline_s",
    "ema_step_time_s",
    "slowest_host",
    "host_step_time_max_s",
    "host_step_time_median_s",
    "straggler_ratio",
    # profiling pillar (telemetry/profiling/): per-window MFU provenances +
    # the cost_attribution event's measured program numbers + the
    # trace_capture event's trigger evidence
    "mfu_pct",
    "mfu_measured_pct",
    "flops",
    "dot_flops",
    "conv_flops",
    "bytes_est",
    "elementwise_bytes",
    "collective_bytes",
    "hlo_flops",
    "hlo_bytes",
    "arithmetic_intensity",
    "ridge_intensity",
    "comm_fraction",
    "factor",
    # kernel microbench records (tools/kernel_bench.py `kernel_bench`
    # events): per-candidate timing + the per-program measured MFU that
    # surfaces kernel regressions in the same JSONL pipeline as training
    "kernel_ms",
    "kernel_flops",
    "kernel_tflops",
    "kernel_mfu_measured_pct",
    "kernel_bench_winners",
    # request tracing (telemetry/tracing.py `span` events)
    "duration_s",
    # fleet health plane (telemetry/slo.py `slo_alert` events): the measured
    # objective value + its threshold at each transition, and the firing
    # dwell stamped on the resolved record
    "slo_value",
    "slo_threshold",
    "slo_firing_s",
    # goodput run ledger (telemetry/goodput.py): attempt envelope + the
    # checkpoint-timing stamps on the record AFTER each operation + the
    # boundary time the amortized windows exclude
    "restart_count",
    "ckpt_save_s",
    "ckpt_restore_s",
    "ckpt_drain_s",
    "window_excluded_s",
    # elastic fleet (serving/fleet/autoscale.py): `scale_event` envelopes,
    # the `replica_ready` boot stamp, and the retiring replica's
    # `migration_*` outcome records
    "time_to_ready_s",
    "replicas_before",
    "replicas_after",
    "migrated_blocks",
    "hot_blocks",
    "retire_s",
    # post-training (posttrain/): DPO/ORPO preference metrics beside loss,
    # GRPO reward/KL metrics, the per-window rollout/reward wall stamps,
    # and the weights generation on weight_swap / rolling_update events
    "dpo_loss",
    "accept_margin",
    "reward_mean",
    "kl_to_ref",
    "rollout_s",
    "reward_s",
    "weights_version",
)

# keys that are wall-time durations and can never legitimately be negative:
# a negative value means mixed clocks (a wall-clock timestamp subtracted
# from a monotonic one) — exactly the corruption the per-process WallAnchor
# exists to prevent, so --strict flags it
_DURATION_KEYS = (
    "duration_s",
    "queue_s",
    "ttft_s",
    "route_s",
    "step_time_s",
    "compile_time_s",
    "drain_duration_s",
    "host_input_wait_s",
    "recompile_secs",
    "ckpt_save_s",
    "ckpt_restore_s",
    "ckpt_drain_s",
    "window_excluded_s",
    "slo_firing_s",
    "time_to_ready_s",
    "retire_s",
    "rollout_s",
    "reward_s",
)

# the slo_alert state machine's legal states (telemetry/slo.py) — anything
# else in a record means a foreign writer or corruption
_SLO_STATES = ("pending", "firing", "resolved", "cleared")

# a span record must carry these to be assemblable by `automodel_tpu trace`
# — ONE schema, owned by the tracing module (its read_span_records applies
# the same keys); the string ids here, the numeric keys checked separately
from automodel_tpu_torch.telemetry.tracing import SPAN_REQUIRED_KEYS as _SPAN_KEYS

_SPAN_REQUIRED = tuple(k for k in _SPAN_KEYS if k not in ("duration_s", "ts"))


def _strict_loads(line: str) -> Any:
    def _reject(tok: str):
        raise ValueError(f"bare {tok} token (non-strict JSON)")

    return json.loads(line, parse_constant=_reject)


def lint_metrics_jsonl(path: str) -> tuple[list[dict], list[str]]:
    """→ (parsed records, problems). Problems are human-readable strings
    with 1-based line numbers; parsing continues past bad lines."""
    records: list[dict] = []
    problems: list[str] = []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        return [], [f"cannot read {path}: {e}"]
    last_step: Optional[int] = None
    pending_resume = None  # True = bare marker; int = resumed_from_step
    last_restart: Optional[int] = None
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            rec = _strict_loads(line)
        except ValueError as e:
            problems.append(f"line {i}: {e}")
            continue
        if not isinstance(rec, dict):
            problems.append(f"line {i}: record is not an object")
            continue
        records.append(rec)
        if "ts" not in rec:
            problems.append(f"line {i}: missing ts")
        if rec.get("event") in ("resume", "rollback"):
            # one marker excuses ONE rewind (to resumed_from_step+1 when the
            # marker carries it); a sticky excuse would let genuine
            # corruption later in a resumed file slip past --strict
            rf = rec.get("resumed_from_step")
            pending_resume = rf if isinstance(rf, int) else True
        rc = rec.get("restart_count")
        if isinstance(rc, int) and not isinstance(rc, bool):
            # the attempt envelope is append-only across requeues: within
            # one file restart_count may only grow — a regression means two
            # runs interleaved into one file, or corruption
            if last_restart is not None and rc < last_restart:
                problems.append(
                    f"line {i}: restart_count went backwards "
                    f"({last_restart} -> {rc}) — attempts are append-only; "
                    "a regression means interleaved runs or corruption"
                )
            last_restart = rc
        step = rec.get("step")
        if step is not None:
            if not isinstance(step, int):
                problems.append(f"line {i}: step is not an int: {step!r}")
            else:
                if last_step is not None and step < last_step:
                    # the rewound step need only land PAST the restore point
                    # (`>` not `== +1`: with log_every_steps=N the first
                    # post-resume record is the next multiple of N)
                    if pending_resume is True or (
                        isinstance(pending_resume, int)
                        and step > pending_resume
                    ):
                        # a legitimate rewind: a recorded resume (checkpoint
                        # walk-back after preemption, on_nonfinite rollback)
                        # retrains step numbers in the same JSONL. Surfaced
                        # as resume_points in the summary, not corruption.
                        rec["_resume_point"] = True
                    else:
                        problems.append(
                            f"line {i}: step went backwards ({last_step} -> "
                            f"{step}) with no matching resume/rollback marker"
                        )
                # the first step record after a marker consumes it, rewind
                # or not (a forward resume needs no excuse later)
                pending_resume = None
                last_step = step
        for k in _NUMERIC_KEYS:
            if k in rec and rec[k] is not None and not isinstance(rec[k], (int, float)):
                problems.append(f"line {i}: {k} is not numeric: {rec[k]!r}")
            if k in rec and rec[k] is None and not rec.get(f"{k}_nonfinite"):
                problems.append(f"line {i}: {k} is null without a {k}_nonfinite marker")
        for k in _DURATION_KEYS:
            v = rec.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool) and v < 0:
                problems.append(
                    f"line {i}: {k} is negative ({v}) — durations are "
                    "monotonic differences and cannot go backwards; a "
                    "negative value means mixed wall/monotonic clocks"
                )
        if rec.get("event") in ("serve_request", "route_request"):
            # multi-tenant QoS labels ride the request records as plain
            # strings; anything else means a foreign writer or corruption
            for k in ("tenant", "tier"):
                v = rec.get(k)
                if v is not None and not isinstance(v, str):
                    problems.append(
                        f"line {i}: {k} is not a string: {v!r}"
                    )
        if rec.get("event") == "slo_alert":
            if not isinstance(rec.get("slo"), str) or not rec.get("slo"):
                problems.append(f"line {i}: slo_alert record has no slo name")
            if rec.get("state") not in _SLO_STATES:
                problems.append(
                    f"line {i}: slo_alert state {rec.get('state')!r} not in "
                    f"{'/'.join(_SLO_STATES)}"
                )
        if rec.get("event") == "span":
            missing = [
                k for k in _SPAN_REQUIRED
                if not isinstance(rec.get(k), str) or not rec.get(k)
            ]
            if missing:
                problems.append(f"line {i}: span record missing {missing}")
            if not isinstance(rec.get("duration_s"), (int, float)):
                problems.append(f"line {i}: span record has no duration_s")
            # "ts" absence is already flagged for every record above; a
            # non-numeric one would break assembly ordering too
            if "ts" in rec and not isinstance(rec.get("ts"), (int, float)):
                problems.append(f"line {i}: span ts is not numeric")
    return records, problems


def summarize_metrics(records: list[dict]) -> dict[str, Any]:
    train = [r for r in records if "loss" in r]
    tps = [r["tps"] for r in train if isinstance(r.get("tps"), (int, float))]
    step_t = [r["step_time_s"] for r in train if isinstance(r.get("step_time_s"), (int, float))]
    nonfinite_steps = [r.get("step") for r in records if r.get("nonfinite")]
    recompiles = sum(r.get("recompiles", 0) or 0 for r in records)
    out = {
        "records": len(records),
        "train_steps_logged": len(train),
        "first_loss": train[0]["loss"] if train else None,
        "last_loss": train[-1]["loss"] if train else None,
        "tps_mean": sum(tps) / len(tps) if tps else None,
        "step_time_mean_s": sum(step_t) / len(step_t) if step_t else None,
        "nonfinite_steps": nonfinite_steps,
        "recompiles_after_first_step": recompiles,
    }
    resumes = [r.get("step") for r in records if r.get("_resume_point")]
    if resumes:
        out["resume_points"] = resumes
    # distributed-guard events: a hang or desync anywhere in the file is
    # the headline of that run — surface it unconditionally
    hangs = [r for r in records if r.get("event") == "hang"]
    if hangs:
        out["hang_events"] = [
            {"step": r.get("step"), "heartbeat_age_s": r.get("heartbeat_age_s")}
            for r in hangs
        ]
    desyncs = [r for r in records if r.get("event") == "desync"]
    if desyncs:
        out["desync_events"] = [
            {"step": r.get("step"), "hosts": r.get("desync_hosts")}
            for r in desyncs
        ]
    stragglers = [
        r["straggler_ratio"]
        for r in records
        if isinstance(r.get("straggler_ratio"), (int, float))
    ]
    if stragglers:
        out["straggler_ratio_max"] = max(stragglers)
    mfu = [r["mfu"] for r in records if isinstance(r.get("mfu"), (int, float))]
    if mfu:
        out["mfu_mean"] = sum(mfu) / len(mfu)
    # profiling pillar: analytic vs measured MFU ride the same records; the
    # cost_attribution event carries roofline class, the trace_capture
    # events are anomaly evidence worth headlining
    for key in ("mfu_pct", "mfu_measured_pct", "host_input_wait_s"):
        vals = [r[key] for r in records if isinstance(r.get(key), (int, float))]
        if vals:
            out[f"{key}_mean"] = sum(vals) / len(vals)
    # goodput envelope + checkpoint-timing rollups: how many attempts this
    # file spans and what the checkpoint machinery cost in wall clock
    # (whole-run segment decomposition lives in `automodel_tpu goodput`)
    attempt_ids = [
        r["attempt_id"] for r in records if isinstance(r.get("attempt_id"), str)
    ]
    if attempt_ids:
        out["attempts"] = len(dict.fromkeys(attempt_ids))
        rcs = [
            r["restart_count"] for r in records
            if isinstance(r.get("restart_count"), int)
            and not isinstance(r.get("restart_count"), bool)
        ]
        if rcs:
            out["restart_count_max"] = max(rcs)
    for key in ("ckpt_save_s", "ckpt_restore_s", "ckpt_drain_s", "window_excluded_s"):
        vals = [r[key] for r in records if isinstance(r.get(key), (int, float))]
        if vals:
            out[f"{key}_total"] = round(sum(vals), 6)
    costs = [r for r in records if r.get("event") == "cost_attribution"]
    if costs:
        out["cost_programs"] = [
            {
                "program": r.get("program"),
                "roofline_class": r.get("roofline_class"),
                "flops": r.get("flops"),
            }
            for r in costs
        ]
    captures = [r for r in records if r.get("event") == "trace_capture"]
    if captures:
        out["trace_captures"] = [
            {
                "step": r.get("step"),
                "reason": r.get("reason"),
                "capture_path": r.get("capture_path"),
                "skipped": r.get("skipped"),
            }
            for r in captures
        ]
    # kernel sweep records (tools/kernel_bench.py): best TFLOP/s + measured
    # MFU per kernel, so a tile regression reads off the same report as a
    # training regression
    kb = [r for r in records if r.get("event") == "kernel_bench"]
    if kb:
        out["kernel_bench_records"] = len(kb)
        best: dict[str, float] = {}
        for r in kb:
            name = r.get("kernel")
            tf = r.get("kernel_tflops")
            if isinstance(name, str) and isinstance(tf, (int, float)):
                best[name] = max(best.get(name, float("-inf")), tf)
        if best:
            out["kernel_tflops_best"] = dict(sorted(best.items()))
        mfus = [
            r["kernel_mfu_measured_pct"] for r in kb
            if isinstance(r.get("kernel_mfu_measured_pct"), (int, float))
        ]
        if mfus:
            out["kernel_mfu_measured_pct_max"] = max(mfus)
        fails = [r for r in kb if r.get("ok") is False]
        if fails:
            out["kernel_bench_failures"] = len(fails)
    gens = [r for r in records if r.get("event") == "generation"]
    if gens:
        out["generation_records"] = len(gens)
        tpses = [
            r["decode_tps"]
            for r in gens
            if isinstance(r.get("decode_tps"), (int, float))
        ]
        if tpses:
            out["decode_tps_mean"] = sum(tpses) / len(tpses)
    serves = [r for r in records if r.get("event") == "serve_request"]
    if serves:
        out["serve_requests"] = len(serves)
        ttfts = sorted(
            r["ttft_s"] for r in serves
            if isinstance(r.get("ttft_s"), (int, float))
        )
        if ttfts:
            out["serve_ttft_p50_s"] = percentile(ttfts, 0.50)
            out["serve_ttft_p99_s"] = percentile(ttfts, 0.99)
            out["serve_ttft_max_s"] = ttfts[-1]
        occ = [
            r["block_occupancy"] for r in serves
            if isinstance(r.get("block_occupancy"), (int, float))
        ]
        if occ:
            out["serve_block_occupancy_peak"] = max(occ)
        # speculative decoding: aggregate acceptance over the file's
        # requests (token-weighted, not a mean of per-request rates)
        sp = sum(
            r["spec_proposed"] for r in serves
            if isinstance(r.get("spec_proposed"), int)
        )
        sa = sum(
            r["spec_accepted"] for r in serves
            if isinstance(r.get("spec_accepted"), int)
        )
        if sp:
            out["serve_spec_proposed"] = sp
            out["serve_spec_accepted"] = sa
            out["serve_accept_rate"] = round(sa / sp, 4)
        # completion-reason histogram: shed/timeout/stall/drain
        # terminations are the headline of a run that had them
        reasons: dict[str, int] = {}
        for r in serves:
            cr = r.get("completion_reason")
            if isinstance(cr, str):
                reasons[cr] = reasons.get(cr, 0) + 1
        if reasons:
            out["serve_completion_reasons"] = dict(sorted(reasons.items()))
            for reason, key in (
                ("shed", "serve_shed"),
                ("timeout", "serve_timeouts"),
                ("quota", "serve_quota"),
            ):
                if reasons.get(reason):
                    out[key] = reasons[reason]
        # multi-tenant QoS rollups: per-tier shed/timeout histograms (the
        # overload story — which tier paid for the pressure) and the
        # per-tenant quota bill
        by_tier: dict[str, dict[str, int]] = {}
        for r in serves:
            tier, cr = r.get("tier"), r.get("completion_reason")
            if isinstance(tier, str) and isinstance(cr, str):
                c = by_tier.setdefault(tier, {})
                c[cr] = c.get(cr, 0) + 1
        for reason, key in (
            ("shed", "serve_shed_by_tier"),
            ("timeout", "serve_timeouts_by_tier"),
        ):
            hist = {
                t: c[reason] for t, c in sorted(by_tier.items())
                if c.get(reason)
            }
            if hist:
                out[key] = hist
        quotas: dict[str, int] = {}
        for r in serves:
            if r.get("completion_reason") == "quota" and isinstance(
                r.get("tenant"), str
            ):
                quotas[r["tenant"]] = quotas.get(r["tenant"], 0) + 1
        if quotas:
            out["serve_quota_by_tenant"] = dict(sorted(quotas.items()))
    routes = [r for r in records if r.get("event") == "route_request"]
    if routes:
        # fleet router records: every routed request's terminal outcome —
        # the per-replica spread, the retry bill, and the affinity hit rate
        out["route_requests"] = len(routes)
        out["route_retries"] = sum(
            r["retries"] for r in routes if isinstance(r.get("retries"), int)
        )
        hits = sum(
            1 for r in routes
            if isinstance(r.get("prefix_match_blocks"), int)
            and r["prefix_match_blocks"] > 0
        )
        out["route_prefix_hit_rate"] = round(hits / len(routes), 4)
        by_replica: dict[str, int] = {}
        for r in routes:
            name = r.get("replica")
            if isinstance(name, str):
                by_replica[name] = by_replica.get(name, 0) + 1
        if by_replica:
            out["route_replicas"] = dict(sorted(by_replica.items()))
        unroutable = sum(
            1 for r in routes if r.get("completion_reason") == "unroutable"
        )
        if unroutable:
            out["route_unroutable"] = unroutable
        handoffs = sum(1 for r in routes if r.get("disaggregated"))
        if handoffs:
            out["route_kv_handoffs"] = handoffs
    spans = [r for r in records if r.get("event") == "span"]
    if spans:
        # request-tracing rollups: per-stage p50/p99 so "where did the time
        # go" reads off the same summary as throughput. Orphan adjudication
        # across PROCESSES belongs to `automodel_tpu trace` (it sees every
        # file); here the count covers only this one file's spans, so a
        # per-process file legitimately shows cross-process parents as
        # orphans — surfaced as data, not flagged as a problem.
        out["span_records"] = len(spans)
        out["span_traces"] = len({
            r["trace_id"] for r in spans if isinstance(r.get("trace_id"), str)
        })
        ids = {r.get("span_id") for r in spans}
        out["span_orphans_in_file"] = sum(
            1 for r in spans
            if r.get("parent_id") and r["parent_id"] not in ids
        )
        by_stage: dict[str, list[float]] = {}
        for r in spans:
            stage, dur = r.get("stage"), r.get("duration_s")
            if isinstance(stage, str) and isinstance(dur, (int, float)):
                by_stage.setdefault(stage, []).append(float(dur))
        if by_stage:
            out["span_stages"] = {
                stage: {
                    "count": len(durs),
                    "p50_s": round(percentile(durs, 0.50), 6),
                    "p99_s": round(percentile(durs, 0.99), 6),
                }
                for stage, durs in sorted(by_stage.items())
            }
    alerts = [r for r in records if r.get("event") == "slo_alert"]
    if alerts:
        # fleet health plane: SLO alerting is the headline of a run that had
        # it — per-SLO fire counts, the firing wall-clock bill (summed off
        # the slo_firing_s each resolved record carries), and any objective
        # the file leaves pending/firing (breach outlived the run)
        out["slo_alerts"] = len(alerts)
        fired: dict[str, int] = {}
        firing_s: dict[str, float] = {}
        last_state: dict[str, str] = {}
        for r in alerts:
            name = r.get("slo")
            if not isinstance(name, str) or not name:
                continue
            st = r.get("state")
            if st == "firing":
                fired[name] = fired.get(name, 0) + 1
            fs = r.get("slo_firing_s")
            if isinstance(fs, (int, float)) and not isinstance(fs, bool):
                firing_s[name] = firing_s.get(name, 0.0) + float(fs)
            if isinstance(st, str):
                last_state[name] = st
        if fired:
            out["slo_fired"] = dict(sorted(fired.items()))
        if firing_s:
            out["slo_firing_s_total"] = {
                k: round(v, 3) for k, v in sorted(firing_s.items())
            }
        unresolved = sorted(
            n for n, st in last_state.items() if st in ("pending", "firing")
        )
        if unresolved:
            out["slo_unresolved_at_exit"] = unresolved
    scales = [r for r in records if r.get("event") == "scale_event"]
    if scales:
        # elastic fleet: every scale event with its trigger and size step,
        # in file order — the autoscaler's whole story reads off the
        # summary, including how fast each spawned replica came up
        out["scale_events"] = [
            {
                "direction": r.get("direction"),
                "trigger": r.get("trigger"),
                "replicas_before": r.get("replicas_before"),
                "replicas_after": r.get("replicas_after"),
            }
            for r in scales
        ]
        out["scale_ups"] = sum(
            1 for r in scales if r.get("direction") == "up"
        )
        out["scale_downs"] = sum(
            1 for r in scales if r.get("direction") == "down"
        )
    boots = [r for r in records if r.get("event") == "replica_ready"]
    if boots:
        # time-to-ready by boot source: the warm-start vs cold-load A/B is
        # exactly these two buckets side by side
        by_src: dict[str, list[float]] = {}
        for r in boots:
            src = r.get("boot_source")
            ttr = r.get("time_to_ready_s")
            if isinstance(src, str) and isinstance(ttr, (int, float)):
                by_src.setdefault(src, []).append(float(ttr))
        out["replica_boots"] = {
            src: {
                "count": len(ts),
                "time_to_ready_p50_s": round(percentile(ts, 0.50), 6),
                "max_s": round(max(ts), 6),
            }
            for src, ts in sorted(by_src.items())
        }
    migrations = [
        r for r in records
        if r.get("event") in (
            "migration_complete", "migration_failed", "migration_skipped"
        )
    ]
    if migrations:
        out["prefix_migrations"] = {
            "complete": sum(
                1 for r in migrations
                if r["event"] == "migration_complete"
            ),
            "failed": sum(
                1 for r in migrations if r["event"] == "migration_failed"
            ),
            "skipped": sum(
                1 for r in migrations if r["event"] == "migration_skipped"
            ),
            "migrated_blocks": sum(
                int(r.get("migrated_blocks") or 0) for r in migrations
            ),
        }
    stalls = [r for r in records if r.get("event") == "serve_engine_event"]
    if stalls:
        out["serve_engine_events"] = [
            {
                "reason": r.get("reason"),
                "step": r.get("step"),
                "requests_failed": r.get("requests_failed"),
            }
            for r in stalls
        ]
        out["serve_stalls"] = sum(
            1 for r in stalls if r.get("reason") == "engine_stall"
        )
    return out


def format_table(summary: dict[str, Any]) -> str:
    rows = [(k, v) for k, v in summary.items()]
    width = max(len(k) for k, _ in rows)
    lines = []
    for k, v in rows:
        if isinstance(v, float):
            v = f"{v:.6g}"
        lines.append(f"{k:<{width}}  {v}")
    return "\n".join(lines)


# -- bench-result validation: a leg that never ran must not read as a zero --

# (value key, failure-reason key) per bench leg — bench.py's output dict and
# the benchmark recipe's generation (decode) leg
_BENCH_LEGS = (
    ("value", "dense_failure"),
    ("qlora_8b_mfu_pct", "qlora_8b_failure"),
    ("moe_mfu_pct", "moe_failures"),
    ("gen_decode_tps", "gen_failure"),
    ("serve_tokens_per_s", "serve_failure"),
    # speculative sub-leg: a null accept rate must name why (spec disabled,
    # engine failure, no round ran) — never read as "measured zero"
    ("serve_accept_rate", "serve_spec_failure"),
    # routed fleet sub-leg (serving/fleet/): same contract — absent fleet:
    # section / any failure records its reason, never a silent null/zero
    ("serve_fleet_tokens_per_s", "serve_fleet_failure"),
    ("serve_route_prefix_hit_rate", "serve_fleet_failure"),
    # hierarchical-KV-cache A/B sub-leg (spill-on vs spill-off on the same
    # arrival schedule): a null throughput or hit rate must name why
    ("serve_spill_tokens_per_s", "serve_spill_failure"),
    ("serve_effective_hit_rate", "serve_spill_failure"),
    # input-pipeline A/B sub-leg (sync vs prefetch under an injected collate
    # delay): a null speedup must name why — never read as "measured zero"
    ("input_pipeline_speedup", "input_pipeline_failure"),
)

# legs where a hard 0.0 IS a measurement (an accept rate of zero means the
# draft never matched — real data, unlike a 0.0 MFU which means never-ran;
# a 0.0 prefix-hit rate means the workload shared no prefixes — also real)
_ZERO_VALID_LEGS = frozenset({
    "serve_accept_rate",
    "serve_route_prefix_hit_rate",
    "serve_effective_hit_rate",
})


def validate_bench_result(result: dict[str, Any]) -> list[str]:
    """A leg whose value is 0.0 or None MUST carry a recorded reason;
    a hard 0.0 is additionally always suspect (an MFU of exactly zero is
    not a measurement). → list of problems (empty = valid)."""
    problems: list[str] = []
    for value_key, failure_key in _BENCH_LEGS:
        if value_key not in result:
            continue
        value = result[value_key]
        reason = result.get(failure_key)
        if (
            isinstance(value, (int, float)) and not isinstance(value, bool)
            and value == 0.0 and value_key not in _ZERO_VALID_LEGS
        ):
            problems.append(
                f"{value_key} is 0.0 — a leg that never ran must report null "
                f"+ a reason in {failure_key}, never a zero measurement"
            )
        elif value is None and not reason:
            problems.append(
                f"{value_key} is null but {failure_key} records no reason"
            )
    return problems


def main(argv: Optional[list[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: metrics_report <train_metrics.jsonl> [--strict]")
        return 0 if argv else 2
    strict = "--strict" in argv
    path = next((a for a in argv if not a.startswith("-")), None)
    if path is None:
        print("usage: metrics_report <train_metrics.jsonl> [--strict]")
        return 2
    records, problems = lint_metrics_jsonl(path)
    print(format_table(summarize_metrics(records)))
    if problems:
        print(f"\n{len(problems)} schema problem(s):", file=sys.stderr)
        for p in problems[:50]:
            print(f"  {p}", file=sys.stderr)
        return 1 if strict or not records else 0
    return 0
