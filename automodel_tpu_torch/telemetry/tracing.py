"""End-to-end distributed request tracing across the serving fleet.

A production request is a multi-process story — router placement, optional
prefill-replica chunking, a KV handoff over the AKV1 socket, then decode —
and each process only writes its own JSONL. This module is the dependency-
free span layer that joins those files back into one request:

- **Span API** (:class:`Tracer`): every span carries ``trace_id`` /
  ``span_id`` / ``parent_id`` and a duration measured on the MONOTONIC
  clock (``time.perf_counter``). Each process binds wall time to its
  monotonic clock exactly once (:class:`WallAnchor`), so a wall-clock step
  (NTP slew, manual set) mid-request can never produce a negative duration
  or a scrambled waterfall — cross-host wall skew is corrected at ASSEMBLY
  instead (parent/child links pin each process's offset).
- **Context propagation**: a W3C-style ``traceparent`` header
  (``00-<trace_id 32hex>-<span_id 16hex>-<flags 2hex>``) minted at the
  router (or at the engine front for direct requests) and carried through
  every HTTP forward and the AKV1 geometry handshake. Flag bit 0 is the
  sampled bit: an unsampled trace still propagates (downstream stays
  consistent) but emits nothing.
- **Assembler** (``automodel_tpu trace <jsonl...>``): joins span records
  from N per-process metrics files by ``trace_id`` into per-request
  waterfalls — markdown plus Chrome-trace JSON (loadable by
  ``telemetry/profiling/trace.py`` and chrome://tracing). Orphan spans
  (parent never found) and partial traces (no root) are REPORTED, never
  dropped: a missing span is evidence of a lost file or a dead process.

Span JSONL schema (rides the existing per-process metrics path; accepted
by ``automodel_tpu report --strict``)::

    {"event": "span", "trace_id": ..., "span_id": ..., "parent_id": ...,
     "stage": "prefill", "process": "serve-prefill-123",
     "ts": <anchored wall start>, "duration_s": ..., ...attrs}

Stage names (docs/observability.md glossary): router — ``route`` (root),
``placement``, ``prefill_rpc``, ``forward``, ``probe_sweep``; transfer —
``kv_send``, ``kv_receive``; replica — ``serve`` (root), ``queue``,
``admission``, ``prefill`` (per chunk), ``kv_inject``, ``decode``,
``spec_propose``, ``spec_verify``.

A copy of ``automodel_tpu/telemetry/tracing.py`` (stdlib only). The
port's serve emits the replica stages it runs (``serve``, ``queue``,
``admission``, ``prefill``, ``kv_reload``, ``decode``, ``spec_propose``,
``spec_verify``); ``python -m automodel_tpu_torch.cli.app trace`` is
``main`` below.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import re
import sys
import time
from typing import Any, Callable, Iterable, Optional

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# keys a span record must carry to be assemblable (report.py lints these)
SPAN_REQUIRED_KEYS = ("trace_id", "span_id", "stage", "duration_s", "ts")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """Identity of one span: enough to emit it and to parent children."""

    trace_id: str
    span_id: str
    sampled: bool = True
    parent_id: Optional[str] = None


def to_traceparent(ctx: SpanContext) -> str:
    """W3C trace-context header for ``ctx`` (version 00; flag bit 0 =
    sampled)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def parse_traceparent(header: Any) -> Optional[SpanContext]:
    """→ the remote parent context, or None for a missing/malformed header
    (a bad header must degrade to "new trace", never break a request)."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    # ff is forbidden by the spec; all-zero ids mean "no trace"
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


class WallAnchor:
    """ONE wall↔monotonic binding per process.

    Every timestamp a process emits is ``offset + perf_counter()`` — the
    wall clock is read exactly once, at construction, so all of a process's
    records share one coherent clock even if the wall clock steps
    mid-request. Durations are always monotonic differences."""

    def __init__(self):
        self.offset = time.time() - time.perf_counter()

    def wall(self, mono: Optional[float] = None) -> float:
        """Anchored wall time for a monotonic instant (now when omitted)."""
        return self.offset + (time.perf_counter() if mono is None else mono)


@dataclasses.dataclass(frozen=True)
class TracingConfig:
    """The strict ``tracing:`` YAML section (serve / route CLIs)."""

    enabled: bool = True
    sample_rate: float = 1.0  # fraction of ROOT traces that emit spans

    def __post_init__(self):
        if not (0.0 <= self.sample_rate <= 1.0):
            raise ValueError(
                f"tracing.sample_rate={self.sample_rate} (want 0.0..1.0)"
            )

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TracingConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TypeError(f"unknown tracing keys: {sorted(unknown)}")
        return cls(**d)


class Tracer:
    """Per-process span emitter.

    ``emit`` receives one span dict per recorded span (the serving fronts
    point it at the same metrics-JSONL writer the ``serve_request`` /
    ``route_request`` records ride). ``observe`` (optional) receives
    ``(stage, duration_s)`` per emitted span — the fronts point it at
    their /metrics per-stage latency histogram. Both hooks are failure-
    isolated: telemetry must never break serving."""

    def __init__(
        self,
        process: str,
        emit: Optional[Callable[[dict], None]] = None,
        enabled: bool = True,
        sample_rate: float = 1.0,
        observe: Optional[Callable[[str, float], None]] = None,
        seed: Optional[int] = None,
    ):
        self.process = str(process)
        self.emit = emit
        self.enabled = bool(enabled) and emit is not None
        self.sample_rate = float(sample_rate)
        self.observe = observe
        self.clock = WallAnchor()
        self._rng = random.Random(seed)

    @classmethod
    def from_config(
        cls,
        config: TracingConfig,
        process: str,
        emit: Optional[Callable[[dict], None]],
        observe: Optional[Callable[[str, float], None]] = None,
    ) -> Optional["Tracer"]:
        """→ a Tracer, or None when the section (or the emit path) turns
        tracing off — callers treat None as "no tracing"."""
        if not config.enabled or emit is None:
            return None
        return cls(
            process, emit=emit, sample_rate=config.sample_rate, observe=observe
        )

    # -- context --------------------------------------------------------------
    def start(self, parent: Optional[SpanContext] = None) -> SpanContext:
        """Mint a span context. With a parent: same trace, sampling
        inherited (the ROOT decided once, every process honors it). Without:
        a new trace, sampled per ``sample_rate``."""
        if parent is not None:
            return SpanContext(
                parent.trace_id, new_span_id(),
                sampled=parent.sampled, parent_id=parent.span_id,
            )
        sampled = self.enabled and self._rng.random() < self.sample_rate
        return SpanContext(new_trace_id(), new_span_id(), sampled=sampled)

    def parse(self, header: Any) -> Optional[SpanContext]:
        return parse_traceparent(header)

    def active(self, ctx: Optional[SpanContext]) -> bool:
        return self.enabled and ctx is not None and ctx.sampled

    # -- emission -------------------------------------------------------------
    def record(
        self,
        ctx: Optional[SpanContext],
        stage: str,
        start_mono: float,
        end_mono: Optional[float] = None,
        **attrs: Any,
    ) -> Optional[dict]:
        """Emit one span: ``[start_mono, end_mono]`` on THIS process's
        monotonic clock (perf_counter instants — the same clock the serving
        schedulers already stamp ``t_submit``/``t_admit`` with)."""
        if not self.active(ctx):
            return None
        if end_mono is None:
            end_mono = time.perf_counter()
        rec = {
            "event": "span",
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "stage": str(stage),
            "process": self.process,
            "ts": round(self.clock.wall(start_mono), 6),
            "duration_s": round(end_mono - start_mono, 9),
        }
        if ctx.parent_id is not None:
            rec["parent_id"] = ctx.parent_id
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        if self.observe is not None:
            try:
                self.observe(rec["stage"], rec["duration_s"])
            except Exception:
                pass
        try:
            self.emit(rec)
        except Exception:  # telemetry must never break serving
            pass
        return rec

    def child(
        self,
        parent: Optional[SpanContext],
        stage: str,
        start_mono: float,
        end_mono: Optional[float] = None,
        **attrs: Any,
    ) -> Optional[SpanContext]:
        """Mint + record a child span in one call (the common case for
        stages whose window is already known from scheduler bookkeeping)."""
        if not self.active(parent):
            return None
        ctx = self.start(parent=parent)
        self.record(ctx, stage, start_mono, end_mono, **attrs)
        return ctx

    @contextlib.contextmanager
    def span(
        self, parent: Optional[SpanContext], stage: str, **attrs: Any
    ):
        """Context manager measuring the enclosed block. Yields the child
        context (pass it downstream via ``to_traceparent``); records on
        exit even when the block raises (the failed stage is exactly the
        one worth seeing). ``parent=None`` roots a new trace."""
        ctx = self.start(parent=parent)
        t0 = time.perf_counter()
        try:
            yield ctx
        finally:
            self.record(ctx, stage, t0, **attrs)


# -- assembly -----------------------------------------------------------------


def read_span_records(paths: Iterable[str]) -> tuple[list[dict], list[str]]:
    """Collect ``event == "span"`` records from JSONL files. → (spans,
    problems). Unparseable lines and schema-violating spans are reported,
    not silently dropped."""
    # ONE strict-JSON policy for the whole telemetry pipeline
    from automodel_tpu_torch.telemetry.report import _strict_loads

    spans: list[dict] = []
    problems: list[str] = []
    for path in paths:
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError as e:
            problems.append(f"cannot read {path}: {e}")
            continue
        for i, line in enumerate(lines, 1):
            if not line.strip():
                continue
            try:
                rec = _strict_loads(line)
            except ValueError as e:
                problems.append(f"{path}:{i}: {e}")
                continue
            if not isinstance(rec, dict) or rec.get("event") != "span":
                continue
            missing = [k for k in SPAN_REQUIRED_KEYS if rec.get(k) is None]
            if missing:
                problems.append(f"{path}:{i}: span missing {missing}")
                continue
            if not isinstance(rec["duration_s"], (int, float)):
                problems.append(f"{path}:{i}: span duration_s not numeric")
                continue
            if not isinstance(rec["ts"], (int, float)):
                problems.append(f"{path}:{i}: span ts not numeric")
                continue
            if rec["duration_s"] < 0:
                problems.append(
                    f"{path}:{i}: span has negative duration_s "
                    f"{rec['duration_s']}"
                )
            rec["_source"] = path
            spans.append(rec)
    return spans, problems


def _skew_offsets(
    spans: list[dict], ids: dict[str, dict], ref_process: str
) -> dict[str, float]:
    """Per-process clock offsets that make cross-process parent→child links
    physically plausible: a child that appears to start before its parent
    (or after the parent's end) is shifted by exactly the violation. Within
    a process nothing moves — every process's spans share one WallAnchor,
    so their relative layout is already exact."""
    off: dict[str, float] = {ref_process: 0.0}
    changed = True
    guard = 0
    while changed and guard <= len(spans) + 1:
        changed = False
        guard += 1
        for s in spans:
            p = ids.get(s.get("parent_id") or "")
            if p is None:
                continue
            pp, sp = p.get("process", "?"), s.get("process", "?")
            if pp not in off or sp in off:
                continue
            p_start = float(p["ts"]) + off[pp]
            p_end = p_start + max(float(p.get("duration_s") or 0.0), 0.0)
            c_start = float(s["ts"])
            if c_start < p_start:
                off[sp] = p_start - c_start
            elif c_start > p_end:
                off[sp] = p_end - c_start
            else:
                off[sp] = 0.0
            changed = True
    return off


def assemble_traces(
    spans: list[dict], skew_correct: bool = True
) -> list[dict]:
    """Group spans by trace_id and build per-trace waterfalls. → list of
    trace dicts sorted by first activity::

        {"trace_id", "spans" (tree order, each with t0_s/ts_adj/depth/
         orphan), "roots", "orphans", "partial", "skew_s", "duration_s",
         "processes"}

    Out-of-order input is fine (everything is re-sorted by timestamp);
    orphan spans (parent id never found) head their own subtree, flagged,
    never dropped; a trace with no root at all is flagged ``partial``."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(str(s["trace_id"]), []).append(dict(s))
    traces = []
    for tid, group in by_trace.items():
        ids = {s["span_id"]: s for s in group}
        for s in group:
            s.setdefault("process", "?")
        roots = [s for s in group if not s.get("parent_id")]
        orphans = [
            s for s in group
            if s.get("parent_id") and s["parent_id"] not in ids
        ]
        ref = min(roots or group, key=lambda s: float(s["ts"]))["process"]
        off = (
            _skew_offsets(group, ids, ref) if skew_correct else {ref: 0.0}
        )
        for s in group:
            s["ts_adj"] = float(s["ts"]) + off.get(s["process"], 0.0)
        t0 = min(s["ts_adj"] for s in group)
        t_end = max(
            s["ts_adj"] + max(float(s.get("duration_s") or 0.0), 0.0)
            for s in group
        )
        children: dict[str, list[dict]] = {}
        for s in group:
            pid = s.get("parent_id")
            if pid in ids:
                children.setdefault(pid, []).append(s)
        ordered: list[dict] = []

        def _walk(span: dict, depth: int) -> None:
            span["t0_s"] = span["ts_adj"] - t0
            span["depth"] = depth
            ordered.append(span)
            for c in sorted(
                children.get(span["span_id"], []), key=lambda x: x["ts_adj"]
            ):
                _walk(c, depth + 1)

        for r in sorted(roots, key=lambda s: s["ts_adj"]):
            _walk(r, 0)
        for o in sorted(orphans, key=lambda s: s["ts_adj"]):
            o["orphan"] = True
            _walk(o, 0)
        traces.append({
            "trace_id": tid,
            "spans": ordered,
            "roots": roots,
            "orphans": orphans,
            "partial": not roots,
            "skew_s": {
                p: round(v, 6) for p, v in off.items() if abs(v) > 1e-9
            },
            "duration_s": t_end - t0,
            "processes": sorted({s["process"] for s in group}),
        })
    traces.sort(key=lambda t: min(s["ts_adj"] for s in t["spans"]))
    return traces


_SPAN_DETAIL_KEYS = (
    "request_id", "replica", "completion_reason", "outcome", "attempt",
    "tokens", "pos", "handoff_id",
)


def render_waterfall(trace: dict, width: int = 32) -> str:
    """One trace as a markdown waterfall (tree-indented stages, offset
    bars, orphan/partial flags)."""
    total = max(trace["duration_s"], 1e-9)
    lines = [
        f"## trace {trace['trace_id']} — {total * 1000:.2f} ms, "
        f"{len(trace['spans'])} span(s), "
        f"processes: {', '.join(trace['processes'])}",
    ]
    if trace["partial"]:
        lines.append(
            "**partial trace**: no root span found — a process's JSONL is "
            "missing from the input"
        )
    if trace["skew_s"]:
        parts = ", ".join(
            f"{p} {v * 1000:+.3f} ms" for p, v in sorted(trace["skew_s"].items())
        )
        lines.append(f"clock-skew correction applied: {parts}")
    if trace["orphans"]:
        lines.append(
            f"**{len(trace['orphans'])} orphan span(s)** (parent id not in "
            "the supplied files) — shown flagged below, not dropped"
        )
    lines.append("")
    lines.append("| start_ms | dur_ms | waterfall | span |")
    lines.append("|---:|---:|:---|:---|")
    for s in trace["spans"]:
        dur = max(float(s.get("duration_s") or 0.0), 0.0)
        lead = int(round(s["t0_s"] / total * width))
        bar = "·" * min(lead, width) + "█" * max(
            1, int(round(dur / total * width))
        )
        label = "&nbsp;&nbsp;" * s.get("depth", 0) + str(s["stage"])
        detail = " ".join(
            f"{k}={s[k]}" for k in _SPAN_DETAIL_KEYS if s.get(k) is not None
        )
        flags = " **⚠ orphan**" if s.get("orphan") else ""
        lines.append(
            f"| {s['t0_s'] * 1000:.3f} | {dur * 1000:.3f} | `{bar[:width + 1]}` "
            f"| {label} [{s['process']}]{flags}"
            f"{' — ' + detail if detail else ''} |"
        )
    return "\n".join(lines)


def chrome_trace(traces: list[dict]) -> dict:
    """Chrome-trace JSON (``{"traceEvents": [...]}``): one pid per process,
    one tid per trace, complete (``ph: X``) events — loadable by
    chrome://tracing, Perfetto, and ``telemetry/profiling/trace.py``."""
    events: list[dict] = []
    pids: dict[str, int] = {}
    all_spans = [s for t in traces for s in t["spans"]]
    if not all_spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s["ts_adj"] for s in all_spans)
    for t_idx, trace in enumerate(traces):
        tid = t_idx + 1
        for s in trace["spans"]:
            proc = s["process"]
            if proc not in pids:
                pids[proc] = len(pids) + 1
                events.append({
                    "ph": "M", "name": "process_name", "pid": pids[proc],
                    "args": {"name": proc},
                })
            args = {
                k: s[k]
                for k in ("trace_id", "span_id", "parent_id", *_SPAN_DETAIL_KEYS)
                if s.get(k) is not None
            }
            if s.get("orphan"):
                args["orphan"] = True
            events.append({
                "ph": "X",
                "name": str(s["stage"]),
                "pid": pids[proc],
                "tid": tid,
                "ts": round((s["ts_adj"] - t0) * 1e6, 3),
                "dur": round(max(float(s.get("duration_s") or 0.0), 0.0) * 1e6, 3),
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_report(
    traces: list[dict], sources: list[str], problems: list[str]
) -> str:
    n_spans = sum(len(t["spans"]) for t in traces)
    n_orphans = sum(len(t["orphans"]) for t in traces)
    n_partial = sum(1 for t in traces if t["partial"])
    lines = [
        "# automodel_tpu trace report",
        "",
        f"{len(traces)} trace(s), {n_spans} span(s) from "
        f"{len(sources)} file(s): {', '.join(sources)}",
    ]
    if n_orphans or n_partial:
        lines.append(
            f"**{n_orphans} orphan span(s), {n_partial} partial trace(s)** — "
            "evidence of a missing process file, a crashed process, or an "
            "in-flight request at capture time"
        )
    if problems:
        lines.append(f"{len(problems)} input problem(s):")
        lines.extend(f"- {p}" for p in problems[:20])
    lines.append("")
    for t in traces:
        lines.append(render_waterfall(t))
        lines.append("")
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    """``automodel_tpu trace <metrics.jsonl ...> [--chrome out.json]
    [--md out.md] [--trace-id PREFIX]`` — assemble per-process span JSONLs
    into per-request waterfalls."""
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = (
        "usage: automodel_tpu trace <metrics.jsonl> [...] "
        "[--chrome out.json] [--md out.md] [--trace-id PREFIX]"
    )
    if not argv or argv[0] in ("-h", "--help"):
        print(usage)
        return 0 if argv else 2
    chrome_path = md_path = trace_filter = None
    files: list[str] = []
    it = iter(argv)
    for a in it:
        if a == "--chrome":
            chrome_path = next(it, None)
        elif a == "--md":
            md_path = next(it, None)
        elif a == "--trace-id":
            trace_filter = next(it, None)
        elif a.startswith("-"):
            print(f"unknown option {a!r}\n{usage}", file=sys.stderr)
            return 2
        else:
            files.append(a)
    if not files or (chrome_path is None and "--chrome" in argv) or (
        md_path is None and "--md" in argv
    ) or (trace_filter is None and "--trace-id" in argv):
        print(usage, file=sys.stderr)
        return 2
    spans, problems = read_span_records(files)
    for p in problems:
        print(f"problem: {p}", file=sys.stderr)
    if not spans:
        print(
            "no span records found — is tracing enabled (tracing: section) "
            "and logging.metrics_path set on every process?",
            file=sys.stderr,
        )
        return 1
    traces = assemble_traces(spans)
    if trace_filter:
        traces = [
            t for t in traces if t["trace_id"].startswith(trace_filter)
        ]
        if not traces:
            print(f"no trace matches {trace_filter!r}", file=sys.stderr)
            return 1
    report = render_report(traces, files, problems)
    if md_path:
        with open(md_path, "w") as f:
            f.write(report + "\n")
        print(f"wrote {md_path}")
    else:
        print(report)
    if chrome_path:
        with open(chrome_path, "w") as f:
            json.dump(chrome_trace(traces), f)
        print(f"wrote {chrome_path} (chrome://tracing / perfetto)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
