"""Trace analytics, port of ``automodel_tpu/telemetry/profiling/trace.py``:
parse a captured ``torch.profiler`` trace into a structured report (JSON +
markdown) with JAX's output schema.

Input: the Chrome-trace JSON ``export_chrome_trace`` writes (plain or
gzip'd; utils/profiler.py), or a directory holding one (the newest is
read). Events are ``X`` complete events with ``ts``/``dur`` in
microseconds and a category (``cat``):

- device events are ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` on the
  GPU process's stream threads (CUPTI). When the trace has none — a CPU
  run — the ``cpu_op`` events are the ops instead (the CPU is the device),
  and the report says so (``device: "cpu"``, ``kernel_events: 0``): a
  caller that needs the card's kernels checks ``kernel_events``;
- named scopes are ``record_function`` ranges (``user_annotation``, and
  their ``gpu_user_annotation`` shadows on the streams).

The report answers JAX's three questions: the top-K ops by self time
(self = span minus nested same-thread children, aggregated by name); the
compute / comm / host-gap split (device busy = the union of op intervals;
comm = NCCL / collective kernels; host gap = window − busy); and the
per-scope attribution (each scope's device time: the op events that fall
inside its ranges, on the host thread for CPU ops, by time for kernels).
"""

from __future__ import annotations

import bisect
import gzip
import json
import re
from pathlib import Path
from typing import Any, Iterable, Optional

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SCOPE_CATS = ("user_annotation", "gpu_user_annotation")
_COMM_RE = re.compile(r"nccl|all_?reduce|all_?gather|reduce_?scatter|all_?to_?all|broadcast|sendrecv", re.I)
# profiler scaffolding that covers the whole window
_INFRA_RE = re.compile(r"^(ProfilerStep#|\[memory\]|PyTorch Profiler|Iteration Start|Record Window End)")


def load_trace_events(path: str | Path) -> list[dict]:
    """Chrome-trace events from a file or a directory (the newest
    ``*.json`` / ``*.json.gz`` under it)."""
    p = Path(path)
    if p.is_dir():
        candidates = sorted(
            [*p.rglob("*.json.gz"), *p.rglob("*.json")], key=lambda f: f.stat().st_mtime
        )
        if not candidates:
            raise FileNotFoundError(
                f"no *.json[.gz] trace under {p} — was the trace window ever open? (profiler "
                "start/end steps inside the run's step range?)"
            )
        p = candidates[-1]
    raw = p.read_bytes()
    if p.suffix == ".gz" or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    doc = json.loads(raw)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{p}: not a Chrome trace (no traceEvents list)")
    return events


def _self_times(spans: list[dict]) -> None:
    """Annotate each span (one thread, sorted by ts) with ``self_us`` =
    dur minus directly-nested child durs. Stack-based single pass."""
    stack: list[dict] = []
    for s in spans:
        while stack and s["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
            stack.pop()
        if stack:
            stack[-1]["child_us"] += s["dur"]
        s["child_us"] = 0.0
        stack.append(s)
    for s in spans:
        s["self_us"] = max(s["dur"] - s["child_us"], 0.0)


def _merge(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _union_us(intervals: Iterable[tuple[float, float]]) -> float:
    return sum(e - s for s, e in _merge(intervals))


def _base_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameter list (``void (anonymous
    namespace)::flash_fwd_kernel<128, true>(Params)`` →
    ``flash_fwd_kernel``)."""
    name = name.replace("(anonymous namespace)::", "").strip()
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break  # the parameter list
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip()
    base = base.split(" ")[-1] if base.startswith(("void ", "static ")) else base
    return base or name


def analyze_trace(events: list[dict], top_k: int = 20, scope_depth: int = 2) -> dict:
    """→ the structured report dict (JAX's schema, plus ``device``,
    ``kernel_events`` and ``host_gaps``, the largest gaps between device
    ops)."""
    spans: list[dict] = []
    for e in events:
        if e.get("ph") != "X" or not isinstance(e.get("dur"), (int, float)):
            continue
        name = str(e.get("name", ""))
        if _INFRA_RE.search(name):
            continue
        spans.append({
            "name": name, "cat": str(e.get("cat", "")), "ts": float(e.get("ts", 0.0)),
            "dur": float(e["dur"]), "key": (e.get("pid"), e.get("tid")),
        })
    kernels = [s for s in spans if s["cat"] in _DEVICE_CATS]
    device = "gpu" if kernels else "cpu"
    ops = kernels if kernels else [s for s in spans if s["cat"] == "cpu_op"]
    scopes = [s for s in spans if s["cat"] in _SCOPE_CATS]

    by_thread: dict[Any, list[dict]] = {}
    for s in ops:
        by_thread.setdefault(s["key"], []).append(s)
    for lst in by_thread.values():
        lst.sort(key=lambda s: (s["ts"], -s["dur"]))
        _self_times(lst)

    bounds = [s for s in spans if s["cat"] in (*_DEVICE_CATS, "cpu_op", "user_annotation")]
    t_min = min((s["ts"] for s in bounds), default=None)
    t_max = max((s["ts"] + s["dur"] for s in bounds), default=None)
    window_us = (t_max - t_min) if t_min is not None else 0.0

    agg: dict[str, dict] = {}
    comm_us = compute_us = 0.0
    for s in ops:
        base = _base_name(s["name"])
        is_comm = bool(_COMM_RE.search(base))
        if is_comm:
            comm_us += s["self_us"]
        else:
            compute_us += s["self_us"]
        a = agg.setdefault(
            base, {"name": base, "count": 0, "total_us": 0.0, "self_us": 0.0,
                   "category": "comm" if is_comm else "compute"},
        )
        a["count"] += 1
        a["total_us"] += s["dur"]
        a["self_us"] += s["self_us"]

    busy = _merge((s["ts"], s["ts"] + s["dur"]) for s in ops)
    device_busy_us = sum(e - s for s, e in busy)
    gaps = sorted(
        ({"start_us": round(busy[i][1] - t_min, 3), "gap_s": round((busy[i + 1][0] - busy[i][1]) / 1e6, 6)}
         for i in range(len(busy) - 1)),
        key=lambda g: -g["gap_s"],
    )[:5]

    scope_us: dict[str, float] = {}
    if scopes and ops:
        by_ts = sorted(ops, key=lambda s: s["ts"])
        starts = [s["ts"] for s in by_ts]
        longest = max(s["dur"] for s in ops)
        for sc in scopes:
            parts = [p for p in sc["name"].split("/") if p]
            name = "/".join(parts[:scope_depth]) or sc["name"]
            lo, hi = sc["ts"], sc["ts"] + sc["dur"]
            inside = []
            for s in by_ts[bisect.bisect_left(starts, lo - longest):bisect.bisect_left(starts, hi)]:
                if s["ts"] + s["dur"] > lo and (device == "gpu" or s["key"] == sc["key"]):
                    inside.append((max(s["ts"], lo), min(s["ts"] + s["dur"], hi)))
            if inside:
                scope_us[name] = scope_us.get(name, 0.0) + _union_us(inside)

    total_self = comm_us + compute_us
    top = sorted(agg.values(), key=lambda o: -o["self_us"])[:top_k]
    for o in top:
        o["total_s"] = round(o.pop("total_us") / 1e6, 6)
        o["self_s"] = round(o["self_us"] / 1e6, 6)
        o["share_pct"] = round(100.0 * o.pop("self_us") / total_self, 2) if total_self else 0.0
    scope_rows = [
        {"scope": k, "self_s": round(v / 1e6, 6),
         "share_pct": round(100.0 * v / total_self, 2) if total_self else 0.0}
        for k, v in sorted(scope_us.items(), key=lambda kv: -kv[1])[:top_k]
    ]
    return {
        "window_s": round(window_us / 1e6, 6),
        "device_busy_s": round(device_busy_us / 1e6, 6),
        "device_busy_fraction": round(device_busy_us / window_us, 4) if window_us else 0.0,
        "host_gap_s": round(max(window_us - device_busy_us, 0.0) / 1e6, 6),
        "compute_s": round(compute_us / 1e6, 6),
        "comm_s": round(comm_us / 1e6, 6),
        "comm_fraction": round(comm_us / total_self, 4) if total_self else 0.0,
        "op_events": len(ops),
        "device": device,
        "kernel_events": len(kernels),
        "host_gaps": gaps,
        "top_ops": top,
        "scopes": scope_rows,
    }


def render_markdown(report: dict, title: str = "PROFILE", context: Optional[dict[str, Any]] = None) -> str:
    """The generated PROFILE artifact body (JAX's layout)."""
    lines = [f"# {title}", ""]
    if context:
        lines += ["## Context", ""]
        for k, v in context.items():
            lines.append(f"- **{k}**: {v}")
        lines.append("")
    lines += [
        "## Decomposition",
        "",
        f"Device: {report.get('device', '?')}, kernel events: {report.get('kernel_events', 0)}",
        "",
        "| window | device busy | busy frac | host gap | compute | comm | comm frac |",
        "|---|---|---|---|---|---|---|",
        "| {window_s:.4f}s | {device_busy_s:.4f}s | {device_busy_fraction:.1%} "
        "| {host_gap_s:.4f}s | {compute_s:.4f}s | {comm_s:.4f}s | {comm_fraction:.1%} |".format(**report),
        "",
        f"## Top ops by self time ({len(report['top_ops'])})",
        "",
        "| op | category | count | self (s) | total (s) | share |",
        "|---|---|---|---|---|---|",
    ]
    for o in report["top_ops"]:
        lines.append(
            f"| `{o['name']}` | {o['category']} | {o['count']} "
            f"| {o['self_s']:.6f} | {o['total_s']:.6f} | {o['share_pct']:.1f}% |"
        )
    if report.get("host_gaps"):
        lines += ["", "## Largest host gaps", "", "| after (us into window) | gap (s) |", "|---|---|"]
        for g in report["host_gaps"]:
            lines.append(f"| {g['start_us']} | {g['gap_s']:.6f} |")
    if report.get("scopes"):
        lines += ["", "## Scope attribution", "", "| scope | device (s) | share |", "|---|---|---|"]
        for s in report["scopes"]:
            lines.append(f"| `{s['scope']}` | {s['self_s']:.6f} | {s['share_pct']:.1f}% |")
    if report.get("cost"):
        lines += ["", "## Cost attribution", ""]
        for prog, c in report["cost"].items():
            lines.append(f"- **{prog}**: " + json.dumps(c))
    lines.append("")
    return "\n".join(lines)
