"""Run-ledger goodput accounting, port of
``automodel_tpu/telemetry/goodput.py``: wall-clock decomposition of a
training run across restart attempts.

The resilience stack (preemption, rollback, hang watchdog, prefetch) makes
runs *survive*; this module measures what the surviving *costs* — in the
sense of the ML-goodput metric of accelerator fleets: of N wall-clock hours,
how many produced committed optimizer steps?

One append-only ``goodput.jsonl`` per run ``output_dir``, shared by every
restart attempt (appends ride the MetricLogger's flock-guarded idempotent
writer). Three record shapes:

- ``{"event": "attempt", "attempt_id", "restart_count", "start_ts", ...}``
  written once at startup. A new attempt first CLOSES its predecessor's
  tail: if the previous attempt has no ``attempt_end`` (SIGKILL, OOM kill,
  watchdog ``os._exit``), an inferred end is written at the predecessor's
  last-record timestamp — a killed attempt still accounts.
- ``{"event": "segment", "attempt_id", "kind", "duration_s", ...}`` — one
  per accounted wall-clock slice. The taxonomy is ``SEGMENT_KINDS`` below;
  two kinds are *reclassifications* (``reclassified_from: "step"``): they
  move seconds OUT of productive step time rather than adding new wall
  clock, so per-attempt segments always sum to the attempt's wall clock
  (plus an ``unattributed`` residual the rollup computes).
- ``{"event": "attempt_end", "attempt_id", "end_ts", "reason"}`` — clean
  exit / preemption / crash, or ``inferred: true`` when written post-hoc
  by the successor.

The recipes emit segments through the :class:`GoodputLedger` facade at the
seams that already know their boundaries — the ``train_ft`` log-window
barrier, ``Checkpointer.save/load/wait`` (via ``timing_hook``), the eval
loop, the prefetch input-wait accumulator, and the rollback/preemption
paths. Consumers: the ``goodput <run-dir>`` command (per-attempt +
whole-run breakdown, flight-recorder hang/desync join), ``goodput_fraction``
and per-segment gauges on the training ``/metrics`` port, and segment
rollups in ``report --strict``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
import uuid
from pathlib import Path
from typing import Any, Iterable, Optional

logger = logging.getLogger(__name__)

# the segment taxonomy (docs/observability.md, "Goodput"):
#   startup          — process start (setup() entry) to the first loop step:
#                      model build, mesh, data, checkpoint discovery
#   compile          — step 1's blocking wall time (kernel builds, the
#                      allocator's warm-up and the cost count dominate)
#   step             — productive optimizer-step time (log windows, minus
#                      the host input wait below)
#   input_wait       — host time acquiring the next device-ready batch
#   ckpt_save        — checkpoint save call (sync write, or async staging)
#   ckpt_drain       — async-save drain + commit (Checkpointer.wait)
#   ckpt_restore     — checkpoint load (startup resume and rollback)
#   eval             — validation passes
#   generation       — val-time sample generation
#   rollback_discard — step time reclassified as lost: steps re-done after
#                      an `on_nonfinite: rollback` restored an older ckpt
#   preemption_lost  — step time reclassified as lost: steps past the
#                      checkpoint the NEXT attempt actually resumed from
#   rollout          — post-training (posttrain/grpo.py): serving-engine
#                      completion generation between optimizer steps
#   reward           — post-training: scoring rollouts with the reward fn
# plus the rollup-only residual `unattributed` (wall not covered by any
# segment — hang time, scheduler jitter; the CLI joins flight-recorder
# hang/desync events to name it).
SEGMENT_KINDS = (
    "startup",
    "compile",
    "step",
    "input_wait",
    "ckpt_save",
    "ckpt_drain",
    "ckpt_restore",
    "eval",
    "generation",
    "rollback_discard",
    "preemption_lost",
    "rollout",
    "reward",
)

# reclassifying kinds move seconds out of this source bucket at rollup
_RECLASS_SOURCE = "step"
RECLASSIFIED_KINDS = ("rollback_discard", "preemption_lost")

# Checkpointer.timing_hook kind → the key stamped on the next log record
CKPT_PENDING_KEYS = {
    "ckpt_save": "ckpt_save_s",
    "ckpt_drain": "ckpt_drain_s",
    "ckpt_restore": "ckpt_restore_s",
}


def _process_index() -> int:
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    except Exception:
        return 0


def _read_records(path: Path) -> list[dict]:
    """Tolerant JSONL read: parse past damaged lines (a SIGKILL mid-append
    can leave one) — the ledger must never refuse to chain because its
    predecessor died mid-write."""
    records: list[dict] = []
    try:
        text = path.read_text()
    except OSError:
        return records
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records


class GoodputLedger:
    """The per-attempt facade the recipes drive.

    Every public method is best-effort: goodput accounting is
    observability, and a full disk or broken FS must degrade it to a no-op
    rather than kill the training run it is pricing."""

    def __init__(
        self,
        path: str | os.PathLike,
        t_start: Optional[float] = None,
        enabled: bool = True,
    ):
        self.path = Path(path)
        self.t_start = float(t_start if t_start is not None else time.time())
        # multi-host: one writer (process 0) — the peers' wall clock is the
        # same story, and interleaved attempt records from N hosts would
        # read as N bogus restarts
        self.enabled = bool(enabled) and _process_index() == 0
        self.attempt_id = uuid.uuid4().hex[:16]
        self.restart_count = 0
        self._accounted = 0.0  # seconds covered by segments this attempt
        self._totals: dict[str, float] = {}  # NET per-kind seconds
        self._pending: dict[str, float] = {}  # next-log-record stamps
        self._step_secs: dict[int, float] = {}  # step → attributed seconds
        self._last_step = 0
        self._loop_started = False
        self._closed = False
        self._resume_consumed = False
        self._write_failed = False
        self._prev_attempt: Optional[dict] = None
        if self.enabled:
            try:
                self._open_attempt()
            except Exception as e:  # ledger must never block a run start
                logger.warning("goodput ledger disabled: %s", e)
                self.enabled = False

    # -- envelope (satellite: attempt identity on every JSONL record) -------
    @property
    def envelope(self) -> dict:
        """Stamped into every metrics-JSONL record (MetricLogger envelope)
        and the flight-recorder fingerprint, so ``report``/``goodput`` can
        join and order per-attempt files deterministically."""
        return {"attempt_id": self.attempt_id, "restart_count": self.restart_count}

    # -- startup chaining ----------------------------------------------------
    def _open_attempt(self) -> None:
        prior = _read_records(self.path)
        attempts = [r for r in prior if r.get("event") == "attempt"]
        self.restart_count = len(attempts)
        if attempts:
            prev = attempts[-1]
            prev_id = prev.get("attempt_id")
            prev_recs = [r for r in prior if r.get("attempt_id") == prev_id]
            ended = any(r.get("event") == "attempt_end" for r in prev_recs)
            step_secs: dict[int, float] = {}
            last_step = 0
            for r in prev_recs:
                if r.get("event") != "segment" or r.get("kind") != "step":
                    continue
                f, t = r.get("step_from"), r.get("step_to")
                dur = r.get("duration_s")
                if not (
                    isinstance(f, int) and isinstance(t, int)
                    and isinstance(dur, (int, float)) and t >= f
                ):
                    continue
                per = float(dur) / (t - f + 1)
                for s in range(f, t + 1):
                    step_secs[s] = per  # last write wins: replays supersede
                last_step = max(last_step, t)
            self._prev_attempt = {
                "attempt_id": prev_id,
                "last_step": last_step,
                "step_secs": step_secs,
            }
            if not ended:
                # SIGKILL / watchdog os._exit: close the tail at the last
                # thing the dead attempt managed to write
                last_ts = max(
                    (r["ts"] for r in prev_recs if isinstance(r.get("ts"), (int, float))),
                    default=None,
                )
                self._append(
                    {
                        "event": "attempt_end",
                        "attempt_id": prev_id,
                        "ts": time.time(),
                        "end_ts": last_ts,
                        "inferred": True,
                    }
                )
        self._append(
            {
                "event": "attempt",
                "attempt_id": self.attempt_id,
                "restart_count": self.restart_count,
                "pid": os.getpid(),
                "start_ts": self.t_start,
                "ts": time.time(),
            }
        )

    def _append(self, rec: dict) -> None:
        from automodel_tpu_torch.loggers.metric_logger import _append_line

        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            _append_line(self.path, json.dumps(rec, allow_nan=False) + "\n")
        except Exception as e:
            if not self._write_failed:
                self._write_failed = True
                logger.warning("goodput ledger append failed (%s) — degrading", e)

    # -- segment emission ----------------------------------------------------
    def add(
        self,
        kind: str,
        duration_s: float,
        step: Optional[int] = None,
        step_from: Optional[int] = None,
        step_to: Optional[int] = None,
        **extra: Any,
    ) -> None:
        if not self.enabled or self._closed:
            return
        dur = max(float(duration_s), 0.0)
        rec: dict[str, Any] = {
            "event": "segment",
            "attempt_id": self.attempt_id,
            "kind": kind,
            "duration_s": round(dur, 6),
            "ts": time.time(),
        }
        if step is not None:
            rec["step"] = int(step)
        if step_from is not None and step_to is not None:
            rec["step_from"], rec["step_to"] = int(step_from), int(step_to)
        rec.update(extra)
        self._append(rec)
        self._totals[kind] = self._totals.get(kind, 0.0) + dur
        self._accounted += dur
        if kind == "step" and step_from is not None and step_to is not None:
            per = dur / max(step_to - step_from + 1, 1)
            for s in range(int(step_from), int(step_to) + 1):
                self._step_secs[s] = per
            self._last_step = max(self._last_step, int(step_to))

    @contextlib.contextmanager
    def segment(self, kind: str, **extra: Any):
        """Timed segment around a slow section (eval, generation)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(kind, time.perf_counter() - t0, **extra)

    def window(
        self, wall_s: float, input_wait_s: float, steps: int, step_to: int
    ) -> None:
        """One closed log window: ``wall_s`` seconds spanning ``steps``
        optimizer steps ending at ``step_to``, of which ``input_wait_s`` was
        host input wait. Splits into a ``step`` + ``input_wait`` pair so the
        two always sum back to the window's wall clock."""
        if steps <= 0:
            return
        wait = min(max(float(input_wait_s), 0.0), max(float(wall_s), 0.0))
        self.add(
            "step",
            wall_s - wait,
            step_from=step_to - steps + 1,
            step_to=step_to,
            steps=steps,
        )
        if wait > 0:
            self.add("input_wait", wait, step=step_to)

    def compile_window(
        self, wall_s: float, input_wait_s: float, step: Optional[int] = None
    ) -> None:
        """Step 1's blocking window: compile-dominated, excluded from the
        productive ``step`` bucket (matching ``compile_time_s``)."""
        wait = min(max(float(input_wait_s), 0.0), max(float(wall_s), 0.0))
        self.add("compile", wall_s - wait, step=step)
        if wait > 0:
            self.add("input_wait", wait, step=step)
        if step is not None:
            self._last_step = max(self._last_step, int(step))

    def loop_started(self) -> None:
        """First loop iteration reached: everything since ``t_start`` not
        already covered by a timed segment (ckpt_restore) was setup."""
        if self._loop_started:
            return
        self._loop_started = True
        self.add("startup", (time.time() - self.t_start) - self._accounted)

    # -- checkpoint timing hook (Checkpointer.timing_hook) -------------------
    def on_ckpt_timing(self, kind: str, duration_s: float, step: Optional[int] = None) -> None:
        key = CKPT_PENDING_KEYS.get(kind)
        if key is None:
            return
        self.add(kind, duration_s, step=step)
        if self.enabled:
            self._pending[key] = round(
                self._pending.get(key, 0.0) + max(float(duration_s), 0.0), 6
            )

    def pop_pending(self) -> dict:
        """Checkpoint-duration stamps accumulated since the last log record
        (satellite: ``ckpt_save_s``/``ckpt_restore_s``/``ckpt_drain_s`` ride
        the NEXT record after each operation)."""
        out, self._pending = self._pending, {}
        return out

    # -- resilience seams ----------------------------------------------------
    def on_resume(self, resumed_from_step: int) -> None:
        """Startup auto-resume landed at ``resumed_from_step``: the previous
        attempt's step time past that step is reclassified as
        ``preemption_lost`` — work a kill threw away because it was never
        committed."""
        if not self.enabled or self._resume_consumed:
            return
        self._resume_consumed = True
        prev = self._prev_attempt
        self._append(
            {
                "event": "resume",
                "attempt_id": self.attempt_id,
                "prev_attempt_id": prev["attempt_id"] if prev else None,
                "resumed_from_step": int(resumed_from_step),
                "ts": time.time(),
            }
        )
        if prev is None:
            return
        lost_steps = [
            s for s in prev["step_secs"] if s > int(resumed_from_step)
        ]
        if not lost_steps:
            return
        lost_s = sum(prev["step_secs"][s] for s in lost_steps)
        self._append(
            {
                "event": "segment",
                "attempt_id": prev["attempt_id"],
                "kind": "preemption_lost",
                "duration_s": round(lost_s, 6),
                "steps_lost": len(lost_steps),
                "resumed_from_step": int(resumed_from_step),
                "reclassified_from": _RECLASS_SOURCE,
                "ts": time.time(),
            }
        )

    def on_rollback(self, fail_step: int, restored_step: int) -> None:
        """``on_nonfinite: rollback`` fired: this attempt's own step time in
        ``(restored_step, fail_step]`` is reclassified as discarded — those
        steps will be retrained from the restored checkpoint."""
        if not self.enabled:
            return
        discarded = {
            s: self._step_secs.pop(s)
            for s in list(self._step_secs)
            if int(restored_step) < s <= int(fail_step)
        }
        dur = sum(discarded.values())
        self._append(
            {
                "event": "segment",
                "attempt_id": self.attempt_id,
                "kind": "rollback_discard",
                "duration_s": round(dur, 6),
                "steps_discarded": max(int(fail_step) - int(restored_step), len(discarded)),
                "fail_step": int(fail_step),
                "restored_step": int(restored_step),
                "reclassified_from": _RECLASS_SOURCE,
                "ts": time.time(),
            }
        )
        self._totals[_RECLASS_SOURCE] = self._totals.get(_RECLASS_SOURCE, 0.0) - dur
        self._totals["rollback_discard"] = (
            self._totals.get("rollback_discard", 0.0) + dur
        )

    # -- /metrics + lifecycle ------------------------------------------------
    def snapshot(self) -> dict:
        """Live per-segment totals + goodput fraction for the training
        ``/metrics`` exporter (net of reclassifications)."""
        wall = max(time.time() - self.t_start, 1e-9)
        return {
            "wall_s": wall,
            "segments": dict(self._totals),
            "goodput_fraction": max(self._totals.get("step", 0.0), 0.0) / wall,
        }

    def close(self, reason: str = "exit") -> None:
        if not self.enabled or self._closed:
            return
        self._closed = True
        self._append(
            {
                "event": "attempt_end",
                "attempt_id": self.attempt_id,
                "reason": reason,
                "end_ts": time.time(),
                "ts": time.time(),
            }
        )


# -- rollup (the `goodput` command and the tests) -----------------------------


def rollup(records: Iterable[dict], events: Iterable[dict] = ()) -> dict:
    """Join a goodput.jsonl's records into per-attempt + whole-run totals.

    ``events`` — flight-recorder / metrics-JSONL anomaly records (``hang``,
    ``desync``) used two ways: a dead attempt's wall clock extends to the
    latest event inside it (the watchdog's evidence writes outlive the last
    closed window), and the attempt's ``unattributed`` residual is annotated
    with the event that explains it."""
    attempts: list[dict] = []
    by_id: dict[str, dict] = {}
    for rec in records:
        ev = rec.get("event")
        aid = rec.get("attempt_id")
        if ev == "attempt" and isinstance(aid, str):
            a = {
                "attempt_id": aid,
                "restart_count": rec.get("restart_count", len(attempts)),
                "start_ts": rec.get("start_ts", rec.get("ts")),
                "end_ts": None,
                "end_reason": None,
                "inferred_end": False,
                "last_ts": rec.get("ts"),
                "raw": {},
                "reclassified": [],
                "steps_lost": 0,
                "steps_discarded": 0,
                "resumed_from_step": None,
                "last_step": 0,
            }
            attempts.append(a)
            by_id[aid] = a
            continue
        a = by_id.get(aid) if isinstance(aid, str) else None
        if a is None:
            continue
        if isinstance(rec.get("ts"), (int, float)):
            a["last_ts"] = max(a["last_ts"] or 0.0, rec["ts"])
        if ev == "attempt_end":
            a["end_ts"] = rec.get("end_ts", rec.get("ts"))
            a["end_reason"] = rec.get("reason", "inferred" if rec.get("inferred") else None)
            a["inferred_end"] = bool(rec.get("inferred"))
        elif ev == "resume":
            a["resumed_from_step"] = rec.get("resumed_from_step")
        elif ev == "segment":
            kind = rec.get("kind")
            dur = rec.get("duration_s")
            if not isinstance(kind, str) or not isinstance(dur, (int, float)):
                continue
            if rec.get("reclassified_from"):
                a["reclassified"].append((kind, float(dur), rec.get("reclassified_from")))
                if kind == "preemption_lost":
                    a["steps_lost"] += int(rec.get("steps_lost", 0) or 0)
                if kind == "rollback_discard":
                    a["steps_discarded"] += int(rec.get("steps_discarded", 0) or 0)
            else:
                a["raw"][kind] = a["raw"].get(kind, 0.0) + float(dur)
            if kind == "step" and isinstance(rec.get("step_to"), int):
                a["last_step"] = max(a["last_step"], rec["step_to"])
            elif isinstance(rec.get("step"), int):
                a["last_step"] = max(a["last_step"], rec["step"])

    ev_list = [
        e for e in events
        if e.get("event") in ("hang", "desync") and isinstance(e.get("ts"), (int, float))
    ]
    out_attempts: list[dict] = []
    for i, a in enumerate(attempts):
        segs = dict(a["raw"])
        for kind, dur, source in a["reclassified"]:
            segs[kind] = segs.get(kind, 0.0) + dur
            segs[source] = max(segs.get(source, 0.0) - dur, 0.0)
        start = a["start_ts"]
        end = a["end_ts"]
        anomalies = []
        if start is not None:
            lo = start
            hi = attempts[i + 1]["start_ts"] if i + 1 < len(attempts) else None
            for e in ev_list:
                if e["ts"] >= lo and (hi is None or e["ts"] < hi):
                    anomalies.append(
                        {"event": e["event"], "step": e.get("step"), "ts": e["ts"]}
                    )
        if end is None or a["inferred_end"]:
            # a dead attempt's truest death time is the LATEST thing it
            # provably did: its last ledger record, an inferred tail close,
            # or anomaly evidence written on the way out — never just the
            # first anomaly (a survived desync followed by more windows
            # must not truncate the wall clock)
            candidates = [
                t for t in (end, a["last_ts"])
                if isinstance(t, (int, float))
            ]
            candidates.extend(e["ts"] for e in anomalies)
            end = max(candidates, default=end)
        wall = max((end or 0.0) - (start or 0.0), 0.0) if start is not None else 0.0
        accounted = sum(segs.values())
        unattributed = max(wall - accounted, 0.0)
        segs_out = {k: round(v, 6) for k, v in sorted(segs.items()) if v > 0}
        # committed = attempted minus what the successor had to retrain
        base = a["resumed_from_step"] or 0
        attempted = max(a["last_step"] - base, 0)
        committed = max(attempted - a["steps_lost"], 0)
        rec = {
            "attempt_id": a["attempt_id"],
            "restart_count": a["restart_count"],
            "wall_s": round(wall, 6),
            "segments": segs_out,
            "unattributed_s": round(unattributed, 6),
            "accounted_fraction": round(accounted / wall, 6) if wall else None,
            "goodput_fraction": round(segs.get("step", 0.0) / wall, 6) if wall else None,
            "steps_attempted": attempted,
            "steps_committed": committed,
            "steps_lost": a["steps_lost"],
            "steps_discarded": a["steps_discarded"],
            "resumed_from_step": a["resumed_from_step"],
            "end_reason": a["end_reason"],
            "inferred_end": a["inferred_end"],
        }
        if wall:
            rec["steps_per_s_attempted"] = round(attempted / wall, 6)
            rec["steps_per_s_committed"] = round(committed / wall, 6)
        if anomalies:
            rec["anomalies"] = anomalies
        out_attempts.append(rec)

    totals: dict[str, float] = {}
    wall_total = unattr_total = 0.0
    steps_attempted = steps_committed = 0
    for a in out_attempts:
        wall_total += a["wall_s"]
        unattr_total += a["unattributed_s"]
        steps_attempted += a["steps_attempted"]
        steps_committed += a["steps_committed"]
        for k, v in a["segments"].items():
            totals[k] = totals.get(k, 0.0) + v
    # wall time BETWEEN attempts: requeue / scheduler wait, not any
    # attempt's fault — reported beside the attempts, never inside one
    requeue_gap = 0.0
    for i in range(1, len(attempts)):
        p_end = attempts[i - 1]["end_ts"] or attempts[i - 1]["last_ts"]
        n_start = attempts[i]["start_ts"]
        if isinstance(p_end, (int, float)) and isinstance(n_start, (int, float)):
            requeue_gap += max(n_start - p_end, 0.0)
    return {
        "attempts": out_attempts,
        "run": {
            "n_attempts": len(out_attempts),
            "wall_s": round(wall_total, 6),
            "requeue_gap_s": round(requeue_gap, 6),
            "segments": {k: round(v, 6) for k, v in sorted(totals.items())},
            "unattributed_s": round(unattr_total, 6),
            "goodput_fraction": (
                round(totals.get("step", 0.0) / wall_total, 6) if wall_total else None
            ),
            "steps_attempted": steps_attempted,
            "steps_committed": steps_committed,
            "steps_per_s_committed": (
                round(steps_committed / wall_total, 6) if wall_total else None
            ),
        },
    }


def _collect_events(run_dir: Path) -> list[dict]:
    """Hang/desync evidence from the run dir: the flight-recorder dump and
    any metrics JSONLs next to the ledger. The same event usually lands in
    BOTH sinks (the watchdog writes everywhere it can) — deduplicated by
    (event, step, ts) so one hang never reads as two."""
    events: list[dict] = []
    seen: set[tuple] = set()

    def _take(rec: Any) -> None:
        if not (isinstance(rec, dict) and rec.get("event") in ("hang", "desync")):
            return
        ts = rec.get("ts")
        key = (
            rec["event"],
            rec.get("step"),
            round(ts, 3) if isinstance(ts, (int, float)) else None,
        )
        if key in seen:
            return
        seen.add(key)
        events.append(rec)

    fr = run_dir / "flight_recorder.json"
    if fr.exists():
        try:
            for rec in json.loads(fr.read_text()).get("records") or []:
                _take(rec)
        except (OSError, ValueError):
            pass
    for p in sorted(run_dir.glob("*.jsonl")):
        if p.name == "goodput.jsonl":
            continue
        for rec in _read_records(p):
            _take(rec)
    return events


def format_report(roll: dict) -> str:
    """Human table: per-attempt then whole-run segment breakdown."""
    lines: list[str] = []

    def _block(title: str, wall: float, segs: dict, unattr: float, extra: list[str]):
        lines.append(title)
        width = max([len(k) for k in segs] + [len("unattributed")], default=12)
        for k, v in segs.items():
            pct = 100.0 * v / wall if wall else 0.0
            lines.append(f"  {k:<{width}}  {v:>10.3f}s  {pct:5.1f}%")
        if unattr or not segs:
            pct = 100.0 * unattr / wall if wall else 0.0
            lines.append(f"  {'unattributed':<{width}}  {unattr:>10.3f}s  {pct:5.1f}%")
        lines.extend(f"  {e}" for e in extra)
        lines.append("")

    for a in roll["attempts"]:
        extra = [
            f"goodput_fraction   {a['goodput_fraction']}",
            f"steps attempted/committed  {a['steps_attempted']}/{a['steps_committed']}",
        ]
        if a.get("steps_per_s_committed") is not None:
            extra.append(
                "steps/s attempted/committed  "
                f"{a.get('steps_per_s_attempted')}/{a.get('steps_per_s_committed')}"
            )
        if a["steps_lost"]:
            extra.append(f"preemption-lost steps      {a['steps_lost']}")
        if a["steps_discarded"]:
            extra.append(f"rollback-discarded steps   {a['steps_discarded']}")
        if a.get("resumed_from_step") is not None:
            extra.append(f"resumed from step          {a['resumed_from_step']}")
        for ev in a.get("anomalies", ()):
            extra.append(
                f"unattributed idle joins a `{ev['event']}` event at step "
                f"{ev.get('step')} (flight recorder)"
            )
        end = a["end_reason"] or ("inferred" if a["inferred_end"] else "?")
        _block(
            f"attempt {a['restart_count']} ({a['attempt_id']}, "
            f"end: {end}{', inferred' if a['inferred_end'] and a['end_reason'] != 'inferred' else ''}) "
            f"— wall {a['wall_s']:.3f}s",
            a["wall_s"], a["segments"], a["unattributed_s"], extra,
        )
    run = roll["run"]
    extra = [
        f"goodput_fraction   {run['goodput_fraction']}",
        f"steps committed    {run['steps_committed']} "
        f"({run.get('steps_per_s_committed')} steps/s over attempt wall clock)",
    ]
    if run["requeue_gap_s"]:
        extra.append(f"requeue gap        {run['requeue_gap_s']:.3f}s between attempts")
    _block(
        f"whole run — {run['n_attempts']} attempt(s), wall {run['wall_s']:.3f}s",
        run["wall_s"], run["segments"], run["unattributed_s"], extra,
    )
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m automodel_tpu_torch.cli.app goodput <run-dir | goodput.jsonl> [--json]\n"
            "  Wall-clock decomposition of a training run across restart\n"
            "  attempts (segment taxonomy in docs/observability.md)."
        )
        return 0 if argv else 2
    as_json = "--json" in argv
    target = Path(next((a for a in argv if not a.startswith("-")), "."))
    path = target / "goodput.jsonl" if target.is_dir() else target
    if not path.exists():
        print(f"no goodput ledger at {path}", file=sys.stderr)
        return 2
    records = _read_records(path)
    events = _collect_events(path.parent)
    roll = rollup(records, events)
    if not roll["attempts"]:
        print(f"{path}: no attempt records", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps(roll, indent=2))
    else:
        print(format_report(roll))
    return 0
