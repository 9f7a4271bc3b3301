"""The ``serve`` fronts: stdin JSONL, or a local HTTP server when
``serving.http.port`` is set. Port of ``automodel_tpu/serving/server.py``
(``stats_snapshot`` :191, ``_reason_status`` :249, ``_EngineLoop``
:260-384, ``serve_http`` :386-862, ``_install_drain_handler`` :865,
``_drain_exit_code`` :105, ``_warmup`` :892, ``main`` :971-1131,
``_serve_http_forever`` :1201 and ``_serve_stdin`` :1283-1500).

- **stdin JSONL**: one request object a line, ``{"prompt_ids": [...]}``
  (or ``"prompt": "1 2 3"``, token ids as text) with optional ``id``,
  ``max_new_tokens``, ``deadline_s``, ``max_queue_wait_s``, ``tenant``,
  ``tier``; each terminal record is printed as it happens, with its
  ``completion``. A bad line gets an error line and the batch goes on; a
  shed, quota or draining rejection gets a retriable error line. Exit
  code: 0, 1 if a line was bad, 2 if no request came in, or the drain's
  code after SIGTERM.
- **HTTP** (``serving.http: {port, host, warmup}``): ``POST /generate``
  blocks until its request ends and answers 200 with the record (503 +
  a tier-scaled ``Retry-After`` for a shed, drain, stall or error, 429
  for a quota, 504 for a timeout, 400 for a bad request); ``X-Tenant-Id``
  and ``X-Tier`` headers name the tenant and tier when the body does not.
  ``GET /stats`` (JAX's key set, with a mixed replica's fleet values),
  ``GET /metrics`` (the Prometheus exposition of ``engine.metrics``),
  ``GET /healthz`` (scheduler alive, last step inside the watchdog
  deadline) and ``GET /readyz`` (not draining, one decode step done).
  One thread (``_EngineLoop``) steps the engine; handlers submit under
  its lock and wait. Loopback by default: a local front, as JAX's.

Both fronts install the SIGTERM drain (``serving.drain``) and start the
stall watchdog (``serving.watchdog``), whose stacks and flight-recorder
dump land beside ``logging.metrics_path`` when one is set. The fleet's
paths (``/prefill``, ``/kv_fetch``, ``/retire``, ``/swap_weights`` and a
``/generate`` carrying a ``handoff_id``) answer 400 naming what is not
ported. Top-level sections the port does not run (``slo``, ``fleet``)
are refused when enabled.

A ``tracing: {enabled, sample_rate}`` section turns on request tracing
(``telemetry/tracing.py``): the spans ride the same metrics JSONL as the
``serve_request`` records (no ``logging.metrics_path``, no spans) and
feed ``automodel_serve_stage_seconds`` on ``/metrics``. A W3C
``traceparent`` (the HTTP header, or a ``traceparent`` field of the body
or of a stdin line) makes the request's root span its child.

Unlike JAX's, the port's ``_warmup`` raises when its request fails: a
warm-up that only logged would let a broken kernel reach the front.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import sys
import threading
import time
from pathlib import Path
from typing import Any, Optional

from automodel_tpu_torch.serving.engine import section_enabled

logger = logging.getLogger(__name__)

UNPORTED_TOP_SECTIONS = ("slo", "fleet")
# the fleet's HTTP paths: answered 400 by name
UNPORTED_PATHS = ("/prefill", "/kv_fetch", "/retire", "/swap_weights")

# Retry-After advice on retriable rejections, scaled by tier with QoS
# (interactive 1x, batch 2x, best_effort 3x): lower tiers back off longer
RETRY_AFTER_S = 5


def _tier_retry_after(tier: Any) -> int:
    """Tier-scaled Retry-After seconds (the flat advice on an unknown or
    absent tier: a rejection must never raise over advice)."""
    from automodel_tpu_torch.serving.engine import tier_index

    try:
        return RETRY_AFTER_S * (tier_index(str(tier)) + 1)
    except (TypeError, ValueError):
        return RETRY_AFTER_S


def _encode_prompt(req: dict) -> list[int]:
    if req.get("prompt_ids") is not None:
        return [int(t) for t in req["prompt_ids"]]
    prompt = req.get("prompt")
    if prompt is None:
        raise ValueError("request needs 'prompt' or 'prompt_ids'")
    toks = str(prompt).replace(",", " ").split()
    try:
        return [int(t) for t in toks]
    except ValueError:
        raise ValueError(
            "no tokenizer in the torch backend: 'prompt' must be token ids (e.g. \"1 2 3\")"
        ) from None


def _drain_exit_code(drain_cfg: Any) -> int:
    """0 after a clean drain, or the launchers' requeue code (75) so a
    drained replica under slurm/k8s is restarted instead of counted as
    done (``requeue_exit: auto``)."""
    from automodel_tpu_torch.resilience.preemption import REQUEUE_EXIT_CODE

    if drain_cfg.requeue_exit == "always":
        return REQUEUE_EXIT_CODE
    if drain_cfg.requeue_exit == "never":
        return 0
    under_launcher = "SLURM_JOB_ID" in os.environ or "KUBERNETES_SERVICE_HOST" in os.environ
    return REQUEUE_EXIT_CODE if under_launcher else 0


def stats_snapshot(engine: Any) -> dict:
    """The GET /stats body (JAX's keys). Call under the engine-loop lock
    while the scheduler runs."""
    tier = engine.pool.spill
    return {
        "queue_depth": engine.queue_depth,
        "busy_slots": engine.busy_slots,
        "completed_total": engine.completed_total,
        "failed_total": engine.failed_total,
        "shed_total": engine.shed_total,
        "timeout_total": engine.timeout_total,
        "stall_total": engine.stall_total,
        "error_total": engine.error_total,
        "draining": engine.draining,
        "drain_duration_s": engine.drain_duration_s,
        "block_occupancy": engine.pool.occupancy(),
        "blocks_in_use": engine.pool.in_use(),
        "allocator": dict(engine.pool.counters),
        "decode_backend": engine.decode_backend,
        "kv_cache_dtype": engine.config.kv_cache_dtype,
        "spec_proposed_total": engine.spec_proposed_total,
        "spec_accepted_total": engine.spec_accepted_total,
        "spec_accept_rate": engine.spec_accept_rate,
        "role": engine.config.role,
        "block_size": engine.config.block_size,
        "kv_transfer_port": engine.kv_transfer_port,
        "kv_injected_total": engine.kv_injected_total,
        "hot_prefixes": engine.hot_prefixes(),
        "spill_bytes": tier.bytes if tier is not None else None,
        "spill_entries": len(tier) if tier is not None else None,
        "time_to_ready_s": engine.time_to_ready_s,
        "boot_source": engine.boot_source,
        "weights_version": engine.weights_version,
        "quota_total": engine.quota_total,
        "qos": engine.qos_snapshot(),
    }


_OK_REASONS = ("stop", "length")


def _reason_status(reason: str) -> int:
    """HTTP status for a terminal record."""
    if reason in _OK_REASONS:
        return 200
    if reason == "timeout":
        return 504  # the client's own budget expired: not retriable
    if reason == "quota":
        return 429  # retriable after Retry-After, on this replica
    return 503  # draining / cancelled / shed / engine_stall / engine_error


class _EngineLoop:
    """The scheduler thread of the HTTP front: handlers submit under the
    lock and wait on a per-request event; the loop steps the engine while
    there is work (through a drain too, so in-flight requests finish and
    the grace expiry cancels)."""

    def __init__(self, engine: Any):
        self.engine = engine
        self.lock = threading.Lock()
        self._events: dict[str, threading.Event] = {}
        self._results: dict[str, dict] = {}
        self._abandoned: set[str] = set()  # timed-out waiters: drop on finish
        self.error: Optional[str] = None  # scheduler-thread death, terminal
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="serve-scheduler", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def alive(self) -> bool:
        return self._thread.is_alive() and self.error is None

    def submit_blocking(self, prompt_ids: list[int], req: dict, timeout_s: float, trace: Any = None) -> dict:
        from automodel_tpu_torch.serving.engine import QueueFull, QuotaExceeded

        ev = threading.Event()
        with self.lock:
            if self.error is not None:
                raise RuntimeError(f"serving engine is down: {self.error}")
            try:
                rid = self.engine.submit(
                    prompt_ids,
                    max_new_tokens=req.get("max_new_tokens"),
                    deadline_s=req.get("deadline_s"),
                    max_queue_wait_s=req.get("max_queue_wait_s"),
                    tenant=req.get("tenant"),
                    tier=req.get("tier"),
                    return_logprobs=bool(req.get("return_logprobs")),
                    kv_peer=req.get("kv_peer"),
                    trace=trace,
                )
            except QueueFull:
                # shed at once, with one tier-labelled record a give-up
                self.engine.record_shed(prompt_ids=prompt_ids, tenant=req.get("tenant"), tier=req.get("tier"))
                raise
            except QuotaExceeded as e:
                self.engine.record_quota(prompt_ids=prompt_ids, tenant=e.tenant, tier=e.tier)
                raise
            self._events[rid] = ev
        if not ev.wait(timeout=timeout_s):
            with self.lock:
                self._events.pop(rid, None)
                # the request can't be cancelled mid-flight: its eventual
                # record is dropped instead of kept forever
                self._abandoned.add(rid)
            raise TimeoutError(f"request {rid} timed out after {timeout_s}s")
        with self.lock:
            if self.error is not None and rid not in self._results:
                raise RuntimeError(f"serving engine died: {self.error}")
            return self._results.pop(rid)

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                try:
                    idle = self.engine.idle()
                    done = [] if idle else self.engine.step()
                except Exception as e:  # scheduler death is terminal, not silent
                    self.error = f"{type(e).__name__}: {e}"
                    logger.exception("serving scheduler thread died")
                    # wake every waiter so handlers answer 503 at once
                    for ev in self._events.values():
                        ev.set()
                    self._events.clear()
                    return
                for rec in done:
                    rid = rec["request_id"]
                    ev = self._events.pop(rid, None)
                    if rid in self._abandoned:
                        self._abandoned.discard(rid)
                        continue
                    self._results[rid] = rec
                    if ev is not None:
                        ev.set()
            if idle:
                # an idle server is healthy, not hung
                self.engine.touch_watchdog()
                time.sleep(0.005)


def serve_http(engine: Any, port: int, host: str = "127.0.0.1"):
    """→ (ThreadingHTTPServer, _EngineLoop), the loop started. The caller
    runs ``server.serve_forever()`` (the CLI) or drives requests itself
    (tests), and shuts both down."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    loop = _EngineLoop(engine)
    loop.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict, retry_after: Any = False) -> None:
            # retry_after: False = no header, True = flat advice, a number =
            # that many seconds (the tier-scaled QoS advice)
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after:
                self.send_header("Retry-After", str(RETRY_AFTER_S if retry_after is True else int(retry_after)))
            self.end_headers()
            self.wfile.write(body)

        def _retry_advice(self, req: dict) -> int:
            """Tier-scaled Retry-After: the explicit tier, else the tenant's
            configured one, else the default."""
            qos = engine.config.qos
            tier = req.get("tier")
            if tier is None:
                tenant = req.get("tenant")
                tier = qos.tier_for(str(tenant)) if tenant is not None else qos.default_tier
            return _tier_retry_after(tier)

        def _stash_qos_headers(self, req: dict) -> None:
            """X-Tenant-Id / X-Tier headers (a router forwards them); body
            fields win."""
            for key, header in (("tenant", "X-Tenant-Id"), ("tier", "X-Tier")):
                if req.get(key) is None:
                    h = self.headers.get(header)
                    if h is not None:
                        req[key] = h

        def do_GET(self):
            if self.path == "/metrics":
                from automodel_tpu_torch.telemetry.prometheus import CONTENT_TYPE

                with loop.lock:
                    engine.metrics.sync(engine)
                    body = engine.metrics.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/healthz":
                # lock-free: during the very stall this reports, the
                # scheduler holds the lock inside engine.step
                alive = loop.alive()
                idle = engine.idle()
                age = engine.last_step_age_s
                wd = engine.watchdog
                deadline = wd.deadline_s if wd is not None else None
                ok = alive and (idle or wd is None or age is None or age <= deadline)
                return self._json(200 if ok else 503, {
                    "ok": ok, "scheduler_alive": alive, "idle": idle, "last_step_age_s": age,
                    "stall_deadline_s": deadline, "error": loop.error,
                })
            if self.path == "/readyz":
                ready = loop.alive() and not engine.draining and engine.first_decode_done
                if ready:
                    engine.note_ready()
                return self._json(200 if ready else 503, {
                    "ready": ready, "draining": engine.draining, "first_decode_done": engine.first_decode_done,
                })
            if self.path != "/stats":
                return self._json(404, {"error": f"unknown path {self.path}"})
            with loop.lock:
                snap = stats_snapshot(engine)
            self._json(200, snap)

        def _read_req(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body is not a JSON object")
            return req

        def _trace_ctx(self, req: dict):
            """The propagated trace context: the ``traceparent`` header, or a
            body field for bare clients. None roots a new trace."""
            tracer = getattr(engine, "tracer", None)
            if tracer is None:
                return None
            return tracer.parse(self.headers.get("traceparent") or req.get("traceparent"))

        def do_POST(self):
            if self.path in UNPORTED_PATHS:
                return self._json(400, {
                    "error": f"{self.path} belongs to the fleet (KV transfer, retire, weight swap), "
                    "which is not ported to the torch backend yet"
                })
            if self.path != "/generate":
                return self._json(404, {"error": f"unknown path {self.path}"})
            from automodel_tpu_torch.serving.engine import EngineDraining, QueueFull, QuotaExceeded

            req = {}
            try:
                req = self._read_req()
                if req.get("handoff_id") is not None:
                    return self._json(400, {
                        "error": "handoff_id: the prefill→decode KV handoff is not ported to the torch backend yet"
                    })
                self._stash_qos_headers(req)
                ids = _encode_prompt(req)
                rec = loop.submit_blocking(
                    ids, req, timeout_s=float(req.get("timeout_s", 300.0)), trace=self._trace_ctx(req)
                )
            except (ValueError, TypeError) as e:
                return self._json(400, {"error": str(e)})
            except QueueFull as e:
                return self._json(
                    503, {"error": str(e), "retriable": True, "reason": "shed"},
                    retry_after=self._retry_advice(req),
                )
            except QuotaExceeded as e:
                return self._json(
                    429,
                    {"error": str(e), "retriable": True, "reason": "quota", "tenant": e.tenant, "tier": e.tier},
                    retry_after=_tier_retry_after(e.tier),
                )
            except EngineDraining as e:
                return self._json(
                    503, {"error": str(e), "retriable": True, "reason": "draining"},
                    retry_after=self._retry_advice(req),
                )
            except TimeoutError as e:
                return self._json(504, {"error": str(e)})
            except RuntimeError as e:  # scheduler thread died
                return self._json(503, {"error": str(e)})
            out = dict(rec)
            out["completion"] = " ".join(map(str, rec["tokens"]))
            if req.get("id") is not None:
                out["id"] = req["id"]
            code = _reason_status(rec.get("completion_reason", "length"))
            self._json(code, out, retry_after=self._retry_advice(req) if code == 503 else False)

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server, loop


def _install_drain_handler(engine: Any, on_term=None):
    """Chain SIGTERM → drain through ``PreemptionHandler`` (handlers
    installed before still run). → the installed handler, or None when
    ``serving.drain.install_signal_handler`` is off or this is not the main
    thread (``signal.signal`` would raise)."""
    drain_cfg = engine.config.drain
    if not drain_cfg.install_signal_handler:
        return None
    if threading.current_thread() is not threading.main_thread():
        return None
    from automodel_tpu_torch.resilience.preemption import PreemptionHandler

    handler = PreemptionHandler(
        signals=("SIGTERM",),
        on_preempt=on_term,
        log_message=(
            "serving drain: rejecting new requests retriable, finishing "
            f"in-flight within serving.drain.grace_s={drain_cfg.grace_s}"
        ),
    )
    try:
        handler.install()
    except ValueError:  # not the main thread after all
        return None
    return handler


def _warmup(engine: Any) -> None:
    """One tiny request through the engine before the front opens: it
    builds and loads the kernels and runs one decode step, so /readyz can
    go true. It raises when the request does not complete: a warm-up that
    only logged would let a broken kernel reach the front."""
    vocab = int(getattr(engine.model.config, "vocab_size", 2))
    # max_new_tokens=2: a 1-token request ends at the prefill tick and never
    # runs the decode program
    rid = engine.submit([min(1, max(vocab - 1, 0))], request_id="__warmup__", max_new_tokens=2)
    recs = {r["request_id"]: r for r in engine.run()}
    reason = recs.get(rid, {}).get("completion_reason")
    if reason not in _OK_REASONS or not engine.first_decode_done:
        raise RuntimeError(f"serve warm-up request ended as {reason!r}: {recs.get(rid, {}).get('detail')}")


def refuse_unported_top_sections(cfg: Any) -> None:
    """Raise ``ValueError`` naming the first enabled top-level section the
    port does not run (``slo``, ``fleet``)."""
    for name in UNPORTED_TOP_SECTIONS:
        section = cfg.get(name, None)
        if section_enabled(name, section.to_dict() if hasattr(section, "to_dict") else section):
            raise ValueError(
                f"{name} is enabled, but the {name} section is not ported to the torch backend yet"
            )


def _section(cfg: Any, name: str) -> dict:
    section = cfg.get(name, None)
    return dict(section.to_dict() if hasattr(section, "to_dict") else (section or {}))


def build_tracer(cfg: Any, emit=None):
    """The ``tracing:`` section → a Tracer whose spans go to ``emit`` (the
    metrics JSONL writer), or None when the section or ``emit`` turns
    tracing off (JAX ``serving/server.py:1026-1036``). The engine points
    its ``observe`` at ``/metrics``. Unlike JAX's serve, which traces
    whenever a metrics path is set (an absent section reads as
    ``enabled: true``), the port traces only when the section is given."""
    from automodel_tpu_torch.telemetry.tracing import Tracer, TracingConfig

    section = _section(cfg, "tracing")
    if not section:
        return None
    return Tracer.from_config(
        TracingConfig.from_dict(section), process=f"serve-mixed-{os.getpid()}", emit=emit,
    )


def build_engine(cfg: Any, on_record=None):
    """ServingEngine from a config tree (``device``, ``model``,
    ``generation``, ``serving`` and ``tracing`` sections)."""
    from automodel_tpu_torch.generation.engine import GenerationConfig, build_auto_from_cfg
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine

    refuse_unported_top_sections(cfg)
    serve_cfg = ServeConfig.from_dict(_section(cfg, "serving"))
    gen_cfg = GenerationConfig.from_dict(_section(cfg, "generation"))
    tracer = build_tracer(cfg, emit=on_record)
    auto = build_auto_from_cfg(cfg)
    return ServingEngine(auto, serve_cfg, gen_cfg, on_record=on_record, tracer=tracer)


def main(cfg: Any) -> int:
    """`python -m automodel_tpu_torch.cli.app serve -c cfg.yaml` (stdin
    JSONL, or HTTP when serving.http.port is set)."""
    t_boot = time.perf_counter()  # time_to_ready_s starts before the model build
    http_section = dict(_section(cfg, "serving").get("http") or {})
    metrics_path = _section(cfg, "logging").get("metrics_path")
    metric_logger = on_record = None
    if metrics_path:
        from automodel_tpu_torch.loggers.metric_logger import MetricLogger

        metric_logger = MetricLogger(metrics_path)

        def on_record(rec: dict) -> None:
            rec = dict(rec)
            rec.pop("tokens", None)  # completions don't belong in metrics
            metric_logger.log(rec)

    engine = build_engine(cfg, on_record=on_record)
    engine.boot_t = t_boot
    # stall evidence (stacks, flight recorder) lands beside the metrics JSONL
    flight_recorder = stacks_path = None
    if metrics_path:
        from automodel_tpu_torch.telemetry.flight_recorder import FlightRecorder, build_fingerprint

        parent = Path(metrics_path).parent
        stacks_path = str(parent / "watchdog_stacks.txt")
        flight_recorder = FlightRecorder(
            path=str(parent / "flight_recorder.json"),
            fingerprint=build_fingerprint(config=cfg.to_dict() if hasattr(cfg, "to_dict") else None),
        )
    engine.start_watchdog(flight_recorder=flight_recorder, metric_logger=metric_logger, stacks_path=stacks_path)
    try:
        if http_section.get("port") is not None:
            return _serve_http_forever(engine, http_section)
        return _serve_stdin(engine)
    finally:
        engine.stop_watchdog()


def start_http_front(engine: Any, http_section: dict):
    """The HTTP front up to ``serve_forever``: the warm-up (unless
    ``warmup: false``), ``serve_http``, the SIGTERM drain handler and the
    ``serve_listening`` line. → (server, loop, handler, state); a drain
    ends in ``server.shutdown()`` with the exit code in ``state["rc"]``."""
    port = int(http_section["port"])
    host = str(http_section.get("host", "127.0.0.1"))
    drain_cfg = engine.config.drain
    if http_section.get("warmup", True):
        _warmup(engine)
        engine.note_ready()
    state = {"rc": 0}
    server, loop = serve_http(engine, port, host=host)

    def _drain_then_stop():
        # begin_drain only flips flags the scheduler reads at its next
        # iteration: not under loop.lock, which a wedged step holds
        engine.begin_drain()
        deadline = time.monotonic() + drain_cfg.grace_s + 10.0
        while time.monotonic() < deadline:
            if engine.drain_complete() or not loop.alive():
                break
            time.sleep(0.05)
        state["rc"] = _drain_exit_code(drain_cfg)
        server.shutdown()

    def _on_term():
        threading.Thread(target=_drain_then_stop, name="serve-drain", daemon=True).start()

    handler = _install_drain_handler(engine, on_term=_on_term)
    c = engine.config
    print(json.dumps({
        "event": "serve_listening", "host": host, "port": server.server_address[1],
        "slots": c.slots, "num_blocks": c.num_blocks,
    }), flush=True)
    return server, loop, handler, state


def _serve_http_forever(engine: Any, http_section: dict) -> int:
    server, loop, handler, state = start_http_front(engine, http_section)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        loop.close()
        if handler is not None:
            handler.restore()
    return state["rc"]


def _error_line(lineno: int, e: Exception, rid: Any, **extra) -> None:
    err = {"error": f"line {lineno}: {e}", **extra}
    if rid is not None:
        err["id"] = rid
    print(json.dumps(err), flush=True)


def _serve_stdin(engine: Any) -> int:
    """Submit every stdin line, print terminal records as they happen. A
    daemon reader thread feeds a queue so the scheduler never blocks on
    stdin, and SIGTERM is seen between steps. On SIGTERM the rest of the
    input is not read: lines already read get retriable ``draining``
    error lines, queued requests draining records, and in-flight requests
    finish within the grace."""
    from automodel_tpu_torch.serving.engine import EngineDraining, QueueFull, QuotaExceeded

    drain_cfg = engine.config.drain
    handler = _install_drain_handler(engine)
    stdin = sys.stdin
    lines_q: "queue_mod.Queue[str]" = queue_mod.Queue()

    def _reader():
        while True:
            line = stdin.readline()
            lines_q.put(line)  # "" = EOF sentinel
            if line == "":
                return

    threading.Thread(target=_reader, name="serve-stdin", daemon=True).start()
    counts = {"submitted": 0, "bad": 0}

    def handle_line(line: str, lineno: int) -> None:
        line = line.strip()
        if not line:
            return
        rid = None
        req: dict = {}
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request line is not a JSON object")
            rid = req.get("id")
            ids = _encode_prompt(req)
            ctx = engine.tracer.parse(req.get("traceparent")) if engine.tracer is not None else None
            while True:
                try:
                    engine.submit(
                        ids,
                        request_id=str(rid) if rid is not None else None,
                        max_new_tokens=req.get("max_new_tokens"),
                        deadline_s=req.get("deadline_s"),
                        max_queue_wait_s=req.get("max_queue_wait_s"),
                        tenant=req.get("tenant"),
                        tier=req.get("tier"),
                        return_logprobs=bool(req.get("return_logprobs", False)),
                        kv_peer=req.get("kv_peer"),
                        trace=ctx,
                    )
                    break
                except QueueFull:
                    # a bounded queue under unbounded stdin: absorb the
                    # backpressure with a step, and shed only when the step
                    # retired nothing and the queue is still full
                    before = engine.completed_total + engine.failed_total
                    for rec in engine.step():
                        _emit(rec)
                    if (engine.completed_total + engine.failed_total == before
                            and engine.queue_depth >= engine.config.max_queue):
                        raise
        except QueueFull as e:
            engine.record_shed(
                request_id=str(rid) if rid is not None else None, tenant=req.get("tenant"), tier=req.get("tier"),
            )
            _error_line(lineno, e, rid, retriable=True, reason="shed")
        except QuotaExceeded as e:
            engine.record_quota(request_id=str(rid) if rid is not None else None, tenant=e.tenant, tier=e.tier)
            _error_line(lineno, e, rid, retriable=True, reason="quota", tenant=e.tenant, tier=e.tier)
        except EngineDraining as e:
            _error_line(lineno, e, rid, retriable=True, reason="draining")
        except (ValueError, TypeError) as e:
            counts["bad"] += 1
            _error_line(lineno, e, rid)
        else:
            counts["submitted"] += 1

    lineno = 0
    eof = False
    while not eof:
        if handler is not None and handler.preempted and not engine.draining:
            engine.begin_drain()
        if engine.draining:
            break
        got_line = False
        try:
            line = lines_q.get_nowait()
            if line == "":
                eof = True
            else:
                lineno += 1
                handle_line(line, lineno)
                got_line = True
        except queue_mod.Empty:
            pass
        if not engine.idle():
            for rec in engine.step():
                _emit(rec)
        elif not got_line and not eof:
            engine.touch_watchdog()
            time.sleep(0.02)

    def _reject_buffered_lines() -> None:
        # lines the reader already took off the pipe are gone from the
        # client's side: each gets a retriable error line on a drain
        while True:
            try:
                line = lines_q.get_nowait().strip()
            except queue_mod.Empty:
                return
            if not line:
                continue
            err = {"error": "server is draining — retry against another replica", "retriable": True,
                   "reason": "draining"}
            try:
                req = json.loads(line)
                if isinstance(req, dict) and req.get("id") is not None:
                    err["id"] = req["id"]
            except ValueError:
                pass
            print(json.dumps(err), flush=True)

    # EOF or drain: finish the remaining work; a SIGTERM landing here still
    # starts the drain. Bounded by the same guard as ServingEngine.run.
    c = engine.config
    per_req = -(-c.max_seq_len // c.prefill_chunk) + c.max_seq_len
    iter_bound = 64 + (engine.queue_depth + engine.busy_slots + 1) * (per_req + 2)
    drained_rc = None
    for _ in range(iter_bound):
        if handler is not None and handler.preempted and not engine.draining:
            engine.begin_drain()
        if engine.draining:
            _reject_buffered_lines()
            if engine.drain_complete():
                drained_rc = _drain_exit_code(drain_cfg)
                break
        elif engine.idle():
            break
        for rec in engine.step():
            _emit(rec)
    else:
        raise RuntimeError(
            f"serving engine failed to drain within {iter_bound} iterations "
            f"(queue={engine.queue_depth}, busy={engine.busy_slots})"
        )
    if handler is not None:
        handler.restore()
    if drained_rc is not None:
        _reject_buffered_lines()  # lines that raced in during the drain
        return drained_rc
    if counts["submitted"] == 0:
        print(
            'no requests: pipe JSONL lines like {"prompt_ids": [1, 2, 3], '
            '"max_new_tokens": 8} into stdin',
            file=sys.stderr,
        )
        return 2
    return 0 if counts["bad"] == 0 else 1


def _emit(rec: dict, out=None) -> None:
    out = out or sys.stdout
    rec = dict(rec)
    if rec.get("event") == "serve_engine_event":
        # engine-level evidence (a stall or error rebuild), as it is
        print(json.dumps(rec), file=out, flush=True)
        return
    rec["completion"] = " ".join(map(str, rec.pop("tokens", [])))
    rec.pop("event", None)
    print(json.dumps(rec), file=out, flush=True)
