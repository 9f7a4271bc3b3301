"""The port's request tracing (``automodel_tpu_torch/telemetry/tracing.py``
and its serving hooks) against the JAX package's: ``traceparent`` parse and
format, the strict ``tracing:`` section, sampling and its inheritance, the
assembler, the waterfall and the Chrome trace on the same span files, and
the same tiny workload through both engines with tracing on, which must
leave the same (request, stage, parent stage) span multiset and the same
``automodel_serve_stage_seconds`` counts. Durations may differ. Then the
port's own paths: the speculative round's spans, a spill reload's span,
the HTTP ``traceparent`` header, and the traced stdin CLI whose JSONL the
``trace`` command assembles with no orphan and ``report --strict``
accepts."""

import io
import json
import os
import random
import re
import threading
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest

from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
from automodel_tpu.serving.engine import ServeConfig as JServeConfig
from automodel_tpu.serving.engine import ServingEngine as JServingEngine
from automodel_tpu.telemetry import tracing as jtr
from automodel_tpu.telemetry.federation import parse_exposition
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.generation.engine import GenerationConfig
from automodel_tpu_torch.serving.engine import KVSpillConfig, ServeConfig, ServingEngine
from automodel_tpu_torch.telemetry import tracing as ttr
from torch_port_parity import jax_tiny, torch_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACED_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu_traced.yaml")
SPEC_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu_spec.yaml")
SERVE = dict(slots=2, block_size=4, num_blocks=64, prefill_chunk=8, max_seq_len=64, decode_kernel="gather")
STAGES = ("serve", "queue", "admission", "prefill", "decode")


@pytest.fixture(scope="module")
def models():
    _, params, jauto = jax_tiny(seed=0)
    return jauto, torch_twin(params)


def _spans(records):
    return [r for r in records if r.get("event") == "span"]


def _mk_span(tid, sid, stage, ts, dur, parent=None, process="p"):
    s = {"event": "span", "trace_id": tid, "span_id": sid, "stage": stage, "process": process, "ts": ts,
         "duration_s": dur}
    if parent:
        s["parent_id"] = parent
    return s


# -- units ----------------------------------------------------------------------


HEADERS = [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "  00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-03  ",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-" + "0" * 32 + "-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-" + "0" * 16 + "-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",
    "garbage", "", None, 7,
]


def test_traceparent_roundtrip_and_rejection_match_jax():
    for h in HEADERS:
        t, j = ttr.parse_traceparent(h), jtr.parse_traceparent(h)
        assert (t is None) == (j is None), h
        if t is not None:
            assert (t.trace_id, t.span_id, t.sampled, t.parent_id) == (j.trace_id, j.span_id, j.sampled, j.parent_id)
            assert ttr.to_traceparent(t) == jtr.to_traceparent(j)
            assert ttr.parse_traceparent(ttr.to_traceparent(t)) == t
    assert sum(ttr.parse_traceparent(h) is not None for h in HEADERS) == 3


def test_tracing_config_strict_like_jax():
    for mod in (ttr, jtr):
        assert mod.TracingConfig.from_dict(None) == mod.TracingConfig(enabled=True, sample_rate=1.0)
        assert mod.TracingConfig.from_dict({"_target_": "x", "sample_rate": 0.5}).sample_rate == 0.5
        with pytest.raises(TypeError, match="unknown tracing keys"):
            mod.TracingConfig.from_dict({"sample": 1.0})
        with pytest.raises(ValueError, match="sample_rate"):
            mod.TracingConfig(sample_rate=1.5)
    assert ttr.Tracer.from_config(ttr.TracingConfig(enabled=False), "p", emit=print) is None
    assert ttr.Tracer.from_config(ttr.TracingConfig(), "p", emit=None) is None


def test_sampling_is_decided_at_the_root_and_inherited():
    out = []
    off = ttr.Tracer("p", emit=out.append, sample_rate=0.0, seed=0)
    root = off.start()
    assert not root.sampled and not off.active(root)
    assert off.child(root, "queue", 0.0, 1.0) is None and out == []
    # a sampled parent from elsewhere is honoured even at rate 0
    remote = ttr.SpanContext("a" * 32, "b" * 16, sampled=True)
    child = off.start(parent=remote)
    assert child.sampled and child.trace_id == remote.trace_id and child.parent_id == remote.span_id
    # the same seeded rate samples the same roots as JAX's tracer
    t = ttr.Tracer("p", emit=out.append, sample_rate=0.3, seed=11)
    j = jtr.Tracer("p", emit=out.append, sample_rate=0.3, seed=11)
    assert [t.start().sampled for _ in range(64)] == [j.start().sampled for _ in range(64)]
    # a failing emit or observe never reaches the caller
    seen = []

    def boom(_):
        raise RuntimeError("sink down")

    bad = ttr.Tracer("p", emit=boom, observe=lambda s, d: seen.append((s, d)))
    rec = bad.record(bad.start(), "serve", 1.0, 1.5, request_id="r")
    assert rec["duration_s"] == 0.5 and seen == [("serve", 0.5)]


def _assembly_cases():
    tid = "t" * 32
    ordered = [
        _mk_span(tid, "a" * 16, "route", 100.0, 1.0),
        _mk_span(tid, "b" * 16, "forward", 100.2, 0.7, parent="a" * 16),
        _mk_span(tid, "c" * 16, "serve", 100.3, 0.5, parent="b" * 16),
        _mk_span(tid, "d" * 16, "queue", 100.3, 0.1, parent="c" * 16),
    ]
    random.Random(7).shuffle(ordered)
    skewed = [
        _mk_span("s" * 32, "a" * 16, "route", 1000.0, 0.5, process="router"),
        _mk_span("s" * 32, "b" * 16, "serve", 995.1, 0.2, parent="a" * 16, process="replica"),
        _mk_span("s" * 32, "c" * 16, "queue", 995.1, 0.05, parent="b" * 16, process="replica"),
        _mk_span("s" * 32, "e" * 16, "decode", 1001.0, 0.1, parent="b" * 16, process="late"),
    ]
    orphaned = [
        _mk_span("o" * 32, "a" * 16, "route", 10.0, 1.0),
        _mk_span("o" * 32, "z" * 16, "kv_receive", 10.5, 0.1, parent="9" * 16),
        _mk_span("q" * 32, "b" * 16, "serve", 5.0, 0.3, parent="8" * 16),
    ]
    return {"out_of_order": ordered, "skewed": skewed, "orphans_and_partial": orphaned}


@pytest.mark.parametrize("case", sorted(_assembly_cases()))
def test_assembly_waterfall_and_chrome_equal_jax(case, tmp_path):
    spans = _assembly_cases()[case]
    bad = ['{"event": "span", "trace_id": "x", "ts": NaN}', '{"event": "span", "trace_id": "y", "span_id": "z"}']
    path = tmp_path / "spans.jsonl"
    path.write_text("".join(json.dumps(s) + "\n" for s in spans) + "\n".join(bad) + "\n")
    (ts, tp), (js, jp) = ttr.read_span_records([str(path)]), jtr.read_span_records([str(path)])
    assert ts == js and tp == jp and len(tp) == 2
    tt, jt = ttr.assemble_traces(ts), jtr.assemble_traces(js)
    assert tt == jt
    assert ttr.render_report(tt, [str(path)], tp) == jtr.render_report(jt, [str(path)], jp)
    assert ttr.chrome_trace(tt) == jtr.chrome_trace(jt)
    for mod, tag in ((ttr, "t"), (jtr, "j")):
        assert mod.main([str(path), "--chrome", str(tmp_path / f"{tag}.json"), "--md", str(tmp_path / f"{tag}.md")]) == 0
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert (tmp_path / "t.md").read_text() == (tmp_path / "j.md").read_text()


def test_trace_cli_usage_and_empty_input(tmp_path, capsys):
    assert app.main(["trace"]) == 2
    empty = tmp_path / "e.jsonl"
    empty.write_text('{"event": "serve_request"}\n')
    assert app.main(["trace", str(empty)]) == 1
    assert "no span records" in capsys.readouterr().err
    assert app.main(["trace", str(empty), "--chrome"]) == 2


# -- the engines ----------------------------------------------------------------


def _workload():
    rng = np.random.default_rng(5)
    long = rng.integers(1, 128, size=19).tolist()  # 3 chunks of 8
    return [
        rng.integers(1, 128, size=5).tolist(),
        long,
        rng.integers(1, 128, size=3).tolist(),
        long[:12] + rng.integers(1, 128, size=4).tolist(),  # a prefix hit
        rng.integers(1, 128, size=9).tolist(),
    ]


def _drive(engine, traced_parent, unsampled_parent):
    prompts = _workload()
    for i, p in enumerate(prompts):
        trace = traced_parent if i == 1 else unsampled_parent if i == 4 else None
        engine.submit(p, request_id=f"r{i}", trace=trace)
    engine.run()
    # a queue timeout: its whole life is the queue, and its root says why
    engine.submit([1, 2, 3], request_id="late", max_queue_wait_s=1e-9)
    time.sleep(0.002)
    engine.run()


def _shape(records):
    """(request, stage, parent stage) multiset, the root's parent named by
    id when it came from outside."""
    spans = _spans(records)
    by_id = {s["span_id"]: s for s in spans}
    out = Counter()
    for s in spans:
        pid = s.get("parent_id")
        parent = by_id[pid]["stage"] if pid in by_id else pid
        out[(s["request_id"], s["stage"], parent)] += 1
    return out


def _stage_counts(engine):
    """``automodel_serve_stage_seconds`` counts by stage, read off the
    rendered exposition."""
    body = engine.metrics.registry.render()
    return {m[0]: int(m[1]) for m in re.findall(r'automodel_serve_stage_seconds_count\{stage="(\w+)"\} (\d+)', body)}


def test_engine_spans_equal_jax_engine(models):
    jauto, tauto = models
    jrec, trec = [], []
    gen = dict(max_new_tokens=6, greedy=True)
    je = JServingEngine(jauto, JServeConfig(**SERVE), JGenerationConfig(**gen), on_record=jrec.append,
                        tracer=jtr.Tracer("jax", emit=jrec.append))
    te = ServingEngine(tauto, ServeConfig(**SERVE), GenerationConfig(**gen), on_record=trec.append,
                       tracer=ttr.Tracer("port", emit=trec.append))
    assert te.tracer.observe == te.metrics.observe_stage and te.tracer.clock is te._clock
    _drive(je, jtr.SpanContext("d" * 32, "2" * 16), jtr.SpanContext("f" * 32, "1" * 16, sampled=False))
    _drive(te, ttr.SpanContext("d" * 32, "2" * 16), ttr.SpanContext("f" * 32, "1" * 16, sampled=False))
    shape = _shape(trec)
    assert shape == _shape(jrec)
    assert shape[("r1", "prefill", "serve")] == 3 and shape[("r1", "serve", "2" * 16)] == 1
    assert not any(k[0] == "r4" for k in shape)  # the unsampled parent is honoured
    assert shape[("late", "queue", "serve")] == 1 and shape[("late", "serve", None)] == 1
    late = next(s for s in _spans(trec) if s["stage"] == "serve" and s["request_id"] == "late")
    assert late["completion_reason"] == "timeout"
    # every span observed the /metrics stage histogram, as in JAX
    counts = _stage_counts(te)
    assert counts == _stage_counts(je) and set(counts) == set(STAGES)
    assert counts == dict(Counter(s["stage"] for s in _spans(trec)))
    assert "automodel_serve_stage_seconds" in parse_exposition(te.metrics.registry.render())
    # each child lies inside its root, and the trace assembles whole
    spans = _spans(trec)
    roots = {s["span_id"]: s for s in spans if s["stage"] == "serve"}
    for s in spans:
        if s["stage"] != "serve":
            r = roots[s["parent_id"]]
            assert r["ts"] - 1e-6 <= s["ts"] and s["ts"] + s["duration_s"] <= r["ts"] + r["duration_s"] + 1e-3
    traces = ttr.assemble_traces(spans)
    assert len(traces) == 5 and sum(len(t["orphans"]) for t in traces) == 1  # r1's parent is remote
    # the record's ts shares the spans' wall anchor
    req = next(r for r in trec if r.get("event") == "serve_request" and r["request_id"] == "r0")
    root = next(s for s in spans if s["stage"] == "serve" and s["request_id"] == "r0")
    assert 0 <= req["ts"] - (root["ts"] + root["duration_s"]) < 1.0


def test_spill_reload_and_speculative_rounds_leave_spans(models):
    _, tauto = models
    recs = []
    eng = ServingEngine(
        tauto,
        ServeConfig(slots=1, block_size=4, num_blocks=12, prefill_chunk=4, max_seq_len=64, decode_kernel="gather",
                    kv_spill=KVSpillConfig(enabled=True, max_host_mb=4.0)),
        GenerationConfig(max_new_tokens=6, greedy=True), tracer=ttr.Tracer("port", emit=recs.append),
    )
    for i, (p, n) in enumerate(((list(range(1, 14)), 6), (list(range(20, 60)), 2), (list(range(1, 14)), 6))):
        eng.submit(p, request_id=f"s{i}", max_new_tokens=n)
        eng.run()
    (reload,) = [s for s in _spans(recs) if s["stage"] == "kv_reload"]
    assert reload["request_id"] == "s2" and reload["blocks"] == eng.pool.counters["spill_reloaded_blocks"] == 3
    # speculative serving through its CLI config: one propose and one verify
    # span a round for each slot the round served
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.serving.server import build_engine

    cfg = load_yaml_config(SPEC_CFG)
    cfg.set_by_path("tracing", {"enabled": True})
    recs = []
    eng = build_engine(cfg, on_record=recs.append)
    for i in range(2):
        eng.submit([1, 2, 3, 4 + i], request_id=f"q{i}", max_new_tokens=6)
    eng.run()
    spans = _spans(recs)
    per = Counter((s["request_id"], s["stage"]) for s in spans)
    for rid in ("q0", "q1"):
        assert per[(rid, "spec_propose")] == per[(rid, "spec_verify")] >= 1
    assert sum(per[(r, "spec_verify")] for r in ("q0", "q1")) <= 2 * eng.spec_rounds
    assert all(s["k"] == eng.config.speculative.k for s in spans if s["stage"] == "spec_propose")


def test_http_front_reads_the_traceparent_header(models):
    from automodel_tpu_torch.serving.server import serve_http

    _, tauto = models
    recs = []
    eng = ServingEngine(tauto, ServeConfig(**SERVE), GenerationConfig(max_new_tokens=3, greedy=True),
                        on_record=recs.append, tracer=ttr.Tracer("port", emit=recs.append))
    server, loop = serve_http(eng, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    try:
        parent = "00-" + "c" * 32 + "-" + "3" * 16 + "-01"
        for headers, body in (({"traceparent": parent}, {}), ({}, {"traceparent": parent.replace("c", "e")}), ({}, {})):
            req = urllib.request.Request(
                url, data=json.dumps({"prompt_ids": [1, 2, 3], **body}).encode(),
                headers={"Content-Type": "application/json", **headers},
            )
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
    finally:
        server.shutdown()
        server.server_close()
        loop.close()
    roots = [s for s in _spans(recs) if s["stage"] == "serve"]
    assert [(r["trace_id"][:1], r.get("parent_id")) for r in roots][:2] == [("c", "3" * 16), ("e", "3" * 16)]
    assert "parent_id" not in roots[2]


def test_traced_stdin_serve_assembles_and_passes_report_strict(monkeypatch, capsys, tmp_path):
    metrics = tmp_path / "serve.jsonl"
    lines = [
        json.dumps({"id": "a", "prompt_ids": list(range(1, 12)), "max_new_tokens": 5}),
        json.dumps({"id": "b", "prompt_ids": [3, 4], "max_new_tokens": 3}),
    ]
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(x + "\n" for x in lines)))
    assert app.main(["serve", "-c", TRACED_CFG, f"--logging.metrics_path={metrics}"]) == 0
    capsys.readouterr()
    spans, problems = ttr.read_span_records([str(metrics)])
    assert problems == [] and Counter(s["stage"] for s in spans)["serve"] == 2
    chrome, md = tmp_path / "t.json", tmp_path / "t.md"
    assert app.main(["trace", str(metrics), "--chrome", str(chrome), "--md", str(md)]) == 0
    traces = ttr.assemble_traces(spans)
    assert len(traces) == 2 and not any(t["orphans"] or t["partial"] for t in traces)
    assert json.loads(chrome.read_text())["traceEvents"] and "## trace" in md.read_text()
    assert app.main(["report", str(metrics), "--strict"]) == 0
    # JAX's linter accepts the same file
    from automodel_tpu.telemetry.report import lint_metrics_jsonl

    assert lint_metrics_jsonl(str(metrics))[1] == []
