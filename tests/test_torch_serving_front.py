"""The port's serving front — drain, the stall watchdog and its rebuild, the
HTTP server, ``/stats`` and ``/metrics`` — against the JAX package's.

The engines run on the same tiny Llama weights (``params_from_jax``) and the
same requests; each test compares records reason by reason (tokens,
``completion_reason``, ``retriable``, ``tenant``, ``tier``), counters, the
``/stats`` and ``/metrics`` key sets and the HTTP status codes. A stall or a
failing program is planted on the JAX side with its own fault injection and
on the port's with a wrapped decode program. The ``serve`` CLI runs as a
subprocess for the SIGTERM drains (stdin and HTTP, exit 0 and, under a
slurm job id, 75). Watchdog timings use short CPU deadlines (0.2-0.5 s)
against a stall of several deadlines; every HTTP call and join has a
timeout. Mirrors ``tests/test_serving.py`` :577, :834, :871, :973, :990 and
``tests/test_serving_chaos.py`` :127, :193, :591.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
from automodel_tpu.resilience import fault_injection as fi
from automodel_tpu.serving import engine as jeng
from automodel_tpu.serving import server as jsrv
from automodel_tpu.telemetry.federation import parse_exposition
from automodel_tpu_torch.generation.engine import GenerationConfig
from automodel_tpu_torch.serving import engine as teng
from automodel_tpu_torch.serving import server as tsrv
from torch_port_parity import jax_tiny, torch_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONT_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu_front.yaml")
SERVE = dict(slots=2, block_size=4, num_blocks=32, prefill_chunk=4, max_seq_len=32, decode_kernel="gather")
CPU_WATCHDOG = dict(min_deadline_s=0.2, max_deadline_s=0.5, multiplier=4.0, poll_interval_s=0.02,
                    compile_grace_s=60.0)


@pytest.fixture(scope="module")
def models():
    _, params, jauto = jax_tiny(seed=0)
    return jauto, torch_twin(params)


@pytest.fixture(autouse=True)
def _clear_injector():
    yield
    fi.activate(None)


def _pair(models, max_new: int = 4, **serve):
    """(JAX engine, port engine, JAX records, port records) over the same
    serving section (sub-sections as dicts)."""
    cfg = dict(SERVE, **serve)
    out = []
    for mod, auto, gen in ((jeng, models[0], JGenerationConfig), (teng, models[1], GenerationConfig)):
        records = []
        out.append((mod.ServingEngine(auto, mod.ServeConfig.from_dict(cfg), gen(max_new_tokens=max_new, greedy=True),
                                      on_record=records.append), records))
    (je, jr), (te, tr) = out
    return je, te, jr, tr


def _by_id(records) -> dict:
    keys = ("completion_reason", "retriable", "tenant", "tier", "tokens")
    return {r["request_id"]: tuple(r[k] for k in keys) for r in records if r.get("event") == "serve_request"}


def _keys(d, prefix="") -> set:
    """Every key path of a nested dict (``hot_prefixes`` values aside)."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("queued_by_tenant", "tenants"):
            out |= _keys(v, prefix + k + ".")
    return out


# -- drain -----------------------------------------------------------------------


def test_drain_rejects_queue_finishes_inflight_and_stamps_duration(models):
    je, te, jr, tr = _pair(models, drain={"grace_s": 30.0})
    for eng in (je, te):
        eng.submit([1, 2, 3], request_id="a")
        eng.submit([4, 5], request_id="b")
        eng.step()  # a and b admitted
        eng.submit([6, 7], request_id="c")  # queued behind full slots
        eng.begin_drain()
        with pytest.raises((jeng.EngineDraining, teng.EngineDraining)):
            eng.submit([9, 9])
        for _ in range(200):
            eng.step()
            if eng.drain_complete():
                break
        assert eng.drain_duration_s is not None and eng.drain_duration_s >= 0
        eng.check_invariants()
        assert eng.pool.available() == eng.pool.usable_blocks
        eng.metrics.sync(eng)
        text = eng.metrics.registry.render()
        assert "automodel_serve_draining 1" in text and "automodel_serve_drain_duration_seconds" in text
    recs = _by_id(tr)
    assert recs == _by_id(jr)
    assert recs["c"][:2] == ("draining", True) and recs["a"][0] == recs["b"][0] == "length"
    assert (te.completed_total, te.failed_total) == (je.completed_total, je.failed_total) == (2, 1)


def test_drain_grace_expiry_cancels_inflight(models):
    je, te, jr, tr = _pair(models, max_new=20, slots=1, num_blocks=64, max_seq_len=64, drain={"grace_s": 0.0})
    for eng in (je, te):
        eng.submit([1, 2, 3], request_id="a")
        eng.step()  # admitted, prefilling
        eng.begin_drain()
        for _ in range(50):
            eng.step()
            if eng.drain_complete():
                break
        eng.check_invariants()
        assert eng.pool.available() == eng.pool.usable_blocks
    recs = _by_id(tr)
    assert recs == _by_id(jr) and [r[:2] for r in recs.values()] == [("cancelled", True)]


def test_drain_exit_code_policy(monkeypatch):
    for k in ("SLURM_JOB_ID", "KUBERNETES_SERVICE_HOST"):
        monkeypatch.delenv(k, raising=False)
    cases = [({}, "auto", 0), ({}, "always", 75), ({"SLURM_JOB_ID": "1234"}, "auto", 75),
             ({"SLURM_JOB_ID": "1234"}, "never", 0), ({"KUBERNETES_SERVICE_HOST": "10.0.0.1"}, "auto", 75)]
    for env, policy, want in cases:
        for k in ("SLURM_JOB_ID", "KUBERNETES_SERVICE_HOST"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = tsrv._drain_exit_code(teng.DrainConfig(requeue_exit=policy))
        assert got == jsrv._drain_exit_code(jeng.DrainConfig(requeue_exit=policy)) == want, (env, policy)
    with pytest.raises(ValueError, match="requeue_exit"):
        teng.DrainConfig(requeue_exit="sometimes")


# -- /stats and /metrics ----------------------------------------------------------


def test_stats_and_metrics_key_sets_match_jax(models):
    """``stats_snapshot`` has JAX's keys (nested ones too) and a mixed
    replica's fleet values; after the same traffic with spill and QoS on,
    the counters agree and ``/metrics`` renders the same families and
    samples (parsed by the JAX package's parser)."""
    je, te, jr, tr = _pair(models, kv_spill={"enabled": True, "max_host_mb": 4.0}, num_blocks=12, max_seq_len=64,
                           qos={"enabled": True, "tenants": {"t": {"tier": "batch"}}})
    for eng in (je, te):
        for i, p in enumerate((list(range(1, 14)), list(range(20, 60)), list(range(1, 14)))):
            eng.submit(p, request_id=f"r{i}", tenant="t" if i else None)
            eng.run()
        eng.metrics.sync(eng)
    assert _by_id(tr) == _by_id(jr)
    js, ts = jsrv.stats_snapshot(je), tsrv.stats_snapshot(te)
    assert _keys(ts) == _keys(js)
    fleet = dict(role="mixed", kv_transfer_port=None, kv_injected_total=0, boot_source="cold_hf", weights_version=0)
    assert {k: ts[k] for k in fleet} == {k: js[k] for k in fleet} == fleet
    same = ("completed_total", "failed_total", "allocator", "spill_bytes", "spill_entries", "qos", "hot_prefixes",
            "block_size", "quota_total", "shed_total")
    assert {k: ts[k] for k in same} == {k: js[k] for k in same}
    assert ts["allocator"]["spill_reloads"] == 1
    jf, tf = parse_exposition(je.metrics.registry.render()), parse_exposition(te.metrics.registry.render())
    assert set(tf) == set(jf)
    skip = {"automodel_serve_ttft_seconds", "automodel_serve_decode_tps", "automodel_serve_queue_seconds",
            "automodel_serve_tier_ttft_seconds", "automodel_serve_block_occupancy"}
    for name in set(tf) - skip:
        assert tf[name].samples == jf[name].samples, name
    for name in skip - {"automodel_serve_block_occupancy"}:
        assert {k: h.count for k, h in tf[name].histograms.items()} == {
            k: h.count for k, h in jf[name].histograms.items()}, name


# -- the HTTP front ---------------------------------------------------------------


def _http(port, path, body=None, headers=None, timeout=60):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            return resp.status, (raw.decode() if path == "/metrics" else json.loads(raw)), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class _Fronts:
    """Both HTTP fronts up on ephemeral loopback ports."""

    def __init__(self, je, te):
        self.engines = (je, te)
        self.servers = [jsrv.serve_http(je, None, port=0), tsrv.serve_http(te, port=0)]
        self.threads = [threading.Thread(target=s.serve_forever, daemon=True) for s, _ in self.servers]
        for t in self.threads:
            t.start()
        self.ports = [s.server_address[1] for s, _ in self.servers]

    def call(self, path, body=None, headers=None):
        return [_http(p, path, body, headers) for p in self.ports]

    def close(self):
        for (server, loop), t in zip(self.servers, self.threads):
            server.shutdown()
            server.server_close()
            loop.close()
            t.join(timeout=10)


def test_http_front_matches_jax(models):
    """/readyz before the first decode and while draining, /healthz,
    /generate (the same completion), a bad request, /stats and /metrics,
    the drain's 503 with Retry-After: the same codes and keys as JAX's."""
    je, te, jr, tr = _pair(models)
    fronts = _Fronts(je, te)
    try:
        (jc, jb, _), (tc, tb, _) = fronts.call("/readyz")
        assert tc == jc == 503 and tb == jb == {"ready": False, "draining": False, "first_decode_done": False}
        (jc, jb, _), (tc, tb, _) = fronts.call("/healthz")
        assert tc == jc == 200 and set(tb) == set(jb) and tb["ok"] is True
        body = {"prompt": "1 2 3", "max_new_tokens": 3, "id": "x"}
        (jc, jb, _), (tc, tb, _) = fronts.call("/generate", body)
        assert tc == jc == 200 and tb["completion"] == jb["completion"] and len(tb["completion"].split()) == 3
        assert set(tb) == set(jb) and tb["id"] == "x" and tb["ttft_s"] > 0
        (jc, _, _), (tc, _, _) = fronts.call("/readyz")
        assert tc == jc == 200
        (jc, _, _), (tc, _, _) = fronts.call("/generate", {})
        assert tc == jc == 400
        (jc, jb, _), (tc, tb, _) = fronts.call("/stats")
        assert _keys(tb) == _keys(jb) and tb["completed_total"] == jb["completed_total"] == 1
        (_, jm, _), (_, tm, _) = fronts.call("/metrics")
        assert set(parse_exposition(tm)) == set(parse_exposition(jm))
        for (_, loop), eng in zip(fronts.servers, fronts.engines):
            with loop.lock:
                eng.begin_drain()
        (jc, jb, _), (tc, tb, _) = fronts.call("/readyz")
        assert tc == jc == 503 and tb["draining"] is jb["draining"] is True
        (jc, jb, jh), (tc, tb, th) = fronts.call("/generate", body)
        assert tc == jc == 503 and tb["reason"] == jb["reason"] == "draining"
        assert th.get("Retry-After") == jh.get("Retry-After") == "5"
        (jc, jb, _), (tc, tb, _) = fronts.call("/stats")
        assert tb["draining"] is jb["draining"] is True
    finally:
        fronts.close()


def test_http_qos_quota_and_shed_codes_match_jax(models):
    """Tenants named by body and by the X-Tenant-Id / X-Tier headers: a
    quota trip is 429 with the tier-scaled Retry-After, an unknown tier
    400, and the terminal records agree."""
    qos = {"enabled": True, "tenants": {"demo": {"tier": "interactive", "requests_per_s": 0.01, "burst_s": 100}}}
    je, te, jr, tr = _pair(models, qos=qos)
    fronts = _Fronts(je, te)
    try:
        p = {"prompt_ids": [1, 2, 3], "max_new_tokens": 2}
        calls = [
            (dict(p, tenant="demo"), {}),
            (dict(p, tenant="demo"), {}),  # bucket empty: 429
            (p, {"X-Tenant-Id": "demo", "X-Tier": "best_effort"}),  # 429, Retry-After 15
            (p, {"X-Tenant-Id": "other", "X-Tier": "batch"}),
            (dict(p, tier="platinum"), {}),  # 400
        ]
        for body, headers in calls:
            (jc, jb, jh), (tc, tb, th) = fronts.call("/generate", body, headers)
            assert tc == jc, (body, headers, jb, tb)
            assert th.get("Retry-After") == jh.get("Retry-After"), (body, headers)
            if tc == 429:
                assert (tb["reason"], tb["tenant"], tb["tier"]) == (jb["reason"], jb["tenant"], jb["tier"])
            if tc == 200:
                assert (tb["tenant"], tb["tier"], tb["completion"]) == (jb["tenant"], jb["tier"], jb["completion"])
        (jc, jb, _), (tc, tb, _) = fronts.call("/stats")
        assert tb["quota_total"] == jb["quota_total"] == 2 and tb["qos"] == jb["qos"]
    finally:
        fronts.close()
    strip = ("completion_reason", "retriable", "tenant", "tier")
    assert sorted(tuple(r[k] for k in strip) for r in tr) == sorted(tuple(r[k] for k in strip) for r in jr)


def test_http_front_concurrent_clients_each_get_one_answer(models):
    """Eight client threads against one front, with a short thread switch
    interval: every request is answered once with its own record, and the
    engine's counters and allocator agree with them."""
    _, te, _, tr = _pair(models, max_queue=64)
    server, loop = tsrv.serve_http(te, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    answers = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            for i in range(2):
                answers.append(_http(port, "/generate", {"prompt_ids": [1 + c, 2 + i, 3], "max_new_tokens": 2}))

        clients = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in clients)
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
        server.server_close()
        loop.close()
        thread.join(timeout=10)
    n = 2 * len(clients)
    assert len(answers) == n and {code for code, _, _ in answers} == {200}
    rids = [body["request_id"] for _, body, _ in answers]
    assert len(set(rids)) == n and sorted(rids) == sorted(r["request_id"] for r in tr)
    assert te.completed_total == n and te.idle()
    te.check_invariants()
    assert te.pool.available() == te.pool.usable_blocks


def test_fleet_paths_handoff_and_kv_peer_are_refused_by_name(models):
    _, te, _, _ = _pair(models)
    server, loop = tsrv.serve_http(te, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        for path in ("/kv_fetch", "/retire", "/prefill", "/swap_weights"):
            code, body, _ = _http(port, path, {})
            assert code == 400 and "not ported" in body["error"], path
        code, body, _ = _http(port, "/generate", {"prompt_ids": [1, 2], "handoff_id": "h1"})
        assert code == 400 and "handoff_id" in body["error"]
        code, body, _ = _http(port, "/generate", {"prompt_ids": [1, 2], "kv_peer": {"host": "h", "port": 1}})
        assert code == 400 and "kv_peer" in body["error"]
    finally:
        server.shutdown()
        server.server_close()
        loop.close()
        thread.join(timeout=10)
    with pytest.raises(ValueError, match="kv_peer"):
        te.submit([1, 2], kv_peer={"host": "127.0.0.1", "port": 9})


# -- watchdog and rebuild ----------------------------------------------------------


def _chaos_pair(models, tmp_path, **serve):
    serve.setdefault("watchdog", dict(CPU_WATCHDOG, stacks_path=str(tmp_path / "stacks.txt")))
    return _pair(models, slots=2, num_blocks=48, **serve)


def _drive(eng, arm, n=8):
    """Submit ``n`` requests, arm the fault once the engine is warm (step
    3), step until idle, auditing the allocator after every step. →
    {request id: record}."""
    rids = [eng.submit([1 + i, 2 + i, 3 + i, 4], request_id=f"r{i}") for i in range(n)]
    out = []
    armed = False
    for _ in range(10_000):
        if not armed and eng._step_counter >= 3:
            arm(eng)
            armed = True
        if eng.idle():
            break
        out.extend(eng.step())
        eng.pool.check_invariants()
    by_id = {r["request_id"]: r for r in out}
    assert armed and sorted(by_id) == sorted(rids), "a request was dropped or duplicated"
    return by_id


def _port_fault(eng, fault):
    """Wrap the port engine's decode program: the next call sleeps 2 s
    (a stall around a real launch) or raises once."""
    real = eng._decode

    def once(*a, **k):
        eng._decode = real
        if fault == "hang":
            time.sleep(2.0)
            return real(*a, **k)
        raise RuntimeError("planted decode failure")

    eng._decode = once


def _serves_after(eng):
    rid = eng.submit([7, 8, 9])
    done = {r["request_id"]: r for r in eng.run()}
    assert done[rid]["completion_reason"] in ("stop", "length")
    eng.pool.check_invariants()


def test_chaos_hung_decode_fails_wave_and_recovers(models, tmp_path):
    """A decode step stalled past the watchdog's deadline: on both engines
    the watchdog fires once, dumps stacks, only the in-flight wave ends
    ``engine_stall`` (retriable), the pool rebuilds leak-free, the stall
    counter and its metric read 1, and the engine serves on."""
    je, te, jr, tr = _chaos_pair(models, tmp_path)
    results = {}
    for name, eng in (("jax", je), ("torch", te)):
        wd = eng.start_watchdog()
        try:
            if name == "jax":
                arm = lambda e: fi.activate({"serve_hang_at_step": e._step_counter + 1, "serve_hang_seconds": 2.0})
            else:
                arm = lambda e: _port_fault(e, "hang")
            by_id = _drive(eng, arm)
            results[name] = sorted({r["completion_reason"] for r in by_id.values()})
            stalled = [r for r in by_id.values() if r["completion_reason"] == "engine_stall"]
            assert stalled and all(r["retriable"] for r in stalled)
            assert wd.fired is not None and wd.fired["event"] == "engine_stall"
            assert eng.stall_total == 1 and eng.error_total == 0
            assert "Thread" in (tmp_path / "stacks.txt").read_text()
            (tmp_path / "stacks.txt").unlink()
            assert "automodel_serve_engine_stalls_total 1" in eng.metrics.registry.render()
            assert eng.pool.available() == eng.pool.usable_blocks
            _serves_after(eng)
        finally:
            eng.stop_watchdog()
            fi.activate(None)
    assert results["torch"] == results["jax"] and set(results["torch"]) <= {"stop", "length", "engine_stall"}
    for recs in (jr, tr):
        events = [r for r in recs if r.get("event") == "serve_engine_event"]
        assert [e["reason"] for e in events] == ["engine_stall"]
    assert te.pool_bytes == je.pool_bytes


def test_chaos_engine_exception_rebuilds_and_recovers(models, tmp_path):
    """A program that raises mid-wave: on both engines only the in-flight
    wave ends ``engine_error``, every block comes back, the prefix cache
    resets, the error counter and its metric read 1, and the next requests
    serve."""
    je, te, jr, tr = _chaos_pair(models, tmp_path, watchdog={"enabled": False})
    results = {}
    for name, eng in (("jax", je), ("torch", te)):
        arm = ((lambda e: fi.activate({"serve_exception_at_step": e._step_counter + 1})) if name == "jax"
               else (lambda e: _port_fault(e, "raise")))
        by_id = _drive(eng, arm)
        fi.activate(None)
        results[name] = sorted((rid, r["completion_reason"]) for rid, r in by_id.items()
                               if r["completion_reason"] == "engine_error")
        assert results[name] and all(by_id[rid]["retriable"] for rid, _ in results[name])
        assert eng.error_total == 1 and eng.stall_total == 0
        assert "automodel_serve_engine_errors_total 1" in eng.metrics.registry.render()
        assert eng.pool.available() == eng.pool.usable_blocks
        _serves_after(eng)
    assert results["torch"] == results["jax"]


def test_consecutive_rebuilds_past_the_budget_raise(models):
    _, te, _, _ = _pair(models)
    te.submit([1, 2, 3])
    te._decode = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("always fails"))
    with pytest.raises(RuntimeError, match="always fails"):
        for _ in range(te.MAX_CONSECUTIVE_REBUILDS + 2):
            te.submit([1, 2, 3])
            te.step()
    assert te.error_total == te.MAX_CONSECUTIVE_REBUILDS


def test_warmup_raises_where_jax_only_logs(models):
    """The port's warm-up raises when its request fails (JAX's logs a
    warning), so a broken program never reaches the front."""
    _, te, _, _ = _pair(models)
    te._decode = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("broken kernel"))
    with pytest.raises(RuntimeError, match="warm-up"):
        tsrv._warmup(te)


# -- the serve CLI as a process -------------------------------------------------------


def _readline(pipe, timeout: float) -> str:
    box = []
    t = threading.Thread(target=lambda: box.append(pipe.readline()), daemon=True)
    t.start()
    t.join(timeout)
    assert box and box[0], "no line from the server within the timeout"
    return box[0]


def test_serve_stdin_sigterm_drain_subprocess(tmp_path):
    """SIGTERM mid-workload: in-flight requests complete, queued ones end
    ``draining`` (retriable), the process exits 0 within the grace, and the
    metrics JSONL holds one record for every request."""
    metrics = tmp_path / "serve_metrics.jsonl"
    cfg = {
        "seed": 0, "device": "cpu",
        "model": {"hf_config": {
            "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 64, "hidden_size": 32,
            "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 8, "max_position_embeddings": 128,
        }, "backend": {"attn": "sdpa", "param_dtype": "float32", "compute_dtype": "float32"}},
        "generation": {"max_new_tokens": 48, "greedy": True},
        "serving": {"slots": 1, "block_size": 4, "num_blocks": 64, "prefill_chunk": 4, "max_seq_len": 64,
                    "drain": {"grace_s": 45.0}},
        "logging": {"metrics_path": str(metrics)},
    }
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text(json.dumps(cfg))  # JSON is valid YAML
    proc = subprocess.Popen(
        [sys.executable, "-m", "automodel_tpu_torch.cli.app", "serve", "-c", str(cfg_path)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
    )
    ids = [f"r{i}" for i in range(6)]
    try:
        for i, rid in enumerate(ids):
            proc.stdin.write(json.dumps({"id": rid, "prompt_ids": [1 + i, 2 + i, 3]}) + "\n")
        proc.stdin.flush()  # stdin stays open: the server keeps listening
        first = json.loads(_readline(proc.stdout, 60))
        assert first["request_id"] == "r0" and first["completion_reason"] == "length"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    seen = {"r0": first} | {r["request_id"]: r for r in lines if "request_id" in r}
    assert sorted(seen) == ids, err[-2000:]
    reasons = {rid: seen[rid]["completion_reason"] for rid in ids}
    done = [r for r in ids if reasons[r] == "length"]
    rejected = [r for r in ids if reasons[r] == "draining"]
    assert sorted(done + rejected) == ids and done and rejected, reasons
    assert all(seen[r]["retriable"] for r in rejected)
    logged = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert sorted(r["request_id"] for r in logged if r.get("event") == "serve_request") == ids


@pytest.mark.parametrize("env,want", [({}, 0), ({"SLURM_JOB_ID": "4242"}, 75)], ids=["plain", "slurm"])
def test_serve_http_cli_answers_then_drains_on_sigterm(tmp_path, env, want):
    """``serve -c serve_tiny_cpu_front.yaml --serving.http.port=0`` answers
    /generate, /stats and /metrics; SIGTERM drains it, exit 0 (75 under a
    slurm job id)."""
    run_env = {k: v for k, v in os.environ.items() if k not in ("SLURM_JOB_ID", "KUBERNETES_SERVICE_HOST")}
    run_env.update(env)
    proc = subprocess.Popen(
        [sys.executable, "-m", "automodel_tpu_torch.cli.app", "serve", "-c", FRONT_CFG, "--serving.http.port=0",
         f"--logging.metrics_path={tmp_path / 'm.jsonl'}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=run_env,
    )
    try:
        listening = json.loads(_readline(proc.stdout, 60))
        assert listening["event"] == "serve_listening"
        port = listening["port"]
        code, body, _ = _http(port, "/generate", {"prompt_ids": [1, 2, 3, 4, 5], "max_new_tokens": 3, "tenant": "a"})
        assert code == 200 and len(body["completion"].split()) == 3 and body["tier"] == "interactive"
        code, stats, _ = _http(port, "/stats")
        assert code == 200 and stats["completed_total"] == 2 and stats["spill_entries"] == 0  # the warm-up too
        code, text, _ = _http(port, "/metrics")
        assert code == 200 and "automodel_serve_requests_completed_total 2" in text
        assert _http(port, "/readyz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == want, err[-2000:]
    assert "serving drain complete" in err


def test_chip_smoke_carries_the_committed_front_config():
    """chip_smoke.py's phase 21 builds from serve_llama3_8b_front.yaml as a
    dict (the card has no YAML reader)."""
    import importlib.util

    from automodel_tpu_torch.config.loader import load_yaml_config

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_llama3_8b_front.yaml"))
    assert chip_smoke.SERVE_LLAMA3_8B_FRONT == cfg.to_dict()
    serve = teng.ServeConfig.from_dict(cfg.to_dict()["serving"])
    assert serve.kv_spill.enabled and serve.qos.enabled and not serve.speculative.enabled
