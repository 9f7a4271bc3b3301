"""The port's telemetry against the JAX package's (``tests/test_telemetry.py``):
the anomaly flags and their ``nonfinite`` rule (an element count, never the
norm's finiteness), the per-group grad norms, build events, the step
profiler window, the memory census cadence, the facade's cost and its
inert mode, the crash flight recorder, and the record and event key sets
of a whole run beside JAX's recipe on the same YAML."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu_torch.telemetry import Telemetry, TelemetryConfig, build_fingerprint
from torch_port_parity import jax_tiny, torch_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_TINY = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0)


def _batch(seed=3, vocab=128):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=vocab, seq_length=16, num_samples=8, seed=seed)
    group = [default_collater([ds[0], ds[1]])]
    return {k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)}


def _both_steps(scale: float, on_nonfinite: str = "raise"):
    """The tiny Llama's train step in both packages on the same weights,
    the loss sum scaled by ``scale`` → (jax step fn, jax state, port step
    fn, port state, port model)."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.telemetry.anomaly import jax_groups
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    model, params, _ = jax_tiny(seed=1)
    jbase = jax_loss(model, loss="masked_ce")

    def jloss(p, mb):
        loss_sum, n = jbase(p, mb)
        return loss_sum * scale, n

    jopt = jax_optimizer(**OPT)
    jstate = JaxState.create(params, jax.jit(jopt.init)(params))
    jfn = jax_step(jloss, jopt, donate=False, on_nonfinite=on_nonfinite)

    tmodel = torch_twin(params, trainable=True).model
    named = list(tmodel.named_parameters())
    tparams = [p for _, p in named]
    tbase = make_causal_lm_loss(tmodel, loss="masked_ce")

    def tloss(mb):
        loss_sum, n = tbase(mb)
        return loss_sum * scale, n

    tstate = TrainState(params=tparams, optimizer=build_optimizer(tparams, **OPT))
    tfn = build_train_step(tloss, on_nonfinite=on_nonfinite, groups=jax_groups(tmodel, [n for n, _ in named]))
    return jfn, jstate, tfn, tstate, tmodel


@pytest.mark.parametrize("on_nonfinite", ["raise", "skip"])
def test_nonfinite_is_an_element_count_not_the_norm(on_nonfinite):
    """The loss scaled by 1e20: grad elements near 1e20, all finite, and the
    fp32 sum of squares overflows to inf. JAX's flag counts elements, so the
    step is finite there; the port's is too (it used to read the norm and
    call the step non-finite). Under ``skip`` both apply the update. Loss,
    grad norm and the params after the step are held to JAX's."""
    from automodel_tpu_torch.models.llama import params_from_jax

    jfn, jstate, tfn, tstate, tmodel = _both_steps(1e20, on_nonfinite)
    batch = _batch()
    jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    jm = jax.device_get(jm)
    assert not bool(jm["nonfinite"]) and not bool(tm["nonfinite"])
    assert int(jm["grad_nonfinite_count"]) == int(tm["grad_nonfinite_count"]) == 0
    assert np.isinf(float(jm["grad_norm"])) and np.isinf(float(tm["grad_norm"]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    if on_nonfinite == "skip":
        assert tm["skipped"] is False and not bool(jm["skipped"])
    want = params_from_jax(jax.device_get(jstate.params))
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)


def test_group_norms_and_keys_match_jax():
    """One ordinary step: ``grad_norm/<group>`` keys (the JAX param tree's
    first path component) and values equal JAX's (fp32 rtol 1e-5)."""
    jfn, jstate, tfn, tstate, _ = _both_steps(1.0)
    batch = _batch(seed=5)
    _, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    jm = jax.device_get(jm)
    jkeys = sorted(k for k in jm if k.startswith("grad_norm/"))
    assert jkeys == sorted(k for k in tm if k.startswith("grad_norm/")) == [
        "grad_norm/embed", "grad_norm/final_norm", "grad_norm/layers", "grad_norm/lm_head"]
    for k in jkeys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert not bool(tm["nonfinite"]) and int(tm["grad_nonfinite_count"]) == 0


def test_planted_nan_flags_that_step_and_names_the_group():
    """A NaN in one tensor's grads: the flag and the count fire in that step,
    only that tensor's group norm goes non-finite, and the record survives
    the logger as strict JSON (JAX ``test_planted_nan_flags_that_step``)."""
    from automodel_tpu_torch.telemetry.anomaly import anomaly_metrics

    grads = [torch.ones(4), torch.tensor([1.0, float("nan"), 1.0]), torch.ones(2, 2)]
    norms = [torch.linalg.vector_norm(g) for g in grads]
    m = anomaly_metrics(torch.tensor(3.0), grads, norms, ["a", "b", "a"])
    assert bool(m["nonfinite"]) and int(m["grad_nonfinite_count"]) == 1
    assert np.isfinite(float(m["grad_norm/a"])) and not np.isfinite(float(m["grad_norm/b"]))
    np.testing.assert_allclose(float(m["grad_norm/a"]), np.sqrt(8.0), rtol=1e-6)


def test_anomaly_flags_can_be_disabled():
    from automodel_tpu_torch.training.train_step import build_train_step

    w = torch.nn.Parameter(torch.ones(3))
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.optim.builders import build_optimizer

    state = TrainState(params=[w], optimizer=build_optimizer([w], name="sgd", lr=0.1))
    step = build_train_step(lambda mb: ((w * mb["input_ids"].float()).sum(), torch.tensor(3)), anomaly_flags=False)
    m = step(state, {"input_ids": torch.ones(1, 3, dtype=torch.int64)})
    assert "nonfinite" not in m and "grad_nonfinite_count" not in m
    # the skip policy still needs the flag (JAX :203-209)
    step = build_train_step(lambda mb: ((w * mb["input_ids"].float()).sum(), torch.tensor(3)),
                            anomaly_flags=False, on_nonfinite="skip")
    m = step(state, {"input_ids": torch.ones(1, 3, dtype=torch.int64)})
    assert "nonfinite" in m and "grad_norm/params" not in m


def test_build_bridge_counts_builds_by_cursor():
    """Builds and loads reported by the kernel builders drain by cursor, as
    JAX's compile events do: a build counts one, a load adds seconds only,
    a second consumer sees nothing older than itself."""
    from automodel_tpu_torch.telemetry import compile_events
    from automodel_tpu_torch.telemetry.compile_events import CompileEventBridge

    bridge = CompileEventBridge()
    compile_events.record(0.25, built=True)
    compile_events.record(0.05, built=False)
    d = bridge.drain()
    assert d["compiles"] == 1 and d["compile_secs"] == pytest.approx(0.3)
    assert bridge.drain() == {"compiles": 0, "compile_secs": 0.0}
    assert CompileEventBridge().drain()["compiles"] == 0


def test_step_profiler_opens_mid_window_on_resume(monkeypatch, tmp_path):
    """JAX's window rule (a resumed run past start_step traces the rest of
    its window), and the port's warmup: a run that reaches the step before
    the window enables the trace there and records from start_step."""
    from automodel_tpu_torch.utils import profiler as P

    calls = []
    monkeypatch.setattr(P, "start_trace", lambda d, perfetto=True, warmup=False: calls.append(("start", warmup)))
    monkeypatch.setattr(P, "step_trace", lambda: calls.append("record"))
    monkeypatch.setattr(P, "stop_trace", lambda: calls.append("stop") or tmp_path / "t.json")
    prof = P.StepProfiler(P.ProfilerConfig(enabled=True, start_step=3, end_step=6, trace_dir=str(tmp_path)))
    prof.on_step(4)  # a resumed run first sees step 4 (> start_step)
    assert calls == [("start", False)]
    prof.on_step(5)
    prof.on_step(6)
    prof.on_step(7)
    assert calls == [("start", False), "stop"]
    calls.clear()
    prof = P.StepProfiler(P.ProfilerConfig(enabled=True, start_step=3, end_step=5, trace_dir=str(tmp_path)))
    for step in range(1, 7):
        prof.on_step(step)
        assert prof.active == (2 <= step < 5)
    assert calls == [("start", True), "record", "stop"]


def test_step_profiler_writes_a_chrome_trace(tmp_path):
    """A real window on the CPU, warmed up over the step before: one gzip'd
    Chrome trace under trace_dir that the analyzer reads (cpu ops, no
    kernel events here)."""
    from automodel_tpu_torch.telemetry.profiling.trace import analyze_trace, load_trace_events
    from automodel_tpu_torch.utils.profiler import ProfilerConfig, StepProfiler

    prof = StepProfiler(ProfilerConfig(enabled=True, start_step=2, end_step=3, trace_dir=str(tmp_path)))
    prof.on_step(1)  # warms up
    prof.on_step(2)
    x = torch.randn(64, 64)
    for _ in range(3):
        x = torch.tanh(x @ x)
    prof.on_step(3)
    assert prof.trace_path.name.endswith(".json.gz") and prof.trace_path.parent == tmp_path
    report = analyze_trace(load_trace_events(tmp_path))
    assert report["device"] == "cpu" and report["kernel_events"] == 0 and report["op_events"] > 0
    assert any(o["name"].startswith("aten::") for o in report["top_ops"])


def test_memory_census_cadence(monkeypatch, tmp_path):
    import automodel_tpu_torch.telemetry as tel_mod

    calls = {"n": 0}
    real = tel_mod.memory_telemetry.memory_snapshot
    monkeypatch.setattr(tel_mod.memory_telemetry, "memory_snapshot",
                        lambda k, d=None: calls.__setitem__("n", calls["n"] + 1) or real(k, d))
    tel = Telemetry(TelemetryConfig(memory_every_steps=10, flight_recorder_path=str(tmp_path / "fr.json")))
    logged = []
    for step in range(1, 103):
        tel.on_step(step)
        if step % 3 == 0:
            logged.append(tel.enrich(step, {"loss": 1.0, "step": step}))
    assert calls["n"] == 10 and tel.memory_samples == 10
    assert len([m for m in logged if "mem_bytes_in_use" in m]) == 10


def test_telemetry_per_step_overhead_bounded(tmp_path):
    """JAX's bound: the per-step host work (two timer pairs, the hook, a
    ring append) under 50 us a step, best of 5 trials."""
    tel = Telemetry(TelemetryConfig(memory_every_steps=0, flight_recorder_path=str(tmp_path / "fr.json")))
    step, best = 0, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(200):
            step += 1
            tel.timers("data_wait").start()
            tel.timers("data_wait").stop()
            tel.timers("dispatch").start()
            tel.timers("dispatch").stop()
            tel.on_step(step)
            tel.record_step({"step": step, "tokens": 1024, "ts": 0.0})
        best = min(best, time.perf_counter() - t0)
    assert best / 200 < 50e-6, f"{best / 200 * 1e6:.1f} us a step"
    assert len(tel.flight_recorder.records) == tel.config.flight_recorder_steps


def test_telemetry_disabled_is_inert():
    tel = Telemetry(TelemetryConfig(enabled=False))
    assert tel.flight_recorder is None and tel.compile_bridge is None
    assert tel.enrich(50, {"loss": 1.0}) == {"loss": 1.0}
    with tel.crash_guard():
        pass


def test_flight_recorder_crash_dump(tmp_path):
    path = tmp_path / "fr.json"
    tel = Telemetry(TelemetryConfig(flight_recorder_steps=4, flight_recorder_path=str(path)),
                    fingerprint=build_fingerprint({"seed": 1}))
    with pytest.raises(RuntimeError, match="induced"):
        with tel.crash_guard():
            for i in range(10):
                tel.record_step({"step": i, "loss": float(i)})
            raise RuntimeError("induced failure")
    dump = json.loads(path.read_text())
    assert dump["reason"] == "RuntimeError" and "induced failure" in dump["exception"]["message"]
    assert [r["step"] for r in dump["records"]] == [6, 7, 8, 9]
    assert dump["fingerprint"]["config"] == {"seed": 1} and "census" in dump["memory"]


def _run_both(tmp_path, extra: dict | None = None):
    """sft_tiny_cpu.yaml through JAX's recipe (the suite's 8 CPU devices, a
    global batch of 8) and the port's (JAX's weights) → (jax records, port
    records), each run in its own output_dir."""
    from automodel_tpu.config.loader import load_yaml_config as jax_load
    from automodel_tpu.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    recipes = {}
    for name, load, cls in (("jax", jax_load, JaxRecipe), ("port", load_yaml_config,
                                                           TrainFinetuneRecipeForNextTokenPrediction)):
        cfg = load(SFT_TINY)
        for key, value in (("dataset._target_", "automodel_tpu.data.sft.MockSFTDataset"),
                           ("dataloader.global_batch_size", 8), ("step_scheduler.max_steps", 4),
                           ("output_dir", str(tmp_path / name)),
                           ("logging.metrics_path", str(tmp_path / name / "m.jsonl")),
                           *(extra or {}).items()):
            cfg.set_by_path(key, value)
        if name == "port":
            cfg.set_by_path("device", "cpu")
        recipes[name] = cls(cfg)
        recipes[name].setup()
    recipes["port"].model.load_state_dict(params_from_jax(jax.device_get(recipes["jax"].state.params)))
    for r in recipes.values():
        r.run_train_validation_loop()
    return {n: [json.loads(s) for s in (tmp_path / n / "m.jsonl").read_text().splitlines()] for n in recipes}


# keys a run may carry in one package and not the other, and why
KEYS_ALLOWED_TO_DIFFER = {
    "recompiles": "XLA recompiles (JAX's step 2 sharding fixpoint); the port builds no kernel on the CPU",
    "recompile_secs": "as above",
    "hlo_flops": "XLA's cost analysis of the lowered step: no counterpart in torch (cost.py)",
    "hlo_bytes": "as above",
}


def test_record_and_event_keys_match_jax(tmp_path):
    """No telemetry section: every step record carries JAX's keys
    (``grad_norm/<group>``, ``grad_nonfinite_count``, ``time/*_s``,
    ``heartbeat_age_s``, the attempt envelope, ...), each event record
    (``cost_attribution``) JAX's keys, beside goodput.jsonl; losses and
    grad norms agree (rtol 1e-4). ``report --strict`` accepts the file."""
    from automodel_tpu_torch.telemetry.report import main as report_main

    rows = _run_both(tmp_path)
    allowed = set(KEYS_ALLOWED_TO_DIFFER)
    for kind in ("step", "event"):
        j = [r for r in rows["jax"] if ("event" in r) == (kind == "event")]
        t = [r for r in rows["port"] if ("event" in r) == (kind == "event")]
        assert [r.get("event") for r in j] == [r.get("event") for r in t], kind
        for a, b in zip(j, t):
            assert set(a) - allowed == set(b) - allowed, (kind, set(a) ^ set(b))
    steps = {n: [r for r in rows[n] if "loss" in r] for n in rows}
    for a, b in zip(steps["jax"], steps["port"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-4)
        assert b["grad_nonfinite_count"] == 0 and b["nonfinite"] is False
    assert (tmp_path / "port" / "goodput.jsonl").exists() and (tmp_path / "jax" / "goodput.jsonl").exists()
    assert report_main([str(tmp_path / "port" / "m.jsonl"), "--strict"]) == 0


def test_every_section_off_is_bit_identical_and_inert(tmp_path):
    """Every new section off (``enabled: false``): no anomaly keys, no
    goodput file, no watchdog, no cost event; the losses and grad norms
    equal the all-on run's bit for bit (telemetry never changes the math).
    The bf16 twin of the full-depth config (remat full): a counter that
    changed an op's kernel (decomposing ``silu_backward``) moves its
    rounding there."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    out = {}
    for tag, sections in (("on", {}), ("off", {
        "telemetry": {"enabled": False}, "profiling": {"enabled": False},
        "distributed_guard": {"enabled": False}, "metrics_server": {"enabled": False},
        "fault_tolerance": {"enabled": False}})):
        cfg = load_yaml_config(SFT_TINY.replace("sft_tiny_cpu", "sft_tiny_cpu_full"))
        cfg.set_by_path("device", "cpu")
        cfg.set_by_path("step_scheduler.max_steps", 3)
        cfg.set_by_path("output_dir", str(tmp_path / tag))
        cfg.set_by_path("logging.metrics_path", str(tmp_path / tag / "m.jsonl"))
        for k, v in sections.items():
            cfg.set_by_path(k, v)
        r = TrainFinetuneRecipeForNextTokenPrediction(cfg)
        r.setup()
        if tag == "off":
            assert r.guard.watchdog is None and r.telemetry.flight_recorder is None and not r.ledger.enabled
        r.run_train_validation_loop()
        out[tag] = [json.loads(s) for s in (tmp_path / tag / "m.jsonl").read_text().splitlines()]
    on = [r for r in out["on"] if "loss" in r]
    off = [r for r in out["off"] if "loss" in r]
    assert [(r["loss"], r["grad_norm"]) for r in on] == [(r["loss"], r["grad_norm"]) for r in off]
    assert not any("event" in r for r in out["off"])
    assert not any(k.startswith(("grad_norm/", "time/")) or k in ("nonfinite", "heartbeat_age_s", "attempt_id")
                   for r in off for k in r)
    assert not (tmp_path / "off" / "goodput.jsonl").exists()


@pytest.mark.parametrize("section,key", [
    ("telemetry", "bogus"), ("profiling", "bogus"), ("distributed_guard", "bogus"),
    ("metrics_server", "bogus"), ("fault_tolerance", "bogus"), ("fault_injection", "bogus"),
])
def test_unknown_keys_raise_as_jax(section, key):
    """An unknown key in each new section raises JAX's ``TypeError`` before
    the model is built."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import check_sections

    cfg = load_yaml_config(SFT_TINY)
    cfg.set_by_path(f"{section}.{key}", 1)
    with pytest.raises(TypeError, match=key):
        check_sections(cfg)
