"""The port's profiling pillar against the JAX package's
(``tests/test_profiling.py``): the cost counter's FLOPs equal JAX's jaxpr
walker on a dense and a dense-experts MoE train step, each kernel wrapper's
count equals ``FlopCounterMode`` over its plain version, ``attn: flash``
counts what ``sdpa`` counts, the roofline and measured MFU, the trace
analyzer on a torch Chrome trace, the triggered capture, the strict
config, the ``profile`` command, and the training metrics port against
JAX's exposition."""

import gzip
import json
import os
import re
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from automodel_tpu_torch.telemetry.profiling import (
    CostCounter,
    ProfilingConfig,
    RooflineConfig,
    TriggeredCapture,
    TriggeredCaptureConfig,
    analyze_trace,
    count_cost,
    load_trace_events,
    mfu_measured_pct,
    roofline,
)
from torch_port_parity import jax_tiny, torch_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0)


def _batch(vocab=128, seed=3, accum=2):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=vocab, seq_length=16, num_samples=8, seed=seed)
    group = [default_collater([ds[2 * a], ds[2 * a + 1]]) for a in range(accum)]
    return {k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)}


def _jax_cost(jmodel, params, batch, loss="masked_ce"):
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.telemetry.profiling import program_cost
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss

    jopt = jax_optimizer(**OPT)
    state = JaxState.create(params, jax.jit(jopt.init)(params))
    fn = jax_step(jax_loss(jmodel, loss=loss), jopt, donate=False)
    return program_cost(fn, state, {k: jnp.asarray(v) for k, v in batch.items()})


def _port_cost(tmodel, batch, loss="masked_ce"):
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    params = list(tmodel.parameters())
    state = TrainState(params=params, optimizer=build_optimizer(params, **OPT))
    fn = build_train_step(make_causal_lm_loss(tmodel, loss=loss))
    return count_cost(fn, state, {k: torch.from_numpy(v) for k, v in batch.items()})[1]


def test_cost_counter_matches_jax_walker_dense():
    """A tiny Llama step (sdpa, masked_ce, 2 microbatches): the counted
    ``flops`` and ``dot_flops`` equal JAX's walker to 1e-6; under ``attn:
    flash`` (the kernels' plain versions on the CPU, each counted as the
    plain attention's work) the count is the same."""
    model, params, _ = jax_tiny(seed=0)
    batch = _batch()
    jc = _jax_cost(model, params, batch)
    tc = _port_cost(torch_twin(params, trainable=True).model, batch)
    np.testing.assert_allclose(tc.flops, jc.flops, rtol=1e-6)
    np.testing.assert_allclose(tc.dot_flops, jc.dot_flops, rtol=1e-6)
    assert tc.conv_flops == jc.conv_flops == 0 and "hlo_flops" not in tc.to_dict()
    flash = _port_cost(torch_twin(params, attn="flash", trainable=True).model, batch)
    assert flash.flops == tc.flops and flash.dot_flops == tc.dot_flops


def test_cost_counter_matches_jax_walker_moe_dense_experts():
    """A tiny Qwen3-MoE step with ``experts: dense``: the same FLOPs as
    JAX's walker to 1e-6."""
    from automodel_tpu.models.common.config import BackendConfig as JaxBackend
    from automodel_tpu.models.qwen3_moe import MoEForCausalLM as JaxMoE
    from automodel_tpu.models.qwen3_moe import MoETransformerConfig as JaxMoEConfig
    from automodel_tpu_torch.models.common.config import BackendConfig
    from automodel_tpu_torch.models.qwen3_moe import MoEForCausalLM, MoETransformerConfig, params_from_jax

    hf = dict(architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe", vocab_size=128, hidden_size=64,
              intermediate_size=128, moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, num_experts=8, num_experts_per_tok=2, norm_topk_prob=True,
              max_position_embeddings=256, tie_word_embeddings=False, router_aux_loss_coef=0.001)
    kw = dict(attn="sdpa", experts="dense", param_dtype="float32", compute_dtype="float32")
    jmodel = JaxMoE(JaxMoEConfig.from_hf(hf), JaxBackend(**kw))
    params = jmodel.init(jax.random.key(0))
    tmodel = MoEForCausalLM(MoETransformerConfig.from_hf(hf), BackendConfig(**kw), device=torch.device("cpu"),
                            trainable=True)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    batch = _batch()
    jc, tc = _jax_cost(jmodel, params, batch), _port_cost(tmodel, batch)
    np.testing.assert_allclose(tc.flops, jc.flops, rtol=1e-6)
    np.testing.assert_allclose(tc.dot_flops, jc.dot_flops, rtol=1e-6)


def _plain_flops(fn, *args, **kwargs) -> float:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return float(fc.get_total_flops())


def _counted(fn, *args, **kwargs) -> float:
    with CostCounter() as c:
        fn(*args, **kwargs)
    return c.cost.flops


def _k1():
    g = torch.Generator().manual_seed(0)
    B, Sq, Sk, N, Nkv, H = 2, 24, 24, 4, 2, 16
    q = torch.randn(B, Sq, N, H, generator=g)
    k, v = torch.randn(B, Sk, Nkv, H, generator=g), torch.randn(B, Sk, Nkv, H, generator=g)
    pos = torch.arange(Sq, dtype=torch.int32)
    kw = dict(causal=True, window=None, scale=H ** -0.5)
    return q, k, v, pos, kw


def test_k1_counts_equal_flop_counter_over_the_plain_attention():
    """K1: the forward wrapper counts what FlopCounterMode counts over its
    plain version (QKᵀ and PV, the full rectangle); forward, dq and dkv
    together count the plain forward plus autograd's backward of it (its
    four gradient products), which is what ``sdpa`` costs."""
    from automodel_tpu_torch.ops import ring_flash as rf

    q, k, v, pos, kw = _k1()
    assert _counted(rf.flash_block_fwd, q, k, v, pos, pos, None, None, **kw) == _plain_flops(
        rf._flash_fwd_plain, q, k, v, pos, pos, None, None, **kw)
    out, lse = rf._flash_fwd_plain(q, k, v, pos, pos, None, None, **kw)
    do = torch.randn_like(out)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    with CostCounter() as c:
        rf.flash_block_fwd(q, k, v, pos, pos, None, None, **kw)
        rf.flash_block_dq(q, k, v, do, lse, delta, pos, pos, None, None, **kw)
        rf.flash_block_dkv(q, k, v, do, lse, delta, pos, pos, None, None, **kw)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        o, _ = rf._flash_fwd_plain(qg, kg, vg, pos, pos, None, None, **kw)
        (o * do).sum().backward()

    assert c.cost.flops == _plain_flops(fwd_bwd) and c.cost.dot_ops == 3


@pytest.mark.parametrize("kernel", ["gmm", "gmm_t", "tgmm", "fwd", "bwd_gu", "bwd_dwd", "bwd_dx", "bwd_act",
                                    "paged_attend"])
def test_kernel_wrapper_count_equals_flop_counter_over_plain(kernel):
    """K2, K3 and K4: each wrapper's count (its CPU path runs the plain
    version, hidden from the counter) equals FlopCounterMode over the plain
    version at the same shapes, padding rows past the groups excluded."""
    from automodel_tpu_torch.ops import fused_expert_mlp as fm
    from automodel_tpu_torch.ops import grouped_matmul as gm
    from automodel_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(1)
    M, K, N, G, I = 40, 16, 24, 4, 8
    gs = torch.tensor([10, 0, 17, 9], dtype=torch.int32)  # 36 of 40 rows
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    cases = {
        "gmm": (gm.gmm, gm._gmm_plain, (r(M, K), r(G, K, N), gs)),
        "gmm_t": (gm.gmm, gm._gmm_plain, (r(M, K), r(G, N, K), gs, True)),
        "tgmm": (gm.tgmm, gm._tgmm_plain, (r(M, K), r(M, N), gs)),
        "fwd": (fm.fwd, fm._fwd_plain, (r(M, K), r(G, K, 2 * I), r(G, I, K), gs)),
        "bwd_gu": (fm.bwd_gu, fm._bwd_gu_plain, (r(M, K), r(M, 2 * I), r(M, I), gs)),
        "bwd_dwd": (fm.bwd_dwd, fm._bwd_dwd_plain, (r(M, 2 * I), r(M, K), gs)),
        "bwd_dx": (fm.bwd_dx, fm._bwd_dx_plain, (r(M, 2 * I), r(M, I), r(G, K, 2 * I), gs)),
        "bwd_act": (fm.bwd_act, fm._bwd_act_plain, (r(M, 2 * I), r(M, I), gs)),
    }
    if kernel == "paged_attend":
        q = r(2, 3, 4, 16)
        pool_k, pool_v = r(12, 16, 2, 16), r(12, 16, 2, 16)
        tables = torch.tensor([[0, 3, 5], [1, 2, 7]], dtype=torch.int32)
        lengths = torch.tensor([20, 33], dtype=torch.int32)
        wrapper, plain, args = pa.paged_attend, pa.paged_attend_plain, (q, pool_k, pool_v, tables, lengths)
    else:
        wrapper, plain, args = cases[kernel]
    assert _counted(wrapper, *args) == _plain_flops(plain, *args)


def test_roofline_classification_and_measured_mfu_match_jax():
    from automodel_tpu.telemetry.profiling import cost as jcost

    a = torch.ones(64, 64)
    _, cost = count_cost(lambda: (a @ a).sum())
    jc = jcost.ProgramCost(**{k: v for k, v in cost.to_dict().items()})
    for basis in ((1.0, 1e-6), (1e-6, 1000.0), (2.0, 3.0)):
        got = roofline(cost, RooflineConfig(*basis))
        assert got == jcost.roofline(jc, jcost.RooflineConfig(*basis))
    assert roofline(cost, RooflineConfig(peak_tflops=1.0, hbm_gbps=1e-6))["roofline_class"] == "memory_bound"
    assert roofline(cost, RooflineConfig())["roofline_class"] == "unknown"  # the CPU: no table entry
    assert mfu_measured_pct(1e12, 1.0, 1, RooflineConfig(peak_tflops=1.0)) == pytest.approx(100.0)
    assert mfu_measured_pct(1e12, 0.0, 1, RooflineConfig(peak_tflops=1.0)) is None


# a miniature torch.profiler Chrome trace of one step on the card: host ops
# on the python thread, kernels and a copy on stream 7, one record_function
# scope and its device shadow
_FIXTURE = {"traceEvents": [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0, "dur": 30},
    {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1, "tid": 1, "ts": 5, "dur": 2},
    {"ph": "X", "cat": "user_annotation", "name": "layers/attn", "pid": 1, "tid": 1, "ts": 35, "dur": 80},
    {"ph": "X", "cat": "kernel", "name": "void flash_fwd_kernel<128, true>(Params)", "pid": 0, "tid": 7,
     "ts": 40, "dur": 50},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::flash_fwd_kernel<128, (bool)1>(Params)",
     "pid": 0, "tid": 7, "ts": 100, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32(ncclDevComm*)", "pid": 0, "tid": 7,
     "ts": 150, "dur": 20},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "pid": 0, "tid": 8,
     "ts": 10, "dur": 20},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "layers/attn", "pid": 0, "tid": 7, "ts": 40, "dur": 70},
    {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
]}


def test_trace_parse_fixture_decomposition_and_self_time():
    rep = analyze_trace(_FIXTURE["traceEvents"], top_k=5)
    assert rep["device"] == "gpu" and rep["kernel_events"] == rep["op_events"] == 4
    top = {o["name"]: o for o in rep["top_ops"]}
    assert top["flash_fwd_kernel"]["count"] == 2 and top["flash_fwd_kernel"]["self_s"] == pytest.approx(60e-6)
    assert top["ncclDevKernel_AllReduce_Sum_f32"]["category"] == "comm"
    assert rep["window_s"] == pytest.approx(170e-6)
    assert rep["device_busy_s"] == pytest.approx(100e-6)  # 10-30, 40-90, 100-110, 150-170
    assert rep["host_gap_s"] == pytest.approx(70e-6)
    assert rep["comm_s"] == pytest.approx(20e-6) and rep["compute_s"] == pytest.approx(80e-6)
    assert rep["host_gaps"][0]["gap_s"] == pytest.approx(40e-6)
    assert rep["scopes"][0]["scope"] == "layers/attn" and rep["scopes"][0]["self_s"] == pytest.approx(60e-6 * 2)
    assert "## Top ops" in __import__(
        "automodel_tpu_torch.telemetry.profiling.trace", fromlist=["render_markdown"]).render_markdown(rep)


def test_trace_load_accepts_gz_and_dir(tmp_path):
    raw = json.dumps(_FIXTURE).encode()
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "t.json").write_bytes(raw)
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "t.json.gz").write_bytes(gzip.compress(raw))
    for p in (tmp_path / "a" / "t.json", tmp_path / "a", tmp_path / "b"):
        assert len(load_trace_events(p)) == len(_FIXTURE["traceEvents"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_trace_events(tmp_path / "empty")


class _FakeTracer:
    def __init__(self, monkeypatch):
        from automodel_tpu_torch.utils import profiler as P

        self.started, self.stopped = [], 0

        def stop():
            self.stopped += 1
            return Path("trace.json")

        monkeypatch.setattr(P, "start_trace", lambda d, perfetto=True: self.started.append(d))
        monkeypatch.setattr(P, "stop_trace", stop)


def test_triggered_capture_arms_fires_and_bounds(tmp_path, monkeypatch):
    """JAX's schedule: the first interval is dropped, warmup seeds the EMA,
    a 10x step fires a 2-step capture with a memory record, the budget
    blocks the next spike and says so once."""
    tracer = _FakeTracer(monkeypatch)
    clock, events = [0.0], []
    cap = TriggeredCapture(
        TriggeredCaptureConfig(slow_step_factor=3.0, warmup_steps=2, capture_steps=2, max_captures=1,
                               capture_dir=str(tmp_path / "cap")),
        event_hook=events.append, now=lambda: clock[0],
    )

    def step(i, dt):
        clock[0] += dt
        cap.on_step(i)

    step(1, 0.0)
    step(2, 5.0)  # the first interval: dropped
    for i in range(3, 7):
        step(i, 0.1)
    assert not cap.active
    step(7, 1.0)
    assert cap.active and len(tracer.started) == 1
    step(8, 0.1)
    step(9, 0.1)
    assert not cap.active and tracer.stopped == 1
    rec = [e for e in events if e.get("capture_path")][-1]
    assert rec["event"] == "trace_capture" and rec["reason"] == "slow_step" and rec["factor"] >= 3.0
    assert Path(rec["memory_profile"]).exists()  # the CPU: the census
    step(10, 5.0)
    cap.trigger(11, "nonfinite")
    assert len(tracer.started) == 1
    assert len([e for e in events if "budget exhausted" in str(e.get("skipped", ""))]) == 1


def test_triggered_capture_nonfinite_trigger(tmp_path, monkeypatch):
    tracer = _FakeTracer(monkeypatch)
    events = []
    cap = TriggeredCapture(TriggeredCaptureConfig(capture_steps=1, capture_dir=str(tmp_path / "cap")),
                           event_hook=events.append)
    cap.trigger(4, "nonfinite")
    assert cap.active and len(tracer.started) == 1
    cap.on_step(5)
    assert not cap.active and tracer.stopped == 1 and events[-1]["reason"] == "nonfinite"


def test_manual_window_preempts_inflight_capture(tmp_path, monkeypatch):
    from automodel_tpu_torch.telemetry import Telemetry, TelemetryConfig

    tracer = _FakeTracer(monkeypatch)
    tel = Telemetry(TelemetryConfig(flight_recorder_steps=0, compile_events=False,
                                    profile={"enabled": True, "start_step": 4, "end_step": 6,
                                             "trace_dir": str(tmp_path / "manual")}))
    events = []
    tel.attach_profiling(ProfilingConfig(triggered={"capture_steps": 5}), capture_dir=str(tmp_path / "cap"),
                         event_hook=events.append)
    tel.on_step(1)
    tel.trigger_capture(2, "nonfinite")
    assert tel.triggered.active and len(tracer.started) == 1
    tel.on_step(3)
    tel.on_step(4)  # the manual window's start: the capture closes first
    assert not tel.triggered.active and tel.profiler.active and tracer.stopped == 1
    assert tracer.started[-1] == str(tmp_path / "manual")
    assert [e["reason"] for e in events if e.get("capture_path")] == ["nonfinite"]


def test_profiling_config_rejects_unknown_keys_as_jax():
    from automodel_tpu.telemetry.profiling import ProfilingConfig as JaxProfilingConfig
    from automodel_tpu_torch.telemetry.prometheus import MetricsServerConfig

    for cls in (ProfilingConfig, JaxProfilingConfig):
        with pytest.raises(TypeError, match="unknown profiling"):
            cls.from_dict({"tracee_steps": 3})
    assert ProfilingConfig.from_dict(None) == ProfilingConfig() and ProfilingConfig().enabled
    assert [f.name for f in __import__("dataclasses").fields(ProfilingConfig)] == [
        f.name for f in __import__("dataclasses").fields(JaxProfilingConfig)]
    with pytest.raises(TypeError, match="unknown metrics_server"):
        MetricsServerConfig.from_dict({"prot": 1})


def _families_and_samples(body: str) -> tuple[dict, dict]:
    types, samples = {}, {}
    for line in body.splitlines():
        m = re.match(r"# TYPE (\S+) (\S+)", line)
        if m:
            types[m.group(1)] = m.group(2)
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    return types, samples


def test_train_exporter_exposition_matches_jax():
    """The same log records, goodput snapshot and events through both
    exporters: the same ``automodel_train_*`` families (23) and samples."""
    from automodel_tpu.telemetry.prometheus import TrainMetricsExporter as JaxExporter
    from automodel_tpu_torch.telemetry.prometheus import TrainMetricsExporter

    recs = [{"step": 7, "loss": 2.5, "tps": 1000.0, "step_time_s": 0.1, "mfu_pct": 12.5, "mfu_measured_pct": 13.0,
             "skipped_steps_total": 2, "recompiles": 1, "heartbeat_age_s": 0.01, "ckpt_save_s": 1.5,
             "mem_bytes_in_use": 1e9},
            {"step": 8, "loss": 2.4, "recompiles": 2, "ckpt_drain_s": 0.3, "rollbacks_total": 1}]
    snap = {"goodput_fraction": 0.9, "segments": {"step": 9.0, "startup": 1.0}}
    bodies = []
    for cls in (JaxExporter, TrainMetricsExporter):
        ex = cls()
        for r in recs:
            ex.update(r)
        ex.update_goodput(snap)
        for e in ("hang", "nonfinite_step", "trace_capture", "desync", "not_a_known_event"):
            ex.event(e)
        bodies.append(_families_and_samples(ex.registry.render()))
    assert bodies[0] == bodies[1]
    assert len([f for f in bodies[1][0] if f.startswith("automodel_train_")]) == 23


def test_profile_cli_train_mode_on_cpu(tmp_path, capsys):
    """``profile`` on the tiny config (device cpu): one profile_report line;
    report.json with cpu ops (no kernel events off the card), the counted
    ``cost.train_step`` and PROFILE.md beside it."""
    from automodel_tpu_torch.cli import app

    cfg = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")
    rc = app.main(["profile", "-c", cfg, "--device=cpu", f"--output_dir={tmp_path}",
                   "--profiling.trace_warmup_steps=1", "--profiling.trace_steps=1", "--profiling.peak_tflops=0.5",
                   f"--logging.metrics_path={tmp_path / 'm.jsonl'}"])
    assert rc == 0
    line = json.loads([s for s in capsys.readouterr().out.splitlines() if "profile_report" in s][-1])
    rep = json.loads(Path(line["report_json"]).read_text())
    assert rep["device"] == "cpu" and rep["kernel_events"] == 0 and rep["op_events"] > 0
    assert rep["cost"]["train_step"]["flops"] > 0 and rep["run_metrics"]["mfu_measured_pct"] > 0
    assert Path(line["report_md"]).read_text().startswith("# PROFILE (train)")


def test_metrics_server_serves_the_train_families(tmp_path):
    """A training run with ``metrics_server: {port: 0}``: a scrape taken at a
    log record shows the ``automodel_train_*`` families at that step."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml"))
    for k, v in (("device", "cpu"), ("step_scheduler.max_steps", 3), ("output_dir", str(tmp_path)),
                 ("logging.metrics_path", str(tmp_path / "m.jsonl")), ("metrics_server", {"port": 0})):
        cfg.set_by_path(k, v)
    r = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    r.setup()
    port = r._prom_server.server_address[1]
    scraped = []
    orig = r._prom.update_goodput

    def update_goodput(snapshot):  # the last fold of a log record
        orig(snapshot)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
            scraped.append(resp.read().decode())

    r._prom.update_goodput = update_goodput
    r.run_train_validation_loop()
    assert len(scraped) == 3
    types, samples = _families_and_samples(scraped[-1])
    assert samples["automodel_train_step"] == 3.0
    assert "automodel_train_goodput_fraction" in types and "automodel_train_heartbeat_age_seconds" in types


def test_profile_cli_generate_mode_counts_the_products(tmp_path, capsys):
    """``profile --profiling.mode=generate``: the first ``generate_ids`` call
    counted (the linear and einsum products that inference mode hands the
    counter whole), the second traced."""
    from automodel_tpu_torch.cli import app

    cfg = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu.yaml")
    assert app.main(["profile", "-c", cfg, "--device=cpu", f"--output_dir={tmp_path}",
                     "--profiling.mode=generate"]) == 0
    rep = json.loads((tmp_path / "profile" / "report.json").read_text())
    cost = rep["cost"]["generate_ids"]
    assert rep["mode"] == "generate" and rep["op_events"] > 0 and cost["flops"] > 0 and cost["dot_ops"] > 0
    assert rep["run_metrics"]["gen_tokens"] > 0
