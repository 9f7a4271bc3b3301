"""The torch port's benchmark slice against the JAX package: the FLOP laws
and the peak (``utils/flops_utils.py``), the timers and the percentile,
the ``benchmark llm`` recipe through the CLI on the CPU (its result keys,
its loss on weights carried from JAX, its refusals), and the serving
engine's ``run_workload`` (``tests/test_benchmark.py``,
``tests/test_serving.py``).
"""

import json
import math
import os
import time

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.loader import ConfigNode as JConfigNode
from automodel_tpu.recipes.benchmark import BenchmarkingRecipeForNextTokenPrediction as JBench
from automodel_tpu.telemetry.report import percentile as jpercentile
from automodel_tpu.training.timers import Timers as JTimers
from automodel_tpu.utils import flops_utils as jflops
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.config.loader import load_yaml_config
from automodel_tpu_torch.telemetry.report import percentile
from automodel_tpu_torch.training.timers import Timers
from automodel_tpu_torch.utils import flops_utils as flops
from torch_port_parity import HF_TINY, jax_tiny, torch_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "automodel_tpu_torch", "configs")
REL = 1e-12

# the four families' card configs, each at its published widths and cut depth
CARD_CONFIGS = ("sft_llama3_8b.yaml", "pretrain_qwen3_moe_a3b.yaml", "pretrain_gpt_oss_20b.yaml",
                "pretrain_gemma2_9b.yaml")


def _configs(name: str):
    """(the port's model config, JAX's) for a committed card config, each
    through its own package's registry (the port's model on the meta
    device, so no weights are made)."""
    from automodel_tpu.models.common.config import BackendConfig as JBackend
    from automodel_tpu.models.registry import resolve_architecture as jresolve
    from automodel_tpu_torch.models.common.config import BackendConfig
    from automodel_tpu_torch.models.registry import resolve_architecture

    model = load_yaml_config(os.path.join(CONFIGS, name)).model
    hf, backend = model.hf_config.to_dict(), model.backend.to_dict()
    port = resolve_architecture(hf)(hf, BackendConfig.from_dict(backend), device="meta").config
    jmodel, _ = jresolve(hf)(hf, JBackend(**backend))
    return port, jmodel.config


@pytest.mark.parametrize("seq_len", [4096, 8192])
@pytest.mark.parametrize("name", CARD_CONFIGS)
def test_flops_per_token_of_the_card_configs_match_jax(name, seq_len):
    port, jcfg = _configs(name)
    got, want = flops.flops_per_token_for_config(port, seq_len), jflops.flops_per_token_for_config(jcfg, seq_len)
    assert got == pytest.approx(want, rel=REL) and got > 0


LAW_ARGS = [
    dict(hidden_size=4096, num_layers=32, intermediate_size=14336, vocab_size=128256, seq_len=1,
         num_heads=32, num_kv_heads=8, head_dim=128),
    dict(hidden_size=3584, num_layers=8, intermediate_size=14336, vocab_size=256000, seq_len=8192,
         num_heads=16, num_kv_heads=8, head_dim=256, num_gated_linear=2, causal=False),
]
MOE_ARGS = [
    dict(hidden_size=2048, num_layers=4, moe_intermediate_size=768, num_active_experts=8,
         shared_expert_intermediate=0, vocab_size=151936, seq_len=4096, num_heads=32, num_kv_heads=4, head_dim=128),
    dict(hidden_size=2880, num_layers=3, moe_intermediate_size=2880, num_active_experts=4,
         shared_expert_intermediate=512, vocab_size=201088, seq_len=4096, num_heads=64, num_kv_heads=8, head_dim=64,
         dense_intermediate_size=1024, num_dense_layers=1, layer_windows=[128, None, 128]),
    dict(hidden_size=64, num_layers=2, moe_intermediate_size=32, num_active_experts=2, shared_expert_intermediate=0,
         vocab_size=256, seq_len=64, num_heads=4, num_kv_heads=2, head_dim=16, causal=False),
]


@pytest.mark.parametrize("kw", LAW_ARGS)
def test_dense_law_matches_jax(kw):
    assert flops.dense_transformer_flops_per_token(**kw) == pytest.approx(
        jflops.dense_transformer_flops_per_token(**kw), rel=REL)


@pytest.mark.parametrize("kw", MOE_ARGS)
def test_moe_law_matches_jax(kw):
    assert flops.moe_transformer_flops_per_token(**kw) == pytest.approx(
        jflops.moe_transformer_flops_per_token(**kw), rel=REL)


@pytest.mark.parametrize("seq_len,window", [(4096, None), (4096, 128), (8192, 4096), (100, 200), (7, 7)])
def test_avg_attended_context_and_mfu_match_jax(seq_len, window):
    assert flops.avg_attended_context(seq_len, window) == pytest.approx(
        jflops.avg_attended_context(seq_len, window), rel=REL)
    args = (10_000.0 + seq_len, 6.2e9, 989.0)
    assert flops.calculate_mfu(*args) == pytest.approx(jflops.calculate_mfu(*args), rel=REL)


def test_device_peak_tflops_by_the_cards_name(monkeypatch):
    """989 for the H100 SXM's name, NaN for another card or the CPU."""
    names = {}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: names["now"])
    names["now"] = "NVIDIA H100 80GB HBM3"
    assert flops.device_peak_tflops("cuda") == 989.0 == flops.device_peak_tflops(torch.device("cuda", 0))
    for other in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"):
        names["now"] = other
        assert math.isnan(flops.device_peak_tflops("cuda:0"))
    assert math.isnan(flops.device_peak_tflops("cpu"))
    if not torch.cuda.is_available():
        assert math.isnan(flops.device_peak_tflops())


def test_timers_match_jax_under_one_clock(monkeypatch):
    """The same starts and stops under a monkeypatched clock give the same
    summary() and drain_means() in both packages."""
    clock = np.cumsum(np.random.default_rng(0).uniform(0.001, 0.1, size=400)).tolist()
    out = []
    for timers in (Timers(), JTimers()):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        for i in range(7):
            timers("step").start()
            timers("dispatch").start()
            timers("dispatch").stop()
            if i % 2:
                timers("device").start()
                timers("device").stop()
            timers("step").stop()
            if i == 3:
                mid = timers.drain_means()
        out.append((timers.summary(), timers.summary(skip_first=2), mid, timers.drain_means(), timers.drain_means()))
    port, ref = out
    assert port[0].keys() == ref[0].keys() == {"step", "dispatch", "device"}
    for a, b in zip(port, ref):
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert port[-1] == {}


def test_percentile_matches_jax():
    rng = np.random.default_rng(1)
    for n in (1, 2, 3, 10, 97):
        vals = rng.exponential(size=n).tolist()
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert percentile(vals, q) == jpercentile(vals, q)
    assert percentile([], 0.5) is None is jpercentile([], 0.5)
    with pytest.raises(ValueError):
        percentile([1.0], 1.5)


# -- benchmark llm on the CPU --------------------------------------------------

TINY_BENCH = dict(
    seed=3,
    model=dict(hf_config=HF_TINY, backend=dict(attn="sdpa", param_dtype="float32", compute_dtype="float32")),
    dataset=dict(_target_="automodel_tpu.data.sft.MockSFTDataset", vocab_size=128, seq_length=32, num_samples=64),
    dataloader=dict(global_batch_size=8),
    step_scheduler=dict(grad_acc_steps=2, max_steps=100),
    optimizer=dict(name="adamw", lr=1e-3),
    generation=dict(max_new_tokens=6, greedy=True, bench_batch=2, bench_prompt_len=10),
    serving=dict(slots=2, block_size=4, num_blocks=64, prefill_chunk=8, max_seq_len=64, decode_kernel="gather",
                 bench_requests=4, bench_rate=50.0, bench_prompt_len_min=4, bench_prompt_len_max=20,
                 bench_max_new_tokens=5),
    benchmark=dict(warmup_steps=1, measure_steps=2),
)
TINY_BASE = {k: v for k, v in TINY_BENCH.items() if k not in ("generation", "serving")}
# keys of JAX's result the port does not give, each with its reason
NOT_IN_PORT = {
    "recompiles_during_measure": "XLA compiles inside the window; the port does not compile",
    "recompile_secs": "as above",
    "cost": "program cost attribution: the profiling section is refused",
    "mfu_measured_pct": "as above",
}
# keys a leg adds only when it runs (JAX's result for a config without
# generation: and serving: sections lacks them)
RAN_LEG_KEYS = {"gen_tokens", "gen_cache_bytes", "serve_prefix_cache", "serve_queue_depth_peak",
                "serve_decode_backend", "serve_kv_cache_dtype"}


def _yaml(tmp_path, cfg: dict) -> str:
    import yaml

    path = tmp_path / "bench.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _port_cli(tmp_path, cfg: dict, *extra):
    out = tmp_path / "bench.json"
    rc = app.main(["benchmark", "llm", "-c", _yaml(tmp_path, cfg), "--device=cpu",
                   f"--benchmark.output_json={out}", f"--logging.metrics_path={tmp_path / 'm.jsonl'}", *extra])
    return rc, json.loads(out.read_text())


def _check_result(res: dict, measure: int) -> None:
    assert res["timers"]["step"]["count"] == measure
    assert res["tokens_per_second"] > 0 and res["n_chips"] == 1
    assert res["mfu"] is None  # no peak for the CPU
    assert math.isfinite(res["loss"])
    assert res["step_decomposition"]["dispatch_mean_s"] > 0
    assert res["memory"]["devices"] == {"cpu": {}} and res["memory"]["census"]["total_bytes"] > 0


def test_benchmark_llm_on_cpu_matches_jax_keys_and_loss(tmp_path, capsys):
    """The tiny Llama through the CLI, and JAX's recipe on the same config.
    JAX's runs on the suite's 8 virtual CPU devices (``distributed:
    {dp_shard: -1}``, a section the port refuses past one device) without
    its cost attribution (``profiling: {enabled: false}``, a section the
    port refuses; it would only lower the step once more). The port's
    recipe takes JAX's weights after setup, so after 1 warmup and 2
    measured steps on the same first batch the losses agree within fp32
    1e-5."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.recipes.benchmark import BenchmarkingRecipeForNextTokenPrediction

    rc, res = _port_cli(tmp_path, TINY_BASE)
    assert rc == 0
    printed = json.loads([s for s in capsys.readouterr().out.splitlines() if s.startswith("{")][-1])
    assert printed["tokens_per_step"] == res["tokens_per_step"] == 2 * 8 * 32
    _check_result(res, measure=2)
    assert res["serve_spill_failure"] == "no serving: section in config"
    assert res["serve_fleet_failure"] == "no fleet: section in config"
    rows = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["bench_step"] for r in rows] == [0, 1] and all(r["step_time_s"] > 0 for r in rows)

    jrecipe = JBench(JConfigNode(dict(TINY_BASE, distributed=dict(dp_shard=-1), profiling=dict(enabled=False),
                                      logging=dict(metrics_path=str(tmp_path / "j.jsonl")))))
    jrecipe.setup()
    params = jax.device_get(jrecipe.state.params)
    jres = jrecipe.run_benchmark()
    assert set(res) == set(jres) - set(NOT_IN_PORT), set(res) ^ (set(jres) - set(NOT_IN_PORT))
    assert set(res) == set(TINY_BENCH_KEYS) - RAN_LEG_KEYS
    for k in ("gen_failure", "serve_failure", "serve_spill_failure", "serve_fleet_failure", "tokens_per_step"):
        assert res[k] == jres[k], k

    cfg = dict(TINY_BASE, device="cpu", logging=dict(metrics_path=str(tmp_path / "p.jsonl")))
    recipe = BenchmarkingRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    recipe.model.load_state_dict(params_from_jax(params))
    port = recipe.run_benchmark()
    np.testing.assert_allclose(port["loss"], jres["loss"], rtol=0, atol=1e-5)


def test_benchmark_llm_decode_and_serving_legs_match_jax(tmp_path):
    """The same tiny Llama with ``generation:`` and ``serving:`` sections
    through the CLI: both legs run (12 decode tokens, 4 served requests)
    and give the keys JAX's legs give on the same config (JAX's recipe set
    up as above, its four legs called on their own), so with the test
    above the whole result has JAX's keys less NOT_IN_PORT."""
    rc, res = _port_cli(tmp_path, TINY_BENCH)
    assert rc == 0
    _check_result(res, measure=2)
    assert res["gen_failure"] is None and res["gen_tokens"] == 12 and res["gen_decode_tps"] > 0
    assert res["serve_failure"] is None and res["serve_requests"] == 4 and res["serve_tokens_per_s"] > 0
    assert res["serve_spill_failure"] == "serving.kv_spill disabled"
    assert set(res) == set(TINY_BENCH_KEYS)

    jrecipe = JBench(JConfigNode(dict(TINY_BENCH, distributed=dict(dp_shard=-1), profiling=dict(enabled=False),
                                      logging=dict(metrics_path=str(tmp_path / "j.jsonl")))))
    jrecipe.setup()
    jlegs = {**jrecipe._generation_leg(), **jrecipe._serving_leg(), **jrecipe._spill_leg(), **jrecipe._fleet_leg(None)}
    legs = {k: v for k, v in res.items() if k.startswith(("gen_", "serve_"))}
    assert set(legs) == set(jlegs), set(legs) ^ set(jlegs)
    for k in ("gen_tokens", "gen_failure", "serve_requests", "serve_failure", "serve_spec_failure",
              "serve_spill_failure", "serve_fleet_failure", "serve_decode_backend", "serve_kv_cache_dtype"):
        assert legs[k] == jlegs[k], k


def test_benchmark_llm_serving_leg_spec_ab(tmp_path):
    """tests/test_spec_decode.py:507 on the port: the serving leg with
    ``serving.speculative`` on, an int8 pool and the fused backend (the
    paged kernel's plain version on the CPU) reports the accept rate, the
    drafts proposed a second and the spec on/off A/B, each side measured;
    the keys are the tiny result's plus ``serve_spec_ab``, as JAX's leg
    adds it."""
    draft = dict(hf_config=dict(HF_TINY, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                                num_attention_heads=2, num_key_value_heads=1, head_dim=8),
                 backend=dict(attn="sdpa", param_dtype="float32", compute_dtype="float32"))
    serving = dict(TINY_BENCH["serving"], kv_cache_dtype="int8", decode_kernel="fused", bench_requests=3,
                   speculative=dict(enabled=True, k=2, draft=draft))
    rc, res = _port_cli(tmp_path, dict(TINY_BENCH, serving=serving))
    assert rc == 0
    assert res["serve_failure"] is None and res["serve_spec_failure"] is None
    assert res["serve_tokens_per_s"] > 0 and res["serve_requests"] == 3
    assert isinstance(res["serve_accept_rate"], float) and 0 <= res["serve_accept_rate"] <= 1
    assert res["serve_draft_tps"] > 0
    assert (res["serve_decode_backend"], res["serve_kv_cache_dtype"]) == ("fused", "int8")
    ab = res["serve_spec_ab"]
    assert ab["spec_on_tokens_per_s"] > 0 and ab["spec_off_tokens_per_s"] > 0 and ab["speedup"] > 0
    assert set(res) == set(TINY_BENCH_KEYS) | {"serve_spec_ab"}


def test_benchmark_llm_on_cpu_moe(tmp_path):
    """moe_tiny_cpu.yaml through the CLI: no generation or serving section,
    so each leg is a null with its reason, and the keys are JAX's less the
    ones a run leg adds and those listed in NOT_IN_PORT."""
    cfg = load_yaml_config(os.path.join(CONFIGS, "moe_tiny_cpu.yaml")).to_dict()
    rc, res = _port_cli(tmp_path, dict(cfg, benchmark=dict(warmup_steps=1, measure_steps=3)))
    assert rc == 0
    _check_result(res, measure=3)
    assert res["tokens_per_step"] == 2 * 4 * 64
    assert (res["gen_failure"], res["serve_failure"]) == ("no generation: section in config",
                                                          "no serving: section in config")
    assert res["serve_spill_failure"] == "no serving: section in config"
    keys = set(TINY_BENCH_KEYS)
    assert set(res) == keys - RAN_LEG_KEYS
    if not torch.cuda.is_available():  # CUDA unless asked for the CPU
        with pytest.raises(RuntimeError, match="torch.cuda"):
            app.main(["benchmark", "llm", "-c", _yaml(tmp_path, cfg)])


# the port's result keys with both legs run (the first test holds them to JAX's)
TINY_BENCH_KEYS = (
    "tokens_per_second", "tokens_per_second_per_chip", "tflops_per_second_per_chip", "mfu", "step_time_mean_s",
    "step_time_min_s", "step_time_max_s", "n_chips", "tokens_per_step", "loss", "timers", "step_decomposition",
    "telemetry_overhead_s_per_step", "telemetry_overhead_fraction", "memory",
    "gen_ttft_s", "gen_decode_tps", "gen_tokens", "gen_cache_bytes", "gen_failure",
    "serve_tokens_per_s", "serve_ttft_p50_s", "serve_ttft_p99_s", "serve_block_occupancy_peak", "serve_requests",
    "serve_prefix_cache", "serve_queue_depth_peak", "serve_decode_backend", "serve_kv_cache_dtype",
    "serve_failure", "serve_accept_rate", "serve_draft_tps", "serve_spec_failure",
    "serve_spill_tokens_per_s", "serve_spill_ttft_p50_s", "serve_effective_hit_rate", "serve_spill_reloads",
    "serve_spill_failure", "serve_fleet_tokens_per_s", "serve_route_prefix_hit_rate", "serve_fleet_retries",
    "serve_fleet_failure",
)


@pytest.mark.parametrize("override,name", [
    ("--serving.speculative.enabled=true", "serving.speculative"),
    ("--serving.warm_start.peer_host=127.0.0.1", "serving.warm_start"),
    ("--fleet.replicas=[http://127.0.0.1:8101]", "fleet"),
    ("--benchmark.profile.enabled=true", "benchmark.profile.enabled"),
])
def test_benchmark_refuses_unported_legs_by_name(tmp_path, override, name):
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        _port_cli(tmp_path, TINY_BENCH, override)


# -- run_workload --------------------------------------------------------------


def test_run_workload_matches_jax_engine():
    """The same weights, the same arrivals (every offset 0), greedy
    decoding on the gather backend (plain attention on the CPU): the same
    completions token for token, the same request and token counts, the
    same prefix-cache counters and the same stats keys."""
    from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
    from automodel_tpu.serving.engine import ServeConfig as JServeConfig
    from automodel_tpu.serving.engine import ServingEngine as JServingEngine
    from automodel_tpu_torch.generation.engine import GenerationConfig
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine

    _, params, jauto = jax_tiny(seed=4)
    tauto = torch_twin(params)
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, size=12).tolist()
    prompts = [rng.integers(1, 128, size=n).tolist() for n in (5, 19, 3, 9)] + [shared + [5, 6], shared + [7]]
    arrivals = [(0.0, p, 4 + i % 3) for i, p in enumerate(prompts)]
    serve = dict(slots=2, block_size=4, num_blocks=64, prefill_chunk=8, max_seq_len=64, decode_kernel="gather")
    out = {}
    for name, eng in (
        ("port", ServingEngine(tauto, ServeConfig(**serve), GenerationConfig(max_new_tokens=6, greedy=True))),
        ("jax", JServingEngine(jauto, JServeConfig(**serve), JGenerationConfig(max_new_tokens=6, greedy=True))),
    ):
        recs, stats = eng.run_workload(arrivals)
        out[name] = ({r["request_id"]: r["tokens"] for r in recs}, stats)
    (toks, stats), (jtoks, jstats) = out["port"], out["jax"]
    assert toks == jtoks and len(toks) == 6
    assert [len(t) for t in toks.values()] == [4, 5, 6, 4, 5, 6]
    assert set(stats) == set(jstats)
    for k in ("requests", "gen_tokens", "block_occupancy_peak", "queue_depth_peak"):
        assert stats[k] == jstats[k], k
    # JAX's pool counts its spill tier and peer fetches too; unused, all 0
    jc = jstats["prefix_cache"]
    assert stats["prefix_cache"] == {k: jc[k] for k in stats["prefix_cache"]}
    assert stats["prefix_cache"]["prefix_hit_tokens"] > 0
    assert not any(v for k, v in jc.items() if k not in stats["prefix_cache"])
    assert stats["ttft_p50_s"] > 0 and stats["sustained_tokens_per_s"] > 0


@pytest.mark.parametrize("name,file", [
    ("BENCH_LLAMA3_8B", "benchmark_llama3_8b.yaml"),
    ("BENCH_QWEN3_MOE_A3B", "benchmark_qwen3_moe_a3b.yaml"),
    ("BENCH_GPT_OSS_20B", "benchmark_gpt_oss_20b.yaml"),
    ("BENCH_GEMMA2_9B", "benchmark_gemma2_9b.yaml"),
])
def test_chip_smoke_benchmarks_the_committed_configs(name, file):
    """chip_smoke.py phase 18 carries each benchmark config as a dict (the
    card has no YAML reader): its benchmark:, generation: and serving:
    sections, and the rest, must not drift from the committed file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = load_yaml_config(os.path.join(CONFIGS, file)).to_dict()
    assert getattr(chip_smoke, name) == cfg
    assert cfg["benchmark"] == dict(warmup_steps=3, measure_steps=10)
