"""The torch port's generation slice (``generation/kv_cache.py``'s
contiguous cache, ``generation/loop.py``, ``GenerationEngine``, the
``generate`` CLI and the training recipe's eval sampling) against the JAX
package, following ``tests/test_generation.py``.

The same tiny Llama weights (drawn by JAX, carried by ``params_from_jax``)
go through both packages at fp32. Per-step logits of prefill and cached
decode agree within 1e-5; greedy tokens agree exactly, on ragged batches,
past a ring cache's wraparound and through a stop token's early exit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.generation import kv_cache as jkv
from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
from automodel_tpu.generation.engine import GenerationEngine as JGenerationEngine
from automodel_tpu.generation.loop import build_decode_fn as jbuild_decode_fn
from automodel_tpu.generation.loop import build_prefill_fn as jbuild_prefill_fn
from automodel_tpu.generation.sampling import SamplingConfig as JSamplingConfig
from automodel_tpu.generation.sampling import sample as jsample
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.generation import kv_cache
from automodel_tpu_torch.generation.engine import (
    GenerationConfig,
    GenerationEngine,
    GenerationUnsupported,
    resolve_tokenizer,
)
from automodel_tpu_torch.generation.loop import build_decode_fn, build_prefill_fn
from automodel_tpu_torch.generation.sampling import SamplingConfig
from torch_port_parity import CPU, HF_TINY, jax_tiny, to_np, torch_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "automodel_tpu_torch", "configs")
LOGITS_ATOL = 1e-5
# every layer windowed alike (mistral-style): the engine takes the ring layout
HF_RING = dict(HF_TINY, model_type="mistral", sliding_window=4)


@pytest.fixture(scope="module")
def llama():
    _, params, jauto = jax_tiny(seed=0)
    return jauto, torch_twin(params)


@pytest.fixture(scope="module")
def ring_llama():
    _, params, jauto = jax_tiny(seed=1, hf=HF_RING)
    return jauto, torch_twin(params, hf=HF_RING)


def _jax_stepwise(jauto, prompt, n_steps, capacity, window=None):
    """JAX's cache primitives driven directly: prefill, then greedy decode
    steps. → (per-step logits, tokens)."""
    model, params, cfg = jauto.model, jauto.params, jauto.model.config
    cache = jkv.init_cache(cfg.num_layers, 1, capacity, cfg.num_kv_heads, cfg.head_dim, jnp.float32, window=window)
    prefill = jbuild_prefill_fn(lambda p, i, **kw: model(p, i, **kw))
    last, cache = prefill(params, jnp.asarray([prompt], jnp.int32), jnp.asarray([len(prompt)], jnp.int32), cache)
    logits, tokens = [np.asarray(last[0], np.float32)], [int(jnp.argmax(last[0]))]
    for _ in range(n_steps - 1):
        kvc, ctx = jkv.decode_ctx(cache)
        primary, cache = model(params, jnp.asarray([[tokens[-1]]], jnp.int32),
                               position_ids=ctx.q_pos[:, None], cache=(kvc, ctx))
        logits.append(np.asarray(primary[0, -1], np.float32))
        tokens.append(int(jnp.argmax(primary[0, -1])))
    return logits, tokens


def _port_stepwise(tauto, prompt, n_steps, capacity, window=None):
    """The port's primitives driven the same way."""
    model, cfg = tauto.model, tauto.model.config
    cache = kv_cache.init_cache(cfg.num_layers, 1, capacity, cfg.num_kv_heads, cfg.head_dim, torch.float32,
                                window=window, device=CPU)
    last, cache = build_prefill_fn(model)(torch.tensor([prompt]), torch.tensor([len(prompt)], dtype=torch.int32),
                                          cache)
    logits, tokens = [to_np(last[0])], [int(last[0].argmax())]
    for _ in range(n_steps - 1):
        cache, ctx = kv_cache.decode_ctx(cache)
        with torch.inference_mode():
            out = model(torch.tensor([[tokens[-1]]]), ctx.q_pos[:, None].long(), cache=kv_cache.CacheLayers(cache, ctx))
        logits.append(to_np(out[0, -1]))
        tokens.append(int(out[0, -1].argmax()))
    return logits, tokens


def _full_greedy(model, prompt, n):
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            seq.append(int(model(torch.tensor([seq]))[0, -1].argmax()))
    return seq[len(prompt):]


def test_llama_prefill_decode_logits_match_jax_per_step(llama):
    jauto, tauto = llama
    prompt = [5, 17, 3, 99, 42, 7, 1]
    jl, jt = _jax_stepwise(jauto, prompt, n_steps=8, capacity=16)
    tl, tt = _port_stepwise(tauto, prompt, n_steps=8, capacity=16)
    for step, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGITS_ATOL, err_msg=f"step {step}")
    assert tt == jt
    # and the cached decode is the full forward's greedy continuation
    assert tt == _full_greedy(tauto.model, prompt, 8)


def test_ring_cache_wraparound_matches_jax_and_the_full_forward(ring_llama):
    """Capacity = window = 4 < prompt (6): prefill already wraps and 8
    decode steps overwrite expired slots; every step's logits agree with
    JAX's ring within 1e-5 and the greedy tokens with the full windowed
    forward."""
    jauto, tauto = ring_llama
    prompt = [1, 2, 3, 4, 5, 6]
    jl, jt = _jax_stepwise(jauto, prompt, n_steps=8, capacity=4, window=4)
    tl, tt = _port_stepwise(tauto, prompt, n_steps=8, capacity=4, window=4)
    for step, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGITS_ATOL, err_msg=f"step {step}")
    assert tt == jt == _full_greedy(tauto.model, prompt, 8)


def test_ring_engine_refuses_a_ragged_wrapping_batch(ring_llama):
    jauto, tauto = ring_llama
    cfg = dict(max_new_tokens=4, greedy=True, pad_to_multiple=1)
    eng, jeng = GenerationEngine(tauto, GenerationConfig(**cfg)), JGenerationEngine(jauto, JGenerationConfig(**cfg))
    assert eng._window == jeng._window == 4
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="ring"):
            e.generate_ids([[1, 2, 3, 4, 5, 6], [7, 8]])
    for prompts in ([[1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5, 4]], [[1, 2, 3], [7, 8]]):
        out, jout = eng.generate_ids(prompts), jeng.generate_ids(prompts)
        assert out["tokens"] == jout["tokens"] and out["gen_tokens"] == 8


def test_generate_ids_greedy_tokens_and_keys_match_jax(llama):
    """A ragged batch (padded to a multiple of 16) through both engines:
    the same completions, the same counts, the same result keys."""
    jauto, tauto = llama
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(20, 39))]
    cfg = dict(max_new_tokens=6, greedy=True)
    out = GenerationEngine(tauto, GenerationConfig(**cfg)).generate_ids(prompts)
    jout = JGenerationEngine(jauto, JGenerationConfig(**cfg)).generate_ids(prompts)
    assert set(out) == set(jout)
    for k in ("tokens", "n_generated", "gen_tokens", "prefill_tokens", "decode_steps", "cache_bytes"):
        assert out[k] == jout[k], k
    assert [out["tokens"][b] for b in range(3)] == [_full_greedy(tauto.model, p, 6) for p in prompts]
    assert out["ttft_s"] > 0 and out["decode_tps"] > 0


def test_stop_token_early_exit_matches_jax(llama):
    """Declare greedy's second token the stop id: the stop token is kept,
    later tokens are the pad, and the loop exits after one decode step."""
    jauto, tauto = llama
    prompt = [1, 2, 3]
    _, toks = _port_stepwise(tauto, prompt, n_steps=4, capacity=8)
    eos = toks[1]
    cfg, jcfg = tauto.model.config, jauto.model.config
    cache = kv_cache.init_cache(cfg.num_layers, 1, 32, cfg.num_kv_heads, cfg.head_dim, torch.float32, device=CPU)
    last, cache = build_prefill_fn(tauto.model)(torch.tensor([prompt]), torch.tensor([3], dtype=torch.int32), cache)
    res, _ = build_decode_fn(tauto.model, SamplingConfig(temperature=0.0), 16, eos_ids=(eos,))(
        cache, last.argmax(-1).to(torch.int32))
    apply = lambda p, i, **kw: jauto.model(p, i, **kw)
    jcache = jkv.init_cache(jcfg.num_layers, 1, 32, jcfg.num_kv_heads, jcfg.head_dim, jnp.float32)
    jlast, jcache = jbuild_prefill_fn(apply)(jauto.params, jnp.asarray([prompt], jnp.int32),
                                             jnp.asarray([3], jnp.int32), jcache)
    greedy = JSamplingConfig(temperature=0.0)
    jres, _ = jbuild_decode_fn(apply, greedy, 16, eos_ids=(eos,))(
        jauto.params, jcache, jsample(jlast, jax.random.key(0), greedy), jax.random.key(0))
    jres = jax.device_get(jres)
    assert res["tokens"].tolist() == np.asarray(jres["tokens"]).tolist()
    assert res["n_generated"].tolist() == np.asarray(jres["n_generated"]).tolist() == [2]
    assert res["tokens"][0, 1] == eos and not res["tokens"][0, 2:].any()
    assert res["steps"] == int(jres["steps"]) == 1
    # the engine reports the same early exit
    out = GenerationEngine(tauto, GenerationConfig(max_new_tokens=16, greedy=True, eos_token_id=eos)).generate_ids(
        [prompt])
    assert out["tokens"] == [toks[:2]] and out["decode_steps"] == 1


@pytest.mark.parametrize("config_file,why", [
    ("gemma2_tiny_cpu.yaml", "GemmaForCausalLM has no KV-cache decode path"),
    ("gpt_oss_tiny_cpu.yaml", "GptOssForCausalLM has no KV-cache decode path"),
])
def test_models_without_a_cache_path_raise_generation_unsupported(config_file, why):
    from automodel_tpu_torch.auto_model import from_config
    from automodel_tpu_torch.config.loader import load_yaml_config

    model = load_yaml_config(os.path.join(CONFIGS, config_file)).model
    auto = from_config(model.hf_config.to_dict(), model.backend.to_dict(), device="cpu")
    with pytest.raises(GenerationUnsupported, match=why):
        GenerationEngine(auto, GenerationConfig())


def test_context_limit_is_refused_as_in_jax(llama):
    """prompt + max_new_tokens past max_position_embeddings (256) or past
    generation.max_length raises in both engines."""
    jauto, tauto = llama
    for cfg in (dict(max_new_tokens=250), dict(max_new_tokens=4, max_length=8)):
        for eng in (GenerationEngine(tauto, GenerationConfig(**cfg)), JGenerationEngine(jauto, JGenerationConfig(**cfg))):
            with pytest.raises(ValueError, match="context limit"):
                eng.generate_ids([[1] * 8])


def test_cache_bytes_and_census_see_the_cache():
    from automodel_tpu_torch.telemetry.memory import live_array_census

    cache = kv_cache.init_cache(2, 1, 16, 2, 8, torch.float32, device=CPU)
    assert cache.nbytes == 2 * (2 * 16 * 2 * 8 * 4) + 16 * 4 + 4
    shapes = {tuple(e["shape"]) for e in live_array_census(top_k=64, device="cpu")["top"]}
    assert (2, 1, 16, 2, 8) in shapes


def test_resolve_tokenizer_is_token_id_mode(tmp_path):
    assert resolve_tokenizer(None) is None
    (tmp_path / "tokenizer.json").write_text("{}")
    assert resolve_tokenizer(None, str(tmp_path)) is None  # left unread, with a warning
    with pytest.raises(ValueError, match="generation.tokenizer"):
        resolve_tokenizer("meta-llama/Meta-Llama-3-8B")


SERVE_TINY = os.path.join(CONFIGS, "serve_tiny_cpu.yaml")


def test_generate_cli_prints_completions_of_prompt_ids(capsys):
    """``generate`` with ``--prompt`` and with ``generation.prompt_ids``:
    the completions are the engine's greedy tokens on the config's seeded
    weights, then one generation JSON line; no prompt → exit 2; without
    --device=cpu it raises naming torch.cuda."""
    from automodel_tpu_torch.config.arg_parser import parse_args_and_load_config
    from automodel_tpu_torch.generation.engine import build_auto_from_cfg

    assert app.main(["generate", "-c", SERVE_TINY, "--device=cpu", "--prompt", "1 2 3 4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "prompt: 1 2 3 4"
    completion = [int(t) for t in lines[1].split("completion:", 1)[1].split()]
    stats = json.loads(lines[-1])
    assert stats["event"] == "generation" and stats["gen_tokens"] == 8 and stats["ttft_s"] > 0
    cfg = parse_args_and_load_config(["-c", SERVE_TINY, "--device=cpu"])
    engine = GenerationEngine(build_auto_from_cfg(cfg), GenerationConfig.from_dict(cfg.generation.to_dict()))
    assert completion == engine.generate_ids([[1, 2, 3, 4]])["tokens"][0]

    assert app.main(["generate", "-c", SERVE_TINY, "--device=cpu", "--generation.prompt_ids=[[1,2,3],[4,5,6,7]]"]) == 0
    out = capsys.readouterr().out
    assert out.count("completion:") == 2 and "prompt: 4 5 6 7" in out
    assert app.main(["generate", "-c", SERVE_TINY, "--device=cpu"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda"):
            app.main(["generate", "-c", SERVE_TINY, "--device=cuda", "--prompt", "1 2"])


def test_train_recipe_logs_generations_at_validation(tmp_path):
    """A ``generation:`` section samples its prompt_ids with the live
    weights at each validation step (2 and 4) and logs them; the step-4
    samples are what the engine gives on the trained weights."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = load_yaml_config(os.path.join(CONFIGS, "sft_tiny_cpu.yaml")).to_dict()
    cfg.update(device="cpu", logging=dict(metrics_path=str(tmp_path / "m.jsonl")),
               generation=dict(max_new_tokens=4, greedy=True, prompt_ids=[[1, 2, 3, 4], [5, 6]]))
    cfg["step_scheduler"].update(max_steps=4, val_every_steps=2)
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    recipe.run_train_validation_loop()
    rows = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    gens = [r for r in rows if r.get("event") == "generation"]
    assert [g["step"] for g in gens] == [2, 4]
    assert [s["prompt"] for s in gens[0]["gen_samples"]] == ["1 2 3 4", "5 6"]
    assert all(len(s["completion"].split()) == 4 for g in gens for s in g["gen_samples"])
    assert gens[-1]["gen_tokens"] == 8 and gens[-1]["ttft_s"] > 0 and gens[-1]["gen_cache_bytes"] > 0
    final = recipe._gen_engine.generate_ids([[1, 2, 3, 4], [5, 6]])["tokens"]
    assert [s["completion"] for s in gens[-1]["gen_samples"]] == [" ".join(map(str, t)) for t in final]
    assert len([r for r in rows if "loss" in r]) == 4  # sampling added no training row
