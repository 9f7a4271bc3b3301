"""The torch port's serving slice as a whole against the JAX package's
``ServingEngine``: same tiny Llama weights (carried by ``params_from_jax``),
same requests, identical greedy tokens per request.

One workload covers the engine's paths: ragged prompts, a prompt longer
than ``prefill_chunk`` (three chunks), more requests than slots (mid-flight
refill) and a prompt that shares three full blocks with an earlier one
(a prefix-cache hit). It runs on both decode backends and with an int8
pool; the int8 pool is held to the JAX int8 engine, not to fp32. The JAX
fused backend runs its Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
from automodel_tpu.serving.engine import ServeConfig as JServeConfig
from automodel_tpu.serving.engine import ServingEngine as JServingEngine
from automodel_tpu_torch.generation.engine import GenerationConfig
from automodel_tpu_torch.serving.block_pool import BlockPool, BlockPoolError
from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine
from torch_port_parity import jax_tiny, torch_twin

SERVE = dict(slots=2, block_size=4, num_blocks=64, prefill_chunk=8, max_seq_len=64)
MAX_NEW = 6


def _workload():
    rng = np.random.default_rng(5)
    long = rng.integers(1, 128, size=19).tolist()  # 3 chunks of 8
    return [
        rng.integers(1, 128, size=5).tolist(),
        long,
        rng.integers(1, 128, size=3).tolist(),
        long[:12] + rng.integers(1, 128, size=4).tolist(),  # 3 shared blocks
        rng.integers(1, 128, size=9).tolist(),
    ]


def _run(engine, prompts):
    ids = [engine.submit(p, request_id=f"r{i}") for i, p in enumerate(prompts)]
    done = {r["request_id"]: r for r in engine.run()}
    return [done[i] for i in ids]


@pytest.fixture(scope="module")
def models():
    _, params, jauto = jax_tiny(seed=0)
    return jauto, torch_twin(params)


@pytest.mark.parametrize(
    "decode_kernel,kv_cache_dtype",
    [("fused", "bf16"), ("gather", "bf16"), ("fused", "int8"), ("gather", "int8")],
)
def test_serving_greedy_tokens_match_jax_engine(models, monkeypatch, decode_kernel, kv_cache_dtype):
    monkeypatch.setenv("AUTOMODEL_FLASH_INTERPRET", "1")
    jauto, tauto = models
    prompts = _workload()
    serve = dict(SERVE, decode_kernel=decode_kernel, kv_cache_dtype=kv_cache_dtype)
    jeng = JServingEngine(
        jauto, JServeConfig(**serve), JGenerationConfig(max_new_tokens=MAX_NEW, greedy=True)
    )
    assert jeng.decode_backend == decode_kernel
    teng = ServingEngine(
        tauto, ServeConfig(**serve), GenerationConfig(max_new_tokens=MAX_NEW, greedy=True)
    )
    assert teng.decode_backend == decode_kernel
    jrecs = _run(jeng, prompts)
    trecs = _run(teng, prompts)
    assert [r["tokens"] for r in trecs] == [r["tokens"] for r in jrecs]
    assert all(r["completion_reason"] == "length" and len(r["tokens"]) == MAX_NEW for r in trecs)
    assert all(r["ttft_s"] >= 0 for r in trecs)
    # the shared-prefix prompt hit the cache in both engines
    assert trecs[3]["prefix_hit_tokens"] == jrecs[3]["prefix_hit_tokens"] == 12
    assert teng.prefill_chunks > len(prompts)  # the long prompt took 3 chunks
    teng.check_invariants()
    assert teng.pool.available() == teng.pool.usable_blocks


def test_auto_decode_kernel_resolves_to_fused(models):
    _, tauto = models
    eng = ServingEngine(tauto, ServeConfig(**SERVE), GenerationConfig(max_new_tokens=2))
    assert eng.decode_backend == "fused"
    eng = ServingEngine(
        tauto, ServeConfig(**SERVE, decode_kernel="gather"), GenerationConfig(max_new_tokens=2)
    )
    assert eng.decode_backend == "gather"


def test_stop_token_and_timeout_records(models):
    _, tauto = models
    prompts = _workload()[:2]
    ref = _run(
        ServingEngine(tauto, ServeConfig(**SERVE), GenerationConfig(max_new_tokens=MAX_NEW, greedy=True)),
        prompts,
    )
    eos = ref[0]["tokens"][2]
    eng = ServingEngine(
        tauto, ServeConfig(**SERVE),
        GenerationConfig(max_new_tokens=MAX_NEW, greedy=True, eos_token_id=eos),
    )
    recs = _run(eng, prompts)
    assert recs[0]["completion_reason"] == "stop"
    assert recs[0]["tokens"] == ref[0]["tokens"][: ref[0]["tokens"].index(eos) + 1]
    eng.submit([1, 2, 3], request_id="late", deadline_s=1e-9)
    (rec,) = eng.run()
    assert rec["completion_reason"] == "timeout" and rec["tokens"] == []


@pytest.mark.parametrize("qos", [False, True])
def test_terminal_record_keys_match_jax_engine(models, qos):
    """Every terminal record of both engines carries the same keys, among
    them ``retriable``, ``tenant`` and ``tier``, for a request that ends by
    length and one whose queue deadline expires (both with their QoS
    section on or off). An unknown tier is refused at submission by both."""
    jauto, tauto = models
    serve = dict(SERVE, qos={"enabled": True}) if qos else SERVE
    jeng = JServingEngine(jauto, JServeConfig.from_dict(serve), JGenerationConfig(max_new_tokens=2, greedy=True))
    teng = ServingEngine(tauto, ServeConfig.from_dict(serve), GenerationConfig(max_new_tokens=2, greedy=True))
    recs = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        eng.submit([1, 2, 3], request_id="done")
        eng.submit([4, 5], request_id="late", deadline_s=1e-9)
        recs[name] = {r["request_id"]: r for r in eng.run()}
        with pytest.raises(ValueError, match="unknown QoS tier"):
            eng.submit([1, 2], tier="premium")
    for rid, reason in (("done", "length"), ("late", "timeout")):
        j, t = recs["jax"][rid], recs["torch"][rid]
        assert t["completion_reason"] == j["completion_reason"] == reason
        assert set(t) == set(j), set(t) ^ set(j)
        assert (t["retriable"], t["tenant"], t["tier"]) == (j["retriable"], j["tenant"], j["tier"])
        assert (t["retriable"], t["tenant"], t["tier"]) == (False, "anonymous", "interactive")
    teng.submit([1, 2, 3], request_id="named", tenant="team-a", tier="batch")
    (rec,) = teng.run()
    assert (rec["tenant"], rec["tier"]) == ("team-a", "batch")


def test_sampled_decode_is_reproducible_from_the_seed(models):
    _, tauto = models

    def run(seed):
        eng = ServingEngine(
            tauto, ServeConfig(**SERVE),
            GenerationConfig(max_new_tokens=MAX_NEW, temperature=1.0, top_k=20, top_p=0.9, seed=seed),
        )
        return [r["tokens"] for r in _run(eng, _workload()[:3])]

    assert run(3) == run(3)
    assert run(3) != run(4)


@pytest.mark.parametrize(
    "section,value",
    [
        ("speculative", {"enabled": True, "k": 4}),
        ("warm_start", {"peer_host": "127.0.0.1", "peer_port": 9000}),
        ("kv_transfer", {"enabled": True}),
        ("role", "decode"),
    ],
)
def test_unported_serving_sections_are_refused(section, value):
    with pytest.raises(ValueError, match=section):
        ServeConfig.from_dict({**SERVE, section: value})


def test_disabled_sections_are_accepted():
    cfg = ServeConfig.from_dict(
        {**SERVE, "speculative": {"enabled": False}, "http": {"port": None}, "limits": {"deadline_s": 5}}
    )
    assert cfg.limits.deadline_s == 5


def test_submit_validation(models):
    _, tauto = models
    eng = ServingEngine(tauto, ServeConfig(**SERVE), GenerationConfig(max_new_tokens=4))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(ValueError, match="exceeds the serving limit"):
        eng.submit([1] * 62)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit([1, 999])


def test_chunk_prefill_leaves_earlier_int8_blocks_bit_identical():
    """An int8 pool under a bf16 compute dtype. The port's chunk prefill
    writes back only the chunk's own rows, so the blocks of earlier chunks
    (shared prefix blocks among them) keep their bytes. The JAX program
    rewrites the whole gathered view instead; that leaves the same bytes
    because quantize∘dequantize is idempotent on rows that were written in
    the compute dtype."""
    import torch

    from automodel_tpu_torch import auto_model
    from automodel_tpu_torch.ops.paged_attention import dequantize_kv, quantize_kv_rows
    from automodel_tpu_torch.serving import paged
    from torch_port_parity import HF_TINY

    auto = auto_model.from_config(
        HF_TINY, dict(attn="sdpa", param_dtype="float32", compute_dtype="bfloat16"),
        device="cpu", seed=0,
    )
    cfg = auto.config
    pool = paged.init_pool(
        cfg.num_layers, 16, 4, cfg.num_kv_heads, cfg.head_dim, quantized=True, device="cpu"
    )
    chunk = paged.build_chunk_prefill_fn(auto.model, 8, torch.bfloat16)
    table = torch.arange(1, 7, dtype=torch.int32)  # 24 positions
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, 128, size=16))
    chunk(pool, table, ids[:8], 0, 8)
    first = [t[:, 1:3].clone() for t in (*pool.k, *pool.v)]  # positions 0..7
    chunk(pool, table, ids[8:], 8, 8)
    for before, t in zip(first, (*pool.k, *pool.v)):
        assert torch.equal(t[:, 1:3], before)
    for vals, scales in (pool.k, pool.v):
        again = quantize_kv_rows(dequantize_kv(vals[:, 1:3], scales[:, 1:3], torch.bfloat16))
        assert torch.equal(again[0], vals[:, 1:3]) and torch.equal(again[1], scales[:, 1:3])


def test_block_pool_prefix_cache_and_invariants():
    pool = BlockPool(num_blocks=6, block_size=2)
    tokens = [1, 2, 3, 4, 5]
    blocks = pool.allocate(3)
    pool.register_prefix(tokens, blocks)
    pool.free(blocks)
    hits, n = pool.match_prefix(tokens)
    assert n == 4 and hits == blocks[:2]
    pool.free(hits)
    big = pool.allocate(5)
    assert big is not None and pool.counters["evictions"] >= 1
    assert pool.match_prefix(tokens) == ([], 0)
    pool.free(big)
    pool.check_invariants()
    with pytest.raises(BlockPoolError, match="scratch"):
        pool.free([0])
    with pytest.raises(BlockPoolError, match="double free"):
        pool.free([big[0]])
