"""The port's host KV spill tier against the JAX package's.

The tier itself (``HostSpillTier``), the allocator with the tier attached
under a randomized churn, the block moves between the pool and host memory
(``extract_blocks`` / ``inject_blocks`` and the payload helpers, bit for bit
on the same numpy-made pool bytes), the engine's spill → reload path on the
same tiny Llama weights (``params_from_jax``: tokens, counters and the tier's
bytes equal to JAX's engine, reload tokens equal to recompute), the config's
validation and the benchmark's spill leg (its keys and counts; host-clock
times are never compared). Mirrors ``tests/test_serving.py`` :1099, :1135,
:1189, :1254, :1299 and :1335.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
from automodel_tpu.serving import block_pool as jbp
from automodel_tpu.serving import paged as jpaged
from automodel_tpu.serving.engine import KVSpillConfig as JKVSpillConfig
from automodel_tpu.serving.engine import ServeConfig as JServeConfig
from automodel_tpu.serving.engine import ServingEngine as JServingEngine
from automodel_tpu_torch.generation.engine import GenerationConfig
from automodel_tpu_torch.serving import block_pool as tbp
from automodel_tpu_torch.serving import paged as tpaged
from automodel_tpu_torch.serving.engine import KVSpillConfig, ServeConfig, ServingEngine
from torch_port_parity import jax_tiny, torch_twin


@pytest.fixture(scope="module")
def models():
    _, params, jauto = jax_tiny(seed=0)
    return jauto, torch_twin(params)


# -- the tier and the allocator -------------------------------------------------


def test_host_spill_tier_lru_budget_and_counters():
    """The same operations on both tiers (LRU eviction to fit the budget,
    recency refresh, oversize rejection, overwrite, clear): every return
    value, the byte ledger, the counters and the MRU-first hashes equal."""
    tiers = (jbp.HostSpillTier(max_bytes=256), tbp.HostSpillTier(max_bytes=256))
    ops = [
        ("put", 1, b"a" * 64, 64), ("put", 2, b"b" * 64, 64), ("get", 1), ("put", 3, b"c" * 128, 128),
        ("put", 4, b"d" * 64, 64), ("get", 2), ("put", 5, b"x" * 512, 512), ("put", 1, b"A" * 32, 32),
        ("get", 4), ("clear",), ("put", 6, b"e" * 8, 8),
    ]
    for op in ops:
        outs = []
        for tier in tiers:
            if op[0] == "put":
                outs.append(tier.put(op[1], op[2], op[3]))
            elif op[0] == "get":
                outs.append(tier.get(op[1]))
            else:
                outs.append(tier.clear())
            tier.check_invariants()
        j, t = tiers
        assert outs[0] == outs[1], op
        assert (t.bytes, len(t), t.chain_hashes(), t.counters) == (j.bytes, len(j), j.chain_hashes(), j.counters), op
    assert tiers[1].counters == {"spill_puts": 6, "spill_gets": 2, "spill_evicted": 1, "spill_rejected": 1}
    for cls in (jbp.HostSpillTier, tbp.HostSpillTier):
        with pytest.raises(ValueError):
            cls(max_bytes=0)


def test_spill_churn_randomized_invariants():
    """A randomized admit/finish/evict/reload schedule on both allocators
    with a live tier, in lockstep: both audits pass after every operation,
    the counters and tier ledgers stay equal, and the drained pools return
    to fully available. The schedule moves every tier of the hierarchy."""
    rng = random.Random(16)
    pools = []
    for mod in (jbp, tbp):
        pool = mod.BlockPool(num_blocks=16, block_size=4)
        pool.spill = mod.HostSpillTier(max_bytes=40 * 64)

        def on_evict(evicted, pool=pool):
            for h, _ in evicted:
                if pool.spill.put(h, ("payload", h), 64):
                    pool.counters["spilled_blocks"] += 1

        pool.on_evict = on_evict
        pools.append(pool)
    live: list[list[list[int]]] = []
    for _ in range(600):
        if live and (rng.random() < 0.45 or pools[1].available() < 5):
            blocks = live.pop(rng.randrange(len(live)))
            for pool, b in zip(pools, blocks):
                pool.free(b)
        else:
            tokens = [rng.randrange(3) for _ in range(rng.choice([5, 9, 13, 17]))]
            got = []
            for pool, mod in zip(pools, (jbp, tbp)):
                hits, hit_tokens = pool.match_prefix(tokens)
                reloaded = 0
                for h in mod.prompt_chain(tokens, 4)[len(hits):]:
                    if pool.spill.get(h) is None:
                        break
                    reloaded += 1
                fresh = pool.allocate(-(-(len(tokens) + 1) // 4) - len(hits))
                if fresh is None:
                    if hits:
                        pool.free(hits)
                    got.append(None)
                    continue
                if reloaded:
                    pool.counters["spill_reloads"] += 1
                    pool.counters["spill_reloaded_blocks"] += reloaded
                hit_tokens += reloaded * 4
                matchable = max(len(tokens) - 1, 0) // 4 * 4
                pool.note_prefix_tokens(hit_tokens, max(matchable - hit_tokens, 0))
                pool.register_prefix(tokens, hits + fresh)
                got.append(hits + fresh)
            assert got[0] == got[1]
            if got[1] is not None:
                live.append(got)
        for pool in pools:
            pool.check_invariants()
        assert pools[1].counters == {k: pools[0].counters[k] for k in pools[1].counters}
        assert pools[1].spill.counters == pools[0].spill.counters
        assert pools[1].cached_chain_hashes(6) == pools[0].cached_chain_hashes(6)
    for blocks in live:
        for pool, b in zip(pools, blocks):
            pool.free(b)
    for pool in pools:
        pool.check_invariants()
        assert pool.available() == pool.usable_blocks
    c = pools[1].counters
    assert c["evictions"] > 0 and c["spilled_blocks"] > 0 and c["spill_reloads"] > 0
    assert c["prefix_hit_tokens"] > 0 and c["prefix_miss_tokens"] > 0


# -- moving blocks ---------------------------------------------------------------


def _pools(quantized: bool, seed: int = 0):
    """The same numpy-made pool bytes as a JAX PagedKV and a port PagedKV
    (bf16 values, or int8 values with fp32 scales)."""
    rng = np.random.default_rng(seed)
    shape = (2, 12, 4, 2, 8)

    def side():
        if quantized:
            return (rng.integers(-127, 128, size=shape).astype(np.int8),
                    rng.random(shape[:-1]).astype(np.float32))
        # bf16 bits with the exponent's top bit clear: finite values only
        # (a NaN's payload may be rewritten by a device copy)
        return (rng.integers(0, 2**16, size=shape) & 0xBFFF).astype(np.uint16).view(np.int16)

    k, v = side(), side()

    def as_jax(s):
        if quantized:
            return tuple(jnp.asarray(a) for a in s)
        return jax.lax.bitcast_convert_type(jnp.asarray(s), jnp.bfloat16)

    def as_torch(s):
        if quantized:
            return tuple(torch.from_numpy(a.copy()) for a in s)
        return torch.from_numpy(s.copy()).view(torch.bfloat16)

    return jpaged.PagedKV(k=as_jax(k), v=as_jax(v)), tpaged.PagedKV(k=as_torch(k), v=as_torch(v))


def _np(x) -> np.ndarray:
    """Bytes of a host array or tensor (bf16 as its int16 bits)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _flat(payload: dict) -> list[np.ndarray]:
    return [_np(a) for side in ("k", "v") for a in (payload[side] if isinstance(payload[side], tuple)
                                                     else (payload[side],))]


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_extract_inject_match_jax_bit_for_bit(quantized):
    """extract → split → concat → inject on both packages, from the same
    pool bytes: every payload and the receiving pool's bytes equal JAX's,
    an int8 pool's scales included; the port's exact-count inject leaves
    the same bytes outside block 0 as JAX's inject padded to a power of two
    and aimed at the scratch block."""
    jpool, tpool = _pools(quantized)
    blocks = [3, 7, 5]
    jk, jv = jpaged.extract_blocks(jpool, blocks)
    tk, tv = tpaged.extract_blocks(tpool, blocks)
    jpay, tpay = {"k": jk, "v": jv}, {"k": tk, "v": tv}
    for a, b in zip(_flat(jpay), _flat(tpay)):
        np.testing.assert_array_equal(a, b)
    assert tpaged.kv_nbytes(tpay) == jpaged.kv_nbytes(jpay)
    jparts, tparts = jpaged.split_kv_blocks(jpay), tpaged.split_kv_blocks(tpay)
    assert len(tparts) == len(jparts) == 3
    for a, b in zip(jparts, tparts):
        for x, y in zip(_flat(a), _flat(b)):
            np.testing.assert_array_equal(x, y)
    tjoined = tpaged.concat_kv_blocks(tparts)
    for x, y in zip(_flat(tjoined), _flat(tpay)):
        np.testing.assert_array_equal(x, y)
    dst = [9, 1, 10]
    jdst, tdst = _pools(quantized, seed=1)
    jdst = jpaged.inject_blocks(jdst, dst, jpaged.concat_kv_blocks(jparts))
    tpaged.inject_blocks(tdst, dst, tjoined)
    for a, b in zip(_flat({"k": jdst.k, "v": jdst.v}), _flat({"k": tdst.k, "v": tdst.v})):
        np.testing.assert_array_equal(a, b)
    # the round trip lands the bytes as given
    rk, rv = tpaged.extract_blocks(tdst, dst)
    for x, y in zip(_flat({"k": rk, "v": rv}), _flat(tpay)):
        np.testing.assert_array_equal(x, y)
    # JAX's padded inject: 4 blocks, the padding aimed at scratch block 0
    jpad, _ = _pools(quantized, seed=1)
    jpad = jpaged.inject_blocks(
        jpad, dst + [0], jpaged.pad_kv_blocks(jpaged.concat_kv_blocks(jparts), jpaged.bucket_blocks(3))
    )
    for a, b in zip(_flat({"k": jpad.k, "v": jpad.v}), _flat({"k": tdst.k, "v": tdst.v})):
        np.testing.assert_array_equal(a[:, 1:], b[:, 1:])
    # a payload of the other pool kind is refused
    wrong = dict(zip(("k", "v"), tpaged.extract_blocks(_pools(not quantized)[1], dst)))
    with pytest.raises(ValueError):
        tpaged.inject_blocks(tdst, dst, wrong)


# -- the engine ------------------------------------------------------------------

SPILL_SERVE = dict(slots=1, block_size=4, num_blocks=12, prefill_chunk=4, max_seq_len=64, decode_kernel="gather")
PROMPT = list(range(1, 14))  # a 3-block chain: parks 3 cached blocks
BIG = list(range(20, 60))  # disjoint, 40 tokens: needs every block


def _spill_run(eng):
    out = []
    for p, n in ((PROMPT, 6), (BIG, 2), (PROMPT, 6)):
        rid = eng.submit(p, max_new_tokens=n)
        out.append({r["request_id"]: r for r in eng.run()}[rid])
        eng.check_invariants()
    return out


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_spill_reload_matches_jax_and_recompute(models, dtype):
    """A prefix evicted to the host tier and reloaded at its next
    admission: the port's tokens equal JAX's spill engine's and a spill-off
    engine's (recompute), with the same pool and tier counters and tier
    bytes as JAX's; the reloaded blocks hold the tier's bytes exactly."""
    jauto, tauto = models
    spill = dict(enabled=True, max_host_mb=4.0)
    jeng = JServingEngine(
        jauto, JServeConfig(**SPILL_SERVE, kv_cache_dtype=dtype, kv_spill=JKVSpillConfig(**spill)),
        JGenerationConfig(max_new_tokens=6, greedy=True),
    )
    teng = ServingEngine(
        tauto, ServeConfig(**SPILL_SERVE, kv_cache_dtype=dtype, kv_spill=KVSpillConfig(**spill)),
        GenerationConfig(max_new_tokens=6, greedy=True),
    )
    jrecs, trecs = _spill_run(jeng), _spill_run(teng)
    assert [r["tokens"] for r in trecs] == [r["tokens"] for r in jrecs]
    assert trecs[2]["tokens"] == trecs[0]["tokens"]
    assert trecs[2]["prefix_hit_tokens"] == jrecs[2]["prefix_hit_tokens"] == 12
    jc, tc = jeng.pool.counters, teng.pool.counters
    assert tc == {k: jc[k] for k in tc} and set(tc) == set(jc)
    assert tc["spill_reloads"] == 1 and tc["spill_reloaded_blocks"] == 3
    assert tc["spilled_blocks"] == teng.pool.spill.counters["spill_puts"] > 0
    assert teng.pool.spill.counters == jeng.pool.spill.counters
    assert (teng.pool.spill.bytes, len(teng.pool.spill)) == (jeng.pool.spill.bytes, len(jeng.pool.spill))
    assert teng.pool.available() == teng.pool.usable_blocks
    # the reloaded blocks (now parked under the prompt's chain) hold the
    # tier's payload bytes as they were spilled
    chain = tbp.prompt_chain(PROMPT, 4)
    bids = [teng.pool.cached_block(h) for h in chain]
    k, v = tpaged.extract_blocks(teng.kv_pool, bids)
    want = tpaged.concat_kv_blocks([teng.pool.spill.get(h) for h in chain])
    for x, y in zip(_flat({"k": k, "v": v}), _flat(want)):
        np.testing.assert_array_equal(x, y)
    # ground truth: recompute with the spill tier off
    off = ServingEngine(tauto, ServeConfig(**SPILL_SERVE, kv_cache_dtype=dtype),
                        GenerationConfig(max_new_tokens=6, greedy=True))
    assert _spill_run(off)[2]["tokens"] == trecs[2]["tokens"]
    assert off.pool.spill is None and off.pool.counters["spilled_blocks"] == 0


def test_kv_spill_config_parse_validation_and_spec_exclusion():
    """The section's keys, its validation and its exclusion with
    speculative decoding, as JAX's."""
    d = {"kv_spill": {"enabled": True, "max_host_mb": 64.0, "peer_fetch": False, "fetch_timeout_s": 2.0}}
    for cls in (JServeConfig, ServeConfig):
        cfg = cls.from_dict(d)
        assert cfg.kv_spill.enabled and cfg.kv_spill.max_host_mb == 64.0 and cfg.kv_spill.peer_fetch is False
        with pytest.raises(TypeError, match="serving.kv_spill"):
            cls.from_dict({"kv_spill": {"max_host_mbb": 1}})
        with pytest.raises(ValueError, match="max_host_mb"):
            cls.from_dict({"kv_spill": {"max_host_mb": 0}})
        with pytest.raises(ValueError, match="fetch_timeout_s"):
            cls.from_dict({"kv_spill": {"fetch_timeout_s": -1}})
    assert KVSpillConfig.from_dict(None) == KVSpillConfig() and not KVSpillConfig().enabled
    draft = {"hf_config": {"architectures": ["LlamaForCausalLM"]}}
    with pytest.raises(ValueError, match="kv_spill cannot be enabled together with serving.speculative"):
        ServeConfig.from_dict({"kv_spill": {"enabled": True}, "speculative": {"enabled": True, "draft": draft}})


# -- the benchmark's spill leg ---------------------------------------------------


def _bench_cfg(spill: bool) -> dict:
    return {"serving": {
        "slots": 2, "block_size": 4, "num_blocks": 48, "prefill_chunk": 8, "max_seq_len": 64,
        "bench_rate": 50.0, "decode_kernel": "gather", "kv_spill": {"enabled": spill, "max_host_mb": 8.0},
    }}


def test_bench_spill_leg_null_with_reason():
    from automodel_tpu.config.loader import ConfigNode as JConfigNode
    from automodel_tpu.recipes.benchmark import BenchmarkingRecipeForNextTokenPrediction as JBench
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.recipes.benchmark import BenchmarkingRecipeForNextTokenPrediction as Bench

    for cfg in ({}, {"serving": {"slots": 1, "num_blocks": 8}}):
        jrec, trec = JBench.__new__(JBench), Bench.__new__(Bench)
        jrec.cfg, jrec.peft_config = JConfigNode(cfg), None
        trec.cfg = ConfigNode(cfg)
        jleg, tleg = jrec._spill_leg(), trec._spill_leg()
        assert tleg == jleg
        assert tleg["serve_spill_tokens_per_s"] is None and tleg["serve_spill_failure"]


def test_bench_spill_leg_matches_jax_counts(models):
    """The spill A/B through both recipes' legs on the same weights and
    arrivals: the same keys, reload and spill counts and effective hit
    rates (times are host-clock and not compared)."""
    import types

    from automodel_tpu.config.loader import ConfigNode as JConfigNode
    from automodel_tpu.recipes.benchmark import BenchmarkingRecipeForNextTokenPrediction as JBench
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.recipes.benchmark import BenchmarkingRecipeForNextTokenPrediction as Bench

    jauto, tauto = models
    gen = {"max_new_tokens": 4, "greedy": True}
    jrec = JBench.__new__(JBench)
    jrec.cfg, jrec.peft_config, jrec._gen_section = JConfigNode(_bench_cfg(True)), None, gen
    jrec.auto, jrec.model, jrec.state = jauto, jauto.model, types.SimpleNamespace(params=jauto.params)
    trec = Bench.__new__(Bench)
    trec.cfg, trec._gen_section, trec.auto, trec.model = ConfigNode(_bench_cfg(True)), gen, tauto, tauto.model
    scfg = ServeConfig.from_dict(_bench_cfg(True)["serving"])
    assert trec._spill_arrivals(scfg, 12, 3, 3) == jrec._spill_arrivals(JServeConfig.from_dict(
        _bench_cfg(True)["serving"]), 12, 3, 3)
    jleg, tleg = jrec._spill_leg(), trec._spill_leg()
    assert jleg["serve_spill_failure"] is None and tleg["serve_spill_failure"] is None, tleg
    assert set(tleg) == set(jleg) and set(tleg["serve_spill_ab"]) == set(jleg["serve_spill_ab"])
    for key in ("serve_spill_reloads", "serve_effective_hit_rate"):
        assert tleg[key] == jleg[key], key
    for key in ("spilled_blocks", "reloaded_blocks", "effective_hit_rate_on", "effective_hit_rate_off"):
        assert tleg["serve_spill_ab"][key] == jleg["serve_spill_ab"][key], key
    ab = tleg["serve_spill_ab"]
    assert tleg["serve_spill_reloads"] > 0 and ab["spilled_blocks"] >= ab["reloaded_blocks"] > 0
    assert 0 <= ab["effective_hit_rate_off"] < ab["effective_hit_rate_on"] <= 1
    assert tleg["serve_spill_tokens_per_s"] > 0 and ab["spill_off_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", ["decode", "extract"])
def test_bench_legs_report_a_recovered_fault(models, monkeypatch, fault):
    """A fault the engine recovers from fails the benchmark leg instead of
    being measured around: a decode program that raises once inside the
    serving leg's window (one ``engine_error`` rebuild) sets
    ``serve_failure``, and a spill extract that raises (the pool logs it
    and keeps the allocation) sets ``serve_spill_failure``."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.recipes.benchmark import BenchmarkingRecipeForNextTokenPrediction as Bench

    if fault == "decode":
        real = tpaged.build_paged_decode_fn

        def build(*a, **k):
            fn, calls = real(*a, **k), [0]

            def decode(*args):
                calls[0] += 1
                if calls[0] == 3:  # the warm-up request decodes once
                    raise RuntimeError("planted decode failure")
                return fn(*args)

            return decode

        monkeypatch.setattr(tpaged, "build_paged_decode_fn", build)
    else:

        def extract(*a, **k):
            raise RuntimeError("planted extract failure")

        monkeypatch.setattr(tpaged, "extract_blocks", extract)
    _, tauto = models
    trec = Bench.__new__(Bench)
    cfg = _bench_cfg(fault == "extract")
    cfg["serving"]["bench_requests"] = 4
    trec.cfg, trec._gen_section = ConfigNode(cfg), {"max_new_tokens": 4, "greedy": True}
    trec.auto, trec.model = tauto, tauto.model
    leg = trec._serving_leg() if fault == "decode" else trec._spill_leg()
    key = "serve_failure" if fault == "decode" else "serve_spill_failure"
    assert leg[key] and f"planted {fault} failure" in leg[key], leg
    assert "error_total 1" in leg[key] if fault == "decode" else "spill_errors" in leg[key]
    tps = "serve_tokens_per_s" if fault == "decode" else "serve_spill_tokens_per_s"
    assert leg[tps] is None
