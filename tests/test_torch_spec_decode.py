"""The torch port's speculative decoding and Qwen3-MoE KV-cache decode
against the JAX package on the CPU, following ``tests/test_spec_decode.py``,
``tests/test_generation.py`` and ``tests/test_serving.py``.

The same tiny weights go to both packages: JAX draws the target's and the
draft's, ``params_from_jax`` carries them to the port (the port's engine
builds its own draft from the section, whose weights are then replaced).
Prompts are made with numpy. Contracts held here:

- **greedy spec parity**: the port's speculative engine commits the same
  tokens as JAX's speculative engine and as non-speculative greedy
  decoding, for Llama and Qwen3-MoE targets, on the gather and fused
  backends, fp32 and int8 pools; each verify round commits as many tokens
  as JAX's up to the first round in which a slot accepted all k drafts
  (JAX's draft pool then misses ``d_k``'s row, which the port writes: the
  proposals, not the committed tokens, differ after it);
- **self-draft**: a draft holding the target's own weights accepts every
  proposal (1.0), the math that JAX's own self-draft test asks for;
- **rollback**: pool invariants after every step of a mixed accept/reject
  schedule with k > block_size, and the pool drains;
- **the sampled rule**: the committed token is distributed as the target's
  distribution, whatever the draft's;
- **Qwen3-MoE decode**: prefill + decode logits equal JAX's within fp32
  1e-5 through the contiguous cache and the paged programs (gather and
  fused), under the ``dense`` and ``ragged`` experts;
- the config refusals, with JAX's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.generation import kv_cache as jkv
from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
from automodel_tpu.generation.loop import build_prefill_fn as jbuild_prefill_fn
from automodel_tpu.generation.sampling import SamplingConfig as JSamplingConfig
from automodel_tpu.generation.sampling import speculative_verify as jspeculative_verify
from automodel_tpu.serving.engine import ServeConfig as JServeConfig
from automodel_tpu.serving.engine import ServingEngine as JServingEngine
from automodel_tpu.serving.engine import SpeculativeConfig as JSpeculativeConfig
from automodel_tpu_torch.generation import kv_cache
from automodel_tpu_torch.generation.engine import GenerationConfig, GenerationEngine, GenerationUnsupported
from automodel_tpu_torch.generation.loop import build_prefill_fn
from automodel_tpu_torch.generation.sampling import SamplingConfig, speculative_verify
from automodel_tpu_torch.models.llama import params_from_jax as llama_from_jax
from automodel_tpu_torch.serving import paged
from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine, SpeculativeConfig
from torch_port_parity import CPU, jax_tiny, to_np, torch_twin

FP32 = {"attn": "sdpa", "param_dtype": "float32", "compute_dtype": "float32"}
LOGITS_ATOL = 1e-5

# tests/test_spec_decode.py's target (_tiny_llama) and draft (_draft_section)
HF_TARGET = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=64, hidden_size=32,
    intermediate_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
    head_dim=8, max_position_embeddings=128,
)
HF_DRAFT = dict(HF_TARGET, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                num_attention_heads=2, num_key_value_heads=1)
# the qwen3_moe fixtures of :276 (one dense layer, then one MoE layer, 4
# experts) and :315 (8 experts, vocab 128)
HF_MOE_MIXED = dict(
    architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe", vocab_size=64, hidden_size=32,
    intermediate_size=64, moe_intermediate_size=16, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=8, num_experts=4, num_experts_per_tok=2, max_position_embeddings=128,
    tie_word_embeddings=False, first_k_dense_replace=1,
)
HF_MOE = dict(HF_MOE_MIXED, vocab_size=128, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
              head_dim=16, num_experts=8, max_position_embeddings=256)
SERVE = dict(slots=2, block_size=4, num_blocks=48, prefill_chunk=4, max_seq_len=48)


def _draft_section(**over) -> dict:
    return {"hf_config": dict(HF_DRAFT, **over), "backend": dict(FP32)}


def _jax_moe(hf, seed=2):
    """JAX's AutoModel of one Qwen3-MoE (dense experts, as JAX's tests)."""
    from automodel_tpu.auto_model import AutoModel as JAutoModel
    from automodel_tpu.models.common.config import BackendConfig as JBackend
    from automodel_tpu.models.qwen3_moe import MoEForCausalLM as JMoE
    from automodel_tpu.models.qwen3_moe import MoETransformerConfig as JMoEConfig

    jmodel = JMoE(JMoEConfig.from_hf(hf), JBackend(experts="dense", **FP32))
    return JAutoModel(model=jmodel, params=jmodel.init(jax.random.key(seed)), adapter=None, mesh_ctx=None)


def _port_moe(jauto, hf, experts):
    """The port's twin of a JAX Qwen3-MoE, with the given experts backend."""
    from automodel_tpu_torch.auto_model import AutoModel
    from automodel_tpu_torch.models.common.config import BackendConfig
    from automodel_tpu_torch.models.qwen3_moe import MoEForCausalLM, MoETransformerConfig, params_from_jax

    tmodel = MoEForCausalLM(MoETransformerConfig.from_hf(hf), BackendConfig(experts=experts, **FP32), device=CPU)
    tmodel.load_state_dict(params_from_jax(jax.device_get(jauto.params)))
    return AutoModel(model=tmodel, device=CPU)


@pytest.fixture(scope="module")
def moe():
    """The :315 Qwen3-MoE on the JAX side, and a cache of JAX's results
    that every experts backend of the port is held to."""
    return {"auto": _jax_moe(HF_MOE)}


@pytest.fixture(scope="module")
def llama():
    _, params, jauto = jax_tiny(seed=0, hf=HF_TARGET)
    return jauto, torch_twin(params, hf=HF_TARGET)


def _serve_pair(jauto, tauto, *, max_new=6, spec_k=None, draft=None, gen=None, **over):
    """The JAX and the port engine of one config; with ``spec_k`` the port's
    draft takes the JAX draft's weights."""
    draft = draft or _draft_section()
    jspec = JSpeculativeConfig(enabled=True, k=spec_k, draft=draft) if spec_k else JSpeculativeConfig()
    tspec = SpeculativeConfig(enabled=True, k=spec_k, draft=draft) if spec_k else SpeculativeConfig()
    gen = gen or dict(max_new_tokens=max_new, greedy=True)
    jeng = JServingEngine(jauto, JServeConfig(**SERVE, speculative=jspec, **over), JGenerationConfig(**gen))
    teng = ServingEngine(tauto, ServeConfig(**SERVE, speculative=tspec, **over), GenerationConfig(**gen))
    if spec_k:
        teng.draft_auto.model.load_state_dict(llama_from_jax(jax.device_get(jeng.draft_auto.params)))
    return jeng, teng


def _jax_spec_run(jeng, prompts):
    """JAX's engine over the prompts, its verify program wrapped. →
    (tokens per request, rounds: per-slot n_commit lists, 0 for an
    inactive slot)."""
    rounds, verify = [], jeng._verify

    def wrapped(*a):
        toks, n, pool = verify(*a)
        rounds.append(np.asarray(jax.device_get(n)).tolist())
        return toks, n, pool

    jeng._verify = wrapped
    return [r["tokens"] for r in _run(jeng, prompts)], rounds


def _run(engine, prompts):
    ids = [engine.submit(p, request_id=f"r{i}") for i, p in enumerate(prompts)]
    done = {r["request_id"]: r for r in engine.run()}
    return [done[i] for i in ids]


def _rounds_until_full_accept(rounds, k):
    """The rounds up to and including the first in which a slot committed
    k + 1 tokens (JAX's proposals may differ after it)."""
    for i, r in enumerate(rounds):
        if max(r) == k + 1:
            return rounds[: i + 1]
    return rounds


def _assert_spec_parity(jax_run, teng, base, prompts, k):
    """The port's speculative engine against JAX's run (``_jax_spec_run``)
    and the non-speculative stream ``base``."""
    jtokens, jr = jax_run
    tr, verify = [], teng._verify

    def wrapped(*a):
        toks, n = verify(*a)
        tr.append(n.tolist())
        return toks, n

    teng._verify = wrapped
    trecs = _run(teng, prompts)
    tokens = [r["tokens"] for r in trecs]
    assert tokens == jtokens
    assert tokens == base
    head = _rounds_until_full_accept(jr, k)
    assert tr[: len(head)] == head
    assert teng.spec_proposed_total > 0 and teng.spec_rounds == len(tr)
    teng.check_invariants()
    assert teng.pool.available() == teng.pool.usable_blocks
    return trecs


def _greedy_stream(tauto, prompts, max_new):
    eng = GenerationEngine(tauto, GenerationConfig(max_new_tokens=max_new, greedy=True, pad_to_multiple=1))
    return eng.generate_ids([list(p) for p in prompts])["tokens"]


def _prompts(seed, sizes, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(n)).tolist() for n in sizes]


# -- greedy parity ------------------------------------------------------------


@pytest.mark.parametrize("decode_kernel", ["gather", "fused"])
def test_spec_greedy_parity_llama_ragged(llama, monkeypatch, decode_kernel):
    """:244, a ragged batch of four prompts over two slots and an
    uncorrelated random draft; on both decode backends (JAX's fused is its
    Pallas kernel interpreted)."""
    monkeypatch.setenv("AUTOMODEL_FLASH_INTERPRET", "1")
    jauto, tauto = llama
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17], [3, 1]]
    jeng, teng = _serve_pair(jauto, tauto, spec_k=3, decode_kernel=decode_kernel)
    assert teng.decode_backend == jeng.decode_backend == decode_kernel
    _assert_spec_parity(_jax_spec_run(jeng, prompts), teng, _greedy_stream(tauto, prompts, 6), prompts, k=3)


def test_spec_parity_fused_int8_compound(llama, monkeypatch):
    """:343, speculative decoding over an int8 pool through the fused
    backend: the same tokens as JAX's and as the port's non-speculative
    engine on the same int8 pool."""
    monkeypatch.setenv("AUTOMODEL_FLASH_INTERPRET", "1")
    jauto, tauto = llama
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    base = _run(ServingEngine(tauto, ServeConfig(**SERVE, kv_cache_dtype="int8", decode_kernel="fused"),
                              GenerationConfig(max_new_tokens=6, greedy=True)), prompts)
    jeng, teng = _serve_pair(jauto, tauto, spec_k=3, kv_cache_dtype="int8", decode_kernel="fused")
    _assert_spec_parity(_jax_spec_run(jeng, prompts), teng, [r["tokens"] for r in base], prompts, k=3)


@pytest.mark.parametrize("experts", ["dense", "ragged"])
def test_spec_greedy_parity_qwen3_moe(moe, experts):
    """:315, a Qwen3-MoE target (a dense layer, then an MoE layer over 8
    experts) with a Llama draft; the port's experts dense (plain) or
    ragged (the grouped-matmul kernels' plain versions on the CPU)."""
    jauto = moe["auto"]
    tauto = _port_moe(jauto, HF_MOE, experts)
    prompts = [[7, 8, 9, 10], [20, 21, 22]]
    jeng, teng = _serve_pair(jauto, tauto, max_new=5, spec_k=3, draft=_draft_section(vocab_size=128),
                             decode_kernel="gather")
    if "spec" not in moe:
        moe["spec"] = _jax_spec_run(jeng, prompts)
    _assert_spec_parity(moe["spec"], teng, _greedy_stream(tauto, prompts, 5), prompts, k=3)


def test_qwen3_moe_mixed_stack_int8_fused_spec(monkeypatch):
    """:276, the mixed dense + MoE stack with speculative decoding over an
    int8 pool through the fused backend, held to JAX's engine and to the
    port's own fp32 non-speculative output (as JAX's test holds JAX's)."""
    monkeypatch.setenv("AUTOMODEL_FLASH_INTERPRET", "1")
    jauto = _jax_moe(HF_MOE_MIXED)
    tauto = _port_moe(jauto, HF_MOE_MIXED, "dense")
    prompts = [[7, 8, 9, 10], [20, 21]]
    base = _run(ServingEngine(tauto, ServeConfig(**SERVE), GenerationConfig(max_new_tokens=4, greedy=True)),
                prompts)
    jeng, teng = _serve_pair(jauto, tauto, max_new=4, spec_k=3, kv_cache_dtype="int8", decode_kernel="fused")
    _assert_spec_parity(_jax_spec_run(jeng, prompts), teng, [r["tokens"] for r in base], prompts, k=3)


# -- self-draft, stop tokens, rollback ----------------------------------------


def _self_draft(tauto, max_new, k, hf=None, gen=None):
    hf = hf or HF_TARGET
    draft = {"hf_config": dict(hf), "backend": dict(FP32)}
    eng = ServingEngine(
        tauto, ServeConfig(**SERVE, speculative=SpeculativeConfig(enabled=True, k=k, draft=draft)),
        GenerationConfig(**(gen or dict(max_new_tokens=max_new, greedy=True))),
    )
    eng.draft_auto.model.load_state_dict(tauto.model.state_dict())  # self-draft: identical proposals
    return eng


def test_spec_self_draft_accepts_everything_and_stamps_records(llama):
    """:363 on a draft that holds the target's weights: every proposal is
    accepted (1.0), which JAX's engine misses because its draft pool lacks
    the last proposal's row; the records, the engine counters and
    ``run_workload`` carry the spec keys; rounds count waves, not slots."""
    _, tauto = llama
    eng = _self_draft(tauto, max_new=9, k=3)
    arrivals = [(0.0, [1, 2, 3, 4, 5], 9), (0.0, [7, 8, 9], 9)]
    done, stats = eng.run_workload(arrivals)
    assert eng.spec_accept_rate == 1.0
    assert stats["accept_rate"] == 1.0
    assert stats["spec_proposed"] == stats["spec_accepted"] > 0
    assert 0 < eng.spec_rounds < eng.spec_proposed_total // 3
    assert stats["draft_tps"] > 0
    refs = _greedy_stream(tauto, [a[1] for a in arrivals], 9)
    for rec, ref in zip(sorted(done, key=lambda r: r["request_id"]), refs):
        assert rec["spec_accept_rate"] == 1.0
        assert rec["spec_accepted"] == rec["spec_proposed"]
        assert rec["tokens"] == ref


def test_spec_eos_inside_accepted_block_terminates_exactly(llama):
    """:395, a stop token committed inside an accepted block ends the
    request exactly where non-speculative decoding stops."""
    _, tauto = llama
    prompts = [[1, 2, 3, 4, 5]]
    ref = _greedy_stream(tauto, prompts, 8)[0]
    eos = ref[2]
    eng = _self_draft(tauto, 8, k=4, gen=dict(max_new_tokens=8, greedy=True, eos_token_id=int(eos)))
    (rec,) = _run(eng, prompts)
    assert rec["completion_reason"] == "stop"
    assert rec["tokens"] == ref[: ref.index(eos) + 1]
    eng.check_invariants()
    assert eng.pool.available() == eng.pool.usable_blocks


def test_spec_length_inside_accepted_block_terminates_exactly(llama):
    """The length budget reached inside an accepted block: the completion
    holds exactly max_new tokens, the non-speculative stream's."""
    _, tauto = llama
    prompts = [[4, 5, 6]]
    (rec,) = _run(_self_draft(tauto, 6, k=4), prompts)
    assert rec["completion_reason"] == "length"
    assert rec["tokens"] == _greedy_stream(tauto, prompts, 6)[0]


def test_spec_rollback_invariants_randomized_schedule():
    """:424, a noisy copy of the target as the draft gives a mixed
    accept/reject schedule; with k = 6 > block_size = 4 rejections roll
    back across block boundaries. Pool invariants hold after every step,
    the tokens are the greedy stream's, the pool drains."""
    hf = dict(HF_TARGET, num_hidden_layers=2)
    _, params, _ = jax_tiny(seed=0, hf=hf)
    tauto = torch_twin(params, hf=hf)
    prompts = _prompts(0, np.random.default_rng(0).integers(2, 9, size=6), 64)
    refs = _greedy_stream(tauto, prompts, 7)
    eng = _self_draft(tauto, 7, k=6, hf=hf)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in eng.draft_auto.model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    ids = [eng.submit(p) for p in prompts]
    done = {}
    for _ in range(10_000):
        if eng.idle():
            break
        for rec in eng.step():
            done[rec["request_id"]] = rec
        eng.check_invariants()
    assert [done[i]["tokens"] for i in ids] == refs
    assert 0 < eng.spec_accepted_total < eng.spec_proposed_total
    assert eng.pool.available() == eng.pool.usable_blocks


# -- refusals -----------------------------------------------------------------


def test_spec_config_refusals(llama):
    """:463 and the engine's other checks, with JAX's messages."""
    _, tauto = llama
    with pytest.raises(ValueError, match="needs a draft model section"):
        SpeculativeConfig(enabled=True)
    with pytest.raises(ValueError, match=r"speculative.k=0"):
        SpeculativeConfig(k=0)
    with pytest.raises(TypeError, match="unknown serving.speculative keys"):
        ServeConfig.from_dict({**SERVE, "speculative": {"enabled": False, "kk": 2}})
    with pytest.raises(ValueError, match="kv_spill cannot be enabled together with serving.speculative"):
        ServeConfig.from_dict({**SERVE, "kv_spill": {"enabled": True},
                               "speculative": {"enabled": True, "draft": _draft_section()}})

    def engine(**spec):
        return ServingEngine(tauto, ServeConfig.from_dict({**SERVE, "speculative": {"enabled": True, **spec}}),
                             GenerationConfig(max_new_tokens=4, greedy=True))

    with pytest.raises(ValueError, match="vocab_size 32 != target vocab_size 64"):
        engine(k=2, draft=_draft_section(vocab_size=32))
    with pytest.raises(ValueError, match="exceeds the draft model's context limit 40"):
        engine(k=2, draft=_draft_section(max_position_embeddings=40))
    gemma = {"hf_config": dict(architectures=["Gemma2ForCausalLM"], model_type="gemma2", vocab_size=64,
                               hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                               num_attention_heads=2, num_key_value_heads=1, head_dim=16,
                               max_position_embeddings=128), "backend": dict(FP32)}
    with pytest.raises(GenerationUnsupported, match="draft model GemmaForCausalLM has no KV-cache decode path"):
        engine(k=2, draft=gemma)
    eng = engine(k=2, draft=_draft_section())
    with pytest.raises(GenerationUnsupported, match="return_logprobs is not supported on a speculative engine"):
        eng.submit([1, 2, 3], return_logprobs=True)
    # the overhang: a request's block budget and the table cover k more rows
    assert eng.config.spec_overhang == 2
    assert eng.config.table_blocks == ServeConfig(**SERVE).table_blocks
    wide = ServeConfig.from_dict({**SERVE, "speculative": {"enabled": True, "k": 8, "draft": _draft_section()}})
    assert wide.table_blocks == -(-(48 + 9) // 4)
    eng.release_pools()
    assert eng.kv_pool is None and eng.draft_kv_pool is None


# -- the rule itself ----------------------------------------------------------


def test_greedy_verify_rule_matches_jax():
    """Greedy ``speculative_verify`` on random logits and drafts (some equal
    to the argmax, some not): tokens and n_commit equal JAX's."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 5, 16)).astype(np.float32)
    drafts = np.argmax(logits[:, :4], -1).astype(np.int32)
    drafts[1, 0] = (drafts[1, 0] + 1) % 16
    drafts[2, 2] = (drafts[2, 2] + 1) % 16
    drafts[3, 3] = (drafts[3, 3] + 3) % 16
    jt, jn = jspeculative_verify(jnp.asarray(logits), None, jnp.asarray(drafts), jax.random.key(0),
                                 JSamplingConfig(temperature=0.0))
    tt, tn = speculative_verify(torch.from_numpy(logits), None, torch.from_numpy(drafts), None,
                                SamplingConfig(temperature=0.0))
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tn.tolist() == np.asarray(jn).tolist() == [5, 1, 3, 4, 5, 5]


@pytest.mark.parametrize("config", [SamplingConfig(temperature=1.0), SamplingConfig(temperature=0.7, top_k=6)])
def test_sampled_rule_commits_the_target_distribution(config):
    """The rejection rule at V = 8 over 20,000 rows drawn from one seeded
    generator: the first committed token (an accepted d_1 or the
    correction) is distributed as the filtered target p_1, whatever the
    draft q_1 proposed from. Tolerance: 0.015 absolute per token, over 4
    standard errors at this count (sqrt(0.25 / 20000) = 0.0035). The bonus
    token, drawn after k accepted drafts equal to the target, follows
    p_(k+1) the same way."""
    n, V, k = 20_000, 8, 2
    rng = np.random.default_rng(11)
    tl = torch.from_numpy(rng.normal(size=(1, k + 1, V)).astype(np.float32) * 1.5).expand(n, k + 1, V)
    dl = torch.from_numpy(rng.normal(size=(1, k, V)).astype(np.float32) * 1.5).expand(n, k, V)
    from automodel_tpu_torch.generation.sampling import _filter_logits

    p = torch.softmax(_filter_logits(tl[0].float(), config), -1)
    q = torch.softmax(_filter_logits(dl[0].float(), config), -1)
    g = torch.Generator().manual_seed(5)
    drafts = torch.stack([torch.multinomial(q[i], n, replacement=True, generator=g) for i in range(k)], 1)
    toks, n_commit = speculative_verify(tl, dl, drafts, g, config)
    assert bool((n_commit >= 1).all()) and bool((n_commit <= k + 1).all())
    freq = torch.bincount(toks[:, 0].long(), minlength=V).float() / n
    assert float((freq - p[0]).abs().max()) < 0.015, (freq, p[0])
    # a draft that proposes from the target itself is always accepted
    # (u < p/q = 1), and the bonus follows p_(k+1)
    exact = torch.stack([torch.multinomial(p[i], n, replacement=True, generator=g) for i in range(k)], 1)
    toks, n_commit = speculative_verify(tl, tl[:, :k], exact, g, config)
    assert bool((n_commit == k + 1).all())
    freq = torch.bincount(toks[:, k].long(), minlength=V).float() / n
    assert float((freq - p[k]).abs().max()) < 0.015, (freq, p[k])


# -- Qwen3-MoE KV-cache decode --------------------------------------------------


def _jax_moe_stepwise(jauto, prompt, n_steps, capacity):
    """JAX's contiguous-cache prefill and greedy decode steps. → (per-step
    logits, tokens)."""
    model, params, cfg = jauto.model, jauto.params, jauto.model.config
    cache = jkv.init_cache(cfg.num_layers, 1, capacity, cfg.num_kv_heads, cfg.head_dim, jnp.float32)
    last, cache = jbuild_prefill_fn(lambda p, i, **kw: model(p, i, **kw))(
        params, jnp.asarray([prompt], jnp.int32), jnp.asarray([len(prompt)], jnp.int32), cache)
    logits, tokens = [np.asarray(last[0], np.float32)], [int(jnp.argmax(last[0]))]
    for _ in range(n_steps - 1):
        kvc, ctx = jkv.decode_ctx(cache)
        (out, _aux), cache = model(params, jnp.asarray([[tokens[-1]]], jnp.int32), position_ids=ctx.q_pos[:, None],
                                   cache=(kvc, ctx))
        logits.append(np.asarray(out[0, -1], np.float32))
        tokens.append(int(jnp.argmax(out[0, -1])))
    return logits, tokens


def _port_moe_stepwise(tauto, prompt, n_steps, capacity):
    model, cfg = tauto.model, tauto.model.config
    cache = kv_cache.init_cache(cfg.num_layers, 1, capacity, cfg.num_kv_heads, cfg.head_dim, torch.float32,
                                device=CPU)
    last, cache = build_prefill_fn(model)(torch.tensor([prompt]), torch.tensor([len(prompt)], dtype=torch.int32),
                                          cache)
    logits, tokens = [to_np(last[0])], [int(last[0].argmax())]
    for _ in range(n_steps - 1):
        cache, ctx = kv_cache.decode_ctx(cache)
        with torch.inference_mode():
            out, _aux = model(torch.tensor([[tokens[-1]]]), ctx.q_pos[:, None].long(),
                              cache=kv_cache.CacheLayers(cache, ctx))
        logits.append(to_np(out[0, -1]))
        tokens.append(int(out[0, -1].argmax()))
    return logits, tokens


def _port_moe_paged(tauto, prompt, tokens, backend):
    """The port's paged programs over the same stream: chunk prefill of the
    prompt (chunks of 4), then one decode forward a step feeding JAX's
    greedy tokens. → per-step logits."""
    model, cfg = tauto.model, tauto.model.config
    pool = paged.init_pool(cfg.num_layers, 16, 4, cfg.num_kv_heads, cfg.head_dim, torch.float32, device=CPU)
    table = torch.arange(1, 9, dtype=torch.int32)
    chunk = paged.build_chunk_prefill_fn(model, 4, torch.float32)
    ids = torch.tensor(prompt + [0] * (-len(prompt) % 4))
    for start in range(0, len(prompt), 4):
        last = chunk(pool, table, ids[start: start + 4], start, min(4, len(prompt) - start))
    logits = [to_np(last)]
    with torch.inference_mode():
        for i, tok in enumerate(tokens[:-1]):
            out = paged.decode_logits(
                model, pool, table[None], torch.tensor([len(prompt) + i], dtype=torch.int32),
                torch.tensor([[tok]]), torch.tensor([True]), backend=backend, block_size=4,
                compute_dtype=torch.float32,
            )
            logits.append(to_np(out[0, -1]))
    return logits


@pytest.mark.parametrize("experts", ["dense", "ragged"])
def test_qwen3_moe_prefill_decode_logits_match_jax(moe, experts):
    """test_generation.py:150 and test_serving.py:170 on the port: the
    mixed stack's prefill and 5 decode steps through the contiguous cache,
    and through the paged programs on the gather and fused backends, give
    JAX's per-step logits within fp32 1e-5 and its greedy tokens; the
    ``generate`` engine runs the family."""
    tauto = _port_moe(moe["auto"], HF_MOE, experts)
    prompt = [7, 8, 9, 10, 11, 12]
    if "stepwise" not in moe:
        moe["stepwise"] = _jax_moe_stepwise(moe["auto"], prompt, n_steps=6, capacity=16)
    jl, jt = moe["stepwise"]
    tl, tt = _port_moe_stepwise(tauto, prompt, n_steps=6, capacity=16)
    assert tt == jt
    for step, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGITS_ATOL, err_msg=f"contiguous step {step}")
    for backend in ("gather", "fused"):
        for step, (a, b) in enumerate(zip(_port_moe_paged(tauto, prompt, jt, backend), jl)):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGITS_ATOL, err_msg=f"{backend} step {step}")
    assert tauto.model.supports_kv_cache
    assert _greedy_stream(tauto, [prompt], 6) == [jt]
