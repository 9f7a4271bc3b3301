"""The torch port's DeepSeek-V3 (automodel_tpu_torch/models/deepseek_v3)
against the JAX package on the CPU, at the sizes of tests/test_deepseek_v3.py
(3 layers, the first dense, 8 experts with grouped sigmoid routing and a
shared expert; MLA with kv_lora_rank 16, 16 nope + 8 rope channels, v 16):
logits and aux with ``q_lora_rank`` 32 and null under ``sdpa`` and
``flash`` (the flash kernels' plain versions at head_dim 24, v padded from
16), one train step's loss, grad norm and aux, yarn's ``mla_attn_scale``,
the HF adapter both ways with JAX's key set, the registry and ``pretrain
llm`` on the tiny YAML. Weights come from the JAX init (its zero router
bias and unit norm scales filled with random values first) and are carried
by ``params_from_jax``; inputs are made with numpy. fp32, atol 1e-5 unless
a test says otherwise."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.config import BackendConfig as JaxBackend
from automodel_tpu.models.deepseek_v3 import DeepseekV3Config as JaxConfig
from automodel_tpu.models.deepseek_v3 import DeepseekV3ForCausalLM as JaxModel
from automodel_tpu.models.deepseek_v3 import DeepseekV3StateDictAdapter as JaxAdapter
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM, params_from_jax
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FP32 = dict(param_dtype="float32", compute_dtype="float32")

HF_DSV3_TINY = dict(
    architectures=["DeepseekV3ForCausalLM"],
    model_type="deepseek_v3",
    vocab_size=128,
    hidden_size=64,
    intermediate_size=128,
    moe_intermediate_size=32,
    num_hidden_layers=3,
    num_attention_heads=4,
    num_key_value_heads=4,
    n_routed_experts=8,
    num_experts_per_tok=2,
    n_shared_experts=1,
    n_group=4,
    topk_group=2,
    first_k_dense_replace=1,
    norm_topk_prob=True,
    routed_scaling_factor=2.5,
    topk_method="noaux_tc",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    max_position_embeddings=256,
    tie_word_embeddings=False,
)
YARN = dict(rope_scaling=dict(type="yarn", factor=40.0, original_max_position_embeddings=64, beta_fast=32,
                              beta_slow=1, mscale=1.0, mscale_all_dim=1.0))


def _randomize(params, seed):
    """The router's correction bias and every norm scale (zeros and ones
    in JAX's init) filled with seeded random values."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        key = getattr(path[-1], "key", None)
        if key == "bias":
            return jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
        if key == "scale":
            return jnp.asarray(1.0 + rng.normal(size=x.shape) * 0.2, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, params)


def _pair(attn="sdpa", hf=None, seed=0, trainable=False, experts="ragged"):
    hf = hf or HF_DSV3_TINY
    kw = dict(attn=attn, experts=experts, **FP32)
    jmodel = JaxModel(JaxConfig.from_hf(hf), JaxBackend(**kw))
    params = _randomize(jmodel.init(jax.random.key(seed)), seed + 100)
    tmodel = DeepseekV3ForCausalLM(DeepseekV3Config.from_hf(hf), BackendConfig(**kw), device=CPU, trainable=trainable)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel


def test_from_hf_fields_match_jax():
    for hf in (HF_DSV3_TINY, dict(HF_DSV3_TINY, q_lora_rank=None, **YARN)):
        want, got = JaxConfig.from_hf(hf), DeepseekV3Config.from_hf(hf)
        w, g = dataclasses.asdict(want), dataclasses.asdict(got)
        # JAX's dense config has two fields the port leaves out (encoder and
        # minimax variants), at their defaults here
        assert {k: w.pop(k) for k in set(w) - set(g)} == {"causal": True, "qk_norm_flat": False}
        assert g == w
        assert (got.qk_head_dim, got.mla_attn_scale) == (want.qk_head_dim, want.mla_attn_scale)
    moe = DeepseekV3Config.from_hf(HF_DSV3_TINY).moe
    assert moe.score_func == "sigmoid" and moe.expert_bias and moe.bias_update_factor == 1e-3
    assert moe.num_dense_layers == 1 and moe.route_scale == 2.5 and (moe.n_group, moe.topk_group) == (4, 2)


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
@pytest.mark.parametrize("q_lora_rank", [32, None])
def test_logits_and_aux_match_jax(q_lora_rank, attn):
    """Logits to 1e-5, the expert counts exactly, the aux loss to 1e-6
    relative. Under ``flash`` the port runs the flash kernels' plain
    versions at head_dim 24 with v padded from 16 (JAX's flash on the
    CPU takes its XLA attention, the same function)."""
    hf = dict(HF_DSV3_TINY, q_lora_rank=q_lora_rank, router_aux_loss_coef=0.01)
    jmodel, params, tmodel = _pair(attn, hf=hf, seed=1 if q_lora_rank else 2)
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 16)).astype(np.int32)
    jlogits, jaux = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, taux = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_array_equal(taux.expert_counts.numpy(), np.asarray(jaux.expert_counts))
    assert tuple(taux.expert_counts.shape) == (2, 8)
    np.testing.assert_allclose(float(taux.aux_loss), float(jaux.aux_loss), rtol=1e-6)


def test_yarn_mla_attn_scale_matches_jax():
    """A yarn rope (factor 40, mscale_all_dim 1): the softmax scale carries
    mscale squared, the rope tables yarn's frequencies; logits to 1e-5."""
    hf = dict(HF_DSV3_TINY, **YARN)
    jmodel, params, tmodel = _pair("flash", hf=hf, seed=3)
    m = 0.1 * np.log(40.0) + 1.0
    assert tmodel.config.mla_attn_scale == pytest.approx(24**-0.5 * m * m, rel=1e-12)
    ids = np.random.default_rng(4).integers(0, 128, size=(1, 32)).astype(np.int32)
    jlogits, _ = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, _ = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)


OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0)


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
def test_train_step_matches_jax(attn):
    """One optimizer step over 2 microbatches (fused_linear_ce, the aux
    loss in the objective): loss, grad norm, moe_aux_loss and the expert
    load imbalance to 1e-5, the router's correction bias moved by
    ``post_step_fn`` as JAX's, and the weights after the step."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    hf = dict(HF_DSV3_TINY, router_aux_loss_coef=0.01)
    jmodel, params, tmodel = _pair(attn, hf=hf, seed=5, trainable=True)
    jopt = jax_optimizer(**OPT)
    jstate = JaxState.create(params, jax.jit(jopt.init)(params))
    jfn = jax_step(jax_loss(jmodel, loss="fused_linear_ce"), jopt, None, donate=False, post_step_fn=jmodel.post_step_fn)
    tparams = list(tmodel.parameters())
    tstate = TrainState(params=tparams, optimizer=build_optimizer(tparams, **OPT))
    tfn = build_train_step(make_causal_lm_loss(tmodel, loss="fused_linear_ce"), None, post_step_fn=tmodel.post_step_fn)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 128, size=(2, 2, 16)).astype(np.int32)
    labels = np.where(rng.random((2, 2, 16)) < 0.2, -100, rng.integers(0, 128, size=(2, 2, 16))).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels}
    jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "moe_aux_loss", "expert_load_imbalance"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=1e-5, err_msg=key)
    # the weights after the step: AdamW moves an element by about lr, and
    # where its gradient is near zero a last-bit difference in it moves
    # m / sqrt(v) visibly (one lm_head element 1.1e-5 apart): 5e-5, a
    # twentieth of the step
    want = params_from_jax(jax.device_get(jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-5, err_msg=k)
    before = params_from_jax(jax.device_get(params))
    assert not torch.equal(got["model.layers.1.mlp.gate.bias"], before["model.layers.1.mlp.gate.bias"])


@pytest.mark.parametrize("q_lora_rank", [32, None])
def test_hf_adapter_both_ways_matches_jax(q_lora_rank):
    """The port's HF export has JAX's key set and tensors (MLA keys, the
    correction bias, per-expert Linears); loading JAX's export gives back
    the carried state dict."""
    hf = dict(HF_DSV3_TINY, q_lora_rank=q_lora_rank)
    _, params, tmodel = _pair(hf=hf, seed=7)
    jcfg = JaxConfig.from_hf(hf)
    want = {k: np.asarray(v) for k, v in JaxAdapter(jcfg).to_hf(jax.device_get(params))}
    adapter = tmodel.state_dict_adapter(tmodel)
    got = {k: v.numpy() for k, v in adapter.to_hf(tmodel.state_dict())}
    assert set(got) == set(want)
    assert any("kv_a_proj_with_mqa" in k for k in got) and any(k.endswith("e_score_correction_bias") for k in got)
    assert any("q_a_layernorm" in k for k in got) == bool(q_lora_rank)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = adapter.from_hf(lambda k: torch.from_numpy(want[k]))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(back[k], v), k


def test_registry_builds_it_and_refuses_the_cache():
    from automodel_tpu_torch.auto_model import from_config

    auto = from_config(HF_DSV3_TINY, BackendConfig(attn="flash", experts="ragged_fused", **FP32), device="cpu")
    model = auto.model
    assert isinstance(model, DeepseekV3ForCausalLM) and model.rope_dim == 8
    assert not hasattr(model.model.layers[0].mlp, "experts") and hasattr(model.model.layers[2].mlp, "experts")
    assert tuple(model.model.layers[1].self_attn.kv_a_proj_with_mqa.weight.shape) == (16 + 8, 64)
    with pytest.raises(ValueError, match="cache"):
        model.hidden(torch.zeros(1, 4, dtype=torch.long), cache=object())


def test_pretrain_tiny_on_cpu_logs_a_falling_loss(tmp_path):
    """``pretrain llm`` on configs/deepseek_v3_tiny_cpu.yaml (attn: flash,
    experts: ragged_fused through their plain versions): 8 steps, a loss
    falling by more than 0.3 (6.02 -> 5.57 on this seed)."""
    from automodel_tpu_torch.cli import app

    metrics = tmp_path / "train_metrics.jsonl"
    cfg = os.path.join(REPO, "automodel_tpu_torch", "configs", "deepseek_v3_tiny_cpu.yaml")
    assert app.main(["pretrain", "llm", "-c", cfg, f"--logging.metrics_path={metrics}"]) == 0
    rows = [r for r in map(json.loads, metrics.read_text().splitlines()) if "event" not in r]
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert all(len(r["expert_load_imbalance_per_layer"]) == 2 and not r["nonfinite"] for r in rows)
    assert rows[-1]["loss"] < rows[0]["loss"] - 0.3


def test_the_moonlight_config_keeps_the_published_widths():
    """The card config: Moonlight-16B-A3B's config.json widths at 7
    layers, 4,263,151,104 parameters by the model's own shapes (built on
    the meta device), K1's head_dim 192; chip_smoke.py carries it as a
    dict (the card has no PyYAML)."""
    import importlib.util

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import check_sections

    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "pretrain_moonlight_16b_a3b.yaml"))
    check_sections(cfg)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.PRETRAIN_MOONLIGHT_16B_A3B == cfg.to_dict()
    mc = DeepseekV3Config.from_hf(cfg.model.hf_config.to_dict())
    assert (mc.hidden_size, mc.num_heads, mc.vocab_size, mc.q_lora_rank, mc.kv_lora_rank) == (2048, 16, 163840, None, 512)
    assert (mc.qk_head_dim, mc.v_head_dim, mc.rope_dim or mc.qk_rope_head_dim) == (192, 128, 64)
    moe = mc.moe
    assert (moe.num_experts, moe.num_experts_per_tok, moe.moe_intermediate_size, moe.num_shared_experts) == (64, 6, 1408, 2)
    assert (moe.score_func, moe.expert_bias, moe.route_scale, moe.num_dense_layers) == ("sigmoid", True, 2.446, 1)
    backend = BackendConfig.from_dict(cfg.model.backend.to_dict())
    assert (backend.attn, backend.experts) == ("flash", "ragged_fused")
    model = DeepseekV3ForCausalLM(mc, backend, device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == 4_263_151_104
    assert cfg.step_scheduler.grad_acc_steps == 2 and cfg.dataset.seq_length == 4096
