"""The torch port's GPT-OSS family (automodel_tpu_torch/models/gpt_oss)
against the JAX package on the CPU: the tiny model of
tests/test_gpt_oss.py:25-41 (vocab 128, hidden 64, 2 layers, 4 heads over
2, head_dim 16, 4 experts top-2, window 8) with yarn rope and an aux
coefficient of 0.01. JAX's init zeroes every bias, the sinks and the
router's learned bias, so a parity test on that tree could not see one the
port drops: each of those leaves is filled with seeded random values before
both packages get the tree (``params_from_jax``). Checked: logits and aux
under the dense, ragged and ragged_fused experts backends and both
attention backends, a 4-step training trajectory against JAX's
build_train_step, the ``pretrain llm`` CLI on the tiny config, and the card
config's widths."""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.config import BackendConfig as JaxBackend
from automodel_tpu.models.gpt_oss import GptOssConfig as JaxGptOssConfig
from automodel_tpu.models.gpt_oss import GptOssForCausalLM as JaxGptOss
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.gpt_oss import GptOssConfig, GptOssForCausalLM, params_from_jax
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

HF_GPT_OSS_TINY = dict(
    architectures=["GptOssForCausalLM"],
    model_type="gpt_oss",
    vocab_size=128,
    hidden_size=64,
    intermediate_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=16,
    num_local_experts=4,
    num_experts_per_tok=2,
    sliding_window=8,
    max_position_embeddings=256,
    rope_theta=150000.0,
    # yarn over a short original context, so the ramp's three bands apply
    rope_scaling=dict(rope_type="yarn", factor=8.0, beta_fast=32.0, beta_slow=1.0,
                      original_max_position_embeddings=32, truncate=False),
    rms_norm_eps=1e-5,
    attention_bias=True,
    tie_word_embeddings=False,
    router_aux_loss_coef=0.01,
)
FP32 = dict(param_dtype="float32", compute_dtype="float32")
# the leaves JAX's init zeroes (gpt_oss/model.py:92-93, moe/layer.py:168-172)
_ZERO_INIT = ("bias", "linear_bias", "sinks", "gate_up_bias", "down_bias")


def _randomize_zero_init(params, seed):
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if getattr(path[-1], "key", None) in _ZERO_INIT:
            return jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, params)


def _pair(experts="ragged_fused", attn="sdpa", seed=0, trainable=False):
    kw = dict(attn=attn, experts=experts, **FP32)
    jmodel = JaxGptOss(JaxGptOssConfig.from_hf(HF_GPT_OSS_TINY), JaxBackend(**kw))
    params = _randomize_zero_init(jmodel.init(jax.random.key(seed)), seed + 100)
    tmodel = GptOssForCausalLM(GptOssConfig.from_hf(HF_GPT_OSS_TINY), BackendConfig(**kw), device=CPU,
                               trainable=trainable)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
@pytest.mark.parametrize("experts", ["dense", "ragged", "ragged_fused"])
def test_logits_and_aux_match_jax(experts, attn, monkeypatch):
    """fp32 logits to 1e-5, expert counts exactly, aux loss to 1e-6
    relative. JAX's ragged and ragged_fused backends run their Pallas
    kernels interpreted; its flash falls back to sdpa on the CPU, where the
    port's runs the flash kernels' plain version with the sinks folded."""
    monkeypatch.setenv("AUTOMODEL_GMM_INTERPRET", "1")
    jmodel, params, tmodel = _pair(experts, attn)
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 16)).astype(np.int32)
    jlogits, jaux = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, taux = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_array_equal(taux.expert_counts.numpy(), np.asarray(jaux.expert_counts))
    assert int(taux.expert_counts.sum()) == 2 * 2 * 16 * 2  # L*B*S*K
    np.testing.assert_allclose(float(taux.aux_loss), float(jaux.aux_loss), rtol=1e-6)


def test_config_and_weight_carry_cover_every_parameter():
    """from_hf reads the gpt-oss fingerprint as JAX does; params_from_jax
    fills every parameter (sinks, biases and the router's learned bias
    included) under HF names; the backends and decode the port does not
    have raise by name."""
    cfg = GptOssConfig.from_hf(HF_GPT_OSS_TINY)
    jcfg = JaxGptOssConfig.from_hf(HF_GPT_OSS_TINY)
    assert cfg.layer_types == jcfg.layer_types == ("sliding_attention", "full_attention")
    assert (cfg.sliding_window, cfg.head_dim, cfg.attention_bias, cfg.rope.scaling) == (8, 16, True, "yarn")
    moe = cfg.moe
    assert moe.activation == "swiglu_oai" and moe.expert_mlp_bias and moe.router_linear_bias
    assert not moe.softmax_before_topk and not moe.interleaved_gate_up and moe.aux_loss_coeff == 0.01
    _, _, tmodel = _pair()
    sd = tmodel.state_dict()
    assert set(sd) == set(params_from_jax(jax.device_get(_pair()[1])))
    assert tuple(sd["model.layers.0.self_attn.sinks"].shape) == (4,)
    assert tuple(sd["model.layers.1.self_attn.o_proj.bias"].shape) == (64,)
    assert tuple(sd["model.layers.0.mlp.router.weight"].shape) == (4, 64)
    assert tuple(sd["model.layers.0.mlp.router.linear_bias"].shape) == (4,)
    assert tuple(sd["model.layers.1.mlp.experts.gate_up_bias"].shape) == (4, 64)
    assert tuple(sd["model.layers.1.mlp.experts.down_bias"].shape) == (4, 64)
    assert all(v.abs().sum() > 0 for k, v in sd.items() if k.endswith(("bias", "sinks")))
    for experts in ("gspmd", "a2a", "a2a_fused"):
        with pytest.raises(ValueError, match=experts):
            GptOssForCausalLM(cfg, BackendConfig(experts=experts), device=CPU)
    with pytest.raises(ValueError, match="cache"):
        tmodel.hidden(torch.zeros(1, 4, dtype=torch.long), cache=object())


def test_init_weights_draws_the_jax_scales_and_zeroes_biases_and_sinks():
    model = GptOssForCausalLM(GptOssConfig.from_hf(HF_GPT_OSS_TINY), BackendConfig(experts="ragged_fused", **FP32),
                              device=CPU)
    model.init_weights(torch.Generator().manual_seed(0))
    p = dict(model.named_parameters())
    for name, t in p.items():
        if name.endswith(("bias", "sinks")):
            assert torch.equal(t, torch.zeros_like(t)), name
    # fan_in D for the router and gate_up, I for down (std within 10%)
    assert abs(float(p["model.layers.0.mlp.experts.gate_up"].std()) * 64**0.5 - 1) < 0.1
    assert abs(float(p["model.layers.0.mlp.experts.down"].std()) * 32**0.5 - 1) < 0.1
    assert abs(float(p["model.layers.0.mlp.router.weight"].std()) * 64**0.5 - 1) < 0.2


OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0,
           lr_schedule=dict(style="cosine", warmup_steps=2, decay_steps=8))


def _batches(n_steps, accum, seed=11):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=HF_GPT_OSS_TINY["vocab_size"], seq_length=16, num_samples=64, seed=seed)
    out = []
    for s in range(n_steps):
        group = [default_collater([ds[(s * accum + a) * 2 + i] for i in range(2)]) for a in range(accum)]
        out.append({k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)})
    return out


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
def test_train_step_trajectory_matches_jax(attn):
    """4 optimizer steps, grad_acc_steps 2, fused_linear_ce, the aux loss in
    the objective, experts ragged_fused: per-step loss, grad norm,
    moe_aux_loss and expert_load_imbalance to fp32 atol 1e-5, and every
    weight after step 4 (sinks, biases and the router's bias included).
    JAX's ragged_fused runs its XLA reference composition here (its Pallas
    kernels are held to it by tests/test_fused_backward.py), and its flash
    falls back to sdpa on the CPU."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.optim.scheduler import build_lr_schedule
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    jmodel, params, tmodel = _pair("ragged_fused", attn, trainable=True)
    jopt = jax_optimizer(**OPT)
    jstate = JaxState.create(params, jax.jit(jopt.init)(params))
    jfn = jax_step(jax_loss(jmodel, loss="fused_linear_ce"), jopt, jax_schedule(lr=OPT["lr"], **OPT["lr_schedule"]),
                   donate=False)
    tparams = list(tmodel.parameters())
    tstate = TrainState(params=tparams, optimizer=build_optimizer(tparams, **OPT))
    tfn = build_train_step(make_causal_lm_loss(tmodel, loss="fused_linear_ce"),
                           build_lr_schedule(lr=OPT["lr"], **OPT["lr_schedule"]))
    for i, batch in enumerate(_batches(4, accum=2)):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "moe_aux_loss", "expert_load_imbalance"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=1e-5, err_msg=f"{key}, step {i + 1}")
        assert not bool(tm["nonfinite"])
    want = params_from_jax(jax.device_get(jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_pretrain_gpt_oss_tiny_on_cpu_logs_a_falling_loss(tmp_path):
    from automodel_tpu_torch.cli import app

    metrics = tmp_path / "train_metrics.jsonl"
    cfg = os.path.join(REPO, "automodel_tpu_torch", "configs", "gpt_oss_tiny_cpu.yaml")
    assert app.main(["pretrain", "llm", "-c", cfg, "--device=cpu", f"--logging.metrics_path={metrics}"]) == 0
    rows = [r for r in map(json.loads, metrics.read_text().splitlines()) if "event" not in r]
    assert [r["step"] for r in rows] == list(range(1, 9))
    for r in rows:
        assert r["expert_load_imbalance"] >= 1.0 and r["nonfinite"] is False and r["moe_aux_loss"] != 0
        assert len(r["expert_load_imbalance_per_layer"]) == 2
    assert rows[-1]["loss"] < rows[0]["loss"] - 0.5


def test_the_20b_config_keeps_the_published_widths_and_chip_smoke_carries_it():
    """The card config: gpt-oss-20b's widths cut to 3 layers (sliding, full,
    sliding), 3,627,830,688 parameters by the model's own shapes (built on
    the meta device); chip_smoke.py carries it as a dict."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import check_sections

    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "pretrain_gpt_oss_20b.yaml"))
    check_sections(cfg)
    mc = GptOssConfig.from_hf(cfg.model.hf_config.to_dict())
    assert (mc.hidden_size, mc.num_heads, mc.num_kv_heads, mc.head_dim, mc.vocab_size) == (2880, 64, 8, 64, 201088)
    assert (mc.moe.num_experts, mc.moe.num_experts_per_tok, mc.moe.moe_intermediate_size) == (32, 4, 2880)
    assert mc.layer_types == ("sliding_attention", "full_attention", "sliding_attention")
    assert (mc.sliding_window, mc.rope.scaling, mc.rope.factor, mc.rope.theta, mc.rms_eps) == (
        128, "yarn", 32.0, 150000.0, 1e-5)
    backend = BackendConfig.from_dict(cfg.model.backend.to_dict())
    assert (backend.experts, backend.attn, backend.param_dtype) == ("ragged_fused", "flash", "bfloat16")
    model = GptOssForCausalLM(mc, dataclasses.replace(backend), device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == 3_627_830_688
    assert cfg.step_scheduler.grad_acc_steps == 2 and cfg.dataset.seq_length == 4096
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.PRETRAIN_GPT_OSS_20B == cfg.to_dict()
