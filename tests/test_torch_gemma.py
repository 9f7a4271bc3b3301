"""The torch port's Gemma family (automodel_tpu_torch/models/gemma) against
the JAX package on the CPU, at the tiny configs of tests/test_gemma.py:19-44
(vocab 128, hidden 64, 4 heads over 2, head_dim 16, window 8,
query_pre_attn_scalar 16): Gemma 2 with 4 layers and the attention and
final soft caps of 50 and 30, Gemma 3 text with 7 layers (a global layer
at 6), q/k norms and a local rope theta. JAX's init zeroes every norm
scale, which a port that dropped Gemma's ``1 + w`` would not show, so the
scales are filled with seeded random values before both packages get the
tree (``params_from_jax``). Checked: logits under ``attn: sdpa`` and
``attn: flash`` (the flash kernels' plain versions, the cap applied inside
them), a 4-step training trajectory against JAX's build_train_step, the
weight carry, the bf16 embedding scale, and the card config's widths."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.config import BackendConfig as JaxBackend
from automodel_tpu.models.gemma import GemmaConfig as JaxGemmaConfig
from automodel_tpu.models.gemma import GemmaForCausalLM as JaxGemma
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.gemma import GemmaConfig, GemmaForCausalLM, params_from_jax
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, max_position_embeddings=256, sliding_window=8,
             query_pre_attn_scalar=16)
HF_TINY = {
    "gemma2": dict(_TINY, architectures=["Gemma2ForCausalLM"], model_type="gemma2", num_hidden_layers=4,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0),
    "gemma3": dict(_TINY, architectures=["Gemma3ForCausalLM"], model_type="gemma3_text", num_hidden_layers=7,
                   rope_theta=1_000_000.0, rope_local_base_freq=10_000.0),
}
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _randomize_norms(params, seed):
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if getattr(path[-1], "key", None) == "scale":
            return jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, params)


def _pair(which, attn="sdpa", seed=0, trainable=False):
    hf = HF_TINY[which]
    jmodel = JaxGemma(JaxGemmaConfig.from_hf(hf), JaxBackend(attn=attn, **FP32))
    params = _randomize_norms(jmodel.init(jax.random.key(seed)), seed + 100)
    tmodel = GemmaForCausalLM(GemmaConfig.from_hf(hf), BackendConfig(attn=attn, **FP32), device=CPU,
                              trainable=trainable)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
@pytest.mark.parametrize("which", ["gemma2", "gemma3"])
def test_logits_match_jax(which, attn):
    """fp32 logits to 1e-5 over 32 tokens (four windows of 8). JAX's flash
    falls back to sdpa on the CPU at head_dim 16 (the soft cap included);
    the port's runs the flash kernels' plain versions with the cap inside."""
    jmodel, params, tmodel = _pair(which, attn)
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 32)).astype(np.int32)
    jlogits = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    if which == "gemma2":  # the final cap of 30 is applied
        assert float(tlogits.abs().max()) < 30.0


def test_config_and_weight_carry_cover_every_parameter():
    """from_hf reads the family's fingerprint as JAX does; params_from_jax
    fills every parameter under HF names and refuses a leaf it does not
    know."""
    for which in ("gemma2", "gemma3"):
        cfg, jcfg = GemmaConfig.from_hf(HF_TINY[which]), JaxGemmaConfig.from_hf(HF_TINY[which])
        for f in ("layer_types", "rope_local_theta", "query_pre_attn_scalar", "embed_scale", "logits_soft_cap",
                  "attn_soft_cap", "sliding_window", "qk_norm", "tie_embeddings", "act", "head_dim"):
            assert getattr(cfg, f) == getattr(jcfg, f), (which, f)
    cfg2 = GemmaConfig.from_hf(HF_TINY["gemma2"])
    assert cfg2.layer_types[:2] == ("sliding_attention", "full_attention") and cfg2.embed_scale == 8.0
    assert (cfg2.attn_soft_cap, cfg2.logits_soft_cap, cfg2.act) == (50.0, 30.0, "gelu_pytorch_tanh")
    cfg3 = GemmaConfig.from_hf(HF_TINY["gemma3"])
    assert cfg3.qk_norm and cfg3.layer_types[5] == "full_attention" and cfg3.layer_types[6] == "sliding_attention"
    assert GemmaConfig.from_hf(dict(HF_TINY["gemma2"], hidden_activation=None, hidden_act="gelu")).act == (
        "gelu_pytorch_tanh")
    for which in ("gemma2", "gemma3"):
        _, params, tmodel = _pair(which)
        sd = tmodel.state_dict()
        carried = params_from_jax(jax.device_get(params))
        assert set(sd) == set(carried)
        assert ("model.layers.0.self_attn.q_norm.weight" in sd) == (which == "gemma3")
        assert "lm_head.weight" not in sd and "model.layers.3.pre_feedforward_layernorm.weight" in sd
    tree = jax.device_get(params)
    tree["layers"]["attn"]["sinks"] = np.zeros((7, 4), np.float32)
    with pytest.raises(ValueError, match="layers/attn/sinks"):
        params_from_jax(tree)
    with pytest.raises(ValueError, match="cache"):
        tmodel.hidden(torch.zeros(1, 4, dtype=torch.long), cache=object())


def test_init_weights_zero_centered_norms_and_the_registry():
    """Norms init at 0 (a scale of one under ``1 + w``); both text
    architectures build through the registry, the vision-language Gemma 3
    is refused by name."""
    from automodel_tpu_torch import auto_model

    auto = auto_model.from_config(HF_TINY["gemma3"], dict(FP32), device="cpu", seed=0)
    model = auto.model
    assert isinstance(model, GemmaForCausalLM)
    p = dict(model.named_parameters())
    assert all(torch.equal(t, torch.zeros_like(t)) for n, t in p.items() if n.endswith("norm.weight"))
    assert abs(float(p["model.layers.0.mlp.down_proj.weight"].std()) * 128**0.5 - 1) < 0.1
    assert abs(float(p["model.embed_tokens.weight"].std()) / 0.02 - 1) < 0.1
    assert isinstance(auto_model.from_config(HF_TINY["gemma2"], dict(FP32), device="cpu").model, GemmaForCausalLM)
    with pytest.raises(ValueError, match="Gemma3ForConditionalGeneration"):
        auto_model.from_config(dict(HF_TINY["gemma3"], architectures=["Gemma3ForConditionalGeneration"]),
                               dict(FP32), device="cpu")


def test_bf16_embedding_scale_is_rounded_first_as_in_jax(monkeypatch):
    """At Gemma 2 9B's hidden 3584, sqrt(3584) = 59.866 is cast to bf16
    (59.75: bf16 steps by 0.25 there) before the product, as JAX's ``h *
    jnp.asarray(embed_scale, cd)`` does: the first layer sees the bf16
    embedding times exactly 59.75, as JAX computes it."""
    hf = dict(HF_TINY["gemma2"], hidden_size=3584, intermediate_size=8, num_attention_heads=1,
              num_key_value_heads=1, num_hidden_layers=2, vocab_size=16)
    assert float(jnp.asarray(3584**0.5, jnp.bfloat16)) == 59.75
    model = GemmaForCausalLM(GemmaConfig.from_hf(hf), BackendConfig(param_dtype="float32", compute_dtype="bfloat16"),
                             device=CPU)
    model.init_weights(torch.Generator().manual_seed(0))
    seen = []
    monkeypatch.setattr(GemmaForCausalLM, "_layer", lambda self, i, layer, h, *a: seen.append(h) or h)
    ids = torch.arange(16)[None]
    model.hidden(ids)
    emb = model.model.embed_tokens.weight[ids]
    want = jnp.asarray(emb.numpy(), jnp.bfloat16) * jnp.asarray(3584**0.5, jnp.bfloat16)
    assert seen[0].dtype == torch.bfloat16
    assert np.array_equal(seen[0].float().numpy(), np.asarray(want, np.float32))
    assert not torch.equal(seen[0], (emb * 3584**0.5).to(torch.bfloat16))  # the fp32 product rounds elsewhere


OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0,
           lr_schedule=dict(style="cosine", warmup_steps=2, decay_steps=8))


def _batches(n_steps, accum, seed=11):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=128, seq_length=24, num_samples=64, seed=seed)
    out = []
    for s in range(n_steps):
        group = [default_collater([ds[(s * accum + a) * 2 + i] for i in range(2)]) for a in range(accum)]
        out.append({k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)})
    return out


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
def test_train_step_trajectory_matches_jax(attn):
    """Gemma 2, 4 optimizer steps, grad_acc_steps 2, fused_linear_ce with
    the final cap of 30: per-step loss and grad norm to fp32 atol 1e-5, and
    every weight after step 4 (JAX's flash falls back to sdpa here)."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.optim.scheduler import build_lr_schedule
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    jmodel, params, tmodel = _pair("gemma2", attn, trainable=True)
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
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=1e-5, err_msg=f"{key}, step {i + 1}")
        assert not bool(tm["nonfinite"])
    want = params_from_jax(jax.device_get(jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_the_9b_config_keeps_the_published_widths_and_chip_smoke_carries_it():
    """The card config: google/gemma-2-9b's widths cut to 8 layers (sliding
    and full alternating), 2,503,069,184 parameters by the model's own
    shapes (built on the meta device); chip_smoke.py carries it as a dict."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import check_sections

    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "pretrain_gemma2_9b.yaml"))
    check_sections(cfg)
    hf = cfg.model.hf_config.to_dict()
    assert hf["architectures"] == ["Gemma2ForCausalLM"] and hf["model_type"] == "gemma2"
    mc = GemmaConfig.from_hf(hf)
    assert (mc.vocab_size, mc.hidden_size, mc.intermediate_size) == (256000, 3584, 14336)
    assert (mc.num_heads, mc.num_kv_heads, mc.head_dim, mc.query_pre_attn_scalar) == (16, 8, 256, 256)
    assert (mc.attn_soft_cap, mc.logits_soft_cap, mc.sliding_window) == (50.0, 30.0, 4096)
    assert (mc.rope.theta, mc.rms_eps, mc.act, mc.tie_embeddings, mc.max_position_embeddings) == (
        10000.0, 1e-6, "gelu_pytorch_tanh", True, 8192)
    assert mc.layer_types == ("sliding_attention", "full_attention") * 4
    backend = BackendConfig.from_dict(cfg.model.backend.to_dict())
    assert (backend.attn, backend.param_dtype, backend.compute_dtype) == ("flash", "bfloat16", "bfloat16")
    model = GemmaForCausalLM(mc, dataclasses.replace(backend), device=torch.device("meta"))
    n_layer = sum(p.numel() for p in model.model.layers[0].parameters())
    assert n_layer == 198_195_200 and model.model.embed_tokens.weight.numel() == 917_504_000
    assert sum(p.numel() for p in model.parameters()) == 2_503_069_184
    assert cfg.dataset.seq_length == 8192 and cfg.step_scheduler.grad_acc_steps == 2
    assert cfg.loss_fn.name == "fused_linear_ce" and cfg.optimizer.lr == 1e-4
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.PRETRAIN_GEMMA2_9B == cfg.to_dict()
