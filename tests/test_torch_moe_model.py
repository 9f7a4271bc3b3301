"""The torch port's Qwen3-MoE family (automodel_tpu_torch/models/qwen3_moe)
against the JAX package on the CPU: logits and aux of the tiny model of
tests/test_moe_model.py (with aux coefficient 0.001) under the ragged and
dense experts backends, the weight carry, the aux-free bias update, a
4-step training trajectory against JAX's build_train_step, and the
``pretrain llm`` CLI on the tiny config. Weights come from the JAX init
and are carried by ``params_from_jax``; batches are made with numpy."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.config import BackendConfig as JaxBackend
from automodel_tpu.models.qwen3_moe import MoEForCausalLM as JaxMoE
from automodel_tpu.models.qwen3_moe import MoETransformerConfig as JaxMoEConfig
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.qwen3_moe import MoEForCausalLM, MoETransformerConfig, params_from_jax
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

HF_MOE_TINY = dict(
    architectures=["Qwen3MoeForCausalLM"],
    model_type="qwen3_moe",
    vocab_size=128,
    hidden_size=64,
    intermediate_size=128,
    moe_intermediate_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=16,
    num_experts=8,
    num_experts_per_tok=2,
    norm_topk_prob=True,
    max_position_embeddings=256,
    tie_word_embeddings=False,
    router_aux_loss_coef=0.001,
)
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _pair(experts="ragged", hf=None, seed=0, trainable=False, fake_gate=False):
    hf = hf or HF_MOE_TINY
    kw = dict(attn="sdpa", experts=experts, fake_balanced_gate=fake_gate, **FP32)
    jmodel = JaxMoE(JaxMoEConfig.from_hf(hf), JaxBackend(**kw))
    params = jmodel.init(jax.random.key(seed))
    tmodel = MoEForCausalLM(MoETransformerConfig.from_hf(hf), BackendConfig(**kw), device=CPU, trainable=trainable)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("experts", ["ragged", "dense", "ragged_fused"])
def test_logits_and_aux_match_jax(experts, monkeypatch):
    """fp32 logits to 1e-5, expert counts exactly, aux loss to 1e-6
    relative; JAX's ragged and ragged_fused backends through their Pallas
    kernels (interpreted)."""
    monkeypatch.setenv("AUTOMODEL_GMM_INTERPRET", "1")
    jmodel, params, tmodel = _pair(experts)
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 16)).astype(np.int32)
    jlogits, jaux = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, taux = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_array_equal(taux.expert_counts.numpy(), np.asarray(jaux.expert_counts))
    assert int(taux.expert_counts.sum()) == 2 * 2 * 16 * 2  # L*B*S*K
    np.testing.assert_allclose(float(taux.aux_loss), float(jaux.aux_loss), rtol=1e-6)


def test_fake_balanced_gate_backend_matches_jax():
    """``backend.fake_balanced_gate``: every expert gets the same load, the
    aux loss is zero, and the logits match JAX's (fp32, 1e-5)."""
    jmodel, params, tmodel = _pair("ragged", fake_gate=True)
    ids = np.random.default_rng(2).integers(0, 128, size=(2, 16)).astype(np.int32)
    jlogits, _ = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, taux = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    assert torch.equal(taux.expert_counts, torch.full((2, 8), 2 * 16 * 2 // 8, dtype=torch.int32))
    assert float(taux.aux_loss) == 0.0


def test_dense_prefix_layers_match_jax():
    hf = dict(HF_MOE_TINY, num_hidden_layers=3, first_k_dense_replace=1)
    jmodel, params, tmodel = _pair("dense", hf=hf, seed=1)
    assert "dense_layers" in params and not hasattr(tmodel.model.layers[0].mlp, "experts")
    ids = np.random.default_rng(1).integers(0, 128, size=(1, 12)).astype(np.int32)
    jlogits, jaux = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, taux = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    assert tuple(taux.expert_counts.shape) == (2, 8)


def test_params_from_jax_covers_every_parameter_and_refusals():
    _, _, tmodel = _pair()
    sd = tmodel.state_dict()
    assert tuple(sd["model.layers.1.mlp.experts.gate_up"].shape) == (8, 64, 64)
    assert tuple(sd["model.layers.1.mlp.experts.down"].shape) == (8, 32, 64)
    assert tuple(sd["model.layers.0.mlp.gate.weight"].shape) == (8, 64)
    for experts in ("gspmd", "a2a", "a2a_fused"):
        with pytest.raises(ValueError, match=experts):
            MoEForCausalLM(MoETransformerConfig.from_hf(HF_MOE_TINY), BackendConfig(experts=experts), device=CPU)
    # Qwen3-MoE decodes with a cache; a family without the path (GPT-OSS
    # sets the flag off) refuses cache=
    assert MoEForCausalLM.supports_kv_cache
    tmodel.supports_kv_cache = False
    with pytest.raises(ValueError, match="cache"):
        tmodel.hidden(torch.zeros(1, 4, dtype=torch.long), cache=object())
    for model_type in ("glm4_moe", "qwen2_moe"):
        with pytest.raises(ValueError, match=model_type):
            MoETransformerConfig.from_hf(dict(HF_MOE_TINY, model_type=model_type))


def test_aux_free_bias_update_matches_jax():
    """A DeepSeek-V3-style config (sigmoid scores, selection bias, bias
    update factor 0.001): post_step_fn moves each layer's bias as JAX's."""
    hf = dict(HF_MOE_TINY, topk_method="noaux_tc", scoring_func="sigmoid")
    jmodel, params, tmodel = _pair("dense", hf=hf, seed=2)
    assert jmodel.config.moe.bias_update_factor == 0.001
    counts = np.random.default_rng(3).integers(0, 20, size=(2, 8)).astype(np.int32)
    want = jmodel.post_step_fn(params, {"expert_counts": jnp.asarray(counts)})["moe_layers"]["moe"]["router"]["bias"]
    tmodel.post_step_fn({"expert_counts": torch.from_numpy(counts)})
    got = np.stack([b.gate.bias.numpy() for b in tmodel.moe_layers()])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-7)


def test_last_layer_expert_fed_only_unlabeled_rows_gets_exactly_zero_grad(monkeypatch):
    """The rule chip_smoke.py's MoE training phase checks moved expert
    slabs by: in the last MoE layer a token row reaches the loss only
    through its own logits, so an expert fed only by tokens without a label
    gets a gradient of exactly zero (the aux loss reads the router alone),
    while an expert fed a labeled row does not; in an earlier layer every
    fed expert gets one, since later attention reads every row."""
    from automodel_tpu_torch.moe import layer as tlayer
    from automodel_tpu_torch.training.train_step import make_causal_lm_loss

    model = MoEForCausalLM(MoETransformerConfig.from_hf(HF_MOE_TINY), BackendConfig(experts="ragged", **FP32),
                           device=CPU, trainable=True)
    model.init_weights(torch.Generator().manual_seed(0))
    picks = []
    real_gate = tlayer.gate

    def recording_gate(*a, **kw):
        out = real_gate(*a, **kw)
        picks.append(out.topk_idx.detach())
        return out

    monkeypatch.setattr(tlayer, "gate", recording_gate)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 128, size=(2, 16)))
    with torch.no_grad():
        model(ids)
    first, last = picks[0], picks[-1]  # [T, K] of layers 0 and 1
    # mask every token that picks expert e in the last layer
    e = int(last[0, 0])
    unlabeled = (last == e).any(dim=1)
    labels = torch.from_numpy(rng.integers(0, 128, size=(2, 16)))
    labels.view(-1)[unlabeled] = -100
    picks.clear()
    loss_sum, n, _ = make_causal_lm_loss(model, loss="fused_linear_ce")({"input_ids": ids, "labels": labels})
    (loss_sum / n).backward()
    assert torch.equal(picks[-1], last) and 0 < int(n) < ids.numel()

    def fed(idx, rows):
        return torch.zeros(8, dtype=torch.bool).index_fill_(0, idx[rows].reshape(-1), True)

    only_unlabeled = fed(last, unlabeled) & ~fed(last, ~unlabeled)
    labeled = fed(last, ~unlabeled)
    assert only_unlabeled[e] and labeled.any()
    blocks = model.moe_layers()
    for name in ("gate_up", "down"):
        grad = getattr(blocks[-1].experts, name).grad.flatten(1)
        assert torch.equal(grad[only_unlabeled], torch.zeros_like(grad[only_unlabeled])), name
        assert (grad[labeled] != 0).any(dim=1).all(), name
        grad0 = getattr(blocks[0].experts, name).grad.flatten(1)
        assert (grad0[fed(first, torch.ones_like(unlabeled))] != 0).any(dim=1).all(), name


OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0,
           lr_schedule=dict(style="cosine", warmup_steps=2, decay_steps=8))


def _batches(n_steps, accum, seed=11):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=HF_MOE_TINY["vocab_size"], seq_length=16, num_samples=64, seed=seed)
    out = []
    for s in range(n_steps):
        group = [default_collater([ds[(s * accum + a) * 2 + i] for i in range(2)]) for a in range(accum)]
        out.append({k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)})
    return out


def test_train_step_trajectory_matches_jax():
    """4 optimizer steps, grad_acc_steps 2, fused_linear_ce, the aux loss
    in the objective: per-step loss, grad norm, moe_aux_loss and
    expert_load_imbalance to fp32 atol 1e-5 (expert ids are compared
    exactly through the imbalance), and the weights after step 4. JAX's
    ragged backend runs XLA's ragged_dot here (the Pallas kernels are held
    to it by tests/test_grouped_matmul.py)."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.optim.scheduler import build_lr_schedule
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    jmodel, params, tmodel = _pair("ragged", trainable=True)
    jopt = jax_optimizer(**OPT)
    jstate = JaxState.create(params, jax.jit(jopt.init)(params))
    jfn = jax_step(jax_loss(jmodel, loss="fused_linear_ce"), jopt, jax_schedule(lr=OPT["lr"], **OPT["lr_schedule"]),
                   donate=False, post_step_fn=jmodel.post_step_fn)
    tparams = list(tmodel.parameters())
    tstate = TrainState(params=tparams, optimizer=build_optimizer(tparams, **OPT))
    tfn = build_train_step(make_causal_lm_loss(tmodel, loss="fused_linear_ce"),
                           build_lr_schedule(lr=OPT["lr"], **OPT["lr_schedule"]), post_step_fn=tmodel.post_step_fn)
    for i, batch in enumerate(_batches(4, accum=2)):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "moe_aux_loss", "expert_load_imbalance"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=1e-5, err_msg=f"{key}, step {i + 1}")
        np.testing.assert_allclose(tm["expert_load_imbalance_per_layer"].numpy(),
                                   np.asarray(jm["expert_load_imbalance_per_layer"]), atol=1e-6)
        assert int(tm["num_label_tokens"]) == int(jm["num_label_tokens"]) and not bool(tm["nonfinite"])
    want = params_from_jax(jax.device_get(jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_pretrain_moe_tiny_on_cpu_logs_moe_metrics_and_a_falling_loss(tmp_path):
    from automodel_tpu_torch.cli import app

    metrics = tmp_path / "train_metrics.jsonl"
    cfg = os.path.join(REPO, "automodel_tpu_torch", "configs", "moe_tiny_cpu.yaml")
    assert app.main(["pretrain", "llm", "-c", cfg, "--device=cpu", f"--logging.metrics_path={metrics}"]) == 0
    rows = [r for r in map(json.loads, metrics.read_text().splitlines()) if "event" not in r]
    assert [r["step"] for r in rows] == list(range(1, 9))
    for r in rows:
        assert r["moe_aux_loss"] > 0 and r["expert_load_imbalance"] >= 1.0 and r["nonfinite"] is False
        assert isinstance(r["expert_load_imbalance_per_layer"], list) and len(r["expert_load_imbalance_per_layer"]) == 2
    assert rows[-1]["loss"] < rows[0]["loss"] - 0.5


def test_the_a3b_config_keeps_the_published_widths():
    """The card config: Qwen3-30B-A3B's widths with 4 layers; 3,114,814,464
    parameters by the model's own shapes (built on the meta device)."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import check_sections

    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "pretrain_qwen3_moe_a3b.yaml"))
    check_sections(cfg)
    mc = MoETransformerConfig.from_hf(cfg.model.hf_config.to_dict())
    assert (mc.hidden_size, mc.num_heads, mc.num_kv_heads, mc.head_dim, mc.vocab_size) == (2048, 32, 4, 128, 151936)
    assert (mc.moe.num_experts, mc.moe.num_experts_per_tok, mc.moe.moe_intermediate_size) == (128, 8, 768)
    assert mc.qk_norm and mc.moe.norm_topk_prob and mc.moe.aux_loss_coeff == 0.001 and mc.num_layers == 4
    backend = BackendConfig.from_dict(cfg.model.backend.to_dict())
    assert (backend.experts, backend.attn) == ("ragged", "flash")
    model = MoEForCausalLM(mc, dataclasses.replace(backend), device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == 3_114_814_464
    assert cfg.step_scheduler.grad_acc_steps == 2 and cfg.dataset.seq_length == 4096
