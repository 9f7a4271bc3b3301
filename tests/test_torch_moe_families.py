"""The MoE architectures JAX's registry sends to its MoE builder beside
Qwen3-MoE (automodel_tpu/models/registry.py:130-151) against the JAX
package on the CPU: Mixtral (``num_local_experts``, ``intermediate_size``
as the expert width, the ``block_sparse_moe`` w1/w3/w2 keys), Qwen2-MoE
(one shared expert behind a sigmoid gate, attention biases, the singular
``shared_expert`` keys) and GLM-4-MoE (sigmoid routing with the aux-free
correction bias over groups, a dense first layer, a shared expert, partial
rotary, attention biases, q/k norms behind ``use_qk_norm``). For each:
``from_hf`` fields equal JAX's, the registry builds it, logits and aux
agree (fp32, atol 1e-5), and an HF export in the family's key dialect has
JAX's keys and loads back through the conversion mapping bit for bit.
The committed examples/llm_pretrain/qwen3_moe_30b.yaml's backend
(``experts: gspmd``) and mesh (``ep: 8``) are taken.

Last, the one multi-process run of expert parallelism: ``pretrain llm``
on the tiny DeepSeek-V3 at ``ep = 2`` over two gloo processes
(``a2a_fused``: the token exchange by ``all_to_all_single``) against one
process (``ragged_fused``): per-step losses and grad norms within 2e-5
relative (fp32; the expert grads summed in another order).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.config import BackendConfig as JaxBackend
from automodel_tpu.models.qwen3_moe import MoEForCausalLM as JaxMoE
from automodel_tpu.models.qwen3_moe import MoEStateDictAdapter as JaxAdapter
from automodel_tpu.models.qwen3_moe import MoETransformerConfig as JaxMoEConfig
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.qwen3_moe import MoEForCausalLM, MoETransformerConfig, params_from_jax
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FP32 = dict(param_dtype="float32", compute_dtype="float32")

_COMMON = dict(vocab_size=128, hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               max_position_embeddings=256, tie_word_embeddings=False, rms_norm_eps=1e-6)
FAMILIES = {
    "mixtral": dict(_COMMON, architectures=["MixtralForCausalLM"], model_type="mixtral", intermediate_size=32,
                    num_hidden_layers=2, num_local_experts=8, num_experts_per_tok=2, router_aux_loss_coef=0.02,
                    rope_theta=1e6),
    "qwen2_moe": dict(_COMMON, architectures=["Qwen2MoeForCausalLM"], model_type="qwen2_moe", intermediate_size=128,
                      moe_intermediate_size=32, shared_expert_intermediate_size=48, num_hidden_layers=2,
                      num_experts=8, num_experts_per_tok=2, norm_topk_prob=False, router_aux_loss_coef=0.001),
    "glm4_moe": dict(_COMMON, architectures=["Glm4MoeForCausalLM"], model_type="glm4_moe", intermediate_size=128,
                     moe_intermediate_size=32, num_hidden_layers=3, n_routed_experts=8, num_experts_per_tok=2,
                     n_shared_experts=1, first_k_dense_replace=1, n_group=2, topk_group=1,
                     routed_scaling_factor=1.5, norm_topk_prob=True, partial_rotary_factor=0.5,
                     attention_bias=True, use_qk_norm=True),
}
STYLE = {"mixtral": "mixtral", "qwen2_moe": "qwen2_moe", "glm4_moe": None}


def _randomize(params, seed):
    """JAX's zero-initialised leaves (the router's correction bias, the
    attention biases, the shared-expert gate) and unit norm scales filled
    with seeded random values."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "bias" or "shared_gate" in keys:
            return jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
        if keys[-1] == "scale":
            return jnp.asarray(1.0 + rng.normal(size=x.shape) * 0.2, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, params)


def _pair(family, seed=0, experts="ragged"):
    from automodel_tpu_torch.auto_model import from_config

    hf = FAMILIES[family]
    kw = dict(attn="sdpa", experts=experts, **FP32)
    jmodel = JaxMoE(JaxMoEConfig.from_hf(hf), JaxBackend(**kw))
    params = _randomize(jmodel.init(jax.random.key(seed)), seed + 100)
    tmodel = from_config(hf, BackendConfig(**kw), device="cpu").model
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_from_hf_fields_match_jax(family):
    hf = FAMILIES[family]
    w = dataclasses.asdict(JaxMoEConfig.from_hf(hf))
    g = dataclasses.asdict(MoETransformerConfig.from_hf(hf))
    # JAX's dense config has two fields the port leaves out, at their defaults
    assert {k: w.pop(k) for k in set(w) - set(g)} == {"causal": True, "qk_norm_flat": False}
    assert g == w
    moe = g["moe"]
    if family == "mixtral":
        assert (moe["num_experts"], moe["moe_intermediate_size"], moe["num_shared_experts"]) == (8, 32, 0)
    elif family == "qwen2_moe":
        assert moe["num_shared_experts"] == 1 and moe["shared_expert_gate"] and g["attention_bias"]
    else:
        assert moe["score_func"] == "sigmoid" and moe["expert_bias"] and g["qk_norm"] and g["partial_rotary_factor"] == 0.5


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_registry_builds_the_family_and_logits_match_jax(family):
    """The registry builds the MoE model (with the family's HF key
    dialect); logits to 1e-5, the expert counts exactly, the aux loss to
    1e-6 relative (JAX's ragged through XLA's ragged_dot)."""
    jmodel, params, tmodel = _pair(family, seed=1)
    assert type(tmodel) is MoEForCausalLM and tmodel.hf_key_style == STYLE[family]
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 16)).astype(np.int32)
    jlogits, jaux = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, taux = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_array_equal(taux.expert_counts.numpy(), np.asarray(jaux.expert_counts))
    np.testing.assert_allclose(float(taux.aux_loss), float(jaux.aux_loss), rtol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_key_style_round_trips(family, tmp_path):
    """The port's export has the keys and tensors of JAX's export in the
    family's dialect (Mixtral's w1/w3/w2 under block_sparse_moe, Qwen2-MoE's
    shared_expert); written to a directory with its config.json it loads
    back through the conversion mapping (``from_pretrained``) to the same
    state dict."""
    from automodel_tpu_torch.auto_model import from_pretrained
    from automodel_tpu_torch.checkpoint.hf_io import save_hf_checkpoint

    hf = FAMILIES[family]
    _, params, tmodel = _pair(family, seed=2)
    jadapter = JaxAdapter(JaxMoEConfig.from_hf(hf), hf_key_style=STYLE[family])
    want = {k: np.asarray(v) for k, v in jadapter.to_hf(jax.device_get(params))}
    got = dict(tmodel.state_dict_adapter(tmodel).to_hf(tmodel.state_dict()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if family == "mixtral":
        assert "model.layers.1.block_sparse_moe.experts.7.w3.weight" in got
    if family == "qwen2_moe":
        assert "model.layers.0.mlp.shared_expert.down_proj.weight" in got
    save_hf_checkpoint(tmp_path, got.items())
    (tmp_path / "config.json").write_text(json.dumps(hf))
    back = from_pretrained(tmp_path, BackendConfig(attn="sdpa", experts="ragged", **FP32), device="cpu").model
    for k, v in tmodel.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def _steps(path: Path) -> list:
    return [(r["loss"], r["grad_norm"]) for r in map(json.loads, open(path)) if "loss" in r]


def test_ep2_on_two_gloo_processes_matches_one_process(tmp_path):
    cfg = REPO / "automodel_tpu_torch" / "configs" / "deepseek_v3_tiny_cpu.yaml"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    common = [str(cfg), "--step_scheduler.max_steps=3", "--model.backend.attn=sdpa"]
    runs = {
        "ep2": [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "-m",
                "automodel_tpu_torch.cli.app", "pretrain", "llm", "-c", *common, "--distributed.ep=2",
                "--distributed.dp_shard=-1", "--model.backend.experts=a2a_fused"],
        "one": [sys.executable, "-m", "automodel_tpu_torch.cli.app", "pretrain", "llm", "-c", *common],
    }
    for tag, cmd in runs.items():
        out = subprocess.run([*cmd, f"--logging.metrics_path={tmp_path / tag}.jsonl"], cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    ep2, one = _steps(tmp_path / "ep2.jsonl"), _steps(tmp_path / "one.jsonl")
    assert len(ep2) == len(one) == 3
    np.testing.assert_allclose(np.array(ep2), np.array(one), rtol=2e-5, atol=0)


def test_the_qwen3_moe_30b_example_backend_and_mesh_are_taken():
    """examples/llm_pretrain/qwen3_moe_30b.yaml's backend (experts: gspmd,
    remat: selective) and its distributed section (ep 8) are taken: the
    backend builds a tiny Qwen3-MoE whose logits match JAX's gspmd, and the
    mesh degrees validate on 8 ranks."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.parallel.mesh import MeshConfig, MeshContext

    cfg = load_yaml_config(REPO / "examples" / "llm_pretrain" / "qwen3_moe_30b.yaml")
    kw = dict(cfg.model.backend.to_dict(), **FP32)
    assert (kw["experts"], kw["remat"]) == ("gspmd", "selective")
    hf = dict(FAMILIES["mixtral"], architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe",
              num_experts=8, moe_intermediate_size=32, num_local_experts=None)
    jmodel = JaxMoE(JaxMoEConfig.from_hf(hf), JaxBackend(**kw))
    params = _randomize(jmodel.init(jax.random.key(4)), 104)
    tmodel = MoEForCausalLM(MoETransformerConfig.from_hf(hf), BackendConfig.from_dict(kw), device=CPU)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    ids = np.random.default_rng(5).integers(0, 128, size=(2, 16)).astype(np.int32)
    jlogits, _ = jmodel(params, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, _ = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5)
    mesh = MeshConfig.from_section(cfg.distributed.to_dict())
    mesh.check_ported()
    assert MeshContext.from_degrees(8, config=mesh).ep_size == 8
