"""``adafactor`` and ``muon`` on the MoE families (``automodel_tpu_torch/
optim/builders.py`` over ``moe_jax_leaf_of``) against optax on the JAX
param tree.

A tiny Qwen3-MoE (a dense first layer, then MoE layers), a tiny
DeepSeek-V3 (MLA, a shared expert, its own dense-layer stack) and a tiny
GPT-OSS (sinks, attention and expert biases, the learned router bias),
each at widths of 128 where it matters (the model width and 2I) so that
adafactor factors the ``[L, E, D, 2I]`` expert leaves: JAX's
``build_optimizer`` takes two steps on the JAX tree with seeded random
grads (the aux-free router bias, a buffer the port moves by itself, gets
zero grads and is not compared), and the port's optimizer the same two
steps on the carried tensors. Every parameter after two steps equals
JAX's within 1e-5 (fp32: the same arithmetic on the same leaves, every
leaf updated tensor by tensor, adafactor's means and RMS summed from the
per-tensor parts), with the global-norm clip and without it. Muon's
partition is JAX's: the 2-D leaves (embedding, lm_head, the stacked norm
scales, GPT-OSS's sinks and router bias ``[L, E]``) take Newton-Schulz,
the rest (the stacked kernels, the router ``[L, D, E]``, the expert
slabs) Adam.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_port_parity  # noqa: F401  (caps torch at one thread)

from automodel_tpu.models.common.config import BackendConfig as JaxBackend
from automodel_tpu.models.registry import resolve_architecture as jax_resolve
from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
from automodel_tpu_torch.auto_model import from_config
from automodel_tpu_torch.optim import builders

FP32 = dict(param_dtype="float32", compute_dtype="float32", attn="sdpa", experts="ragged")
ATTN = dict(vocab_size=256, hidden_size=128, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
            max_position_embeddings=256, tie_word_embeddings=False)
FAMILIES = {
    "qwen3_moe": dict(ATTN, architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe", intermediate_size=128,
                      moe_intermediate_size=64, num_hidden_layers=3, num_experts=4, num_experts_per_tok=2,
                      norm_topk_prob=True, first_k_dense_replace=1),
    "deepseek_v3": dict(ATTN, architectures=["DeepseekV3ForCausalLM"], model_type="deepseek_v3",
                        num_key_value_heads=4, intermediate_size=128, moe_intermediate_size=64,
                        num_hidden_layers=3, n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
                        first_k_dense_replace=1, topk_method="noaux_tc", norm_topk_prob=True,
                        routed_scaling_factor=2.5, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16),
    "gpt_oss": dict(ATTN, architectures=["GptOssForCausalLM"], model_type="gpt_oss", intermediate_size=64,
                    num_hidden_layers=2, num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
                    layer_types=["sliding_attention", "full_attention"]),
}
CASES = {
    "adafactor": dict(name="adafactor", lr=1e-2),
    "muon": dict(name="muon", lr=1e-2, weight_decay=0.01, betas=(0.9, 0.95)),
}


def _carry(family: str):
    # Mixtral, Qwen2-MoE and GLM-4-MoE carry as Qwen3-MoE does
    mod = family if family in ("deepseek_v3", "gpt_oss") else "qwen3_moe"
    return __import__(f"automodel_tpu_torch.models.{mod}", fromlist=["params_from_jax"]).params_from_jax


def _trees(family: str, seed: int = 0):
    """JAX's params (every zero-initialized leaf filled) and two seeded
    grad trees, zero on the router's aux-free bias."""
    hf = FAMILIES[family]
    jmodel, _ = jax_resolve(hf)(hf, JaxBackend(**FP32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05,
                          jax.device_get(jmodel.init(jax.random.key(seed))))

    def grads(scale):
        def leaf(path, x):
            if getattr(path[-2], "key", None) == "router" and getattr(path[-1], "key", None) == "bias":
                return np.zeros_like(x)
            return (rng.normal(size=x.shape) * scale).astype(np.float32)

        return jax.tree_util.tree_map_with_path(leaf, params)

    return hf, params, [grads(2.0), grads(0.5)]


@pytest.mark.parametrize("clip", [1.0, None], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_steps_match_optax_on_the_jax_leaves(family, case, clip):
    hf, params, grads = _trees(family)
    carry = _carry(family)
    model = from_config(hf, FP32, device="cpu", trainable=True).model
    model.load_state_dict(carry(params))
    named = list(model.named_parameters())
    names = [n for n, _ in named]
    kw = dict(grad_clip_norm=clip, lr_schedule=dict(style="constant"), **CASES[case])
    topt = builders.build_optimizer([p.detach() for _, p in named], names=names, leaf_of=model.jax_leaf_of, **kw)
    jopt = jax_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = carry(g)
        topt.update([tg[n] for n in names])
    want = carry(jax.device_get(jparams))
    for n, p in named:
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5, err_msg=f"{case} {n}")
    if case == "muon":
        muon = {lf.path for lf in builders.jax_leaves(names, model.jax_leaf_of) if lf.path in topt.muon_leaves}
        assert {"embed/embedding", "lm_head/kernel"} <= muon
        assert not any("experts" in p or p.endswith("router/weight") for p in muon)
        if family == "gpt_oss":
            assert {"layers/attn/sinks", "layers/moe/router/linear_bias"} <= muon


def test_every_moe_parameter_has_its_jax_leaf():
    """``moe_jax_leaf_of`` places every parameter of each family on a JAX
    leaf whose stacked shape is JAX's (``params_from_jax`` read backwards)."""
    for family in FAMILIES:
        hf, params, _ = _trees(family)
        model = from_config(hf, FP32, device="cpu").model
        names = [n for n, _ in model.named_parameters()]
        tensors = dict(model.named_parameters())
        flat = {"/".join(str(k.key) for k in path): np.shape(x)
                for path, x in jax.tree_util.tree_leaves_with_path(params)}
        leaves = builders.jax_leaves(names, model.jax_leaf_of)
        for lf in leaves:
            assert lf.shape([tensors[n] for n in names]) == flat[lf.path], (family, lf.path)
        seen = {lf.path for lf in leaves}
        assert seen == {p for p in flat if not p.endswith("router/bias")}, family
