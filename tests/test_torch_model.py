"""The torch port's Llama against the JAX package's: full-forward logits
with weights carried by ``params_from_jax``, plus the builder's refusals
and the seeded random init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu_torch import auto_model
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.llama import params_from_jax
from torch_port_parity import FP32_BACKEND, HF_TINY, jax_tiny, to_np, torch_twin


@pytest.mark.parametrize(
    "hf",
    [HF_TINY, dict(HF_TINY, sliding_window=5, use_sliding_window=True)],
    ids=["llama3_rope", "sliding_window"],
)
def test_full_forward_logits_match_jax(hf):
    model, params, _ = jax_tiny(seed=1, hf=hf)
    tauto = torch_twin(params, hf=hf)
    ids = np.random.default_rng(2).integers(0, 128, size=(2, 12)).astype(np.int32)
    ref = model(params, jnp.asarray(ids))
    with torch.no_grad():
        out = tauto.model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)


def test_params_from_jax_covers_every_parameter():
    _, params, _ = jax_tiny(seed=0)
    sd = params_from_jax(jax.device_get(params))
    tauto = torch_twin(params)
    assert set(sd) == set(tauto.model.state_dict())
    layer0 = np.asarray(params["layers"]["attn"]["q_proj"]["kernel"][0])
    np.testing.assert_array_equal(sd["model.layers.0.self_attn.q_proj.weight"].numpy(), layer0.T)
    bad = jax.device_get(params)
    bad["layers"]["attn"]["q_proj"]["lora_A"] = np.zeros((2, 64, 4), np.float32)
    with pytest.raises(ValueError, match="lora_A"):
        params_from_jax(bad)


def test_from_config_seeded_init_scales():
    a = auto_model.from_config(HF_TINY, FP32_BACKEND, device="cpu", seed=3)
    b = auto_model.from_config(HF_TINY, FP32_BACKEND, device="cpu", seed=3)
    c = auto_model.from_config(HF_TINY, FP32_BACKEND, device="cpu", seed=4)
    sa, sb, sc = (x.model.state_dict() for x in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["lm_head.weight"], sc["lm_head.weight"])
    assert abs(float(sa["model.embed_tokens.weight"].std()) - 0.02) < 0.002
    w = sa["model.layers.0.mlp.down_proj.weight"]  # fan_in = intermediate 128
    assert abs(float(w.std()) * np.sqrt(128) - 1.0) < 0.05
    assert torch.equal(sa["model.norm.weight"], torch.ones(64))


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        auto_model.from_config(HF_TINY, FP32_BACKEND, device="cuda")


def test_backend_refuses_what_is_not_ported():
    assert BackendConfig(attn="flash").attn == "flash"
    assert BackendConfig(attn="ring", cp_zigzag=True).cp_zigzag  # context parallelism (parallel/cp.py)
    with pytest.raises(ValueError, match="attn='splash'"):
        BackendConfig(attn="splash")
    for key, value in (("remat", "everything"), ("fp8", True), ("fp8_experts", True), ("attn_block_q", 0)):
        with pytest.raises(ValueError, match=key):
            BackendConfig.from_dict({"attn": "flash", key: value})
    accepted = BackendConfig.from_dict({"attn": "flash", "remat": "selective", "scan_layers": False,
                                        "attn_block_q": 512, "attn_block_kv": 512})
    assert (accepted.remat, accepted.scan_layers, accepted.attn_block_q) == ("selective", False, 512)
    for key, value in (("attn_block_q", 256), ("attn_block_kv", 1024)):
        with pytest.raises(ValueError, match=key):
            BackendConfig.from_dict({"attn": "flash", key: value})
    with pytest.raises(ValueError, match="MixtralForCausalLM"):
        auto_model.from_config(dict(HF_TINY, architectures=["MixtralForCausalLM"]), FP32_BACKEND, device="cpu")
