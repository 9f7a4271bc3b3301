"""Shared fixtures for the torch port's parity tests (tests/test_torch_*.py).

The same tiny Llama config goes to both packages; the JAX package draws the
weights and ``params_from_jax`` carries them to the port, so both hold the
same numbers. Inputs are made with numpy from a seed and handed to each.

Importing this module caps torch at one intra-op thread. The suite runs
several pytest workers on one host, and torch's default (a thread per core
in each worker) oversubscribes it: the spinning pool threads slow the torch
tests several-fold and steal the cores that the other workers' wall-clock
comparisons time. At these tiny shapes one thread is the faster setting.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

torch.set_num_threads(1)

# 2 layers, hidden 64, 4 heads over 2 kv heads, head_dim 16; llama3 rope
# scaling with a small original context so the scaling bands all apply
HF_TINY = dict(
    architectures=["LlamaForCausalLM"],
    model_type="llama",
    vocab_size=128,
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=16,
    max_position_embeddings=256,
    rope_theta=500000.0,
    rope_scaling={
        "rope_type": "llama3",
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32,
    },
    rms_norm_eps=1e-5,
    tie_word_embeddings=False,
)

FP32_BACKEND = dict(attn="sdpa", param_dtype="float32", compute_dtype="float32")
CPU = torch.device("cpu")


def jax_tiny(seed: int = 0, hf: dict | None = None):
    """(JAX LlamaForCausalLM, params, JAX AutoModel) at fp32."""
    from automodel_tpu.auto_model import AutoModel
    from automodel_tpu.models.common.config import BackendConfig, TransformerConfig
    from automodel_tpu.models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(
        TransformerConfig.from_hf(hf or HF_TINY), BackendConfig(**FP32_BACKEND)
    )
    params = model.init(jax.random.key(seed))
    return model, params, AutoModel(model=model, params=params, adapter=None, mesh_ctx=None)


def torch_twin(jax_params, hf: dict | None = None, attn: str = "sdpa", trainable: bool = False):
    """The port's model on the CPU holding the JAX weights → AutoModel."""
    from automodel_tpu_torch.auto_model import AutoModel
    from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig
    from automodel_tpu_torch.models.llama import LlamaForCausalLM, params_from_jax

    model = LlamaForCausalLM(
        TransformerConfig.from_hf(hf or HF_TINY), BackendConfig(**dict(FP32_BACKEND, attn=attn)),
        device=CPU, trainable=trainable,
    )
    model.load_state_dict(params_from_jax(jax.device_get(jax_params)))
    return AutoModel(model=model, device=CPU)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)
