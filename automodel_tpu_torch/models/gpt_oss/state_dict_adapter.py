"""Weight carry from the JAX package's GPT-OSS param tree
(``automodel_tpu/models/gpt_oss/model.py`` init_params) to the port's state
dict. Every leaf is stacked over the layers (``layers/...``, leading layer
axis):

- ``attn/{q,k,v,o}_proj/{kernel,bias}`` → ``self_attn.*_proj.{weight,bias}``
  (kernels transposed), ``attn/sinks`` [L, N] → ``self_attn.sinks``;
- ``{input,post_attn}_norm/scale`` → ``{input,post_attention}_layernorm``;
- ``moe/router/{weight,linear_bias}`` → ``mlp.router.{weight,linear_bias}``
  (the weight transposed to [E, D]);
- ``moe/experts/{gate_up,gate_up_bias,down,down_bias}`` →
  ``mlp.experts.*`` (the same layout).

A gradient tree has the same structure and carries over the same way.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.llama.state_dict_adapter import _Taker, carry_ends, carry_stack
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import carry_moe


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX GPT-OSS param (or gradient) tree, numpy leaves → the port's
    state dict. Raises on a leaf it does not know."""
    sd: dict[str, torch.Tensor] = {}
    take = _Taker(tree)
    carry_ends(sd, take)
    n = carry_stack(sd, take, "layers")
    sinks = take("layers", "attn", "sinks")
    for i in range(n):
        sd[f"model.layers.{i}.self_attn.sinks"] = sinks[i].contiguous()
    carry_moe(sd, take, "layers", n, router="router")
    take.check_all_taken("gpt_oss params_from_jax")
    return sd
