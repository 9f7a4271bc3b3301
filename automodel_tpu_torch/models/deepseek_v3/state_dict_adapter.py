"""DeepSeek-V3's weight maps, port of
``automodel_tpu/models/deepseek_v3/state_dict_adapter.py``.

The port's MLA parameters carry HF's names (``self_attn.q_a_proj``,
``q_a_layernorm``, ``q_b_proj`` or ``q_proj``, ``kv_a_proj_with_mqa``,
``kv_a_layernorm``, ``kv_b_proj``, ``o_proj``), so the HF map both ways is
the MoE family's ``MoEStateDictAdapter``, which the model inherits: the MLA
keys as they are, the expert slabs per expert. ``params_from_jax`` carries the JAX
tree: its MLA leaves (``attn/kv_a_proj/kernel`` [L, D, kvr + rope], ...,
kernels ``[in, out]``) onto those names, the rest as the MoE family's.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.llama.state_dict_adapter import _Taker, carry_ends, carry_stack
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import carry_moe

# JAX's MLA leaf under attn/ → the port's name under self_attn.
_MLA_PROJ = {"q_a_proj": "q_a_proj", "q_b_proj": "q_b_proj", "kv_a_proj": "kv_a_proj_with_mqa",
             "kv_b_proj": "kv_b_proj"}
_MLA_NORMS = {"q_a_norm": "q_a_layernorm", "kv_a_norm": "kv_a_layernorm"}

def carry_mla(sd: dict, take: _Taker, stack: str, n: int, offset: int = 0) -> None:
    """The MLA-only leaves of one stacked layer tree (``q_proj`` and
    ``o_proj`` go through ``carry_stack``)."""
    for leaf, name in _MLA_PROJ.items():
        if take.has(stack, "attn", leaf, "kernel"):
            kernel = take(stack, "attn", leaf, "kernel")
            for i in range(n):
                sd[f"model.layers.{offset + i}.self_attn.{name}.weight"] = kernel[i].T.contiguous()
    for leaf, name in _MLA_NORMS.items():
        if take.has(stack, "attn", leaf, "scale"):
            scale = take(stack, "attn", leaf, "scale")
            for i in range(n):
                sd[f"model.layers.{offset + i}.self_attn.{name}.weight"] = scale[i].contiguous()


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX DeepSeek-V3 param (or gradient) tree, numpy leaves → the port's
    state dict. Raises on a leaf it does not know."""
    sd: dict[str, torch.Tensor] = {}
    take = _Taker(tree)
    carry_ends(sd, take)
    nd = 0
    if "dense_layers" in tree:
        nd = carry_stack(sd, take, "dense_layers")
        carry_mla(sd, take, "dense_layers", nd)
    nm = carry_stack(sd, take, "moe_layers", offset=nd)
    carry_mla(sd, take, "moe_layers", nm, offset=nd)
    carry_moe(sd, take, "moe_layers", nm, offset=nd)
    take.check_all_taken("deepseek_v3 params_from_jax")
    return sd
