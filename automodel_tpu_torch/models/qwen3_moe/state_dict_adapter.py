"""Weight carry from the JAX package's MoE param tree to the port's state
dict.

The JAX tree (``automodel_tpu/models/qwen3_moe/model.py`` init_params)
keeps an optional ``dense_layers`` stack (the dense prefix) and a
``moe_layers`` stack, each with a leading layer axis; projection kernels
are ``[in, out]``. The port's ``MoEForCausalLM`` numbers the layers of both
stacks in order under HF names. The MoE leaves map as:

- ``moe/router/weight`` [L, D, E] → ``mlp.gate.weight`` [E, D];
- ``moe/router/bias`` [L, E] → the ``mlp.gate.bias`` buffer;
  ``moe/router/linear_bias`` [L, E] → ``mlp.gate.linear_bias``;
- ``moe/experts/{gate_up,down,gate_up_bias,down_bias}`` [L, E, ...] →
  ``mlp.experts.*`` (the same layout);
- ``moe/shared/*_proj/kernel`` → ``mlp.shared_experts.*_proj.weight``
  (transposed), ``moe/shared_gate/kernel`` [L, D, 1] →
  ``mlp.shared_expert_gate.weight`` [1, D].

A gradient tree has the same structure, so it carries over the same way
(the router bias's zero gradient lands on the buffer's key, which has no
gradient in the port).
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.llama.state_dict_adapter import _Taker, carry_ends, carry_stack

_SHARED = ("gate_proj", "up_proj", "down_proj")


def carry_moe(sd: dict, take: _Taker, stack: str, n: int, offset: int = 0, router: str = "gate") -> None:
    """The ``moe`` leaves of one stacked layer tree (``tree[stack]``, n
    layers) into ``sd`` as layers ``offset``, ``offset + 1``, ..., the
    router under ``mlp.<router>``."""
    m = (stack, "moe")
    per_layer: dict[str, torch.Tensor] = {f"mlp.{router}.weight": take(*m, "router", "weight").transpose(1, 2)}
    for leaf in ("bias", "linear_bias"):
        if take.has(*m, "router", leaf):
            per_layer[f"mlp.{router}.{leaf}"] = take(*m, "router", leaf)
    for name in ("gate_up", "down", "gate_up_bias", "down_bias"):
        if take.has(*m, "experts", name):
            per_layer[f"mlp.experts.{name}"] = take(*m, "experts", name)
    for name in _SHARED:
        if take.has(*m, "shared", name, "kernel"):
            per_layer[f"mlp.shared_experts.{name}.weight"] = take(*m, "shared", name, "kernel").transpose(1, 2)
    if take.has(*m, "shared_gate", "kernel"):
        per_layer["mlp.shared_expert_gate.weight"] = take(*m, "shared_gate", "kernel").transpose(1, 2)
    for key, stacked in per_layer.items():
        for i in range(n):
            sd[f"model.layers.{offset + i}.{key}"] = stacked[i].contiguous()


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX MoE param (or gradient) tree, numpy leaves → the port's state
    dict. Raises on a leaf it does not know."""
    sd: dict[str, torch.Tensor] = {}
    take = _Taker(tree)
    carry_ends(sd, take)
    nd = carry_stack(sd, take, "dense_layers") if "dense_layers" in tree else 0
    nm = carry_stack(sd, take, "moe_layers", offset=nd)
    carry_moe(sd, take, "moe_layers", nm, offset=nd)
    take.check_all_taken("qwen3_moe params_from_jax")
    return sd
