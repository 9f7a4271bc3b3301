"""GPT-OSS's weight maps: HF keys both ways (``GptOssStateDictAdapter``,
port of ``automodel_tpu/models/gpt_oss/state_dict_adapter.py``) and the
carry from the JAX package's param tree (``params_from_jax``).

HF stores the experts stacked, ``mlp.experts.gate_up_proj`` [E, D, 2I]
with gate and up columns interleaved (g0, u0, g1, u1, ...) and its bias
``gate_up_proj_bias`` [E, 2I] the same way; the port keeps the halves
contiguous (g | u), as the JAX package does since its layout marker
``gpt_oss_gate_up: contiguous_v1``, so the adapter de-interleaves on load
and interleaves on save. ``down_proj`` and ``down_proj_bias`` are the
port's ``down`` and ``down_bias``; the router is an HF Linear (``[E, D]``
weight, ``bias``), stored as the port's ``mlp.router.weight`` and
``linear_bias``; the sinks keep their key.

The JAX carry (``automodel_tpu/models/gpt_oss/model.py`` init_params);
every leaf is stacked over the layers (``layers/...``, leading layer axis):

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

import re

import torch

from automodel_tpu_torch.models.llama.state_dict_adapter import (
    LeafPlan,
    LlamaStateDictAdapter,
    _Taker,
    carry_ends,
    carry_stack,
    identity_plan,
)
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


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """HF's [g0, u0, g1, u1, ...] on the last axis → the port's [g | u]."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def interleave(x: torch.Tensor) -> torch.Tensor:
    """The port's [g | u] on the last axis → HF's [g0, u0, g1, u1, ...]."""
    g, u = x.chunk(2, dim=-1)
    return torch.stack([g, u], dim=-1).flatten(-2)


_EXPERTS = re.compile(r"^(?P<p>.*\.mlp\.)(?P<name>experts\.(?:gate_up|down)(?:_bias)?|router\.linear_bias)$")
_HF_NAME = {
    "experts.gate_up": "experts.gate_up_proj",
    "experts.gate_up_bias": "experts.gate_up_proj_bias",
    "experts.down": "experts.down_proj",
    "experts.down_bias": "experts.down_proj_bias",
    "router.linear_bias": "router.bias",
}


class GptOssStateDictAdapter(LlamaStateDictAdapter):
    """HF's interleaved gate_up ⇄ the port's contiguous halves; the expert
    and router tensors under their HF names."""

    def _plan(self, key: str, shape: tuple[int, ...]) -> LeafPlan:
        m = _EXPERTS.match(key)
        if not m:
            return identity_plan(key)
        hf = f"{m['p']}{_HF_NAME[m['name']]}"
        if not m["name"].startswith("experts.gate_up"):
            return identity_plan(key, hf)

        def save(t):
            yield hf, interleave(t)

        return LeafPlan(key, (hf,), lambda get: deinterleave(get(hf)), save)
