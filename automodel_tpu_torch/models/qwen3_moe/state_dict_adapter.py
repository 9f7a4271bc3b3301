"""The MoE family's weight maps: HF keys both ways (``MoEStateDictAdapter``,
port of ``automodel_tpu/models/qwen3_moe/state_dict_adapter.py``) and the
carry from the JAX package's param tree (``params_from_jax``).

HF stores each expert as its own Linears,
``mlp.experts.{j}.{gate,up,down}_proj.weight`` ([I, D], [I, D], [D, I]);
the port stacks them into slabs, ``mlp.experts.gate_up`` [E, D, 2I] (gate
columns, then up) and ``mlp.experts.down`` [E, I, D], which load expert by
expert (``LazyStacked``) and save back per expert. The aux-free router's
selection bias (the ``mlp.gate.bias`` buffer) is HF's
``mlp.gate.e_score_correction_bias``. Every other key is HF's own.

The JAX carry:

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

import re
from typing import Optional

import torch

from automodel_tpu_torch.models.llama.state_dict_adapter import (
    LeafPlan,
    LlamaStateDictAdapter,
    _Taker,
    carry_ends,
    carry_stack,
    identity_plan,
)

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


# the MoE block's tensors (without the layer prefix) → (their JAX leaf
# under the stack, transposed): ``carry_moe`` read backwards
_MOE_LEAF_OF = {
    "mlp.gate.weight": ("moe/router/weight", True),
    "mlp.router.weight": ("moe/router/weight", True),
    "mlp.gate.linear_bias": ("moe/router/linear_bias", False),
    "mlp.router.linear_bias": ("moe/router/linear_bias", False),
    **{f"mlp.experts.{n}": (f"moe/experts/{n}", False) for n in ("gate_up", "down", "gate_up_bias", "down_bias")},
    **{f"mlp.shared_experts.{n}.weight": (f"moe/shared/{n}/kernel", True) for n in _SHARED},
    "mlp.shared_expert_gate.weight": ("moe/shared_gate/kernel", True),
    "self_attn.sinks": ("attn/sinks", False),
    # DeepSeek-V3's MLA (models/deepseek_v3/state_dict_adapter.carry_mla)
    "self_attn.q_a_proj.weight": ("attn/q_a_proj/kernel", True),
    "self_attn.q_b_proj.weight": ("attn/q_b_proj/kernel", True),
    "self_attn.kv_a_proj_with_mqa.weight": ("attn/kv_a_proj/kernel", True),
    "self_attn.kv_b_proj.weight": ("attn/kv_b_proj/kernel", True),
    "self_attn.q_a_layernorm.weight": ("attn/q_a_norm/scale", False),
    "self_attn.kv_a_layernorm.weight": ("attn/kv_a_norm/scale", False),
}


def moe_jax_leaf_of(name: str, n_dense: int = 0, stacks: Optional[tuple[str, str]] = ("dense_layers", "moe_layers")):
    """``params_from_jax`` of the MoE families read backwards for one
    tensor: → (the JAX leaf's path, the tensor's index on the leaf's
    leading layer axis or None, whether it is the leaf's slice transposed),
    or None for a name the map does not know. ``stacks``: the dense prefix's
    and the MoE layers' stacks (layer ``i < n_dense`` in the first), or
    None for one ``layers`` stack (GPT-OSS)."""
    from automodel_tpu_torch.models.llama.state_dict_adapter import _END_LEAF_OF, _LAYER_NAME, _LEAF_OF

    if name in _END_LEAF_OF:
        path, transposed = _END_LEAF_OF[name]
        return path, None, transposed
    m = _LAYER_NAME.match(name)
    if m is None:
        return None
    i, rest = int(m.group(1)), m.group(2)
    stack, j = ("layers", i) if not stacks else (stacks[0], i) if i < n_dense else (stacks[1], i - n_dense)
    if rest in _LEAF_OF:
        return f"{stack}/{_LEAF_OF[rest]}", j, rest.endswith("proj.weight")
    if rest in _MOE_LEAF_OF:
        leaf, transposed = _MOE_LEAF_OF[rest]
        return f"{stack}/{leaf}", j, transposed
    return None


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


_SLAB = re.compile(r"^(?P<p>.*\.mlp\.experts\.)(?P<name>gate_up|down)$")
_ROUTER_BIAS = re.compile(r"^(?P<p>.*\.mlp\.gate\.)bias$")


def _expert_slab_plan(key: str, prefix: str, name: str, num_experts: int) -> LeafPlan:
    """A [E, ...] slab over per-expert HF Linears, loaded expert by expert."""
    from automodel_tpu_torch.checkpoint.hf_io import LazyStacked

    proj = ("gate_proj", "up_proj") if name == "gate_up" else ("down_proj",)
    hf = {j: tuple(f"{prefix}{j}.{p}.weight" for p in proj) for j in range(num_experts)}

    def load(get):
        # row j: the [in, out] kernels of expert j side by side (gate | up)
        return LazyStacked([
            (lambda j=j: torch.cat([get(k).t() for k in hf[j]], dim=-1)) for j in range(num_experts)
        ])

    def save(t):
        for j in range(num_experts):
            for k, part in zip(hf[j], t[j].chunk(len(hf[j]), dim=-1)):
                yield k, part.t().contiguous()

    return LeafPlan(key, tuple(k for j in range(num_experts) for k in hf[j]), load, save)


# the save side's key rewrites per HF key dialect (JAX :29-43, copied): a
# Mixtral or Qwen2-MoE model exports the keys its own architecture reads
# (the load side renames them back through checkpoint/conversion_mapping.py)
_VARIANT_KEY_STYLES: dict[str, list[tuple[str, str]]] = {
    "mixtral": [
        (r"\.mlp\.gate\.weight$", ".block_sparse_moe.gate.weight"),
        # minimax-m2 (mixtral dialect + deepseek-style aux-free router bias)
        (r"\.mlp\.gate\.e_score_correction_bias$", ".block_sparse_moe.gate.e_score_correction_bias"),
        (r"\.mlp\.experts\.(\d+)\.gate_proj\.weight$", r".block_sparse_moe.experts.\1.w1.weight"),
        (r"\.mlp\.experts\.(\d+)\.up_proj\.weight$", r".block_sparse_moe.experts.\1.w3.weight"),
        (r"\.mlp\.experts\.(\d+)\.down_proj\.weight$", r".block_sparse_moe.experts.\1.w2.weight"),
    ],
    "qwen2_moe": [
        (r"\.mlp\.shared_experts\.", ".mlp.shared_expert."),
    ],
}


def style_key(key: str, style: str | None) -> str:
    """A canonical HF key in the dialect ``style`` (None: itself)."""
    for pat, sub in _VARIANT_KEY_STYLES.get(style or "", []):
        new = re.sub(pat, sub, key)
        if new != key:
            return new
    return key


class MoEStateDictAdapter(LlamaStateDictAdapter):
    """Per-expert HF Linears ⇄ the port's expert slabs; the router's
    selection bias under its HF name. A model built with an
    ``hf_key_style`` (Mixtral, Qwen2-MoE) saves in its dialect."""

    def __init__(self, model: torch.nn.Module):
        super().__init__(model)
        self.hf_key_style = getattr(model, "hf_key_style", None)

    def to_hf(self, state_dict: dict[str, torch.Tensor]):
        for key, t in super().to_hf(state_dict):
            yield style_key(key, self.hf_key_style), t

    def _plan(self, key: str, shape: tuple[int, ...]) -> LeafPlan:
        m = _SLAB.match(key)
        if m:
            return _expert_slab_plan(key, m["p"], m["name"], shape[0])
        m = _ROUTER_BIAS.match(key)
        if m:
            return identity_plan(key, f"{m['p']}e_score_correction_bias")
        return identity_plan(key)
