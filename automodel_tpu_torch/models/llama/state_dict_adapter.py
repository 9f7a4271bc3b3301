"""The Llama family's weight maps: HF safetensors keys both ways
(``LlamaStateDictAdapter``, port of ``automodel_tpu/models/llama/
state_dict_adapter.py``), and the carry from the JAX package's param tree
(``params_from_jax``).

The port's parameter names are HF's, so the HF map is the identity over
the model's state dict; an lm_head tied to the embedding is no parameter
and is not saved, as in the JAX package. The families with other layouts
subclass the adapter and override ``_plan`` for their keys.

The JAX tree (``automodel_tpu/models/llama/model.py`` init_params) stacks
per-layer leaves on a leading layer axis and stores projection kernels
``[in, out]``; the port's ``LlamaForCausalLM`` uses HF names with one
module per layer and ``nn.Linear`` weights ``[out, in]``. Input is the tree
as nested numpy arrays (``jax.device_get``); output is a state dict of CPU
tensors for ``load_state_dict``. A gradient (or optimizer-moment) tree has
the same structure as the params, so it carries over the same way and the
tests compare grads key by key.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

_PROJ = {
    ("attn", "q_proj"): "self_attn.q_proj",
    ("attn", "k_proj"): "self_attn.k_proj",
    ("attn", "v_proj"): "self_attn.v_proj",
    ("attn", "o_proj"): "self_attn.o_proj",
    ("mlp", "gate_proj"): "mlp.gate_proj",
    ("mlp", "up_proj"): "mlp.up_proj",
    ("mlp", "down_proj"): "mlp.down_proj",
}
_NORMS = {
    ("input_norm",): "input_layernorm",
    ("post_attn_norm",): "post_attention_layernorm",
    ("attn", "q_norm"): "self_attn.q_norm",
    ("attn", "k_norm"): "self_attn.k_norm",
}


def _tensor(x: Any) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from jax.device_get
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


class _Taker:
    """Reads leaves of a nested tree by path and remembers which it read."""

    def __init__(self, tree: dict):
        self.tree = tree
        self.seen: set[tuple] = set()

    def has(self, *path) -> bool:
        node = self.tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                return False
            node = node[k]
        return True

    def __call__(self, *path) -> torch.Tensor:
        node = self.tree
        for k in path:
            node = node[k]
        self.seen.add(path)
        return _tensor(node)

    def check_all_taken(self, what: str) -> None:
        def leaves(node, prefix=()):
            if isinstance(node, dict):
                for k, v in node.items():
                    yield from leaves(v, prefix + (k,))
            else:
                yield prefix

        unknown = [p for p in leaves(self.tree) if p not in self.seen]
        if unknown:
            raise ValueError(f"{what}: leaves not ported: {['/'.join(p) for p in unknown]}")


def carry_stack(sd: dict, take: _Taker, stack: str, offset: int = 0) -> int:
    """The attention, dense-MLP and norm leaves of one stacked layer tree
    (``tree[stack]``, leading layer axis) into ``sd`` as layers ``offset``,
    ``offset + 1``, ... → the number of layers."""
    L = int(np.asarray(take.tree[stack]["input_norm"]["scale"]).shape[0])
    for (grp, name), hf in _PROJ.items():
        if not take.has(stack, grp, name, "kernel"):
            continue
        kernel = take(stack, grp, name, "kernel")
        bias = take(stack, grp, name, "bias") if take.has(stack, grp, name, "bias") else None
        for i in range(L):
            sd[f"model.layers.{offset + i}.{hf}.weight"] = kernel[i].T.contiguous()
            if bias is not None:
                sd[f"model.layers.{offset + i}.{hf}.bias"] = bias[i].contiguous()
    for path, hf in _NORMS.items():
        if not take.has(stack, *path, "scale"):
            continue
        scale = take(stack, *path, "scale")
        for i in range(L):
            sd[f"model.layers.{offset + i}.{hf}.weight"] = scale[i].contiguous()
    return L


def carry_ends(sd: dict, take: _Taker) -> None:
    """Embedding, final norm and an untied lm_head."""
    sd["model.embed_tokens.weight"] = take("embed", "embedding")
    sd["model.norm.weight"] = take("final_norm", "scale")
    if "lm_head" in take.tree:
        sd["lm_head.weight"] = take("lm_head", "kernel").T.contiguous()


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX Llama param (or gradient) tree, numpy leaves → the port's state
    dict. Raises on a leaf it does not know (fp8, LoRA and NF4 trees are not
    ported)."""
    sd: dict[str, torch.Tensor] = {}
    take = _Taker(tree)
    carry_ends(sd, take)
    carry_stack(sd, take, "layers")
    take.check_all_taken("params_from_jax")
    return sd


# HF name (without the layer prefix) → JAX path of its stacked leaf: the
# projections, llama's norms and Gemma's sandwich norms
_LEAF_OF = {
    **{f"{hf}.{kind}": "/".join((*native, kind if kind == "bias" else "kernel"))
       for native, hf in _PROJ.items() for kind in ("weight", "bias")},
    **{f"{hf}.weight": "/".join((*native, "scale")) for native, hf in _NORMS.items()},
    "pre_feedforward_layernorm.weight": "pre_ffn_norm/scale",
    "post_feedforward_layernorm.weight": "post_ffn_norm/scale",
}
_END_LEAF_OF = {
    "model.embed_tokens.weight": ("embed/embedding", False),
    "model.norm.weight": ("final_norm/scale", False),
    "lm_head.weight": ("lm_head/kernel", True),
}
_LAYER_NAME = re.compile(r"^model\.layers\.(\d+)\.(.+)$")


def jax_leaf_of(name: str) -> Optional[tuple[str, Optional[int], bool]]:
    """``params_from_jax`` read backwards for one tensor of a dense family
    (Llama and its aliases, Gemma): → (the JAX leaf's path ``a/b/c``, the
    tensor's index on the leaf's leading layer axis or None, whether the
    tensor is the leaf's slice transposed: a projection kernel is ``[in,
    out]`` in JAX and ``[out, in]`` here). None for a tensor the map does
    not know (the MoE families' expert slabs and routers)."""
    if name in _END_LEAF_OF:
        path, transposed = _END_LEAF_OF[name]
        return path, None, transposed
    m = _LAYER_NAME.match(name)
    if m is None or m.group(2) not in _LEAF_OF:
        return None
    rest = m.group(2)
    return "layers/" + _LEAF_OF[rest], int(m.group(1)), rest.endswith("proj.weight")


Getter = Callable[[str], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one tensor of the port's state dict maps onto HF keys: ``load``
    builds it from a key getter (a tensor, or a ``LazyStacked`` of rows);
    ``save`` yields its (HF key, tensor) pairs."""

    key: str
    hf_keys: tuple[str, ...]
    load: Callable[[Getter], Any]
    save: Callable[[torch.Tensor], Iterator[tuple[str, torch.Tensor]]]


def identity_plan(key: str, hf_key: str | None = None) -> LeafPlan:
    hf_key = hf_key or key

    def save(t: torch.Tensor):
        yield hf_key, t

    return LeafPlan(key, (hf_key,), lambda get: get(hf_key), save)


class LlamaStateDictAdapter:
    """HF ⇄ port key plan over a built model's state dict (parameters and
    persistent buffers); the model is read for its keys and shapes only."""

    def __init__(self, model: torch.nn.Module):
        self.shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}

    def _plan(self, key: str, shape: tuple[int, ...]) -> LeafPlan:
        return identity_plan(key)

    def leaf_plans(self) -> list[LeafPlan]:
        return [self._plan(k, s) for k, s in self.shapes.items()]

    # -- load ---------------------------------------------------------------
    def iter_from_hf(self, get_tensor: Getter) -> Iterator[tuple[str, Any]]:
        """(port key, tensor or ``LazyStacked``) one leaf at a time, so the
        loader copies each into the model as it is built."""
        for plan in self.leaf_plans():
            yield plan.key, plan.load(get_tensor)

    def from_hf(self, get_tensor: Getter) -> dict[str, torch.Tensor]:
        """The whole state dict at once (the non-streaming convenience)."""
        from automodel_tpu_torch.checkpoint.hf_io import assemble

        return assemble(self.iter_from_hf(get_tensor))

    # -- save ---------------------------------------------------------------
    def to_hf(self, state_dict: dict[str, torch.Tensor]) -> Iterator[tuple[str, torch.Tensor]]:
        """(HF key, tensor) pairs from the port's state dict, in plan order,
        on the tensors' device (the writer moves each to the host)."""
        for plan in self.leaf_plans():
            yield from plan.save(state_dict[plan.key])

    def hf_keys(self) -> list[str]:
        return [k for plan in self.leaf_plans() for k in plan.hf_keys]
