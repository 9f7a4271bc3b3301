"""Weight carry from the JAX package's Llama param tree to the port's
state dict.

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

from typing import Any

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
