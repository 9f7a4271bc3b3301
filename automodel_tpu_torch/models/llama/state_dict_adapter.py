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


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX Llama param (or gradient) tree, numpy leaves → the port's state
    dict. Raises on a leaf it does not know (fp8, LoRA and NF4 trees are not
    ported)."""
    sd: dict[str, torch.Tensor] = {}
    seen: set[tuple] = set()

    def take(*path):
        node = tree
        for k in path:
            node = node[k]
        seen.add(path)
        return _tensor(node)

    sd["model.embed_tokens.weight"] = take("embed", "embedding")
    sd["model.norm.weight"] = take("final_norm", "scale")
    if "lm_head" in tree:
        sd["lm_head.weight"] = take("lm_head", "kernel").T.contiguous()
    layers = tree["layers"]
    L = int(np.asarray(layers["input_norm"]["scale"]).shape[0])
    for (grp, name), hf in _PROJ.items():
        kernel = take("layers", grp, name, "kernel")
        bias = take("layers", grp, name, "bias") if "bias" in layers[grp][name] else None
        for i in range(L):
            sd[f"model.layers.{i}.{hf}.weight"] = kernel[i].T.contiguous()
            if bias is not None:
                sd[f"model.layers.{i}.{hf}.bias"] = bias[i].contiguous()
    for path, hf in _NORMS.items():
        node = layers
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if node is None:
            continue
        scale = take("layers", *path, "scale")
        for i in range(L):
            sd[f"model.layers.{i}.{hf}.weight"] = scale[i].contiguous()

    def leaves(node, prefix=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix

    unknown = [p for p in leaves(tree) if p not in seen]
    if unknown:
        raise ValueError(f"params_from_jax: leaves not ported: {['/'.join(p) for p in unknown]}")
    return sd
