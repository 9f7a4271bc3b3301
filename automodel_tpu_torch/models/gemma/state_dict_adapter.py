"""Gemma's weight maps: HF keys both ways (``GemmaStateDictAdapter``, port
of ``automodel_tpu/models/gemma/state_dict_adapter.py``; the port's names
are HF's, the sandwich norms and Gemma 3's q/k norms among them, and the
tied lm_head is not saved) and the carry from the JAX package's param tree
(``params_from_jax``).

The JAX carry (``automodel_tpu/models/gemma/model.py`` init_params): every
per-layer leaf is stacked over the layers (``layers/...``, leading layer
axis):

- ``embed/embedding`` and ``final_norm/scale`` → ``model.embed_tokens`` and
  ``model.norm``; ``lm_head/kernel`` (transposed) only when untied;
- ``attn/{q,k,v,o}_proj/kernel`` and ``mlp/{gate,up,down}_proj/kernel`` →
  ``self_attn.*`` and ``mlp.*`` (kernels transposed);
- the four norms ``{input,post_attn,pre_ffn,post_ffn}_norm/scale`` →
  ``{input,post_attention,pre_feedforward,post_feedforward}_layernorm``,
  and Gemma 3's ``attn/{q,k}_norm/scale`` → ``self_attn.{q,k}_norm``.

A gradient tree has the same structure and carries over the same way.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.llama.state_dict_adapter import (
    LlamaStateDictAdapter,
    _Taker,
    carry_ends,
    carry_stack,
)

# the sandwich norms llama's carry does not have
_SANDWICH = {"pre_ffn_norm": "pre_feedforward_layernorm", "post_ffn_norm": "post_feedforward_layernorm"}


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX Gemma param (or gradient) tree, numpy leaves → the port's state
    dict. Raises on a leaf it does not know."""
    sd: dict[str, torch.Tensor] = {}
    take = _Taker(tree)
    carry_ends(sd, take)
    n = carry_stack(sd, take, "layers")
    for native, hf in _SANDWICH.items():
        scale = take("layers", native, "scale")
        for i in range(n):
            sd[f"model.layers.{i}.{hf}.weight"] = scale[i].contiguous()
    take.check_all_taken("gemma params_from_jax")
    return sd


class GemmaStateDictAdapter(LlamaStateDictAdapter):
    """The identity map over Gemma's state dict (Gemma 2 and Gemma 3 text)."""
