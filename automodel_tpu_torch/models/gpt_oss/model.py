"""GPT-OSS causal LM as an ``nn.Module``.

Port of ``automodel_tpu/models/gpt_oss/model.py``: ``GptOssConfig`` with
``from_hf`` (:52) and ``GptOssForCausalLM`` (:216), whose forward returns
``(logits, MoEModelAux)``. The family's fingerprint (modeling_gpt_oss.py):

- every layer is MoE: experts with biases on both projections and the
  clamped ``swiglu_oai`` activation, gate and up held as the contiguous
  halves of ``gate_up`` (the JAX adapter de-interleaves HF's layout at the
  checkpoint boundary); a router with a learned bias, top-k over the raw
  logits and a softmax over the picked ones;
- attention with q/k/v and o biases and per-head learned sinks, sliding
  (``sliding_window``) and full layers alternating by ``layer_types``,
  yarn rope.

It is the Qwen3-MoE model of ``models/qwen3_moe`` with its own decoder
layer: the shared attention block (``models/llama/model.attention_block``,
so ``attn: flash`` runs the flash kernels with the sinks folded around
them) and the MoE block of ``moe/layer.py``, whose experts default to
``ragged_fused`` (the fused expert-MLP kernels). Per-layer windows are
static: the layers are a Python loop, where JAX's scan branched with
``lax.cond``. Parameter names follow HF where a module carries them
(``self_attn.sinks``, ``mlp.router``, ``mlp.experts.*``; the learned router
bias is ``mlp.router.linear_bias``, the JAX name). The JAX package has no
KV-cache decode for the family, so neither has the port: ``cache=``
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig
from automodel_tpu_torch.models.common.stacking import DecoderLayer
from automodel_tpu_torch.models.llama.model import LlamaAttention, RMSNorm
from automodel_tpu_torch.models.gpt_oss.state_dict_adapter import GptOssStateDictAdapter
from automodel_tpu_torch.models.qwen3_moe.model import MoEForCausalLM
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.layer import MoEBlock


@dataclasses.dataclass(frozen=True)
class GptOssConfig(TransformerConfig):
    moe: Optional[MoEConfig] = None
    layer_types: tuple = ()

    @classmethod
    def from_hf(cls, hf_cfg: Any) -> "GptOssConfig":
        get = lambda k, d=None: hf_cfg.get(k, d) if isinstance(hf_cfg, dict) else getattr(hf_cfg, k, d)
        base = TransformerConfig.from_hf(hf_cfg)
        lt = get("layer_types") or [
            "sliding_attention" if i % 2 == 0 else "full_attention" for i in range(base.num_layers)
        ]
        moe = MoEConfig(
            num_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 4),
            moe_intermediate_size=get("intermediate_size"),
            score_func="softmax",
            softmax_before_topk=False,  # softmax over the picked logits
            router_linear_bias=True,
            expert_mlp_bias=True,
            activation="swiglu_oai",
            aux_loss_coeff=get("router_aux_loss_coef", 0.0) or 0.0,
        )
        fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        fields.update(
            moe=moe,
            layer_types=tuple(lt),
            attention_bias=bool(get("attention_bias", True)),
            sliding_window=get("sliding_window", 128),
        )
        return cls(**fields)


class GptOssAttention(LlamaAttention):
    """q/k/v (biased when ``attention_bias``) and a biased o projection, and
    the per-head sink logits ``sinks`` [N] in the param dtype."""

    def __init__(self, cfg: GptOssConfig, dtype: torch.dtype, device):
        super().__init__(cfg, dtype, device, o_bias=True)
        self.sinks = nn.Parameter(torch.empty(cfg.num_heads, dtype=dtype, device=device))


class GptOssDecoderLayer(DecoderLayer):
    def __init__(self, cfg: GptOssConfig, dense: bool, dtype: torch.dtype, device):
        super().__init__()
        if dense:
            raise ValueError("GPT-OSS has no dense layers")
        self.self_attn = GptOssAttention(cfg, dtype, device)
        self.mlp = MoEBlock(cfg.moe, cfg.hidden_size, dtype, device, router_name="router")
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)



# automodel_tpu/models/gpt_oss/model.py:195-212, copied (parallel/plans.py)
SHARDING_RULES = [
    (r"attn/sinks$", (None, None)),
    (r"attn/o_proj/bias$", (None, None)),
    (r"embed/embedding$", ("tensor", "fsdp")),
    (r"layers/attn/[qkv]_proj/kernel$", (None, "fsdp", "tensor")),
    (r"layers/attn/[qkv]_proj/bias$", (None, "tensor")),
    (r"layers/attn/o_proj/kernel$", (None, "tensor", "fsdp")),
    (r"moe/router/weight$", (None, None, None)),
    (r"moe/router/(bias|linear_bias)$", (None, None)),
    (r"moe/experts/gate_up$", (None, "expert", "expert_fsdp", "tensor")),
    (r"moe/experts/down$", (None, "expert", "tensor", "expert_fsdp")),
    (r"moe/experts/gate_up_bias$", (None, "expert", "tensor")),
    (r"moe/experts/down_bias$", (None, "expert", None)),
    (r"layers/.*norm/scale$", (None, None)),
    (r"final_norm/scale$", (None,)),
    (r"lm_head/kernel$", ("fsdp", "tensor")),
]

class GptOssForCausalLM(MoEForCausalLM):
    """``init_weights`` draws the JAX scales (the router and gate_up with
    fan_in D, down with fan_in I, projections with their input width,
    embeddings ``N(0,1) * 0.02``) and zeroes every bias and sink."""

    jax_layer_stacks = None  # one JAX stack, ``layers``

    supports_kv_cache = False
    layer_cls = GptOssDecoderLayer
    state_dict_adapter = GptOssStateDictAdapter  # the HF key map
    sharding_rules = SHARDING_RULES
    # the layout contract of gate_up, versioned as the JAX model's
    # (automodel_tpu/models/gpt_oss/model.py:231): contiguous g | u halves,
    # not HF's interleave. The checkpointer stamps it on save and refuses a
    # native restore whose stamp lacks or differs from it.
    native_layout_markers = {"gpt_oss_gate_up": "contiguous_v1"}

    def __init__(
        self,
        config: GptOssConfig,
        backend: BackendConfig = BackendConfig(experts="ragged_fused"),
        device=None,
        trainable: bool = False,
    ):
        super().__init__(config, backend, device=device, trainable=trainable)
