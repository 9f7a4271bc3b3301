"""MoE causal LM, the Qwen3-MoE-shaped family, as an ``nn.Module``.

Port of ``automodel_tpu/models/qwen3_moe/model.py``: ``MoETransformerConfig``
with ``from_hf`` (:48), optional dense prefix layers
(``first_k_dense_replace``, :243-272), and ``MoEForCausalLM``, whose
forward returns ``(logits, MoEModelAux)`` and whose ``hidden`` returns
``(h, aux)``: the aux holds per-MoE-layer expert counts [L_moe, E] (int32,
on the device) and the summed aux loss. Attention is the llama block
(``models/llama/model.attention_block``), so ``attn: flash`` runs the flash
kernels; the routed experts run through ``backend.experts``: ``ragged``
(the grouped-matmul kernels), ``ragged_fused`` (the fused expert-MLP
kernels) or ``dense`` (plain torch). Any other experts backend raises by
name. Each decoder layer runs under the backend's ``remat`` policy
(models/common/stacking.py; ``full_save_dispatch`` keeps the experts'
sort permutations), and RoPE rotates the first ``rope_dim`` channels of a
head, as JAX's does (:220-221).

Parameter names follow HF (``model.layers.{i}.self_attn.*``,
``model.layers.{i}.mlp.gate.weight`` [E, D]) with the stacked expert
weights ``model.layers.{i}.mlp.experts.gate_up`` [E, D, 2I] and
``...experts.down`` [E, I, D]; ``state_dict_adapter`` carries the JAX
tree over. KV-cache decode (:184-245) threads the cache hook through the
llama attention block with one layer index over the dense prefix and the
MoE layers, as JAX's cache's layer axis does; the experts then run through
``backend.experts`` at decode's few rows a group. A subclass whose family
has no decode path (``models/gpt_oss``) sets ``supports_kv_cache = False``
and ``cache=`` raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig
from automodel_tpu_torch.models.common.stacking import DecoderLayer, call_layer, remat_wrap
from automodel_tpu_torch.models.llama.model import (
    ACT_FNS,
    LlamaAttention,
    LlamaMLP,
    RMSNorm,
    SHARDING_RULES as DENSE_RULES,
    _linear,
    _proj,
    attention_block,
    embed,
    lm_head_logits,
)
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import MoEStateDictAdapter
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import expert_backend
from automodel_tpu_torch.moe.gate import update_gate_bias
from automodel_tpu_torch.moe.layer import MoEBlock, moe_block
from automodel_tpu_torch.ops.rope import rope_table


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig(TransformerConfig):
    moe: Optional[MoEConfig] = None

    @classmethod
    def from_hf(cls, hf_cfg: Any) -> "MoETransformerConfig":
        base = TransformerConfig.from_hf(hf_cfg)
        get = lambda k, d=None: hf_cfg.get(k, d) if isinstance(hf_cfg, dict) else getattr(hf_cfg, k, d)
        model_type = get("model_type", "")
        # the one MoE family the port registers; the JAX from_hf also reads
        # glm4-moe and qwen2-moe configs, which wait for their own slice
        if model_type != "qwen3_moe":
            raise ValueError(f"model_type={model_type!r}: the torch backend's MoE family is qwen3_moe")
        aux_free = get("topk_method", None) == "noaux_tc"
        moe = MoEConfig(
            num_experts=get("num_experts", None) or get("n_routed_experts", None) or get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok", 8),
            moe_intermediate_size=get("moe_intermediate_size", None) or get("intermediate_size"),
            num_shared_experts=get("n_shared_experts", 0) or 0,
            shared_expert_intermediate_size=get("shared_expert_intermediate_size", 0)
            or get("moe_intermediate_size", 0)
            or 0,
            score_func=get("scoring_func", None) or "softmax",
            softmax_before_topk=True,
            route_scale=get("routed_scaling_factor", 1.0) or 1.0,
            norm_topk_prob=bool(get("norm_topk_prob", True)),
            n_group=get("n_group", 1) or 1,
            topk_group=get("topk_group", 1) or 1,
            aux_loss_coeff=get("router_aux_loss_coef", 0.0) or 0.0,
            num_dense_layers=get("first_k_dense_replace", 0) or 0,
            expert_bias=aux_free,
            bias_update_factor=0.001 if aux_free else 0.0,
        )
        fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        fields["moe"] = moe
        fields["qk_norm"] = True
        return cls(**fields)


class MoEModelAux(NamedTuple):
    expert_counts: torch.Tensor  # [L_moe, E] int32
    aux_loss: torch.Tensor  # scalar fp32


class MoEDecoderLayer(DecoderLayer):
    def __init__(self, cfg: MoETransformerConfig, dense: bool, dtype: torch.dtype, device):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.mlp = LlamaMLP(cfg, dtype, device) if dense else MoEBlock(cfg.moe, cfg.hidden_size, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)


class MoEModel(nn.Module):
    def __init__(self, cfg: MoETransformerConfig, dtype: torch.dtype, device, layer_cls: type = MoEDecoderLayer):
        super().__init__()
        nd = cfg.moe.num_dense_layers
        self.embed_tokens = nn.utils.skip_init(
            nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype
        )
        self.layers = nn.ModuleList(layer_cls(cfg, i < nd, dtype, device) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)



# automodel_tpu/models/qwen3_moe/model.py:410-421, copied: the dense rules
# match here too (re.search); the expert slabs carry ``tensor`` on their
# intermediate dim, which the port's tensor parallelism does not take yet
# (parallel/plans.check_tp refuses tp on an MoE family).
SHARDING_RULES: list[tuple[str, tuple]] = [
    (r"moe/router/weight$", (None, None, None)),
    (r"moe/router/(bias|linear_bias)$", (None, None)),
    (r"moe/experts/gate_up$", (None, "expert", "expert_fsdp", "tensor")),
    (r"moe/experts/down$", (None, "expert", "tensor", "expert_fsdp")),
    (r"moe/experts/gate_up_bias$", (None, "expert", "tensor")),
    (r"moe/experts/down_bias$", (None, "expert", None)),
    (r"moe/shared/(gate|up)_proj/kernel$", (None, "fsdp", "tensor")),
    (r"moe/shared/down_proj/kernel$", (None, "tensor", "fsdp")),
    (r"moe/shared_gate/kernel$", (None, None, None)),
    *DENSE_RULES,
]

class MoEForCausalLM(nn.Module):
    """Built uninitialized on ``device`` in the param dtype;
    ``init_weights`` fills it from a generator, ``load_state_dict`` from a
    carried checkpoint. Parameters require grad when built ``trainable``.
    A family with other decoder layers (``models/gpt_oss``) subclasses it
    with its own ``layer_cls``."""

    # the JAX param tree's layer stacks (the dense prefix, then the MoE
    # layers): the first path component a tensor's grad norm groups under
    jax_layer_stacks: Optional[tuple[str, str]] = ("dense_layers", "moe_layers")

    supports_kv_cache = True
    layer_cls: type = MoEDecoderLayer
    state_dict_adapter = MoEStateDictAdapter  # the HF key map
    sharding_rules = SHARDING_RULES

    def __init__(
        self,
        config: MoETransformerConfig,
        backend: BackendConfig = BackendConfig(experts="ragged"),
        device=None,
        trainable: bool = False,
    ):
        super().__init__()
        if config.moe is None:
            raise ValueError("MoEForCausalLM needs a config with an MoE section (num_experts)")
        expert_backend(backend.experts)  # raises by name for a backend the port does not have
        self.config = config
        self.backend = backend
        pd = backend.param_torch_dtype
        self.model = MoEModel(config, pd, device, self.layer_cls)
        if not config.tie_embeddings:
            self.lm_head = _linear(config.hidden_size, config.vocab_size, False, pd, device)
        self.requires_grad_(trainable)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX package's scales: every matrix (the
        router, the stacked experts, attention and dense-MLP projections)
        ``N(0,1) / sqrt(fan_in)`` with fan_in its second axis (D for the
        router and gate_up, I for down, the input width of an
        ``nn.Linear``); embeddings ``N(0,1) * 0.02``; norms one; biases,
        attention sinks and the shared-expert gate zero."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(("bias", "sinks", "shared_expert_gate.weight")):
                p.zero_()
            else:
                x = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                if name == "model.embed_tokens.weight":
                    p.copy_(x.to(p.dtype) * 0.02)
                else:
                    denom = torch.tensor(math.sqrt(p.shape[1]), dtype=p.dtype, device=p.device)
                    p.copy_(x.to(p.dtype) / denom)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.backend.compute_torch_dtype

    def moe_layers(self) -> list[MoEBlock]:
        return [layer.mlp for layer in self.model.layers if isinstance(layer.mlp, MoEBlock)]

    def hidden(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        cache: Any = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, MoEModelAux]:
        """Embed + decoder stack → (final-norm hidden states [B, S, D] in
        the compute dtype, MoEModelAux). ``cache``: the generation hook
        (the llama family's), whose layer index runs over the dense prefix
        and the MoE layers in order."""
        if cache is not None and not self.supports_kv_cache:
            raise ValueError(f"{type(self).__name__}: KV-cache decode (cache=) is not ported to the torch backend")
        cfg = self.config
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
            position_ids = position_ids[None, :].expand(input_ids.shape)
        h = embed(self.model.embed_tokens, input_ids).to(self.compute_dtype)
        cos, sin = rope_table(position_ids, cfg.rope_dim or cfg.head_dim, cfg.rope)
        # inference with a cache never recomputes (it has no backward)
        layer_fn = call_layer(self._layer)
        layer_fn = layer_fn if cache is not None else remat_wrap(layer_fn, self.backend.remat)
        counts, aux_losses = [], []
        for i, layer in enumerate(self.model.layers):
            h, aux = layer_fn(i, layer, h, cos, sin, cache, segment_ids)
            if aux is not None:
                counts.append(aux.expert_counts)
                aux_losses.append(aux.aux_loss)
        return self.model.norm(h), MoEModelAux(torch.stack(counts), torch.stack(aux_losses).sum())

    def _layer(self, i: int, layer: nn.Module, h, cos, sin, cache, segment_ids):
        """Decoder layer ``i`` → (h, the MoE block's aux, or None after a
        dense MLP)."""
        cfg = self.config
        h = attention_block(cfg, self.backend, layer, i, h, cos, sin, cache, segment_ids)
        x = layer.post_attention_layernorm(h)
        mlp = layer.mlp
        act = ACT_FNS[cfg.act]
        if isinstance(mlp, MoEBlock):
            out, aux = moe_block(x, mlp, act, self.backend.experts, self.backend.fake_balanced_gate, act_name=cfg.act)
            return h + out, aux
        return h + _proj(act(_proj(x, mlp.gate_proj)) * _proj(x, mlp.up_proj), mlp.down_proj), None

    def lm_head_weight(self) -> torch.Tensor:
        """The output projection [V, D] (the embedding when tied)."""
        return self.model.embed_tokens.weight if self.config.tie_embeddings else self.lm_head.weight

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        logits = lm_head_logits(h, self.lm_head_weight())
        cap = self.config.logits_soft_cap
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        return logits

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        cache: Any = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, MoEModelAux]:
        """Full forward → (logits [B, S, V] in the compute dtype, aux)."""
        h, aux = self.hidden(input_ids, position_ids, cache, segment_ids)
        return self.logits(h), aux

    @torch.no_grad()
    def post_step_fn(self, extras: dict) -> None:
        """Aux-free balancing after the optimizer step (:465): each MoE
        layer's selection bias moves by ``update_gate_bias`` from the
        expert counts summed over the step's microbatches."""
        u = self.config.moe.bias_update_factor
        if u <= 0 or "expert_counts" not in extras:
            return
        for block, c in zip(self.moe_layers(), extras["expert_counts"]):
            router = getattr(block, block.router_name)
            if router.bias is not None:
                router.bias.copy_(update_gate_bias(router.bias, c, u))
