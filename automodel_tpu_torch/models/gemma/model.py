"""Gemma family (Gemma 2 and Gemma 3 text) causal LM as an ``nn.Module``.

Port of ``automodel_tpu/models/gemma/model.py``: ``GemmaConfig`` with
``from_hf`` (:54-103; a multimodal wrapper's ``text_config`` is not read,
since the vision-language Gemma 3 is refused by the registry) and
``GemmaForCausalLM``. What sets the family apart
from llama (modeling_gemma2.py, modeling_gemma3.py):

- zero-centered RMSNorm, ``x̂ · (1 + w)`` in fp32 then cast, whose weights
  init at 0 (``ops/norms.rms_norm_gemma``);
- sandwich norms: post-attention and post-FFN norms on the residual
  branch's output (:185, :194), besides the pre-norms;
- embeddings times ``embed_scale`` = sqrt(hidden), the scale cast to the
  compute dtype first as JAX does (:221): in bf16 sqrt(3584) = 59.866
  becomes 59.75;
- the attention scale ``query_pre_attn_scalar^-0.5`` (:177), not head_dim's;
- the attention-logit soft cap (Gemma 2: 50), applied inside the flash
  kernels under ``attn: flash``, and the final-logit soft cap (Gemma 2: 30)
  in ``logits`` and in ``fused_linear_ce`` (:297-300);
- ``layer_types``: sliding layers attend within ``sliding_window`` (Gemma
  2: even layers; Gemma 3: five of every six), with Gemma 3's local rope
  theta on them (two rope tables, :224-231);
- Gemma 3's per-head q/k norms (:160-162).

The layers are a Python loop with a static window per layer, each
attending through ``ops/attention.windowed_attention`` as JAX's unrolled
path does (``ops/attention.py:421``), and each under the backend's
``remat`` policy (models/common/stacking.py). Parameter names follow HF
(``pre_feedforward_layernorm``, ``post_feedforward_layernorm``, ...). KV-cache decode (serving Gemma)
waits for a later slice: ``cache=`` raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig
from automodel_tpu_torch.models.common.stacking import remat_wrap
from automodel_tpu_torch.models.gemma.state_dict_adapter import GemmaStateDictAdapter
from automodel_tpu_torch.models.llama.model import ACT_FNS, _linear, _proj
from automodel_tpu_torch.ops.attention import windowed_attention
from automodel_tpu_torch.ops.norms import rms_norm_gemma
from automodel_tpu_torch.ops.rope import apply_rope, rope_table


@dataclasses.dataclass(frozen=True)
class GemmaConfig(TransformerConfig):
    layer_types: tuple = ()  # "sliding_attention" | "full_attention" per layer
    rope_local_theta: float = 10000.0
    query_pre_attn_scalar: float = 256.0

    @classmethod
    def from_hf(cls, hf_cfg: Any) -> "GemmaConfig":
        get = lambda k, d=None: hf_cfg.get(k, d) if isinstance(hf_cfg, dict) else getattr(hf_cfg, k, d)
        model_type = get("model_type", "gemma2")
        base = TransformerConfig.from_hf(hf_cfg)
        L = base.num_layers
        lt = get("layer_types")
        if lt is None:
            if model_type == "gemma2":  # even layers sliding, odd full
                lt = ["sliding_attention" if i % 2 == 0 else "full_attention" for i in range(L)]
            else:  # gemma3: 5 local : 1 global
                lt = ["full_attention" if (i + 1) % 6 == 0 else "sliding_attention" for i in range(L)]
        # legacy configs say gelu, but HF runs the tanh approximation for
        # the family; transformers' GemmaConfig carries an explicit
        # hidden_activation of None, so `or` does the fallthrough
        act = get("hidden_activation") or get("hidden_act") or "gelu_pytorch_tanh"
        fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        fields.update(
            layer_types=tuple(lt),
            rope_local_theta=get("rope_local_base_freq", 10000.0) or 10000.0,
            query_pre_attn_scalar=get("query_pre_attn_scalar", base.head_dim),
            embed_scale=float(get("hidden_size")) ** 0.5,
            logits_soft_cap=get("final_logit_softcapping"),
            attn_soft_cap=get("attn_logit_softcapping"),
            sliding_window=get("sliding_window", 4096),
            qk_norm=model_type in ("gemma3", "gemma3_text"),
            tie_embeddings=bool(get("tie_word_embeddings", True)),
            act="gelu_pytorch_tanh" if act in ("gelu", "gelu_pytorch_tanh") else act,
        )
        return cls(**fields)

    def layer_window(self, i: int) -> Optional[int]:
        """The static window of layer ``i``: ``sliding_window`` on a sliding
        layer, none on a full one."""
        return self.sliding_window if self.layer_types[i] == "sliding_attention" else None


class GemmaRMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm_gemma(x, self.weight, self.eps)


class GemmaAttention(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype: torch.dtype, device):
        super().__init__()
        D = cfg.hidden_size
        self.q_proj = _linear(D, cfg.q_dim, cfg.attention_bias, dtype, device)
        self.k_proj = _linear(D, cfg.kv_dim, cfg.attention_bias, dtype, device)
        self.v_proj = _linear(D, cfg.kv_dim, cfg.attention_bias, dtype, device)
        self.o_proj = _linear(cfg.q_dim, D, False, dtype, device)
        if cfg.qk_norm:
            self.q_norm = GemmaRMSNorm(cfg.head_dim, cfg.rms_eps, dtype, device)
            self.k_norm = GemmaRMSNorm(cfg.head_dim, cfg.rms_eps, dtype, device)


class GemmaMLP(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype: torch.dtype, device):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(D, I, cfg.mlp_bias, dtype, device)
        self.up_proj = _linear(D, I, cfg.mlp_bias, dtype, device)
        self.down_proj = _linear(I, D, cfg.mlp_bias, dtype, device)


class GemmaDecoderLayer(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype: torch.dtype, device):
        super().__init__()
        self.self_attn = GemmaAttention(cfg, dtype, device)
        self.mlp = GemmaMLP(cfg, dtype, device)
        D, eps = cfg.hidden_size, cfg.rms_eps
        self.input_layernorm = GemmaRMSNorm(D, eps, dtype, device)
        self.post_attention_layernorm = GemmaRMSNorm(D, eps, dtype, device)
        self.pre_feedforward_layernorm = GemmaRMSNorm(D, eps, dtype, device)
        self.post_feedforward_layernorm = GemmaRMSNorm(D, eps, dtype, device)


class GemmaModel(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype: torch.dtype, device):
        super().__init__()
        self.embed_tokens = nn.utils.skip_init(
            nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype
        )
        self.layers = nn.ModuleList(GemmaDecoderLayer(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm = GemmaRMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)


class GemmaForCausalLM(nn.Module):
    """Built uninitialized on ``device`` in the param dtype;
    ``init_weights`` fills it from a generator, ``load_state_dict`` from a
    carried checkpoint. Parameters require grad when built ``trainable``."""

    supports_kv_cache = False
    state_dict_adapter = GemmaStateDictAdapter  # the HF key map

    def __init__(
        self,
        config: GemmaConfig,
        backend: BackendConfig = BackendConfig(),
        device=None,
        trainable: bool = False,
    ):
        super().__init__()
        if len(config.layer_types) != config.num_layers:
            raise ValueError(f"layer_types has {len(config.layer_types)} entries for {config.num_layers} layers")
        self.config = config
        self.backend = backend
        pd = backend.param_torch_dtype
        self.model = GemmaModel(config, pd, device)
        if not config.tie_embeddings:
            self.lm_head = _linear(config.hidden_size, config.vocab_size, False, pd, device)
        self.requires_grad_(trainable)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX package's scales (gemma/model.py
        init_params): projections ``N(0,1) / sqrt(fan_in)``, embeddings
        ``N(0,1) * 0.02``, the zero-centered norms 0 (a scale of one)."""
        for name, p in self.named_parameters():
            if name.endswith(("norm.weight", ".bias")):
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

    def _layer(self, i: int, layer: GemmaDecoderLayer, h: torch.Tensor, ropes: dict, segment_ids) -> torch.Tensor:
        cfg = self.config
        attn = layer.self_attn
        B, S, _ = h.shape
        x = layer.input_layernorm(h)
        q = _proj(x, attn.q_proj).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = _proj(x, attn.k_proj).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = _proj(x, attn.v_proj).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = attn.q_norm(q)
            k = attn.k_norm(k)
        sliding = cfg.layer_window(i) is not None
        cos, sin = ropes["local" if sliding else "global"]
        q, k = apply_rope(q, k, cos, sin)
        out = windowed_attention(
            q, k, v, backend=self.backend.attn, is_sliding=sliding, window=cfg.sliding_window, causal=True,
            scale=cfg.query_pre_attn_scalar**-0.5, segment_ids=segment_ids, logits_soft_cap=cfg.attn_soft_cap,
        )
        h = h + layer.post_attention_layernorm(_proj(out.reshape(B, S, cfg.q_dim), attn.o_proj))
        y = layer.pre_feedforward_layernorm(h)
        mlp = layer.mlp
        act = ACT_FNS[cfg.act]
        y = _proj(act(_proj(y, mlp.gate_proj)) * _proj(y, mlp.up_proj), mlp.down_proj)
        return h + layer.post_feedforward_layernorm(y)

    def hidden(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        cache: Any = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Embed (times ``embed_scale``) + decoder stack → final-norm hidden
        states [B, S, D] in the compute dtype."""
        if cache is not None:
            raise ValueError("GemmaForCausalLM: KV-cache decode (cache=) is not ported to the torch backend yet")
        cfg = self.config
        cd = self.compute_dtype
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
            position_ids = position_ids[None, :].expand(input_ids.shape)
        h = self.model.embed_tokens.weight[input_ids].to(cd)
        h = h * torch.tensor(cfg.embed_scale, dtype=cd, device=h.device)
        local = dataclasses.replace(cfg.rope, theta=cfg.rope_local_theta, scaling=None)
        ropes = {
            "global": rope_table(position_ids, cfg.head_dim, cfg.rope),
            "local": rope_table(position_ids, cfg.head_dim, local),
        }
        layer_fn = remat_wrap(self._layer, self.backend.remat)
        for i, layer in enumerate(self.model.layers):
            h = layer_fn(i, layer, h, ropes, segment_ids)
        return self.model.norm(h)

    def lm_head_weight(self) -> torch.Tensor:
        """The output projection [V, D] (the embedding when tied)."""
        return self.model.embed_tokens.weight if self.config.tie_embeddings else self.lm_head.weight

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states → logits in h's dtype, soft-capped (Gemma 2: 30)."""
        logits = F.linear(h, self.lm_head_weight().to(h.dtype))
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
    ) -> torch.Tensor:
        """Full forward → logits [B, S, V] in the compute dtype."""
        return self.logits(self.hidden(input_ids, position_ids, cache, segment_ids))
