"""Dense Llama-family causal LM as an ``nn.Module``.

Port of the generic path of ``automodel_tpu/models/llama/model.py`` (no
fp8, LoRA or NF4). Parameter names follow HF transformers
(``model.layers.{i}.self_attn.q_proj.weight``, ``[out, in]``), so a later
``from_pretrained`` maps safetensors keys one to one; ``state_dict_adapter``
carries the JAX package's stacked ``[L, in, out]`` tree over.

Arithmetic follows the JAX model: weights are cast to the compute dtype at
each use, RMSNorm accumulates in fp32, RoPE is applied in the compute
dtype, logits come out in the compute dtype.

Without a cache (the training forward) each layer attends through
``ops.attention.attention`` with the configured backend (``sdpa``, or
``flash``: the flash-attention kernels), causal over the token index, with
packed ``segment_ids`` if given; RoPE follows ``position_ids`` and
rotates the first ``rope_dim`` channels of a head under a
``partial_rotary_factor`` (Phi-3). Each decoder layer runs under the
backend's ``remat`` policy (models/common/stacking.py) when there is no
cache.

The KV-cache hook is the JAX one: with ``cache`` given, each attention
layer calls ``cache.write(layer, k, v)`` with its post-RoPE keys and
values and then, when ``cache.attends_cache``, ``cache.attend(layer, q,
layer_kv, ...)``; the cache object owns where K/V live and which attention
runs (serving/paged.py, generation/kv_cache.py). A cache that does not
attend (the ``generate`` path's prefill) leaves the layer attending over
the incoming block through the configured backend, with ``segment_ids``
keeping the pads apart.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig
from automodel_tpu_torch.models.common.stacking import DecoderLayer, call_layer, remat_wrap
from automodel_tpu_torch.models.llama.state_dict_adapter import LlamaStateDictAdapter
from automodel_tpu_torch.ops.attention import attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import apply_rope, rope_table

ACT_FNS = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


class Linear(nn.Linear):
    """``nn.Linear`` in the input's dtype: the weight (and bias) cast to it
    at each use and the bias added after the product, as the JAX model
    computes. A tensor-parallel plan's hooks (parallel/plans.py) place the
    input and the output around this call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def _linear(
    in_features: int, out_features: int, bias: bool, dtype: torch.dtype, device
) -> nn.Linear:
    return nn.utils.skip_init(
        Linear, in_features, out_features, bias=bias, device=device, dtype=dtype
    )


def _proj(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    # a tensor-parallel plan's hooks ride the module call; without one the
    # same product skips the call's overhead (the host-bound decode path)
    return lin(x) if isinstance(lin.weight, DTensor) else lin.forward(x)


def embed(emb: nn.Embedding, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``input_ids``. A vocab-sharded embedding (a
    DTensor weight under tensor parallelism) goes through its module call,
    whose plan masks the ids other ranks hold and sums the lookups."""
    if isinstance(emb.weight, DTensor):
        return emb(input_ids)
    return emb.weight[input_ids]


def lm_head_logits(h: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """h @ weight^T in h's dtype; a vocab-sharded weight is gathered whole
    first (``full_tensor``, whose backward keeps each rank's rows)."""
    if isinstance(weight, DTensor):
        weight = weight.full_tensor()
    return F.linear(h, weight.to(h.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype, device, o_bias: bool = False):
        super().__init__()
        D = cfg.hidden_size
        self.q_proj = _linear(D, cfg.q_dim, cfg.attention_bias, dtype, device)
        self.k_proj = _linear(D, cfg.kv_dim, cfg.attention_bias, dtype, device)
        self.v_proj = _linear(D, cfg.kv_dim, cfg.attention_bias, dtype, device)
        self.o_proj = _linear(cfg.q_dim, D, o_bias, dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_eps, dtype, device)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_eps, dtype, device)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype, device):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(D, I, cfg.mlp_bias, dtype, device)
        self.up_proj = _linear(D, I, cfg.mlp_bias, dtype, device)
        self.down_proj = _linear(I, D, cfg.mlp_bias, dtype, device)


class LlamaDecoderLayer(DecoderLayer):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype, device):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.mlp = LlamaMLP(cfg, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)


class LlamaModel(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype, device):
        super().__init__()
        self.embed_tokens = nn.utils.skip_init(
            nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype
        )
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg, dtype, device) for _ in range(cfg.num_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)


def layer_sliding_window(cfg: TransformerConfig, layer_idx: int) -> Optional[int]:
    """HF qwen2 semantics: layers < max_window_layers attend fully; a config
    with ``layer_types`` (gpt-oss) windows its ``sliding_attention`` layers
    only."""
    if cfg.sliding_window is None:
        return None
    layer_types = getattr(cfg, "layer_types", ())
    if layer_types:
        return cfg.sliding_window if layer_types[layer_idx] == "sliding_attention" else None
    if cfg.max_window_layers and layer_idx < cfg.max_window_layers:
        return None
    return cfg.sliding_window


def attention_block(
    cfg: TransformerConfig,
    backend: BackendConfig,
    layer: nn.Module,
    i: int,
    h: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache: Any = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """h + self-attention of decoder layer ``i`` (its ``input_layernorm``
    and ``self_attn``), shared by the llama and MoE families: through the
    configured backend (``flash``: the flash kernels) without a cache or
    with one that does not attend (prefill), and through ``cache.attend``
    with one that does; ``cache.write`` takes the keys and values first. A ``self_attn``
    with ``sinks`` (gpt-oss) attends with them."""
    attn = layer.self_attn
    B, S, _ = h.shape
    x = layer.input_layernorm(h)
    # head counts read off the projections: a rank's own under tensor parallelism
    q = _proj(x, attn.q_proj).reshape(B, S, -1, cfg.head_dim)
    k = _proj(x, attn.k_proj).reshape(B, S, -1, cfg.head_dim)
    v = _proj(x, attn.v_proj).reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = attn.q_norm(q)
        k = attn.k_norm(k)
    q, k = apply_rope(q, k, cos, sin)
    window = layer_sliding_window(cfg, i)
    layer_kv = None if cache is None else cache.write(i, k, v)
    if layer_kv is not None and cache.attends_cache:
        out = cache.attend(
            i, q, layer_kv, sliding_window=window,
            scale=cfg.attn_scale, logits_soft_cap=cfg.attn_soft_cap,
        )
    else:
        out = attention(
            q, k, v, backend=backend.attn, causal=True, scale=cfg.attn_scale,
            segment_ids=segment_ids, logits_soft_cap=cfg.attn_soft_cap,
            sliding_window=window, sinks=getattr(attn, "sinks", None),
        )
    return h + _proj(out.reshape(B, S, -1), attn.o_proj)


# Logical dim specs per JAX param path (automodel_tpu/models/llama/model.py
# :383-396, copied): parallel/plans.py matches them against each tensor's
# JAX path and applies tensor parallelism where they name ``tensor``.
SHARDING_RULES: list[tuple[str, tuple]] = [
    (r"embed/embedding$", ("tensor", "fsdp")),
    (r"layers/attn/[qkv]_proj/kernel$", (None, "fsdp", "tensor")),
    (r"layers/attn/[qkv]_proj/bias$", (None, "tensor")),
    (r"layers/attn/o_proj/kernel$", (None, "tensor", "fsdp")),
    (r"layers/attn/[qk]_norm/scale$", (None, None)),
    (r"layers/mlp/(gate|up)_proj/kernel$", (None, "fsdp", "tensor")),
    (r"layers/mlp/(gate|up)_proj/bias$", (None, "tensor")),
    (r"layers/mlp/down_proj/kernel$", (None, "tensor", "fsdp")),
    (r"layers/mlp/down_proj/bias$", (None, None)),
    (r"layers/.*norm/scale$", (None, "fsdp")),
    (r"final_norm/scale$", ("fsdp",)),
    (r"lm_head/kernel$", ("fsdp", "tensor")),
]


class LlamaForCausalLM(nn.Module):
    """Parameters are created uninitialized on ``device`` in the param
    dtype; ``init_weights`` fills them from a generator, ``load_state_dict``
    from a carried checkpoint. They require grad only when the model is
    built ``trainable`` (the finetune recipe); serving builds it frozen."""

    supports_kv_cache = True
    state_dict_adapter = LlamaStateDictAdapter  # the HF key map
    sharding_rules = SHARDING_RULES

    def __init__(
        self,
        config: TransformerConfig,
        backend: BackendConfig = BackendConfig(),
        device=None,
        trainable: bool = False,
    ):
        super().__init__()
        self.config = config
        self.backend = backend
        pd = backend.param_torch_dtype
        self.model = LlamaModel(config, pd, device)
        if not config.tie_embeddings:
            self.lm_head = _linear(config.hidden_size, config.vocab_size, False, pd, device)
        self.requires_grad_(trainable)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX package's scales (model.py init_params):
        projection kernels ``N(0,1) / sqrt(fan_in)``, embeddings
        ``N(0,1) * 0.02``, norms one, biases zero. Draws happen on the
        generator's device in parameter order."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            elif name == "model.embed_tokens.weight":
                x = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                p.copy_(x.to(p.dtype) * 0.02)
            else:
                fan_in = p.shape[1]
                x = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                denom = torch.tensor(math.sqrt(fan_in), dtype=p.dtype, device=p.device)
                p.copy_(x.to(p.dtype) / denom)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.backend.compute_torch_dtype

    def hidden(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        cache: Any = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Embed + decoder stack → final-norm hidden states [B, S, D] in
        the compute dtype."""
        cfg = self.config
        cd = self.compute_dtype
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
            position_ids = position_ids[None, :].expand(input_ids.shape)
        h = embed(self.model.embed_tokens, input_ids).to(cd)
        cos, sin = rope_table(position_ids, cfg.rope_dim or cfg.head_dim, cfg.rope)
        # inference with a cache never recomputes (it has no backward)
        layer_fn = call_layer(self._layer)
        layer_fn = layer_fn if cache is not None else remat_wrap(layer_fn, self.backend.remat)
        for i, layer in enumerate(self.model.layers):
            h = layer_fn(i, layer, h, cos, sin, cache, segment_ids)
        return self.model.norm(h)

    def _layer(self, i: int, layer: LlamaDecoderLayer, h, cos, sin, cache, segment_ids) -> torch.Tensor:
        """Decoder layer ``i``: h + attention, then h + the gated MLP."""
        h = attention_block(self.config, self.backend, layer, i, h, cos, sin, cache, segment_ids)
        x = layer.post_attention_layernorm(h)
        mlp = layer.mlp
        act = ACT_FNS[self.config.act]
        return h + _proj(act(_proj(x, mlp.gate_proj)) * _proj(x, mlp.up_proj), mlp.down_proj)

    def lm_head_weight(self) -> torch.Tensor:
        """The output projection [V, D] (the embedding when tied)."""
        return self.model.embed_tokens.weight if self.config.tie_embeddings else self.lm_head.weight

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states → logits in h's dtype (soft-capped if configured)."""
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
    ) -> torch.Tensor:
        """Full forward → logits [B, S, V] in the compute dtype."""
        return self.logits(self.hidden(input_ids, position_ids, cache, segment_ids))
