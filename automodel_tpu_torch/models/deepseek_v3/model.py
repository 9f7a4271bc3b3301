"""DeepSeek-V3: MLA attention on the MoE family's decoder, as an ``nn.Module``.

Port of ``automodel_tpu/models/deepseek_v3/model.py``. The MoE stack, the
dense prefix (``first_k_dense_replace``), the shared experts, the sigmoid
gate with grouped routing and its correction bias, the aux plumbing and
the ``post_step_fn`` bias update are ``models/qwen3_moe``'s; the attention
is multi-head latent attention (``mla_block``, JAX :125-187):

- q: ``q_a_proj`` [D → q_lora_rank], RMS norm (``q_a_layernorm``),
  ``q_b_proj`` [→ N * (nope + rope)]; or one ``q_proj`` when
  ``q_lora_rank`` is null (Moonlight);
- kv: ``kv_a_proj_with_mqa`` [D → kv_lora_rank + rope], split into the
  latent and one rope head shared by every head; the latent through
  ``kv_a_layernorm`` and ``kv_b_proj`` [→ N * (nope + v)];
- RoPE on the rope parts (pair-interleaved channels under
  ``rope_interleave``), the shared k rope head broadcast over the heads;
- attention over concat(nope, rope) = ``qk_head_dim`` channels at
  ``mla_attn_scale`` (qk_head_dim^-0.5, times yarn's mscale squared).
  Under ``attn: flash`` (and ``ring``, whose steps are the same kernels) v
  is zero-padded from ``v_head_dim`` to ``qk_head_dim`` and the output
  sliced back, as JAX pads it for its kernel: the flash kernels take one
  head_dim for q, k and v (192 at DeepSeek-V3's widths).

``cache=`` is refused by name: JAX's DeepSeek-V3 has no KV-cache path.
Parameter names are HF's (``model.layers.{i}.self_attn.kv_a_proj_with_mqa
.weight``, ...), so the HF map is the MoE family's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.common.stacking import DecoderLayer
from automodel_tpu_torch.models.llama.model import LlamaMLP, RMSNorm, _linear, _proj, tp_group_of
from automodel_tpu_torch.models.qwen3_moe.model import (
    SHARDING_RULES as MOE_RULES,
    MoEForCausalLM,
    MoETransformerConfig,
)
from automodel_tpu_torch.moe.layer import MoEBlock
from automodel_tpu_torch.ops.attention import attention
from automodel_tpu_torch.ops.rope import apply_rope
from automodel_tpu_torch.parallel.autograd import grad_sum


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config(MoETransformerConfig):
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_interleave: bool = True

    @classmethod
    def from_hf(cls, hf_cfg: Any) -> "DeepseekV3Config":
        """JAX :53-82: the MoE config, the MLA widths, no q/k norms, and
        the router's sigmoid scores with the correction bias always there
        (aux-free balancing, factor 1e-3 unless the MoE config set one)."""
        base = MoETransformerConfig.from_hf(hf_cfg)
        get = lambda k, d=None: hf_cfg.get(k, d) if isinstance(hf_cfg, dict) else getattr(hf_cfg, k, d)
        fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        fields.update(
            q_lora_rank=get("q_lora_rank"),
            kv_lora_rank=get("kv_lora_rank", 512),
            qk_nope_head_dim=get("qk_nope_head_dim", 128),
            qk_rope_head_dim=get("qk_rope_head_dim", 64),
            v_head_dim=get("v_head_dim", 128),
            rope_interleave=bool(get("rope_interleave", True)),
            qk_norm=False,
            moe=dataclasses.replace(
                fields["moe"],
                # V3 scores with a sigmoid whatever the config says (HF
                # hardcodes it), and always carries e_score_correction_bias
                score_func=get("scoring_func", None) or "sigmoid",
                expert_bias=True,
                bias_update_factor=fields["moe"].bias_update_factor or 1e-3,
            ),
        )
        return cls(**fields)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def mla_attn_scale(self) -> float:
        """HF DeepseekV3Attention's softmax scale: qk_head_dim^-0.5, times
        yarn's mscale squared (the ``mscale_all_dim`` variant)."""
        scale = self.qk_head_dim**-0.5
        r = self.rope
        if r.scaling == "yarn" and r.factor > 1.0 and r.mscale_all_dim:
            m = 0.1 * r.mscale_all_dim * math.log(r.factor) + 1.0
            scale = scale * m * m
        return scale


class MLAAttention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype, device):
        super().__init__()
        D, N = cfg.hidden_size, cfg.num_heads
        nope, rope, v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            self.q_a_proj = _linear(D, cfg.q_lora_rank, False, dtype, device)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_eps, dtype, device)
            self.q_b_proj = _linear(cfg.q_lora_rank, N * (nope + rope), False, dtype, device)
        else:
            self.q_proj = _linear(D, N * (nope + rope), False, dtype, device)
        self.kv_a_proj_with_mqa = _linear(D, cfg.kv_lora_rank + rope, False, dtype, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_eps, dtype, device)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, N * (nope + v), False, dtype, device)
        self.o_proj = _linear(N * v, D, False, dtype, device)


class DeepseekV3DecoderLayer(DecoderLayer):
    def __init__(self, cfg: DeepseekV3Config, dense: bool, dtype: torch.dtype, device):
        super().__init__()
        self.self_attn = MLAAttention(cfg, dtype, device)
        self.mlp = LlamaMLP(cfg, dtype, device) if dense else MoEBlock(cfg.moe, cfg.hidden_size, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype, device)


# the flash kernels take one head_dim for q, k and v: v is padded to it
PADDED_V_BACKENDS = ("flash", "ring")


def mla_block(
    cfg: DeepseekV3Config,
    backend: BackendConfig,
    layer: nn.Module,
    i: int,
    h: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache: Any = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """h + multi-head latent attention of decoder layer ``i`` (JAX
    :125-187). ``cache`` is refused: DeepSeek-V3 has no decode path."""
    if cache is not None:
        raise ValueError("DeepseekV3ForCausalLM: KV-cache decode (cache=) is not a path of this family")
    attn = layer.self_attn
    B, S, _ = h.shape
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    x = layer.input_layernorm(h)
    if cfg.q_lora_rank:
        q = _proj(attn.q_a_layernorm(_proj(x, attn.q_a_proj)), attn.q_b_proj)
    else:
        q = _proj(x, attn.q_proj)
    # the head count read off the projection: a rank's own under tensor parallelism
    N = q.shape[-1] // (nope + rope)
    q_pass, q_rot = q.reshape(B, S, N, nope + rope).split([nope, rope], dim=-1)
    k_latent, k_rot = _proj(x, attn.kv_a_proj_with_mqa).split([cfg.kv_lora_rank, rope], dim=-1)
    group = tp_group_of(attn.kv_b_proj)
    if group is not None:
        # the shared rope head, read whole by each rank's heads: its
        # gradient is the sum of the ranks' partials
        k_rot = grad_sum(k_rot, group)
    kv = _proj(attn.kv_a_layernorm(k_latent), attn.kv_b_proj).reshape(B, S, N, nope + vdim)
    k_pass, v = kv.split([nope, vdim], dim=-1)
    # one rope head shared by every head
    q_rot, k_rot = apply_rope(q_rot, k_rot[:, :, None, :], cos, sin, interleave=cfg.rope_interleave)
    qh = torch.cat([q_pass, q_rot], dim=-1)
    kh = torch.cat([k_pass, k_rot.expand(B, S, N, rope)], dim=-1)
    pad_v = backend.attn in PADDED_V_BACKENDS and vdim != cfg.qk_head_dim
    if pad_v:
        v = F.pad(v, (0, cfg.qk_head_dim - vdim))
    out = attention(qh, kh, v, backend=backend.attn, causal=True, scale=cfg.mla_attn_scale, segment_ids=segment_ids)
    if pad_v:
        out = out[..., :vdim]
    return h + _proj(out.reshape(B, S, N * vdim), attn.o_proj)


# automodel_tpu/models/deepseek_v3/model.py:203-213, copied: the MLA
# projections' rules, then the MoE family's
SHARDING_RULES: list[tuple[str, tuple]] = [
    (r"attn/q_a_proj/kernel$", (None, "fsdp", None)),
    (r"attn/q_a_norm/scale$", (None, None)),
    (r"attn/q_b_proj/kernel$", (None, "fsdp", "tensor")),
    (r"attn/q_proj/kernel$", (None, "fsdp", "tensor")),
    (r"attn/kv_a_proj/kernel$", (None, "fsdp", None)),
    (r"attn/kv_a_norm/scale$", (None, None)),
    (r"attn/kv_b_proj/kernel$", (None, "fsdp", "tensor")),
    (r"attn/o_proj/kernel$", (None, "tensor", "fsdp")),
    *MOE_RULES,
]


class DeepseekV3ForCausalLM(MoEForCausalLM):
    """The MoE family's model with MLA layers; RoPE rotates
    ``qk_rope_head_dim`` channels."""

    supports_kv_cache = False
    layer_cls = DeepseekV3DecoderLayer
    sharding_rules = SHARDING_RULES
    attention = staticmethod(mla_block)

    @property
    def rope_dim(self) -> int:
        return self.config.qk_rope_head_dim
