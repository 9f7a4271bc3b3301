"""MoE configuration, a copy of ``MoEConfig`` (:15) of
``automodel_tpu/moe/config.py`` with its checks and ``from_hf`` (:72); the
port imports nothing of the JAX package, so it keeps its own, the
``gspmd`` dispatcher's ``capacity_factor`` and the ``a2a`` dispatcher's
``a2a_capacity_factor`` with JAX's defaults included. The gpt-oss expert variant (expert and router biases, the
clamped ``swiglu_oai`` activation) is taken, as ``models/gpt_oss`` sets it.
The other variants keep their fields, so the two configs match field for
field, but no family the port registers uses them, and ``__post_init__``
refuses each by name: interleaved gate/up (the JAX gpt-oss config keeps it
off, its adapter de-interleaves at the HF boundary), the non-gated relu2
experts (nemotron_v3) and the clamp ``activation_limit`` (step3p5)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

# expert variants of families the port does not register, with the only
# value it takes
_NOT_PORTED = dict(interleaved_gate_up=False, activation_limit=None)
ACTIVATIONS = ("swiglu", "swiglu_oai")  # relu2 (non-gated, nemotron_v3) is not ported


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    num_shared_experts: int = 0
    shared_expert_intermediate_size: int = 0
    # routing
    score_func: str = "softmax"  # softmax | sigmoid
    route_scale: float = 1.0
    norm_topk_prob: bool = False
    softmax_before_topk: bool = True  # score then pick (False: softmax over picked)
    n_group: int = 1  # node-limited (grouped) routing
    topk_group: int = 1
    # balancing
    aux_loss_coeff: float = 0.0  # sequence-level aux loss (DeepSeek style)
    bias_update_factor: float = 0.0  # aux-free bias balancing (V3); 0 = off
    expert_bias: bool = False  # e_score_correction_bias present
    # which layers are MoE: the first `num_dense_layers` stay dense MLP
    num_dense_layers: int = 0
    # shared-expert gating (qwen2-moe style sigmoid gate on shared output)
    shared_expert_gate: bool = False
    # dispatch capacity factor for the gspmd (einsum) dispatcher
    capacity_factor: float = 1.25
    # a2a dispatcher per-peer buffer bound, x the balanced load T*K/ep;
    # None = the strict worst case (dropless by construction)
    a2a_capacity_factor: Optional[float] = None
    # gpt-oss-style experts: bias terms on both projections, the clamped
    # (up+1)*glu activation, a learned router bias that feeds both selection
    # and weights. Interleaved gate/up, relu2 and the activation limit are
    # refused unless left at their defaults
    interleaved_gate_up: bool = False
    expert_mlp_bias: bool = False
    activation: str = "swiglu"  # swiglu | swiglu_oai | relu2 (non-gated)
    activation_limit: Optional[float] = None
    router_linear_bias: bool = False

    def __post_init__(self):
        for name, default in _NOT_PORTED.items():
            if getattr(self, name) != default:
                raise ValueError(
                    f"MoEConfig.{name}={getattr(self, name)!r} is not ported to the torch backend "
                    f"(no family the port registers sets it)"
                )
        if self.activation not in ACTIVATIONS:
            raise ValueError(
                f"MoEConfig.activation={self.activation!r} is not ported to the torch backend "
                f"(it takes {list(ACTIVATIONS)})"
            )
        if self.score_func not in ("softmax", "sigmoid"):
            raise ValueError(f"score_func {self.score_func!r}")
        if self.num_experts % self.n_group != 0:
            raise ValueError("num_experts must divide into n_group groups")
        if self.topk_group > self.n_group:
            raise ValueError("topk_group > n_group")

    @classmethod
    def from_hf(cls, get: Any) -> "Optional[MoEConfig]":
        """Build from an HF config getter fn (model-family adapters call this
        with their own field-name mapping on top)."""
        n = get("num_experts", None) or get("n_routed_experts", None)
        if not n:
            return None
        return cls(
            num_experts=n,
            num_experts_per_tok=get("num_experts_per_tok", None) or get("num_experts_per_token", 2),
            moe_intermediate_size=get("moe_intermediate_size", None) or get("intermediate_size"),
            num_shared_experts=get("n_shared_experts", 0) or 0,
            shared_expert_intermediate_size=get("shared_expert_intermediate_size", 0) or 0,
            score_func=get("scoring_func", "softmax"),
            route_scale=get("routed_scaling_factor", 1.0) or 1.0,
            norm_topk_prob=bool(get("norm_topk_prob", False)),
            n_group=get("n_group", 1) or 1,
            topk_group=get("topk_group", 1) or 1,
            aux_loss_coeff=get("router_aux_loss_coef", 0.0) or 0.0,
            num_dense_layers=get("first_k_dense_replace", 0) or 0,
        )
