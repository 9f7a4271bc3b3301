"""The MoE block: gate → experts → (shared experts) → combine.

Port of ``automodel_tpu/moe/layer.py``: ``make_act2`` (:29), ``moe_block``
(:64) and ``MoEAux``. ``MoEBlock`` holds one layer's parameters under HF
names: the router (``gate.weight`` [E, D] for Qwen3-MoE, ``router.weight``
for GPT-OSS; the transpose of the JAX ``router/weight``),
``shared_experts.{gate,up,down}_proj`` and ``shared_expert_gate``, with the
stacked expert weights ``experts.gate_up`` [E, D, 2I] and ``experts.down``
[E, I, D] in the JAX layout, which is the grouped-matmul kernels' rhs
layout. The aux-free selection bias (``<router>.bias``, [E] fp32) is a
buffer: it gets no gradient and is moved only by ``update_gate_bias`` after
the optimizer step. The gpt-oss variant adds a learned router bias
(``<router>.linear_bias``, [E] fp32, a parameter) and expert biases
(``experts.gate_up_bias`` [E, 2I], ``experts.down_bias`` [E, D], in the
param dtype). Init scales follow ``init_moe_params`` (:137): the router and
gate_up with fan_in D, down with fan_in I, every bias zero (``init_weights``
of the model applies them).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.fsdp import FSDPModule

from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import expert_backend, tp_slabs
from automodel_tpu_torch.moe.gate import fake_balanced_gate, gate
from automodel_tpu_torch.ops.fused_expert_mlp import _act_core
from automodel_tpu_torch.parallel.autograd import grad_sum, sum_partials
from automodel_tpu_torch.parallel.plans import local


class MoEAux(NamedTuple):
    expert_counts: torch.Tensor  # [E] int32
    aux_loss: torch.Tensor  # scalar fp32


def make_act2(cfg: MoEConfig, base_act: Callable) -> Callable:
    """Two-argument gated activation from the config, in its inputs' dtype:
    ``act(g) * u``, or gpt-oss's ``swiglu_oai`` (:31-41), the fused
    kernels' formula, whose clamps (``torch.minimum`` / ``torch.maximum``)
    split the gradient evenly at a bound as JAX's do."""
    if cfg.activation == "swiglu_oai":
        return lambda g, u: _act_core(g, u, "swiglu_oai", None)
    return lambda g, u: base_act(g) * u


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Experts(nn.Module):
    def __init__(self, cfg: MoEConfig, hidden_size: int, dtype: torch.dtype, device):
        super().__init__()
        E, D, I = cfg.num_experts, hidden_size, cfg.moe_intermediate_size
        self.gate_up = _param((E, D, 2 * I), dtype, device)
        self.down = _param((E, I, D), dtype, device)
        if cfg.expert_mlp_bias:
            self.gate_up_bias = _param((E, 2 * I), dtype, device)
            self.down_bias = _param((E, D), dtype, device)

    def forward(self, body: Callable, *args):
        """``body(weights, *args)`` over the slabs (their local shards when
        placed): a module call, so an FSDP2 unit gathers them around it."""
        return body({k: local(v) for k, v in self.named_parameters()}, *args)


class Router(nn.Module):
    def __init__(self, cfg: MoEConfig, hidden_size: int, dtype: torch.dtype, device):
        super().__init__()
        self.weight = _param((cfg.num_experts, hidden_size), dtype, device)
        if cfg.bias_update_factor > 0 or cfg.expert_bias:
            self.register_buffer("bias", torch.zeros(cfg.num_experts, dtype=torch.float32, device=device))
        else:
            self.bias = None
        self.linear_bias = _param((cfg.num_experts,), torch.float32, device) if cfg.router_linear_bias else None


class SharedExperts(nn.Module):
    def __init__(self, cfg: MoEConfig, hidden_size: int, dtype: torch.dtype, device):
        super().__init__()
        SI = (cfg.shared_expert_intermediate_size or cfg.moe_intermediate_size) * cfg.num_shared_experts
        D = hidden_size
        self.gate_proj = nn.utils.skip_init(nn.Linear, D, SI, bias=False, device=device, dtype=dtype)
        self.up_proj = nn.utils.skip_init(nn.Linear, D, SI, bias=False, device=device, dtype=dtype)
        self.down_proj = nn.utils.skip_init(nn.Linear, SI, D, bias=False, device=device, dtype=dtype)


class MoEBlock(nn.Module):
    """One MoE layer's parameters, which ``moe_block`` runs; the router sits
    under ``router_name`` (HF's name in the family)."""

    def __init__(self, cfg: MoEConfig, hidden_size: int, dtype: torch.dtype, device, router_name: str = "gate"):
        super().__init__()
        self.cfg = cfg
        self.router_name = router_name
        setattr(self, router_name, Router(cfg, hidden_size, dtype, device))
        self.experts = Experts(cfg, hidden_size, dtype, device)
        if cfg.num_shared_experts > 0:
            self.shared_experts = SharedExperts(cfg, hidden_size, dtype, device)
            if cfg.shared_expert_gate:
                self.shared_expert_gate = nn.utils.skip_init(
                    nn.Linear, hidden_size, 1, bias=False, device=device, dtype=dtype
                )


def moe_block(
    x: torch.Tensor,
    block: MoEBlock,
    act: Callable,
    experts_backend: str = "ragged",
    fake_gate: bool = False,
    act_name: str = "silu",
) -> tuple[torch.Tensor, MoEAux]:
    """x [B, S, D] → (out [B, S, D], MoEAux). ``act_name`` names ``act``
    for ``ragged_fused``, whose kernels apply the activation themselves.
    The backend takes x as [B, S, D], as JAX's layer passes it (:92-111):
    ``gspmd`` fills capacity per batch row. A block placed over an
    expert-parallel group (``block.ep_group``, set by
    ``parallel/plans.parallelize``) holds its expert slabs as DTensors
    sharded on the expert dim; ``a2a`` / ``a2a_fused`` take the local
    slabs and exchange the tokens over that group. A block placed over a
    tp group (``block.tp_group``) holds the slabs' I-shards and its shared
    experts' (column shards of gate and up, row shards of down): every tp
    rank runs the same tokens through its shards, the routed and shared
    partials are summed over the group in fp32 (``sum_partials``), and
    the inputs every rank reads whole (x, the combine weights, the shared
    gate) get their gradients summed over it (``grad_sum``)."""
    cfg = block.cfg
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    if fake_gate:
        gout = fake_balanced_gate(xt, cfg)
    else:
        router = getattr(block, block.router_name)
        gout = gate(xt, router.weight, cfg, bias=router.bias, seq_len=S, linear_bias=router.linear_bias,
                    scope=getattr(block, "aux_scope", None))
    act2 = make_act2(cfg, act)
    tp = getattr(block, "tp_group", None)
    tp = tp if tp is not None and tp.size > 1 else None
    x_in = x
    if tp is not None:
        x_in = grad_sum(x, tp.group)
        gout = gout._replace(topk_weights=grad_sum(gout.topk_weights, tp.group))
    run = expert_backend(experts_backend)

    def routed(weights: dict, x_in, gout):
        if tp is not None:
            weights = tp_slabs(weights, tp)
        return run(x_in, gout, weights, cfg, act2, act_name=act_name, ep=getattr(block, "ep_group", None),
                   partial=tp is not None)

    # through the module call when FSDP2 wraps the experts (its hooks gather
    # and free the slabs), directly otherwise (the host-bound decode path)
    experts = block.experts
    call = experts if isinstance(experts, FSDPModule) else experts.forward
    out = call(routed, x_in, gout).reshape(-1, D)
    if cfg.num_shared_experts > 0:
        sp = block.shared_experts
        lin = lambda h, m: F.linear(h, local(m.weight).to(h.dtype))
        xs = x_in.reshape(-1, D)
        shared = lin(act2(lin(xs, sp.gate_proj), lin(xs, sp.up_proj)), sp.down_proj)
        if cfg.shared_expert_gate:
            s_gate = torch.sigmoid(lin(xt, block.shared_expert_gate))
            shared = shared * (s_gate if tp is None else grad_sum(s_gate, tp.group))
        out = out + shared
    if tp is not None:
        out = sum_partials(out.float(), tp.group).to(x.dtype)
    return out.reshape(B, S, D), MoEAux(gout.expert_counts, gout.aux_loss)
