"""Expert computation backends, port of ``automodel_tpu/moe/experts.py``.

- ``dense``: every expert processes every token, combined by routing
  weight; the plain reference (:75).
- ``ragged``: dropless sort + grouped matmul (:277): the picks are sorted
  by expert and run through ``ops.grouped_matmul.ragged_dot``, which is the
  hand-written gmm / tgmm kernels on CUDA tensors.
- ``ragged_fused``: the same sort, dispatch and combine around
  ``ops.fused_expert_mlp`` (:702), the hand-written fused expert-MLP
  kernels on CUDA tensors, whose backward recomputes through the gmm
  kernels; silu-gated ``swiglu`` and ``swiglu_oai`` only (``_fused_act_of``).

All take fused gate_up weights [E, D, 2I] (the kernels' rhs layout) and
down [E, I, D], with the gpt-oss expert biases ``gate_up_bias`` [E, 2I] and
``down_bias`` [E, D] when the weights carry them. The JAX ``gspmd``,
``a2a`` and ``a2a_fused`` backends are not ported: ``expert_backend``
raises naming them (fp8 experts are a backend key ``BackendConfig``
refuses).

Dispatch and combine are gathers with hand-written backwards
(``_DispatchTake``, ``_SortedCombine``): autograd's own backward of an
index gather is an ``index_add_`` scatter with atomics, slower and not
bit-repeatable. The sort is ``torch.argsort(..., stable=True)``, as
``jnp.argsort`` is stable.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.gate import GateOutput
from automodel_tpu_torch.ops.fused_expert_mlp import add_row_bias, fused_expert_mlp
from automodel_tpu_torch.ops.grouped_matmul import gmm_plan, ragged_dot

Act2 = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _split_gate_up(gu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.chunk(gu, 2, dim=-1)


def _ffn(h: torch.Tensor, w: dict, act2: Act2) -> torch.Tensor:
    """h: [E, T, D] → [E, T, D] through every expert's weights: {gate_up
    [E, D, 2I], down [E, I, D], and optionally gate_up_bias [E, 2I],
    down_bias [E, D]}, the biases added in h's dtype (:54-72)."""
    gu = h @ w["gate_up"].to(h.dtype)
    if "gate_up_bias" in w:
        gu = gu + w["gate_up_bias"].to(h.dtype)[:, None]
    out = act2(*_split_gate_up(gu)) @ w["down"].to(h.dtype)
    if "down_bias" in w:
        out = out + w["down_bias"].to(h.dtype)[:, None]
    return out


def dense_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2, act_name: str = "silu"
) -> torch.Tensor:
    """x [T, D] → [T, D]: all E experts over all tokens, weighted by the
    [T, E] combine matrix."""
    T = x.shape[0]
    cw = torch.zeros((T, cfg.num_experts), dtype=x.dtype, device=x.device)
    cw = cw.scatter_add(1, gate_out.topk_idx, gate_out.topk_weights.to(x.dtype))
    ys = _ffn(x.unsqueeze(0), weights, act2)  # [E, T, D]
    return torch.einsum("etd,te->td", ys, cw)


class _DispatchTake(torch.autograd.Function):
    """xs[p] = x[order[p] // K], with a gather-only backward: ``order`` is
    a bijection over the T*K picks, so dx[t] = sum_k dxs[inv[t*K + k]]."""

    @staticmethod
    def forward(ctx, x, order, inv, K):
        ctx.save_for_backward(order, inv)
        ctx.K, ctx.T = K, x.shape[0]
        return x.index_select(0, order // K)

    @staticmethod
    def backward(ctx, dxs):
        order, inv = ctx.saved_tensors
        dx = dxs.index_select(0, inv).reshape(ctx.T, ctx.K, dxs.shape[-1]).sum(dim=1)
        return dx, None, None, None


class _SortedCombine(torch.autograd.Function):
    """out[t] = sum_k w[t, k] * ys[inv[t*K + k]] → [T, D] fp32 (the products
    in ys's dtype widened to fp32, as :187-190 does), with a gather-only
    backward: d_ys is a gather of dout rows scaled by the pick's weight."""

    @staticmethod
    def forward(ctx, ys, w, order, inv, K):
        ctx.save_for_backward(ys, w, order, inv)
        ctx.K = K
        T, D = w.shape[0], ys.shape[-1]
        yu = ys.index_select(0, inv).reshape(T, K, D)
        return torch.einsum("tkd,tk->td", yu.float(), w.to(ys.dtype).float())

    @staticmethod
    def backward(ctx, dout):
        ys, w, order, inv = ctx.saved_tensors
        K = ctx.K
        T, D = w.shape[0], ys.shape[-1]
        # pick p came from token order[p] // K with weight w.flat[order[p]]
        wp = w.reshape(-1).index_select(0, order)[:, None].to(dout.dtype)
        dys = (dout.index_select(0, order // K) * wp).to(ys.dtype)
        yu = ys.index_select(0, inv).reshape(T, K, D)
        dw = torch.einsum("td,tkd->tk", dout, yu.to(dout.dtype)).to(w.dtype)
        return dys, dw, None, None, None


def _sorted_dispatch(x: torch.Tensor, gate_out: GateOutput, K: int):
    """The picks sorted by expert (a stable sort, as ``jnp.argsort``) →
    (xs [T*K, D], order, inv, int32 group sizes, the gmm plan on CUDA)."""
    flat_expert = gate_out.topk_idx.reshape(-1)  # [T*K]
    order = torch.argsort(flat_expert, stable=True)
    inv = torch.argsort(order)
    group_sizes = gate_out.expert_counts.to(torch.int32)
    plan: Optional[torch.Tensor] = gmm_plan(group_sizes, order.shape[0]) if x.device.type == "cuda" else None
    xs = _DispatchTake.apply(x, order, inv, K)
    return xs, order, inv, group_sizes, plan


def ragged_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2, act_name: str = "silu"
) -> torch.Tensor:
    """Dropless sort + grouped matmul, x [T, D] → [T, D] in x's dtype.
    Group sizes are the gate's device-side expert counts; the gmm work
    plan is built once, on the device, and serves all four gmm launches
    of the layer (two forward, two in the backward). Expert biases are
    added per row in the compute dtype (:312-320)."""
    K = cfg.num_experts_per_tok
    xs, order, inv, group_sizes, plan = _sorted_dispatch(x, gate_out, K)
    gu = ragged_dot(xs, weights["gate_up"].to(xs.dtype), group_sizes, plan=plan)
    if "gate_up_bias" in weights:
        gu = add_row_bias(gu, weights["gate_up_bias"], group_sizes)
    ys = ragged_dot(act2(*_split_gate_up(gu)), weights["down"].to(xs.dtype), group_sizes, plan=plan)
    if "down_bias" in weights:
        ys = add_row_bias(ys, weights["down_bias"], group_sizes)
    return _SortedCombine.apply(ys, gate_out.topk_weights, order, inv, K).to(x.dtype)


def _fused_act_of(cfg: MoEConfig, act_name: str) -> tuple[str, Optional[float]]:
    """(act_kind, limit) for the fused expert-MLP kernels (:326-349), or a
    ValueError for what they do not implement: silu-gated swiglu and
    swiglu_oai only (fp8 experts are refused by ``BackendConfig``)."""
    if cfg.activation not in ("swiglu", "swiglu_oai") or (cfg.activation == "swiglu" and act_name != "silu"):
        raise ValueError(
            f"experts='ragged_fused' implements silu-gated swiglu and swiglu_oai, not "
            f"activation={cfg.activation!r} with base act {act_name!r}"
        )
    return cfg.activation, cfg.activation_limit


def ragged_fused_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2, act_name: str = "silu"
) -> torch.Tensor:
    """``ragged_experts`` with the whole expert MLP in the fused kernels
    (``act2`` unused: the kernels apply the activation from the config).
    The gmm plan serves the forward's two launches and the backward's
    gmm, gmm_t and bwd_dx."""
    act_kind, limit = _fused_act_of(cfg, act_name)
    K = cfg.num_experts_per_tok
    xs, order, inv, group_sizes, plan = _sorted_dispatch(x, gate_out, K)
    bias = lambda name: weights[name].to(xs.dtype) if name in weights else None
    ys = fused_expert_mlp(
        xs, weights["gate_up"].to(xs.dtype), weights["down"].to(xs.dtype), group_sizes,
        bias("gate_up_bias"), bias("down_bias"), act_kind, limit, plan=plan,
    )
    return _SortedCombine.apply(ys, gate_out.topk_weights, order, inv, K).to(x.dtype)


EXPERT_BACKENDS = {"dense": dense_experts, "ragged": ragged_experts, "ragged_fused": ragged_fused_experts}
# the JAX package's other backends, each refused by name
NOT_PORTED = ("gspmd", "a2a", "a2a_fused")


def expert_backend(name: str) -> Callable:
    """The experts function for ``backend.experts``; raises ValueError
    naming a backend the port does not have."""
    fn = EXPERT_BACKENDS.get(name)
    if fn is None:
        why = "is not ported to the torch backend" if name in NOT_PORTED else "is unknown"
        raise ValueError(
            f"experts={name!r} {why} (the torch backend has {sorted(EXPERT_BACKENDS)}; "
            f"not ported: {list(NOT_PORTED)})"
        )
    return fn
