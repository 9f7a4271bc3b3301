"""Expert computation backends, port of ``automodel_tpu/moe/experts.py``.

- ``dense``: every expert processes every token, combined by routing
  weight; the plain reference (:75).
- ``ragged``: dropless sort + grouped matmul (:277): the picks are sorted
  by expert and run through ``ops.grouped_matmul.ragged_dot``, which is the
  hand-written gmm / tgmm kernels on CUDA tensors.

Both take fused gate_up weights [E, D, 2I] (the kernels' rhs layout) and
down [E, I, D]. The JAX ``gspmd``, ``ragged_fused``, ``a2a`` and
``a2a_fused`` backends are not ported: ``expert_backend`` raises naming
them (fp8 experts are a backend key ``BackendConfig`` refuses).

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
from automodel_tpu_torch.ops.grouped_matmul import gmm_plan, ragged_dot

Act2 = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _split_gate_up(gu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.chunk(gu, 2, dim=-1)


def _ffn(h: torch.Tensor, w: dict, act2: Act2) -> torch.Tensor:
    """h: [..., D] → [..., D] through one expert's weights (or, with a
    leading expert axis on both, every expert's): {gate_up [D, 2I],
    down [I, D]}."""
    g, u = _split_gate_up(h @ w["gate_up"].to(h.dtype))
    return act2(g, u) @ w["down"].to(h.dtype)


def dense_experts(x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2) -> torch.Tensor:
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


def ragged_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2
) -> torch.Tensor:
    """Dropless sort + grouped matmul, x [T, D] → [T, D] in x's dtype.
    Group sizes are the gate's device-side expert counts; the gmm work
    plan is built once, on the device, and serves all four gmm launches
    of the layer (two forward, two in the backward)."""
    T, D = x.shape
    K = cfg.num_experts_per_tok
    flat_expert = gate_out.topk_idx.reshape(-1)  # [T*K]
    order = torch.argsort(flat_expert, stable=True)
    inv = torch.argsort(order)
    group_sizes = gate_out.expert_counts.to(torch.int32)
    plan: Optional[torch.Tensor] = gmm_plan(group_sizes, T * K) if x.device.type == "cuda" else None
    xs = _DispatchTake.apply(x, order, inv, K)  # [T*K, D] sorted by expert
    g, u = _split_gate_up(ragged_dot(xs, weights["gate_up"].to(xs.dtype), group_sizes, plan=plan))
    ys = ragged_dot(act2(g, u), weights["down"].to(xs.dtype), group_sizes, plan=plan)
    return _SortedCombine.apply(ys, gate_out.topk_weights, order, inv, K).to(x.dtype)


EXPERT_BACKENDS = {"dense": dense_experts, "ragged": ragged_experts}
# the JAX package's other backends, each refused by name
NOT_PORTED = ("gspmd", "ragged_fused", "a2a", "a2a_fused")


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
