"""Expert computation backends, port of ``automodel_tpu/moe/experts.py``.

- ``dense``: every expert processes every token, combined by routing
  weight; the plain reference (:75).
- ``gspmd``: capacity-based dispatch and combine (:94), plain torch: each
  batch row gives every expert ``max(K, ceil(S * K / E *
  capacity_factor))`` slots, filled in token-major order; a pick past its
  expert's capacity is dropped (contributes zero). The ``[B, S, E, C]``
  dispatch and combine tensors and their einsums are fp32. Over ``ep``
  ranks the experts' slots [E, B, C, D] go to the ranks that hold the
  experts and back by ``all_to_all_single``, the collective GSPMD
  inserts for JAX's expert-sharded einsums (``gspmd_forward_ranks`` drives
  a virtual group in one process).
- ``ragged``: dropless sort + grouped matmul (:277): the picks are sorted
  by expert and run through ``ops.grouped_matmul.ragged_dot``, which is the
  hand-written gmm / tgmm kernels on CUDA tensors.
- ``ragged_fused``: the same sort, dispatch and combine around
  ``ops.fused_expert_mlp`` (:702), the hand-written fused expert-MLP
  kernels on CUDA tensors, whose backward recomputes through the gmm
  kernels; silu-gated ``swiglu`` and ``swiglu_oai`` only (``_fused_act_of``).
- ``a2a`` / ``a2a_fused``: the expert-parallel token exchange (:352-593).
  Without an expert-parallel group of more than one rank they run
  ``ragged`` / ``ragged_fused`` (:377-387). Over ``ep`` ranks each rank
  sorts its picks by global expert, packs per-peer chunks of ``C`` rows
  (the strict worst case, or ``a2a_capacity_factor``, rounded up to 8;
  a pick past its peer's chunk drops), exchanges them and their local
  expert ids with ``all_to_all_single``, re-sorts what it received by
  local expert (the empty slots' sentinel last), runs its ``E / ep``
  experts through the grouped-matmul kernels (``a2a``) or the fused
  expert-MLP kernels (``a2a_fused``), and sends the rows back for the
  weighted combine. The per-rank steps (``a2a_pack``, ``a2a_local``,
  ``a2a_unpack``) are apart from the exchange, so ``a2a_forward_ranks``
  drives every rank of a virtual group in one process in the real order,
  the exchange then being a concatenation (``exchange_ranks``).

Tensor parallelism of the experts (JAX's ``tensor`` rule on the slabs'
intermediate dim, and ``tp_axis`` inside the a2a body, :468-593): every
tp rank runs the same tokens through its I-shard of each expert, ``[g_r |
u_r]`` of gate_up (gate and up split on I first, then sharded, as
``_a2a_weights`` does: a plain ``Shard(-1)`` of the concatenated [E, D,
2I] would hand one rank all of gate), rows r of down and the matching
biases; the down bias is added on tp rank 0 only (outside the fused
kernels), and the down partials are summed over the tp group after the
combine, in fp32. ``tp_slabs`` builds a rank's operands from the slabs'
canonical shards (an exchange of I-blocks over the tp group,
``_TPGateUp``), ``tp_local_slabs`` from whole slabs (the virtual ranks of
``a2a_forward_ranks``); ``moe/layer.moe_block`` sums the partials. A
``_StridedShard(-1, split_factor=2)`` placement would hand each rank
``[g_r | u_r]`` with no exchange, but ``torch.distributed.checkpoint``
cannot save it: it takes a rank's shard for one box of the whole tensor,
and g_r and u_r lie apart (its planner refuses the "overlapping chunks").
So the slabs keep the canonical ``Shard(-1)``, and checkpoints stay
whole and reshardable. Given
``partial=True`` a backend returns its fp32 combine before the cast.

All take fused gate_up weights [E, D, 2I] (the kernels' rhs layout) and
down [E, I, D], with the gpt-oss expert biases ``gate_up_bias`` [E, 2I] and
``down_bias`` [E, D] when the weights carry them. The registry's entries
(``expert_backend``) take x [B, S, D] (``dense``, ``ragged`` and
``ragged_fused`` any leading dims) and return its shape, as JAX's do;
fp8 experts are a backend key ``BackendConfig`` refuses.

Dispatch and combine are gathers with hand-written backwards
(``_DispatchTake``, ``_SortedCombine``, ``_PermTake``, ``_SlotPack``,
``_SlotUnpack``): autograd's own backward of an index gather is an
``index_add_`` scatter with atomics, slower and not bit-repeatable. The
sort is ``torch.argsort(..., stable=True)``, as ``jnp.argsort`` is stable.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.gate import GateOutput, _one_hot
from automodel_tpu_torch.ops.fused_expert_mlp import add_row_bias, fused_expert_mlp
from automodel_tpu_torch.ops.grouped_matmul import gmm_plan, ragged_dot
from automodel_tpu_torch.parallel.autograd import grad_sum

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
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2, act_name: str = "silu",
    partial: bool = False,
) -> torch.Tensor:
    """x [T, D] → [T, D]: all E experts over all tokens, weighted by the
    [T, E] combine matrix (in x's dtype, widened to fp32 as a tp partial)."""
    T = x.shape[0]
    cw = torch.zeros((T, cfg.num_experts), dtype=x.dtype, device=x.device)
    cw = cw.scatter_add(1, gate_out.topk_idx, gate_out.topk_weights.to(x.dtype))
    ys = _ffn(x.unsqueeze(0), weights, act2)  # [E, T, D]
    out = torch.einsum("etd,te->td", ys, cw)
    return out.float() if partial else out


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


def _combined(out: torch.Tensor, x: torch.Tensor, partial: bool) -> torch.Tensor:
    """The fp32 combine in x's dtype, or kept fp32 when it is a tp partial."""
    return out if partial else out.to(x.dtype)


def ragged_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2, act_name: str = "silu",
    partial: bool = False,
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
    return _combined(_SortedCombine.apply(ys, gate_out.topk_weights, order, inv, K), x, partial)


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


def _fused(xs, weights: dict, gsz, fused_act: tuple, plan, partial: bool) -> torch.Tensor:
    """The fused expert MLP over sorted rows; as a tp partial the down bias
    (tp rank 0's, zeros elsewhere) is added after the kernels, as JAX's a2a
    body keeps it out of its kernel under tp (:534-545)."""
    bias = lambda name: weights[name].to(xs.dtype) if name in weights else None
    y = fused_expert_mlp(
        xs, weights["gate_up"].to(xs.dtype), weights["down"].to(xs.dtype), gsz,
        bias("gate_up_bias"), None if partial else bias("down_bias"), fused_act[0], fused_act[1], plan=plan,
    )
    if partial and "down_bias" in weights:
        y = add_row_bias(y, weights["down_bias"], gsz)
    return y


def ragged_fused_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2, act_name: str = "silu",
    partial: bool = False,
) -> torch.Tensor:
    """``ragged_experts`` with the whole expert MLP in the fused kernels
    (``act2`` unused: the kernels apply the activation from the config).
    The gmm plan serves the forward's two launches and the backward's
    gmm, gmm_t and bwd_dx."""
    fused_act = _fused_act_of(cfg, act_name)
    K = cfg.num_experts_per_tok
    xs, order, inv, group_sizes, plan = _sorted_dispatch(x, gate_out, K)
    ys = _fused(xs, weights, group_sizes, fused_act, plan, partial)
    return _combined(_SortedCombine.apply(ys, gate_out.topk_weights, order, inv, K), x, partial)


def _gspmd_dispatch(x: torch.Tensor, gate_out: GateOutput, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (the combine tensor [B, S, E, C] fp32, the experts'
    inputs [E, B, C, D] in x's dtype): each row's picks take their
    expert's slots in token-major order, and a pick past ``max(K, ceil(S *
    K / E * capacity_factor))`` drops (:103-125)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    cap = max(K, int(math.ceil(S * K / E * cfg.capacity_factor)))
    idx = gate_out.topk_idx.reshape(B, S, K)
    w = gate_out.topk_weights.reshape(B, S, K).float()
    onehot = _one_hot(idx, E)  # [B, S, K, E]
    flat = onehot.reshape(B, S * K, E)
    # each pick's position in its expert's buffer: the picks before it
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)
    pos = torch.einsum("bske,bske->bsk", pos, onehot).to(torch.int32)
    pos_oh = _one_hot(pos, cap) * (pos < cap)[..., None].float()  # [B, S, K, C]
    disp = torch.einsum("bske,bskc->bsec", onehot, pos_oh)
    comb = torch.einsum("bske,bskc->bsec", onehot * w[..., None], pos_oh)
    return comb, torch.einsum("bsec,bsd->ebcd", disp, x.float()).to(x.dtype)


def _gspmd_ffn(expert_in: torch.Tensor, weights: dict, act2: Act2) -> torch.Tensor:
    """[E, B, C, D] through each expert's MLP (the slabs [E, ...])."""
    E, B, C, D = expert_in.shape
    return _ffn(expert_in.reshape(E, B * C, D), weights, act2).reshape(E, B, C, D)


def _gspmd_combine(comb: torch.Tensor, expert_out: torch.Tensor, x: torch.Tensor, partial: bool = False) -> torch.Tensor:
    return _combined(torch.einsum("bsec,ebcd->bsd", comb, expert_out.float()), x, partial)


def _to_experts(bufs: torch.Tensor, ep: int) -> torch.Tensor:
    """[ep (source rank), E / ep, B, C, D] received → [E / ep, ep * B, C, D]."""
    _, E_loc, B, C, D = bufs.shape
    return bufs.transpose(0, 1).reshape(E_loc, ep * B, C, D)


def _from_experts(out: torch.Tensor, ep: int) -> torch.Tensor:
    """``_to_experts`` undone: [E / ep, ep * B, C, D] → [ep, E / ep, B, C, D]."""
    E_loc, EB, C, D = out.shape
    return out.reshape(E_loc, ep, EB // ep, C, D).transpose(0, 1).contiguous()


def gspmd_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2,
    ep: Optional["EPGroup"] = None, partial: bool = False,
) -> torch.Tensor:
    """Capacity-based dispatch and combine (:94-133), x [B, S, D] → [B, S,
    D]. Over an expert-parallel group ``weights`` are this rank's local
    slabs [E / ep, ...], and the experts' inputs [E, B, C, D] go to the
    ranks that hold them by ``all_to_all_single`` and come back the same
    way: the collective GSPMD inserts for JAX's expert-sharded einsums."""
    comb, expert_in = _gspmd_dispatch(x, gate_out, cfg)
    if ep is None or ep.size == 1:
        return _gspmd_combine(comb, _gspmd_ffn(expert_in, weights, act2), x, partial)
    E, B, C, D = expert_in.shape
    shape = (ep.size, E // ep.size, B, C, D)
    recv = _AllToAll.apply(expert_in.reshape(ep.size, -1), ep.group).reshape(shape)
    out = _from_experts(_gspmd_ffn(_to_experts(recv, ep.size), weights, act2), ep.size)
    back = _AllToAll.apply(out.reshape(ep.size, -1), ep.group).reshape(E, B, C, D)
    return _gspmd_combine(comb, back, x, partial)


def gspmd_forward_ranks(
    xs: list[torch.Tensor], gate_outs: list[GateOutput], weights: dict, cfg: MoEConfig, act2: Act2
) -> list[torch.Tensor]:
    """``gspmd_experts`` over every rank of a virtual expert-parallel group
    in one process: ``xs[r]`` [B, S, D] and ``gate_outs[r]`` rank r's rows,
    ``weights`` the whole slabs [E, ...] (rank r holds experts ``[r * E /
    ep, (r + 1) * E / ep)``) → each rank's [B, S, D]."""
    ep, E = len(xs), cfg.num_experts
    E_loc = E // ep
    sent = [_gspmd_dispatch(x, g, cfg) for x, g in zip(xs, gate_outs)]
    # rank r receives every rank's slots of its experts, in rank order
    recv = [torch.stack([e[r * E_loc:(r + 1) * E_loc] for _, e in sent]) for r in range(ep)]
    outs = [_from_experts(_gspmd_ffn(_to_experts(recv[r], ep), _local_slabs(weights, r, E_loc), act2), ep)
            for r in range(ep)]
    back = [torch.cat([outs[p][r] for p in range(ep)]) for r in range(ep)]
    return [_gspmd_combine(comb, back[r], x) for r, ((comb, _), x) in enumerate(zip(sent, xs))]


# -- the expert-parallel token exchange ----------------------------------------


class _PermTake(torch.autograd.Function):
    """y[i] = x[perm[i]] for a bijection ``perm`` with inverse ``inv``; the
    backward is the inverse gather (:213-230)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, dy):
        (inv,) = ctx.saved_tensors
        return dy.index_select(0, inv), None, None


class _SlotPack(torch.autograd.Function):
    """The per-peer send buffer as a gather (:233-253): out[r] = xs[src[r]]
    where slot r is valid, else 0; the backward gathers by ``dst`` (a
    dropped pick reads an appended zero row)."""

    @staticmethod
    def forward(ctx, xs, src, dst, valid):
        ctx.save_for_backward(dst)
        return xs.index_select(0, src) * valid[:, None].to(xs.dtype)

    @staticmethod
    def backward(ctx, dy):
        (dst,) = ctx.saved_tensors
        return torch.cat([dy, dy.new_zeros(1, dy.shape[-1])]).index_select(0, dst), None, None, None


class _SlotUnpack(torch.autograd.Function):
    """Slots back to picks (:256-274): out[p] = y[dst[p]], the sentinel
    ``dst`` (the row count) reading an appended zero row; the backward is
    the valid-masked gather by ``src``."""

    @staticmethod
    def forward(ctx, y, dst, src, valid):
        ctx.save_for_backward(src, valid)
        return torch.cat([y, y.new_zeros(1, y.shape[-1])]).index_select(0, dst)

    @staticmethod
    def backward(ctx, dp):
        src, valid = ctx.saved_tensors
        return dp.index_select(0, src) * valid[:, None].to(dp.dtype), None, None, None


class EPGroup(NamedTuple):
    """A rank's group on one mesh dim (``ep``, or ``tp`` for the experts'
    I-split): its size, the rank's index in it and its process group."""

    size: int
    rank: int
    group: Any


class A2ASend(NamedTuple):
    """One rank's side of the exchange: the send buffer [ep * C, D] (chunk
    p for peer p), each slot's local expert id (``E / ep`` for an empty
    slot), and what the combine needs to bring the rows back."""

    x: torch.Tensor
    ids: torch.Tensor
    order: torch.Tensor
    inv: torch.Tensor
    dst: torch.Tensor
    src: torch.Tensor
    valid: torch.Tensor


def a2a_chunk_rows(tokens: int, cfg: MoEConfig, ep: int) -> int:
    """C, the rows a rank sends each peer (:404-408): the strict per-peer
    worst case ``tokens * min(K, E / ep)`` (dropless), or
    ``a2a_capacity_factor`` x the balanced load ``tokens * K / ep`` when
    that is smaller, rounded up to 8."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    if E % ep:
        raise ValueError(f"num_experts={E} must be divisible by ep={ep}")
    cap = tokens * min(K, E // ep)
    if cfg.a2a_capacity_factor is not None:
        cap = min(cap, int(math.ceil(cfg.a2a_capacity_factor * tokens * K / ep)))
    return -(-cap // 8) * 8


def a2a_pack(xt: torch.Tensor, idx: torch.Tensor, E: int, ep: int, C: int) -> A2ASend:
    """One rank's picks sorted by global expert into per-peer chunks
    (:475-505): xt [T, D], idx [T, K] → the send side. Sorted picks are
    peer-contiguous, so slot r of peer p holds pick peer_off[p] + r % C;
    a pick at or past C in its peer's run drops."""
    T, K = idx.shape
    E_loc = E // ep
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inv = torch.argsort(order)
    sorted_e = flat.index_select(0, order)
    xs = _DispatchTake.apply(xt, order, inv, K)
    counts = torch.zeros(E, dtype=torch.int64, device=xt.device).scatter_add_(0, flat, torch.ones_like(flat))
    peer_counts = counts.reshape(ep, E_loc).sum(-1)
    peer_off = torch.cumsum(peer_counts, 0) - peer_counts
    peer_of = sorted_e // E_loc
    pos_in_peer = torch.arange(T * K, device=xt.device) - peer_off[peer_of]
    dst = torch.where(pos_in_peer < C, peer_of * C + pos_in_peer, torch.full_like(pos_in_peer, ep * C))
    slot = torch.arange(ep * C, device=xt.device)
    slot_c, slot_p = slot % C, slot // C
    valid = slot_c < peer_counts[slot_p]
    src = torch.clamp(peer_off[slot_p] + slot_c, max=T * K - 1)
    send_x = _SlotPack.apply(xs, src, dst, valid)
    ids = torch.where(valid, sorted_e.index_select(0, src) % E_loc, torch.full_like(src, E_loc))
    return A2ASend(send_x, ids, order, inv, dst, src, valid)


def a2a_local(
    recv_x: torch.Tensor, recv_ids: torch.Tensor, weights: dict, cfg: MoEConfig, act2: Act2,
    fused_act: Optional[tuple] = None, partial: bool = False,
) -> torch.Tensor:
    """A rank's ``E / ep`` local experts over the rows it received (:511-578):
    recv_x [ep * C, D] with their local expert ids → [ep * C, D] in the
    same order. The rows are sorted by local expert with the empty slots
    (id ``E / ep``) last, past every group, where the kernels write zeros;
    ``weights`` are the local slabs [E / ep, ...]. ``fused_act``: (kind,
    limit) runs the fused expert-MLP kernels, else the grouped matmuls."""
    E_loc = weights["down"].shape[0]
    order2 = torch.argsort(recv_ids, stable=True)
    inv2 = torch.argsort(order2)
    xs2 = _PermTake.apply(recv_x, order2, inv2)
    gsz = torch.zeros(E_loc + 1, dtype=torch.int32, device=recv_x.device)
    gsz = gsz.scatter_add_(0, recv_ids, torch.ones_like(recv_ids, dtype=torch.int32))[:E_loc]
    plan = gmm_plan(gsz, xs2.shape[0]) if xs2.device.type == "cuda" else None
    if fused_act is not None:
        y = _fused(xs2, weights, gsz, fused_act, plan, partial)
    else:
        gu = ragged_dot(xs2, weights["gate_up"].to(xs2.dtype), gsz, plan=plan)
        if "gate_up_bias" in weights:
            gu = add_row_bias(gu, weights["gate_up_bias"], gsz)
        y = ragged_dot(act2(*_split_gate_up(gu)), weights["down"].to(xs2.dtype), gsz, plan=plan)
        if "down_bias" in weights:
            y = add_row_bias(y, weights["down_bias"], gsz)
    return _PermTake.apply(y, inv2, order2)


def a2a_unpack(y: torch.Tensor, send: A2ASend, cw: torch.Tensor) -> torch.Tensor:
    """The rows back from the peers [ep * C, D] (in this rank's send layout)
    → [T, D] fp32: each pick's row (zero for a dropped pick), weighted and
    summed over its token's K picks (:579-590)."""
    T, K = cw.shape
    yp = _SlotUnpack.apply(y, send.dst, send.src, send.valid)
    yp = _PermTake.apply(yp, send.inv, send.order)  # the original pick order
    return torch.einsum("tkd,tk->td", yp.reshape(T, K, -1).float(), cw.to(y.dtype).float())


def exchange_ranks(bufs: list[torch.Tensor], C: int) -> list[torch.Tensor]:
    """The all-to-all of a virtual group in one process: rank r receives
    chunk r of every rank's buffer, in rank order."""
    ep = len(bufs)
    return [torch.cat([bufs[p][r * C:(r + 1) * C] for p in range(ep)]) for r in range(ep)]


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks; its backward is the same
    exchange of the gradient (the reverse routes)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def _local_slabs(weights: dict, rank: int, E_loc: int) -> dict:
    return {k: v[rank * E_loc:(rank + 1) * E_loc] for k, v in weights.items()}


def a2a_forward_ranks(
    xs: list[torch.Tensor], gate_outs: list[GateOutput], weights: dict, cfg: MoEConfig, act2: Act2,
    fused_act: Optional[tuple] = None, tp: int = 1,
) -> list[torch.Tensor]:
    """Every rank of a virtual ``ep x tp`` group in one process, in the
    real exchange's order: ``xs[r]`` [T, D] and ``gate_outs[r]`` are ep
    rank r's tokens and routing (each of its tp ranks holds the same),
    ``weights`` the whole slabs [E, ...] (ep rank r holds experts ``[r * E
    / ep, (r + 1) * E / ep)``, tp rank t their I-shard t) → each ep rank's
    [T, D] in x's dtype: the exchange runs once a tp rank, and the fp32
    partials of the tp ranks are summed. Differentiable end to end."""
    ep, E = len(xs), cfg.num_experts
    C = a2a_chunk_rows(xs[0].shape[0], cfg, ep)
    sends = [a2a_pack(x, g.topk_idx, E, ep, C) for x, g in zip(xs, gate_outs)]
    recv_x = exchange_ranks([s.x for s in sends], C)
    recv_ids = exchange_ranks([s.ids for s in sends], C)
    E_loc = E // ep
    outs = [0.0] * ep
    for t in range(tp):
        w_t = weights if tp == 1 else tp_local_slabs(weights, t, tp)
        ys = [a2a_local(recv_x[r], recv_ids[r], _local_slabs(w_t, r, E_loc), cfg, act2, fused_act, partial=tp > 1)
              for r in range(ep)]
        back = exchange_ranks(ys, C)
        outs = [o + a2a_unpack(back[r], sends[r], gate_outs[r].topk_weights) for r, o in enumerate(outs)]
    return [o.to(x.dtype) for o, x in zip(outs, xs)]


def _i_block(w: torch.Tensor, dim: int, t: int, tp: int) -> torch.Tensor:
    b = w.shape[dim] // tp
    return w.narrow(dim, t * b, b)


def tp_local_slabs(weights: dict, t: int, tp: int) -> dict:
    """tp rank t's operands from whole slabs: ``[g_t | u_t]`` of gate_up
    and gate_up_bias (gate and up each split on I), rows t of down, and
    the down bias on rank 0 only (zeros elsewhere, so its gradient flows
    from rank 0 alone)."""
    out = {}
    for k, w in weights.items():
        if k in ("gate_up", "gate_up_bias"):
            g, u = _split_gate_up(w)
            out[k] = torch.cat([_i_block(g, -1, t, tp), _i_block(u, -1, t, tp)], dim=-1)
        elif k == "down":
            out[k] = _i_block(w, 1, t, tp)
        elif k == "down_bias":
            out[k] = w if t == 0 else w * 0
        else:
            out[k] = w
    return out


def _gate_up_routes(tp: int, r: int) -> tuple[list[int], list[int], bool]:
    """The I-block exchange of ``_TPGateUp`` for tp rank r: the canonical
    ``Shard(-1)`` of [gate | up] splits the last dim into 2 tp blocks of I
    / tp, rank q holding blocks 2q and 2q + 1; rank t needs blocks t (of
    gate) and tp + t (of up). → (the blocks r sends to each rank, the
    blocks it receives from each, whether its two sent blocks go out in
    reverse order)."""
    dest = lambda j: j if j < tp else j - tp
    d0, d1 = dest(2 * r), dest(2 * r + 1)
    send = [int(t == d0) + int(t == d1) for t in range(tp)]
    src_g, src_u = r // 2, (tp + r) // 2
    recv = [int(q == src_g) + int(q == src_u) for q in range(tp)]
    return send, recv, d1 < d0


class _TPGateUp(torch.autograd.Function):
    """A rank's canonical ``Shard(-1)`` shard of a [..., 2I] gate_up (or
    its bias) → its ``[g_r | u_r]`` [..., 2I / tp], by an all-to-all of I
    / tp-wide blocks over the tp group; the backward sends the gradient's
    blocks back the same routes."""

    @staticmethod
    def forward(ctx, w, group, tp, r):
        import torch.distributed as dist

        send, recv, swap = _gate_up_routes(tp, r)
        ctx.group, ctx.send, ctx.recv, ctx.swap = group, send, recv, swap
        b = w.shape[-1] // 2
        blocks = [w[..., :b], w[..., b:]]
        if swap:
            blocks.reverse()
        buf = torch.stack(blocks).reshape(2, -1).contiguous()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, output_split_sizes=recv, input_split_sizes=send, group=group)
        ctx.shape = w.shape
        # received in source order: gate block from r // 2 first, then up
        return torch.cat([out[0].reshape(*w.shape[:-1], b), out[1].reshape(*w.shape[:-1], b)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        b = ctx.shape[-1] // 2
        buf = torch.stack([g[..., :b], g[..., b:]]).reshape(2, -1).contiguous()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, output_split_sizes=ctx.send, input_split_sizes=ctx.recv, group=ctx.group)
        blocks = [out[0].reshape(*ctx.shape[:-1], b), out[1].reshape(*ctx.shape[:-1], b)]
        if ctx.swap:
            blocks.reverse()
        return torch.cat(blocks, dim=-1), None, None, None


def tp_slabs(weights: dict, tp: EPGroup) -> dict:
    """This tp rank's operands from the slabs' canonical local shards
    (gate_up and gate_up_bias ``Shard(-1)``, down ``Shard(1)`` over tp,
    the down bias whole): ``[g_r | u_r]`` by ``_TPGateUp``, and the down
    bias on rank 0 only, its gradient summed over the group (the ranks
    that read it as zeros give zeros)."""
    out = dict(weights)
    for k in ("gate_up", "gate_up_bias"):
        if k in out:
            out[k] = _TPGateUp.apply(out[k], tp.group, tp.size, tp.rank)
    if "down_bias" in out:
        db = grad_sum(out["down_bias"], tp.group)
        out["down_bias"] = db if tp.rank == 0 else db * 0
    return out


def a2a_experts(
    x: torch.Tensor, gate_out: GateOutput, weights: dict, cfg: MoEConfig, act2: Act2,
    ep: Optional[EPGroup] = None, fused_act: Optional[tuple] = None, partial: bool = False,
) -> torch.Tensor:
    """x [B, S, D] (this rank's tokens) → [B, S, D]. Without a group of
    more than one rank: ``ragged`` (``ragged_fused`` with ``fused_act``).
    Over ``ep`` ranks ``weights`` are this rank's local slabs [E / ep, ...]
    and the exchange is ``all_to_all_single`` over ``ep.group``."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    if ep is None or ep.size == 1:
        if fused_act is None:
            return ragged_experts(xt, gate_out, weights, cfg, act2, partial=partial).reshape(B, S, D)
        return ragged_fused_experts(xt, gate_out, weights, cfg, act2, partial=partial).reshape(B, S, D)
    C = a2a_chunk_rows(xt.shape[0], cfg, ep.size)
    send = a2a_pack(xt, gate_out.topk_idx, cfg.num_experts, ep.size, C)
    import torch.distributed as dist

    recv_ids = torch.empty_like(send.ids)
    dist.all_to_all_single(recv_ids, send.ids, group=ep.group)
    recv_x = _AllToAll.apply(send.x, ep.group)
    y = a2a_local(recv_x, recv_ids, weights, cfg, act2, fused_act, partial)
    out = a2a_unpack(_AllToAll.apply(y, ep.group), send, gate_out.topk_weights)
    return _combined(out, x, partial).reshape(B, S, D)


# -- the registry: x [B, S, D] (or any leading dims where the backend allows) --


def _flat(fn: Callable) -> Callable:
    def run(x, gate_out, weights, cfg, act2, act_name="silu", ep=None, partial=False):
        out = fn(x.reshape(-1, x.shape[-1]), gate_out, weights, cfg, act2, act_name=act_name, partial=partial)
        return out.reshape(x.shape)

    return run


def _run_gspmd(x, gate_out, weights, cfg, act2, act_name="silu", ep=None, partial=False):
    return gspmd_experts(x, gate_out, weights, cfg, act2, ep, partial=partial)


def _run_a2a(x, gate_out, weights, cfg, act2, act_name="silu", ep=None, partial=False):
    return a2a_experts(x, gate_out, weights, cfg, act2, ep, partial=partial)


def _run_a2a_fused(x, gate_out, weights, cfg, act2, act_name="silu", ep=None, partial=False):
    return a2a_experts(x, gate_out, weights, cfg, act2, ep, fused_act=_fused_act_of(cfg, act_name), partial=partial)


EXPERT_BACKENDS = {
    "dense": _flat(dense_experts),
    "ragged": _flat(ragged_experts),
    "ragged_fused": _flat(ragged_fused_experts),
    "gspmd": _run_gspmd,
    "a2a": _run_a2a,
    "a2a_fused": _run_a2a_fused,
}
EP_BACKENDS = ("gspmd", "a2a", "a2a_fused")  # the backends that exchange over ``ep``


def expert_backend(name: str) -> Callable:
    """The experts function for ``backend.experts``, called as ``fn(x,
    gate_out, weights, cfg, act2, act_name=..., ep=..., partial=...)``;
    raises ValueError naming an unknown backend."""
    fn = EXPERT_BACKENDS.get(name)
    if fn is None:
        raise ValueError(f"experts={name!r} is unknown (the torch backend has {sorted(EXPERT_BACKENDS)})")
    return fn
