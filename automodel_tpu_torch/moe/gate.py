"""MoE router (gate), port of ``automodel_tpu/moe/gate.py``: ``gate``
(:36), ``fake_balanced_gate`` (:119) and ``update_gate_bias`` (:135).

Under data and context parallelism JAX's aux loss is a mean over the
global batch (GSPMD sees every rank's rows and every token of a row).
``AuxScope`` carries what a rank needs to add its share of it, so that the
shares sum to JAX's value over the data group. The routed fractions ``f``
are counts, without a gradient: they are summed over the ranks that hold
the same mean's tokens before the product (a row's ``cp`` ranks for the
sequence-level form, the whole group for the token-level one). The mean
probabilities ``p`` enter the product linearly, so each rank multiplies
``f`` by its own tokens' probability sum over the global token count: the
shares add up to ``f . p`` and their gradients to its gradient, with no
collective in the backward. The sequence-level form divides its rows' sum
by the global row count.

Everything stays on the tensors' device: ``expert_counts`` is an int32
device tensor built without ``bincount`` or ``one_hot`` (both read the
indices' maximum back to the host on CUDA), so routing a layer needs no
host sync. The top-k is a stable descending sort, which puts the lower
expert index first on ties as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from automodel_tpu_torch.moe.config import MoEConfig


class AuxScope(NamedTuple):
    """The data-parallel scope of the aux loss: the global row count of
    the microbatch, the process group of the data ranks (``loss_dp``), and
    the ``cp`` ranks that share each row's tokens (their group and count;
    None and 1 without context parallelism)."""

    rows_total: torch.Tensor
    group: object
    cp_group: object = None
    cp: int = 1


class GateOutput(NamedTuple):
    topk_idx: torch.Tensor  # [T, K] int64 expert ids
    topk_weights: torch.Tensor  # [T, K] combine weights (x's dtype)
    expert_counts: torch.Tensor  # [E] int32 tokens routed per expert
    aux_loss: torch.Tensor  # scalar fp32 (0 when disabled)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: the lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot by comparison (F.one_hot syncs on CUDA to check bounds)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _score(logits: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    if cfg.score_func == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def gate(
    x: torch.Tensor,
    weight: torch.Tensor,
    cfg: MoEConfig,
    bias: Optional[torch.Tensor] = None,
    seq_len: Optional[int] = None,
    linear_bias: Optional[torch.Tensor] = None,
    scope: Optional[AuxScope] = None,
) -> GateOutput:
    """Route tokens. x: [T, D]; weight: the router [E, D] (the HF
    ``mlp.gate.weight`` layout; the JAX tree holds its transpose); bias:
    [E] aux-free selection correction. Combine weights come from the
    original scores: the bias only moves the selection. ``linear_bias``
    [E] is a learned router bias (gpt-oss) added to the logits, so it feeds
    both the selection and the weights (:53-54). Under a data-parallel
    ``scope`` the aux loss is this rank's share of JAX's global one (the
    shares sum to it over the group)."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    logits = x.float() @ weight.float().t()  # [T, E]
    if linear_bias is not None:
        logits = logits + linear_bias.float()

    if cfg.softmax_before_topk or cfg.score_func == "sigmoid":
        scores = _score(logits, cfg)
    else:
        scores = logits
    choice = scores + bias.float() if bias is not None else scores

    if cfg.n_group > 1:
        # node-limited routing: keep only the best `topk_group` groups per
        # token (group score = sum of its top-2 choice scores)
        g = cfg.n_group
        grouped = choice.reshape(T, g, E // g)
        top2 = _top_k(grouped, min(2, E // g))[0].sum(dim=-1)  # [T, g]
        _, top_groups = _top_k(top2, cfg.topk_group)
        group_mask = torch.zeros((T, g), dtype=torch.bool, device=x.device)
        group_mask.scatter_(1, top_groups, True)
        keep = group_mask.repeat_interleave(E // g, dim=1)
        choice = torch.where(keep, choice, torch.full_like(choice, float("-inf")))

    _, topk_idx = _top_k(choice.detach(), K)  # [T, K]
    topk_scores = torch.gather(scores, 1, topk_idx)

    if not cfg.softmax_before_topk and cfg.score_func == "softmax":
        topk_weights = torch.softmax(topk_scores, dim=-1)
    else:
        topk_weights = topk_scores
        if cfg.norm_topk_prob:
            topk_weights = topk_weights / topk_weights.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    topk_weights = topk_weights * cfg.route_scale

    one_hot = _one_hot(topk_idx, E)  # [T, K, E]
    counts = one_hot.sum(dim=(0, 1))

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.aux_loss_coeff > 0:
        # sequence-level aux loss (DeepSeek style): within each sequence,
        # fraction routed to expert e x mean prob of e, summed over experts.
        # Under softmax after top-k the "probs" are the raw logits, as in JAX
        # (:97-99)
        probs = scores if cfg.score_func == "softmax" else torch.softmax(logits, dim=-1)
        if seq_len is not None and T % seq_len == 0:
            S = seq_len
            B = T // S
            hits = one_hot.reshape(B, S, K, E).sum(dim=(1, 2))  # [B, E]
            if scope is None:
                f = hits * (E / (K * S))
                p = probs.reshape(B, S, E).mean(dim=1)
                aux = (f * p).sum(dim=-1).mean() * cfg.aux_loss_coeff
            else:
                # a row's tokens lie on its cp ranks: f needs their counts
                if scope.cp > 1:
                    import torch.distributed as dist

                    dist.all_reduce(hits, group=scope.cp_group)
                S_all = S * scope.cp
                f = hits * (E / (K * S_all))
                p_mine = probs.reshape(B, S, E).sum(dim=1) / S_all
                aux = (f * p_mine).sum() / scope.rows_total * cfg.aux_loss_coeff
        elif scope is None:
            f = counts * (E / (K * T))
            aux = (f * probs.mean(dim=0)).sum() * cfg.aux_loss_coeff
        else:
            # f is a mean over the group's tokens: its counts are summed first
            import torch.distributed as dist

            tc = torch.cat([counts, counts.new_full((1,), float(T))])
            dist.all_reduce(tc, group=scope.group)
            t_all = tc[-1]
            f = tc[:-1] * (E / K) / t_all
            aux = (f * probs.sum(dim=0) / t_all).sum() * cfg.aux_loss_coeff

    return GateOutput(topk_idx, topk_weights.to(x.dtype), counts.to(torch.int32), aux)


def fake_balanced_gate(x: torch.Tensor, cfg: MoEConfig, offset: int = 0) -> GateOutput:
    """Deterministic perfectly balanced routing for benchmarks: token t goes
    to experts (t*K + j + offset) mod E with uniform weights 1/K."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    t = torch.arange(T, device=x.device)[:, None]
    j = torch.arange(K, device=x.device)[None, :]
    idx = (t * K + j + offset) % E
    w = torch.full((T, K), 1.0 / K, dtype=x.dtype, device=x.device) * cfg.route_scale
    counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones(T * K, dtype=torch.int32, device=x.device))
    return GateOutput(idx, w, counts, torch.zeros((), dtype=torch.float32, device=x.device))


def update_gate_bias(bias: torch.Tensor, expert_counts: torch.Tensor, update_factor: float) -> torch.Tensor:
    """Aux-free load balancing, applied after the optimizer step: push the
    selection bias of under-loaded experts up and over-loaded ones down by
    sign(error) x factor."""
    c = expert_counts.float()
    err = c.mean() - c
    return bias + torch.sign(err) * update_factor
