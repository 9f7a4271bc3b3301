"""Causal-LM losses, port of ``automodel_tpu/ops/losses.py``
(``masked_cross_entropy``, ``chunked_cross_entropy``,
``fused_linear_cross_entropy``, ``vocab_parallel_cross_entropy``,
``kd_loss``, ``nemotron_parse_cross_entropy``, ``build_loss``).

Every loss returns ``(loss_sum fp32, n_valid)``: the caller normalizes by
the global token count over all microbatches. Labels are already shifted
(labels[t] is the target of position t) and ``IGNORE_INDEX`` marks tokens
without a target.

The chunked losses run each token chunk under ``torch.utils.checkpoint``,
the counterpart of ``jax.checkpoint`` on the JAX scan body: the backward
recomputes a chunk's fp32 logits (and, for the fused-linear loss, its
lm_head product) instead of keeping every chunk's, so the working set is
one chunk x vocab.
"""

from __future__ import annotations

import functools
import logging

import torch
from torch.utils.checkpoint import checkpoint

logger = logging.getLogger(__name__)

IGNORE_INDEX = -100


def _usable_chunks(t: int, requested: int) -> int:
    """Largest divisor of t that is <= requested; warns when the memory
    bound degrades from what the caller asked for."""
    nc = next(d for d in range(min(requested, t), 0, -1) if t % d == 0)
    if nc != requested:
        logger.warning(
            "token count %d not divisible by num_chunks=%d; using %d chunks "
            "(pad the batch for the full memory bound)", t, requested, nc,
        )
    return nc


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed CE over valid tokens. logits [T, V] (any float dtype), labels [T]."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = logits32.gather(-1, safe[:, None].long())[:, 0]
    loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return loss.sum(), valid.sum()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum_loss, n_valid). logits [..., V], labels [...]."""
    v = logits.shape[-1]
    return _ce_sum(logits.reshape(-1, v), labels.reshape(-1))


def _chunked(body, x: torch.Tensor, labels: torch.Tensor, num_chunks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of ``body(x_chunk, labels_chunk)`` over token chunks, each under
    a checkpoint (its intermediates recomputed in the backward)."""
    nc = _usable_chunks(x.shape[0], num_chunks)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.long, device=x.device)
    for xc, lb in zip(x.chunk(nc), labels.chunk(nc)):
        s, c = checkpoint(body, xc, lb, use_reentrant=False)
        loss = loss + s
        n = n + c
    return loss, n


def chunked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, num_chunks: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """CE over token chunks; bounds the fp32 logits working set. The token
    count should be divisible by num_chunks (pad batches accordingly)."""
    v = logits.shape[-1]
    flat_logits = logits.reshape(-1, v)
    return _chunked(_ce_sum, flat_logits, labels.reshape(-1), num_chunks)


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    lm_head_kernel: torch.Tensor,
    labels: torch.Tensor,
    num_chunks: int = 16,
    logits_soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CE from hidden states and the lm_head without materializing the
    [T, V] logits. hidden [..., D], lm_head_kernel [D, V] (a transposed view
    of the port's [V, D] weight is fine), labels [...]. The projection runs
    per token chunk and is recomputed per chunk in the backward."""

    def body(h: torch.Tensor, lb: torch.Tensor):
        logits = h @ lm_head_kernel
        if logits_soft_cap is not None:
            logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
        return _ce_sum(logits, lb)

    return _chunked(body, hidden.reshape(-1, hidden.shape[-1]), labels.reshape(-1), num_chunks)


def kd_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    labels: torch.Tensor,
    temperature: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-KL knowledge distillation (JAX :205): the fp32 log-softmax
    of both logits over ``temperature``, KL(teacher || student) per token
    times temperature^2, summed over the tokens whose label is not
    ``IGNORE_INDEX``. → (sum, n_valid)."""
    v = student_logits.shape[-1]
    s = student_logits.reshape(-1, v).float() / temperature
    t = teacher_logits.reshape(-1, v).float() / temperature
    valid = labels.reshape(-1) != IGNORE_INDEX
    t_logp = torch.log_softmax(t, dim=-1)
    s_logp = torch.log_softmax(s, dim=-1)
    kl = (t_logp.exp() * (t_logp - s_logp)).sum(dim=-1) * (temperature**2)
    return torch.where(valid, kl, torch.zeros_like(kl)).sum(), valid.sum()


def nemotron_parse_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    coordinate_weight: float = 10.0,
    class_token_start_idx: int = 50000,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coordinate-weighted CE (JAX :226): a token whose label id is at
    least ``class_token_start_idx`` (a box coordinate or class token) has
    its loss times ``coordinate_weight``; the count stays the unweighted
    valid-token count. → (weighted sum, n_valid)."""
    v = logits.shape[-1]
    flat = logits.reshape(-1, v).float()
    lb = labels.reshape(-1)
    valid = lb != IGNORE_INDEX
    safe = torch.where(valid, lb, torch.zeros_like(lb))
    lse = torch.logsumexp(flat, dim=-1)
    picked = flat.gather(-1, safe[:, None].long())[:, 0]
    per_tok = torch.where(valid, lse - picked, torch.zeros_like(lse))
    w = torch.where(lb >= class_token_start_idx, coordinate_weight, 1.0).float()
    return (per_tok * w).sum(), valid.sum()


class _CopyToTensorParallel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the ``tp``
    group (the input is replicated there, and each rank's share of its
    gradient comes from its own vocabulary slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _VocabParallelCE(torch.autograd.Function):
    """CE over logits sharded on the vocabulary: the row max (detached: the
    lse does not depend on it), the exp-sums and the picked logit reduced
    over the ``tp`` group; the gradient of the local logits needs no
    collective (softmax - one-hot on this rank's slice)."""

    @staticmethod
    def forward(ctx, logits, labels, offset, group, soft_cap):
        import torch.distributed as dist

        x = logits.float()
        t = None
        if soft_cap is not None:
            t = torch.tanh(x / soft_cap)
            x = soft_cap * t
        m = x.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(x - m[:, None])
        z = e.sum(dim=-1)
        dist.all_reduce(z, group=group)
        lse = torch.log(z) + m
        vl = x.shape[-1]
        local = (labels >= offset) & (labels < offset + vl)
        idx = torch.clamp(labels - offset, 0, vl - 1)
        picked = torch.where(local, x.gather(-1, idx[:, None].long())[:, 0], torch.zeros_like(lse))
        dist.all_reduce(picked, group=group)
        valid = labels != IGNORE_INDEX
        loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
        ctx.save_for_backward(e / z[:, None], idx, local & valid, valid, t)
        ctx.soft_cap, ctx.dtype = soft_cap, logits.dtype
        n = valid.sum()
        ctx.mark_non_differentiable(n)
        return loss.sum(), n

    @staticmethod
    def backward(ctx, g, _gn):
        p, idx, picked_here, valid, t = ctx.saved_tensors
        ds = p * valid[:, None].float()
        ds.scatter_add_(-1, idx[:, None].long(), -picked_here[:, None].float())
        ds = ds * g
        if t is not None:
            ds = ds * (1.0 - t * t)
        return ds.to(ctx.dtype), None, None, None, None


def vocab_parallel_cross_entropy(
    hidden: torch.Tensor,
    lm_head_kernel: torch.Tensor,
    labels: torch.Tensor,
    mesh_ctx=None,
    logits_soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor-parallel CE (JAX :139): the lm_head product and the softmax
    with the vocabulary sharded over the ``tp`` group, so no rank holds the
    full [T, V] logits. hidden [..., D] (replicated over tp),
    lm_head_kernel [D, V] (a DTensor sharded on V under tp, e.g. the
    transposed view of the [V, D] weight), labels [...] → (loss_sum fp32,
    n_valid), equal on every tp rank. At tp == 1 it is
    ``fused_linear_cross_entropy``, as in JAX."""
    tp = 1 if mesh_ctx is None else mesh_ctx.tp_size
    if tp == 1:
        return fused_linear_cross_entropy(hidden, lm_head_kernel, labels, logits_soft_cap=logits_soft_cap)
    from torch.distributed.tensor import DTensor, Shard

    if not (isinstance(lm_head_kernel, DTensor) and lm_head_kernel.placements[-1] == Shard(1)):
        raise ValueError("vocab_parallel_cross_entropy: lm_head_kernel must be a DTensor sharded on the vocabulary")
    group = mesh_ctx.group("tp")
    kern = lm_head_kernel.to_local()
    offset = mesh_ctx.coordinate("tp") * kern.shape[-1]
    d = hidden.shape[-1]
    h = _CopyToTensorParallel.apply(hidden.reshape(-1, d), group)
    logits = h @ kern.to(h.dtype)
    return _VocabParallelCE.apply(logits, labels.reshape(-1), offset, group, logits_soft_cap)


LOSS_REGISTRY = {
    "masked_ce": masked_cross_entropy,
    "chunked_ce": chunked_cross_entropy,
    "fused_linear_ce": fused_linear_cross_entropy,
    "kd": kd_loss,
    "nemotron_parse": nemotron_parse_cross_entropy,
    "vocab_parallel_ce": vocab_parallel_cross_entropy,
}


def build_loss(name: str = "masked_ce", **kwargs):
    """The named loss with ``kwargs`` bound; an unknown name raises."""
    fn = LOSS_REGISTRY.get(name)
    if fn is None:
        raise ValueError(
            f"loss {name!r} is not ported to the torch backend (it has {sorted(LOSS_REGISTRY)})"
        )
    return functools.partial(fn, **kwargs) if kwargs else fn
