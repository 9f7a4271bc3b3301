"""Causal-LM losses, port of ``automodel_tpu/ops/losses.py``
(``masked_cross_entropy``, ``chunked_cross_entropy``,
``fused_linear_cross_entropy``, ``kd_loss``,
``nemotron_parse_cross_entropy``, ``build_loss``).

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


LOSS_REGISTRY = {
    "masked_ce": masked_cross_entropy,
    "chunked_ce": chunked_cross_entropy,
    "fused_linear_ce": fused_linear_cross_entropy,
    "kd": kd_loss,
    "nemotron_parse": nemotron_parse_cross_entropy,
}


def build_loss(name: str = "masked_ce", **kwargs):
    """The named loss with ``kwargs`` bound. ``vocab_parallel_ce`` (JAX
    :139, a sum over the tensor-parallel mesh axis) is refused by name
    until the port has parallelism."""
    if name == "vocab_parallel_ce":
        raise ValueError(
            "loss 'vocab_parallel_ce' (vocab_parallel_cross_entropy) is not ported to the torch backend: "
            "it sums over the tensor-parallel mesh axis, and the port runs one device"
        )
    fn = LOSS_REGISTRY.get(name)
    if fn is None:
        raise ValueError(
            f"loss {name!r} is not ported to the torch backend (it has {sorted(LOSS_REGISTRY)})"
        )
    return functools.partial(fn, **kwargs) if kwargs else fn
