"""Causal-LM losses, port of ``automodel_tpu/ops/losses.py``
(``masked_cross_entropy``, ``chunked_cross_entropy``,
``fused_linear_cross_entropy``, ``build_loss``).

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


LOSS_REGISTRY = {
    "masked_ce": masked_cross_entropy,
    "chunked_ce": chunked_cross_entropy,
    "fused_linear_ce": fused_linear_cross_entropy,
}


def build_loss(name: str = "masked_ce", **kwargs):
    """The named loss with ``kwargs`` bound. The JAX package's other losses
    (``kd``, ``nemotron_parse``, ``vocab_parallel_ce``) are refused."""
    fn = LOSS_REGISTRY.get(name)
    if fn is None:
        raise ValueError(
            f"loss {name!r} is not ported to the torch backend (it has {sorted(LOSS_REGISTRY)})"
        )
    return functools.partial(fn, **kwargs) if kwargs else fn
