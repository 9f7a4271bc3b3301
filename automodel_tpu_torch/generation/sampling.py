"""Token sampling: greedy / temperature / top-k / top-p.

Port of ``automodel_tpu/generation/sampling.py``, with ``speculative_verify``,
the draft-and-verify rule of speculative decoding. The JAX code folds the
decode step into a PRNG key; here each step draws from its own
``torch.Generator`` seeded by (seed, step) on the logits' device
(``step_generator``). The two frameworks draw different numbers from the
same seed, so sampled streams differ between them; greedy decoding is
identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """temperature <= 0 means greedy; top_k/top_p restrict the support
    before renormalization (HF order: temperature → top-k → top-p)."""

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None

    def __post_init__(self):
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k={self.top_k} must be >= 1")
        if self.top_p is not None and not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p={self.top_p} must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature is None or self.temperature <= 0.0


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator for one decode step: seeded by (seed, step), so the same
    pair always reproduces the same draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (2**63))
    return gen


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, _NEG_INF), logits)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of descending-prob tokens
    whose cumulative probability reaches p (the top token always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    keep_sorted = torch.cat(
        [torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p], dim=-1
    )
    kth = torch.where(keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf")))
    kth = kth.amin(dim=-1, keepdim=True)
    return torch.where(logits < kth, torch.full_like(logits, _NEG_INF), logits)


def _filter_logits(logits: torch.Tensor, config: SamplingConfig) -> torch.Tensor:
    logits = logits / float(config.temperature)
    if config.top_k is not None:
        logits = _apply_top_k(logits, config.top_k)
    if config.top_p is not None and config.top_p < 1.0:
        logits = _apply_top_p(logits, config.top_p)
    return logits


def sample(
    logits: torch.Tensor, generator: Optional[torch.Generator], config: SamplingConfig
) -> torch.Tensor:
    """logits [B, V] → token ids [B] int32. ``generator`` is unused under
    greedy decoding."""
    logits = logits.float()
    if config.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits, config), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def sample_with_logprobs(
    logits: torch.Tensor, generator: Optional[torch.Generator], config: SamplingConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] → (token ids [B] int32, logprobs [B] fp32). The logprob
    is ``log_softmax`` of the raw (unfiltered, untempered) logits at the
    sampled id; filtering shapes which token is drawn, not its reported
    probability."""
    logits = logits.float()
    ids = sample(logits, generator, config)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, ids[:, None].long())[:, 0]
    return ids, logp


def speculative_verify(
    target_logits: torch.Tensor,
    draft_logits: Optional[torch.Tensor],
    draft_tokens: torch.Tensor,
    generator: Optional[torch.Generator],
    config: SamplingConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The draft-and-verify acceptance rule (Leviathan et al., 2023), port
    of JAX's ``speculative_verify`` (:111-170).

    ``target_logits`` [B, S, V] come from ONE verify forward over the S =
    k+1 fed tokens ``[cur, d_1..d_k]`` (row i is the target's distribution
    for the token after fed token i); ``draft_tokens`` [B, k] are the
    proposals and ``draft_logits`` [B, k, V] the distributions they were
    drawn from (unused under greedy). → ``(tokens [B, S] int32, n_commit
    [B] int32 in 1..S)``: commit ``tokens[:, :n]``, the accepted draft
    prefix plus one correction or bonus token.

    Greedy: accept while ``d_i == argmax(target_i)``; the committed tokens
    are the target's argmax row, bit for bit the non-speculative greedy
    stream. Sampled: accept ``d_i`` with probability ``min(1, p_i(d_i) /
    q_i(d_i))``, draw a rejected position's correction from ``norm(max(p -
    q, 0))`` and the bonus from ``p_k``, after the same filtering as
    ``sample``; the committed token is distributed as the target's. The
    uniforms and the corrections come from ``generator``, so sampled streams
    differ from JAX's as ``sample``'s do."""
    B, S, V = target_logits.shape
    k = S - 1
    target_logits = target_logits.float()
    if config.greedy:
        t = torch.argmax(target_logits, dim=-1).to(torch.int32)  # [B, S]
        match = draft_tokens.to(torch.int32) == t[:, :k]
        n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        return t, (n_acc + 1).to(torch.int32)
    p = torch.softmax(_filter_logits(target_logits, config), dim=-1)
    q = torch.softmax(_filter_logits(draft_logits.float(), config), dim=-1)
    d = draft_tokens.long()[..., None]
    p_d = p[:, :k].gather(-1, d)[..., 0]
    q_d = q.gather(-1, d)[..., 0]
    u = torch.rand((B, k), generator=generator, device=p.device)
    accept = u < p_d / torch.clamp(q_d, min=1e-30)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    # the correction distribution at each draft position (the residual),
    # the bonus distribution at S-1
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rsum > 0, resid / torch.clamp(rsum, min=1e-30), p[:, :k])
    corr = torch.cat([resid, p[:, k:]], dim=1)  # [B, S, V]
    c = torch.multinomial(corr.reshape(B * S, V), 1, generator=generator).reshape(B, S)
    drafts_pad = torch.cat([draft_tokens.long(), torch.zeros((B, 1), dtype=torch.long, device=c.device)], dim=1)
    idx = torch.arange(S, device=c.device)[None, :]
    tokens = torch.where(idx < n_acc[:, None], drafts_pad, c)
    return tokens.to(torch.int32), (n_acc + 1).to(torch.int32)
