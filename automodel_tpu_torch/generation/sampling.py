"""Token sampling: greedy / temperature / top-k / top-p.

Port of ``automodel_tpu/generation/sampling.py``. The JAX code folds the
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
