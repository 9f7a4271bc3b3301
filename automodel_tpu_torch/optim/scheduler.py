"""LR schedules, port of ``automodel_tpu/optim/scheduler.py``: warmup then
constant, linear, cosine or WSD decay with a min-lr floor. The JAX package
builds them from optax schedules; these are the same formulas
(``linear_schedule``, ``cosine_decay_schedule``, ``join_schedules``) as plain
functions of the step count."""

from __future__ import annotations

import math
from typing import Callable


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return f


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(count, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps)) + alpha)

    return f


def _constant(value: float) -> Callable[[int], float]:
    return lambda count: value


def _join(first: Callable, then: Callable, boundary: int) -> Callable[[int], float]:
    return lambda count: first(count) if count < boundary else then(count - boundary)


def build_lr_schedule(
    lr: float,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    style: str = "constant",
    min_lr: float = 0.0,
    wsd_decay_steps: int | None = None,
) -> Callable[[int], float]:
    """Warmup-then-decay schedule: step count → lr.

    style ∈ {constant, linear, cosine, wsd}. ``decay_steps`` counts steps
    after warmup. WSD (warmup-stable-decay) holds lr constant then decays
    linearly over the final ``wsd_decay_steps``.
    """
    lr, min_lr = float(lr), float(min_lr)
    if style == "constant":
        if not warmup_steps:
            return _constant(lr)
        return _join(_linear(0.0, lr, max(warmup_steps, 1)), _constant(lr), warmup_steps)
    if style == "linear":
        decay = _linear(lr, min_lr, max(decay_steps, 1))
    elif style == "cosine":
        decay = _cosine(lr, max(decay_steps, 1), min_lr / lr if lr else 0.0)
    elif style == "wsd":
        wsd_decay = wsd_decay_steps or max(decay_steps // 10, 1)
        stable = max(decay_steps - wsd_decay, 0)
        decay = _join(_constant(lr), _linear(lr, min_lr, wsd_decay), stable)
    else:
        raise ValueError(f"Unknown lr decay style {style!r}")
    if warmup_steps:
        return _join(_linear(0.0, lr, warmup_steps), decay, warmup_steps)
    return decay
