"""Optimizer construction from config, port of
``automodel_tpu/optim/builders.py`` for ``adamw`` and ``adam``.

The update follows the optax chain the JAX package builds (:126-165), in
its order: the fp32 global-norm clip (``clip_by_global_norm_fp32``), Adam
with moments kept in fp32 whatever the param dtype
(``scale_by_adam_fp32_moments``), decoupled weight decay (adamw only), then
the learning-rate schedule; the new parameter is ``(p.float() + u)`` cast
back to p's dtype, as ``optax.apply_updates`` and the cast at
``training/train_step.py:188`` do. It is written out by hand because
``torch.optim.AdamW`` keeps its moments in the parameter dtype: with bf16
params the second moment's ``(1 - b2) * g**2`` increment rounds away and
it freezes, the fault :33-44 of the JAX module documents.

Grads in bf16 (one microbatch with bf16 params) round where optax 0.2.6
rounds them: the clip scale is cast to the grad's dtype (:84), and
``(1-b1)·g``, ``g²`` and ``(1-b2)·g²`` are computed in that dtype, the
decay constants rounded to it, before each is added into its fp32 moment.
fp32 grads keep every step in fp32. The bias corrections ``1 - b**count``
are fp32, as optax's.

Updates are in place (params and moments), since a torch step owns its
buffers; the caller decides beforehand whether a step is applied at all.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from automodel_tpu_torch.optim.scheduler import build_lr_schedule


def global_norm_fp32(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm with fp32 accumulation whatever the leaf dtype (bf16
    partial sums saturate after a few hundred equal-magnitude terms)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamFP32:
    """Clipped Adam/AdamW with fp32 moments over a fixed list of params."""

    params: list
    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    count: int = 0  # updates applied (optax's adam and schedule counts)
    mu: list = dataclasses.field(default_factory=list)
    nu: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.params = list(self.params)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> None:
        """Apply one step in place from ``grads`` (one per param, any float
        dtype). ``grad_norm`` is the fp32 global norm if the caller has it."""
        clip = None
        if self.grad_clip_norm:
            norm = grad_norm if grad_norm is not None else global_norm_fp32(grads)
            clip = torch.clamp(self.grad_clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        count = self.count + 1
        # the bias corrections in fp32, as optax computes 1 - b**count
        bc1 = float(1 - np.float32(self.b1) ** np.float32(count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(count))
        lr = float(self.schedule(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if g.dtype == torch.float32:
                g32 = g if clip is None else g * clip
                mu.mul_(self.b1).add_(g32, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g32, g32, value=1.0 - self.b2)
            else:
                # optax's moment update in the grad's dtype (tree_update_moment):
                # the clip scale, (1 - b1)·g, g² and (1 - b2)·g² each rounded to
                # it, the decay constants too, then added into the fp32 moment
                if clip is not None:
                    g = g * clip.to(g.dtype)
                mu.mul_(self.b1).add_(g * torch.tensor(1.0 - self.b1, dtype=g.dtype))
                nu.mul_(self.b2).add_((g * g) * torch.tensor(1.0 - self.b2, dtype=g.dtype))
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                u.add_(p.float(), alpha=self.weight_decay)
            p.copy_((p.float() + u.mul_(-lr)).to(p.dtype))
        self.count = count


OPTIMIZERS = ("adamw", "adam")


def build_optimizer(
    params: Iterable[torch.Tensor],
    name: str = "adamw",
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    grad_clip_norm: float | None = None,
    lr_schedule: Any | None = None,
) -> AdamFP32:
    """The ``optimizer:`` section over ``params``. Only ``adamw`` and
    ``adam`` (no weight decay), both with fp32 moments, are ported; any
    other name is refused."""
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer {name!r} is not ported to the torch backend (it has {list(OPTIMIZERS)})")
    lr = float(lr)
    schedule = build_lr_schedule(lr=lr, **dict(lr_schedule)) if lr_schedule else build_lr_schedule(lr=lr)
    b1, b2 = (float(b) for b in betas)
    return AdamFP32(
        params=list(params), schedule=schedule, b1=b1, b2=b2, eps=float(eps),
        weight_decay=float(weight_decay) if name == "adamw" else 0.0,
        grad_clip_norm=float(grad_clip_norm) if grad_clip_norm else None,
    )
