"""Collectives with the backward tensor parallelism needs (Megatron's
``f`` and ``g``): the gradient of an input every rank of a group reads
whole is the sum of the ranks' partial gradients (``grad_sum``), and the
sum of the ranks' partial outputs hands every rank the whole gradient
back (``sum_partials``). GSPMD places both where JAX's sharded einsums
need them; here the layers that split their work over ``tp`` call them.
"""

from __future__ import annotations

import torch


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``."""
    return _GradSum.apply(x, group)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' ``x``; identity backward."""
    return _SumPartials.apply(x, group)
