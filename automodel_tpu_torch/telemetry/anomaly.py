"""In-step anomaly flags, port of ``automodel_tpu/telemetry/anomaly.py``.

The train step folds these into its metrics: a boolean ``nonfinite`` (a
non-finite loss, or any non-finite gradient element), the gradients'
non-finite element count, and the fp32 grad norm per parameter group
(``grad_norm/<group>``), the NaN localizer: a non-finite element anywhere
in a group makes that group's norm non-finite, so the record names the
group that blew up in the step it happened.

Everything is computed from the per-tensor fp32 norms the global norm
already takes (``optim/builders.tensor_norms_fp32``): a group norm is the
norm of its tensors' norms, and a finite tensor norm proves the tensor
holds no non-finite element. So elements are counted only in the tensors
whose norm is not finite — the rare step — and never in the common case.
The flag is an element count, as JAX's is, not the norm's finiteness: the
fp32 sum of squares overflows to ``inf`` while every element is finite
(one element near 1e20), and such a step is not non-finite.

Group names are the JAX param tree's first path component (``embed``,
``layers``, ``final_norm``, ``lm_head``; ``dense_layers`` /
``moe_layers`` for Qwen3-MoE), so ``grad_norm/<group>`` keys are the same
in both packages' JSONL.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import torch

_LAYER = re.compile(r"^model\.layers\.(\d+)\.")
_ENDS = (("model.embed_tokens.", "embed"), ("model.norm.", "final_norm"), ("lm_head.", "lm_head"))


def jax_groups(model: Any, names: Sequence[str]) -> list[str]:
    """The JAX param tree's first path component for each of the port's
    parameter names (``params_from_jax`` read backwards)."""
    stacks = getattr(model, "jax_layer_stacks", None)
    n_dense = getattr(getattr(getattr(model, "config", None), "moe", None), "num_dense_layers", 0) or 0
    out = []
    for name in names:
        group = next((g for prefix, g in _ENDS if name.startswith(prefix)), None)
        if group is None:
            m = _LAYER.match(name)
            if m is None:
                group = name.split(".")[0]
            elif stacks:
                group = stacks[0] if int(m.group(1)) < n_dense else stacks[1]
            else:
                group = "layers"
        out.append(group)
    return out


def nonfinite_count(tensors: Sequence[torch.Tensor], norms: Sequence[torch.Tensor], like=None) -> torch.Tensor:
    """Count of non-finite elements over ``tensors`` (int64 scalar), given
    their fp32 norms: one host read of the norms' finiteness, then an
    element count only in the tensors whose norm is not finite. With
    ``like`` (the parameters, when ``tensors`` are their local shards) a
    tensor's count is summed over the ranks it is sharded across."""
    finite = torch.isfinite(torch.stack(list(norms))).tolist()
    count = torch.zeros((), dtype=torch.int64, device=norms[0].device)
    bad = [i for i, ok in enumerate(finite) if not ok]
    if not bad:
        return count
    counts = [(~torch.isfinite(tensors[i])).sum() for i in bad]
    if like is not None:
        from automodel_tpu_torch.parallel.plans import global_sums

        return count + global_sums([like[i] for i in bad], counts).sum()
    for c in counts:
        count = count + c
    return count


def group_grad_norms(norms: Sequence[torch.Tensor], groups: Sequence[str]) -> dict[str, torch.Tensor]:
    """fp32 L2 norm per group from the per-tensor norms → ``grad_norm/<group>``."""
    by_group: dict[str, list] = {}
    for n, g in zip(norms, groups):
        by_group.setdefault(g, []).append(n)
    return {f"grad_norm/{g}": torch.linalg.vector_norm(torch.stack(ns)) for g, ns in by_group.items()}


def anomaly_metrics(
    loss_sum: torch.Tensor, grads: Sequence[torch.Tensor], norms: Sequence[torch.Tensor], groups: Sequence[str],
    like=None,
) -> dict[str, torch.Tensor]:
    """The metrics fragment the train step merges in: ``nonfinite`` (loss
    or any grad element), ``grad_nonfinite_count`` and the group norms
    (``like``: see ``nonfinite_count``)."""
    bad = nonfinite_count(grads, norms, like=like)
    out = {"nonfinite": ~torch.isfinite(loss_sum) | (bad > 0), "grad_nonfinite_count": bad}
    out.update(group_grad_norms(norms, groups))
    return out
