"""Activation recompute of a decoder layer, port of ``remat_wrap`` in
``automodel_tpu/models/common/stacking.py``.

``remat_wrap(fn, policy)`` wraps one layer's function in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only what the policy saves, and the backward runs the layer
again for the rest. The layer stacks call it once per layer, never around
a group of layers: a coarser block would hold a whole group's activations
in the backward (JAX's comment on per-layer remat, same file). The
policies, against JAX's ``jax.checkpoint`` policies:

- ``full`` (``nothing_saveable``): a plain checkpoint, only the layer's
  inputs are kept;
- ``selective`` (``dots_with_no_batch_dims_saveable``): the outputs of
  ``aten.mm`` and ``aten.addmm``, the projections, are saved; everything
  else, attention included, is recomputed;
- ``full_save_dispatch``: as ``full``, but the outputs of ``aten.sort``
  and ``aten.argsort`` (the MoE dispatch permutations, moe/experts.py) are
  saved, so the recompute does not sort the picks again;
- ``none``: ``fn`` itself.

The flash kernels launch through ``ctypes`` inside a
``torch.autograd.Function``, which the policy's dispatch mode does not see:
under ``selective`` and ``full`` their forward simply runs again in the
recompute, on the same inputs, and gives the same output and lse.

The layer stacks run each FSDP2-wrapped decoder layer through its module
call (``DecoderLayer.forward`` runs the family's layer body), so FSDP2's
hooks gather a layer's parameters before it and free them after. Under ``full`` or ``selective`` the recompute
runs inside the backward, where FSDP2 has gathered them again.

Recompute applies only when grad is enabled: a forward under
``torch.no_grad`` (a frozen KD teacher, evaluation, generation) calls
``fn`` directly, as JAX leaves the KV-cache inference path unwrapped
(``automodel_tpu/models/llama/model.py:306-308``).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

REMAT_POLICIES = ("none", "full", "selective", "full_save_dispatch")
# the ops whose outputs each selective policy keeps; the rest is recomputed
_SAVED_OPS = {
    "selective": (torch.ops.aten.mm, torch.ops.aten.addmm),
    "full_save_dispatch": (torch.ops.aten.sort, torch.ops.aten.argsort),
}


def _context_fn(saved: tuple) -> Callable:
    def policy(ctx, func, *args, **kwargs):
        if func.overloadpacket in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_wrap(fn: Callable, policy: str) -> Callable:
    """``fn`` under the recompute ``policy`` (``none | full | selective |
    full_save_dispatch``); an unknown policy raises."""
    if policy == "none":
        return fn
    if policy == "full":
        kw: dict = {}
    elif policy in _SAVED_OPS:
        kw = dict(context_fn=_context_fn(_SAVED_OPS[policy]))
    else:
        raise ValueError(f"Unknown remat policy {policy!r}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)

    return wrapped


class DecoderLayer(nn.Module):
    """A decoder layer whose module call runs ``body(layer, *args)``: the
    family's layer function, with the module's hooks (FSDP2's gather and
    free) around it."""

    def forward(self, body: Callable, *args):
        return body(self, *args)


def call_layer(body: Callable) -> Callable:
    """``(i, layer, *args) -> body(i, layer, *args)``, through the layer's
    module call when FSDP2 wraps it (its hooks gather and free the
    parameters), directly otherwise (no module-call overhead on the
    single-device hot path)."""
    from torch.distributed.fsdp import FSDPModule

    def run(i: int, layer: nn.Module, *args):
        if isinstance(layer, FSDPModule):
            return layer(functools.partial(body, i), *args)
        return body(i, layer, *args)

    return run
