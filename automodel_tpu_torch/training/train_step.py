"""The training step, port of ``build_train_step`` (:30),
``build_eval_step`` (:267) and ``make_causal_lm_loss`` (:295) of
``automodel_tpu/training/train_step.py``.

One step takes a batch whose leaves carry a leading microbatch axis [A,
...]: gradients of every microbatch's summed token loss, accumulated in
fp32 when A > 1 and kept in the param dtype when A == 1 (:135-148);
normalized by the global label-token count of all microbatches (:170-176);
the fp32 global grad norm; a ``nonfinite`` flag; and the optimizer update.
With ``on_nonfinite: skip`` a non-finite step applies nothing, so params
and Adam moments stay bit-identical (:211-224); the step counter still
advances. ``raise`` and ``rollback`` are the recipe's, read off the
``nonfinite`` flag. ``grad_mask`` (one bool a parameter, False = frozen;
``training/freeze.py``) computes no gradient for a frozen tensor and
hands the optimizer a zero one, so ``grad_norm`` covers the trainable
tensors only (:127-130). A loss function may return a third value, per-microbatch
``extras``: the MoE models' ``moe_aux_loss`` and ``expert_counts`` are
summed over microbatches and reported as ``moe_aux_loss`` (divided by the
microbatch count, :225-226), ``expert_load_imbalance`` and its per-layer
list (:243-249); ``post_step_fn(extras)`` runs after an applied update
(:192), the aux-free router-bias slot. Pipeline info, ``bound_params``,
QAT and LoRA hooks are not ported.

``anomaly_flags`` (default on, ``telemetry.anomaly_flags``) adds
``telemetry/anomaly.py``'s metrics: ``nonfinite`` (a non-finite loss or
any non-finite gradient *element*, as JAX's :199-209 counts them, not the
norm's finiteness: the fp32 sum of squares overflows while every element
is finite), ``grad_nonfinite_count`` and ``grad_norm/<group>`` per JAX
param group (``groups``, one name a parameter). All of it comes from the
per-tensor norms the global norm takes; elements are counted only in a
tensor whose norm is not finite. With the flags off, ``nonfinite`` is
still computed when the policy or the fault injection needs it (JAX
:203-209), and absent otherwise. ``nan_grads_at_step`` (fault injection)
adds NaN to every gradient of that step before the norms (:182-187).
Deciding whether to apply the update reads the flag on the host (one
synchronisation per step).

Under a mesh (``mesh_ctx``, the parameters placed by
``parallel/plans.parallelize``) the gradients come from ``backward()``:
FSDP2 reduce-scatters each microbatch's into the parameters' shards (a
sum over ``fsdp``, all-reduced over ``dp_replicate`` for HSDP), and the
step reads each shard's local tensor. The token count and the loss sum
are all-reduced over ``loss_dp``, as JAX normalizes over that group, and
the grads divided by the global count then equal one process's. The
per-tensor norms, and the non-finite element counts behind ``nonfinite``,
are summed over the mesh dims each tensor is sharded on, so ``grad_norm``
and its groups are the whole model's on every rank. The optimizer updates
the local shards (``state.optimizer`` was built over them). An MoE
model's expert counts are summed over ``loss_dp`` before the aux-free
bias update, and its ``moe_aux_loss`` is the mean of the ranks' (each
rank's aux loss is taken over its own tokens).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from automodel_tpu_torch.optim.builders import global_norm_fp32, tensor_norms_fp32
from automodel_tpu_torch.parallel.plans import global_norms_fp32, is_sharded, local
from automodel_tpu_torch.telemetry.anomaly import anomaly_metrics, nonfinite_count
from automodel_tpu_torch.training.train_state import TrainState

ON_NONFINITE = ("raise", "skip", "rollback")


def build_train_step(
    loss_fn: Callable[[dict], tuple],
    lr_schedule: Optional[Callable[[int], float]] = None,
    on_nonfinite: str = "raise",
    post_step_fn: Optional[Callable[[dict], None]] = None,
    grad_mask: Optional[Sequence[bool]] = None,
    anomaly_flags: bool = True,
    groups: Optional[Sequence[str]] = None,
    nan_grads_at_step: Optional[int] = None,
    mesh_ctx: Any = None,
) -> Callable[[TrainState, dict], dict]:
    """(state, batch) → metrics, updating ``state`` in place.

    ``loss_fn(microbatch) -> (loss_sum, n_valid_tokens[, extras])``,
    loss_sum the un-normalized token-loss sum. Metrics are tensors on the batch's device
    (``loss``, ``grad_norm``, ``num_label_tokens``, ``nonfinite``) plus the
    host ints/floats ``step``, ``lr`` and, under ``skip``, ``skipped``. With
    ``raise`` the caller checks ``nonfinite`` (recipes/train_ft.py).
    ``groups`` names each parameter's group for ``grad_norm/<group>``
    (``telemetry.anomaly.jax_groups``; one ``params`` group when None)."""
    if on_nonfinite not in ON_NONFINITE:
        raise ValueError(f"on_nonfinite={on_nonfinite!r} is not ported (want one of {ON_NONFINITE})")
    sharded = mesh_ctx is not None
    loss_group = mesh_ctx.group("loss_dp") if sharded and mesh_ctx.group_size("loss_dp") > 1 else None

    def step_fn(state: TrainState, batch: dict) -> dict:
        params = state.params
        mask = [True] * len(params) if grad_mask is None else list(grad_mask)
        trainable = [p for p, m in zip(params, mask) if m]

        def full(mb_grads) -> list:
            """Trainable grads back in parameter order, a zero for a frozen one."""
            it = iter(mb_grads)
            return [next(it) if m else torch.zeros_like(p) for p, m in zip(params, mask)]
        n_mb = batch["input_ids"].shape[0]
        loss_sum = n_tokens = grads = None
        extras_sum: dict = {}
        for i in range(n_mb):
            mb = {k: v[i] for k, v in batch.items() if isinstance(v, torch.Tensor)}
            mb_loss, mb_n, *rest = loss_fn(mb)
            for k, v in (rest[0] if rest else {}).items():
                extras_sum[k] = v if k not in extras_sum else extras_sum[k] + v
            mb_loss = mb_loss.float()
            if sharded:
                mb_grads = _backward_grads(mb_loss, params, mask)
            else:
                mb_grads = full(torch.autograd.grad(mb_loss, trainable))
            mb_loss = mb_loss.detach()
            if n_mb == 1:
                # no accumulation: the grads stay in the param dtype
                loss_sum, n_tokens, grads = mb_loss, mb_n, list(mb_grads)
            elif grads is None:
                loss_sum, n_tokens = mb_loss, mb_n
                grads = [g.float() for g in mb_grads]
            else:
                loss_sum, n_tokens = loss_sum + mb_loss, n_tokens + mb_n
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g)  # in fp32, without an fp32 copy of g
            del mb_grads
        if loss_group is not None:
            import torch.distributed as dist

            n_tokens, loss_sum = n_tokens.clone(), loss_sum.clone()
            dist.all_reduce(n_tokens, group=loss_group)
            dist.all_reduce(loss_sum, group=loss_group)
            for k in ("expert_counts", "moe_aux_loss"):
                if k in extras_sum:
                    v = extras_sum[k].detach().clone()
                    dist.all_reduce(v, group=loss_group)
                    extras_sum[k] = v if k == "expert_counts" else v / mesh_ctx.group_size("loss_dp")
        denom = torch.clamp(n_tokens, min=1).float()
        # divide in fp32 even for bf16 grads (a bf16-rounded token count is
        # off by up to 0.4%)
        if n_mb == 1:
            # in place, one tensor at a time: a second list of the model's
            # grads would not fit beside the first at full depth
            for g in grads:
                g.copy_((g.float() / denom).to(g.dtype))
        else:
            for g in grads:
                g.div_(denom)
        if nan_grads_at_step is not None and state.step + 1 == nan_grads_at_step:
            for g in grads:
                g.add_(float("nan"))
        like = params if sharded else None
        norms = global_norms_fp32(grads, like) if sharded else tensor_norms_fp32(grads)
        grad_norm = global_norm_fp32(grads, norms)
        metrics: dict[str, Any] = {
            "loss": loss_sum / denom,
            "grad_norm": grad_norm,
            "num_label_tokens": n_tokens,
            "step": state.step + 1,
        }

        def flags() -> dict:
            # reads the norms' finiteness on the host: taken after the update
            # is queued unless the skip policy must see it first
            if anomaly_flags:
                return anomaly_metrics(loss_sum, grads, norms, groups or ["params"] * len(grads), like=like)
            if on_nonfinite != "raise" or nan_grads_at_step is not None:
                return {"nonfinite": ~torch.isfinite(loss_sum) | (nonfinite_count(grads, norms, like=like) > 0)}
            return {}
        if "moe_aux_loss" in extras_sum:
            metrics["moe_aux_loss"] = extras_sum["moe_aux_loss"] / n_mb
        if "expert_counts" in extras_sum:
            c = extras_sum["expert_counts"].float()  # [L, E]
            per_layer = c.amax(dim=-1) / c.mean(dim=-1).clamp_min(1.0)
            metrics["expert_load_imbalance"] = per_layer.mean()
            metrics["expert_load_imbalance_per_layer"] = per_layer
        if lr_schedule is not None:
            metrics["lr"] = float(lr_schedule(state.step))
        skip = False
        if on_nonfinite == "skip":
            metrics.update(flags())
            skip = bool(metrics["nonfinite"])
        if not skip:
            state.optimizer.update(grads, grad_norm)
            if post_step_fn is not None:
                post_step_fn(extras_sum)
        if on_nonfinite == "skip":
            metrics["skipped"] = skip
        else:
            metrics.update(flags())
        state.step += 1
        return metrics

    return step_fn


def _backward_grads(loss: torch.Tensor, params: Sequence[torch.Tensor], mask: Sequence[bool]) -> list:
    """One microbatch's gradients through ``backward()`` (FSDP2 reduces
    them into the parameters' shards): each trainable parameter's local
    shard of its gradient, a zero for a frozen one; ``.grad`` is cleared."""
    loss.backward()
    out = []
    for p, m in zip(params, mask):
        g = p.grad if m else None
        out.append(torch.zeros_like(local(p)) if g is None else local(g))
        p.grad = None
    return out


def build_eval_step(loss_fn: Callable[[dict], tuple], mesh_ctx: Any = None) -> Callable[[TrainState, dict], dict]:
    """(state, batch) → ``{"loss_sum", "num_label_tokens"}`` summed over the
    batch's microbatches (leading axis [A, ...]): the forward only, under
    ``torch.no_grad``, the loss sum accumulated in fp32 as JAX's scan
    does, and summed over ``loss_dp`` under a mesh. The state's
    parameters are the model's own, so the step reads them through
    ``loss_fn``."""
    loss_group = None
    if mesh_ctx is not None and mesh_ctx.group_size("loss_dp") > 1:
        loss_group = mesh_ctx.group("loss_dp")

    @torch.no_grad()
    def step_fn(state: TrainState, batch: dict) -> dict:
        loss_sum = n_tokens = None
        for i in range(batch["input_ids"].shape[0]):
            mb = {k: v[i] for k, v in batch.items() if isinstance(v, torch.Tensor)}
            mb_loss, mb_n, *_ = loss_fn(mb)
            mb_loss = mb_loss.float()
            if loss_sum is None:
                loss_sum, n_tokens = mb_loss, mb_n
            else:
                loss_sum, n_tokens = loss_sum + mb_loss, n_tokens + mb_n
        if loss_group is not None:
            import torch.distributed as dist

            loss_sum, n_tokens = loss_sum.clone(), n_tokens.clone()
            dist.all_reduce(loss_sum, group=loss_group)
            dist.all_reduce(n_tokens, group=loss_group)
        return {"loss_sum": loss_sum, "num_label_tokens": n_tokens}

    return step_fn


def make_causal_lm_loss(model: Any, loss: str = "masked_ce", mesh_ctx: Any = None,
                        **loss_kwargs: Any) -> Callable[[dict], tuple]:
    """Next-token-prediction loss over the port's causal LM: labels are
    already shifted by the collator. ``fused_linear_ce`` never materializes
    the full logits (ops/losses.py); ``vocab_parallel_ce`` shards them on
    the vocabulary over the mesh's ``tp`` group (``fused_linear_ce`` at tp
    = 1, and without a mesh, as JAX's :319-333). Under tensor parallelism
    the other losses gather the vocab-sharded lm_head whole. An MoE model
    (whose forward and ``hidden`` return ``(output, aux)``) adds ``aux_loss
    x n`` to the loss sum, so the global token normalization averages it by
    token, and returns ``extras`` with ``moe_aux_loss`` and
    ``expert_counts`` (:338-349)."""
    from automodel_tpu_torch.ops import losses as L

    hidden_path = loss in ("fused_linear_ce", "vocab_parallel_ce")
    build = None if hidden_path else L.build_loss(loss, **loss_kwargs)
    vocab_parallel = loss == "vocab_parallel_ce" and mesh_ctx is not None and mesh_ctx.tp_size > 1

    def loss_fn(mb: dict):
        kw = {k: mb[k] for k in ("position_ids", "segment_ids") if mb.get(k) is not None}
        if hidden_path:
            out = model.hidden(mb["input_ids"], **kw)
            hidden, maux = out if isinstance(out, tuple) else (out, None)
            weight = model.lm_head_weight()
            cap = model.config.logits_soft_cap
            if vocab_parallel:
                loss_sum, n = L.vocab_parallel_cross_entropy(
                    hidden, weight.to(hidden.dtype).t(), mb["labels"], mesh_ctx, logits_soft_cap=cap, **loss_kwargs
                )
            else:
                if is_sharded(weight):
                    weight = weight.full_tensor()
                loss_sum, n = L.fused_linear_cross_entropy(
                    hidden, weight.to(hidden.dtype).t(), mb["labels"], logits_soft_cap=cap, **loss_kwargs
                )
        else:
            out = model(mb["input_ids"], **kw)
            logits, maux = out if isinstance(out, tuple) else (out, None)
            loss_sum, n = build(logits, mb["labels"])
        if maux is None:
            return loss_sum, n
        loss_sum = loss_sum + maux.aux_loss * n.float()
        extras = {"moe_aux_loss": maux.aux_loss.detach(), "expert_counts": maux.expert_counts}
        return loss_sum, n, extras

    return loss_fn
