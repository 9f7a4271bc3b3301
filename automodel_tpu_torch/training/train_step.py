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
advances. A loss function may return a third value, per-microbatch
``extras``: the MoE models' ``moe_aux_loss`` and ``expert_counts`` are
summed over microbatches and reported as ``moe_aux_loss`` (divided by the
microbatch count, :225-226), ``expert_load_imbalance`` and its per-layer
list (:243-249); ``post_step_fn(extras)`` runs after an applied update
(:192), the aux-free router-bias slot. Pipeline info, ``bound_params``,
QAT and LoRA hooks are not ported.

``nonfinite`` is read from the loss and the fp32 grad norm: any NaN or Inf
gradient element makes the norm non-finite. Deciding whether to apply the
update reads it on the host (one synchronisation per step).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from automodel_tpu_torch.optim.builders import global_norm_fp32
from automodel_tpu_torch.training.train_state import TrainState

ON_NONFINITE = ("raise", "skip")


def build_train_step(
    loss_fn: Callable[[dict], tuple],
    lr_schedule: Optional[Callable[[int], float]] = None,
    on_nonfinite: str = "raise",
    post_step_fn: Optional[Callable[[dict], None]] = None,
) -> Callable[[TrainState, dict], dict]:
    """(state, batch) → metrics, updating ``state`` in place.

    ``loss_fn(microbatch) -> (loss_sum, n_valid_tokens[, extras])``,
    loss_sum the un-normalized token-loss sum. Metrics are tensors on the batch's device
    (``loss``, ``grad_norm``, ``num_label_tokens``, ``nonfinite``) plus the
    host ints/floats ``step``, ``lr`` and, under ``skip``, ``skipped``. With
    ``raise`` the caller checks ``nonfinite`` (recipes/train_ft.py)."""
    if on_nonfinite not in ON_NONFINITE:
        raise ValueError(f"on_nonfinite={on_nonfinite!r} is not ported (want one of {ON_NONFINITE})")

    def step_fn(state: TrainState, batch: dict) -> dict:
        params = state.params
        n_mb = batch["input_ids"].shape[0]
        loss_sum = n_tokens = grads = None
        extras_sum: dict = {}
        for i in range(n_mb):
            mb = {k: v[i] for k, v in batch.items() if isinstance(v, torch.Tensor)}
            mb_loss, mb_n, *rest = loss_fn(mb)
            for k, v in (rest[0] if rest else {}).items():
                extras_sum[k] = v if k not in extras_sum else extras_sum[k] + v
            mb_loss = mb_loss.float()
            mb_grads = torch.autograd.grad(mb_loss, params)
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
        denom = torch.clamp(n_tokens, min=1).float()
        # divide in fp32 even for bf16 grads (a bf16-rounded token count is
        # off by up to 0.4%)
        if n_mb == 1:
            grads = [(g.float() / denom).to(g.dtype) for g in grads]
        else:
            for g in grads:
                g.div_(denom)
        grad_norm = global_norm_fp32(grads)
        nonfinite = ~(torch.isfinite(loss_sum) & torch.isfinite(grad_norm))
        metrics: dict[str, Any] = {
            "loss": loss_sum / denom,
            "grad_norm": grad_norm,
            "num_label_tokens": n_tokens,
            "nonfinite": nonfinite,
            "step": state.step + 1,
        }
        if "moe_aux_loss" in extras_sum:
            metrics["moe_aux_loss"] = extras_sum["moe_aux_loss"] / n_mb
        if "expert_counts" in extras_sum:
            c = extras_sum["expert_counts"].float()  # [L, E]
            per_layer = c.amax(dim=-1) / c.mean(dim=-1).clamp_min(1.0)
            metrics["expert_load_imbalance"] = per_layer.mean()
            metrics["expert_load_imbalance_per_layer"] = per_layer
        if lr_schedule is not None:
            metrics["lr"] = float(lr_schedule(state.step))
        skip = on_nonfinite == "skip" and bool(nonfinite)
        if not skip:
            state.optimizer.update(grads, grad_norm)
            if post_step_fn is not None:
                post_step_fn(extras_sum)
        if on_nonfinite == "skip":
            metrics["skipped"] = skip
        state.step += 1
        return metrics

    return step_fn


def build_eval_step(loss_fn: Callable[[dict], tuple]) -> Callable[[TrainState, dict], dict]:
    """(state, batch) → ``{"loss_sum", "num_label_tokens"}`` summed over the
    batch's microbatches (leading axis [A, ...]): the forward only, under
    ``torch.no_grad``, the loss sum accumulated in fp32 as JAX's scan
    does. The state's parameters are the model's own, so the step reads
    them through ``loss_fn``."""

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
        return {"loss_sum": loss_sum, "num_label_tokens": n_tokens}

    return step_fn


def make_causal_lm_loss(model: Any, loss: str = "masked_ce", **loss_kwargs: Any) -> Callable[[dict], tuple]:
    """Next-token-prediction loss over the port's causal LM: labels are
    already shifted by the collator. ``fused_linear_ce`` never materializes
    the full logits (ops/losses.py). An MoE model (whose forward and
    ``hidden`` return ``(output, aux)``) adds ``aux_loss x n`` to the loss
    sum, so the global token normalization averages it by token, and
    returns ``extras`` with ``moe_aux_loss`` and ``expert_counts``
    (:338-349)."""
    from automodel_tpu_torch.ops import losses as L

    build = None if loss == "fused_linear_ce" else L.build_loss(loss, **loss_kwargs)

    def loss_fn(mb: dict):
        kw = {k: mb[k] for k in ("position_ids", "segment_ids") if mb.get(k) is not None}
        if build is None:
            out = model.hidden(mb["input_ids"], **kw)
            hidden, maux = out if isinstance(out, tuple) else (out, None)
            kernel = model.lm_head_weight().to(hidden.dtype).t()
            loss_sum, n = L.fused_linear_cross_entropy(
                hidden, kernel, mb["labels"], logits_soft_cap=model.config.logits_soft_cap, **loss_kwargs
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
