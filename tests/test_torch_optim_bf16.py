"""The port's AdamW on bf16 grads against the JAX package's on the CPU.

With bf16 params and one microbatch, both train steps hand the optimizer
bf16 grads. optax then rounds the clip scale, ``(1-b1)·g``, ``g²`` and
``(1-b2)·g²`` to bf16 before adding them into the fp32 moments; the port
copies those roundings (``optim/builders.py``). Inputs are made with numpy
from a seed and given to both.

Tolerance: after each of 4 steps at most 32 of the 65,536 elements of a
bf16 256x256 param (0.05%) may differ, each by at most two bf16 steps. The
rest of the arithmetic is fp32 in both, and the two frameworks order it
differently: 3-12 elements differ on these inputs, by one step (two once,
at step 4: a param already a step apart feeds its own weight decay). The same optimizer fed
the same grads cast to fp32 (all arithmetic in fp32, the port before it
copied the roundings) moves thousands of elements apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_parity import CPU, HF_TINY

MAX_DIFFERING = 32
SHAPE = (256, 256)


def _run(clip, cast_grads_to_fp32=False, steps=4, seed=0):
    """Both optimizers over ``steps`` steps on one bf16 param → the count of
    differing elements and the largest difference in bf16 steps (of the bit
    patterns; the params keep their sign), per step."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu_torch.optim.builders import build_optimizer

    rng = np.random.default_rng(seed)
    p0 = (rng.normal(size=SHAPE) * 0.05).astype(np.float32)
    kw = dict(name="adamw", lr=1e-2, weight_decay=0.01, grad_clip_norm=clip)
    jopt = jax_optimizer(**kw)
    jp = [jnp.asarray(p0, dtype=jnp.bfloat16)]
    jstate = jopt.init(jp)
    tp = [torch.tensor(p0).to(torch.bfloat16)]
    topt = build_optimizer(tp, **kw)
    out = []
    for _ in range(steps):
        g = (rng.normal(size=SHAPE) * 0.01).astype(np.float32)
        upd, jstate = jopt.update([jnp.asarray(g, dtype=jnp.bfloat16)], jstate, jp)
        jp = [x.astype(jnp.bfloat16) for x in optax.apply_updates(jp, upd)]
        tg = torch.tensor(g).to(torch.bfloat16)
        topt.update([tg.float() if cast_grads_to_fp32 else tg])
        got = tp[0].view(torch.int16).numpy().astype(np.int32)  # bf16 bit patterns
        want = np.asarray(jp[0]).view(np.int16).astype(np.int32)
        out.append((int((got != want).sum()), int(np.abs(got - want).max())))
    assert all(m.dtype == torch.float32 for m in topt.mu + topt.nu)
    return out


@pytest.mark.parametrize("clip", [None, 1.0])
def test_bf16_grad_adamw_matches_jax_every_step(clip):
    for step, (n_diff, worst) in enumerate(_run(clip), start=1):
        assert n_diff <= MAX_DIFFERING, f"step {step}: {n_diff} of {np.prod(SHAPE)} params differ"
        assert worst <= 2, f"step {step}: {worst} bf16 steps apart"


@pytest.mark.parametrize("clip", [None, 1.0])
def test_fp32_arithmetic_on_bf16_grads_is_caught(clip):
    """The check above is sharp: the same grads fed as fp32 (no bf16
    rounding, the port's arithmetic before it copied optax's) leave far
    more than ``MAX_DIFFERING`` elements apart."""
    n_diff = [n for n, _ in _run(clip, cast_grads_to_fp32=True)]
    assert min(n_diff) > 10 * MAX_DIFFERING, n_diff


BF16_BACKEND = dict(attn="sdpa", param_dtype="bfloat16", compute_dtype="bfloat16")
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0,
           lr_schedule=dict(style="cosine", warmup_steps=2, decay_steps=8))


def _batches(n_steps, seed=11):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=HF_TINY["vocab_size"], seq_length=16, num_samples=64, seed=seed)
    out = []
    for s in range(n_steps):
        group = [default_collater([ds[s * 2 + i] for i in range(2)])]
        out.append({k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)})
    return out


def test_bf16_one_microbatch_trajectory_matches_jax():
    """4 optimizer steps of the tiny Llama with bf16 params and compute, one
    microbatch a step (the path on which the optimizer gets bf16 grads),
    clip 1.0, cosine warmup, fused_linear_ce: each step's loss and grad norm
    to rtol 5e-3. The compute is bf16 and the frameworks round the forward
    and backward at different places: the losses read up to 8e-4 apart and
    the grad norms 2e-3, with or without the optimizer's roundings, so this
    holds the whole path and the optimizer tests above hold the roundings."""
    from automodel_tpu.models.common.config import BackendConfig as JaxBackend
    from automodel_tpu.models.common.config import TransformerConfig as JaxConfig
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig
    from automodel_tpu_torch.models.llama import LlamaForCausalLM, params_from_jax
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.optim.scheduler import build_lr_schedule
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    model = JaxLlama(JaxConfig.from_hf(HF_TINY), JaxBackend(**BF16_BACKEND))
    params = model.init(jax.random.key(0))
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(params))
    jopt = jax_optimizer(**OPT)
    jstate = JaxState.create(params, jax.jit(jopt.init)(params))
    jfn = jax_step(jax_loss(model, loss="fused_linear_ce"), jopt, jax_schedule(lr=OPT["lr"], **OPT["lr_schedule"]),
                   donate=False)

    tmodel = LlamaForCausalLM(TransformerConfig.from_hf(HF_TINY), BackendConfig(**BF16_BACKEND), device=CPU,
                              trainable=True)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    tparams = list(tmodel.parameters())
    assert all(p.dtype == torch.bfloat16 for p in tparams)
    tstate = TrainState(params=tparams, optimizer=build_optimizer(tparams, **OPT))
    tfn = build_train_step(make_causal_lm_loss(tmodel, loss="fused_linear_ce"),
                           build_lr_schedule(lr=OPT["lr"], **OPT["lr_schedule"]))

    for i, batch in enumerate(_batches(4)):
        assert batch["input_ids"].shape[0] == 1  # one microbatch
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=5e-3, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=5e-3,
                                   err_msg=f"step {i + 1}")
        assert np.isfinite(float(tm["loss"]))
    assert all(p.dtype == torch.bfloat16 for p in tparams) and tstate.optimizer.count == 4
