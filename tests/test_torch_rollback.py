"""``fault_tolerance.on_nonfinite: rollback`` in the port's recipe, JAX's
three rollback tests (``tests/test_resilience.py:876-931``) in the port's
terms, plus the no-checkpoint refusal and the fast-forward arithmetic held
to JAX's ``_rollback`` case by case; the host RNG state
(``training/rng.StatefulRNG``) through a checkpoint; ``freeze_mask``
against JAX's trainable set and grad norm."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu_torch.cli import app
from automodel_tpu_torch.config import ConfigNode
from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction as Recipe
from automodel_tpu_torch.resilience.preemption import NonFiniteError
from torch_port_parity import CPU, HF_TINY, jax_tiny, torch_twin


def _cfg(tmp_path, **extra):
    cfg = {
        "seed": 7,
        "device": "cpu",
        "model": {
            "hf_config": dict(HF_TINY, max_position_embeddings=128),
            "backend": {"attn": "sdpa", "param_dtype": "float32", "compute_dtype": "float32"},
        },
        "dataset": {"_target_": "automodel_tpu.data.sft.MockSFTDataset", "vocab_size": 128, "seq_length": 32,
                    "num_samples": 64},
        "dataloader": {"global_batch_size": 8},
        "step_scheduler": {"grad_acc_steps": 1, "num_epochs": 2, "max_steps": 4, "ckpt_every_steps": 1},
        "optimizer": {"name": "adamw", "lr": 1e-3, "grad_clip_norm": 1.0},
        "loss_fn": {"name": "masked_ce"},
        "checkpoint": {"enabled": True, "checkpoint_dir": str(tmp_path / "ckpt")},
        "logging": {"metrics_path": str(tmp_path / "metrics.jsonl")},
        "fault_tolerance": {"on_nonfinite": "rollback"},
    }
    cfg.update(extra)
    r = Recipe(ConfigNode(cfg))
    r.setup()
    return r


def _flag_at(r, step, once=True):
    orig, fired = r.train_step, []

    def flaky(state, batch):
        m = orig(state, batch)
        if m["step"] == step and not (once and fired):
            fired.append(1)
            m = dict(m, nonfinite=torch.tensor(True))
        return m

    r.train_step = flaky
    return fired


def test_rollback_restores_and_completes(tmp_path):
    """One transient non-finite step 3: restore step 2, skip the bad
    window's batch, finish all 4 steps; the JSONL passes report --strict."""
    r = _cfg(tmp_path)
    fired = _flag_at(r, 3)
    last = r.run_train_validation_loop()
    assert fired == [1] and last["step"] == 4 and last["rollbacks_total"] == 1
    assert np.isfinite(last["loss"])
    # restore to step 2 (2 consumed) + 1 fast-forwarded + steps 3, 4 + the
    # scheduler's one look-ahead batch before it sees max_steps: 6, as JAX
    assert r.dataloader.state_dict()["batch_in_epoch"] == 6
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    # the recovery events (cost_attribution, the non-finite step's triggered
    # trace_capture and goodput_tail are the telemetry's own, as in JAX)
    events = [x["event"] for x in rows
              if x.get("event") not in (None, "cost_attribution", "trace_capture", "goodput_tail")]
    assert events == ["rollback", "resume"]
    assert next(x for x in rows if x.get("event") == "rollback")["fail_step"] == 3
    assert next(x for x in rows if x.get("event") == "resume")["resumed_from_step"] == 2
    assert [x["step"] for x in rows if "loss" in x] == [1, 2, 3, 4]
    assert app.main(["report", str(tmp_path / "metrics.jsonl"), "--strict"]) == 0
    # no checkpoint at or after the failed step was committed before it
    committed = sorted(p.parent.name for p in (tmp_path / "ckpt").glob("*/MANIFEST.json"))
    assert committed[-1] == "epoch_0_step_4" and "epoch_0_step_3" in committed


def test_rollback_budget_exhausts_to_raise(tmp_path):
    """A deterministic non-finite step recurs after every restore: it burns
    the budget, then raises instead of looping."""
    r = _cfg(tmp_path, fault_tolerance={"on_nonfinite": "rollback", "max_rollbacks": 1})
    _flag_at(r, 2, once=False)
    with pytest.raises(NonFiniteError, match="step 2"):
        r.run_train_validation_loop()
    assert r.rollbacks == 1


def test_rollback_without_a_checkpoint_raises_jax_message(tmp_path):
    r = _cfg(tmp_path, checkpoint={"enabled": False})
    _flag_at(r, 2)
    with pytest.raises(NonFiniteError, match="rollback requested but no checkpoint is available"):
        r.run_train_validation_loop()
    with pytest.raises(ValueError, match="on_nonfinite"):
        _cfg(tmp_path, fault_tolerance={"on_nonfinite": "retry"})


@pytest.mark.parametrize(
    "nb,ga,pos,ckpt_step,fail_step",
    [(10, 3, 6, 2, 5), (10, 1, 4, 2, 3), (7, 2, 4, 1, 9), (10, 3, 9, 3, 4), (2, 3, 0, 1, 4), (8, 2, 0, 0, 3)],
)
def test_fast_forward_equals_jax_arithmetic(nb, ga, pos, ckpt_step, fail_step):
    """The loader cursor and the scheduler's epoch after a rollback, epoch
    tails included (``len(dl)`` not a multiple of grad_acc), equal JAX's
    ``_rollback`` on the same state."""
    from automodel_tpu.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe

    def fake(cls):
        class _DL:
            epoch, batch_in_epoch = 0, pos

            def __len__(self):
                return nb

            def seek(self, epoch, b):
                self.epoch, self.batch_in_epoch = epoch, b

        r = object.__new__(cls)
        r.dataloader = _DL()
        r.step_scheduler = types.SimpleNamespace(step=ckpt_step, epoch=0, grad_acc_steps=ga)
        r.checkpointer = types.SimpleNamespace(has_checkpoint=lambda: True, wait=lambda: None)
        r.telemetry = types.SimpleNamespace(record_step=lambda rec: None)
        r.metric_logger = types.SimpleNamespace(log=lambda rec: None)
        r.resilience = types.SimpleNamespace(rollbacks=1)
        r.rollbacks = 1
        r._restore = lambda before_step: None
        r._rollback(fail_step=fail_step)
        return r.dataloader.epoch, r.dataloader.batch_in_epoch, r.step_scheduler.epoch

    assert fake(Recipe) == fake(JaxRecipe)


def test_stateful_rng_rides_the_checkpoint(tmp_path):
    """The host RNG state is saved in a checkpoint's extras under "rng" and
    restored on resume; its streams equal JAX's StatefulRNG's."""
    from automodel_tpu.training.rng import StatefulRNG as JaxRNG
    from automodel_tpu_torch.training.rng import StatefulRNG

    a, b = StatefulRNG(3), JaxRNG(3)
    assert [a.python.random() for _ in range(4)] == [b.python.random() for _ in range(4)]
    assert np.array_equal(a.numpy.integers(0, 1 << 30, 8), b.numpy.integers(0, 1 << 30, 8))
    r = _cfg(tmp_path, step_scheduler={"max_steps": 2, "ckpt_every_steps": 2})
    r.rng.python.random()
    r.rng.numpy.random(5)
    r.run_train_validation_loop()
    extra = json.loads((tmp_path / "ckpt" / "epoch_0_step_2" / "extra_state.json").read_text())
    want = r.rng.state_dict()
    b.load_state_dict(json.loads(json.dumps(want)))  # JSON's lists back to tuples, as JAX
    r2 = _cfg(tmp_path, step_scheduler={"max_steps": 2, "ckpt_every_steps": 2})
    assert r2.state.step == 2 and "rng" in extra
    assert r2.rng.python.random() == b.python.random() == r.rng.python.random()
    assert r2.rng.numpy.random() == b.numpy.random() == r.rng.numpy.random()


def test_freeze_mask_trainable_set_and_grad_norm_equal_jax():
    """``freeze_mask`` over JAX leaf paths: the same trainable set as JAX's,
    and one train step with the mask gives JAX's grad norm (trainable
    tensors only); frozen tensors keep their values and hold no state."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.training.freeze import apply_freeze
    from automodel_tpu.training.freeze import freeze_mask as jax_mask
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.training.freeze import freeze_mask
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    patterns = ["embed/*", "layers/attn/*", "final_norm/*"]
    model, params, _ = jax_tiny(seed=4)
    jm = jax_mask(params, patterns)
    tmodel = torch_twin(params, trainable=True).model
    named = list(tmodel.named_parameters())
    names, tparams = [n for n, _ in named], [p for _, p in named]
    mask = freeze_mask(names, patterns)
    from automodel_tpu_torch.training.freeze import param_path

    flat = {"/".join(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jm)[0]}
    assert mask == [flat[param_path(n)] for n in names]
    assert 0 < sum(mask) < len(mask)

    # eps 1e-2: a first Adam step is ~lr x sign(g), so an element whose grad
    # is ~1e-8 would move by a framework's rounding of it; the mask is what
    # this test holds
    opt = dict(name="adamw", lr=1e-3, weight_decay=0.1, grad_clip_norm=1.0, eps=1e-2)
    jopt = apply_freeze(jax_optimizer(**opt), jm)
    jstate = JaxState.create(params, jopt.init(params))
    jfn = jax_step(jax_loss(model, loss="masked_ce"), jopt, donate=False, grad_mask=jm)
    topt = build_optimizer(tparams, trainable=mask, **opt)
    tstate = TrainState(params=tparams, optimizer=topt)
    tfn = build_train_step(make_causal_lm_loss(tmodel, loss="masked_ce"), grad_mask=mask)
    before = [p.detach().clone() for p in tparams]
    rng = np.random.default_rng(2)
    batch = {"input_ids": rng.integers(1, 128, (1, 2, 16)).astype(np.int32),
             "labels": rng.integers(0, 128, (1, 2, 16)).astype(np.int32)}
    jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tmet = tfn(tstate, {k: torch.from_numpy(v).to(CPU) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    got = tmodel.state_dict()
    for k, v in params_from_jax(jax.device_get(jstate.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    for p, b, m, mu in zip(tparams, before, mask, topt.mu):
        assert (mu is not None) == m
        if not m:
            assert torch.equal(p.detach(), b)
