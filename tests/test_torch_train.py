"""The torch port's training slice against the JAX package on the CPU:
losses and their grads, the LR schedules, clipped AdamW with fp32 moments,
the data path, and the whole train step over 4 optimizer steps with
gradient accumulation (attn sdpa and flash on the port side), plus the
``on_nonfinite: skip`` policy. Same weights (carried by ``params_from_jax``)
and the same numpy-made batches go to both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automodel_tpu.ops import losses as jl
from automodel_tpu_torch.ops import losses as tl
from torch_port_parity import HF_TINY, jax_tiny, to_np, torch_twin


def _loss_inputs(seed=0, T=48, D=16, V=40):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(2, T // 2, D)).astype(np.float32)
    kernel = (rng.normal(size=(D, V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, size=(2, T // 2)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    return hidden, kernel, labels


@pytest.mark.parametrize("name", ["masked_ce", "chunked_ce", "fused_linear_ce"])
def test_losses_and_grads_match_jax(name):
    hidden, kernel, labels = _loss_inputs()
    cap = 5.0 if name == "fused_linear_ce" else None

    def jax_fn(h, w):
        if name == "fused_linear_ce":
            return jl.fused_linear_cross_entropy(h, w, jnp.asarray(labels), num_chunks=4, logits_soft_cap=cap)
        kw = {"num_chunks": 4} if name == "chunked_ce" else {}
        return jl.build_loss(name, **kw)(h @ w, jnp.asarray(labels))

    (j_loss, j_n), j_grads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(kernel)
    )
    th, tw = torch.tensor(hidden, requires_grad=True), torch.tensor(kernel, requires_grad=True)
    if name == "fused_linear_ce":
        t_loss, t_n = tl.fused_linear_cross_entropy(th, tw, torch.tensor(labels), num_chunks=4, logits_soft_cap=cap)
    else:
        kw = {"num_chunks": 4} if name == "chunked_ce" else {}
        t_loss, t_n = tl.build_loss(name, **kw)(th @ tw, torch.tensor(labels))
    t_loss.backward()
    assert int(t_n) == int(j_n) == int((labels != -100).sum())
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(to_np(th.grad), np.asarray(j_grads[0]), atol=1e-6)
    np.testing.assert_allclose(to_np(tw.grad), np.asarray(j_grads[1]), atol=1e-6)


def test_unported_loss_is_refused():
    with pytest.raises(ValueError, match="vocab_parallel_ce"):
        tl.build_loss("vocab_parallel_ce")
    with pytest.raises(ValueError, match="'bogus' is not ported"):
        tl.build_loss("bogus")


@pytest.mark.parametrize(
    "kw",
    [
        dict(style="constant"),
        dict(style="constant", warmup_steps=10),
        dict(style="linear", warmup_steps=20, decay_steps=200, min_lr=1e-5),
        dict(style="cosine", warmup_steps=100, decay_steps=150, min_lr=2e-5),
        dict(style="cosine", decay_steps=250),
        dict(style="wsd", warmup_steps=10, decay_steps=200),
        dict(style="wsd", warmup_steps=5, decay_steps=100, wsd_decay_steps=40, min_lr=1e-6),
    ],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()),
)
def test_lr_schedule_matches_optax_every_step(kw):
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
    from automodel_tpu_torch.optim.scheduler import build_lr_schedule

    ref, port = jax_schedule(lr=3e-4, **kw), build_lr_schedule(lr=3e-4, **kw)
    steps = np.arange(301)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = np.asarray([port(int(s)) for s in steps])
    # optax evaluates in fp32, the port in Python floats: a few fp32 ulps of
    # the value, or of lr where the value decays to ~0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=3e-4 * 4e-7)


def test_adamw_with_clip_and_weight_decay_matches_optax():
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu_torch.optim.builders import build_optimizer

    rng = np.random.default_rng(4)
    shapes = [(6, 5), (7,), (3, 2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    kw = dict(name="adamw", lr=0.05, weight_decay=0.1, betas=(0.9, 0.95), grad_clip_norm=1.0,
              lr_schedule=dict(style="cosine", warmup_steps=1, decay_steps=5))
    jopt = jax_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.tensor(p) for p in params]
    topt = build_optimizer(tp, **kw)
    for step in range(3):
        grads = [(rng.normal(size=s) * (3.0 if step == 1 else 0.2)).astype(np.float32) for s in shapes]
        upd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update([torch.tensor(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=f"step {step}")
    with pytest.raises(ValueError, match="lion"):
        build_optimizer(tp, name="lion")


def test_data_path_matches_jax_batches_and_resume_cursor():
    from automodel_tpu.data import collators as jc
    from automodel_tpu.data import loader as jld
    from automodel_tpu.data import sft as jsft
    from automodel_tpu_torch.data import collators as tc
    from automodel_tpu_torch.data import loader as tld
    from automodel_tpu_torch.data import sft as tsft

    kw = dict(vocab_size=50, seq_length=12, num_samples=20)
    jdl = jld.DataLoader(jsft.MockSFTDataset(**kw), global_batch_size=3, seed=5, pad_seq_len_divisible=8)
    tdl = tld.DataLoader(tsft.MockSFTDataset(**kw), global_batch_size=3, seed=5, pad_seq_len_divisible=8)
    jb, tb = list(jdl), list(tdl)
    assert len(jb) == len(tb) == 6
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b) and a["num_label_tokens"] == b["num_label_tokens"]
        for k in ("input_ids", "labels", "position_ids"):
            np.testing.assert_array_equal(a[k], b[k])
    sa, sb = jc.stack_microbatches(jb[:2]), tc.stack_microbatches(tb[:2])
    assert sa["num_label_tokens"] == sb["num_label_tokens"]
    np.testing.assert_array_equal(sa["labels"], sb["labels"])
    tdl.seek(1, 2)
    state = tdl.state_dict()
    resumed = tld.DataLoader(tsft.MockSFTDataset(**kw), global_batch_size=3, seed=0, pad_seq_len_divisible=8)
    resumed.load_state_dict(state)
    np.testing.assert_array_equal(next(iter(resumed))["input_ids"], tdl.batch_for(1, 2)["input_ids"])


def _batches(n_steps, accum, seed=11):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=HF_TINY["vocab_size"], seq_length=16, num_samples=64, seed=seed)
    out = []
    for s in range(n_steps):
        group = [default_collater([ds[(s * accum + a) * 2 + i] for i in range(2)]) for a in range(accum)]
        out.append({k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)})
    return out


OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01, betas=(0.9, 0.95), grad_clip_norm=1.0,
           lr_schedule=dict(style="cosine", warmup_steps=2, decay_steps=8))


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
def test_train_step_trajectory_matches_jax(attn):
    """4 optimizer steps, grad_acc_steps 2, cosine warmup, clip 1.0,
    fused_linear_ce: per-step loss and grad norm to rtol 1e-4 and the
    params after step 4 to atol 1e-5 (fp32)."""
    from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.optim.scheduler import build_lr_schedule
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    model, params, _ = jax_tiny(seed=0)
    jopt = jax_optimizer(**OPT)
    jstate = JaxState.create(params, jax.jit(jopt.init)(params))
    jfn = jax_step(jax_loss(model, loss="fused_linear_ce"), jopt, jax_schedule(lr=OPT["lr"], **OPT["lr_schedule"]),
                   donate=False)

    tmodel = torch_twin(params, attn=attn, trainable=True).model
    tparams = list(tmodel.parameters())
    tstate = TrainState(params=tparams, optimizer=build_optimizer(tparams, **OPT))
    tfn = build_train_step(make_causal_lm_loss(tmodel, loss="fused_linear_ce"),
                           build_lr_schedule(lr=OPT["lr"], **OPT["lr_schedule"]))

    for i, batch in enumerate(_batches(4, accum=2)):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert tm["step"] == int(jm["step"]) == i + 1
        assert int(tm["num_label_tokens"]) == int(jm["num_label_tokens"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert not bool(tm["nonfinite"])
    want = params_from_jax(jax.device_get(jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_skip_policy_leaves_params_and_moments_bit_identical():
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    _, params, _ = jax_tiny(seed=2)
    tmodel = torch_twin(params, trainable=True).model
    tparams = list(tmodel.parameters())
    state = TrainState(params=tparams, optimizer=build_optimizer(tparams, **OPT))
    base = make_causal_lm_loss(tmodel, loss="masked_ce")
    poison = {"on": False}

    def loss_fn(mb):
        loss_sum, n = base(mb)
        return (loss_sum * float("nan") if poison["on"] else loss_sum), n

    step = build_train_step(loss_fn, on_nonfinite="skip")
    b1, b2 = ({k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(2, accum=1, seed=3))
    first = step(state, b1)
    assert first["skipped"] is False and not bool(first["nonfinite"])
    opt = state.optimizer
    before = [t.clone() for t in tparams + opt.mu + opt.nu]
    poison["on"] = True
    m = step(state, b2)
    assert m["skipped"] is True and bool(m["nonfinite"]) and m["step"] == 2 == state.step
    after = tparams + opt.mu + opt.nu
    assert all(torch.equal(a, b) for a, b in zip(before, after)) and opt.count == 1
    with pytest.raises(ValueError, match="rollback"):
        build_train_step(loss_fn, on_nonfinite="rollback")


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
def test_model_grads_match_jax_key_by_key(attn):
    """One packed microbatch (two documents per row, positions restarting
    at each): the port's parameter grads of the mean token loss (the train
    step's normalization) against JAX's grad tree carried by
    ``params_from_jax``, key by key (fp32)."""
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.training.train_step import make_causal_lm_loss

    model, params, _ = jax_tiny(seed=1)
    rng = np.random.default_rng(9)
    S, cut = 24, np.array([[10], [15]])
    pos = np.arange(S)[None, :]
    mb = dict(
        input_ids=rng.integers(1, HF_TINY["vocab_size"], size=(2, S)).astype(np.int32),
        labels=rng.integers(0, HF_TINY["vocab_size"], size=(2, S)).astype(np.int32),
        segment_ids=(pos >= cut).astype(np.int32),
        position_ids=np.where(pos >= cut, pos - cut, pos).astype(np.int32),
    )
    mb["labels"][:, -1] = -100
    jfn = jax_loss(model, loss="masked_ce")
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}

    def jax_mean(p):
        loss_sum, n = jfn(p, jmb)
        return loss_sum / n, n

    (j_loss, j_n), j_grads = jax.value_and_grad(jax_mean, has_aux=True)(params)
    tmodel = torch_twin(params, attn=attn, trainable=True).model
    t_loss, t_n = make_causal_lm_loss(tmodel, loss="masked_ce")({k: torch.from_numpy(v) for k, v in mb.items()})
    t_loss = t_loss / t_n
    t_loss.backward()
    assert int(t_n) == int(j_n)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    want = params_from_jax(jax.device_get(j_grads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
