"""The rest of the port's optimizers (``automodel_tpu_torch/optim/
builders.py``) against the optax chains JAX's ``build_optimizer`` builds:
``moments_dtype: param``, lion, sgd, adafactor and muon.

Two levels. The update rule alone, on a param tree with the JAX layout the
layout-reading optimizers care about: an embedding ``[256, 128]``, an
untied lm_head (``[128, 256]`` in JAX, transposed in the port), a final
norm, a stacked non-square layer kernel ``[2, 128, 192]`` and a stacked
norm ``[2, 128]``; widths past 128 so adafactor factors its second
moments, and muon's 2-D leaves (embedding, lm_head, the stacked norm)
against its 3-D one (Adam's branch). Then the recipe: 4 steps of the
tiny Llama through the port's recipe (its optimizer built from the
``optimizer:`` section with the parameters' names) against JAX's train
step with JAX's optimizer on the same batches: loss and grad norm per
step, and the parameters after step 4. fp32 atol 1e-5 unless stated;
the bf16 case states its own."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automodel_tpu.optim.builders import build_optimizer as jax_optimizer
from automodel_tpu_torch.optim.builders import build_optimizer, jax_leaves
from torch_port_parity import CPU, HF_TINY

L, V, H, Q = 2, 256, 128, 192
NAMES = (
    ["model.embed_tokens.weight", "lm_head.weight", "model.norm.weight"]
    + [f"model.layers.{i}.self_attn.q_proj.weight" for i in range(L)]
    + [f"model.layers.{i}.input_layernorm.weight" for i in range(L)]
)

CASES = {
    "adamw_param_moments": dict(name="adamw", moments_dtype="param", weight_decay=0.01, betas=(0.9, 0.95)),
    "adam_param_moments": dict(name="adam", moments_dtype="param", betas=(0.9, 0.95)),
    "lion": dict(name="lion", weight_decay=0.1, betas=(0.9, 0.99)),
    "sgd": dict(name="sgd", betas=(0.9, 0.999)),
    "adafactor": dict(name="adafactor"),
    "adafactor_decay": dict(name="adafactor", weight_decay=0.01),
    "muon": dict(name="muon", weight_decay=0.01, betas=(0.9, 0.95)),
}


def _tree(rng, scale=1.0):
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {
        "embed": {"embedding": f(V, H)},
        "lm_head": {"kernel": f(H, V)},
        "final_norm": {"scale": 1.0 + f(H)},
        "layers": {"attn": {"q_proj": {"kernel": f(L, H, Q)}}, "input_norm": {"scale": 1.0 + f(L, H)}},
    }


def _port(tree):
    """The JAX tree as the port's tensors, in NAMES order."""
    lay = tree["layers"]
    out = [tree["embed"]["embedding"], tree["lm_head"]["kernel"].T, tree["final_norm"]["scale"]]
    out += [lay["attn"]["q_proj"]["kernel"][i].T for i in range(L)]
    out += [lay["input_norm"]["scale"][i] for i in range(L)]
    return [torch.from_numpy(np.array(x, copy=True)) for x in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_rule_matches_optax(case):
    kw = dict(lr=1e-2, grad_clip_norm=1.0, lr_schedule=dict(style="cosine", warmup_steps=1, decay_steps=4),
              **CASES[case])
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.05)
    jopt = jax_optimizer(**kw)
    jstate = jopt.init(params)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = _port(params)
    topt = build_optimizer(tparams, names=NAMES, **kw)
    for step in range(3):
        grads = _tree(rng, 0.5 if step else 2.0)  # step 1 clips
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.update(_port(grads))
        want = _port(jax.device_get(jparams))
        for name, got, w in zip(NAMES, tparams, want):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"{case} step {step} {name}")
    assert topt.count == 3


@pytest.mark.parametrize(
    "kw",
    [dict(name="adamw", moments_dtype="param", weight_decay=0.01), dict(name="lion", weight_decay=0.01),
     dict(name="sgd")],
    ids=lambda kw: kw["name"],
)
@pytest.mark.parametrize("clip", [None, 1.0])
def test_bf16_update_rule_is_bit_identical_to_optax(kw, clip):
    """bf16 params, bf16 grads and param-dtype state (the full-depth
    path): 4 steps on a 256x256 param from the same grads leave the same
    bf16 bit patterns as optax, every element."""
    rng = np.random.default_rng(0)
    p0 = (rng.normal(size=(256, 256)) * 0.05).astype(np.float32)
    kw = dict(lr=1e-2, grad_clip_norm=clip, **kw)
    jopt = jax_optimizer(**kw)
    jp = [jnp.asarray(p0, dtype=jnp.bfloat16)]
    jstate = jopt.init(jp)
    tp = [torch.tensor(p0).to(torch.bfloat16)]
    topt = build_optimizer(tp, **kw)
    for _ in range(4):
        g = (rng.normal(size=(256, 256)) * 0.01).astype(np.float32)
        upd, jstate = jopt.update([jnp.asarray(g, dtype=jnp.bfloat16)], jstate, jp)
        jp = [x.astype(jnp.bfloat16) for x in optax.apply_updates(jp, upd)]
        topt.update([torch.tensor(g).to(torch.bfloat16)])
        np.testing.assert_array_equal(tp[0].view(torch.int16).numpy(), np.asarray(jp[0]).view(np.int16))
    state = topt.state_lists()
    assert all(t.dtype == torch.bfloat16 for ts in state.values() for t in ts)


def test_jax_leaves_and_muon_labels():
    leaves = {lf.path: lf for lf in jax_leaves(NAMES)}
    assert set(leaves) == {"embed/embedding", "lm_head/kernel", "final_norm/scale", "layers/attn/q_proj/kernel",
                           "layers/input_norm/scale"}
    tensors = _port(_tree(np.random.default_rng(1)))
    q = leaves["layers/attn/q_proj/kernel"]
    assert q.stacked and q.transposed and tuple(q.gather(tensors).shape) == (L, H, Q)
    assert [torch.equal(a, b) for a, b in zip(q.split(q.gather(tensors)), [tensors[i] for i in q.index])] == [True] * L
    opt = build_optimizer(tensors, name="muon", names=NAMES)
    assert opt.muon_leaves == {"embed/embedding", "lm_head/kernel", "layers/input_norm/scale"}
    with pytest.raises(ValueError, match="names"):
        build_optimizer(tensors, name="adafactor")
    moe_names = NAMES[:-1] + ["model.layers.0.mlp.experts.gate_up"]
    with pytest.raises(ValueError, match="layout is not mapped"):
        build_optimizer(tensors, name="muon", names=moe_names)  # the dense families' map
    # the MoE families' map places the expert slab on its stacked leaf
    from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import moe_jax_leaf_of

    slab = {lf.path: lf for lf in jax_leaves(moe_names, moe_jax_leaf_of)}["moe_layers/moe/experts/gate_up"]
    assert slab.stacked and not slab.transposed and slab.index == (len(NAMES) - 1,)
    with pytest.raises(ValueError, match="moments_dtype"):
        build_optimizer(tensors, moments_dtype="bf16")
    with pytest.raises(ValueError, match="Unknown optimizer"):
        build_optimizer(tensors, name="rmsprop")


def test_top_level_schedule_keys_and_string_lr():
    p = [torch.zeros(3)]
    a = build_optimizer(p, lr="1e-2", style="cosine", warmup_steps=2, decay_steps=8)
    b = build_optimizer(p, lr=1e-2, lr_schedule=dict(style="cosine", warmup_steps=2, decay_steps=8))
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule

    jax_optimizer(lr="1e-2", style="cosine", warmup_steps=2, decay_steps=8)  # JAX takes the same section

    js = jax_schedule(lr=1e-2, style="cosine", warmup_steps=2, decay_steps=8)
    assert [a.schedule(i) for i in range(10)] == [b.schedule(i) for i in range(10)]
    np.testing.assert_allclose([a.schedule(i) for i in range(10)], [float(js(i)) for i in range(10)], rtol=1e-5)


def _batches(n_steps, accum, seed=11):
    from automodel_tpu_torch.data.collators import default_collater, stack_microbatches
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(vocab_size=HF_TINY["vocab_size"], seq_length=16, num_samples=64, seed=seed)
    out = []
    for s in range(n_steps):
        group = [default_collater([ds[(s * accum + a) * 2 + i] for i in range(2)]) for a in range(accum)]
        out.append({k: v for k, v in stack_microbatches(group).items() if isinstance(v, np.ndarray)})
    return out


RECIPE_CASES = {
    "adamw_param_moments_bf16": dict(name="adamw", moments_dtype="param"),
    "lion": dict(name="lion"),
    "sgd": dict(name="sgd", lr=5e-2),
    "adafactor": dict(name="adafactor"),
    "muon": dict(name="muon"),
}


@pytest.mark.parametrize("case", sorted(RECIPE_CASES))
def test_recipe_trajectory_matches_jax(case, tmp_path):
    """4 steps of the port's recipe step (fused_linear_ce, clip 1.0, cosine
    warmup, weight decay 0.01, grad_acc 2; the bf16 case one microbatch, so
    its optimizer gets bf16 grads and keeps bf16 moments) against JAX's
    train step with JAX's optimizer: loss and grad norm per step to rtol
    1e-4 and the final params to atol 1e-5. The bf16 case holds loss and
    grad norm to rtol 5e-3, as ``test_torch_optim_bf16.py`` states for the
    bf16 path: the frameworks round the bf16 forward and backward at
    different places, and Adam's near-sign updates carry those grad
    differences into a few params by more than a bf16 step, so its params
    are held by the update rule on equal grads
    (``test_bf16_update_rule_is_bit_identical_to_optax``), not here."""
    from automodel_tpu.models.common.config import BackendConfig as JaxBackend
    from automodel_tpu.models.common.config import TransformerConfig as JaxConfig
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
    from automodel_tpu.training.train_state import TrainState as JaxState
    from automodel_tpu.training.train_step import build_train_step as jax_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    bf16 = case.endswith("bf16")
    dtype = "bfloat16" if bf16 else "float32"
    backend = dict(attn="sdpa", param_dtype=dtype, compute_dtype=dtype)
    opt = dict(dict(lr=1e-3, weight_decay=0.01, betas=[0.9, 0.95], grad_clip_norm=1.0,
                    lr_schedule=dict(style="cosine", warmup_steps=2, decay_steps=8)), **RECIPE_CASES[case])
    model = JaxLlama(JaxConfig.from_hf(HF_TINY), JaxBackend(**backend))
    params = model.init(jax.random.key(0))
    jopt = jax_optimizer(**opt)
    jstate = JaxState.create(params, jax.jit(jopt.init)(params))
    jfn = jax_step(jax_loss(model, loss="fused_linear_ce"), jopt, jax_schedule(lr=opt["lr"], **opt["lr_schedule"]),
                   donate=False)

    cfg = dict(
        seed=0, device="cpu", model=dict(hf_config=HF_TINY, backend=backend),
        dataset=dict(_target_="automodel_tpu.data.sft.MockSFTDataset", vocab_size=128, seq_length=16, num_samples=8),
        dataloader=dict(global_batch_size=2), optimizer=opt, loss_fn=dict(name="fused_linear_ce"),
        logging=dict(metrics_path=str(tmp_path / "m.jsonl")),
    )
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    recipe.model.load_state_dict(params_from_jax(jax.device_get(params)))
    rtol = 5e-3 if bf16 else 1e-4
    for i, batch in enumerate(_batches(4, accum=1 if bf16 else 2)):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = recipe.train_step(recipe.state, {k: torch.from_numpy(v).to(CPU) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=rtol, err_msg=f"{case} step {i + 1}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=rtol,
                                   err_msg=f"{case} step {i + 1}")
    want = params_from_jax(jax.device_get(jstate.params))
    got = recipe.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        if bf16:
            assert got[k].dtype == torch.bfloat16 and torch.isfinite(got[k]).all()
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=f"{case} {k}")
    if bf16:
        opt = recipe.state.optimizer
        assert all(m.dtype == torch.bfloat16 for m in opt.mu + opt.nu) and opt.count == 4


def test_chip_smoke_trains_the_committed_full_depth_config():
    """chip_smoke.py carries sft_llama3_8b_full.yaml as a dict (the card has
    no YAML reader); the two must not drift apart, and the full config is
    the 8-layer one at 32 layers with bf16 moments and remat."""
    import importlib.util
    import os

    from automodel_tpu_torch.config.loader import load_yaml_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    configs = os.path.join(repo, "automodel_tpu_torch", "configs")
    full = load_yaml_config(os.path.join(configs, "sft_llama3_8b_full.yaml")).to_dict()
    assert chip_smoke.SFT_LLAMA3_8B_FULL == full
    cut = load_yaml_config(os.path.join(configs, "sft_llama3_8b.yaml")).to_dict()
    assert full["model"]["hf_config"] == dict(cut["model"]["hf_config"], num_hidden_layers=32)
    assert full["model"]["backend"] == dict(cut["model"]["backend"], remat="full")
    assert full["optimizer"] == dict(cut["optimizer"], moments_dtype="param")


def test_tiny_full_config_trains_on_cpu_with_bf16_moments(tmp_path):
    """The CPU twin of the full-depth config (bf16 weights, one microbatch,
    bf16 moments, remat full) through the finetune CLI: 8 finite steps and
    a JSONL that report --strict accepts."""
    import json
    import os

    from automodel_tpu_torch.cli import app

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = os.path.join(repo, "automodel_tpu_torch", "configs", "sft_tiny_cpu_full.yaml")
    path = tmp_path / "m.jsonl"
    assert app.main(["finetune", "llm", "-c", cfg, "--device=cpu", f"--logging.metrics_path={path}"]) == 0
    rows = [r for r in map(json.loads, path.read_text().splitlines()) if "event" not in r]
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert all(np.isfinite(r["loss"]) and not r["nonfinite"] for r in rows)
    assert app.main(["report", str(path), "--strict"]) == 0
