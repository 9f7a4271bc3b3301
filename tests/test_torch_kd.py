"""The torch port's knowledge-distillation recipe (automodel_tpu_torch/
recipes/kd.py, ops/losses.kd_loss) against the JAX package on the CPU:
``kd_loss`` and its grad at temperatures 1 and 2 with masked labels; the
recipe's 4-step loss and grad-norm trajectory on the config of
tests/test_kd_and_launcher.py (a 2-layer student, a 3-layer teacher) with
JAX's weights carried by ``params_from_jax``; ``kd llm --device=cpu``
through the CLI; the refusals; the frozen teacher; and a tiny Qwen3-MoE
student whose KD loss carries JAX's aux-loss branch. Inputs are made with
numpy from a seed."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config.loader import ConfigNode as JConfigNode
from automodel_tpu.ops import losses as jl
from automodel_tpu.recipes.kd import KDRecipeForNextTokenPrediction as JaxKD
from automodel_tpu.recipes.kd import make_kd_loss as jax_make_kd_loss
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.config import ConfigNode
from automodel_tpu_torch.ops import losses as tl
from automodel_tpu_torch.recipes.kd import KDRecipeForNextTokenPrediction, make_kd_loss
from torch_port_parity import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KD_TINY_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "kd_tiny_cpu.yaml")

# tests/test_kd_and_launcher.py's config
TINY = {
    "architectures": ["LlamaForCausalLM"],
    "model_type": "llama",
    "vocab_size": 128,
    "hidden_size": 64,
    "intermediate_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "head_dim": 16,
}
FP32 = {"attn": "sdpa", "param_dtype": "float32", "compute_dtype": "float32"}


def _cfg(tmp_path, name: str, **over) -> dict:
    cfg = {
        "seed": 0,
        "model": {"hf_config": TINY, "backend": FP32},
        "teacher_model": {"hf_config": dict(TINY, num_hidden_layers=3), "backend": FP32},
        "kd": {"ratio": 0.5, "temperature": 2.0},
        "dataset": {
            "_target_": "automodel_tpu.data.sft.MockSFTDataset",
            "num_samples": 32,
            "seq_length": 16,
            "vocab_size": 128,
        },
        "dataloader": {"global_batch_size": 8},
        "step_scheduler": {"max_steps": 4},
        "optimizer": {"name": "adamw", "lr": 2e-3},
        "logging": {"metrics_path": str(tmp_path / f"{name}.jsonl")},
    }
    cfg.update(over)
    return cfg


def _rows(path) -> list:
    return [json.loads(s) for s in open(path).read().splitlines() if '"loss"' in s]


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_kd_loss_matches_jax(temperature):
    """The sum, the count and the grad of the student logits, fp32 atol
    1e-5, with masked labels."""
    rng = np.random.default_rng(int(temperature))
    s = (rng.normal(size=(2, 12, 40)) * 3).astype(np.float32)
    t = (rng.normal(size=(2, 12, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 12)).astype(np.int32)
    labels[0, :4] = -100
    labels[1, -2:] = -100
    (j_sum, j_n), j_grad = jax.value_and_grad(
        lambda x: jl.kd_loss(x, jnp.asarray(t), jnp.asarray(labels), temperature), has_aux=True
    )(jnp.asarray(s))
    ts = torch.tensor(s, requires_grad=True)
    t_sum, t_n = tl.build_loss("kd", temperature=temperature)(ts, torch.tensor(t), torch.tensor(labels))
    t_sum.backward()
    assert int(t_n) == int(j_n) == int((labels != -100).sum())
    np.testing.assert_allclose(float(t_sum.detach()), float(j_sum), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(to_np(ts.grad), np.asarray(j_grad), atol=1e-5)


def test_kd_recipe_trajectory_matches_jax(tmp_path):
    """JAX's recipe on the suite's 8 CPU devices (``distributed: {dp_shard:
    -1}``, a section the port refuses past one device) and the port's on
    the CPU, the port's student and teacher holding JAX's weights: the
    same batches give the same 4-step loss and grad norm (rtol 1e-4,
    fp32)."""
    from automodel_tpu_torch.models.llama import params_from_jax

    jrecipe = JaxKD(JConfigNode(_cfg(tmp_path, "jax", distributed={"dp_shard": -1})))
    jrecipe.setup()
    student = params_from_jax(jax.device_get(jrecipe.state.params))
    teacher = params_from_jax(jax.device_get(jrecipe.teacher.params))
    jrecipe.run_train_validation_loop()

    recipe = KDRecipeForNextTokenPrediction(ConfigNode(_cfg(tmp_path, "port", device="cpu")))
    recipe.setup()
    recipe.model.load_state_dict(student)
    recipe.teacher.model.load_state_dict(teacher)
    recipe.run_train_validation_loop()

    jrows, trows = _rows(tmp_path / "jax.jsonl"), _rows(tmp_path / "port.jsonl")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [1, 2, 3, 4]
    for j, t in zip(jrows, trows):
        assert t["num_label_tokens"] == j["num_label_tokens"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4, err_msg=f"step {t['step']}")
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4, err_msg=f"step {t['step']}")


def test_kd_llm_cli_on_cpu_writes_jsonl(tmp_path):
    """``kd llm`` through the CLI on the tiny config (a selective-remat
    student under ``attn: flash``, the kernels' plain versions): 8 finite
    rows, the loss falling."""
    metrics = tmp_path / "m.jsonl"
    rc = app.main(["kd", "llm", "-c", KD_TINY_CFG, "--device=cpu", f"--logging.metrics_path={metrics}"])
    assert rc == 0
    rows = _rows(metrics)
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert all(r["nonfinite"] is False and r["num_label_tokens"] == 2 * 4 * 48 for r in rows)
    assert rows[-1]["loss"] < rows[0]["loss"]


@pytest.mark.parametrize(
    "change,match",
    [
        (dict(teacher_model=None), "requires a `teacher_model:` section"),
        (dict(teacher={"hf_config": TINY}), "`teacher:` section is not read"),
        (dict(kd={"temperature": 2.0, "alpha": 0.5}), "alpha"),
        (dict(peft={"dim": 8}), "peft"),
        (dict(loss_fn={"name": "fused_linear_ce"}), "fused_linear_ce"),
        (dict(teacher_model={"hf_config": dict(TINY, vocab_size=256), "backend": FP32}), "vocab_size 256"),
        (dict(teacher_model={"hf_config": TINY, "backend": FP32, "seed": 3}), "seed"),
    ],
)
def test_kd_refuses_by_name(tmp_path, change, match):
    cfg = _cfg(tmp_path, "r", device="cpu", **change)
    with pytest.raises(ValueError, match=match):
        KDRecipeForNextTokenPrediction(ConfigNode({k: v for k, v in cfg.items() if v is not None})).setup()


def test_teacher_is_frozen_and_absent_from_the_checkpoint_state(tmp_path):
    """The teacher is in eval mode with no parameter requiring grad; after a
    step it holds its weights bit for bit and has no grad; the checkpoint
    tree holds the student's state dict and moments only."""
    recipe = KDRecipeForNextTokenPrediction(ConfigNode(_cfg(tmp_path, "f", device="cpu",
                                                            step_scheduler={"max_steps": 1})))
    recipe.setup()
    teacher = recipe.teacher.model
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    recipe.run_train_validation_loop()
    assert all(p.grad is None for p in teacher.parameters())
    assert all(torch.equal(before[k], v) for k, v in teacher.state_dict().items())
    state = recipe.checkpoint_state()
    assert set(state["model"]) == set(recipe.model.state_dict())
    assert len(recipe.state.params) == len(list(recipe.model.parameters()))
    assert not {id(p) for p in teacher.parameters()} & {id(p) for p in recipe.state.params}
    assert len(state["optim"]["mu"]) == len(list(recipe.model.named_parameters()))


def test_moe_student_carries_the_aux_loss_branch():
    """A tiny Qwen3-MoE student under a tiny Llama teacher: the KD loss sum
    (the blend plus aux x n), the count, the aux loss and the expert counts
    against JAX's ``make_kd_loss`` on the same weights and microbatch."""
    from automodel_tpu.models.common.config import BackendConfig as JaxBackend
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from automodel_tpu.models.common.config import TransformerConfig as JaxTC
    from test_torch_moe_model import HF_MOE_TINY, _pair
    from torch_port_parity import torch_twin

    jstudent, sparams, tstudent = _pair("dense", trainable=True)
    hf_teacher = dict(TINY, vocab_size=HF_MOE_TINY["vocab_size"], num_hidden_layers=3)
    jteacher = JaxLlama(JaxTC.from_hf(hf_teacher), JaxBackend(**FP32))
    tparams = jteacher.init(jax.random.key(7))
    tteacher = torch_twin(tparams, hf=hf_teacher).model
    rng = np.random.default_rng(3)
    mb = dict(input_ids=rng.integers(0, 128, size=(2, 16)).astype(np.int32),
              labels=rng.integers(0, 128, size=(2, 16)).astype(np.int32))
    mb["labels"][:, -3:] = -100
    jfn = jax_make_kd_loss(jstudent, jteacher, tparams, lambda x, *a, **k: x, 0.3, 2.0)
    j_sum, j_n, j_extras = jfn(sparams, {k: jnp.asarray(v) for k, v in mb.items()})
    t_sum, t_n, t_extras = make_kd_loss(tstudent, tteacher, 0.3, 2.0)({k: torch.from_numpy(v) for k, v in mb.items()})
    assert int(t_n) == int(j_n)
    np.testing.assert_allclose(float(t_sum.detach()), float(j_sum), rtol=1e-5)
    np.testing.assert_allclose(float(t_extras["moe_aux_loss"]), float(j_extras["moe_aux_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(t_extras["expert_counts"].numpy(), np.asarray(j_extras["expert_counts"]))
    assert float(t_extras["moe_aux_loss"]) > 0


def test_chip_smoke_distils_the_committed_config():
    """chip_smoke.py carries kd_llama3_8b_to_llama3_2_1b.yaml as a dict (the
    card has no YAML reader); the two must not drift apart. Both models at
    their published widths and depths; the student's head_dim 64, tied
    embeddings and full remat."""
    import importlib.util

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "kd_llama3_8b_to_llama3_2_1b.yaml"))
    assert chip_smoke.KD_LLAMA3_8B_TO_1B == cfg.to_dict()
    teacher = TransformerConfig.from_hf(cfg.teacher_model.hf_config.to_dict())
    student = TransformerConfig.from_hf(cfg.model.hf_config.to_dict())
    assert (teacher.num_layers, teacher.hidden_size, teacher.head_dim) == (32, 4096, 128)
    assert (student.num_layers, student.hidden_size, student.head_dim, student.tie_embeddings) == (16, 2048, 64, True)
    assert student.rope.scaling == "llama3" and student.rope.factor == 32.0
    assert BackendConfig.from_dict(cfg.model.backend.to_dict()).remat == "full"


def test_tied_student_grads_match_jax_key_by_key():
    """A student with tied embeddings (as Llama-3.2-1B): the lm_head's
    grad and the embedding lookup's grad add into the one tensor. The KD
    loss's grads, fp32, against JAX's ``make_kd_loss`` key by key."""
    from automodel_tpu.models.common.config import BackendConfig as JaxBackend
    from automodel_tpu.models.common.config import TransformerConfig as JaxTC
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from automodel_tpu_torch.models.llama import params_from_jax
    from torch_port_parity import torch_twin

    hf_s = dict(TINY, tie_word_embeddings=True)
    hf_t = dict(TINY, num_hidden_layers=3)
    jstudent, jteacher = (JaxLlama(JaxTC.from_hf(h), JaxBackend(**FP32)) for h in (hf_s, hf_t))
    sparams, tparams = jstudent.init(jax.random.key(2)), jteacher.init(jax.random.key(3))
    assert "lm_head" not in sparams
    tstudent = torch_twin(sparams, hf=hf_s, trainable=True).model
    tteacher = torch_twin(tparams, hf=hf_t).model
    rng = np.random.default_rng(5)
    mb = dict(input_ids=rng.integers(0, 128, size=(2, 16)).astype(np.int32),
              labels=rng.integers(0, 128, size=(2, 16)).astype(np.int32))
    mb["labels"][0, :5] = -100
    jfn = jax_make_kd_loss(jstudent, jteacher, tparams, lambda x, *a, **k: x, 0.5, 2.0)
    (j_sum, j_n), j_grads = jax.value_and_grad(
        lambda p: jfn(p, {k: jnp.asarray(v) for k, v in mb.items()}), has_aux=True)(sparams)
    t_sum, t_n = make_kd_loss(tstudent, tteacher, 0.5, 2.0)({k: torch.from_numpy(v) for k, v in mb.items()})
    t_sum.backward()
    assert int(t_n) == int(j_n)
    np.testing.assert_allclose(float(t_sum.detach()), float(j_sum), rtol=1e-5)
    want = params_from_jax(jax.device_get(j_grads))
    got = dict(tstudent.named_parameters())
    assert set(got) == set(want) and "lm_head.weight" not in got
    for name, p in got.items():
        np.testing.assert_allclose(to_np(p.grad), want[name].numpy(), atol=1e-5, err_msg=name)


def test_kd_loss_passes_through_the_train_step_and_its_skip_policy(tmp_path):
    """``build_train_step`` over the KD loss (which closes over the frozen
    teacher): the grads are the student's parameters' alone, and under
    ``on_nonfinite: skip`` a poisoned step leaves the student, its moments
    and the teacher bit-identical."""
    from automodel_tpu_torch.data.collators import stack_microbatches
    from automodel_tpu_torch.training.train_step import build_train_step

    recipe = KDRecipeForNextTokenPrediction(ConfigNode(_cfg(
        tmp_path, "s", device="cpu", fault_tolerance={"on_nonfinite": "skip"})))
    recipe.setup()
    poison = {"on": False}

    def loss_fn(mb):
        loss_sum, n = recipe.loss_fn(mb)
        return (loss_sum * float("nan") if poison["on"] else loss_sum), n

    step = build_train_step(loss_fn, on_nonfinite="skip")
    batches = iter(recipe.dataloader)
    first = step(recipe.state, recipe._place(stack_microbatches([next(batches)])))
    assert first["skipped"] is False and not bool(first["nonfinite"])
    opt = recipe.state.optimizer
    teacher = list(recipe.teacher.model.parameters())
    before = [t.clone() for t in recipe.state.params + opt.mu + opt.nu + teacher]
    poison["on"] = True
    m = step(recipe.state, recipe._place(stack_microbatches([next(batches)])))
    assert m["skipped"] is True and bool(m["nonfinite"])
    after = recipe.state.params + opt.mu + opt.nu + teacher
    assert all(torch.equal(a, b) for a, b in zip(before, after)) and opt.count == 1
