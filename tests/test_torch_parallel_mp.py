"""The port's parallel training on several gloo processes on the CPU.

``torchrun --standalone --nproc_per_node 2 -m automodel_tpu_torch.cli.app
finetune llm`` on ``configs/parallel_tiny_cpu.yaml`` (a 2-layer Llama,
fp32, weights from a local HF directory holding the JAX package's init)
at ``dp_shard = 2`` (FSDP2), ``tp = 2`` with ``vocab_parallel_ce`` (DTensor
tensor parallelism) and ``cp = 2`` with the zigzag ring; each run's
per-step loss and grad norm are held to one process of the port and to the
JAX package's recipe on the suite's virtual CPU devices, and its weights
after the 3 steps (the consolidated ``hf/`` export, gathered on rank 0) to
the one-process run's. A ``dp_shard = 2`` checkpoint restores in one
process bit for bit; greedy ``generate`` under ``tp = 2`` gives one
process's tokens; HSDP on 4 processes (``dp_replicate = 2``) gives FSDP's
(``slow``: 4 processes twice).

Tolerance: fp32, the same arithmetic in another order (gradient sums
split across ranks, the ring's blockwise softmax): losses and grad norms
2e-5 relative; weights after 3 AdamW steps at lr 3e-3 within 1e-4 of the
tensor's norm, and no element a third of one step (1e-3) apart. Adam
divides by sqrt(v), so where a gradient is near zero a last-bit difference
in it moves that element's update by a fraction of the learning rate: one
element in 8,192 was 1.5e-4 apart under cp = 2 (1.8e-5 of its tensor's
norm), the rest within 1e-6.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_port_parity import jax_tiny, torch_twin

REPO = Path(__file__).resolve().parents[1]
CFG = REPO / "automodel_tpu_torch" / "configs" / "parallel_tiny_cpu.yaml"
RUN_TIMEOUT_S = 240
TOL = dict(rtol=2e-5, atol=0)


def _base() -> dict:
    from automodel_tpu_torch.config.loader import load_yaml_config

    return load_yaml_config(CFG).to_dict()


def _torchrun(nproc: int, cfg: dict, where: Path, *command: str) -> subprocess.CompletedProcess:
    where.mkdir(parents=True, exist_ok=True)
    path = where / "cfg.json"
    path.write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}", "-m",
           "automodel_tpu_torch.cli.app", *command, "-c", str(path)]
    out = subprocess.run(cmd, cwd=str(where), env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return out


def _steps(path: Path) -> list:
    return [(r["loss"], r["grad_norm"]) for r in map(json.loads, open(path)) if "loss" in r]


def _close_weights(got: torch.Tensor, want: torch.Tensor, name: str) -> None:
    a, b = got.double().numpy(), want.double().numpy()
    assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), name
    assert np.abs(a - b).max() <= 1e-3, name


def _hf_weights(d: Path) -> dict:
    from automodel_tpu_torch.checkpoint.hf_io import HFCheckpointReader

    rd = HFCheckpointReader(d)
    return {k: rd.get_tensor(k) for k in rd.keys()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The HF dir of the JAX init, JAX's recipe and one port process on it."""
    from automodel_tpu.config.loader import ConfigNode as JConfigNode
    from automodel_tpu.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction as JRecipe
    from automodel_tpu_torch.checkpoint.addons import write_hf_addons
    from automodel_tpu_torch.checkpoint.hf_io import save_hf_checkpoint
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    root = tmp_path_factory.mktemp("parallel")
    base = _base()
    hf = base["model"]["hf_config"]
    _, params, _ = jax_tiny(seed=0, hf=hf)
    auto = torch_twin(params, hf=hf)
    save_hf_checkpoint(root / "init", auto.adapter.to_hf(auto.model.state_dict()))
    write_hf_addons(root / "init", hf_config=hf)
    base["model"] = dict(pretrained_model_name_or_path=str(root / "init"),
                         backend=dict(base["model"]["backend"], attn="sdpa", cp_zigzag=False))
    base["dataloader"]["global_batch_size"] = 8
    base["dataset"]["_target_"] = "automodel_tpu.data.sft.MockSFTDataset"  # both packages resolve it

    jcfg = dict(base, distributed=dict(dp_shard=-1), logging=dict(metrics_path=str(root / "jax.jsonl")))
    jcfg.pop("device")
    jrecipe = JRecipe(JConfigNode(jcfg))
    jrecipe.setup()
    jrecipe.run_train_validation_loop()

    one = dict(base, logging=dict(metrics_path=str(root / "one.jsonl")))
    one.pop("distributed")
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(one))
    recipe.setup()
    recipe.run_train_validation_loop()
    weights = {k: v.detach().clone() for k, v in recipe.model.state_dict().items()}
    return dict(root=root, base=base, jax=_steps(root / "jax.jsonl"), one=_steps(root / "one.jsonl"),
                weights=weights)


def _run_parallel(ref, tag: str, distributed: dict, backend: dict, loss: str = "fused_linear_ce") -> dict:
    where = ref["root"] / tag
    cfg = json.loads(json.dumps(ref["base"]))
    cfg.update(distributed=distributed, loss_fn=dict(name=loss), logging=dict(metrics_path=str(where / "m.jsonl")))
    cfg["model"]["backend"].update(backend)
    cfg["checkpoint"] = dict(enabled=True, checkpoint_dir=str(where / "ckpt"), save_consolidated=True)
    cfg["step_scheduler"]["ckpt_every_steps"] = 3
    _torchrun(2, cfg, where, "finetune", "llm")
    steps = _steps(where / "m.jsonl")
    np.testing.assert_allclose(steps, ref["one"], **TOL)
    np.testing.assert_allclose(steps, ref["jax"], **TOL)
    got = _hf_weights(where / "ckpt" / "epoch_0_step_3" / "hf")
    assert set(got) == set(ref["weights"])
    for k, w in ref["weights"].items():
        _close_weights(got[k], w, k)
    return dict(cfg=cfg, where=where)


@pytest.fixture(scope="module")
def fsdp_run(ref):
    return _run_parallel(ref, "dp2", dict(dp_shard=2), dict(attn="flash"))


def test_one_process_port_matches_jax(ref):
    np.testing.assert_allclose(ref["one"], ref["jax"], **TOL)
    assert len(ref["one"]) == 3


def test_dp_shard2_fsdp_matches_one_process_and_jax(fsdp_run):
    state = fsdp_run["where"] / "ckpt" / "epoch_0_step_3" / "state"
    assert (state / ".metadata").exists() and len(list(state.glob("*.distcp"))) == 2  # each rank wrote its shards


def test_tp2_vocab_parallel_matches_one_process_and_jax(ref):
    _run_parallel(ref, "tp2", dict(tp=2), dict(attn="flash"), loss="vocab_parallel_ce")


def test_cp2_zigzag_ring_matches_one_process_and_jax(ref):
    _run_parallel(ref, "cp2", dict(cp=2), dict(attn="ring", cp_zigzag=True))


def test_dp_shard2_checkpoint_restores_in_one_process_bit_for_bit(fsdp_run, tmp_path):
    """The DCP state two ranks wrote (FSDP2 shards of the weights and of
    Adam's moments) restores into one process: the weights equal the
    consolidated export bit for bit, and the moments, step and count are
    the saved ones."""
    import torch.distributed.checkpoint as dcp

    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = json.loads(json.dumps(fsdp_run["cfg"]))
    cfg.pop("distributed")
    cfg["logging"] = dict(metrics_path=str(tmp_path / "r.jsonl"))
    cfg["checkpoint"] = dict(enabled=True, checkpoint_dir=str(fsdp_run["where"] / "ckpt"))
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    assert recipe.state.step == 3 and recipe.state.optimizer.count == 3
    sd = recipe.model.state_dict()
    for k, w in _hf_weights(fsdp_run["where"] / "ckpt" / "epoch_0_step_3" / "hf").items():
        assert torch.equal(sd[k], w), k
    names = [n for n, _ in recipe.model.named_parameters()]
    blank = {"optim": {"mu": {n: torch.zeros_like(t) for n, t in zip(names, recipe.state.optimizer.mu)}}}
    dcp.load(blank, checkpoint_id=str(fsdp_run["where"] / "ckpt" / "epoch_0_step_3" / "state"), no_dist=True)
    for n, t in zip(names, recipe.state.optimizer.mu):
        assert torch.equal(blank["optim"]["mu"][n], t) and bool(t.abs().sum() > 0), n


def test_generate_tp2_greedy_tokens_equal_one_process(ref):
    from automodel_tpu_torch.cli import app

    cfg = json.loads(json.dumps(ref["base"]))
    cfg.update(distributed=dict(tp=2), generation=dict(max_new_tokens=6, greedy=True, prompt_ids=[[1, 2, 3, 4], [9, 8]]))
    out = _torchrun(2, cfg, ref["root"] / "gen", "generate")
    lines = [s for s in out.stdout.splitlines() if s.startswith("completion:")]
    one = dict(cfg)
    one.pop("distributed")
    (ref["root"] / "gen1").mkdir()
    path = ref["root"] / "gen1" / "cfg.json"
    path.write_text(json.dumps(one))
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert app.main(["generate", "-c", str(path)]) == 0
    want = [s for s in buf.getvalue().splitlines() if s.startswith("completion:")]
    assert lines == want and len(want) == 2 and len(want[0].split()) == 7


@pytest.mark.slow
def test_hsdp_matches_fsdp_on_four_processes(ref):
    """After test_hsdp_grads_parity_vs_pure_fsdp: HSDP (dp_replicate 2 x
    dp_shard 2) and FSDP (dp_shard 4) give the same steps and weights."""
    runs = []
    for tag, dist in (("hsdp", dict(dp_replicate=2, dp_shard=2)), ("fsdp4", dict(dp_shard=4))):
        where = ref["root"] / tag
        cfg = json.loads(json.dumps(ref["base"]))
        cfg.update(distributed=dist, logging=dict(metrics_path=str(where / "m.jsonl")))
        cfg["checkpoint"] = dict(enabled=True, checkpoint_dir=str(where / "ckpt"), save_consolidated=True)
        cfg["step_scheduler"]["ckpt_every_steps"] = 3
        _torchrun(4, cfg, where, "finetune", "llm")
        runs.append((_steps(where / "m.jsonl"), _hf_weights(where / "ckpt" / "epoch_0_step_3" / "hf")))
    np.testing.assert_allclose(runs[0][0], runs[1][0], **TOL)
    np.testing.assert_allclose(runs[0][0], ref["one"], **TOL)
    for k in runs[0][1]:
        _close_weights(runs[0][1][k], runs[1][1][k], k)
