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

import jax
import jax.numpy as jnp
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


# -- the MoE families on two gloo processes: tp, expert_fsdp, the aux loss,
# adafactor and muon on a mesh; every case in one torchrun of
# tests/torch_mp_moe_child.py
#
# Tolerance: fp32, the same arithmetic summed in another order (the tp
# partials, the ranks' halves of the batch): the loss and the aux loss
# within 2e-5 relative, every gradient within 1e-4 of its tensor's largest
# element; the weights after two adafactor or muon steps against one
# process (which test_torch_optim_moe.py holds to optax) as the dense runs'
# above: within 1e-4 of the tensor's norm, no element a third of a step
# (lr / 3) apart (muon's Adam branch divides by sqrt(v), so a last-bit
# difference in a near-zero gradient moves that element by part of a step).

MOE_BACKENDS = ("dense", "ragged", "ragged_fused", "gspmd", "a2a", "a2a_fused")
MOE_MESHES = {"tp2": dict(tp=2, dp_shard=1), "efsdp2": dict(dp_shard=2)}
AUX_COEF = 0.5  # large, so a wrong aux weighting shows past the tolerance


def _moe_families() -> dict:
    from tests.test_torch_deepseek_v3 import HF_DSV3_TINY
    from tests.test_torch_gpt_oss import HF_GPT_OSS_TINY
    from tests.test_torch_moe_families import FAMILIES

    qwen3 = dict(FAMILIES["mixtral"], architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe",
                 num_experts=8, moe_intermediate_size=32, num_local_experts=None, norm_topk_prob=True)
    fams = dict(qwen3_moe=qwen3, deepseek_v3=HF_DSV3_TINY, gpt_oss=HF_GPT_OSS_TINY, **FAMILIES)
    return {k: dict(v, router_aux_loss_coef=AUX_COEF) for k, v in fams.items()}


def _moe_batch(vocab: int, seed: int = 5) -> dict:
    """4 rows of 32 tokens; the last two rows (rank 1's half under
    dp_shard = 2) half padding, so the ranks' label counts differ."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(4, 32)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[2:, 16:] = -100
    return dict(input_ids=ids, labels=labels)


def _rel_close(got, want, rel: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30), (what, np.abs(got - want).max())


@pytest.fixture(scope="module")
def moe_mp(tmp_path_factory):
    """JAX's and one process's loss and grads for each family, then every
    MoE case on two gloo processes in one torchrun."""
    from automodel_tpu.models.common.config import BackendConfig as JaxBackend
    from automodel_tpu.models.registry import resolve_architecture as jax_resolve
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.auto_model import from_config
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss
    from tests.test_torch_moe_families import _randomize
    from tests.test_torch_optim_moe import FAMILIES as WIDE, _carry

    root = tmp_path_factory.mktemp("moe_mp")
    fp32 = dict(param_dtype="float32", compute_dtype="float32", attn="sdpa")
    plan, ref = [], dict(jax={}, one={}, steps={})

    def port(hf, experts, weights):
        m = from_config(hf, dict(fp32, experts=experts), device="cpu", trainable=True).model
        m.load_state_dict(weights)
        return m

    for family, hf in _moe_families().items():
        jmodel, _ = jax_resolve(hf)(hf, JaxBackend(experts="ragged", **fp32))
        params = _randomize(jmodel.init(jax.random.key(0)), 100)
        batch = _moe_batch(hf["vocab_size"])
        np.savez(root / f"{family}_batch.npz", **batch)
        weights = _carry(family)(jax.device_get(params))
        torch.save(weights, root / f"{family}.pt")
        jfn = jax_loss(jmodel, "fused_linear_ce")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def jobj(p):
            loss_sum, n, extras = jfn(p, jb)
            return loss_sum / n, (extras["moe_aux_loss"], n)

        (jl, (jaux, jn)), jg = jax.jit(jax.value_and_grad(jobj, has_aux=True))(params)
        ref["jax"][family] = dict(loss=float(jl), aux=float(jaux), grads=_carry(family)(jax.device_get(jg)))
        for experts in ("ragged", "gspmd"):
            m = port(hf, experts, weights)
            mb = {k: torch.from_numpy(v) for k, v in batch.items()}
            loss_sum, n, extras = make_causal_lm_loss(m, "fused_linear_ce")(mb)
            loss_sum.backward()
            ref["one"][(family, experts)] = dict(
                loss=float(loss_sum.detach() / n), aux=float(extras["moe_aux_loss"]),
                grads={k: p.grad / n for k, p in m.named_parameters()})
        for mesh, degrees in MOE_MESHES.items():
            for experts in MOE_BACKENDS:
                plan.append(dict(name=f"{family}-{mesh}-{experts}", kind="grads", hf=hf, experts=experts,
                                 weights=str(root / f"{family}.pt"), batch=str(root / f"{family}_batch.npz"),
                                 mesh=degrees))
        if family == "qwen3_moe":
            # cp = 2: each row's tokens split over the two ranks (zigzag ring)
            for experts in ("ragged", "a2a_fused"):
                plan.append(dict(name=f"{family}-cp2-{experts}", kind="grads", hf=hf, experts=experts,
                                 weights=str(root / f"{family}.pt"), batch=str(root / f"{family}_batch.npz"),
                                 mesh=dict(cp=2, dp_shard=1)))
    for family in ("deepseek_v3", "gpt_oss"):
        hf = WIDE[family]
        jmodel, _ = jax_resolve(hf)(hf, JaxBackend(experts="ragged", **fp32))
        weights = _carry(family)(jax.device_get(_randomize(jmodel.init(jax.random.key(1)), 101)))
        torch.save(weights, root / f"{family}_wide.pt")
        batch = _moe_batch(hf["vocab_size"], seed=6)
        np.savez(root / f"{family}_wide_batch.npz", **batch)
        for name, okw in (("adafactor", dict(name="adafactor", lr=1e-2)),
                          ("muon", dict(name="muon", lr=1e-2, weight_decay=0.01, betas=[0.9, 0.95]))):
            m = port(hf, "a2a_fused", weights)
            named = list(m.named_parameters())
            opt = build_optimizer([p for _, p in named], names=[n for n, _ in named], leaf_of=m.jax_leaf_of, **okw)
            state = TrainState(params=[p for _, p in named], optimizer=opt)
            step = build_train_step(make_causal_lm_loss(m, "fused_linear_ce"))
            mb = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
            losses = [float(step(state, mb)["loss"]) for _ in range(2)]
            optim = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                     for k, v in opt.state_tree([n for n, _ in named]).items()}
            ref["steps"][(family, name)] = dict(losses=losses, params={n: p.detach().clone() for n, p in named},
                                                optim=optim)
            for mesh, degrees in MOE_MESHES.items():
                case = f"{family}-{mesh}-{name}"
                plan.append(dict(name=case, kind="steps", hf=hf, experts="a2a_fused",
                                 weights=str(root / f"{family}_wide.pt"), batch=str(root / f"{family}_wide_batch.npz"),
                                 mesh=degrees, optimizer=okw, optim_dir=str(root / f"{case}_optim")))
    # the token-level aux loss (no seq_len): global means over both ranks
    gcfg = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=8, norm_topk_prob=True,
                aux_loss_coeff=0.1)
    rng = np.random.default_rng(7)
    np.savez(root / "gate.npz", x=rng.normal(size=(12, 16)).astype(np.float32),
             router=(rng.normal(size=(8, 16)) * 0.5).astype(np.float32))
    plan.append(dict(name="gate-token-level", kind="gate", batch=str(root / "gate.npz"), mesh=dict(dp_shard=2),
                     gate=dict(cfg=gcfg)))
    (root / "plan.json").write_text(json.dumps(plan))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           str(REPO / "tests" / "torch_mp_moe_child.py"), str(root / "plan.json"), str(root)]
    out = subprocess.run(cmd, cwd=str(root), env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    got = {case["name"]: torch.load(root / f"{case['name']}.pt") for case in plan}
    return dict(ref=ref, got=got, gate_cfg=gcfg, gate_inputs=dict(np.load(root / "gate.npz")), root=root)


def _check_grads(got: dict, want: dict, what: str) -> None:
    _rel_close(got["loss"], want["loss"], 2e-5, f"{what} loss")
    _rel_close(got["aux"], want["aux"], 2e-5, f"{what} aux")
    for k, g in got["grads"].items():  # the parameters (JAX's tree also has the aux-free bias)
        _rel_close(g.numpy(), want["grads"][k].numpy(), 1e-4, f"{what} {k}")


def test_moe_aux_loss_is_global_under_dp_shard2(moe_mp):
    """dp_shard = 2 with the aux loss on (coefficient 0.5) and the ranks'
    label counts unequal (rank 1's rows half padding): the loss, the aux
    loss and the router's grads are JAX's global ones, and one
    process's. Each rank adds n_global / rows_global x its sequences' aux."""
    got = moe_mp["got"]["qwen3_moe-efsdp2-ragged"]
    for want in (moe_mp["ref"]["one"][("qwen3_moe", "ragged")], moe_mp["ref"]["jax"]["qwen3_moe"]):
        _check_grads(got, want, "qwen3_moe dp_shard=2")
    router = [k for k in got["grads"] if k.endswith("mlp.gate.weight")]
    assert router and all(float(got["grads"][k].abs().max()) > 0 for k in router)


@pytest.mark.parametrize("experts", ["ragged", "a2a_fused"])
def test_moe_aux_loss_is_global_under_cp2(moe_mp, experts):
    """cp = 2 (each row's tokens on both ranks, the zigzag ring) with the
    aux loss on: the sequence-level aux loss takes each row's expert
    counts over its cp ranks, so the loss, the aux loss and every grad
    are JAX's whole-sequence ones, and one process's."""
    got = moe_mp["got"][f"qwen3_moe-cp2-{experts}"]
    for want in (moe_mp["ref"]["one"][("qwen3_moe", "ragged")], moe_mp["ref"]["jax"]["qwen3_moe"]):
        _check_grads(got, want, f"qwen3_moe cp=2 {experts}")


@pytest.mark.parametrize("family", ["qwen3_moe", "mixtral", "qwen2_moe", "glm4_moe", "deepseek_v3", "gpt_oss"])
@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
def test_moe_family_on_two_processes_matches_one_process_and_jax(moe_mp, family, mesh):
    """tp = 2 (the slabs' I-shards, the shared experts and the attention
    under DTensor TP) or expert_fsdp = 2 (the slabs inside FSDP2), through
    every experts backend: the loss, aux loss and every grad equal one
    process's and JAX's (gspmd, whose capacity may drop picks, one
    process's gspmd)."""
    for experts in MOE_BACKENDS:
        got = moe_mp["got"][f"{family}-{mesh}-{experts}"]
        if experts == "gspmd":
            _check_grads(got, moe_mp["ref"]["one"][(family, "gspmd")], f"{family} {mesh} gspmd")
        else:
            _check_grads(got, moe_mp["ref"]["one"][(family, "ragged")], f"{family} {mesh} {experts}")
            _check_grads(got, moe_mp["ref"]["jax"][family], f"{family} {mesh} {experts} against JAX")


@pytest.mark.parametrize("optimizer", ["adafactor", "muon"])
@pytest.mark.parametrize("family", ["deepseek_v3", "gpt_oss"])
@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
def test_adafactor_and_muon_on_a_mesh_match_one_process(moe_mp, family, optimizer, mesh):
    """Two steps of adafactor or muon on sharded leaves (the expert slabs'
    I- or width shards, the vocab-sharded embedding and head, GPT-OSS's
    head-sharded sinks): the statistics reduced over the mesh dims, the
    weights those of one process."""
    got = moe_mp["got"][f"{family}-{mesh}-{optimizer}"]
    want = moe_mp["ref"]["steps"][(family, optimizer)]
    _rel_close(got["losses"], want["losses"], 2e-5, "losses")
    for k, w in want["params"].items():
        a, b = got["params"][k].double().numpy(), w.double().numpy()
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), (family, mesh, optimizer, k)
        assert np.abs(a - b).max() <= 1e-2 / 3, (family, mesh, optimizer, k)


@pytest.mark.parametrize("optimizer", ["adafactor", "muon"])
@pytest.mark.parametrize("family", ["deepseek_v3", "gpt_oss"])
@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
def test_adafactor_and_muon_state_saved_on_a_mesh_restores_in_one_process(moe_mp, family, optimizer, mesh):
    """The statistics the two ranks saved through DCP after the two steps
    (the recipe's checkpoint tree: each placed as its JAX leaf's
    parameters, a reduced dim replicated) load into one process's tree
    whole: each within 1e-4 of the one-process run's norm, as the weights
    are, and the count 2."""
    import torch.distributed.checkpoint as dcp

    want = moe_mp["ref"]["steps"][(family, optimizer)]["optim"]
    blank = {"optim": {k: {n: torch.zeros_like(t) for n, t in v.items()} if isinstance(v, dict) else 0
                       for k, v in want.items()}}
    dcp.load(blank, checkpoint_id=str(moe_mp["root"] / f"{family}-{mesh}-{optimizer}_optim"), no_dist=True)
    got = blank["optim"]
    assert got["count"] == want["count"] == 2
    stats = [(kind, path) for kind, v in want.items() if isinstance(v, dict) for path in v]
    assert stats
    for kind, path in stats:
        a, b = got[kind][path].double().numpy(), want[kind][path].double().numpy()
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), (family, mesh, optimizer, kind, path)


def test_token_level_aux_loss_is_the_global_one(moe_mp):
    """The gate's token-level aux loss (``seq_len`` unset) over two ranks'
    halves of the rows: the shares add up to JAX's aux over all the rows,
    and the router grads to JAX's (2e-5 relative)."""
    from automodel_tpu.moe.config import MoEConfig as JMoEConfig
    from automodel_tpu.moe.gate import gate as jgate

    got, inp = moe_mp["got"]["gate-token-level"], moe_mp["gate_inputs"]
    cfg = JMoEConfig(**moe_mp["gate_cfg"])
    aux, grad = jax.value_and_grad(lambda w: jgate(jnp.asarray(inp["x"]), w, cfg).aux_loss)(
        jnp.asarray(inp["router"].T))
    _rel_close(got["aux"], float(aux), 2e-5, "aux")
    _rel_close(got["grad"].numpy().T, np.asarray(grad), 2e-5, "router grad")
