"""The port's mesh and plans (automodel_tpu_torch/parallel/mesh.py, plans.py)
against the JAX package's, after tests/test_mesh.py.

The degrees, the inference of ``dp_shard: -1``, the validation errors,
the logical-axis rules and ``resolve`` are compared with JAX's
``build_mesh`` on the suite's 8 virtual CPU devices; the port's side needs
no process group for them. One world-1 gloo group, made in this process
and torn down, builds a real device mesh with its flattened groupings. The
plans' rule matching runs over the port's HF names against JAX's over its
tree paths on the same tiny Llama.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_port_parity import HF_TINY, jax_tiny, torch_twin

from automodel_tpu.parallel import MeshConfig as JMeshConfig, build_mesh as jbuild_mesh
from automodel_tpu.parallel import mesh as jmesh
from automodel_tpu.parallel.plans import match_rule as jmatch_rule, path_str as jpath_str
from automodel_tpu_torch.parallel import mesh as tmesh
from automodel_tpu_torch.parallel import plans as tplans
from automodel_tpu_torch.parallel.mesh import MeshConfig, MeshContext

DEGREES = [
    dict(tp=2),
    dict(pp=2, tp=2, cp=1, dp_shard=2),
    dict(dp_shard=8, ep=4),
    dict(dp_shard=2, cp=2, tp=2),
    dict(dp_replicate=2, dp_shard=2, tp=2),
    dict(dp_replicate=2, cp=2),
    dict(),
]
SPECS = [("batch", "seq", None), ("fsdp", "tensor"), ("loss_dp",), ("expert", "expert_fsdp"), (None, "fsdp", "tensor"),
         (("batch", "seq"), None), ("vocab",), ("expert_batch", None, "stage")]


def _jax_spec(p) -> tuple:
    return tuple(tuple(d) if isinstance(d, (tuple, list)) else d for d in p)


@pytest.mark.parametrize("degrees", DEGREES, ids=lambda d: "_".join(f"{k}{v}" for k, v in d.items()) or "default")
def test_sizes_and_resolve_match_jax(devices8, degrees):
    jctx = jbuild_mesh(JMeshConfig(**degrees), devices=devices8)
    ctx = MeshContext.from_degrees(8, **degrees)
    assert ctx.shape == dict(jctx.mesh.shape)
    assert (ctx.world_size, ctx.dp_size, ctx.dp_cp_size, ctx.tp_size, ctx.cp_size, ctx.pp_size, ctx.ep_size) == (
        jctx.world_size, jctx.dp_size, jctx.dp_cp_size, jctx.tp_size, jctx.cp_size, jctx.pp_size, jctx.ep_size)
    for spec in SPECS:
        assert ctx.resolve(spec) == _jax_spec(jctx.resolve(spec)), spec
    assert ctx.resolve(None) == ()


def test_infer_and_validation_errors_word_for_word():
    assert MeshConfig(tp=2).validate(8).dp_shard == 4
    bad = [dict(tp=3), dict(dp_shard=3, tp=2), dict(dp_shard=8, ep=3), dict(pp_schedule="1f1b"), dict(pp_zb_queue=0)]
    for degrees in bad:
        with pytest.raises(ValueError) as jerr:
            JMeshConfig(**degrees).validate(8)
        with pytest.raises(ValueError) as terr:
            MeshConfig(**degrees).validate(8)
        want = str(jerr.value).replace("MeshConfig(", "").split("product")[-1]
        assert want in str(terr.value), (str(terr.value), str(jerr.value))


def test_refusals_by_name_and_section_keys():
    for degrees, name in ((dict(pp=2), "distributed.pp=2"), (dict(ep=2), "distributed.ep=2")):
        with pytest.raises(ValueError, match=name):
            MeshConfig(**degrees).check_ported()
    assert MeshConfig.from_section({"cp": 2, "platform": "cpu", "tp": None}) == MeshConfig(cp=2)
    with pytest.raises(ValueError, match=r"distributed keys \['cpp'\]"):
        MeshConfig.from_section({"cpp": 2})


def test_hybrid_mesh_shapes_match_jax():
    cases = [(JMeshConfig(dp_shard=8), MeshConfig(dp_shard=8), 2), (JMeshConfig(dp_replicate=2, tp=2),
             MeshConfig(dp_replicate=2, tp=2), 2), (JMeshConfig(dcn={"dp_shard": 2}), MeshConfig(dcn={"dp_shard": 2}), 2)]
    for jcfg, cfg, n in cases:
        assert tmesh.hybrid_mesh_shapes(cfg, 8, n) == jmesh.hybrid_mesh_shapes(jcfg, 8, n)
    for kw, n in ((dict(tp=8), 2), (dict(dcn={"tp": 2}, tp=2), 4), (dict(dcn={"xx": 2}), 2)):
        with pytest.raises(ValueError) as jerr:
            jmesh.hybrid_mesh_shapes(JMeshConfig(**kw), 8, n)
        with pytest.raises(ValueError) as terr:
            tmesh.hybrid_mesh_shapes(MeshConfig(**kw), 8, n)
        assert str(terr.value) == str(jerr.value)


def test_initialize_distributed_env_plumbing(monkeypatch):
    """torchrun's variables are validated before dialing, as JAX validates
    its own; the dial gets the parsed topology."""
    import torch.distributed as dist

    calls = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.update(backend=backend, **kw))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_distributed("cpu") == (0, 1)  # no env: one process on a free local port
    assert calls["backend"] == "gloo" and calls["world_size"] == 1 and calls["init_method"].startswith("tcp://127.0.0.1:")
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "1234")
    with pytest.raises(ValueError, match="WORLD_SIZE / RANK"):
        tmesh.initialize_distributed("cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert tmesh.initialize_distributed("cpu") == (2, 4)
    assert calls["init_method"] == "tcp://host0:1234" and (calls["rank"], calls["world_size"]) == (2, 4)
    monkeypatch.setenv("RANK", "5")
    with pytest.raises(ValueError, match="invalid process topology"):
        tmesh.initialize_distributed("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_PORT", "http")
    with pytest.raises(ValueError, match="host and port"):
        tmesh.initialize_distributed("cpu")
    if not torch.cuda.is_available():
        monkeypatch.setenv("MASTER_PORT", "1234")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tmesh.initialize_distributed("cuda")


def test_device_mesh_of_one_process_groupings():
    """A world-1 gloo group → the device mesh in JAX's axis order with the
    flattened groupings; every coordinate 0."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(MeshConfig())
    tmesh.initialize_distributed("cpu")
    try:
        ctx = tmesh.build_mesh(MeshConfig())
        assert ctx.mesh.mesh_dim_names == tmesh.MeshAxisName.ALL and ctx.mesh.shape == (1,) * 6
        assert ctx.device_type == "cpu" and ctx.rank == 0
        for name in tmesh.FLAT_GROUPS + ("tp", "cp"):
            assert ctx.submesh(name).size() == 1 and ctx.coordinate(name) == 0
            assert dist.get_world_size(ctx.group(name)) == 1
        assert ctx.fsdp_mesh().mesh_dim_names == ("fsdp",)
        with pytest.raises(ValueError, match="distributed.ep"):
            tmesh.build_mesh(MeshConfig(ep=2, dp_shard=2))
    finally:
        tmesh.destroy_distributed()


def test_plan_rules_match_jax_paths():
    """Each port tensor's JAX path matches the rule JAX matches on that
    leaf; the TP plan makes q/k/v/gate/up column-wise, o/down row-wise,
    the embedding and lm_head vocab-sharded."""
    import jax

    from automodel_tpu.models.llama.model import SHARDING_RULES as JRULES
    from automodel_tpu_torch.models.llama.model import SHARDING_RULES

    assert SHARDING_RULES == JRULES
    model, params, _ = jax_tiny()
    jpaths = {jpath_str(p) for p, _ in jax.tree_util.tree_leaves_with_path(params)}
    tmodel = torch_twin(params).model
    seen = set()
    for name, _ in tmodel.named_parameters():
        path = tplans.path_str(name)
        assert path in jpaths, (name, path)
        assert tplans.match_rule(path, SHARDING_RULES) == jmatch_rule(path, JRULES)
        seen.add(path)
    assert seen == jpaths
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    plan = tplans.tp_plan(tmodel, SHARDING_RULES)
    kinds = {k: type(v) for k, v in plan.items()}
    L = HF_TINY["num_hidden_layers"]
    assert len(plan) == 7 * L + 2
    for i in range(L):
        for proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "mlp.gate_proj", "mlp.up_proj"):
            assert kinds[f"model.layers.{i}.{proj}"] is ColwiseParallel
        for proj in ("self_attn.o_proj", "mlp.down_proj"):
            assert kinds[f"model.layers.{i}.{proj}"] is RowwiseParallel
    assert kinds["model.embed_tokens"] is RowwiseParallel and kinds["lm_head"] is ColwiseParallel


def test_rule_tables_are_jax_copies():
    from automodel_tpu.models.gemma import model as jg
    from automodel_tpu.models.gpt_oss import model as jgo
    from automodel_tpu.models.qwen3_moe import model as jq
    from automodel_tpu_torch.models.gemma import model as tg
    from automodel_tpu_torch.models.gpt_oss import model as tgo
    from automodel_tpu_torch.models.qwen3_moe import model as tq

    for t, j in ((tg, jg), (tgo, jgo), (tq, jq)):
        assert t.SHARDING_RULES == j.SHARDING_RULES, t.__name__


def test_check_tp_refusals():
    from automodel_tpu_torch.models.common.config import TransformerConfig

    class M:
        config = TransformerConfig.from_hf(dict(HF_TINY, num_key_value_heads=1))

    with pytest.raises(ValueError, match="tp=2 must divide num_attention_heads=4 and num_key_value_heads=1"):
        tplans.check_tp(M(), 2)
    M.config = TransformerConfig.from_hf(dict(HF_TINY, vocab_size=127))
    with pytest.raises(ValueError, match="vocab_size=127"):
        tplans.check_tp(M(), 2)
    tplans.check_tp(M(), 1)
    np.testing.assert_equal(tplans.local(torch.ones(2)).numpy(), np.ones(2))


def test_chip_smoke_fsdp_config_is_the_committed_one():
    """chip_smoke.py phase 26 (a) carries sft_llama3_8b_fsdp.yaml as a dict:
    the full-depth config with ``distributed: {dp_shard: -1}``."""
    import importlib.util

    from automodel_tpu_torch.config.loader import load_yaml_config

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    configs = repo / "automodel_tpu_torch" / "configs"
    fsdp = load_yaml_config(configs / "sft_llama3_8b_fsdp.yaml").to_dict()
    full = load_yaml_config(configs / "sft_llama3_8b_full.yaml").to_dict()
    assert chip_smoke.SFT_LLAMA3_8B_FSDP == fsdp
    assert {k: v for k, v in fsdp.items() if k not in ("distributed", "logging")} == {
        k: v for k, v in full.items() if k != "logging"}
    assert fsdp["distributed"] == {"dp_shard": -1}
    assert MeshConfig.from_section(fsdp["distributed"]).validate(1).dp_shard == 1
