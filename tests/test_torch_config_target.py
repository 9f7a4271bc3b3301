"""``_target_`` resolution in the port's ``ConfigNode.instantiate``, against
JAX's (``automodel_tpu/config/loader.py:207-236``): sibling keys as kwargs,
nested targets built first, ``_no_instantiate_``, overrides. A target of
the JAX package resolves to the port's twin, never to the JAX module; the
JAX stack and an unported twin are refused by name; every ``_target_`` of
the committed ``examples/**/*.yaml`` either resolves to its twin or is
refused naming what is missing. The recipe builds its dataset through it."""

import glob
import json
import os
import subprocess
import sys

import pytest

from automodel_tpu.config.loader import ConfigNode as JConfigNode
from automodel_tpu.config.loader import load_yaml_config as jload
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.config.loader import ConfigNode, resolve_target
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")


def test_instantiate_semantics_equal_jax():
    tree = {
        "_target_": "builtins.dict",
        "a": 1,
        "inner": {"_target_": "builtins.dict", "x": [1, {"_target_": "builtins.complex", "real": 3.0, "imag": 4.0}]},
        "kept": {"_target_": "math.sqrt", "x": 4.0},
        "_no_instantiate_": ["kept"],
    }
    t, j = ConfigNode(tree).instantiate(b=2), JConfigNode(tree).instantiate(b=2)
    assert t["inner"] == j["inner"] == {"x": [1, 3 + 4j]}
    assert (t["a"], t["b"]) == (j["a"], j["b"]) == (1, 2)
    assert t["kept"].to_dict() == j["kept"].to_dict() == {"_target_": "math.sqrt", "x": 4.0}
    assert ConfigNode({"_target_": "builtins.dict", "a": 1}).instantiate(a=3) == {"a": 3}
    for node in (ConfigNode({"a": 1}), JConfigNode({"a": 1})):
        with pytest.raises(ValueError, match="no _target_"):
            node.instantiate()


@pytest.mark.parametrize("prefix", ["automodel_tpu", "automodel_tpu_torch"])
def test_both_prefixes_build_the_port_dataset_without_importing_jax(prefix):
    code = (
        "import sys\n"
        "from automodel_tpu_torch.config.loader import ConfigNode\n"
        f"ds = ConfigNode({{'_target_': '{prefix}.data.sft.MockSFTDataset', 'vocab_size': 64, "
        "'seq_length': 16, 'num_samples': 4}).instantiate()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'automodel_tpu'))\n"
        "print(type(ds).__module__, len(ds), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["automodel_tpu_torch.data.sft", "4", "[]"]


@pytest.mark.parametrize(
    "target,match",
    [
        ("jax.numpy.zeros", "names jax"),
        ("optax.adamw", "names optax"),
        ("flax.linen.Dense", "names flax"),
        ("orbax.checkpoint.PyTreeCheckpointer", "names orbax"),
        ("os.system", "outside the import allowlist"),
        ("automodel_tpu.peft.lora.apply_lora", "first missing module: automodel_tpu_torch.peft"),
        ("automodel_tpu.data.retrieval.MockRetrievalDataset",
         "first missing module: automodel_tpu_torch.data.retrieval"),
        ("automodel_tpu.data.sft.HellaSwag", "first missing name: automodel_tpu_torch.data.sft.HellaSwag"),
    ],
)
def test_refusals_name_what_is_missing(target, match):
    with pytest.raises(ValueError, match=match):
        resolve_target(target)
    with pytest.raises(ValueError, match=match):
        ConfigNode({"_target_": target}).instantiate()


def _targets(node):
    if isinstance(node, dict):
        if isinstance(node.get("_target_"), str):
            yield node["_target_"]
        for v in node.values():
            yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_every_example_target_resolves_to_its_twin_or_is_refused_by_name():
    targets = sorted({
        t for path in glob.glob(os.path.join(REPO, "examples", "**", "*.yaml"), recursive=True)
        for t in _targets(jload(path).to_dict())
    })
    assert "automodel_tpu.data.sft.MockSFTDataset" in targets
    resolved = []
    for t in targets:
        try:
            obj = resolve_target(t)
        except ValueError as e:
            assert "does not have yet" in str(e) or "allowlist" in str(e) or "does not exist" in str(e), (t, e)
            continue
        except ImportError:
            # an allowlisted third-party package absent from this host
            # (transformers, datasets): the same failure JAX's loader gives
            continue
        resolved.append(t)
        if t.startswith("automodel_tpu."):
            assert obj.__module__.startswith("automodel_tpu_torch.")
            assert obj.__qualname__ == t.rsplit(".", 1)[-1]
    assert "automodel_tpu.data.sft.MockSFTDataset" in resolved


def test_recipe_dataset_from_either_prefix_trains_the_same(tmp_path):
    losses = {}
    for prefix in ("automodel_tpu", "automodel_tpu_torch"):
        path = tmp_path / f"{prefix}.jsonl"
        rc = app.main(["finetune", "llm", "-c", SFT_CFG, "--device=cpu", "--step_scheduler.max_steps=2",
                       f"--dataset._target_={prefix}.data.sft.MockSFTDataset", f"--logging.metrics_path={path}"])
        assert rc == 0
        losses[prefix] = [r["loss"] for r in map(json.loads, path.read_text().splitlines()) if "loss" in r]
    assert losses["automodel_tpu"] == losses["automodel_tpu_torch"] and len(losses["automodel_tpu"]) == 2
    with pytest.raises(ValueError, match="does not have yet"):
        app.main(["finetune", "llm", "-c", SFT_CFG, "--device=cpu",
                  "--dataset._target_=automodel_tpu.data.sft.HellaSwag"])
