"""The torch port's checkpoint layer (automodel_tpu_torch/checkpoint/
checkpointer.py, verify.py, consolidate.py, resilience/manifest.py and
retry.py) and the recipe's resume and validation, against the JAX package
on the CPU.

Each test follows a JAX test by name (tests/test_resilience.py,
tests/test_checkpoint_polish.py): manifests commit and detect corruption,
each package's ``verify-ckpt`` audits the other's trees, the checkpointer
orders, prunes, walks back and guards as JAX's does. End to end: a run
broken at step 2 and resumed is bit-identical to an unbroken one through
the ``finetune`` CLI (fused_linear_ce, two microbatches), ``val_loss``
equals JAX's ``run_validation`` on the same weights and batches (fp32,
1e-5), and ``serve`` runs from a saved HF directory."""

import io
import json
import os
import shutil
import time
import types
import zlib

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from automodel_tpu.checkpoint.checkpointer import CheckpointingConfig as JaxCheckpointingConfig
from automodel_tpu.checkpoint.verify import main as jax_verify_main
from automodel_tpu.resilience import manifest as jmanifest
from automodel_tpu_torch.checkpoint.checkpointer import (
    Checkpointer,
    _dcp_load,
    CheckpointingConfig,
    CheckpointIntegrityError,
    param_tree_signature,
)
from automodel_tpu_torch.checkpoint.verify import main as verify_main
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.resilience import manifest
from automodel_tpu_torch.resilience.retry import RetriesExhausted, retry_io
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from torch_port_parity import HF_TINY, jax_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")
SERVE_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu.yaml")


def corrupt_file(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def _mk(tmp_path, **kw):
    return Checkpointer(CheckpointingConfig(checkpoint_dir=str(tmp_path / "run"), **kw))


def _state(v: float) -> dict:
    return {"w": torch.full((4,), v), "step": int(v)}


def _target() -> dict:
    return _state(0.0)


def _victim(d):
    return max((p for p in (d / "state").rglob("*") if p.is_file()), key=lambda p: p.stat().st_size)


# ---------------------------------------------------------------------------
# retry.py, manifest.py
# ---------------------------------------------------------------------------


def test_retry_succeeds_after_transient_failures_and_exhausts():
    calls, sleeps = [], []

    @retry_io(op="t", max_attempts=3, sleep=sleeps.append, jitter=0.0, base_delay_s=0.1)
    def flaky(n):
        calls.append(n)
        if len(calls) < 3:
            raise OSError("EIO")
        return n

    assert flaky(7) == 7 and len(calls) == 3 and sleeps == [0.1, 0.2]

    @retry_io(op="bad", max_attempts=2, sleep=lambda s: None)
    def broken():
        raise OSError("gone")

    with pytest.raises(RetriesExhausted) as e:
        broken()
    assert isinstance(e.value.__cause__, OSError)

    @retry_io(op="typed", sleep=lambda s: None)
    def corrupt():
        calls.append("v")
        raise ValueError("bad header")

    n = len(calls)
    with pytest.raises(ValueError):
        corrupt()
    assert len(calls) == n + 1  # not retried


def test_manifest_roundtrip_and_corruption_detection(tmp_path):
    d = tmp_path / "epoch_0_step_3"
    (d / "state").mkdir(parents=True)
    (d / "state" / "arrays.bin").write_bytes(os.urandom(4096))
    (d / "extra_state.json").write_text("{}")
    manifest.write_manifest(d, epoch=0, step=3, layout_markers={"k": "v1"})
    ok, problems = manifest.verify_manifest(d)
    assert ok and not problems
    m = json.loads((d / "MANIFEST.json").read_text())
    assert m["step"] == 3 and m["fingerprint"]["layout_markers"] == {"k": "v1"}
    assert set(m["files"]) == {"state/arrays.bin", "extra_state.json"}
    corrupt_file(d / "state" / "arrays.bin")
    ok, problems = manifest.verify_manifest(d)
    assert not ok and any("arrays.bin" in p and "checksum" in p for p in problems)
    assert manifest.verify_manifest(d, check_checksums=False)[0]
    (d / "extra_state.json").write_text("")
    ok, problems = manifest.verify_manifest(d, check_checksums=False)
    assert not ok and any("size" in p for p in problems)
    (d / "MANIFEST.json").unlink()
    ok, problems = manifest.verify_manifest(d)
    assert not ok and "missing" in problems[0]


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("size", [0, 1, 999, 1000, 1001, 4321])
def test_crc32_spans_join_to_the_whole_files_crc(tmp_path, monkeypatch, size, workers):
    """A file checksummed a span at a time (1000-byte spans here, on a
    pool of ``workers`` threads) gets the CRC32 of its whole bytes, so a
    manifest's entries stay the JAX package's."""
    monkeypatch.setattr(manifest, "_CRC_SPAN", 1000)
    monkeypatch.setattr(manifest, "_CRC_WORKERS", workers)
    data = np.random.default_rng(size).bytes(size)
    (tmp_path / "f").write_bytes(data)
    assert manifest._crc32_file(tmp_path / "f") == f"{zlib.crc32(data):08x}"


@pytest.mark.parametrize("checksums", [True, False])
def test_manifest_is_byte_compatible_with_jax(tmp_path, monkeypatch, checksums):
    """Both packages write the same MANIFEST.json for the same dir (the
    clock pinned), skipping the same tmp dirs, and each verifies the
    other's."""
    d = tmp_path / "epoch_1_step_7"
    (d / "state").mkdir(parents=True)
    (d / "state" / "data").write_bytes(os.urandom(3000))
    (d / "config.json").write_text('{"a": 1}')
    (d / "state.orbax-checkpoint-tmp-5").mkdir()
    (d / "state.orbax-checkpoint-tmp-5" / "junk").write_bytes(b"x")
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    kw = dict(epoch=1, step=7, layout_markers={"gpt_oss_gate_up": "contiguous_v1"}, checksums=checksums)
    port = manifest.write_manifest(d, **kw).read_bytes()
    assert jmanifest.verify_manifest(d)[0]
    jax_bytes = jmanifest.write_manifest(d, **kw).read_bytes()
    assert port == jax_bytes
    assert manifest.verify_manifest(d)[0]


def test_each_packages_verify_ckpt_audits_the_others_tree(tmp_path):
    """A committed tree of either package passes both auditors (exit 0); a
    truncated state file fails both (exit 1)."""
    ck = _mk(tmp_path)
    ck.save(_state(1.0), epoch=0, step=1)
    d2 = ck.save(_state(2.0), epoch=0, step=2)
    jck = JaxCheckpointer(JaxCheckpointingConfig(checkpoint_dir=str(tmp_path / "jax")))
    jd = jck.save({"w": jax.numpy.arange(4.0)}, epoch=0, step=1)
    from automodel_tpu.checkpoint.verify import audit_tree as jax_audit_tree

    assert all(r["committed"] and r["ok"] for r in jax_audit_tree(ck.root)) and len(jax_audit_tree(ck.root)) == 2
    for root in (ck.root, jck.root):
        assert verify_main([str(root)]) == 0 and jax_verify_main([str(root)]) == 0
    for d in (d2, jd):
        victim = _victim(d)
        with open(victim, "r+b") as f:
            f.truncate(victim.stat().st_size - 1)
    for root in (ck.root, jck.root):
        assert verify_main([str(root)]) == 1 and jax_verify_main([str(root)]) == 1


# ---------------------------------------------------------------------------
# checkpointer: commit marker, ordering, prune, walk-back, guards, best
# ---------------------------------------------------------------------------


def test_save_commits_manifest_and_orders_by_epoch_then_step(tmp_path):
    ck = _mk(tmp_path)
    d1 = ck.save(_state(1.0), epoch=0, step=100)
    d2 = ck.save(_state(2.0), epoch=1, step=50)
    assert (d1 / "MANIFEST.json").exists() and (d2 / "MANIFEST.json").exists()
    assert ck.latest_dir().name == "epoch_1_step_50"
    restored, _ = ck.load(_target())
    assert torch.equal(restored["w"], torch.full((4,), 2.0)) and restored["step"] == 2
    assert ck.last_load["state_bytes"] == 16 and ck.last_save["state_bytes"] == 16


def test_load_restores_in_place(tmp_path):
    """DCP loads into the target's tensors: a model's state dict (sharing
    the parameters' storage) comes back without a copy step."""
    ck = _mk(tmp_path)
    lin = torch.nn.Linear(3, 2)
    saved = {k: v.clone() for k, v in lin.state_dict().items()}
    ck.save({"model": lin.state_dict()}, epoch=0, step=1)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.zero_()
    ck.load({"model": lin.state_dict()})
    assert torch.equal(lin.weight, saved["weight"]) and torch.equal(lin.bias, saved["bias"])


def test_kill_during_async_save_falls_back_to_committed(tmp_path):
    ck = _mk(tmp_path)
    ck.save(_state(1.0), epoch=0, step=1)
    dead = ck.root / "epoch_0_step_2"
    (dead / "state").mkdir(parents=True)
    (dead / "state" / "junk.bin").write_bytes(b"\0" * 128)
    (dead / "state.dcp-checkpoint-tmp").mkdir()
    assert ck.latest_dir().name == "epoch_0_step_1"
    restored, _ = ck.load(_target())
    assert torch.equal(restored["w"], torch.full((4,), 1.0))


def test_async_save_commits_on_close(tmp_path):
    ck = _mk(tmp_path, is_async=True)
    src = _state(3.0)
    out = ck.save(src, epoch=0, step=2)
    src["w"].fill_(9.0)  # the staged host copy is what gets written
    ck.close()
    assert (out / "MANIFEST.json").exists() and manifest.verify_manifest(out)[0]
    restored, _ = ck.load(_target())
    assert torch.equal(restored["w"], torch.full((4,), 3.0))


def test_async_drain_failure_costs_one_checkpoint_not_the_run(tmp_path, monkeypatch, caplog):
    ck = _mk(tmp_path, is_async=True)
    d1 = ck.save(_state(1.0), epoch=0, step=1)
    monkeypatch.setattr(ck._async, "wait_until_finished", lambda: (_ for _ in ()).throw(OSError("flaked")))
    ck.wait()
    assert not (d1 / "MANIFEST.json").exists()
    assert "dir left uncommitted" in caplog.text
    d2 = ck.save(_state(2.0), epoch=0, step=2)
    ck.close()
    assert (d2 / "MANIFEST.json").exists()
    restored, _ = ck.load(_target())
    assert torch.equal(restored["w"], torch.full((4,), 2.0))


def test_legacy_tree_without_manifests_still_resumes(tmp_path):
    ck = _mk(tmp_path)
    for step, v in ((1, 1.0), (2, 2.0)):
        (ck.save(_state(v), epoch=0, step=step) / "MANIFEST.json").unlink()
    assert ck.latest_dir().name == "epoch_0_step_2"
    restored, _ = ck.load(_target())
    assert torch.equal(restored["w"], torch.full((4,), 2.0))


def test_load_walks_back_past_corrupt_newest(tmp_path, caplog):
    ck = _mk(tmp_path)
    ck.save(_state(1.0), epoch=0, step=1)
    d2 = ck.save(_state(2.0), epoch=0, step=2)
    corrupt_file(_victim(d2))
    restored, _ = ck.load(_target())
    assert torch.equal(restored["w"], torch.full((4,), 1.0))
    assert "FAILED verification" in caplog.text and "quarantined" in caplog.text
    assert not d2.exists() and (ck.root / "epoch_0_step_2.corrupt").exists()
    assert ck.latest_dir().name == "epoch_0_step_1"
    corrupt_file(_victim(ck.root / "epoch_0_step_1"))
    with pytest.raises(CheckpointIntegrityError):
        ck.load(_target())


def test_explicit_restore_from_never_silently_substitutes(tmp_path):
    ck = _mk(tmp_path)
    ck.save(_state(1.0), epoch=0, step=1)
    d2 = ck.save(_state(2.0), epoch=0, step=2)
    corrupt_file(_victim(d2))
    with pytest.raises(CheckpointIntegrityError):
        ck.load(_target(), path=d2)


def test_prune_counts_committed_only_and_protects_restore_from(tmp_path):
    ck = _mk(tmp_path, keep_last_k=2)
    d1 = ck.save(_state(1.0), epoch=0, step=1)
    ck.save(_state(2.0), epoch=0, step=2)
    ck.save(_state(3.0), epoch=0, step=3)
    assert not d1.exists()
    (ck.root / "epoch_0_step_9" / "state").mkdir(parents=True)  # newer uncommitted: untouched
    (ck.root / "epoch_0_step_0" / "state.dcp-checkpoint-tmp").mkdir(parents=True)  # stale: collected
    (ck.root / "epoch_0_step_1" / "state").mkdir(parents=True)  # legacy-looking: kept
    ck.config.restore_from = str(ck.root / "epoch_0_step_2")
    ck.save(_state(4.0), epoch=0, step=4)
    ck.save(_state(5.0), epoch=0, step=5)
    names = {p.name for p in ck.root.iterdir()}
    assert "epoch_0_step_2" in names and "epoch_0_step_3" not in names
    assert {"epoch_0_step_4", "epoch_0_step_5", "epoch_0_step_9", "epoch_0_step_1"} <= names
    assert "epoch_0_step_0" not in names


def test_restore_from_is_bootstrap_not_a_pin(tmp_path):
    base_dir = _mk(tmp_path / "base").save(_state(7.0), epoch=0, step=99)
    ck = _mk(tmp_path, restore_from=str(base_dir))
    assert ck.latest_dir() == base_dir and ck.latest_committed_dir() is None
    assert torch.equal(ck.load(_target())[0]["w"], torch.full((4,), 7.0))
    ck.save(_state(1.0), epoch=0, step=1)
    ck.save(_state(2.0), epoch=0, step=2)
    assert ck.latest_dir().name == ck.latest_committed_dir().name == "epoch_0_step_2"
    assert torch.equal(ck.load(_target())[0]["w"], torch.full((4,), 2.0))


def test_size_only_manifests(tmp_path):
    ck = _mk(tmp_path, manifest_checksums=False)
    out = ck.save(_state(1.0), epoch=0, step=1)
    m = json.loads((out / "MANIFEST.json").read_text())
    assert m["algorithm"] == "size-only" and all("crc32" not in e for e in m["files"].values())
    assert manifest.verify_manifest(out)[0]
    victim = _victim(out)
    with open(victim, "r+b") as f:
        f.truncate(10)
    ok, problems = manifest.verify_manifest(out)
    assert not ok and any("size" in p for p in problems)


def test_native_layout_marker_gates_restore(tmp_path):
    from automodel_tpu_torch.models.gpt_oss import GptOssForCausalLM

    markers = GptOssForCausalLM.native_layout_markers
    assert markers == {"gpt_oss_gate_up": "contiguous_v1"}
    ck = _mk(tmp_path)
    ck.save(_state(1.0), epoch=0, step=1, layout_markers=markers)
    restored, extra = ck.load(_target(), expected_layout_markers=markers)
    assert extra["_layout_markers"] == markers and torch.equal(restored["w"], torch.ones(4))
    with pytest.raises(ValueError, match="incompatible param layout"):
        ck.load(_target(), expected_layout_markers={"gpt_oss_gate_up": "contiguous_v2"})
    ck2 = Checkpointer(CheckpointingConfig(checkpoint_dir=str(tmp_path / "old")))
    ck2.save(_state(1.0), epoch=0, step=1)
    with pytest.raises(ValueError, match="no layout marker"):
        ck2.load(_target(), expected_layout_markers=markers)
    assert torch.equal(ck2.load(_target())[0]["w"], torch.ones(4))


def test_param_signature_guard_refuses_mismatched_tree(tmp_path):
    state = {"a": torch.arange(4.0), "b": {"w": torch.ones(2, 3)}}
    ck = _mk(tmp_path)
    ck.save(state, epoch=0, step=1)
    ok = {"a": torch.zeros(4), "b": {"w": torch.zeros(2, 3)}}
    restored, extra = ck.load(ok)
    assert "_param_signature" in extra and torch.equal(restored["a"], torch.arange(4.0))
    bad_shape = {"a": torch.zeros(4), "b": {"w": torch.zeros(2, 4)}}
    with pytest.raises(ValueError, match="signature mismatches"):
        ck.load(bad_shape)
    with pytest.raises(ValueError, match="b/w"):
        ck.load(bad_shape)
    with pytest.raises(ValueError, match="checkpoint has but model lacks"):
        ck.load({"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="model expects but checkpoint lacks"):
        ck.load({**ok, "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="signature mismatches"):
        ck.load({"a": torch.zeros(4, dtype=torch.int32), "b": {"w": torch.zeros(2, 3)}})
    off = Checkpointer(CheckpointingConfig(checkpoint_dir=str(tmp_path / "run"), check_param_signature=False))
    assert torch.equal(off.load({"a": torch.zeros(4), "b": {"w": torch.zeros(2, 3)}})[0]["a"], torch.arange(4.0))
    legacy = Checkpointer(CheckpointingConfig(checkpoint_dir=str(tmp_path / "old"), check_param_signature=False))
    legacy.save(state, epoch=0, step=1)
    restored, extra = Checkpointer(CheckpointingConfig(checkpoint_dir=str(tmp_path / "old"))).load(ok)
    assert "_param_signature" not in extra
    assert param_tree_signature(state)["digest"] == param_tree_signature({"b": state["b"], "a": state["a"]})["digest"]


def test_best_val_marker_and_prune_protection(tmp_path):
    ck = _mk(tmp_path, keep_last_k=2)
    d1 = ck.save(_state(1.0), epoch=0, step=1)
    ck.mark_best(d1, "val_loss", 0.5)
    info = ck.best_info()
    assert info["dir"] == d1.name and info["value"] == 0.5 and info["step"] == 1
    d2 = ck.save(_state(2.0), epoch=0, step=2)
    d3 = ck.save(_state(3.0), epoch=0, step=3)
    d4 = ck.save(_state(4.0), epoch=0, step=4)
    assert d1.exists() and not d2.exists() and d3.exists() and d4.exists()
    ck.mark_best(d4, "val_loss", 0.25)
    assert ck.best_info()["dir"] == d4.name
    ck.save(_state(5.0), epoch=0, step=5)
    assert not d1.exists()


def test_best_marker_defers_until_async_commit(tmp_path):
    ck = _mk(tmp_path, is_async=True)
    d1 = ck.save(_state(1.0), epoch=0, step=1)
    ck.mark_best(d1, "val_loss", 0.5)
    assert ck.best_info() is None or (d1 / "MANIFEST.json").exists()
    ck.wait()
    info = ck.best_info()
    assert (d1 / "MANIFEST.json").exists() and info["dir"] == d1.name and info["value"] == 0.5
    ck.close()


def test_verify_ckpt_cli(tmp_path, capsys):
    ck = _mk(tmp_path)
    ck.save(_state(1.0), epoch=0, step=1)
    d2 = ck.save(_state(2.0), epoch=0, step=2)
    assert app.main(["verify-ckpt", str(ck.root)]) == 0
    corrupt_file(_victim(d2))
    assert app.main(["verify-ckpt", str(ck.root)]) == 1
    assert app.main(["verify-ckpt", str(ck.root), "--no-checksums"]) == 0
    capsys.readouterr()
    assert app.main(["verify-ckpt", str(ck.root), "--json"]) == 1
    recs = json.loads(capsys.readouterr().out)
    assert [r["ok"] for r in recs] == [True, False]
    assert app.main(["verify-ckpt", str(tmp_path / "nope")]) == 2


def test_verify_ckpt_tolerates_uncommitted_leftover(tmp_path):
    ck = _mk(tmp_path)
    ck.save(_state(1.0), epoch=0, step=1)
    (ck.root / "epoch_0_step_2" / "state").mkdir(parents=True)
    (ck.root / "epoch_0_step_2" / "state" / "data.bin").write_bytes(b"x" * 16)
    assert verify_main([str(ck.root)]) == 0
    legacy = tmp_path / "legacy_tree"
    (legacy / "epoch_0_step_1" / "state").mkdir(parents=True)
    assert verify_main([str(legacy)]) == 0
    only_bad = tmp_path / "only_uncommitted"
    (only_bad / "epoch_0_step_1" / "state.dcp-checkpoint-tmp").mkdir(parents=True)
    assert verify_main([str(only_bad)]) == 1


def test_step_scheduler_cadence_and_state():
    batches = [{"i": i} for i in range(10)]
    s = StepScheduler(grad_acc_steps=1, ckpt_every_steps=2, val_every_steps=3, max_steps=6, dataloader=batches)
    seen = [(s.step, s.is_ckpt_step, s.is_val_step) for _ in s]
    assert seen == [(1, False, False), (2, True, False), (3, False, True), (4, True, False), (5, False, False),
                    (6, True, True)]
    assert s.state_dict() == {"step": 6, "epoch": 0}
    t = StepScheduler(dataloader=batches)
    t.load_state_dict({"step": 4, "epoch": 1})
    assert (t.step, t.epoch, t.is_ckpt_step) == (4, 1, False)


# ---------------------------------------------------------------------------
# the recipe: resume, validation, best marker, consolidation, serving
# ---------------------------------------------------------------------------

CKPT_ARGS = [
    "--checkpoint.enabled=true", "--checkpoint.save_consolidated=true",
    "--step_scheduler.ckpt_every_steps=2", "--step_scheduler.val_every_steps=2",
    "--validation_dataset._target_=automodel_tpu_torch.data.sft.MockSFTDataset",
    "--validation_dataset.vocab_size=256", "--validation_dataset.seq_length=64",
    "--validation_dataset.num_samples=8", "--validation_dataset.seed=7",
]


def _finetune(tmp_path, tag, *args):
    rc = app.main(["finetune", "llm", "-c", SFT_CFG, "--device=cpu",
                   f"--logging.metrics_path={tmp_path / tag}.jsonl", *args])
    assert rc == 0
    return [json.loads(s) for s in (tmp_path / f"{tag}.jsonl").read_text().splitlines()]


def _dcp_model_and_moments(step_dir):
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(str(step_dir / "state")).read_metadata()
    sd = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in meta.state_dict_metadata.items()
          if isinstance(m, TensorStorageMetadata)}
    return _dcp_load(step_dir / "state", sd)


def test_resumed_run_is_bit_identical_to_an_unbroken_one(tmp_path):
    """4 unbroken steps against 2 + resume + 2 through the finetune CLI
    (fused_linear_ce, 2 microbatches, checkpoints and validation every 2
    steps): the same losses and grad norms bit for bit, and the same step-4
    state (parameters, fp32 moments, count and step); the resumed run logs
    its resume record and the best marker names a committed dir."""
    args = [*CKPT_ARGS, "--step_scheduler.max_steps=4"]
    whole = _finetune(tmp_path, "whole", *args, f"--checkpoint.checkpoint_dir={tmp_path / 'a'}")
    first = _finetune(tmp_path, "broken", *CKPT_ARGS, "--step_scheduler.max_steps=2",
                      f"--checkpoint.checkpoint_dir={tmp_path / 'b'}")
    assert sorted(p.name for p in (tmp_path / "b").iterdir() if p.name.startswith("epoch")) == ["epoch_0_step_2"]
    both = _finetune(tmp_path, "broken", *args, f"--checkpoint.checkpoint_dir={tmp_path / 'b'}")
    assert both[: len(first)] == first
    resumes = [r for r in both if r.get("event") == "resume"]
    assert [r["resumed_from_step"] for r in resumes] == [2]
    train = lambda rows: [(r["step"], r["loss"], r["grad_norm"]) for r in rows if "loss" in r]
    assert train(both) == train(whole) and len(train(whole)) == 4
    vals = lambda rows: [(r["step"], r["val_tokens"]) for r in rows if "val_loss" in r]
    assert vals(both) == vals(whole) and [s for s, _ in vals(whole)] == [2, 4] and vals(whole)[0][1] > 0
    for step in (2, 4):  # the parameter and moment trajectory
        a = _dcp_model_and_moments(tmp_path / "a" / f"epoch_0_step_{step}")
        b = _dcp_model_and_moments(tmp_path / "b" / f"epoch_0_step_{step}")
        assert set(a) == set(b) and any(k.startswith("optim.mu.") for k in a) and len(a) > 20
        for k in a:
            assert torch.equal(a[k], b[k]), (step, k)
    hf = "epoch_0_step_4/hf/model.safetensors"
    assert (tmp_path / "a" / hf).read_bytes() == (tmp_path / "b" / hf).read_bytes()
    for root in ("a", "b"):
        best = json.loads((tmp_path / root / "BEST.json").read_text())
        assert (tmp_path / root / best["dir"] / "MANIFEST.json").exists() and best["metric"] == "val_loss"
        assert app.main(["verify-ckpt", str(tmp_path / root)]) == 0


def test_val_loss_matches_jax_run_validation(tmp_path):
    """The port's run_validation over the same weights (carried from JAX)
    and the same validation batches as JAX's run_validation: val_loss
    within fp32 1e-5, val_tokens equal."""
    from automodel_tpu.data.loader import DataLoader as JaxDataLoader
    from automodel_tpu.data.sft import MockSFTDataset as JaxMockSFTDataset
    from automodel_tpu.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe
    from automodel_tpu.training.train_state import TrainState as JaxTrainState
    from automodel_tpu.training.train_step import build_eval_step as jax_build_eval_step
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_make_loss
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    ds = dict(vocab_size=128, seq_length=16, num_samples=6, seed=3)
    cfg = dict(
        seed=5, device="cpu",
        model=dict(hf_config=HF_TINY, backend=dict(attn="sdpa", param_dtype="float32", compute_dtype="float32")),
        dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", **ds),
        validation_dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", **ds),
        dataloader=dict(global_batch_size=2),
        loss_fn=dict(name="fused_linear_ce", num_chunks=4),
        logging=dict(metrics_path=str(tmp_path / "m.jsonl")),
    )
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    jmodel, params, _ = jax_tiny(seed=2)
    recipe.model.load_state_dict(params_from_jax(jax.device_get(params)))
    port = recipe.run_validation()
    jns = types.SimpleNamespace(
        val_dataloader=JaxDataLoader(JaxMockSFTDataset(**ds), global_batch_size=2, seed=5),
        eval_step=jax_build_eval_step(jax_make_loss(jmodel, loss="fused_linear_ce", num_chunks=4)),
        state=JaxTrainState.create(params, {}), mesh_ctx=None, _last_val_metric=None,
    )
    ref = JaxRecipe.run_validation(jns)
    assert port["val_tokens"] == ref["val_tokens"] > 0
    np.testing.assert_allclose(port["val_loss"], ref["val_loss"], rtol=0, atol=1e-5)
    assert recipe._last_val_metric == port["val_loss"]


def test_offline_consolidation_equals_the_runs_hf_save(tmp_path):
    """consolidate(step_dir) rebuilds the model from the config snapshot
    on the device asked for, reads only the DCP state's model entries, and writes the same
    safetensors bytes as the run's own hf/ export."""
    from automodel_tpu_torch.checkpoint.consolidate import main as consolidate_main

    _finetune(tmp_path, "c", *CKPT_ARGS, "--step_scheduler.max_steps=2",
              f"--checkpoint.checkpoint_dir={tmp_path / 'ck'}")
    step = tmp_path / "ck" / "epoch_0_step_2"
    if not torch.cuda.is_available():  # CUDA unless asked for the CPU
        with pytest.raises(RuntimeError, match="torch.cuda"):
            consolidate_main([str(step), str(tmp_path / "out")])
    assert consolidate_main([str(step), str(tmp_path / "out"), "--device=cpu"]) == 0
    assert (tmp_path / "out" / "model.safetensors").read_bytes() == (step / "hf" / "model.safetensors").read_bytes()
    assert json.loads((tmp_path / "out" / "config.json").read_text()) == json.loads(
        (step / "hf" / "config.json").read_text())


def test_serve_and_finetune_from_a_local_hf_directory(tmp_path, monkeypatch, capsys):
    """``serve -c`` with model.pretrained_model_name_or_path a directory the
    port saved serves the same greedy tokens as the random-init config the
    weights came from; ``finetune`` starts from it and resumes with
    restore_from naming another run's step dir."""
    from automodel_tpu_torch.auto_model import from_config
    from automodel_tpu_torch.checkpoint.hf_io import save_hf_checkpoint
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.generation.engine import build_auto_from_cfg

    cfg = load_yaml_config(SERVE_CFG)
    auto = build_auto_from_cfg(cfg)
    save_hf_checkpoint(tmp_path / "hf", auto.adapter.to_hf(auto.model.state_dict()))
    (tmp_path / "hf" / "config.json").write_text(json.dumps(cfg.model.hf_config.to_dict()))
    line = json.dumps({"id": "x", "prompt_ids": [3, 1, 4, 1, 5, 9, 2, 6]}) + "\n"
    outs = []
    for extra in ([], [f"--model.pretrained_model_name_or_path={tmp_path / 'hf'}"]):
        monkeypatch.setattr("sys.stdin", io.StringIO(line))
        assert app.main(["serve", "-c", SERVE_CFG, "--device=cpu", *extra]) == 0
        outs.append([json.loads(s)["completion"] for s in capsys.readouterr().out.splitlines() if s.strip()])
    assert outs[0] == outs[1] and len(outs[0][0].split()) == 8

    sft = load_yaml_config(SFT_CFG).model.hf_config.to_dict()
    src = tmp_path / "sft_hf"
    base = from_config(sft, {"param_dtype": "float32", "compute_dtype": "float32"}, device="cpu", seed=9)
    save_hf_checkpoint(src, base.adapter.to_hf(base.model.state_dict()))
    (src / "config.json").write_text(json.dumps(sft))
    (src / "tokenizer.json").write_text("{}")
    pre = [f"--model.pretrained_model_name_or_path={src}", *CKPT_ARGS, "--step_scheduler.max_steps=2"]
    _finetune(tmp_path, "p", *pre, f"--checkpoint.checkpoint_dir={tmp_path / 'p'}")
    step2 = tmp_path / "p" / "epoch_0_step_2"
    assert (step2 / "hf" / "tokenizer.json").exists()  # the add-ons copy the source's files
    rows = _finetune(tmp_path, "q", *pre[:-1], "--step_scheduler.max_steps=4", f"--checkpoint.restore_from={step2}",
                     f"--checkpoint.checkpoint_dir={tmp_path / 'q'}")
    assert [r["resumed_from_step"] for r in rows if r.get("event") == "resume"] == [2]
    assert [r["step"] for r in rows if "loss" in r] == [3, 4]
    shutil.rmtree(tmp_path / "p")
