"""The port's distributed guard against the JAX package's
(``tests/test_distributed_guard.py``): timed calls and barriers, straggler
attribution, the consensus fingerprint (``find_divergent``,
``fold_array_crc``, ``config_crc`` equal to JAX's on the same inputs), the
injected single-process desync, the training watchdog (adaptive deadline,
phase graces, evidence on expiry), a desynced checkpoint that never
commits, and the hang that exits 75 from a subprocess. A 2-process gloo
consensus run is marked ``slow``."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from automodel_tpu_torch.resilience import fault_injection as fi
from automodel_tpu_torch.resilience.consensus import (
    COLUMNS,
    ConsensusConfig,
    ConsensusGuard,
    DesyncError,
    config_crc,
    find_divergent,
    fold_array_crc,
)
from automodel_tpu_torch.resilience.timed_sync import SyncTimeout, barrier_with_timeout, slowest_host, timed_call
from automodel_tpu_torch.resilience.watchdog import Watchdog, WatchdogConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_TINY = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")


@pytest.fixture(autouse=True)
def _reset_fault_injection():
    fi.activate(None)
    yield
    fi.activate(None)


def test_timed_call_passes_results_and_exceptions_through_and_times_out():
    assert timed_call(lambda: 7, name="x", timeout_s=5) == 7
    with pytest.raises(ZeroDivisionError):
        timed_call(lambda: 1 / 0, name="x", timeout_s=5)
    with pytest.raises(SyncTimeout, match="'checkpoint_commit'"):
        timed_call(lambda: time.sleep(5), name="checkpoint_commit", timeout_s=0.1)


def test_barrier_single_process_is_free_and_a_dead_peer_times_out():
    assert barrier_with_timeout("shutdown") == 1
    assert barrier_with_timeout("x", gather_fn=lambda v: np.stack([v, v, v])) == 3
    with pytest.raises(SyncTimeout, match="'init'"):
        barrier_with_timeout("init", timeout_s=0.1, gather_fn=lambda v: time.sleep(5))


def test_slowest_host_and_find_divergent_match_jax():
    """The same matrices through both packages' plurality rule: the same
    findings (majority, no majority, two divergers, the step-time column
    ignored), and the same straggler attribution."""
    from automodel_tpu.resilience import consensus as jc
    from automodel_tpu.resilience import timed_sync as jts

    rng = np.random.default_rng(0)
    base = np.array([5.0, 1234.0, 99.0, 0.5, 0.1])
    mats = [np.stack([base] * 4)]
    m = np.stack([base] * 4)
    m[2, COLUMNS.index("data")] = 7.0
    mats.append(m)
    m = np.stack([base] * 4)
    m[0, 0], m[1, 0] = 6.0, 7.0
    mats.append(m)
    m = np.stack([base] * 2)
    m[1, 1] = 1.0
    mats.append(m)
    m = np.stack([base] * 3)
    m[:, COLUMNS.index("step_time")] = rng.random(3)
    mats.append(m)
    for mat in mats:
        assert find_divergent(mat) == jc.find_divergent(mat)
        times = mat[:, COLUMNS.index("step_time")]
        assert slowest_host(times) == jts.slowest_host(times)
    assert [f["host"] for f in find_divergent(mats[1])] == [2]
    assert slowest_host([0.1, 0.5, 0.1]) == (1, pytest.approx(5.0))


def test_fold_array_crc_and_config_crc_match_jax():
    from automodel_tpu.resilience import consensus as jc

    rng = np.random.default_rng(1)
    h = jh = 0
    for shape, dtype in (((2, 3, 16), np.int32), ((5,), np.int64), ((4, 4), np.float32)):
        a = rng.integers(0, 1000, size=shape).astype(dtype)
        h, jh = fold_array_crc(h, a), jc.fold_array_crc(jh, a)
        assert h == jh
    nc = np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2]  # not contiguous
    assert fold_array_crc(h, nc) == jc.fold_array_crc(jh, nc)
    fp = {"config": {"b": 1, "a": [1, 2]}, "device": {"platform": "cpu"}}
    assert config_crc(fp) == jc.config_crc(fp) == config_crc(dict(reversed(list(fp.items()))))


def test_consensus_single_process_is_inert_and_an_injected_desync_names_the_host():
    guard = ConsensusGuard(ConsensusConfig(), fingerprint={"seed": 1})
    assert not guard.active() and guard.check(3) == {}
    fi.activate({"desync_batch_at_step": 2})
    events = []
    guard = ConsensusGuard(ConsensusConfig(), fingerprint={"seed": 1}, event_hook=events.append)
    assert guard.active()
    batch = {"input_ids": np.arange(12, dtype=np.int32).reshape(1, 2, 6)}
    guard.fold_batch(1, batch)
    guard.check(1)  # in agreement: straggler metrics only
    guard.fold_batch(2, batch)
    with pytest.raises(DesyncError, match="host 2: data=") as e:
        guard.check(2, where="checkpoint")
    assert e.value.hosts == [2] and events[-1]["event"] == "desync" and events[-1]["desync_hosts"] == [2]


def test_consensus_gather_seam_reports_straggler_metrics():
    guard = ConsensusGuard(ConsensusConfig(param_checksum=False),
                           gather_fn=lambda v: np.stack([v, v * [1, 1, 1, 1, 5]]))
    out = guard.check(4, step_time_s=0.1)
    assert out["slowest_host"] == 1 and out["straggler_ratio"] == pytest.approx(5.0 / 3.0, rel=1e-3)


def _wd(tmp_path, **kw):
    kw.setdefault("poll_interval_s", 0.05)
    kw.setdefault("compile_grace_s", 0.5)
    kw.setdefault("ema_alpha", 0.5)
    kw.setdefault("stacks_path", str(tmp_path / "stacks.txt"))
    return WatchdogConfig(**kw)


def test_watchdog_adaptive_deadline_and_phase_graces(tmp_path):
    """JAX's deadline rule: EMA x multiplier, clamped; the compile grace
    ends at the second pet; each phase grace holds inside its phase, and
    phase time never feeds the EMA."""
    from automodel_tpu.resilience.watchdog import WatchdogConfig as JaxWatchdogConfig

    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(WatchdogConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JaxWatchdogConfig)]
    wd = Watchdog(_wd(tmp_path, multiplier=10.0, min_deadline_s=0.01, max_deadline_s=2.0, enabled=False))
    wd._ema_s = 100.0
    assert wd.deadline_s == 2.0
    wd._ema_s = 1e-6
    assert wd.deadline_s == 0.01
    wd = Watchdog(_wd(tmp_path, min_deadline_s=0.1, checkpoint_grace_s=5.0, compile_grace_s=7.0, enabled=False))
    wd._phase = "compile"
    assert wd.deadline_s == 7.0
    wd.pet(1)
    assert wd._phase == "compile"
    wd.pet(2)
    assert wd._phase is None and wd.deadline_s == 0.1
    ema = wd.ema_step_time_s
    with wd.phase("checkpoint"):
        assert wd.deadline_s == 5.0
        time.sleep(0.1)
    wd.pet(3)
    assert wd.ema_step_time_s == ema
    with pytest.raises(ValueError):
        with wd.phase("nonsense"):
            pass


def test_watchdog_fires_with_stacks_and_flight_recorder(tmp_path):
    from automodel_tpu_torch.telemetry.flight_recorder import FlightRecorder

    rec = FlightRecorder(capacity=4, path=str(tmp_path / "fr.json"))
    rec.record({"step": 7, "loss": 1.0})
    fired = []
    wd = Watchdog(_wd(tmp_path, min_deadline_s=0.2), flight_recorder=rec, on_hang=fired.append)
    wd.start()
    try:
        wd.pet(7)
        deadline = time.monotonic() + 10
        while not fired and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert fired and fired[0]["event"] == "hang" and fired[0]["step"] == 7
    assert "hang at step 7" in (tmp_path / "stacks.txt").read_text()
    dump = json.loads((tmp_path / "fr.json").read_text())
    assert dump["reason"] == "hang" and any(r.get("event") == "hang" for r in dump["records"])
    assert Watchdog(_wd(tmp_path, enabled=False)).start()._thread is None


def test_desynced_checkpoint_never_commits(tmp_path):
    """``desync_batch_at_step: 2`` with a checkpoint every step: step 1
    commits, the pre-commit check of step 2 raises DesyncError naming host
    2, nothing past step 1 commits, and the desync is in the JSONL."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = load_yaml_config(SFT_TINY)
    for k, v in (("device", "cpu"), ("step_scheduler.max_steps", 4), ("step_scheduler.ckpt_every_steps", 1),
                 ("step_scheduler.log_every_steps", 5), ("output_dir", str(tmp_path)),
                 ("logging.metrics_path", str(tmp_path / "m.jsonl")),
                 ("checkpoint", {"enabled": True, "checkpoint_dir": str(tmp_path / "ckpt")}),
                 ("fault_injection", {"desync_batch_at_step": 2})):
        cfg.set_by_path(k, v)
    r = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    r.setup()
    with pytest.raises(DesyncError, match="host 2"):
        r.run_train_validation_loop()
    committed = sorted(p.parent.name for p in (tmp_path / "ckpt").glob("*/MANIFEST.json"))
    assert committed == ["epoch_0_step_1"]
    rows = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["desync_hosts"] for r in rows if r.get("event") == "desync"] == [[2]]
    assert json.loads((tmp_path / "flight_recorder.json").read_text())["reason"] == "DesyncError"


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "AUTOMODEL_FAULT_INJECTION")}
    env["PYTHONPATH"] = REPO
    return env


def test_hang_exits_75_with_evidence_within_the_deadline(tmp_path):
    """The port's CLI in a subprocess, ``hang_at_step: 3`` after the step-1
    checkpoint committed: the watchdog fires within min_deadline + a poll,
    dumps stacks, a hang event and the flight recorder, stamps the peer
    marker, and exits 75 (JAX ``test_hang_subprocess_requeue_exit_with_evidence``)."""
    cfg = tmp_path / "cfg.yaml"
    ckpt = tmp_path / "ckpt"
    cfg.write_text(json.dumps({
        "device": "cpu", "seed": 3, "output_dir": str(tmp_path),
        "model": {"hf_config": {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 64,
                                "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                                "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 16,
                                "max_position_embeddings": 64},
                  "backend": {"attn": "sdpa", "param_dtype": "float32", "compute_dtype": "float32"}},
        "dataset": {"_target_": "automodel_tpu.data.sft.MockSFTDataset", "vocab_size": 64, "seq_length": 16,
                    "num_samples": 64},
        "dataloader": {"global_batch_size": 4},
        "step_scheduler": {"max_steps": 1000, "num_epochs": 100, "ckpt_every_steps": 1},
        "optimizer": {"name": "adamw", "lr": 1e-3},
        "checkpoint": {"enabled": True, "checkpoint_dir": str(ckpt)},
        "fault_injection": {"hang_at_step": 3, "hang_seconds": 600},
        "distributed_guard": {"watchdog": {"min_deadline_s": 2.0, "poll_interval_s": 0.2, "multiplier": 10.0}},
    }))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "automodel_tpu_torch.cli.app", "finetune", "llm", "-c", str(cfg)],
                         env=_env(), cwd=tmp_path, capture_output=True, text=True, timeout=170)
    assert out.returncode == 75, (out.stdout[-2000:], out.stderr[-3000:])
    assert "[watchdog] HANG" in out.stderr and time.monotonic() - t0 < 150
    assert "hang at step 3" in (tmp_path / "watchdog_stacks.txt").read_text()
    dump = json.loads((tmp_path / "flight_recorder.json").read_text())
    hang = [r for r in dump["records"] if r.get("event") == "hang"]
    assert dump["reason"] == "hang" and hang and hang[0]["step"] == 3
    # fired within the deadline plus one poll (host jitter allowed for)
    assert hang[0]["heartbeat_age_s"] < hang[0]["deadline_s"] + 0.2 + 1.0
    rows = [json.loads(s) for s in (tmp_path / "train_metrics.jsonl").read_text().splitlines()]
    assert any(r.get("event") == "hang" for r in rows)
    assert (ckpt / ".preempted").exists()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_GLOO_WORKER = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from automodel_tpu_torch.resilience.consensus import ConsensusConfig, ConsensusGuard, DesyncError
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
g = ConsensusGuard(ConsensusConfig(param_checksum=False), fingerprint={"seed": 1})
out = {"active": g.active()}
g.fold_batch(1, {"input_ids": np.arange(8, dtype=np.int32)})
out["agree"] = g.check(1, step_time_s=0.1 * (rank + 1))
g.fold_batch(2, {"input_ids": np.arange(8, dtype=np.int32) + rank})
try:
    g.check(2)
    out["desync"] = None
except DesyncError as e:
    out["desync"] = e.hosts
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.mark.slow
def test_consensus_over_two_gloo_processes(tmp_path):
    """Two processes on gloo: the all-gather agrees at step 1 (rank 1 the
    straggler at 2x), and a batch that differs on one rank at step 2 is a
    desync both ranks raise (two hosts, no plurality: both are named)."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r), port], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    res = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    for r in res:
        assert r["active"] and r["agree"]["slowest_host"] == 1 and r["desync"] == [0, 1]
