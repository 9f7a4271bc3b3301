"""The port's fault injection against the JAX package's
(``resilience/fault_injection.py`` and its tests in
``tests/test_distributed_guard.py`` / ``test_goodput.py``): the training
knobs keep JAX's names and defaults, the serving and fleet knobs are
refused by name, the env var arms a subprocess, and each knob drives its
recovery path through the port's recipe: an injected crash dumps the
flight recorder, NaN grads under ``skip`` are skipped with the group norm
and a triggered capture as evidence, a corrupted checkpoint is walked back,
failed I/O is retried, a slow collate lands in the input wait."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from automodel_tpu_torch.resilience import fault_injection as fi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_TINY = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")


@pytest.fixture(autouse=True)
def _reset():
    fi.activate(None)
    yield
    fi.activate(None)


def test_training_knobs_keep_jax_names_and_defaults_and_serving_knobs_are_refused():
    from automodel_tpu.resilience import fault_injection as jfi

    jax_fields = {f.name: f.default for f in dataclasses.fields(jfi.FaultInjectionConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(fi.FaultInjectionConfig)}
    assert all(jax_fields[k] == v for k, v in port_fields.items())
    assert set(jax_fields) == set(port_fields) | set(fi.SERVING_KNOBS)
    with pytest.raises(ValueError, match="serve_hang_at_step.*not ported"):
        fi.activate({"serve_hang_at_step": 3})
    with pytest.raises(TypeError, match="bogus"):
        fi.activate({"bogus": 1})
    assert fi.activate({}) is None and fi.active_injector() is None  # an empty section arms nothing
    assert fi.activate({"hang_at_step": 3}) is not None


def test_env_var_arms_a_subprocess():
    code = ("from automodel_tpu_torch.resilience.fault_injection import active_injector as a; "
            "i = a(); print(i.config.straggle_host, i.config.straggle_ms)")
    env = dict(os.environ, PYTHONPATH=REPO, AUTOMODEL_FAULT_INJECTION='{"straggle_host": 0, "straggle_ms": 5}')
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=60)
    assert out.stdout.split() == ["0", "5"], out.stderr
    env["AUTOMODEL_FAULT_INJECTION"] = '{"kv_push_drop_ack": true}'
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "kv_push_drop_ack" in out.stderr


def test_injector_hooks_fire_once_and_only_where_armed(tmp_path):
    import time

    inj = fi.FaultInjector(fi.FaultInjectionConfig(hang_at_step=2, hang_seconds=0.2, straggle_host=0,
                                                   straggle_ms=60, straggle_at_step=3, fail_io_attempts=2,
                                                   fail_io_op="manifest", corrupt_ckpt_file="state/*"))
    t0 = time.perf_counter()
    inj.maybe_hang(1)
    inj.maybe_straggle(2)
    assert time.perf_counter() - t0 < 0.05
    inj.maybe_hang(2)
    inj.maybe_hang(2)  # once
    inj.maybe_straggle(3)
    assert 0.25 < time.perf_counter() - t0 < 1.0
    for _ in range(2):
        with pytest.raises(OSError, match="injected I/O failure"):
            inj.check_io("manifest_commit")
    inj.check_io("manifest_commit")  # the third attempt passes
    inj.check_io("hf_write")  # another op is never failed
    (tmp_path / "state").mkdir()
    (tmp_path / "state" / "a.bin").write_bytes(b"\x00" * 256)
    inj.after_checkpoint_save(tmp_path)
    assert (tmp_path / "state" / "a.bin").read_bytes() != b"\x00" * 256
    with pytest.raises(fi.InjectedFault, match="step 4"):
        fi.FaultInjector(fi.FaultInjectionConfig(die_at_step=4, die_mode="exception")).maybe_die(4)


def _recipe(tmp_path, **sections):
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = load_yaml_config(SFT_TINY)
    for k, v in (("device", "cpu"), ("step_scheduler.max_steps", 4), ("output_dir", str(tmp_path)),
                 ("logging.metrics_path", str(tmp_path / "m.jsonl")), *sections.items()):
        cfg.set_by_path(k, v)
    r = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    r.setup()
    return r


def _rows(tmp_path):
    return [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]


def test_injected_crash_dumps_the_flight_recorder(tmp_path):
    r = _recipe(tmp_path, fault_injection={"die_at_step": 3, "die_mode": "exception"})
    with pytest.raises(fi.InjectedFault, match="step 3"):
        r.run_train_validation_loop()
    dump = json.loads((tmp_path / "flight_recorder.json").read_text())
    assert dump["reason"] == "InjectedFault" and [x["step"] for x in dump["records"] if "tokens" in x][-1] == 2
    assert dump["fingerprint"]["attempt"]["restart_count"] == 0
    roll = __import__("automodel_tpu_torch.telemetry.goodput", fromlist=["rollup"])
    assert roll.rollup(roll._read_records(tmp_path / "goodput.jsonl"))["attempts"][0]["end_reason"] == "crash"


def test_nan_grads_under_skip_are_skipped_with_evidence(tmp_path):
    """``nan_grads_at_step: 2`` under ``on_nonfinite: skip``: step 2 logs
    ``nonfinite: true, skipped: true`` with a non-finite group norm, a
    triggered capture with reason ``nonfinite`` follows, later records
    carry ``skipped_steps_total: 1`` and the run ends with a finite loss."""
    r = _recipe(tmp_path, fault_tolerance={"on_nonfinite": "skip"}, fault_injection={"nan_grads_at_step": 2})
    last = r.run_train_validation_loop()
    rows = _rows(tmp_path)
    s2 = next(x for x in rows if x.get("step") == 2 and "loss" in x)
    assert s2["nonfinite"] is True and s2["skipped"] is True and s2["grad_nonfinite_count"] > 0
    assert s2["grad_norm/layers"] is None and s2["grad_norm/layers_nonfinite"] is True
    caps = [x for x in rows if x.get("event") == "trace_capture" and x.get("capture_path")]
    assert [c["reason"] for c in caps] == ["nonfinite"] and os.path.exists(caps[0]["memory_profile"])
    assert last["skipped_steps_total"] == 1 and last["step"] == 4


def test_corrupt_checkpoint_is_walked_back_and_failed_io_retried(tmp_path, caplog):
    """The newest checkpoint's state corrupted after commit, and the first
    two manifest commits failed: the retries absorb the failures, the
    restart quarantines the corrupt dir and resumes from the older one."""
    ck = {"enabled": True, "checkpoint_dir": str(tmp_path / "ckpt")}
    r = _recipe(tmp_path, checkpoint=ck, **{"step_scheduler.ckpt_every_steps": 2})
    r.run_train_validation_loop()
    r = _recipe(tmp_path, checkpoint=ck, **{"step_scheduler.ckpt_every_steps": 2, "step_scheduler.max_steps": 6,
                                            "fault_injection": {"corrupt_ckpt_file": "state/*.distcp",
                                                                "fail_io_attempts": 2,
                                                                "fail_io_op": "manifest_commit"}})
    r.run_train_validation_loop()
    assert "attempt 2/3 failed" in caplog.text
    fi.activate(None)
    r = _recipe(tmp_path, checkpoint=ck, **{"step_scheduler.max_steps": 6})
    assert list((tmp_path / "ckpt").glob("*.corrupt*")) and r.state.step == 4


def test_slow_collate_lands_in_the_input_wait(tmp_path):
    r = _recipe(tmp_path, fault_injection={"slow_collate_ms": 40})
    r.run_train_validation_loop()
    rows = [x for x in _rows(tmp_path) if "host_input_wait_s" in x]
    # grad_acc 2: two collates a step on the sync path
    assert rows and all(x["host_input_wait_s"] > 0.075 for x in rows)
