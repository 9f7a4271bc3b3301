"""The port's goodput ledger against the JAX package's
(``tests/test_goodput.py``): attempts chained across restarts, an inferred
tail for a killed attempt, preemption-lost and rollback-discard
reclassification, the rollup and the report equal to JAX's on the same
records, a clean tiny run whose segments sum to its wall clock, and a
SIGTERM → exit 75 → resume cycle through the port's CLI that leaves one
joined ledger."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from automodel_tpu_torch.telemetry.goodput import SEGMENT_KINDS, GoodputLedger, _read_records, format_report, rollup
from automodel_tpu_torch.telemetry.goodput import main as goodput_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_TINY = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")


def _two_attempts(path):
    """A first attempt with windows, checkpoint timings, an eval segment and
    a rollback, killed without a close; a second that resumes at step 4
    and exits cleanly."""
    led = GoodputLedger(path, t_start=time.time() - 20.0)
    led.loop_started()
    led.compile_window(1.5, 0.1, step=1)
    led.window(4.0, 0.4, steps=4, step_to=5)
    led.on_ckpt_timing("ckpt_save", 0.25, step=4)
    with led.segment("eval", step=5):
        time.sleep(0.01)
    led.window(3.0, 0.3, steps=3, step_to=8)
    led.on_rollback(fail_step=8, restored_step=6)
    led.window(2.0, 0.1, steps=2, step_to=8)
    led2 = GoodputLedger(path, t_start=time.time())
    led2.on_resume(4)
    led2.loop_started()
    led2.window(2.0, 0.2, steps=2, step_to=6)
    led2.on_ckpt_timing("ckpt_drain", 0.05, step=6)
    led2.close(reason="exit")
    return led, led2


def test_ledger_chains_attempts_and_matches_jax_rollup(tmp_path):
    """The port's ledger writes the records JAX's does; JAX's rollup and the
    port's over the same file are the same dict, and so is the report."""
    from automodel_tpu.telemetry import goodput as jg

    assert SEGMENT_KINDS == jg.SEGMENT_KINDS
    led, led2 = _two_attempts(tmp_path / "goodput.jsonl")
    assert led2.restart_count == 1 and led2.envelope == {"attempt_id": led2.attempt_id, "restart_count": 1}
    recs = _read_records(tmp_path / "goodput.jsonl")
    assert [r["event"] for r in recs if r["event"] != "segment"] == [
        "attempt", "attempt_end", "attempt", "resume", "attempt_end"]
    assert next(r for r in recs if r["event"] == "attempt_end")["inferred"] is True
    events = [{"event": "hang", "step": 8, "ts": time.time()}]
    assert rollup(recs) == jg.rollup(jg._read_records(tmp_path / "goodput.jsonl"))
    assert rollup(recs, events) == jg.rollup(recs, events)
    assert format_report(rollup(recs)) == jg.format_report(jg.rollup(recs))
    a1, a2 = rollup(recs)["attempts"]
    assert a1["steps_lost"] == 4 and a1["steps_discarded"] == 2 and a2["resumed_from_step"] == 4


def test_ledger_disabled_is_a_no_op(tmp_path):
    led = GoodputLedger(tmp_path / "goodput.jsonl", enabled=False)
    led.loop_started()
    led.window(1.0, 0.0, steps=1, step_to=1)
    led.close(reason="exit")
    assert not (tmp_path / "goodput.jsonl").exists() and led.snapshot()["segments"] == {}


def test_goodput_cli_renders_and_json(tmp_path, capsys):
    _two_attempts(tmp_path / "goodput.jsonl")
    assert goodput_main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "whole run — 2 attempt(s)" in out and "preemption_lost" in out
    assert goodput_main([str(tmp_path / "goodput.jsonl"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["run"]["n_attempts"] == 2
    from automodel_tpu_torch.cli import app

    assert app.main(["goodput", str(tmp_path / "nothing_here")]) != 0


def test_clean_run_segments_sum_to_wall_clock(tmp_path):
    """A tiny CPU run with a checkpoint cadence: startup, compile, step,
    input_wait and checkpoint segments, the envelope on every record, the
    ckpt stamps on the next record, and the segments within 5% of the
    attempt's wall clock."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = load_yaml_config(SFT_TINY)
    for k, v in (("device", "cpu"), ("step_scheduler.max_steps", 4), ("step_scheduler.ckpt_every_steps", 2),
                 ("output_dir", str(tmp_path)), ("logging.metrics_path", str(tmp_path / "m.jsonl")),
                 ("checkpoint", {"enabled": True, "checkpoint_dir": str(tmp_path / "ckpt")})):
        cfg.set_by_path(k, v)
    r = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    r.setup()
    r.run_train_validation_loop()
    roll = rollup(_read_records(tmp_path / "goodput.jsonl"))
    (a,) = roll["attempts"]
    assert a["end_reason"] == "exit" and a["unattributed_s"] <= 0.05 * a["wall_s"]
    assert {"startup", "compile", "step", "input_wait", "ckpt_save"} <= set(a["segments"])
    rows = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert all(x["attempt_id"] == a["attempt_id"] and x["restart_count"] == 0 for x in rows)
    assert any("ckpt_save_s" in x for x in rows) and any(x.get("window_excluded_s", 0) > 0 for x in rows)


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "AUTOMODEL_FAULT_INJECTION")}
    env["PYTHONPATH"] = REPO
    return env


def test_sigterm_drains_saves_exits_75_and_the_restart_joins_the_ledger(tmp_path):
    """SIGTERM mid-run: the loop drains at the next step boundary, joins
    the prefetch producers, commits the emergency checkpoint at that step
    and exits 75. The restart resumes there, and ``goodput`` shows one
    ledger of two chained attempts, the first ended ``preempted``, each
    summing to its wall clock within 5%."""
    argv = [sys.executable, "-m", "automodel_tpu_torch.cli.app", "finetune", "llm", "-c", SFT_TINY, "--device=cpu",
            f"--output_dir={tmp_path}", f"--logging.metrics_path={tmp_path / 'm.jsonl'}",
            "--checkpoint.enabled=true", f"--checkpoint.checkpoint_dir={tmp_path / 'ckpt'}",
            "--data.prefetch.depth=2", "--fault_injection.slow_collate_ms=150", "--step_scheduler.num_epochs=100",
            "--step_scheduler.max_steps=1000", "--step_scheduler.ckpt_every_steps=1000"]
    proc = subprocess.Popen(argv, env=_env(), cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                steps = [json.loads(s).get("step") for s in (tmp_path / "m.jsonl").read_text().splitlines()]
            except (OSError, ValueError):
                steps = []
            if len([s for s in steps if s]) >= 3:
                break
            if proc.poll() is not None or time.time() > deadline:
                pytest.fail(f"the run never logged 3 steps: {proc.communicate()[1][-2000:]}")
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, err[-3000:]
    committed = sorted(int(p.parent.name.rsplit("_", 1)[1]) for p in (tmp_path / "ckpt").glob("*/MANIFEST.json"))
    assert len(committed) == 1
    saved = committed[0]
    out2 = subprocess.run(argv[:-2] + [f"--step_scheduler.max_steps={saved + 2}"], env=_env(), cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert out2.returncode == 0, out2.stderr[-2000:]
    rows = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [x["resumed_from_step"] for x in rows if x.get("event") == "resume"] == [saved]
    assert [x["step"] for x in rows if "loss" in x and x["restart_count"] == 1] == [saved + 1, saved + 2]
    roll = rollup(_read_records(tmp_path / "goodput.jsonl"))
    a1, a2 = roll["attempts"]
    assert a1["end_reason"] == "preempted" and a2["resumed_from_step"] == saved and a1["steps_lost"] == 0
    for a in (a1, a2):
        assert a["unattributed_s"] <= 0.05 * a["wall_s"], a
    assert goodput_main([str(tmp_path)]) == 0
