"""The port's metrics linter and summary (``automodel_tpu_torch/telemetry/
report.py``) against the JAX package's on the same files: clean training
rows, a bare ``NaN``, a null without its marker, a step rewind with and
without a resume marker, serving records with spans (one missing a key,
one with a negative duration), and bench results. Then ``report --strict``
over what the port's tiny CPU finetune and serve write."""

import io
import json
import os

import pytest

from automodel_tpu.telemetry import report as jrep
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.telemetry import report as trep
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")
TRACED_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu_traced.yaml")

_ROW = {"loss": 2.5, "grad_norm": 1.0, "lr": 1e-3, "tps": 100.0, "step_time_s": 0.1, "ts": 1.0}
_SPAN = {"event": "span", "trace_id": "t" * 32, "span_id": "a" * 16, "stage": "serve", "process": "p",
         "ts": 2.0, "duration_s": 0.25}
_SERVE = {"event": "serve_request", "request_id": "r", "completion_reason": "length", "ttft_s": 0.1,
          "tenant": "a", "tier": "interactive", "block_occupancy": 0.5, "queue_s": 0.01, "ts": 2.5}

FILES = {
    "clean_training": [json.dumps({**_ROW, "step": s, "loss": 3.0 - s / 10}) for s in range(1, 6)],
    "bare_nan": [json.dumps({**_ROW, "step": 1}), '{"step": 2, "loss": NaN, "ts": 1.0}'],
    "null_without_marker": [json.dumps({**_ROW, "step": 1, "loss": None})],
    "null_with_marker": [json.dumps({**_ROW, "step": 1, "loss": None, "loss_nonfinite": True})],
    "rewind_without_marker": [json.dumps({**_ROW, "step": s}) for s in (1, 2, 3, 2)],
    "rewind_after_resume": [json.dumps({**_ROW, "step": s}) for s in (1, 2, 3)]
    + [json.dumps({"event": "resume", "resumed_from_step": 2, "ts": 1.0}), json.dumps({**_ROW, "step": 3})],
    "serving_with_spans": [
        json.dumps(_SPAN),
        json.dumps({**_SPAN, "span_id": "b" * 16, "stage": "queue", "parent_id": "a" * 16, "duration_s": 0.01}),
        json.dumps(_SERVE),
    ],
    "span_missing_key": [json.dumps({k: v for k, v in _SPAN.items() if k != "span_id"}), json.dumps(_SERVE)],
    "negative_duration": [json.dumps({**_SPAN, "duration_s": -0.5}), json.dumps({**_SERVE, "ttft_s": -1.0})],
    "not_json": ["{not json", "[1, 2]", json.dumps({"step": "three", "ts": 1.0})],
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_lint_summary_and_table_equal_jax(name, tmp_path, capsys):
    path = tmp_path / f"{name}.jsonl"
    path.write_text("\n".join(FILES[name]) + "\n")
    (tr, tp), (jr, jp) = trep.lint_metrics_jsonl(str(path)), jrep.lint_metrics_jsonl(str(path))
    assert tr == jr and tp == jp
    ts, js = trep.summarize_metrics(tr), jrep.summarize_metrics(jr)
    assert ts == js
    assert trep.format_table(ts) == jrep.format_table(js)
    # the CLI's exit codes and output: 0 clean, 1 under --strict with a
    # problem, as JAX's ``report``
    for strict in ([], ["--strict"]):
        t_rc = app.main(["report", str(path), *strict])
        t_out = capsys.readouterr()
        j_rc = jrep.main([str(path), *strict])
        j_out = capsys.readouterr()
        assert (t_rc, t_out.out, t_out.err) == (j_rc, j_out.out, j_out.err)
    assert bool(tp) == (name not in ("clean_training", "null_with_marker", "rewind_after_resume",
                                     "serving_with_spans"))


def test_validate_bench_result_and_percentile_equal_jax():
    results = [
        {"value": 0.0, "dense_failure": None},
        {"value": None},
        {"value": None, "dense_failure": "oom"},
        {"serve_accept_rate": 0.0, "gen_decode_tps": 12.0},
        {"serve_spill_tokens_per_s": None, "serve_spill_failure": "off"},
    ]
    for r in results:
        assert trep.validate_bench_result(r) == jrep.validate_bench_result(r)
    vals = [3.0, 1.0, 4.0, 1.5, 9.0]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert trep.percentile(vals, q) == jrep.percentile(vals, q)
    assert trep.percentile([], 0.5) is None
    assert app.main(["report"]) == 2


def test_report_strict_accepts_the_port_finetune_and_serve_jsonl(tmp_path, monkeypatch, capsys):
    train = tmp_path / "train.jsonl"
    assert app.main(["finetune", "llm", "-c", SFT_CFG, "--device=cpu", "--step_scheduler.max_steps=3",
                     f"--logging.metrics_path={train}"]) == 0
    serve = tmp_path / "serve.jsonl"
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps({"id": "a", "prompt_ids": [1, 2, 3, 4, 5]}) + "\n"))
    assert app.main(["serve", "-c", TRACED_CFG, f"--logging.metrics_path={serve}"]) == 0
    capsys.readouterr()
    for path in (train, serve):
        assert app.main(["report", str(path), "--strict"]) == 0, capsys.readouterr().err
        assert jrep.main([str(path), "--strict"]) == 0
    summary = trep.summarize_metrics(trep.lint_metrics_jsonl(str(serve))[0])
    assert summary["serve_requests"] == 1 and summary["span_traces"] == 1
    assert trep.summarize_metrics(trep.lint_metrics_jsonl(str(train))[0])["train_steps_logged"] == 3
