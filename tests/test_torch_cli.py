"""The torch port's ``serve`` CLI: stdin JSONL in, one record per request
out, on the CPU by ``--device=cpu``; bad lines answered and skipped;
unported sections and a missing CUDA refused loudly."""

import io
import json
import os

import pytest
import torch

from automodel_tpu_torch.cli import app

CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "automodel_tpu_torch", "configs", "serve_tiny_cpu.yaml",
)


def _serve(monkeypatch, capsys, lines, *overrides):
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(line + "\n" for line in lines)))
    rc = app.main(["serve", "-c", CFG, *overrides])
    out = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    return rc, [o for o in out if "completion_reason" in o], [o for o in out if "error" in o]


def test_serve_stdin_jsonl_with_a_bad_line(monkeypatch, capsys, tmp_path):
    metrics = tmp_path / "serve_metrics.jsonl"
    lines = [
        json.dumps({"id": "a", "prompt_ids": [1, 2, 3, 4, 5], "max_new_tokens": 4}),
        "this is not json",
        json.dumps({"id": "b", "prompt": "7 8 9"}),
        json.dumps({"id": "c", "prompt_ids": [1, 500]}),  # token id past the vocab
        json.dumps({"id": "d", "prompt_ids": list(range(1, 20))}),
    ]
    rc, recs, errs = _serve(
        monkeypatch, capsys, lines, "--device=cpu", f"--logging.metrics_path={metrics}"
    )
    assert rc == 1  # a bad line does not stop the batch, but is reported
    by_id = {r["request_id"]: r for r in recs}
    assert sorted(by_id) == ["a", "b", "d"]
    assert len(by_id["a"]["completion"].split()) == 4
    assert len(by_id["b"]["completion"].split()) == 8  # the config's default budget
    assert all(r["completion_reason"] == "length" and r["ttft_s"] >= 0 for r in recs)
    assert {e.get("id") for e in errs} == {None, "c"}
    assert "line 2" in errs[0]["error"]
    logged = [json.loads(s) for s in metrics.read_text().splitlines()]
    assert len(logged) == 3 and all("tokens" not in r for r in logged)


def test_serve_is_deterministic_and_greedy(monkeypatch, capsys):
    line = json.dumps({"id": "x", "prompt_ids": [3, 1, 4, 1, 5, 9, 2, 6]})
    _, first, _ = _serve(monkeypatch, capsys, [line], "--device=cpu")
    _, again, _ = _serve(monkeypatch, capsys, [line], "--device=cpu", "--serving.decode_kernel=gather")
    assert first[0]["completion"] == again[0]["completion"]


def test_serve_without_requests_exits_2(monkeypatch, capsys):
    rc, recs, _ = _serve(monkeypatch, capsys, [], "--device=cpu")
    assert rc == 2 and recs == []


@pytest.mark.parametrize(
    "override,section",
    [
        ("--serving.speculative.enabled=true", "speculative"),
        ("--serving.qos.enabled=true", "qos"),
        ("--serving.kv_spill.enabled=true", "kv_spill"),
        ("--tracing.enabled=true", "tracing"),
    ],
)
def test_unported_sections_raise_naming_the_section(monkeypatch, capsys, override, section):
    with pytest.raises(ValueError, match=section):
        _serve(monkeypatch, capsys, ['{"prompt_ids": [1]}'], "--device=cpu", override)


def test_cuda_device_without_cuda_raises(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _serve(monkeypatch, capsys, ['{"prompt_ids": [1]}'], "--device=cuda")


@pytest.mark.parametrize("command", ["finetune", "generate", "route"])
def test_other_commands_exit_2(command, capsys):
    assert app.main([command, "llm", "-c", CFG]) == 2
    assert "not ported" in capsys.readouterr().err
