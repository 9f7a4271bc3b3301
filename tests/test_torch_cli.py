"""The torch port's CLI. ``serve``: stdin JSONL in, one record per request
out, on the CPU by ``--device=cpu``; bad lines answered and skipped.
``finetune llm``: the training recipe on the CPU, JSONL rows with a falling
loss. Unported sections and a missing CUDA are refused loudly."""

import io
import json
import os

import pytest
import torch

from automodel_tpu_torch.cli import app
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu.yaml")
SFT_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")
SPEC_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_tiny_cpu_spec.yaml")


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


def test_serve_spec_tiny_cpu_yaml_end_to_end(monkeypatch, capsys, tmp_path):
    """serve_tiny_cpu_spec.yaml through the serve CLI
    (tests/test_spec_decode.py:587): a speculative engine over an int8
    pool; every stdout record and every metrics JSONL row carries the spec
    keys, the completions equal the same config's with the draft off
    (greedy), and ``return_logprobs`` is refused on the speculative engine
    as an error line."""
    lines = [json.dumps({"id": "a", "prompt": "1 2 3"}),
             json.dumps({"id": "b", "prompt_ids": [7, 8], "max_new_tokens": 4})]

    def serve(metrics, *overrides, extra=()):
        monkeypatch.setattr("sys.stdin", io.StringIO("".join(x + "\n" for x in [*lines, *extra])))
        rc = app.main(["serve", "-c", SPEC_CFG, f"--logging.metrics_path={metrics}", *overrides])
        out = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.strip()]
        return rc, {o["request_id"]: o for o in out if "completion" in o}, [o for o in out if "error" in o]

    bad = json.dumps({"id": "c", "prompt_ids": [1, 2], "return_logprobs": True})
    rc, on, errs = serve(tmp_path / "on.jsonl", extra=[bad])
    assert rc == 1 and set(on) == {"a", "b"}
    assert [e["id"] for e in errs] == ["c"] and "return_logprobs" in errs[0]["error"]
    assert len(on["b"]["completion"].split()) == 4 and len(on["a"]["completion"].split()) == 16
    for rec in on.values():
        assert rec["spec_proposed"] > 0 and 0 <= rec["spec_accept_rate"] <= 1
        assert rec["spec_accepted"] <= rec["spec_proposed"]
    logged = [json.loads(x) for x in (tmp_path / "on.jsonl").read_text().splitlines()]
    assert len(logged) == 2 and all("spec_accept_rate" in r for r in logged)
    rc, off, _ = serve(tmp_path / "off.jsonl", "--serving.speculative.enabled=false")
    assert rc == 0
    assert {k: r["completion"] for k, r in off.items()} == {k: r["completion"] for k, r in on.items()}
    assert all("spec_proposed" not in r for r in off.values())


def test_serve_without_requests_exits_2(monkeypatch, capsys):
    rc, recs, _ = _serve(monkeypatch, capsys, [], "--device=cpu")
    assert rc == 2 and recs == []


@pytest.mark.parametrize(
    "override,section",
    [
        ("--serving.speculative.enabled=true", "speculative"),
        ("--serving.kv_transfer.enabled=true", "kv_transfer"),
        ("--serving.warm_start.peer_host=127.0.0.1", "warm_start"),
        ("--serving.role=decode", "role"),
        ("--fleet.enabled=true", "fleet"),
        ("--slo.enabled=true", "slo"),
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


@pytest.mark.parametrize("command", ["grpo", "dpo", "route"])
def test_other_commands_exit_2(command, capsys):
    assert app.main([command, "llm", "-c", CFG]) == 2
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("command", ["trace", "report"])
def test_trace_and_report_are_ported(command, capsys, tmp_path):
    """``trace`` and ``report`` left ``NOT_PORTED``: each runs its module's
    ``main`` (usage exit 2 without a file, 1 on a file with nothing to
    assemble or a schema problem under ``--strict``), never "not ported"."""
    assert command not in app.NOT_PORTED
    assert app.main([command]) == 2
    bad = tmp_path / "m.jsonl"
    bad.write_text('{"step": 1, "loss": NaN, "ts": 1.0}\n')
    assert app.main([command, str(bad), *(["--strict"] if command == "report" else [])]) == 1
    assert "not ported" not in capsys.readouterr().err


def test_finetune_vlm_is_not_ported(capsys):
    assert app.main(["finetune", "vlm", "-c", SFT_CFG]) == 2
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("command", ["finetune", "pretrain"])
def test_finetune_tiny_on_cpu_writes_falling_loss(command, tmp_path):
    metrics = tmp_path / "train_metrics.jsonl"
    rc = app.main([command, "llm", "-c", SFT_CFG, "--device=cpu", f"--logging.metrics_path={metrics}"])
    assert rc == 0
    # the step records; the cost_attribution and goodput_tail events ride beside them, as in JAX
    rows = [r for r in map(json.loads, metrics.read_text().splitlines()) if "event" not in r]
    assert [r["step"] for r in rows] == list(range(1, 9))
    for r in rows:
        assert {"loss", "grad_norm", "lr", "num_label_tokens", "ts"} <= set(r)
        assert r["num_label_tokens"] == 2 * 4 * 48 and r["nonfinite"] is False
    assert all("step_time_s" in r and r["tps"] > 0 for r in rows[1:])
    losses = [r["loss"] for r in rows]
    assert losses[-1] < losses[0] - 0.5


def test_finetune_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without it")
    with pytest.raises(RuntimeError, match="torch.cuda"):
        app.main(["finetune", "llm", "-c", SFT_CFG])


@pytest.mark.parametrize(
    "override,name",
    [
        ("--checkpoint.model_save_format=torch_save", "model_save_format"),
        ("--peft.dim=8", "peft"),
        ("--qat.enabled=true", "qat"),
        ("--fault_tolerance.on_nonfinite=retry", "on_nonfinite"),
        ("--data.prefetch.depth=0", "prefetch"),
        ("--data.queries=q.jsonl", "data"),
        ("--generation.tokenizer=meta-llama/Meta-Llama-3-8B", "generation.tokenizer"),
        ("--validation_dataset.seq_length=8", "validation_dataset"),
        ("--distributed.pp=2", "distributed.pp"),
        ("--distributed.ep=2", "distributed.ep"),
        ("--logging.wandb.project=x", "wandb"),
        ("--model.backend.remat=everything", "remat"),
        ("--model.backend.fp8=true", "fp8"),
        ("--dataset._target_=automodel_tpu.data.sft.SQuAD", "SQuAD"),
        ("--model.pretrained_model_name_or_path=meta-llama/Meta-Llama-3-8B", "pretrained_model_name_or_path"),
    ],
)
def test_finetune_refuses_unported_sections_by_name(override, name, tmp_path):
    with pytest.raises(ValueError, match=name):
        app.main(["finetune", "llm", "-c", SFT_CFG, "--device=cpu", override,
                  f"--logging.metrics_path={tmp_path / 'm.jsonl'}"])


def test_jax_8b_recipe_is_refused_and_the_port_8b_config_is_accepted():
    """The committed JAX recipe asks for what the port does not run: its
    sections pass the check since its ``distributed: {dp_shard: -1}`` is
    read (FSDP2), and its SQuAD dataset is refused by name; the port's own
    8B config passes the section check at the published Llama-3-8B widths
    with the depth cut to 8."""
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig
    from automodel_tpu_torch.recipes.train_ft import build_dataset, check_sections

    jax_cfg = load_yaml_config(os.path.join(REPO, "examples", "llm_finetune", "llama3_8b_sft.yaml"))
    check_sections(jax_cfg)
    with pytest.raises(ValueError, match="SQuAD"):
        build_dataset(jax_cfg.dataset)
    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_llama3_8b.yaml"))
    check_sections(cfg)
    tc = TransformerConfig.from_hf(cfg.model.hf_config.to_dict())
    assert (tc.hidden_size, tc.num_heads, tc.num_kv_heads, tc.head_dim) == (4096, 32, 8, 128)
    assert (tc.intermediate_size, tc.vocab_size, tc.num_layers) == (14336, 128256, 8)
    assert BackendConfig.from_dict(cfg.model.backend.to_dict()).attn == "flash"
    assert cfg.dataset.seq_length == 4096 and cfg.loss_fn.name == "fused_linear_ce"


def test_chip_smoke_trains_the_committed_8b_config():
    """chip_smoke.py carries sft_llama3_8b.yaml as a dict (the card has no
    YAML reader); the two must not drift apart."""
    import importlib.util

    from automodel_tpu_torch.config.loader import load_yaml_config

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_llama3_8b.yaml"))
    assert chip_smoke.SFT_LLAMA3_8B == cfg.to_dict()


def test_chip_smoke_trains_the_committed_moe_config():
    """chip_smoke.py carries pretrain_qwen3_moe_a3b.yaml as a dict too."""
    import importlib.util

    from automodel_tpu_torch.config.loader import load_yaml_config

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "pretrain_qwen3_moe_a3b.yaml"))
    assert chip_smoke.PRETRAIN_QWEN3_MOE_A3B == cfg.to_dict()


def test_chip_smoke_serves_the_committed_spec_config():
    """chip_smoke.py phase 20 carries serve_qwen3_moe_a3b_spec.yaml as a
    dict: Qwen3-30B-A3B at its published 48 layers with the Qwen3-0.6B
    draft (28 layers), sharing the vocabulary; the two must not drift."""
    import importlib.util

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.serving.engine import ServeConfig

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = load_yaml_config(os.path.join(REPO, "automodel_tpu_torch", "configs", "serve_qwen3_moe_a3b_spec.yaml"))
    assert chip_smoke.SERVE_QWEN3_MOE_A3B_SPEC == cfg.to_dict()
    serving = ServeConfig.from_dict(cfg.serving.to_dict())
    draft = serving.speculative.draft["hf_config"]
    assert serving.speculative.enabled and serving.speculative.k == 4
    assert cfg.model.hf_config.num_hidden_layers == 48 and draft["num_hidden_layers"] == 28
    assert draft["vocab_size"] == cfg.model.hf_config.vocab_size == 151936


GEMMA_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "gemma2_tiny_cpu.yaml")


def test_pretrain_gemma2_tiny_on_cpu_writes_falling_loss(tmp_path):
    """The Gemma 2 path (attention soft cap inside the flash kernels' plain
    versions, final cap in fused_linear_ce): 8 rows, a falling loss; without
    --device=cpu on a host with no card it raises naming torch.cuda."""
    metrics = tmp_path / "train_metrics.jsonl"
    rc = app.main(["pretrain", "llm", "-c", GEMMA_CFG, "--device=cpu", f"--logging.metrics_path={metrics}"])
    assert rc == 0
    rows = [r for r in map(json.loads, metrics.read_text().splitlines()) if "event" not in r]
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert all(r["nonfinite"] is False and r["num_label_tokens"] == 2 * 4 * 48 for r in rows)
    assert rows[-1]["loss"] < rows[0]["loss"] - 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda"):
            app.main(["pretrain", "llm", "-c", GEMMA_CFG, f"--logging.metrics_path={metrics}"])
