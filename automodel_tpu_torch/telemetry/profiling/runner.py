"""The ``profile`` command, port of
``automodel_tpu/telemetry/profiling/runner.py``: generated PROFILE
artifacts.

    python -m automodel_tpu_torch.cli.app profile -c cfg.yaml [--profiling.mode=train|generate] [--device=cpu]

One command opens a ``torch.profiler`` window around N steps of the
configured workload, parses the capture and writes under
``<output_dir>/profile/``:

- ``report.json``  — the structured report (trace decomposition + top-K
  ops + scope attribution + the counted cost)
- ``PROFILE.md``   — its markdown rendering
- ``trace/``       — the raw capture (Chrome-trace JSON)

Modes (``profiling.mode``):

- ``train`` (default) — the training recipe for ``trace_warmup_steps``
  steps, then ``trace_steps`` more inside the window (the recipe's own
  ``telemetry.profile`` window), then stop. Step 1 is counted (cost.py),
  so the report carries ``cost.train_step`` and the run metrics
  ``mfu_measured_pct`` where the peak is known (``profiling.peak_tflops``
  on the CPU).
- ``generate`` — the generation engine on ``generation.bench_batch`` x
  ``bench_prompt_len`` random prompts: the first ``generate_ids`` call
  (counted: ``cost.generate_ids``) builds and warms up, the second is
  traced.

Prints one ``{"event": "profile_report", ...}`` JSON line naming the
artifacts, with ``kernel_events`` (0 when the trace holds no device
events: a CPU run, or a profiler without CUDA activity).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)


def _plain(section: Any) -> Any:
    return section.to_dict() if hasattr(section, "to_dict") else section


def _resolve_output_dir(cfg: Any) -> Path:
    out = cfg.get("output_dir", None)
    if out is None:
        out = Path("runs") / time.strftime("profile_%Y%m%d_%H%M%S")
    return Path(out)


def _write_report(out_dir: Path, report: dict, title: str, context: dict) -> tuple[Path, Path]:
    from automodel_tpu_torch.telemetry.profiling.trace import render_markdown

    out_dir.mkdir(parents=True, exist_ok=True)
    json_path = out_dir / "report.json"
    json_path.write_text(json.dumps(report, indent=2, default=str) + "\n")
    md_path = out_dir / "PROFILE.md"
    md_path.write_text(render_markdown(report, title=title, context=context))
    return json_path, md_path


def _profile_train(cfg: Any, pcfg, out_dir: Path) -> dict:
    from automodel_tpu_torch.config.loader import ConfigNode
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    warmup = max(int(pcfg.trace_warmup_steps), 1)
    steps = max(int(pcfg.trace_steps), 1)
    trace_dir = Path(pcfg.trace_dir) if pcfg.trace_dir else out_dir / "trace"
    d = _plain(cfg)
    d["output_dir"] = str(out_dir.parent) if out_dir.name == "profile" else str(out_dir)
    sched = dict(d.get("step_scheduler") or {})
    sched["max_steps"] = warmup + steps
    d["step_scheduler"] = sched
    tel = dict(d.get("telemetry") or {})
    # steps are numbered from 1; the window covers (warmup, warmup + steps]
    tel["profile"] = {"enabled": True, "trace_dir": str(trace_dir), "start_step": warmup + 1,
                      "end_step": warmup + 1 + steps}
    d["telemetry"] = tel
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(d))
    recipe.setup()
    last = recipe.run_train_validation_loop()
    costs = {"train_step": dict(recipe._step_cost)} if getattr(recipe, "_step_cost", None) else {}
    return {
        "trace_dir": str(trace_dir),
        "steps_traced": steps,
        "last_metrics": {k: v for k, v in (last or {}).items()
                         if isinstance(v, (int, float, str)) and not isinstance(v, bool)},
        "cost": costs,
    }


def _profile_generate(cfg: Any, pcfg, out_dir: Path) -> dict:
    import numpy as np

    from automodel_tpu_torch.generation.engine import GenerationConfig, GenerationEngine, build_auto_from_cfg
    from automodel_tpu_torch.telemetry.profiling import record_program_cost
    from automodel_tpu_torch.utils.profiler import start_trace, stop_trace

    trace_dir = Path(pcfg.trace_dir) if pcfg.trace_dir else out_dir / "trace"
    gen_section = dict(_plain(cfg.get("generation", None)) or {})
    for k in ("prompts", "prompt_ids", "tokenizer", "enabled"):
        gen_section.pop(k, None)
    batch = int(gen_section.pop("bench_batch", 2))
    prompt_len = int(gen_section.pop("bench_prompt_len", 16))
    auto = build_auto_from_cfg(cfg)
    engine = GenerationEngine(auto, GenerationConfig.from_dict(gen_section))
    vocab = int(auto.model.config.vocab_size)
    prompts = np.random.default_rng(0).integers(1, vocab, size=(batch, prompt_len)).tolist()
    costs: dict = {}
    record_program_cost(costs, "generate_ids", engine.generate_ids, prompts)  # build + warm-up, counted
    start_trace(str(trace_dir))
    try:
        out = engine.generate_ids(prompts)
    finally:
        stop_trace()
    return {
        "trace_dir": str(trace_dir),
        "steps_traced": 1,
        "last_metrics": {"ttft_s": out["ttft_s"], "decode_tps": out["decode_tps"], "gen_tokens": out["gen_tokens"]},
        "cost": costs,
    }


def main(cfg: Any) -> int:
    """→ process exit code. Prints one JSON line naming the artifacts."""
    from automodel_tpu_torch.telemetry.profiling import ProfilingConfig
    from automodel_tpu_torch.telemetry.profiling.trace import analyze_trace, load_trace_events

    section = dict(_plain(cfg.get("profiling", None)) or {})
    pcfg = ProfilingConfig.from_dict(section)
    mode = pcfg.mode
    if mode not in ("train", "generate"):
        print(f"profiling.mode must be train|generate, got {mode!r}")
        return 2
    out_dir = _resolve_output_dir(cfg) / "profile"
    run = _profile_train(cfg, pcfg, out_dir) if mode == "train" else _profile_generate(cfg, pcfg, out_dir)

    events = load_trace_events(run["trace_dir"])
    report = analyze_trace(events, top_k=pcfg.top_k)
    report["mode"] = mode
    report["steps_traced"] = run["steps_traced"]
    report["cost"] = run["cost"]
    report["run_metrics"] = run["last_metrics"]
    context = {"mode": mode, "steps_traced": run["steps_traced"], "trace_dir": run["trace_dir"],
               **{f"run.{k}": v for k, v in run["last_metrics"].items()}}
    json_path, md_path = _write_report(out_dir, report, title=f"PROFILE ({mode})", context=context)
    print(json.dumps({
        "event": "profile_report",
        "report_json": str(json_path),
        "report_md": str(md_path),
        "trace_dir": run["trace_dir"],
        "op_events": report["op_events"],
        "kernel_events": report["kernel_events"],
        "device_busy_fraction": report["device_busy_fraction"],
        "comm_fraction": report["comm_fraction"],
    }), flush=True)
    return 0
