"""CLI entry point of the torch port.

    python -m automodel_tpu_torch.cli.app serve -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app finetune llm -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app benchmark llm -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app kd llm -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app generate -c cfg.yaml [--prompt '1 2 3'] [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app verify-ckpt <dir> [--no-checksums] [--json]
    python -m automodel_tpu_torch.cli.app trace <metrics.jsonl> [...] [--chrome out.json] [--md out.md] [--trace-id P]
    python -m automodel_tpu_torch.cli.app report <metrics.jsonl> [--strict]
    python -m automodel_tpu_torch.cli.app profile -c cfg.yaml [--profiling.mode=train|generate] [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app goodput <run-dir | goodput.jsonl> [--json]

``serve`` runs the serving front (serving/server.py): a local HTTP server
when ``serving.http.port`` is set, the stdin-JSONL front otherwise; both
drain on SIGTERM and start the stall watchdog;
``finetune llm`` and ``pretrain llm`` run the training recipe
(recipes/train_ft.py), ``benchmark llm`` the benchmark recipe
(recipes/benchmark.py) and ``kd llm`` the knowledge-distillation recipe
(recipes/kd.py), as ``automodel_tpu/cli/app.py:184-187`` routes them;
``generate`` runs the KV-cache generation engine on token-id prompts
(generation/engine.py), as ``automodel_tpu/cli/app.py:90-97`` routes it.
All run on the config's ``device`` (``cuda`` unless ``--device=cpu``).
``verify-ckpt`` audits a checkpoint tree's manifests without loading a
tensor (checkpoint/verify.py; exit 0 resumable, 1 corrupt, 2 usage), as
``automodel_tpu/cli/app.py:81-86`` routes it. ``trace`` assembles the span
records of serve's metrics JSONLs into per-request waterfalls (markdown
and a Chrome trace; telemetry/tracing.py) and ``report`` lints and
summarizes a metrics JSONL (telemetry/report.py; ``--strict`` exits 1 on
any schema problem), as ``automodel_tpu/cli/app.py:61-80`` routes them;
neither reads a config or touches a device. ``profile`` opens a
``torch.profiler`` window around a few steps of the training recipe (or
two ``generate_ids`` calls) and writes ``report.json`` and ``PROFILE.md``
under ``<output_dir>/profile/`` (telemetry/profiling/runner.py);
``goodput`` rolls a run's ``goodput.jsonl`` into a per-attempt and
whole-run wall-clock decomposition (telemetry/goodput.py), as
``automodel_tpu/cli/app.py:53-57, 126-131`` route them. A training run that
is preempted (SIGTERM) after its emergency checkpoint committed exits 75
(1 with nothing committed), a cross-process desync exits 1, and a crash
while a peer's preemption marker is fresh exits 75, as JAX's
``main`` maps them (:206-240). The JAX package's other commands are not
ported yet; each exits 2 saying so.

A config with a ``distributed:`` section runs the recipe commands and
``generate`` on a process group, joined before the command as JAX's
``main`` joins its runtime (:92-181) and torn down after it:

    torchrun --nproc_per_node N -m automodel_tpu_torch.cli.app finetune llm -c cfg.yaml
"""

from __future__ import annotations

import sys

from automodel_tpu_torch.config.arg_parser import parse_args_and_load_config

TRAIN_COMMANDS = ("finetune", "pretrain", "benchmark", "kd")
NOT_PORTED = ("dpo", "grpo", "mine", "route", "fleet-status")


def _usage() -> str:
    return (
        "usage: python -m automodel_tpu_torch.cli.app serve -c config.yaml "
        "[--device=cpu] [--dotted.key=value ...]  (stdin JSONL in, one JSON "
        "line per finished request out; with --serving.http.port=N an HTTP front)\n"
        "       python -m automodel_tpu_torch.cli.app {finetune|pretrain|benchmark|kd} llm -c config.yaml "
        "[--device=cpu] [--dotted.key=value ...]\n"
        "       python -m automodel_tpu_torch.cli.app generate -c config.yaml [--prompt '1 2 3'] "
        "[--device=cpu] [--dotted.key=value ...]\n"
        "       python -m automodel_tpu_torch.cli.app verify-ckpt <dir> [--no-checksums] [--json]\n"
        "       python -m automodel_tpu_torch.cli.app trace <metrics.jsonl> [...] "
        "[--chrome out.json] [--md out.md] [--trace-id PREFIX]\n"
        "       python -m automodel_tpu_torch.cli.app report <metrics.jsonl> [--strict]\n"
        "       python -m automodel_tpu_torch.cli.app profile -c config.yaml [--profiling.mode=train|generate] "
        "[--device=cpu] [--dotted.key=value ...]\n"
        "       python -m automodel_tpu_torch.cli.app goodput <run-dir | goodput.jsonl> [--json]"
    )


def _not_ported(what: str) -> int:
    print(
        f"{what} is not ported to the torch backend yet; use "
        f"python -m automodel_tpu.cli.app {what} for the JAX package",
        file=sys.stderr,
    )
    return 2


def _crash_is_preemption_collateral(cfg) -> bool:
    """A crash while a peer's preemption marker in the shared checkpoint
    root is fresh is collateral of that preemption (JAX :30-48)."""
    from automodel_tpu_torch.checkpoint.checkpointer import CheckpointingConfig
    from automodel_tpu_torch.resilience import peer_preemption_fresh

    ccfg = cfg.get("checkpoint", None)
    ccfg = dict(ccfg.to_dict() if hasattr(ccfg, "to_dict") else (ccfg or {}))
    if not ccfg.get("enabled", False):
        return False
    return peer_preemption_fresh(ccfg.get("checkpoint_dir", CheckpointingConfig.checkpoint_dir))


def _init_distributed(cfg) -> bool:
    """Join the process group when the config has a ``distributed:``
    section (parallel/mesh.initialize_distributed: torchrun's environment,
    NCCL on the config's CUDA device, gloo under ``device: cpu``)."""
    if cfg.get("distributed", None) is None:
        return False
    from automodel_tpu_torch.device import resolve_device
    from automodel_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(resolve_device(cfg.get("device", None)))
    return True


def _run_distributed(cfg, fn) -> int:
    """``fn()`` inside the process group the config asks for, if any."""
    joined = _init_distributed(cfg)
    try:
        return fn()
    finally:
        if joined:
            from automodel_tpu_torch.parallel.mesh import destroy_distributed

            destroy_distributed()


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0 if argv else 2
    command = argv[0]
    if command == "verify-ckpt":
        from automodel_tpu_torch.checkpoint.verify import main as verify_main

        return verify_main(argv[1:])
    if command == "trace":
        from automodel_tpu_torch.telemetry.tracing import main as trace_main

        return trace_main(argv[1:])
    if command == "report":
        from automodel_tpu_torch.telemetry.report import main as report_main

        return report_main(argv[1:])
    if command == "goodput":
        from automodel_tpu_torch.telemetry.goodput import main as goodput_main

        return goodput_main(argv[1:])
    if command == "profile":
        from automodel_tpu_torch.telemetry.profiling.runner import main as profile_main

        return profile_main(parse_args_and_load_config(argv[1:]))
    if command == "serve":
        from automodel_tpu_torch.serving.server import main as serve_main

        return serve_main(parse_args_and_load_config(argv[1:]))
    if command == "generate":
        from automodel_tpu_torch.generation.engine import main as generate_main

        cfg = parse_args_and_load_config(argv[1:])
        return _run_distributed(cfg, lambda: generate_main(cfg))
    if command in TRAIN_COMMANDS:
        domain = argv[1] if len(argv) > 1 else ""
        if domain != "llm":
            return _not_ported(f"{command} {domain}".strip())
        if command == "benchmark":
            from automodel_tpu_torch.recipes.benchmark import main as recipe_main
        elif command == "kd":
            from automodel_tpu_torch.recipes.kd import main as recipe_main
        else:
            from automodel_tpu_torch.recipes.train_ft import main as recipe_main

        cfg = parse_args_and_load_config(argv[2:])
        from automodel_tpu_torch.resilience import REQUEUE_EXIT_CODE, DesyncError, TrainingPreempted

        try:
            _run_distributed(cfg, lambda: recipe_main(cfg))
        except DesyncError as e:
            # a desynced process is a real fault, never requeued
            print(f"DESYNC: {e}", file=sys.stderr)
            return 1
        except TrainingPreempted as e:
            print(f"preempted: {e}", file=sys.stderr)
            # nothing committed: a requeue would loop at zero progress
            return 1 if e.checkpoint_dir is None else REQUEUE_EXIT_CODE
        except Exception as e:
            if _crash_is_preemption_collateral(cfg):
                print(f"crash while a peer's preemption marker is fresh — requeueing as preemption collateral: "
                      f"{e!r}", file=sys.stderr)
                return REQUEUE_EXIT_CODE
            raise
        return 0
    if command in NOT_PORTED:
        return _not_ported(command)
    print(f"unknown command {command!r}. {_usage()}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
