"""CLI entry point of the torch port.

    python -m automodel_tpu_torch.cli.app serve -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app finetune llm -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app benchmark llm -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app kd llm -c cfg.yaml [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app generate -c cfg.yaml [--prompt '1 2 3'] [--dotted.key=value ...]
    python -m automodel_tpu_torch.cli.app verify-ckpt <dir> [--no-checksums] [--json]
    python -m automodel_tpu_torch.cli.app trace <metrics.jsonl> [...] [--chrome out.json] [--md out.md] [--trace-id P]
    python -m automodel_tpu_torch.cli.app report <metrics.jsonl> [--strict]

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
neither reads a config or touches a device. The JAX package's other
commands are not ported yet; each exits 2 saying so.
"""

from __future__ import annotations

import sys

from automodel_tpu_torch.config.arg_parser import parse_args_and_load_config

TRAIN_COMMANDS = ("finetune", "pretrain", "benchmark", "kd")
NOT_PORTED = (
    "dpo", "grpo", "mine",
    "route", "fleet-status", "profile", "goodput",
)


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
        "       python -m automodel_tpu_torch.cli.app report <metrics.jsonl> [--strict]"
    )


def _not_ported(what: str) -> int:
    print(
        f"{what} is not ported to the torch backend yet; use "
        f"python -m automodel_tpu.cli.app {what} for the JAX package",
        file=sys.stderr,
    )
    return 2


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
    if command == "serve":
        from automodel_tpu_torch.serving.server import main as serve_main

        return serve_main(parse_args_and_load_config(argv[1:]))
    if command == "generate":
        from automodel_tpu_torch.generation.engine import main as generate_main

        return generate_main(parse_args_and_load_config(argv[1:]))
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

        recipe_main(parse_args_and_load_config(argv[2:]))
        return 0
    if command in NOT_PORTED:
        return _not_ported(command)
    print(f"unknown command {command!r}. {_usage()}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
