"""CLI entry point of the torch port.

    python -m automodel_tpu_torch.cli.app serve -c cfg.yaml [--dotted.key=value ...]

``serve`` runs the stdin-JSONL serving front (serving/server.py) on the
config's ``device`` (``cuda`` unless ``--device=cpu``). The JAX package's
other commands are not ported yet; each exits 2 saying so.
"""

from __future__ import annotations

import sys

from automodel_tpu_torch.config.arg_parser import parse_args_and_load_config

NOT_PORTED = (
    "finetune", "pretrain", "kd", "dpo", "grpo", "benchmark", "mine", "generate",
    "route", "fleet-status", "profile", "report", "goodput", "trace", "verify-ckpt",
)


def _usage() -> str:
    return (
        "usage: python -m automodel_tpu_torch.cli.app serve -c config.yaml "
        "[--device=cpu] [--dotted.key=value ...]  (stdin JSONL in, one JSON "
        "line per finished request out)"
    )


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0 if argv else 2
    command = argv[0]
    if command == "serve":
        from automodel_tpu_torch.serving.server import main as serve_main

        return serve_main(parse_args_and_load_config(argv[1:]))
    if command in NOT_PORTED:
        print(
            f"{command} is not ported to the torch backend yet; use "
            f"python -m automodel_tpu.cli.app {command} for the JAX package",
            file=sys.stderr,
        )
        return 2
    print(f"unknown command {command!r}. {_usage()}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
