"""CLI arg parsing with dotted config overrides.

Port of ``automodel_tpu/config/arg_parser.py``: a ``-c/--config`` YAML plus
any number of ``--a.b.c=value`` (or ``--a.b.c value``) overrides;
``--a.b.c=null`` sets None, ``--del a.b.c`` removes a key.
"""

from __future__ import annotations

import sys
from typing import Sequence

from automodel_tpu_torch.config.loader import ConfigNode, load_yaml_config, translate_value


def parse_cli_argv(
    argv: Sequence[str],
) -> tuple[str | None, list[tuple[str, str]], list[str]]:
    """Split argv into (config_path, [(dotted_key, raw_value)], deletions)."""
    config_path: str | None = None
    overrides: list[tuple[str, str]] = []
    deletions: list[str] = []
    argv = list(argv)
    reserved = ("-c", "--config", "--del")

    def operand(idx: int, opt: str) -> str:
        if idx >= len(argv):
            raise ValueError(f"Option {opt} requires an argument")
        return argv[idx]

    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-c", "--config"):
            config_path = operand(i + 1, tok)
            i += 2
        elif tok == "--del":
            deletions.append(operand(i + 1, tok))
            i += 2
        elif tok.startswith("--"):
            body = tok[2:]
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            if "=" in body:
                key, val = body.split("=", 1)
                overrides.append((key, val))
                i += 1
            elif nxt is not None and not nxt.startswith("--") and nxt not in reserved:
                overrides.append((body, nxt))
                i += 2
            else:
                overrides.append((body, "true"))
                i += 1
        else:
            raise ValueError(f"Unexpected CLI token {tok!r}")
    return config_path, overrides, deletions


def parse_args_and_load_config(argv: Sequence[str] | None = None) -> ConfigNode:
    argv = list(sys.argv[1:] if argv is None else argv)
    config_path, overrides, deletions = parse_cli_argv(argv)
    if config_path is None:
        raise ValueError("A config file is required: -c/--config path.yaml")
    cfg = load_yaml_config(config_path)
    for key, raw in overrides:
        cfg.set_by_path(key, translate_value(raw))
    for key in deletions:
        cfg.delete_by_path(key)
    return cfg
