"""The ``serve`` front: stdin JSONL in, one JSON line per terminal request
out.

Port of ``main`` (:971) and the stdin-JSONL front (:1283) of
``automodel_tpu/serving/server.py``. Each input line is a JSON object
``{"prompt_ids": [...]}`` (or ``"prompt": "1 2 3"``, token ids as text)
with optional ``id``, ``max_new_tokens``, ``deadline_s`` and
``max_queue_wait_s``. A bad line gets an error line and the batch goes on.
Exit code: 0, 1 if any line was bad, 2 if no request came in.

Top-level sections the port does not run (``tracing``, ``slo``, ``fleet``)
are refused when enabled; the ``serving:`` section refuses its own
(serving/engine.py).
"""

from __future__ import annotations

import json
import queue as queue_mod
import sys
import threading
import time
from typing import Any

from automodel_tpu_torch.serving.engine import section_enabled

UNPORTED_TOP_SECTIONS = ("tracing", "slo", "fleet")


def _encode_prompt(req: dict) -> list[int]:
    if req.get("prompt_ids") is not None:
        return [int(t) for t in req["prompt_ids"]]
    prompt = req.get("prompt")
    if prompt is None:
        raise ValueError("request needs 'prompt' or 'prompt_ids'")
    toks = str(prompt).replace(",", " ").split()
    try:
        return [int(t) for t in toks]
    except ValueError:
        raise ValueError(
            "no tokenizer in the torch backend: 'prompt' must be token ids (e.g. \"1 2 3\")"
        ) from None


def _emit(rec: dict, out=None) -> None:
    out = out or sys.stdout
    rec = dict(rec)
    rec["completion"] = " ".join(map(str, rec.pop("tokens", [])))
    rec.pop("event", None)
    print(json.dumps(rec), file=out, flush=True)


def _metrics_sink(cfg: Any):
    """``logging.metrics_path``: append every terminal record (without its
    tokens) to a JSONL file. → (on_record, close)."""
    logging_section = cfg.get("logging", None) or {}
    path = logging_section.get("metrics_path") if hasattr(logging_section, "get") else None
    if not path:
        return None, lambda: None
    f = open(path, "a")

    def on_record(rec: dict) -> None:
        rec = dict(rec)
        rec.pop("tokens", None)
        f.write(json.dumps(rec) + "\n")
        f.flush()

    return on_record, f.close


def build_engine(cfg: Any, on_record=None):
    """ServingEngine from a config tree (``device``, ``model``,
    ``generation``, ``serving`` sections)."""
    from automodel_tpu_torch.generation.engine import GenerationConfig, build_auto_from_cfg
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine

    for name in UNPORTED_TOP_SECTIONS:
        section = cfg.get(name, None)
        if section_enabled(name, section.to_dict() if hasattr(section, "to_dict") else section):
            raise ValueError(
                f"{name} is enabled, but the {name} section is not ported to the torch backend yet"
            )
    serve_section = cfg.get("serving", None)
    serve_cfg = ServeConfig.from_dict(
        serve_section.to_dict() if hasattr(serve_section, "to_dict") else serve_section
    )
    gen_section = cfg.get("generation", None)
    gen_cfg = GenerationConfig.from_dict(
        gen_section.to_dict() if hasattr(gen_section, "to_dict") else gen_section
    )
    auto = build_auto_from_cfg(cfg)
    return ServingEngine(auto, serve_cfg, gen_cfg, on_record=on_record)


def main(cfg: Any) -> int:
    """`python -m automodel_tpu_torch.cli.app serve -c cfg.yaml`"""
    on_record, close = _metrics_sink(cfg)
    try:
        engine = build_engine(cfg, on_record=on_record)
        return _serve_stdin(engine)
    finally:
        close()


def _serve_stdin(engine) -> int:
    """Submit every stdin line, print terminal records as they happen. A
    daemon reader thread feeds a queue so the scheduler never blocks on
    stdin: completions stream out while input sits idle-open."""
    stdin = sys.stdin
    lines_q: "queue_mod.Queue[str]" = queue_mod.Queue()

    def _reader():
        while True:
            line = stdin.readline()
            lines_q.put(line)  # "" = EOF sentinel
            if line == "":
                return

    threading.Thread(target=_reader, name="serve-stdin", daemon=True).start()
    counts = {"submitted": 0, "bad": 0}

    def handle_line(line: str, lineno: int) -> None:
        line = line.strip()
        if not line:
            return
        rid = None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request line is not a JSON object")
            rid = req.get("id")
            ids = _encode_prompt(req)
            engine.submit(
                ids,
                request_id=str(rid) if rid is not None else None,
                max_new_tokens=req.get("max_new_tokens"),
                deadline_s=req.get("deadline_s"),
                max_queue_wait_s=req.get("max_queue_wait_s"),
                tenant=req.get("tenant"),
                tier=req.get("tier"),
            )
        except (ValueError, TypeError) as e:
            counts["bad"] += 1
            err = {"error": f"line {lineno}: {e}"}
            if rid is not None:
                err["id"] = rid
            print(json.dumps(err), flush=True)
        else:
            counts["submitted"] += 1

    lineno = 0
    eof = False
    while not eof:
        got_line = False
        try:
            line = lines_q.get_nowait()
            if line == "":
                eof = True
            else:
                lineno += 1
                handle_line(line, lineno)
                got_line = True
        except queue_mod.Empty:
            pass
        if not engine.idle():
            for rec in engine.step():
                _emit(rec)
        elif not got_line and not eof:
            time.sleep(0.02)
    for rec in engine.run():
        _emit(rec)
    if counts["submitted"] == 0:
        print(
            'no requests: pipe JSONL lines like {"prompt_ids": [1, 2, 3], '
            '"max_new_tokens": 8} into stdin',
            file=sys.stderr,
        )
        return 2
    return 0 if counts["bad"] == 0 else 1
