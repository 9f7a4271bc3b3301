"""Checkpoint integrity manifests, port of
``automodel_tpu/resilience/manifest.py`` (the whole module).

``MANIFEST.json`` is the checkpoint's commit marker and integrity record:
the last file written into a step dir (after the state, the extra-state
JSON and the HF export have landed), listing every file with its size and
CRC32 plus a config and layout fingerprint. Its format is the JAX
package's, byte for byte: each package's ``verify-ckpt`` audits the other's
trees.

1. *Commit*: a dir without a manifest was never finished; a crash mid-save
   leaves none, so resume skips the dir and falls back to the previous
   committed step.
2. *Integrity*: a dir with a manifest whose bytes later rot (truncation,
   bit flips) fails verification, and ``Checkpointer.load`` walks back to
   the newest checkpoint that verifies.

Verification reads file bytes (streamed CRC32) and never deserializes a
tensor, so an audit runs at disk bandwidth without device memory.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import zlib
from pathlib import Path
from typing import Any, Optional

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
FORMAT_VERSION = 1
_CHUNK = 1 << 20
# the infix of a state dir still being written (renamed to ``state`` when
# complete); the JAX package's orbax tmp dirs carry it too
TMP_MARK = "-checkpoint-tmp"


def step_dir_key(p: Path) -> Optional[tuple[int, int]]:
    """``epoch_{e}_step_{s}`` → (e, s); None for anything else (including
    quarantined ``*.corrupt`` dirs). THE one parser of the checkpoint dir
    naming scheme — the Checkpointer (ordering, pruning) and the verify-
    ckpt auditor both use it, so the format can never drift between them.
    Sorting on the PAIR fixes the multi-epoch bug where step number alone
    made epoch_0_step_100 beat epoch_1_step_50."""
    parts = p.name.split("_")
    if len(parts) != 4 or parts[0] != "epoch" or parts[2] != "step":
        return None
    try:
        return int(parts[1]), int(parts[3])
    except ValueError:
        return None


# A file longer than one span is checksummed a span at a time on a thread
# pool (``os.pread`` and ``zlib.crc32`` release the GIL) and the spans' CRCs
# are joined: a DCP state is one file of ~7.4 GB a Llama-3-8B layer, which
# the commit's read-back and every verified load read whole.
_CRC_SPAN = 64 << 20
_CRC_WORKERS = min(8, os.cpu_count() or 1)


def _gf2_times(mat: list[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _crc32_zeros(nbytes: int) -> list[int]:
    """The GF(2) operator that runs a CRC32 over ``nbytes`` zero bytes, as
    zlib's ``crc32_combine`` builds it: crc(a + b) = op(len b)(crc a) ^ crc b."""
    op = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    for _ in range(3):  # 2, 4, 8 bits
        op = [_gf2_times(op, col) for col in op]
    out = [1 << n for n in range(32)]
    while nbytes:
        if nbytes & 1:
            out = [_gf2_times(op, col) for col in out]
        nbytes >>= 1
        if nbytes:
            op = [_gf2_times(op, col) for col in op]
    return out


def _crc32_span(fd: int, start: int, end: int) -> int:
    crc = 0
    while start < end:
        chunk = os.pread(fd, min(_CHUNK, end - start), start)
        if not chunk:  # the file shrank under us: its size check fails
            break
        crc = zlib.crc32(chunk, crc)
        start += len(chunk)
    return crc


def _crc32_file(path: Path) -> str:
    from concurrent.futures import ThreadPoolExecutor

    fd = os.open(path, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        starts = range(0, size, _CRC_SPAN)
        ends = [min(s + _CRC_SPAN, size) for s in starts]
        if len(starts) <= 1 or _CRC_WORKERS <= 1:
            crcs = [_crc32_span(fd, s, e) for s, e in zip(starts, ends)]
        else:
            with ThreadPoolExecutor(_CRC_WORKERS) as pool:
                crcs = list(pool.map(_crc32_span, [fd] * len(starts), starts, ends))
    finally:
        os.close(fd)
    crc = crcs[0] if crcs else 0
    full = _crc32_zeros(_CRC_SPAN) if len(crcs) > 1 else None
    for s, e, c in zip(starts[1:], ends[1:], crcs[1:]):
        op = full if e - s == _CRC_SPAN else _crc32_zeros(e - s)
        crc = _gf2_times(op, crc) ^ c
    return f"{crc & 0xFFFFFFFF:08x}"


def config_fingerprint(step_dir: Path, layout_markers: Optional[dict] = None) -> dict:
    """Layout/config fingerprint stamped into the manifest: a restored run
    can cheaply tell 'this checkpoint came from a different config' apart
    from 'this checkpoint is damaged'."""
    fp: dict[str, Any] = {}
    cfg = step_dir / "config.json"
    if cfg.exists():
        fp["config_sha256"] = hashlib.sha256(cfg.read_bytes()).hexdigest()
    if layout_markers:
        fp["layout_markers"] = dict(layout_markers)
    return fp


def write_manifest(
    step_dir: Path | str,
    epoch: Optional[int] = None,
    step: Optional[int] = None,
    layout_markers: Optional[dict] = None,
    checksums: bool = True,
) -> Path:
    """Checksum every file under ``step_dir`` and atomically write the
    manifest LAST (tmp + rename), committing the checkpoint.

    ``checksums=False`` (``checkpoint.manifest_checksums: false``) records
    sizes only: the commit marker and truncation detection stay, but the
    commit-time read-back of the whole tree — a full disk-bandwidth pass,
    material for multi-TB checkpoints — is skipped. Bitrot then goes
    undetected until ``verify-ckpt``-with-checksums is run elsewhere, so
    the default stays on."""
    step_dir = Path(step_dir)
    files: dict[str, dict] = {}
    for p in sorted(step_dir.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(step_dir))
        if rel == MANIFEST_NAME or rel.endswith(".tmp"):
            continue
        # a kill mid-save can strand the state's tmp dir (the port's
        # `state.dcp-checkpoint-tmp`, the JAX package's `state.orbax-
        # checkpoint-tmp-*`) next to a later re-save of the same step; its
        # garbage must not be checksummed into the manifest, or its later
        # cleanup would look like corruption
        if any(TMP_MARK in part for part in p.relative_to(step_dir).parts):
            continue
        entry: dict = {"bytes": p.stat().st_size}
        if checksums:
            entry["crc32"] = _crc32_file(p)
        files[rel] = entry
    payload = {
        "format_version": FORMAT_VERSION,
        "epoch": epoch,
        "step": step,
        "created_ts": time.time(),
        "algorithm": "crc32" if checksums else "size-only",
        "files": files,
        "fingerprint": config_fingerprint(step_dir, layout_markers),
    }
    tmp = step_dir / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2))
    os.replace(tmp, step_dir / MANIFEST_NAME)
    return step_dir / MANIFEST_NAME


def has_manifest(step_dir: Path | str) -> bool:
    return (Path(step_dir) / MANIFEST_NAME).exists()


def classify_step_dirs(root: Path | str) -> tuple[bool, list[tuple[Path, str]]]:
    """→ (manifest_era, [(dir, kind)]) over every ``epoch_E_step_S`` child.

    Kind: ``committed`` (manifest present), ``legacy_state`` (completed
    ``state/`` but no manifest), or ``unfinished`` (neither — no state
    rename ever landed). ``manifest_era`` is True when ANY dir carries a
    manifest; what a ``legacy_state`` dir MEANS hinges on it, and this is
    THE one statement of that rule, shared by the Checkpointer
    (resume/prune) and ``verify-ckpt`` (audit) so they can never disagree:
    in a manifest-era tree a bare completed-``state/`` dir is an unfinished
    save — including an async save whose rename landed but whose commit
    never ran — and is skipped for resume (walk-back last resort only); in
    a tree with no manifests anywhere it is a pre-manifest-era save and
    fully resumable."""
    root = Path(root)
    if not root.exists():
        return False, []
    dirs = [p for p in root.iterdir() if p.is_dir() and step_dir_key(p) is not None]
    manifest_era = any(has_manifest(p) for p in dirs)
    classified = []
    for p in dirs:
        if has_manifest(p):
            kind = "committed"
        elif (p / "state").exists():
            kind = "legacy_state"
        else:
            kind = "unfinished"
        classified.append((p, kind))
    return manifest_era, classified


def verify_manifest(
    step_dir: Path | str, check_checksums: bool = True
) -> tuple[bool, list[str]]:
    """→ (ok, problems). Problems name the file and failure mode, so the
    flight-recorder entry (and ``verify-ckpt`` output) is actionable.
    Files present on disk but absent from the manifest are NOT failures —
    post-commit artifacts (e.g. a PEFT adapter export) may land later.

    ``check_checksums=False`` does the existence+size pass only (what
    ``latest_dir`` affordably needs per candidate dir); full verification
    runs at load time and in the CLI auditor."""
    step_dir = Path(step_dir)
    mpath = step_dir / MANIFEST_NAME
    if not mpath.exists():
        return False, [f"{MANIFEST_NAME} missing (uncommitted or pre-manifest save)"]
    try:
        manifest = json.loads(mpath.read_text())
        entries = manifest["files"]
    except (ValueError, KeyError) as e:
        return False, [f"{MANIFEST_NAME} unreadable: {e!r}"]
    problems: list[str] = []
    for rel, meta in entries.items():
        p = step_dir / rel
        if not p.exists():
            problems.append(f"{rel}: listed in manifest but missing on disk")
            continue
        size = p.stat().st_size
        if size != meta.get("bytes"):
            problems.append(
                f"{rel}: size {size} != manifest {meta.get('bytes')} (truncated?)"
            )
            continue
        if (
            check_checksums
            and "crc32" in meta  # size-only manifests have nothing to check
            and _crc32_file(p) != meta["crc32"]
        ):
            problems.append(f"{rel}: checksum mismatch (corrupt bytes)")
    return not problems, problems
