"""Offline checkpoint auditor, port of ``automodel_tpu/checkpoint/verify.py``:
the engine behind ``python -m automodel_tpu_torch.cli.app verify-ckpt <dir>``.

Verifies MANIFEST.json integrity (file list, sizes, streamed checksums) and
the layout-marker stamp for a single step dir or a whole checkpoint root —
WITHOUT deserializing any tensor, so a multi-TB tree audits at disk
bandwidth before an operator commits a big run to resuming from it.

Exit codes: 0 = the tree is resumable as the Checkpointer sees it — every
committed checkpoint verifies, uncommitted crash leftovers beside them are
tolerated (resume skips them, _prune GCs them), and a tree with no
manifests at all but completed ``state/`` dirs audits as LEGACY
(pre-manifest era, resumed via the Checkpointer's fallback); 1 = a
committed dir is corrupt/truncated, or nothing in the tree is resumable;
2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from automodel_tpu_torch.resilience.manifest import (
    MANIFEST_NAME,
    classify_step_dirs,
    has_manifest,
    step_dir_key,
    verify_manifest,
)


def _is_step_dir(p: Path) -> bool:
    return step_dir_key(p) is not None


def audit_dir(step_dir: Path, check_checksums: bool = True) -> dict:
    """→ {dir, committed, ok, problems, n_files, bytes, layout_markers}."""
    rec: dict = {"dir": str(step_dir), "committed": has_manifest(step_dir)}
    if not rec["committed"]:
        # a completed state/ with no manifest is what the Checkpointer's
        # legacy fallback resumes from (pre-manifest era save) — recorded
        # so the exit-code logic can audit such trees as resumable
        rec["legacy_state"] = (step_dir / "state").exists()
        rec.update(
            ok=False,
            problems=[f"{MANIFEST_NAME} missing (uncommitted or pre-manifest save)"],
        )
        return rec
    ok, problems = verify_manifest(step_dir, check_checksums=check_checksums)
    rec.update(ok=ok, problems=problems)
    try:
        manifest = json.loads((step_dir / MANIFEST_NAME).read_text())
        rec["n_files"] = len(manifest.get("files", {}))
        rec["bytes"] = sum(m.get("bytes", 0) for m in manifest.get("files", {}).values())
        markers = manifest.get("fingerprint", {}).get("layout_markers")
        if markers:
            rec["layout_markers"] = markers
    except (ValueError, OSError):
        pass
    return rec


def audit_tree(root: Path, check_checksums: bool = True) -> list[dict]:
    """A step dir audits itself; a root audits every epoch_*_step_* child."""
    if _is_step_dir(root) or has_manifest(root):
        return [audit_dir(root, check_checksums)]
    # same committed/legacy/unfinished classification the Checkpointer's
    # resume uses (manifest.classify_step_dirs) — the audit and the resume
    # path can never disagree about what a dir is
    _, classified = classify_step_dirs(root)
    children = sorted((p for p, _ in classified), key=step_dir_key)
    if not children:
        return [audit_dir(root, check_checksums)]  # report the miss
    return [audit_dir(p, check_checksums) for p in children]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m automodel_tpu_torch.cli.app verify-ckpt",
        description="Verify checkpoint manifests without loading tensors.",
    )
    ap.add_argument("path", help="a step dir (epoch_E_step_S) or a checkpoint root")
    ap.add_argument(
        "--no-checksums", action="store_true",
        help="existence+size pass only (fast triage of a huge tree)",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    root = Path(args.path)
    if not root.exists():
        print(f"verify-ckpt: {root} does not exist", file=sys.stderr)
        return 2
    recs = audit_tree(root, check_checksums=not args.no_checksums)
    # a tree with no manifest ANYWHERE but completed state/ dirs is a
    # pre-manifest-era run, which the Checkpointer's legacy fallback
    # resumes (with a warning) — audit it the same way. One manifest in
    # the tree makes it manifest-era: bare dirs are then crash leftovers.
    manifest_era = any(r["committed"] for r in recs)
    for r in recs:
        r["legacy"] = not manifest_era and r.pop("legacy_state", False)
    if args.json:
        print(json.dumps(recs, indent=2))
    else:
        for r in recs:
            status = (
                "OK " if r["ok"]
                else "CORRUPT" if r["committed"]
                else "LEGACY" if r["legacy"]
                else "UNCOMMITTED"
            )
            size = f" {r['bytes'] / 1e6:.1f}MB/{r['n_files']}f" if "bytes" in r else ""
            print(f"{status:11s} {r['dir']}{size}")
            for p in r.get("problems", []):
                print(f"            - {p}")
    n_ok = sum(r["ok"] for r in recs)
    n_legacy = sum(r["legacy"] for r in recs)
    print(
        f"{n_ok}/{len(recs)} checkpoint dir(s) verify"
        + (f" ({n_legacy} legacy pre-manifest, resumable unverified)" if n_legacy else ""),
        file=sys.stderr,
    )
    # exit contract: an uncommitted leftover (kill mid-async-save) next to
    # verified checkpoints is a state the Checkpointer tolerates — resume
    # skips it and _prune GCs it — so it must not fail an operator's audit;
    # only a corrupt COMMITTED dir, or a tree with nothing resumable, does
    n_corrupt = sum(r["committed"] and not r["ok"] for r in recs)
    return 1 if n_corrupt or not (n_ok or n_legacy) else 0


if __name__ == "__main__":
    raise SystemExit(main())
