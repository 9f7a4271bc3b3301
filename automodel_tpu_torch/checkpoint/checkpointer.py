"""Training checkpointer, port of ``automodel_tpu/checkpoint/checkpointer.py``
with orbax replaced by ``torch.distributed.checkpoint`` (DCP).

A checkpoint is a step dir ``<checkpoint_dir>/epoch_{E}_step_{S}``
holding the training state (``state/``, a DCP directory: the model's
parameters and persistent buffers, the optimizer's fp32 moments and count,
and the step), ``extra_state.json`` (the dataloader and step-scheduler
cursors, the param-tree signature, the layout markers), ``config.json``
(the recipe config), optionally ``hf/`` (a consolidated HF save) and, last,
``MANIFEST.json``. Without a process group (or with one of one rank) DCP
runs in one process (``no_dist``); under a mesh of more ranks every rank
writes its shards of the DTensor state (the model's FSDP2 / tensor-parallel
parameters, the optimizer's moments wrapped alike) and rank 0 writes the
metadata, the json files, the consolidated ``hf/`` export (each tensor
gathered whole, ``full_tensor``) and the manifest, with barriers between.
A state saved under one mesh restores under another, one process
included: DCP reshards on load. The state is written to
``state.dcp-checkpoint-tmp`` and renamed to ``state`` when complete, as
orbax renames its tmp dir.

Resilience contract (``resilience/manifest.py``): every save commits by
writing ``MANIFEST.json`` last (for an async save, when the write drains at
the next ``wait()`` / ``close()``), listing every file with size and CRC32.
Only committed dirs count for auto-resume and pruning; ``load()`` verifies
and walks back past corrupt dirs (at most ``max_restore_fallbacks``)
instead of crashing a restarted run on a damaged newest checkpoint. The DCP
calls ride the retrying-I/O decorator. Before the manifest, every process
waits at the distributed guard's commit barrier (``commit_barrier``, a
timed barrier: no process commits until every process's save drained),
and after it the fault injector's ``after_checkpoint_save`` runs (the
JAX package's checkpoint faults, ``resilience/fault_injection.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import warnings
import zlib
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch

from automodel_tpu_torch.resilience.manifest import (
    TMP_MARK,
    classify_step_dirs,
    has_manifest,
    step_dir_key as _dir_key,
    verify_manifest,
    write_manifest,
)
from automodel_tpu_torch.resilience.fault_injection import active_injector
from automodel_tpu_torch.resilience.retry import retry_io

logger = logging.getLogger(__name__)

STATE_TMP = "state.dcp" + TMP_MARK
# DCP's notice that it runs in one process, which is the intent here
_ONE_PROCESS = "torch.distributed is disabled, unavailable or uninitialized"
MODEL_SAVE_FORMATS = ("sharded", "safetensors")


class CheckpointIntegrityError(Exception):
    """No loadable checkpoint: every candidate (within the walk-back bound)
    failed manifest verification, or an explicitly named dir is damaged."""


@dataclasses.dataclass
class CheckpointingConfig:
    """The ``checkpoint:`` section, with the JAX package's keys and
    meaning."""

    enabled: bool = True
    checkpoint_dir: str = "checkpoints"
    # sharded: the DCP state only; safetensors: a consolidated HF save too
    model_save_format: str = "sharded"
    save_consolidated: bool = False
    keep_last_k: int = 0  # 0 = keep all
    restore_from: Optional[str] = None
    # the state is staged to host memory in save() and written on a
    # background thread; the next save (or wait()/close()) drains it and
    # commits the dir
    is_async: bool = False
    # auto-resume walk-back bound: how many older committed checkpoints
    # load() may fall back to when newer ones fail verification
    max_restore_fallbacks: int = 3
    # False = size-only manifests: the commit marker and truncation
    # detection stay, the commit-time checksum read-back of the tree goes
    manifest_checksums: bool = True
    # every save records the state's (key, shape, dtype) signature; load()
    # refuses a checkpoint whose signature mismatches the built model.
    # False only for deliberate surgery.
    check_param_signature: bool = True

    def __post_init__(self):
        if self.model_save_format not in MODEL_SAVE_FORMATS:
            raise ValueError(
                f"checkpoint.model_save_format={self.model_save_format!r} (want one of {MODEL_SAVE_FORMATS})"
            )


def _flatten(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def state_bytes(tree: Any) -> int:
    """Bytes of the tensors in a state tree."""
    return sum(v.numel() * v.element_size() for _, v in _flatten(tree) if isinstance(v, torch.Tensor))


def _world() -> tuple[int, int]:
    from automodel_tpu_torch.resilience.timed_sync import world

    return world()


def _barrier() -> None:
    if _world()[1] > 1:
        import torch.distributed as dist

        dist.barrier()


@retry_io(op="dcp_save", max_attempts=3)
def _dcp_save(path: Path, state: dict) -> None:
    """Write ``state`` as a DCP dir at ``path``, through a tmp dir renamed
    into place when complete (a killed save leaves no ``state/``); every
    rank of a group writes its shards, rank 0 clears and renames."""
    import torch.distributed.checkpoint as dcp

    rank, n = _world()
    tmp = path.with_name(STATE_TMP)
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_ONE_PROCESS)
        dcp.save(state, checkpoint_id=str(tmp), no_dist=n == 1)
    _barrier()
    if rank == 0:
        os.replace(tmp, path)
    _barrier()


@retry_io(op="dcp_load", max_attempts=3)
def _dcp_load(path: Path, state: dict) -> dict:
    """Load a DCP dir into ``state``'s tensors in place (on their devices,
    each rank its own shards); its plain values (ints) are replaced in the
    dict."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_ONE_PROCESS)
        dcp.load(state, checkpoint_id=str(path), no_dist=_world()[1] == 1)
    return state


class FullTensors:
    """A read-only view of a state dict whose DTensor values come back
    whole (``full_tensor``, a collective every rank calls in the same
    order): the consolidated export's input under a mesh."""

    def __init__(self, state_dict: dict):
        self._sd = state_dict

    def __getitem__(self, key: str) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        t = self._sd[key]
        return t.full_tensor() if isinstance(t, DTensor) else t



class _AsyncSave:
    """One DCP write on a background thread over a host copy of the state."""

    def __init__(self, path: Path, state: dict):
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(path, state), name="dcp-async-save", daemon=True)
        self._thread.start()

    def _run(self, path: Path, state: dict) -> None:
        try:
            _dcp_save(path, state)
        except BaseException as e:  # surfaced at wait_until_finished
            self._error = e

    def wait_until_finished(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error


def _stage(state: dict) -> dict:
    """A host copy of the state (tensors copied to CPU; the training step
    goes on updating the device ones in place)."""
    return _tree_map(lambda v: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v, state)


def param_tree_signature(tree: Any) -> dict:
    """Structural signature of a state tree: sorted ``path:shape:dtype``
    entries and their CRC32 digest. Plain values sign by type name."""
    entries = []
    for name, leaf in _flatten(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = str(getattr(leaf, "dtype", type(leaf).__name__)).removeprefix("torch.")
        entries.append(f"{name}:{shape}:{dtype}")
    entries.sort()
    digest = zlib.crc32("\n".join(entries).encode())
    return {"n_leaves": len(entries), "digest": f"{digest:08x}", "entries": entries}


def verify_param_signature(
    found: Optional[dict], expected: dict, ckpt_dir: Path, max_diffs: int = 12
) -> None:
    """Loudly refuse resuming a checkpoint whose state-tree structure or
    shapes mismatch the built model. A checkpoint with no recorded
    signature (pre-guard save) loads unchanged; DCP's own load still
    checks each tensor's shape there."""
    if not found:
        return
    if found.get("digest") == expected["digest"]:
        return
    f_set, e_set = set(found.get("entries") or ()), set(expected["entries"])
    missing = sorted(e_set - f_set)  # model expects, checkpoint lacks
    extra = sorted(f_set - e_set)  # checkpoint has, model doesn't
    lines = [f"model expects but checkpoint lacks: {p}" for p in missing[:max_diffs]]
    lines += [f"checkpoint has but model lacks:    {p}" for p in extra[:max_diffs]]
    more = len(missing) + len(extra) - len(lines)
    if more > 0:
        lines.append(f"... and {more} more")
    if not lines:  # same entries, different digest (should not happen)
        lines = [f"digest {found.get('digest')} != expected {expected['digest']}"]
    raise ValueError(
        f"checkpoint {ckpt_dir} param-tree signature mismatches the built "
        f"model ({found.get('n_leaves')} vs {expected['n_leaves']} leaves) — "
        "refusing to resume. Rebuild the model with the config the "
        "checkpoint was saved under (its config.json records it), or set "
        "checkpoint.check_param_signature: false for deliberate surgery:\n  "
        + "\n  ".join(lines)
    )


class Checkpointer:
    """Step dirs under ``config.checkpoint_dir``: save, commit, prune,
    load with verification and walk-back, and the best-val marker."""

    def __init__(self, config: CheckpointingConfig):
        self.config = config
        self.root = Path(config.checkpoint_dir)
        self._async: Optional[_AsyncSave] = None
        # (dir, epoch, step, layout_markers) whose manifest commits when the
        # in-flight async save drains
        self._pending_commit: Optional[tuple[Path, int, int, Optional[dict]]] = None
        # best-val marker deferred until its dir's async save commits:
        # BEST.json must never point at an uncommitted (unrestorable) tree
        self._pending_best: Optional[tuple[Path, str, float]] = None
        # the last save's and load's parts: seconds and bytes of the state,
        # the HF export and the manifest commit
        self.last_save: dict = {}
        self.last_load: dict = {}
        # the recipe points this at the telemetry ring: integrity events
        # (fallbacks, failed async saves) land in the flight recorder
        self.event_hook: Optional[Callable[[dict], None]] = None
        # the recipe points this at the goodput ledger: (kind, seconds, step)
        # per operation — "ckpt_save" (sync write / async staging),
        # "ckpt_drain" (async drain + commit), "ckpt_restore" (load)
        self.timing_hook: Optional[Callable[..., None]] = None
        # drain seconds inside the current save() (its wait() for the
        # previous async save), subtracted so no second is billed twice
        self._inner_drain_s = 0.0
        # the distributed guard's timed barrier: no process writes the
        # manifest until every process's save drained
        self.commit_barrier: Optional[Callable[[str], None]] = None

    def _event(self, rec: dict) -> None:
        if self.event_hook is not None:
            try:
                self.event_hook(rec)
            except Exception:  # telemetry must never break checkpointing
                pass

    def _timing(self, kind: str, seconds: float, step: Optional[int] = None) -> None:
        if self.timing_hook is not None:
            try:
                self.timing_hook(kind, seconds, step=step)
            except Exception:  # telemetry must never break checkpointing
                pass

    def wait(self) -> None:
        """Block until an in-flight async save finishes, then commit it by
        writing its manifest: a crash before this point leaves the dir
        uncommitted and auto-resume ignores it. A drain that raises discards
        the pending commit (a manifest over a partial write would vouch for
        it) without propagating: the dir stays uncommitted, the failure is
        logged, and the next cadence save tries again."""
        pending, self._pending_commit = self._pending_commit, None
        t0 = time.perf_counter()
        try:
            if self._async is not None:
                job, self._async = self._async, None
                try:
                    job.wait_until_finished()
                except Exception as e:
                    if pending is None:
                        raise
                    logger.error(
                        "async checkpoint save to %s FAILED (%r); dir left uncommitted — "
                        "resume will skip it, next cadence save retries", pending[0], e,
                    )
                    self._event({"event": "async_save_failed", "dir": str(pending[0]), "error": repr(e),
                                 "ts": time.time()})
                    if self._pending_best is not None and self._pending_best[0] == pending[0]:
                        self._pending_best = None
                    return
            if pending is not None:
                self._commit(*pending)
        finally:
            if pending is not None:
                # only a drain that had a commit to finish is a segment
                dt = time.perf_counter() - t0
                self._inner_drain_s += dt
                self._timing("ckpt_drain", dt, step=pending[2])

    def _commit(self, out: Path, epoch: int, step: int, layout_markers: Optional[dict]) -> None:
        if self.commit_barrier is not None:
            self.commit_barrier("checkpoint_commit")
        if _world()[0] == 0:  # rank 0 writes the manifest; the others wait for it
            t0 = time.perf_counter()
            # write_manifest is tmp + rename, so a retry after a transient EIO
            # mid-read-back is idempotent
            retry_io(op="manifest_commit", max_attempts=3)(write_manifest)(
                out, epoch=epoch, step=step, layout_markers=layout_markers,
                checksums=self.config.manifest_checksums,
            )
            self.last_save["manifest_s"] = time.perf_counter() - t0
            if self._pending_best is not None and self._pending_best[0] == out:
                _, metric, value = self._pending_best
                self._pending_best = None
                self._write_best(out, metric, value)
            inj = active_injector()
            if inj is not None:
                inj.after_checkpoint_save(out)
        _barrier()

    def close(self) -> None:
        self.wait()

    # -- paths --------------------------------------------------------------
    def step_dir(self, epoch: int, step: int) -> Path:
        return self.root / f"epoch_{epoch}_step_{step}"

    def _candidate_dirs(self, include_legacy_tail: bool = False) -> list[Path]:
        """Committed checkpoint dirs, newest first by (epoch, step).

        Committed = manifest present — a single stat per dir, because this
        runs on every save (via _prune) and a per-file size sweep over
        thousands of state files on a FUSE mount would stall the step
        boundary. Contents are verified (sizes AND checksums) at load time
        by _verify_for_load, which walks back past any dir that fails. The
        committed/legacy/unfinished classification (and the manifest-era
        rule deciding which a bare completed-``state/`` dir is) lives in
        ``manifest.classify_step_dirs``, shared with ``verify-ckpt``.

        ``include_legacy_tail`` (walk-back only): in a manifest-era tree,
        append the completed-``state/`` no-manifest dirs AFTER every
        manifest dir — a valid legacy checkpoint is a better last resort
        than crashing when every manifest-era dir fails verification."""
        manifest_era, classified = classify_step_dirs(self.root)
        cands = [
            p for p, kind in classified
            if kind == "committed" or (kind == "legacy_state" and not manifest_era)
        ]
        legacy_tail = [
            p for p, kind in classified
            if kind == "legacy_state" and manifest_era
        ]
        cands.sort(key=_dir_key, reverse=True)
        if include_legacy_tail:
            cands.extend(sorted(legacy_tail, key=_dir_key, reverse=True))
        return cands

    def latest_committed_dir(self) -> Path | None:
        """Newest checkpoint committed into THIS run's tree — no
        ``restore_from`` bootstrap fallback. The preemption path uses this
        to decide requeue-eligibility: a run that committed nothing must
        exit as a real failure, or the launcher would requeue it to
        re-bootstrap and be preempted again at zero net progress."""
        cands = self._candidate_dirs()
        return cands[0] if cands else None

    def latest_dir(self) -> Path | None:
        """Newest committed run-local checkpoint; ``restore_from`` is only
        the BOOTSTRAP source, used when the run's own tree is empty. (If it
        pinned every resume, a preempted-and-requeued run would restart
        from the original base checkpoint forever — zero net progress under
        recurring preemption.)"""
        cands = self._candidate_dirs()
        if cands:
            return cands[0]
        if self.config.restore_from:
            return Path(self.config.restore_from)
        return None

    # -- save ---------------------------------------------------------------
    def save(
        self,
        state: dict,
        epoch: int,
        step: int,
        extra_state: dict[str, dict] | None = None,
        hf_export: Any = None,  # (adapter, state_dict) for a consolidated HF save
        config_snapshot: dict | None = None,
        hf_meta: dict | None = None,  # {"hf_config": dict, "source_dir": str}
        layout_markers: dict[str, str] | None = None,
    ) -> Path:
        """Save ``state`` (a dict tree of tensors and plain values) as step
        dir ``epoch_{epoch}_step_{step}``, in the JAX package's order:
        uncommit, rewrite, ``extra_state.json``, ``config.json``, the
        ``hf/`` export, the state, then the manifest (at the next
        ``wait()`` when async)."""
        from automodel_tpu_torch.checkpoint.hf_io import save_hf_checkpoint

        t_save = time.perf_counter()
        self._inner_drain_s = 0.0
        rank, n_ranks = _world()
        out = self.step_dir(epoch, step)
        if rank == 0:
            out.mkdir(parents=True, exist_ok=True)
        if layout_markers:
            extra_state = {**(extra_state or {}), "_layout_markers": dict(layout_markers)}
        if self.config.check_param_signature:
            extra_state = {**(extra_state or {}), "_param_signature": param_tree_signature(state)}
        # saving the same step twice (cadence save + end-of-loop save) is
        # idempotent: the previous state dir is replaced
        self.wait()  # at most one async save in flight
        self.last_save = {}
        # uncommit first: a stale manifest must not vouch for the dir while
        # its contents are rewritten underneath it (rank 0 of a group)
        if rank == 0:
            manifest = out / "MANIFEST.json"
            if manifest.exists():
                manifest.unlink()
            if (out / "state").exists():
                shutil.rmtree(out / "state")
            # a kill mid-save strands the tmp dir; reclaim it
            for stale in out.glob(f"*{TMP_MARK}*"):
                shutil.rmtree(stale, ignore_errors=True)
            if extra_state:
                (out / "extra_state.json").write_text(json.dumps(extra_state, default=_json_default))
            if config_snapshot:
                (out / "config.json").write_text(json.dumps(config_snapshot, indent=2, default=str))
        _barrier()
        if hf_export is not None and (
            self.config.save_consolidated or self.config.model_save_format == "safetensors"
        ):
            from automodel_tpu_torch.checkpoint.addons import write_hf_addons

            adapter, sd = hf_export
            t0 = time.perf_counter()
            # to_hf yields one tensor at a time; the writer brings each to
            # the host and flushes shard files as they fill. Under a group
            # every rank gathers each tensor whole and rank 0 writes it
            tensors = adapter.to_hf(FullTensors(sd) if n_ranks > 1 else sd)
            if rank == 0:
                self.last_save["hf_bytes"] = save_hf_checkpoint(out / "hf", tensors)
                write_hf_addons(out / "hf", **(hf_meta or {}))
            else:
                for _ in tensors:
                    pass
            self.last_save["hf_s"] = time.perf_counter() - t0
        self.last_save["state_bytes"] = state_bytes(state)
        t0 = time.perf_counter()
        if self.config.is_async:
            # staging (device → host) is synchronous, the write is not
            self._async = _AsyncSave(out / "state", _stage(state))
            self._pending_commit = (out, epoch, step, layout_markers)
            self.last_save["stage_s"] = time.perf_counter() - t0
        else:
            _dcp_save(out / "state", state)
            self.last_save["state_s"] = time.perf_counter() - t0
            self._commit(out, epoch, step, layout_markers)
        self._prune(protect={out.resolve()})
        # the inner wait() already reported the previous save's drain
        self._timing("ckpt_save", max(time.perf_counter() - t_save - self._inner_drain_s, 0.0), step=step)
        return out

    def _prune(self, protect: set[Path] | None = None) -> None:
        """Delete committed checkpoints beyond ``keep_last_k`` (by (epoch,
        step), oldest first). Only COMMITTED dirs count toward k — an
        uncommitted crash leftover must not silently consume a keep slot —
        and neither the dir named by ``restore_from`` (the resume source of
        a running job) nor the in-flight save target is ever deleted.

        Uncommitted leftovers strictly OLDER than the newest committed
        checkpoint are garbage (a kill mid-save can leave a multi-GB
        partial tree per incident — on spot capacity that fills the volume)
        and are deleted too — but ONLY dirs without a completed ``state/``
        (a kill mid-write leaves ``state.dcp-checkpoint-tmp``, never
        ``state/``). A dir WITH ``state/`` and no manifest is
        indistinguishable from a valid legacy (pre-manifest) checkpoint,
        and sweeping those would destroy every legacy restore point the
        moment the first manifest-era save lands. A newer-or-equal
        uncommitted dir is left alone (it may be the save currently in
        flight)."""
        k = self.config.keep_last_k
        if k <= 0 or not self.root.exists() or _world()[0] != 0:
            return
        protect = set(protect or ())
        if self.config.restore_from:
            protect.add(Path(self.config.restore_from).resolve())
        if self._pending_commit is not None:
            protect.add(self._pending_commit[0].resolve())
        best = self.best_info()
        if best is not None:
            # the best-val checkpoint outlives keep_last_k: production
            # resume/export points at it long after the cadence window moved
            protect.add((self.root / best["dir"]).resolve())
        committed = self._candidate_dirs()  # newest first
        for p in committed[k:]:
            if p.resolve() in protect:
                continue
            shutil.rmtree(p)
        if not committed:
            return
        newest_key = _dir_key(committed[0])
        keep = {p.resolve() for p in committed}
        for p in self.root.iterdir():
            key = _dir_key(p)
            if key is None or not p.is_dir() or p.resolve() in keep | protect:
                continue
            if key < newest_key and not (p / "state").exists():
                logger.warning("pruning stale uncommitted checkpoint dir %s", p)
                shutil.rmtree(p)

    # -- load ---------------------------------------------------------------
    def load(
        self,
        state: dict,
        path: str | os.PathLike | None = None,
        expected_layout_markers: dict[str, str] | None = None,
        before_step: int | None = None,
    ) -> tuple[dict, dict]:
        """Restore into ``state`` (the built training state: its tensors are
        loaded in place, on their devices) → (state, extra_state).

        ``expected_layout_markers`` (the model's ``native_layout_markers``)
        and the param-tree signature are checked before a tensor is read, so
        a checkpoint of another layout or shape refuses loudly instead of
        half-loading. An explicitly named dir (``path``, or ``restore_from``
        when the run's own tree is empty) is fully verified and fails on
        damage; auto-resume walks back through committed run-local dirs,
        newest first, at most ``max_restore_fallbacks`` extra candidates.
        ``before_step`` (auto-resume only) keeps the candidates saved
        strictly before that step: the non-finite rollback's, since a save
        at the diverged step holds the poisoned params (JAX :469-472)."""
        t_load = time.perf_counter()
        if path is not None:
            d = self._verify_for_load(Path(path))
        else:
            try:
                d = self._pick_verified_latest(before_step=before_step)
            except FileNotFoundError:
                # no run-local committed checkpoint at all → bootstrap
                if not self.config.restore_from:
                    raise
                d = self._verify_for_load(Path(self.config.restore_from))
        t_verified = time.perf_counter()
        extra_file = d / "extra_state.json"
        extra = json.loads(extra_file.read_text()) if extra_file.exists() else {}
        check_layout_markers(extra.get("_layout_markers"), expected_layout_markers, d)
        if self.config.check_param_signature:
            verify_param_signature(extra.get("_param_signature"), param_tree_signature(state), d)
        t0 = time.perf_counter()
        state = _dcp_load(d / "state", state)
        self.last_load = {
            "dir": str(d), "verify_s": t_verified - t_load,
            "state_s": time.perf_counter() - t0, "state_bytes": state_bytes(state),
        }
        key = _dir_key(d)
        self._timing("ckpt_restore", time.perf_counter() - t_load, step=key[1] if key else None)
        return state, extra

    def _verify_for_load(self, d: Path) -> Path:
        if not d.exists():
            raise FileNotFoundError(f"No checkpoint found at {d}")
        if not has_manifest(d):
            # pre-manifest tree: nothing to verify against — load with a
            # warning rather than stranding older runs
            logger.warning(
                "checkpoint %s has no MANIFEST.json (pre-manifest save) — "
                "loading unverified", d,
            )
            return d
        ok, problems = verify_manifest(d, check_checksums=True)
        if ok:
            return d
        raise CheckpointIntegrityError(
            f"checkpoint {d} fails integrity verification:\n  "
            + "\n  ".join(problems)
        )

    def _pick_verified_latest(self, before_step: int | None = None) -> Path:
        cands = self._candidate_dirs(include_legacy_tail=True)
        if before_step is not None:
            cands = [p for p in cands if _dir_key(p)[1] < before_step]
        if not cands:
            raise FileNotFoundError(
                f"No checkpoint found under {self.root}"
                + (f" before step {before_step}" if before_step is not None else "")
            )
        budget = 1 + max(self.config.max_restore_fallbacks, 0)
        rejected: list[str] = []
        for i, d in enumerate(cands[:budget]):
            try:
                chosen = self._verify_for_load(d)
            except CheckpointIntegrityError as e:
                quarantined = self._quarantine(d)
                logger.error(
                    "checkpoint %s FAILED verification — quarantined as %s, "
                    "falling back to the previous committed checkpoint (%s)",
                    d, quarantined, e,
                )
                self._event({"event": "checkpoint_fallback", "rejected": str(d),
                             "quarantined_as": str(quarantined), "problems": str(e)})
                rejected.append(f"{d}: {e}")
                continue
            if i > 0:
                logger.warning(
                    "resuming from OLDER checkpoint %s after %d newer dir(s) "
                    "failed verification — some steps will be retrained",
                    chosen, i,
                )
            return chosen
        raise CheckpointIntegrityError(
            f"no loadable checkpoint under {self.root} within "
            f"{budget} candidate(s):\n  " + "\n  ".join(rejected)
        )

    def _quarantine(self, d: Path) -> Path:
        """Rename a committed-but-corrupt dir out of the ``epoch_E_step_S``
        namespace (data kept for forensics). Without this, corrupt dirs
        would keep occupying ``keep_last_k`` slots FOREVER — pruning counts
        them as committed and would delete the newer GOOD post-resume saves
        instead, until every restore candidate is corrupt."""
        target = d.with_name(d.name + ".corrupt")
        n = 0
        while target.exists():
            n += 1
            target = d.with_name(f"{d.name}.corrupt{n}")
        try:
            d.rename(target)
        except OSError:  # quarantine is best-effort; the walk-back proceeds
            return d
        return target

    def has_checkpoint(self) -> bool:
        return self.latest_dir() is not None

    # -- best-val marker ------------------------------------------------------
    def best_info(self) -> Optional[dict]:
        """The BEST.json record ({dir, metric, value, epoch, step, ts}), or
        None. The named dir may have been pruned away externally — callers
        treat a dangling record as 'no best yet'."""
        f = self.root / "BEST.json"
        if not f.exists():
            return None
        try:
            info = json.loads(f.read_text())
        except (OSError, ValueError):
            return None
        d = self.root / str(info.get("dir", ""))
        return info if info.get("dir") and d.exists() else None

    def mark_best(self, step_dir: Path, metric: str, value: float) -> None:
        """Stamp ``step_dir`` as the best-val checkpoint: BEST.json at the
        tree root (tmp+rename — crash-safe) plus a ``best`` symlink for
        humans and tooling (skipped on filesystems without symlink support;
        BEST.json is the source of truth — production resume points at it
        without parsing the metrics JSONL). The marked dir is protected from
        keep_last_k pruning for as long as it holds the marker.

        With an async save in flight for ``step_dir`` the marker is
        DEFERRED until that save commits (and discarded if the drain
        fails): BEST.json must never name a dir auto-resume would skip."""
        if _world()[0] != 0:
            return  # rank 0 writes the marker
        if self._pending_commit is not None and self._pending_commit[0] == step_dir:
            self._pending_best = (step_dir, metric, float(value))
            return
        self._write_best(step_dir, metric, value)

    def _write_best(self, step_dir: Path, metric: str, value: float) -> None:
        info = {
            "dir": step_dir.name,
            "metric": metric,
            "value": float(value),
            "ts": time.time(),
        }
        key = _dir_key(step_dir)
        if key is not None:
            info["epoch"], info["step"] = key
        tmp = self.root / "BEST.json.tmp"
        tmp.write_text(json.dumps(info, indent=2))
        tmp.replace(self.root / "BEST.json")
        link = self.root / "best"
        try:
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(step_dir.name)
        except OSError:  # symlink-less FS (some object-store FUSE mounts)
            pass
        logger.info(
            "best checkpoint: %s (%s=%.6g)", step_dir.name, metric, value
        )


def check_layout_markers(
    found: dict | None, expected: dict[str, str] | None, ckpt_dir: Path
) -> None:
    """Fail loudly when a native checkpoint's on-disk param layout predates
    the model's current contract. A checkpoint with NO marker for an
    expected key is treated as pre-versioning (e.g. gpt-oss gate_up saved
    interleaved before the contiguous flip) — loading it would not error
    anywhere, just silently mis-compute."""
    if not expected:
        return
    found = found or {}
    problems = []
    for key, want in expected.items():
        got = found.get(key)
        if got is None:
            problems.append(
                f"{key}: checkpoint has no layout marker (pre-versioning "
                f"save); current code expects {want!r}"
            )
        elif got != want:
            problems.append(f"{key}: checkpoint has {got!r}, code expects {want!r}")
    if problems:
        raise ValueError(
            f"native checkpoint {ckpt_dir} was saved under an incompatible "
            "param layout — re-export it through the HF path (to_hf/from_hf "
            "applies the layout transforms) instead of loading it natively:\n  "
            + "\n  ".join(problems)
        )


def _json_default(o: Any):
    if isinstance(o, torch.Tensor):
        return o.tolist()
    if hasattr(o, "tolist"):  # numpy values
        return o.tolist()
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"not JSON serializable: {type(o)}")
