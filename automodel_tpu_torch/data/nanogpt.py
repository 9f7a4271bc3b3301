"""nanoGPT-style streaming dataset: flat memory-mapped token shards, port of
``automodel_tpu/data/nanogpt.py`` (reference nanogpt_dataset.py): .bin
files of tokens, samples are strided windows, several shard sets blended by
weight with resumable mid-stream state.

Every window is addressable by a flat index: ``BlendedNanogptDataset``
fixes the whole blend schedule (which source, which window) from the seed
at init, so the DataLoader's ``(epoch, batch_in_epoch)`` cursor is the
whole resumable state. A resume, a prefetch flush or a rollback that lands
mid-stream (across a .bin shard boundary or a source boundary) derives the
same sample from the index alone.

As in the JAX package, windows return labels already shifted (the collator
shifts again), and ``dtype`` defaults to ``uint16``: shards of a vocabulary
past 65,535 tokens must be read as ``uint32``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import numpy as np


class NanogptDataset:
    def __init__(
        self,
        paths: Sequence[str] | str,
        seq_length: int,
        dtype=np.uint16,
        stride: int | None = None,
    ):
        if isinstance(paths, (str, Path)):
            p = Path(paths)
            paths = sorted(p.glob("*.bin")) if p.is_dir() else [p]
        self.shards = [np.memmap(f, dtype=dtype, mode="r") for f in paths]
        if not self.shards:
            raise FileNotFoundError(f"no .bin shards in {paths}")
        self.seq_length = seq_length
        self.stride = stride or seq_length
        self._counts = [
            max((len(s) - seq_length - 1) // self.stride + 1, 0) for s in self.shards
        ]
        self._cum = np.cumsum([0] + self._counts)

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, idx: int) -> dict:
        shard_i = int(np.searchsorted(self._cum, idx, side="right") - 1)
        local = idx - self._cum[shard_i]
        start = int(local * self.stride)
        window = np.asarray(
            self.shards[shard_i][start : start + self.seq_length + 1], np.int32
        )
        return {"input_ids": window[:-1], "labels": window[1:]}


class BlendedNanogptDataset:
    """Weighted blend of several shard sets (e.g. web + code + books bins).

    ``sources`` is a list of ``{"paths": <dir|file|list>, "weight": w}``
    dicts (weight defaults to 1.0; weights are normalized). Sample ``i``
    deterministically draws its source from the normalized weights via
    ``rng(seed)`` and reads that source's next unread window — the whole
    schedule (assignment + per-source positions) is precomputed at init,
    so ``__getitem__`` is pure random access and resumable by index. A
    source shorter than its share of the schedule wraps, re-shuffling its
    window order per pass (``shuffle_windows``) so a wrapped pass never
    replays the previous pass's order.

    ``num_samples`` sets the schedule length (default: the weighted blend
    exhausts the largest source exactly once).
    """

    def __init__(
        self,
        sources: Sequence[Any],
        seq_length: int,
        seed: int = 0,
        num_samples: int | None = None,
        shuffle_windows: bool = True,
        dtype=np.uint16,
        stride: int | None = None,
    ):
        if not sources:
            raise ValueError("BlendedNanogptDataset needs at least one source")
        norm: list[dict] = []
        for s in sources:
            if isinstance(s, (str, Path)):
                s = {"paths": s}
            norm.append(dict(s))
        self.datasets = [
            NanogptDataset(s["paths"], seq_length, dtype=dtype, stride=stride)
            for s in norm
        ]
        weights = np.asarray([float(s.get("weight", 1.0)) for s in norm], np.float64)
        if (weights <= 0).any():
            raise ValueError(f"source weights must be > 0, got {weights.tolist()}")
        empty = [
            str(norm[i]["paths"]) for i, d in enumerate(self.datasets) if not len(d)
        ]
        if empty:
            # fail at init, not at the arbitrary mid-training step whose
            # schedule slot first lands on the windowless source
            raise ValueError(
                f"blended source(s) yield zero windows at seq_length="
                f"{seq_length}: {empty}"
            )
        self.weights = weights / weights.sum()
        self.seq_length = seq_length
        self.seed = seed
        self.shuffle_windows = shuffle_windows
        if num_samples is None:
            # the blend that consumes the dominating source exactly once:
            # len(d_k)/w_k maximized over sources
            num_samples = int(
                max(len(d) / w for d, w in zip(self.datasets, self.weights))
            )
        if num_samples <= 0:
            raise ValueError(f"num_samples must be > 0, got {num_samples}")
        rng = np.random.default_rng(seed)
        # schedule: source per sample + that sample's running position
        # WITHIN its source (count of earlier samples from the same source)
        self._assignment = rng.choice(
            len(self.datasets), size=num_samples, p=self.weights
        ).astype(np.int64)
        self._position = np.zeros(num_samples, np.int64)
        for s in range(len(self.datasets)):
            mask = self._assignment == s
            self._position[mask] = np.arange(int(mask.sum()))
        # per-source, per-pass window permutations are derived lazily (a
        # long schedule over a short source makes many passes; most runs
        # touch pass 0 only)
        self._perm_cache: dict[tuple[int, int], np.ndarray] = {}

    def __len__(self) -> int:
        return len(self._assignment)

    def _window_order(self, source: int, pass_no: int) -> np.ndarray:
        key = (source, pass_no)
        perm = self._perm_cache.get(key)
        if perm is None:
            n = len(self.datasets[source])
            if self.shuffle_windows:
                perm = np.random.default_rng(
                    self.seed * 9176 + source * 131 + pass_no
                ).permutation(n)
            else:
                perm = np.arange(n)
            if len(self._perm_cache) > 64:
                self._perm_cache.clear()
            self._perm_cache[key] = perm
        return perm

    def __getitem__(self, idx: int) -> dict:
        source = int(self._assignment[idx])
        d = self.datasets[source]
        pos = int(self._position[idx])
        pass_no, local = divmod(pos, len(d))
        return d[int(self._window_order(source, pass_no)[local])]

    def source_counts(self) -> list[int]:
        """Samples the schedule draws from each source (tests/telemetry)."""
        return [int((self._assignment == s).sum()) for s in range(len(self.datasets))]
