"""Data loading, port of ``DataLoader`` (:45) of
``automodel_tpu/data/loader.py`` at the numpy level: shuffled epochs of
collated global batches.

Batch construction is functional: ``batch_for(epoch, i)`` builds batch i
of an epoch from the (seed, epoch) shuffle order alone, with no mutable
cursor involved, so the sync iterator and the prefetch pipeline's collate
workers (data/prefetch.py, which call it at once from a thread pool) give
the same stream from any resume point (``seek``, ``state_dict``). Under a
mesh every process loads the same global batch; ``local_batch`` (the
host half of JAX's ``place_batch``) cuts this rank's rows of the
``batch`` grouping and, under context parallelism, its sequence slice;
the recipe copies that to the device (recipes/train_ft.py)."""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator

import numpy as np

from automodel_tpu_torch.data.collators import default_collater


class DataLoader:
    """Map-style dataset → shuffled epochs of collated global batches.

    ``collate_fn`` (default ``default_collater``) gets a list of examples
    and ``**collate_kwargs``; ``shuffle: false`` keeps the dataset's
    order; ``drop_last: false`` keeps a trailing partial batch; with
    ``infinite`` one ``__iter__`` call runs epoch after epoch. Stateful:
    ``state_dict`` / ``load_state_dict`` resume mid-epoch."""

    def __init__(
        self,
        dataset: Any,
        global_batch_size: int,
        collate_fn: Callable | None = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        infinite: bool = False,
        **collate_kwargs: Any,
    ):
        self.dataset = dataset
        self.global_batch_size = int(global_batch_size)
        self.collate_fn = collate_fn or default_collater
        self.collate_kwargs = collate_kwargs
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.infinite = infinite
        self.epoch = 0
        self.batch_in_epoch = 0
        # (seed, epoch) → order for the epochs in flight: collate workers
        # near an epoch's end want e and e+1 at once. Keyed by seed too, as
        # load_state_dict / seek may change it; the lock keeps the dict's
        # mutation safe under concurrent workers
        self._order_cache: dict[tuple, np.ndarray] = {}
        self._order_lock = threading.Lock()

    def __len__(self) -> int:
        n = len(self.dataset) // self.global_batch_size
        if not self.drop_last and len(self.dataset) % self.global_batch_size:
            n += 1
        return n

    def _epoch_order(self, epoch: int | None = None) -> np.ndarray:
        epoch = self.epoch if epoch is None else epoch
        key = (self.seed, epoch)
        with self._order_lock:
            order = self._order_cache.get(key)
            if order is not None:
                return order
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed * 1000003 + epoch).shuffle(order)
        with self._order_lock:
            self._order_cache[key] = order
            for k in [k for k in self._order_cache if k[0] != self.seed or k[1] < epoch - 1]:
                del self._order_cache[k]
        return order

    def batch_for(self, epoch: int, i: int) -> dict:
        """Collate batch ``i`` of epoch ``epoch`` (pure in the cursor;
        thread-safe given a read-only dataset). The sync iterator and the
        prefetch collate workers both come here, so the injected collate
        delay (``fault_injection.slow_collate_ms``) hits both paths."""
        from automodel_tpu_torch.resilience.fault_injection import active_injector

        order = self._epoch_order(epoch)
        idx = order[i * self.global_batch_size : (i + 1) * self.global_batch_size]
        batch = self.collate_fn([self.dataset[int(j)] for j in idx], **self.collate_kwargs)
        inj = active_injector()
        if inj is not None:
            inj.maybe_slow_collate()
        return batch

    def __iter__(self) -> Iterator[dict]:
        """The rest of the current epoch, then the cursor moves to the next
        (and on, with ``infinite``)."""
        while True:
            while self.batch_in_epoch < len(self):
                batch = self.batch_for(self.epoch, self.batch_in_epoch)
                self.batch_in_epoch += 1
                yield batch
            self.epoch += 1
            self.batch_in_epoch = 0
            if not self.infinite:
                return

    def seek(self, epoch: int, batch_in_epoch: int) -> None:
        """Jump the cursor to an exact position (resume, the rollback's
        fast-forward)."""
        self.epoch = int(epoch)
        self.batch_in_epoch = int(batch_in_epoch)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "batch_in_epoch": self.batch_in_epoch, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.batch_in_epoch = state["batch_in_epoch"]
        self.seed = state.get("seed", self.seed)



# which leaves carry a sequence dim beside the batch dim (JAX :28-42)
SEQ_KEYS = frozenset(
    ("input_ids", "labels", "position_ids", "segment_ids", "behavior_logprobs", "ref_logprobs")
    + tuple(f"{side}_{key}" for side in ("chosen", "rejected") for key in ("input_ids", "labels", "position_ids"))
)


def local_batch(ctx: Any, batch: dict, microbatched: bool = True) -> dict:
    """This rank's part of a (possibly [A]-stacked) numpy global batch:
    rows ``[i B/n, (i+1) B/n)`` of the batch dim, i this rank's index in
    the ``batch`` grouping (``dp_replicate, dp_shard, ep``, of size n),
    and, for the sequence leaves under ``cp > 1``, the rank's contiguous
    slice of the (already zigzag-permuted, when zigzag) sequence. Non-array
    values pass through."""
    b_ax = 1 if microbatched else 0
    n_b, i_b = ctx.dp_size, ctx.coordinate("batch") if ctx.dp_size > 1 else 0
    n_s, i_s = ctx.cp_size, ctx.coordinate("cp") if ctx.cp_size > 1 else 0
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        if v.shape[b_ax] % n_b:
            raise ValueError(f"batch leaf {k} has {v.shape[b_ax]} rows, not a multiple of the {n_b} batch ranks")
        rows = v.shape[b_ax] // n_b
        v = np.take(v, np.arange(i_b * rows, (i_b + 1) * rows), axis=b_ax)
        if n_s > 1 and k in SEQ_KEYS:
            S = v.shape[b_ax + 1]
            if S % n_s:
                raise ValueError(f"batch leaf {k} has {S} tokens a row, not a multiple of cp={n_s}")
            s_loc = S // n_s
            v = np.take(v, np.arange(i_s * s_loc, (i_s + 1) * s_loc), axis=b_ax + 1)
        out[k] = np.ascontiguousarray(v)
    return out
