"""Data loading, port of ``DataLoader`` (:45) of
``automodel_tpu/data/loader.py`` at the numpy level: shuffled epochs of
collated global batches.

Batch construction is functional: ``batch_for(epoch, i)`` builds batch i
of an epoch from the (seed, epoch) shuffle order alone, with no mutable
cursor involved, so the sync iterator and the prefetch pipeline's collate
workers (data/prefetch.py, which call it at once from a thread pool) give
the same stream from any resume point (``seek``, ``state_dict``). The
recipe moves batches to the device (``place_batch`` of the JAX package
becomes a torch copy there, recipes/train_ft.py)."""

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
        thread-safe given a read-only dataset)."""
        order = self._epoch_order(epoch)
        idx = order[i * self.global_batch_size : (i + 1) * self.global_batch_size]
        return self.collate_fn([self.dataset[int(j)] for j in idx], **self.collate_kwargs)

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

