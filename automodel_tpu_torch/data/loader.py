"""Data loading, port of ``DataLoader`` (:45) of
``automodel_tpu/data/loader.py`` at the numpy level: shuffled epochs of
collated global batches. Batch i of an epoch is built from the (seed,
epoch) shuffle order alone (``batch_for``), so a resume point (``seek``,
``state_dict``) replays the same stream. The recipe moves batches to the
device (``place_batch`` of the JAX package becomes a torch copy there)."""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np

from automodel_tpu_torch.data.collators import default_collater


class DataLoader:
    """Map-style dataset → shuffled epochs of ``default_collater``-collated
    global batches; a trailing partial batch is dropped."""

    def __init__(self, dataset: Any, global_batch_size: int, seed: int = 0, **collate_kwargs: Any):
        self.dataset = dataset
        self.global_batch_size = int(global_batch_size)
        self.collate_kwargs = collate_kwargs
        self.seed = seed
        self.epoch = 0
        self.batch_in_epoch = 0
        self._order: tuple[tuple, np.ndarray] | None = None

    def __len__(self) -> int:
        return len(self.dataset) // self.global_batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        key = (self.seed, epoch)
        if self._order is None or self._order[0] != key:
            order = np.arange(len(self.dataset))
            np.random.default_rng(self.seed * 1000003 + epoch).shuffle(order)
            self._order = (key, order)
        return self._order[1]

    def batch_for(self, epoch: int, i: int) -> dict:
        """Collate batch ``i`` of epoch ``epoch`` (pure in the cursor)."""
        order = self._epoch_order(epoch)
        idx = order[i * self.global_batch_size : (i + 1) * self.global_batch_size]
        return default_collater([self.dataset[int(j)] for j in idx], **self.collate_kwargs)

    def __iter__(self) -> Iterator[dict]:
        """The rest of the current epoch, then the cursor moves to the next."""
        while self.batch_in_epoch < len(self):
            batch = self.batch_for(self.epoch, self.batch_in_epoch)
            self.batch_in_epoch += 1
            yield batch
        self.epoch += 1
        self.batch_in_epoch = 0

    def seek(self, epoch: int, batch_in_epoch: int) -> None:
        """Jump the cursor to an exact position."""
        self.epoch = int(epoch)
        self.batch_in_epoch = int(batch_in_epoch)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "batch_in_epoch": self.batch_in_epoch, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.batch_in_epoch = state["batch_in_epoch"]
        self.seed = state.get("seed", self.seed)
