"""Megatron-style pretraining samplers, port of
``automodel_tpu/data/megatron/sampler.py``.

Parity: reference datasets/llm/megatron/sampler.py:353 —
``MegatronPretrainingSampler`` (sequential, resumable at an exact consumed-
sample offset) and ``MegatronPretrainingRandomSampler`` (epoch-shuffled
buckets, same resumability). One process consumes the global batch, so
the per-rank offset/stride of the reference collapses to
(consumed_samples, global_batch_size) state.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class MegatronPretrainingSampler:
    """Sequential batches of dataset indices, resumable mid-epoch."""

    def __init__(
        self,
        total_samples: int,
        global_batch_size: int,
        consumed_samples: int = 0,
        drop_last: bool = True,
    ):
        if total_samples <= 0:
            raise ValueError("total_samples must be positive")
        self.total_samples = total_samples
        self.global_batch_size = global_batch_size
        self.consumed_samples = consumed_samples
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = self.total_samples - self.consumed_samples
        return n // self.global_batch_size if self.drop_last else -(-n // self.global_batch_size)

    def __iter__(self) -> Iterator[list[int]]:
        """Yield the remainder of the CURRENT epoch (offset = consumed %
        total), so per-epoch re-iteration works like any sampler."""
        start = self.consumed_samples % self.total_samples
        batch: list[int] = []
        for idx in range(start, self.total_samples):
            batch.append(idx)
            if len(batch) == self.global_batch_size:
                self.consumed_samples += len(batch)
                yield batch
                batch = []
        if batch:
            if self.drop_last:
                self.consumed_samples += len(batch)  # account the dropped tail
            else:
                self.consumed_samples += len(batch)
                yield batch

    def state_dict(self) -> dict:
        return {"consumed_samples": self.consumed_samples}

    def load_state_dict(self, state: dict) -> None:
        self.consumed_samples = int(state["consumed_samples"])


class MegatronPretrainingRandomSampler:
    """Per-epoch shuffled batches (reference: random sampler with
    epoch-seeded shuffle buckets), resumable at an exact sample offset."""

    def __init__(
        self,
        total_samples: int,
        global_batch_size: int,
        consumed_samples: int = 0,
        seed: int = 0,
    ):
        if total_samples <= 0:
            raise ValueError("total_samples must be positive")
        self.total_samples = total_samples
        self.global_batch_size = global_batch_size
        self.consumed_samples = consumed_samples
        self.seed = seed

    @property
    def epoch(self) -> int:
        return self.consumed_samples // self.total_samples

    def __len__(self) -> int:
        return self.total_samples // self.global_batch_size

    def __iter__(self) -> Iterator[list[int]]:
        """Yield the REMAINDER of the current epoch (shuffled with an
        epoch-derived seed); callers loop epochs like any sampler."""
        epoch = self.epoch
        perm = np.random.default_rng((self.seed, epoch)).permutation(
            self.total_samples
        )
        start = self.consumed_samples % self.total_samples
        usable = self.total_samples - (self.total_samples % self.global_batch_size)
        for off in range(start, usable, self.global_batch_size):
            if off + self.global_batch_size > usable:
                break
            batch = perm[off : off + self.global_batch_size].tolist()
            self.consumed_samples += len(batch)
            yield batch
        # account the dropped tail so the next epoch reshuffles cleanly
        rem = self.total_samples - (self.consumed_samples % self.total_samples)
        if rem != self.total_samples:
            self.consumed_samples += rem

    def state_dict(self) -> dict:
        return {"consumed_samples": self.consumed_samples, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.consumed_samples = int(state["consumed_samples"])
        self.seed = int(state.get("seed", self.seed))
