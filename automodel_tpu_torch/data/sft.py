"""SFT datasets, port of ``MockSFTDataset`` (:134) of
``automodel_tpu/data/sft.py``. Datasets that need a tokenizer or a download
(SQuAD, HellaSwag, column-mapped) wait until those files can be on the
machine; the recipe refuses them by name."""

from __future__ import annotations

import numpy as np

IGNORE_INDEX = -100


class MockSFTDataset:
    """Deterministic random-token dataset for tests and benchmarks: no
    tokenizer, no network. The first ``mask_ratio`` of each example is
    prompt (label ``IGNORE_INDEX``)."""

    def __init__(
        self,
        vocab_size: int = 32000,
        seq_length: int = 512,
        num_samples: int = 1024,
        seed: int = 0,
        mask_ratio: float = 0.25,
    ):
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.num_samples = num_samples
        self.seed = seed
        self.mask_ratio = mask_ratio

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        ids = rng.integers(3, self.vocab_size, size=self.seq_length).tolist()
        n_mask = int(self.seq_length * self.mask_ratio)
        labels = [IGNORE_INDEX] * n_mask + ids[n_mask:]
        return {"input_ids": ids, "labels": labels}
