"""GPT pretraining dataset: epoch-shuffled documents → fixed-length samples,
port of ``automodel_tpu/data/megatron/gpt_dataset.py``: doc_idx
(epoch-repeated shuffled documents), sample_idx (native
``build_sample_idx``), shuffle_idx, and weighted blending across datasets.
Samples are (seq_length+1)-token windows crossing document boundaries.

``__getitem__`` returns labels already shifted (``tokens[1:]``), and
``default_collater`` shifts them again, so each position trains on the
token two ahead. That is the JAX package's behaviour, and the port copies
it (tests/test_torch_data_megatron.py pins it by name); a fix belongs to
both packages at once.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

from automodel_tpu_torch.data.megatron.helpers import (
    build_blending_indices,
    build_sample_idx,
)
from automodel_tpu_torch.data.megatron.indexed_dataset import IndexedDataset

logger = logging.getLogger(__name__)


class GPTDataset:
    def __init__(
        self,
        indexed: IndexedDataset | str,
        seq_length: int,
        num_samples: int | None = None,
        seed: int = 0,
        shuffle: bool = True,
    ):
        if not isinstance(indexed, IndexedDataset):
            indexed = IndexedDataset(indexed)
        self.indexed = indexed
        self.seq_length = seq_length
        tokens_per_epoch = indexed.num_tokens
        samples_per_epoch = max((tokens_per_epoch - 1) // seq_length, 1)
        self.num_samples = num_samples or samples_per_epoch
        num_epochs = int(np.ceil((self.num_samples * (seq_length + 1)) / max(tokens_per_epoch, 1))) + 1

        rng = np.random.default_rng(seed)
        n_docs = len(indexed)
        doc_idx = np.tile(np.arange(n_docs, dtype=np.int64), num_epochs)
        if shuffle:
            # shuffle each epoch independently (Megatron semantics)
            doc_idx = doc_idx.reshape(num_epochs, n_docs)
            for e in range(num_epochs):
                rng.shuffle(doc_idx[e])
            doc_idx = doc_idx.reshape(-1)
        self.doc_idx = doc_idx
        self.sample_idx = build_sample_idx(
            indexed.sizes, doc_idx, seq_length, self.num_samples
        )
        self.shuffle_idx = np.arange(self.num_samples, dtype=np.int64)
        if shuffle:
            rng.shuffle(self.shuffle_idx)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> dict:
        i = int(self.shuffle_idx[idx])
        (d0, o0), (d1, o1) = self.sample_idx[i], self.sample_idx[i + 1]
        if d0 == d1:
            tokens = self.indexed.get_slice(
                int(self.doc_idx[d0]), int(o0), int(o1 - o0 + 1)
            )
        else:
            parts = [self.indexed[int(self.doc_idx[d0])][int(o0):]]
            parts += [self.indexed[int(self.doc_idx[d])] for d in range(d0 + 1, d1)]
            parts.append(self.indexed[int(self.doc_idx[d1])][: int(o1) + 1])
            tokens = np.concatenate(parts)
        tokens = np.asarray(tokens, np.int32)
        assert len(tokens) == self.seq_length + 1, (len(tokens), self.seq_length)
        return {"input_ids": tokens[:-1], "labels": tokens[1:].astype(np.int32)}


class BlendedDataset:
    """Weighted mixture of datasets (reference: blended dataset builder)."""

    def __init__(self, datasets: Sequence, weights: Sequence[float], num_samples: int):
        assert len(datasets) == len(weights) > 0
        self.datasets = list(datasets)
        self.dataset_index, self.dataset_sample_index = build_blending_indices(
            np.asarray(weights, np.float64), num_samples
        )

    def __len__(self) -> int:
        return len(self.dataset_index)

    def __getitem__(self, idx: int) -> dict:
        d = self.datasets[int(self.dataset_index[idx])]
        return d[int(self.dataset_sample_index[idx]) % len(d)]


class MegatronPretraining:
    """YAML-facing wrapper (reference: MegatronPretraining,
    llm/megatron_dataset.py:418): paths [+ optional weights] → blended GPT
    dataset."""

    def __init__(
        self,
        paths: Sequence[str] | str,
        seq_length: int,
        num_samples: int | None = None,
        weights: Sequence[float] | None = None,
        seed: int = 0,
    ):
        if isinstance(paths, str):
            paths = [paths]
        datasets = [
            GPTDataset(p, seq_length, num_samples=num_samples, seed=seed + i)
            for i, p in enumerate(paths)
        ]
        if len(datasets) == 1:
            self._ds = datasets[0]
        else:
            total = num_samples or sum(len(d) for d in datasets)
            self._ds = BlendedDataset(
                datasets, weights or [len(d) for d in datasets], total
            )

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, idx: int) -> dict:
        return self._ds[idx]
