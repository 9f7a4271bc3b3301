"""Random pretraining corpora written from a seed, for runs and tests that
need a Megatron or nanoGPT corpus on disk and have none: no tokenizer, no
download. Token ids are uniform over the vocabulary; a Megatron corpus
holds documents of log-normal lengths.

    python -m automodel_tpu_torch.data.synthetic megatron PREFIX --tokens N --vocab V [--seed S]
    python -m automodel_tpu_torch.data.synthetic nanogpt DIR --shards K --tokens N --vocab V [--seed S]

A vocabulary past 65,535 ids is written as ``uint32`` (the writers'
``uint16`` default would wrap it), and the readers then need the same
dtype: the Megatron ``.idx`` carries it, a nanoGPT source takes ``dtype``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from automodel_tpu_torch.data.megatron.indexed_dataset import IndexedDatasetWriter


def token_dtype(vocab_size: int) -> np.dtype:
    return np.dtype(np.uint16 if vocab_size <= 65536 else np.uint32)


def document_lengths(n_tokens: int, seed: int, median: int = 1536, sigma: float = 1.0,
                     min_len: int = 16, max_len: int = 16384) -> np.ndarray:
    """Log-normal document lengths (median ``median``, clipped to
    [min_len, max_len]) summing to exactly ``n_tokens``; the last document
    is cut to fit."""
    rng = np.random.default_rng(seed)
    need = int(n_tokens / median * 1.5) + 16
    lengths = np.empty(0, np.int64)
    while lengths.sum() < n_tokens:
        draw = np.clip(np.round(rng.lognormal(np.log(median), sigma, need)), min_len, max_len).astype(np.int64)
        lengths = np.concatenate([lengths, draw])
    cut = int(np.searchsorted(np.cumsum(lengths), n_tokens))
    lengths = lengths[: cut + 1].copy()
    lengths[-1] -= int(lengths.sum()) - n_tokens
    return lengths[lengths > 0]


def write_megatron_corpus(prefix: str | Path, n_tokens: int, vocab_size: int, seed: int = 0,
                          median: int = 1536) -> dict:
    """``prefix.bin`` / ``prefix.idx`` of ``n_tokens`` random tokens →
    {documents, tokens, bytes, dtype, seconds}."""
    t0 = time.perf_counter()
    prefix = Path(prefix)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    dtype = token_dtype(vocab_size)
    lengths = document_lengths(n_tokens, seed, median)
    tokens = np.random.default_rng(seed + 1).integers(0, vocab_size, n_tokens, dtype=dtype)
    with IndexedDatasetWriter(prefix, dtype=dtype) as w:
        start = 0
        for n in lengths:
            w.add_document(tokens[start : start + n])
            start += int(n)
    nbytes = prefix.with_suffix(".bin").stat().st_size + prefix.with_suffix(".idx").stat().st_size
    return dict(documents=len(lengths), tokens=n_tokens, bytes=nbytes, dtype=dtype.name,
                seconds=time.perf_counter() - t0)


def write_nanogpt_shards(directory: str | Path, n_shards: int, tokens_per_shard: int, vocab_size: int,
                         seed: int = 0) -> dict:
    """``directory/shard_<k>.bin`` files of random tokens →
    {shards, tokens, bytes, dtype, seconds}."""
    t0 = time.perf_counter()
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    dtype = token_dtype(vocab_size)
    rng = np.random.default_rng(seed)
    nbytes = 0
    for k in range(n_shards):
        path = directory / f"shard_{k:03d}.bin"
        rng.integers(0, vocab_size, tokens_per_shard, dtype=dtype).tofile(path)
        nbytes += path.stat().st_size
    return dict(shards=n_shards, tokens=n_shards * tokens_per_shard, bytes=nbytes, dtype=dtype.name,
                seconds=time.perf_counter() - t0)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m automodel_tpu_torch.data.synthetic", description=__doc__.split("\n\n")[0])
    p.add_argument("kind", choices=("megatron", "nanogpt"))
    p.add_argument("path", help="the corpus prefix (megatron) or shard directory (nanogpt)")
    p.add_argument("--tokens", type=int, required=True, help="tokens in all (megatron) or a shard (nanogpt)")
    p.add_argument("--vocab", type=int, required=True)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.kind == "megatron":
        out = write_megatron_corpus(args.path, args.tokens, args.vocab, args.seed)
    else:
        out = write_nanogpt_shards(args.path, args.shards, args.tokens, args.vocab, args.seed)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
