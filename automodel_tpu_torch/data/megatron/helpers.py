"""ctypes bindings for the native index builders, with numpy versions, port
of ``automodel_tpu/data/megatron/helpers.py``.

The port keeps its own copy of the C++ (``helpers.cpp`` beside this file)
and builds it with ``g++ -O3 -shared -fPIC`` at first use into
``automodel_tpu_torch/_build/libmegatron_helpers-<hash>.so``, the hash of
the source, as ops/_cuda_build.py keys the kernels' libraries: never
beside the source, and an edited source never loads a stale library. As in
the JAX package, a host without a compiler falls back to the numpy
versions with a warning (host index building, not a device kernel);
``native_available()`` says which path runs, and ``native_calls`` counts
the builders' calls that went through the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "helpers.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False
# builder name → calls that ran the native library (chip_smoke.py checks it)
native_calls: dict[str, int] = {}


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmegatron_helpers-{digest}.so"


def _count(name: str) -> None:
    native_calls[name] = native_calls.get(name, 0) + 1


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.build_sample_idx.restype = ctypes.c_int64
        lib.build_sample_idx.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.build_blending_indices.restype = None
        lib.build_blending_indices.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
            ctypes.c_int64,
        ]
        lib.build_exhaustive_blending_indices.restype = None
        lib.build_exhaustive_blending_indices.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
        ]
        lib.build_mapping.restype = ctypes.c_int64
        lib.build_mapping.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.build_blocks_mapping.restype = ctypes.c_int64
        lib.build_blocks_mapping.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    except Exception as e:  # no toolchain → the numpy versions
        logger.warning("native helpers unavailable (%s); using the numpy versions", e)
    return _lib


def native_available() -> bool:
    """Whether the builders run the native library (building it if needed)."""
    return _load() is not None


def build_sample_idx(
    sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int, max_samples: int
) -> np.ndarray:
    """[(num_samples+1), 2] int64 (doc_idx position, in-document offset)."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int64)
    out = np.zeros((max_samples + 1, 2), np.int64)
    lib = _load()
    if lib is not None:
        _count("build_sample_idx")
        n = lib.build_sample_idx(
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(doc_idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_samples,
            seq_length,
        )
        if n < 0:
            raise ValueError(
                f"doc_idx exhausted: {max_samples} samples of {seq_length + 1} "
                f"tokens need more than {int(sizes[doc_idx].sum())} tokens"
            )
        return out[: n + 1]
    return _build_sample_idx_py(sizes, doc_idx, seq_length, max_samples)


def _build_sample_idx_py(sizes, doc_idx, seq_length, max_samples):
    out = [(0, 0)]
    doc_pos, doc_offset = 0, 0
    for _ in range(max_samples):
        remaining = seq_length + 1
        while remaining > 0:
            if doc_pos >= len(doc_idx):
                raise ValueError("doc_idx exhausted")
            doc_len = int(sizes[doc_idx[doc_pos]]) - doc_offset
            if doc_len > remaining:
                doc_offset += remaining - 1
                remaining = 0
            else:
                remaining -= doc_len
                doc_pos += 1
                doc_offset = 0
        out.append((doc_pos, doc_offset))
    return np.asarray(out, np.int64)


def build_blending_indices(
    weights: np.ndarray, size: int
) -> tuple[np.ndarray, np.ndarray]:
    """(dataset_index int16 [size], dataset_sample_index int64 [size])."""
    w = np.ascontiguousarray(weights, np.float64)
    w = w / w.sum()
    d_idx = np.zeros(size, np.int16)
    s_idx = np.zeros(size, np.int64)
    lib = _load()
    if lib is not None:
        _count("build_blending_indices")
        lib.build_blending_indices(
            d_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            s_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(w),
            size,
        )
        return d_idx, s_idx
    return _build_blending_indices_py(w, size)


def _build_blending_indices_py(w, size):
    d_idx = np.zeros(size, np.int16)
    s_idx = np.zeros(size, np.int64)
    current = np.zeros(len(w), np.int64)
    for i in range(size):
        err = w * (i + 1) - current
        pick = int(err.argmax())
        d_idx[i] = pick
        s_idx[i] = current[pick]
        current[pick] += 1
    return d_idx, s_idx


def build_exhaustive_blending_indices(
    sizes: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Draw EXACTLY sizes[d] samples from each dataset, interleaved by
    remaining fraction (reference build_exhaustive_blending_indices:21).
    → (dataset_index int16 [sum(sizes)], dataset_sample_index int64)."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    total = int(sizes.sum())
    d_idx = np.zeros(total, np.int16)
    s_idx = np.zeros(total, np.int64)
    lib = _load()
    if lib is not None:
        _count("build_exhaustive_blending_indices")
        lib.build_exhaustive_blending_indices(
            d_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            s_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(sizes),
        )
        return d_idx, s_idx
    return _build_exhaustive_blending_indices_py(sizes)


def _build_exhaustive_blending_indices_py(sizes):
    total = int(sizes.sum())
    d_idx = np.zeros(total, np.int16)
    s_idx = np.zeros(total, np.int64)
    drawn = np.zeros(len(sizes), np.int64)
    for i in range(total):
        frac = np.where(sizes > drawn, (sizes - drawn) / np.maximum(sizes, 1), -1.0)
        pick = int(frac.argmax())
        d_idx[i] = pick
        s_idx[i] = drawn[pick]
        drawn[pick] += 1
    return d_idx, s_idx


_LONG_SENTENCE_LEN = 512


def build_mapping(
    docs: np.ndarray,  # [n_docs+1] sentence offsets
    sizes: np.ndarray,  # [n_sents] token counts
    num_epochs: int,
    max_num_samples: int,
    max_seq_length: int,
    short_seq_prob: float,
    seed: int,
    min_num_sent: int = 2,
) -> np.ndarray:
    """BERT-style sample mapping → [n, 3] int64 rows
    (start_sent, end_sent_exclusive, target_seq_len), shuffled (reference
    build_mapping:266-562: greedy sentence packing to a randomized target,
    skipping docs with <min_num_sent sentences or any sentence >512)."""
    docs = np.ascontiguousarray(docs, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int32)
    n_docs = len(docs) - 1
    lib = _load()
    if lib is not None:
        _count("build_mapping")
        args = (
            docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_docs,
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_epochs, max_num_samples, max_seq_length, short_seq_prob,
            seed, min_num_sent,
        )
        n = lib.build_mapping(*args, None)
        out = np.empty((n, 3), np.int64)
        lib.build_mapping(
            *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        return out
    return _build_mapping_py(
        docs, sizes, num_epochs, max_num_samples, max_seq_length,
        short_seq_prob, seed, min_num_sent,
    )


def _build_mapping_py(docs, sizes, num_epochs, max_num_samples,
                      max_seq_length, short_seq_prob, seed, min_num_sent):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(num_epochs):
        if len(rows) >= max_num_samples:
            break
        for doc in range(len(docs) - 1):
            first, last = int(docs[doc]), int(docs[doc + 1])
            remain = last - first
            if remain < min_num_sent:
                continue
            if (sizes[first:last] > _LONG_SENTENCE_LEN).any():
                continue
            prev_start, seq_len, num_sent = first, 0, 0

            def tgt():
                if short_seq_prob > 0 and rng.random() < short_seq_prob:
                    return 2 + int(rng.integers(0, max_seq_length - 1))
                return max_seq_length

            target = tgt()
            for s in range(first, last):
                seq_len += int(sizes[s])
                num_sent += 1
                remain -= 1
                if (seq_len >= target and remain > 1 and num_sent >= min_num_sent) or remain == 0:
                    rows.append((prev_start, s + 1, target))
                    prev_start, seq_len, num_sent = s + 1, 0, 0
                    target = tgt()
    out = np.asarray(rows, np.int64).reshape(-1, 3)
    rng2 = np.random.default_rng(seed + 1)
    return out[rng2.permutation(len(out))]


def build_blocks_mapping(
    docs: np.ndarray,
    sizes: np.ndarray,
    titles_sizes: np.ndarray,  # [n_docs] title token counts
    num_epochs: int,
    max_num_samples: int,
    max_seq_length: int,
    seed: int,
    use_one_sent_blocks: bool = False,
) -> np.ndarray:
    """ICT/paired-block mapping → [n, 4] int64 rows
    (start_sent, end_sent_exclusive, doc, block_id), shuffled; per-doc
    target = max_seq_length - title size (reference
    build_blocks_mapping:564-805)."""
    docs = np.ascontiguousarray(docs, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int32)
    titles_sizes = np.ascontiguousarray(titles_sizes, np.int32)
    n_docs = len(docs) - 1
    lib = _load()
    if lib is not None:
        _count("build_blocks_mapping")
        args = (
            docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_docs,
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            titles_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_epochs, max_num_samples, max_seq_length, seed,
            int(use_one_sent_blocks),
        )
        n = lib.build_blocks_mapping(*args, None)
        out = np.empty((n, 4), np.int64)
        lib.build_blocks_mapping(
            *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        return out
    return _build_blocks_mapping_py(
        docs, sizes, titles_sizes, num_epochs, max_num_samples, max_seq_length,
        seed, use_one_sent_blocks,
    )


def _build_blocks_mapping_py(docs, sizes, titles_sizes, num_epochs,
                             max_num_samples, max_seq_length, seed,
                             use_one_sent_blocks):
    n_docs = len(docs) - 1
    min_num_sent = 1 if use_one_sent_blocks else 2
    rows = []
    for _ in range(num_epochs):
        if len(rows) >= max_num_samples:
            break
        block_id = 0
        for doc in range(n_docs):
            first, last = int(docs[doc]), int(docs[doc + 1])
            target = max_seq_length - int(titles_sizes[doc])
            remain = last - first
            if remain < min_num_sent or target <= 0:
                continue
            if (sizes[first:last] > _LONG_SENTENCE_LEN).any():
                continue
            prev_start, seq_len, num_sent = first, 0, 0
            for s in range(first, last):
                seq_len += int(sizes[s])
                num_sent += 1
                remain -= 1
                if (seq_len >= target and remain > 1 and num_sent >= min_num_sent) or remain == 0:
                    rows.append((prev_start, s + 1, doc, block_id))
                    block_id += 1
                    prev_start, seq_len, num_sent = s + 1, 0, 0
    out = np.asarray(rows, np.int64).reshape(-1, 4)
    rng2 = np.random.default_rng(seed + 1)
    return out[rng2.permutation(len(out))]
