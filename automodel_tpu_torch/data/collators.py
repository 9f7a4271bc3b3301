"""Batch collation, port of ``default_collater`` (:30), ``packed_collater``
(:65) and ``stack_microbatches`` (:159) of
``automodel_tpu/data/collators.py``, at the numpy level. The collator emits already-shifted labels (labels[t] is the
target of position t, ``IGNORE_INDEX`` on padding, prompt and the final
position), so model and loss never shift."""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

IGNORE_INDEX = -100


def _pad_to(x: Sequence[int], length: int, value: int) -> np.ndarray:
    arr = np.full((length,), value, dtype=np.int32)
    arr[: len(x)] = np.asarray(x[:length], dtype=np.int32)
    return arr


def _round_up(n: int, div: int) -> int:
    return ((n + div - 1) // div) * div


def default_collater(
    examples: Iterable[dict[str, Any]],
    pad_token_id: int = 0,
    pad_seq_len_divisible: int | None = None,
    max_seq_len: int | None = None,
) -> dict[str, Any]:
    """examples: dicts with ``input_ids`` and optional ``labels`` (unshifted,
    IGNORE_INDEX-masked) → input_ids/labels/position_ids [B, S] int32 with
    labels shifted for next-token prediction, and ``num_label_tokens``."""
    examples = list(examples)
    seq = max(len(e["input_ids"]) for e in examples)
    if max_seq_len is not None:
        seq = min(seq, max_seq_len)
    if pad_seq_len_divisible:
        seq = _round_up(seq, pad_seq_len_divisible)
    input_ids = np.stack([_pad_to(e["input_ids"], seq, pad_token_id) for e in examples])
    raw_labels = np.stack([_pad_to(e.get("labels", e["input_ids"]), seq, IGNORE_INDEX) for e in examples])
    labels = np.full_like(raw_labels, IGNORE_INDEX)
    labels[:, :-1] = raw_labels[:, 1:]
    lengths = np.asarray([min(len(e["input_ids"]), seq) for e in examples])
    pos = np.arange(seq)[None, :]
    position_ids = np.where(pos < lengths[:, None], pos, 0).astype(np.int32)
    return {
        "input_ids": input_ids,
        "labels": labels,
        "position_ids": position_ids,
        "num_label_tokens": int((labels != IGNORE_INDEX).sum()),
    }


def packed_collater(
    examples: Iterable[dict[str, Any]],
    pad_token_id: int = 0,
) -> dict[str, Any]:
    """Collate pre-packed examples (data/packed.py): each example already
    carries input_ids/labels/position_ids/segment_ids of equal length.
    Labels shift within a segment; the last position of a segment (whose
    next token starts another document) gets ``IGNORE_INDEX``."""
    examples = list(examples)
    input_ids = np.stack([np.asarray(e["input_ids"], np.int32) for e in examples])
    raw_labels = np.stack([np.asarray(e["labels"], np.int32) for e in examples])
    segment_ids = np.stack([np.asarray(e["segment_ids"], np.int32) for e in examples])
    position_ids = np.stack([np.asarray(e["position_ids"], np.int32) for e in examples])
    labels = np.full_like(raw_labels, IGNORE_INDEX)
    labels[:, :-1] = raw_labels[:, 1:]
    same_seg = segment_ids[:, :-1] == segment_ids[:, 1:]
    labels[:, :-1] = np.where(same_seg, labels[:, :-1], IGNORE_INDEX)
    return {
        "input_ids": input_ids,
        "labels": labels,
        "position_ids": position_ids,
        "segment_ids": segment_ids,
        "num_label_tokens": int((labels != IGNORE_INDEX).sum()),
    }


def stack_microbatches(batches: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """[A] list of collated batches → arrays with a leading accumulation axis."""
    keys = [k for k in batches[0] if isinstance(batches[0][k], np.ndarray)]
    out: dict[str, Any] = {k: np.stack([b[k] for b in batches]) for k in keys}
    out["num_label_tokens"] = int(sum(b.get("num_label_tokens", 0) for b in batches))
    return out
