"""Sequence packing, port of ``pack_sequences`` (:20) of
``automodel_tpu/data/packed.py``: greedy fill of tokenized examples into
rows of a fixed size. Packing emits ``segment_ids`` (0 for padding, real
documents from 1) and position ids that restart in each document; the
attention backends keep documents apart by segment equality, which is what
the flash kernels' segment path (ops/ring_flash.py) takes. Collate the rows
with ``collators.packed_collater``."""

from __future__ import annotations

from typing import Iterable, Iterator

IGNORE_INDEX = -100


def pack_sequences(
    examples: Iterable[dict],
    packed_sequence_size: int,
    pad_token_id: int = 0,
    drop_overlong: bool = True,
) -> Iterator[dict]:
    """Greedy packing → examples of exactly ``packed_sequence_size`` tokens.
    An example that does not fit the current row closes it (padded); one
    longer than a row is dropped, or cut to the row with
    ``drop_overlong=False``."""
    buf_ids: list[int] = []
    buf_labels: list[int] = []
    buf_pos: list[int] = []
    buf_seg: list[int] = []
    seg = 1

    def flush():
        nonlocal buf_ids, buf_labels, buf_pos, buf_seg, seg
        pad = packed_sequence_size - len(buf_ids)
        yield {
            "input_ids": buf_ids + [pad_token_id] * pad,
            "labels": buf_labels + [IGNORE_INDEX] * pad,
            "position_ids": buf_pos + [0] * pad,
            "segment_ids": buf_seg + [0] * pad,
        }
        buf_ids, buf_labels, buf_pos, buf_seg, seg = [], [], [], [], 1

    for ex in examples:
        ids = list(ex["input_ids"])
        labels = list(ex.get("labels", ids))
        if len(ids) > packed_sequence_size:
            if drop_overlong:
                continue
            ids = ids[:packed_sequence_size]
            labels = labels[:packed_sequence_size]
        if len(buf_ids) + len(ids) > packed_sequence_size:
            yield from flush()
        buf_ids += ids
        buf_labels += labels
        buf_pos += list(range(len(ids)))
        buf_seg += [seg] * len(ids)
        seg += 1
    if buf_ids:
        yield from flush()
