"""Delta Lake / lakehouse table dataset, port of
``automodel_tpu/data/delta_lake.py`` (reference
datasets/llm/delta_lake_dataset.py). Gated on the optional ``deltalake``
package (imported at construction); rows become column-mapped tokenized
samples.
"""

from __future__ import annotations

import logging
from typing import Any, Iterator, Optional

from automodel_tpu_torch.data.collators import IGNORE_INDEX

logger = logging.getLogger(__name__)


class DeltaLakeDataset:
    """Rows of a Delta table → input_ids/labels samples.

    ``table_uri``: local path / s3:// / abfss:// Delta table.
    ``context_column``/``answer_column`` mirror the column-mapped SFT
    dataset: loss covers the answer tokens only when both are given.
    """

    def __init__(
        self,
        table_uri: str,
        tokenizer: Any,
        context_column: str = "context",
        answer_column: Optional[str] = None,
        max_len: int = 1024,
        storage_options: Optional[dict] = None,
        limit: Optional[int] = None,
    ):
        try:
            from deltalake import DeltaTable
        except ImportError as exc:
            raise ImportError(
                "DeltaLakeDataset requires the optional `deltalake` package "
                "(pip install deltalake)"
            ) from exc
        table = DeltaTable(table_uri, storage_options=storage_options)
        tbl = table.to_pyarrow_table(columns=self._columns(context_column, answer_column))
        if limit:
            tbl = tbl.slice(0, limit)  # slice the arrow view BEFORE python-izing
        self._rows = tbl.to_pylist()
        self.tokenizer = tokenizer
        self.context_column = context_column
        self.answer_column = answer_column
        self.max_len = max_len
        logger.info("DeltaLakeDataset: %d rows from %s", len(self._rows), table_uri)

    @staticmethod
    def _columns(context_column: str, answer_column: Optional[str]) -> list[str]:
        return [context_column] + ([answer_column] if answer_column else [])

    def __len__(self) -> int:
        return len(self._rows)

    def _encode(self, text: str) -> list[int]:
        ids = self.tokenizer(str(text), add_special_tokens=False)
        if isinstance(ids, dict):
            ids = ids["input_ids"]
        return list(ids)

    def __getitem__(self, idx: int) -> dict:
        row = self._rows[idx]
        ctx_ids = self._encode(row[self.context_column])
        if self.answer_column:
            ans_ids = self._encode(row[self.answer_column])
            ids = (ctx_ids + ans_ids)[: self.max_len]
            labels = ([IGNORE_INDEX] * len(ctx_ids) + ans_ids)[: self.max_len]
        else:
            ids = ctx_ids[: self.max_len]
            labels = list(ids)
        return {"input_ids": ids, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]
