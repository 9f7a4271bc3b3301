"""Megatron-format binary indexed datasets (.bin token data + .idx index),
port of ``automodel_tpu/data/megatron/indexed_dataset.py``. The on-disk
format is bit-compatible with Megatron's ``MMapIndexedDataset`` (and so
with the JAX package's writer and reader), so corpora tokenized by existing
Megatron / NeMo tooling load directly:

  .idx: magic b"MMIDIDX\\x00\\x00" | u64 version=1 | u8 dtype_code |
        u64 num_sequences | u64 num_documents |
        i32 sizes[num_sequences] | i64 pointers[num_sequences] |
        i64 doc_idx[num_documents+1]
  .bin: raw little-endian token data, row-major

Reading is zero-copy via np.memmap.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Sequence

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
    5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class IndexedDataset:
    """Memory-mapped reader. `ds[i]` → np array of document i's tokens."""

    def __init__(self, path_prefix: str | Path):
        p = Path(str(path_prefix))
        idx_path = p.with_suffix(".idx") if p.suffix != ".idx" else p
        bin_path = idx_path.with_suffix(".bin")
        with open(idx_path, "rb") as f:
            magic = f.read(9)
            if magic != _MAGIC:
                raise ValueError(f"{idx_path}: bad magic {magic!r}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            (n_seq,) = struct.unpack("<Q", f.read(8))
            (n_doc,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        idx_buf = np.memmap(idx_path, mode="r", offset=offset)
        sz_bytes = n_seq * 4
        ptr_bytes = n_seq * 8
        self.sizes = np.frombuffer(idx_buf[:sz_bytes], np.int32)
        self.pointers = np.frombuffer(idx_buf[sz_bytes : sz_bytes + ptr_bytes], np.int64)
        self.doc_idx = np.frombuffer(
            idx_buf[sz_bytes + ptr_bytes : sz_bytes + ptr_bytes + (n_doc + 1) * 8],
            np.int64,
        )
        self._data = np.memmap(bin_path, dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        start = self.pointers[i] // self.dtype.itemsize
        return self._data[start : start + self.sizes[i]]

    def get_slice(self, i: int, offset: int, length: int) -> np.ndarray:
        start = self.pointers[i] // self.dtype.itemsize + offset
        return self._data[start : start + length]

    @property
    def num_tokens(self) -> int:
        return int(self.sizes.sum())


class IndexedDatasetWriter:
    """Streaming writer (documents appended one by one).

    The default dtype is JAX's ``uint16``, which wraps token ids above
    65,535 without an error: a corpus for a larger vocabulary (Llama-3's
    128,256) must say ``uint32``."""

    def __init__(self, path_prefix: str | Path, dtype=np.uint16):
        p = Path(str(path_prefix))
        self.idx_path = p.with_suffix(".idx")
        self.bin_path = p.with_suffix(".bin")
        self.dtype = np.dtype(dtype)
        self._bin = open(self.bin_path, "wb")
        self.sizes: list[int] = []
        self.pointers: list[int] = []
        self._offset = 0

    def add_document(self, tokens: Sequence[int] | np.ndarray) -> None:
        arr = np.ascontiguousarray(tokens, self.dtype)
        self.pointers.append(self._offset)
        self.sizes.append(len(arr))
        self._bin.write(arr.tobytes())
        self._offset += arr.nbytes

    def finalize(self) -> None:
        self._bin.close()
        n = len(self.sizes)
        with open(self.idx_path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _DTYPE_CODES[self.dtype]))
            f.write(struct.pack("<Q", n))
            f.write(struct.pack("<Q", n))  # one document per sequence
            f.write(np.asarray(self.sizes, np.int32).tobytes())
            f.write(np.asarray(self.pointers, np.int64).tobytes())
            f.write(np.arange(n + 1, dtype=np.int64).tobytes())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
