"""HF safetensors checkpoint I/O, port of ``automodel_tpu/checkpoint/hf_io.py``.

The safetensors container is parsed and written here, with no
``safetensors`` package: an 8-byte little-endian header length, a JSON
header (dtype, shape and data offsets per tensor, padded with spaces to 8
bytes), then the raw bytes. Tensors are read out of an ``mmap`` with
``torch.frombuffer``, so bf16 checkpoints round-trip bit for bit in torch's
own dtypes, and a directory either package writes loads into the other.

``load_params_from_hf`` streams: the state-dict adapter yields one port
tensor at a time (a ``LazyStacked`` expert slab row by row), each is copied
into the built model's tensor on its device and released, so host memory
holds one leaf, never the model. ``save_hf_checkpoint`` writes sharded
files plus ``model.safetensors.index.json`` when the weights pass
``max_shard_bytes``, flushing each shard as it fills.

FP8-blockwise (``<key>_scale_inv``) and MXFP4 (``<key>_blocks`` /
``_scales``) tensors dequantize while they are read, as JAX's reader does
(``checkpoint/quant_io.py``): ``keys`` and ``info`` give the logical bf16
view, and the reader's ``device`` is where the dequantization runs (the
load device under ``from_pretrained``), a chunk of rows at a time.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Any, Callable, Iterable, Optional

import torch

from automodel_tpu_torch.resilience.retry import retry_io

SAFETENSORS_INDEX = "model.safetensors.index.json"
MAX_SHARD_BYTES = 5 * 1024**3

_ST_TO_TORCH = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U64": torch.uint64,
    "U32": torch.uint32,
    "U16": torch.uint16,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_TO_ST = {v: k for k, v in _ST_TO_TORCH.items()}


@retry_io(op="safetensors_read_header", max_attempts=3)
def _read_header(path: Path) -> tuple[dict, int]:
    """(header dict, data section offset). Retried on ``OSError``; a
    malformed header raises ``ValueError`` at once."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


class HFCheckpointReader:
    """Lazy mmap reader over an HF checkpoint dir (one file, or shards and
    their index). ``get_tensor`` copies one tensor's bytes out of the map
    into a CPU tensor it owns; a quantized tensor is dequantized to bf16 on
    ``device`` (the CPU by default)."""

    def __init__(self, path: str | os.PathLike, device: str | torch.device | None = None):
        self.path = Path(path)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        index_file = self.path / SAFETENSORS_INDEX
        self.weight_map: dict[str, str] = {}
        if index_file.exists():
            self.weight_map = dict(json.loads(index_file.read_text())["weight_map"])
        else:
            cands = sorted(self.path.glob("*.safetensors"))
            if not cands:
                raise FileNotFoundError(f"No safetensors checkpoint under {self.path}")
            for c in cands:
                header, _ = _read_header(c)
                self.weight_map.update({k: c.name for k in header if k != "__metadata__"})
        self._files: dict[str, tuple[dict, int, Any]] = {}

    def _is_fp8_blockwise(self, key: str) -> bool:
        return (
            key in self.weight_map
            and f"{key}_scale_inv" in self.weight_map
            and self._raw_info(key)[0] in ("F8_E4M3", "F8_E5M2")
        )

    def _is_mxfp4(self, key: str) -> bool:
        return (
            key not in self.weight_map
            and f"{key}_blocks" in self.weight_map
            and f"{key}_scales" in self.weight_map
        )

    def keys(self) -> list[str]:
        """Logical tensor keys, as the JAX reader lists them: a
        ``_scale_inv`` companion folds into its fp8 tensor, an MXFP4
        ``_blocks`` / ``_scales`` pair into the tensor it encodes."""
        out = []
        for k in self.weight_map:
            if k.endswith("_scale_inv") and self._is_fp8_blockwise(k[: -len("_scale_inv")]):
                continue
            if k.endswith("_blocks") and self._is_mxfp4(k[: -len("_blocks")]):
                out.append(k[: -len("_blocks")])
                continue
            if k.endswith("_scales") and self._is_mxfp4(k[: -len("_scales")]):
                continue
            out.append(k)
        return out

    def _file(self, name: str) -> tuple[dict, int, Any]:
        if name not in self._files:
            p = self.path / name
            header, data_off = _read_header(p)
            with open(p, "rb") as f:
                # a private writable map: torch.frombuffer wants a writable
                # buffer, and nothing written to it reaches the file
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            self._files[name] = (header, data_off, mm)
        return self._files[name]

    def _raw_info(self, key: str) -> tuple[str, tuple[int, ...]]:
        header, _, _ = self._file(self.weight_map[key])
        meta = header[key]
        return meta["dtype"], tuple(meta["shape"])

    def info(self, key: str) -> tuple[str, tuple[int, ...]]:
        """(safetensors dtype string, shape) without reading data: the
        logical post-dequantization view of a quantized tensor (the same
        predicates as ``get_tensor``)."""
        if self._is_fp8_blockwise(key):
            return "BF16", self._raw_info(key)[1]
        if self._is_mxfp4(key):
            *prefix, r, g, b = self._raw_info(f"{key}_blocks")[1]
            return "BF16", (*prefix, g * b * 2, r)
        return self._raw_info(key)

    def get_tensor(self, key: str) -> torch.Tensor:
        from automodel_tpu_torch.checkpoint import quant_io

        on = lambda k: self._raw_tensor(k).to(self.device)
        if self._is_fp8_blockwise(key):
            return quant_io.dequantize_fp8_blockwise(on(key), on(f"{key}_scale_inv"))
        if self._is_mxfp4(key):
            return quant_io.dequantize_mxfp4(on(f"{key}_blocks"), on(f"{key}_scales"))
        return self._raw_tensor(key)

    def _raw_tensor(self, key: str) -> torch.Tensor:
        header, data_off, mm = self._file(self.weight_map[key])
        meta = header[key]
        dtype = _ST_TO_TORCH[meta["dtype"]]
        start, end = meta["data_offsets"]
        if end == start:
            return torch.empty(meta["shape"], dtype=dtype)
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - start, offset=data_off + start)
        # the copy owns aligned memory and outlives the map
        return raw.clone().view(dtype).reshape(meta["shape"])

    def close(self) -> None:
        for _, _, mm in self._files.values():
            mm.close()
        self._files.clear()


def _host_bytes(t: torch.Tensor):
    """A CPU tensor's bytes as a numpy uint8 view (no copy when contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


@retry_io(op="safetensors_write", max_attempts=3)
def _write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    header: dict[str, Any] = {}
    offset = 0
    for k, t in tensors.items():
        st_dtype = _TORCH_TO_ST.get(t.dtype)
        if st_dtype is None:
            raise TypeError(f"{k}: dtype {t.dtype} has no safetensors encoding")
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": st_dtype, "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    hbytes += b" " * ((8 - (len(hbytes) % 8)) % 8)  # the spec pads to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hbytes)))
        f.write(hbytes)
        for t in tensors.values():
            f.write(_host_bytes(t))


def save_hf_checkpoint(
    path: str | os.PathLike,
    tensors: Iterable[tuple[str, torch.Tensor]],
    metadata: dict | None = None,
    max_shard_bytes: int = MAX_SHARD_BYTES,
    dtype: Optional[torch.dtype] = None,
) -> int:
    """Write (key, tensor) pairs as sharded safetensors plus the index (one
    ``model.safetensors`` when they fit one shard) → bytes of tensor data.

    Each tensor comes to the host as it is reached (device tensors stream
    leaf by leaf) and each shard is written and released once it reaches
    ``max_shard_bytes``, so host memory holds one shard. Shards carry
    temporary names until their count is known."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    shard: dict[str, torch.Tensor] = {}
    shard_size = 0
    shard_keys: list[list[str]] = []
    total = 0

    def flush():
        nonlocal shard, shard_size
        if not shard:
            return
        _write_safetensors(path / f"shard-{len(shard_keys):05d}.tmp", shard)
        shard_keys.append(list(shard))
        shard = {}
        shard_size = 0

    for key, t in tensors:
        t = t.detach()
        if dtype is not None:
            t = t.to(dtype)
        t = t.to("cpu")
        nbytes = t.numel() * t.element_size()
        if shard_size + nbytes > max_shard_bytes and shard:
            flush()
        shard[key] = t
        shard_size += nbytes
        total += nbytes
    flush()

    n = len(shard_keys)
    weight_map: dict[str, str] = {}
    for i, keys in enumerate(shard_keys):
        fname = "model.safetensors" if n == 1 else f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        (path / f"shard-{i:05d}.tmp").rename(path / fname)
        weight_map.update({k: fname for k in keys})
    if n != 1:
        index = {"metadata": {"total_size": total, **(metadata or {})}, "weight_map": weight_map}
        (path / SAFETENSORS_INDEX).write_text(json.dumps(index, indent=2))
    return total


class LazyStacked:
    """A port tensor with a leading stack axis whose rows are read on demand
    (one HF tensor group per row: an expert of a slab). The loader copies it
    into its target row by row, so the stacked tensor never exists on the
    host."""

    def __init__(self, row_fns: Iterable[Callable[[], torch.Tensor]]):
        self.row_fns = list(row_fns)
        self._cache: tuple[int, torch.Tensor] | None = None  # (idx, row)

    def row(self, i: int) -> torch.Tensor:
        if self._cache is None or self._cache[0] != i:
            self._cache = (i, self.row_fns[i]())
        return self._cache[1]

    def __len__(self) -> int:
        return len(self.row_fns)

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.row_fns), *self.row(0).shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.row(0).dtype

    def materialize(self) -> torch.Tensor:
        return torch.stack([fn() for fn in self.row_fns], 0)


def assemble(leaves: Iterable[tuple[str, Any]]) -> dict[str, torch.Tensor]:
    """(key, leaf) pairs → a state dict (``LazyStacked`` leaves realized)."""
    return {k: v.materialize() if isinstance(v, LazyStacked) else v for k, v in leaves}


def load_params_from_hf(
    adapter: Any,
    reader: Any,
    targets: dict[str, torch.Tensor],
    dtype: Optional[torch.dtype] = None,
) -> list[str]:
    """Stream an HF checkpoint into ``targets`` (the built model's state
    dict, whose tensors share the parameters' storage) in place → the keys
    loaded. Each HF tensor is cast to ``dtype`` (the param dtype) as it is
    read, then copied into its target on the target's device and in the
    target's dtype. A key the adapter yields that the model lacks, a shape
    that differs, or a target left unloaded raises."""
    if not hasattr(reader, "get_tensor"):  # a path; readers (RemappedReader too) pass through
        reader = HFCheckpointReader(reader)

    def get(key: str) -> torch.Tensor:
        t = reader.get_tensor(key)
        return t.to(dtype) if dtype is not None else t

    loaded: list[str] = []
    try:
        with torch.no_grad():
            for key, leaf in adapter.iter_from_hf(get):
                if key not in targets:
                    raise KeyError(f"{key}: the checkpoint's adapter yields a tensor the model does not have")
                tgt = targets[key]
                if tuple(leaf.shape) != tuple(tgt.shape):
                    raise ValueError(f"{key}: checkpoint shape {tuple(leaf.shape)} != model shape {tuple(tgt.shape)}")
                if isinstance(leaf, LazyStacked):
                    for i in range(len(leaf)):
                        tgt[i].copy_(leaf.row(i))
                else:
                    tgt.copy_(leaf)
                loaded.append(key)
    finally:
        reader.close()
    missing = sorted(set(targets) - set(loaded))
    if missing:
        raise KeyError(f"the checkpoint left model tensors unloaded: {missing}")
    return loaded
