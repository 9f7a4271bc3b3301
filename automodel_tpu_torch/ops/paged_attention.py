"""Paged attention for decode and verify, in place over the KV block pool,
plus int8 KV-row quantization.

Port of ``automodel_tpu/ops/paged_attention.py``. ``paged_attend`` is the
wrapper of the hand-written Hopper kernel ``csrc/paged_attention.cu``
(which replaces the Pallas ``_paged_kernel`` of the JAX package): given
CUDA tensors it launches the kernel or raises, given CPU tensors it runs
``paged_attend_plain``, the same function in plain torch. There is no path
from a CUDA tensor to the plain version.

Semantics shared by both versions (and by the JAX kernel):

- q ``[B, Sq, N, H]`` is scaled in q's dtype (the kernel does it as it
  loads q, bit for bit as ``_scaled_q`` does); query row ``qi`` sits at
  absolute position ``lengths[b] + qi`` and attends pool
  positions ``pos <= lengths[b] + qi`` (and, under a window,
  ``lengths[b] + qi - pos < window``). The rows being attended were
  written into the pool before the call.
- Only live blocks are read: ``j <= (length + Sq - 1) // BS`` and, under a
  window, ``(j + 1) * BS - 1 > length - window``. Table entries outside
  that range may hold anything.
- Soft cap ``cap * tanh(s / cap)`` applies before masking; softmax is fp32;
  a row that attends nothing outputs zeros.
- int8 pools hold per-(token row, kv head) fp32 scales ``[NB, BS, Nkv]``;
  values dequantize as ``int8 * scale``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from automodel_tpu_torch.telemetry.profiling import cost as _cost

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
INT8_MAX = 127.0

# the CUDA kernel's shapes (csrc/paged_attention.cu): head dims and block
# sizes it is instantiated for, the query rows (of Sq * rep a kv head) one
# CTA takes, and the chunk sizes of its split-KV grid in blocks, largest
# first. Any Sq * rep is taken: wider chunks run ceil(Sq * rep / 32) row
# tiles.
CUDA_HEAD_DIMS = (64, 128, 256)
CUDA_BLOCK_SIZES = (16,)
CUDA_TILE_ROWS = 32
CUDA_CHUNK_BLOCKS = (32, 16, 8, 4)


# -- int8 KV-row quantization ------------------------------------------------


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., Nkv, H]`` → (int8 values, fp32 scales ``[..., Nkv]``).
    Symmetric per-(row, kv-head) absmax scaling, round half to even;
    quantize∘dequantize is idempotent on the values."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / INT8_MAX
    q = torch.clamp(torch.round(xf / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv_rows`` (scale broadcast over H)."""
    return (q.float() * scale[..., None].float()).to(dtype)


# -- plain version -----------------------------------------------------------


def _scaled_q(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """q times the scale rounded to q's dtype, as the JAX wrapper scales it.
    The scale stays a 0-dim CPU tensor, which a CUDA op takes as a scalar:
    building it on the card would be a blocking copy on every call."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return q * torch.tensor(scale, dtype=q.dtype)


def paged_attend_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain torch: gather the live blocks,
    dequantize, masked softmax in fp32. → ``[B, Sq, N, H]`` in q.dtype."""
    B, Sq, N, H = q.shape
    _, BS, Nkv, _ = k_pool.shape
    NBseq = tables.shape[1]
    rep = N // Nkv
    C = NBseq * BS
    lengths = lengths.long()
    qs = _scaled_q(q, scale).float().reshape(B, Sq, Nkv, rep, H)

    j = torch.arange(NBseq, device=q.device)
    live = j[None, :] <= ((lengths + Sq - 1) // BS)[:, None]  # [B, NBseq]
    if sliding_window is not None:
        live = live & ((j[None, :] + 1) * BS - 1 > (lengths - sliding_window)[:, None])
    tl = torch.where(live, tables.long(), torch.zeros_like(tables, dtype=torch.long))

    def side(pool, pool_scale):
        x = pool[tl].float()  # [B, NBseq, BS, Nkv, H]
        if pool_scale is not None:
            x = x * pool_scale[tl].float()[..., None]
        x = torch.where(live[:, :, None, None, None], x, torch.zeros_like(x))
        return x.reshape(B, C, Nkv, H)

    k = side(k_pool, k_scale)
    v = side(v_pool, v_scale)
    pos = torch.arange(C, device=q.device)
    q_abs = lengths[:, None] + torch.arange(Sq, device=q.device)[None, :]  # [B, Sq]
    mask = pos[None, None, :] <= q_abs[:, :, None]  # [B, Sq, C]
    if sliding_window is not None:
        mask = mask & (q_abs[:, :, None] - pos[None, None, :] < sliding_window)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qs, k)  # [B, Nkv, rep, Sq, C]
    if logits_soft_cap is not None:
        s = logits_soft_cap * torch.tanh(s / logits_soft_cap)
    m4 = mask[:, None, None, :, :]
    s = torch.where(m4, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]  # [B, Sq, Nkv, rep, 1]
    acc = torch.einsum("bgrqk,bkgh->bqgrh", p, v)
    out = torch.where(l > 0, acc / torch.clamp(l, min=1e-30), torch.zeros_like(acc))
    return out.reshape(B, Sq, N, H).to(q.dtype)


# -- the CUDA kernel ---------------------------------------------------------


def chunk_blocks(batch: int, num_kv_heads: int, nbseq: int, sm_count: int) -> int:
    """The kernel's split rule: blocks a chunk (one CTA's share of a
    sequence's KV for one kv head). The grid is ``(Nkv, B, ceil(nbseq /
    cb))``, sized from shapes alone (lengths stay on the card): the largest
    chunk of ``CUDA_CHUNK_BLOCKS`` whose grid still gives every SM a CTA
    when every table is full, else the smallest. Each CTA costs a start, a
    partial and a share of the merge, so fewer, longer chunks win as long
    as the longest sequence is spread over the SMs (PERF.md section 6)."""
    for cb in CUDA_CHUNK_BLOCKS[:-1]:
        if batch * num_kv_heads * -(-nbseq // cb) >= sm_count:
            return cb
    return CUDA_CHUNK_BLOCKS[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per (device, stream): the kernel's merge counters, zeroed once; every
# launch leaves them zero
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return buf


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.paged_attention_fwd
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
    fn.restype = i
    lib.paged_attention_error_string.argtypes = [i]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, sliding_window):
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged_attend on CUDA takes bf16 q, got {q.dtype}")
    quantized = k_scale is not None
    want_pool = torch.int8 if quantized else torch.bfloat16
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "tables": tables, "lengths": lengths}
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"paged_attend: {name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attend: {name} must be contiguous")
        if name in ("q", "k_pool", "v_pool") and t.data_ptr() % 16:
            raise ValueError(f"paged_attend: {name} must start on a 16-byte boundary")
    for name in ("k_pool", "v_pool"):
        if tensors[name].dtype != want_pool:
            raise TypeError(f"paged_attend: {name} must be {want_pool}, got {tensors[name].dtype}")
    for name in ("tables", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"paged_attend: {name} must be int32, got {tensors[name].dtype}")
    B, Sq, N, H = q.shape
    NB, BS, Nkv, Hk = k_pool.shape
    if v_pool.shape != k_pool.shape or Hk != H:
        raise ValueError(f"paged_attend: pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs q {tuple(q.shape)}")
    if quantized:
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if t.dtype != torch.float32 or tuple(t.shape) != (NB, BS, Nkv):
                raise ValueError(f"paged_attend: {name} must be fp32 [{NB}, {BS}, {Nkv}]")
    if tables.dim() != 2 or tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attend: tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} vs batch {B}")
    if N % Nkv:
        raise ValueError(f"paged_attend: {N} heads not a multiple of {Nkv} kv heads")
    if H not in CUDA_HEAD_DIMS:
        raise ValueError(f"paged_attend: head_dim {H} (the CUDA kernel takes {CUDA_HEAD_DIMS})")
    if BS not in CUDA_BLOCK_SIZES:
        raise ValueError(f"paged_attend: block_size {BS} (the CUDA kernel takes {CUDA_BLOCK_SIZES})")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"paged_attend: sliding_window {sliding_window} (the CUDA kernel takes >= 1 or None)")


def _lib() -> ctypes.CDLL:
    from automodel_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("paged_attention")
    if not hasattr(lib, "_paged_bound"):
        _bind(lib)
        lib._paged_bound = True
    return lib


def _launch_cuda(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale, sliding_window, logits_soft_cap,
                 cb: int):
    """One launch of the kernel at ``cb`` blocks a chunk (``paged_attend``
    passes ``chunk_blocks``'s; chip_paged_ab.py's ``--sweep`` times every
    size of ``CUDA_CHUNK_BLOCKS``)."""
    lib = _lib()
    B, Sq, N, H = q.shape
    _, BS, Nkv, _ = k_pool.shape
    nbseq = tables.shape[1]
    splits = -(-nbseq // cb)
    tiles = -(-Sq * (N // Nkv) // CUDA_TILE_ROWS)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part = counters = None
        if splits > 1:  # partials [B, Nkv, splits, rows, H] then their [max, sum]
            part = torch.empty(B * Nkv * splits * Sq * (N // Nkv) * (H + 2), dtype=torch.float32, device=q.device)
            counters = _counters(q.device, stream, B * Nkv * tiles)
        rc = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            counters.data_ptr() if counters is not None else None,
            B, Sq, N, Nkv, H, BS, nbseq,
            -1 if sliding_window is None else int(sliding_window),
            int(k_scale is not None),
            0.0 if logits_soft_cap is None else float(logits_soft_cap),
            scale if scale is not None else 1.0 / (H**0.5),
            cb,
            stream,
        )
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed ({rc}): {msg}")
    paged_attend.launches += 1
    return out



def _paged_flops(q, k_pool, v_pool, tables, *args, **kwargs) -> float:
    """The plain version's work: QKᵀ and PV over every gathered block of a
    row's table, 2 x 2·B·Sq·N·(NBseq·BS)·H."""
    B, Sq, N, H = q.shape
    return 4.0 * B * Sq * N * tables.shape[1] * k_pool.shape[1] * H


@_cost.counted(_paged_flops)
def paged_attend(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode/verify attention, in place over one layer's block pool.

    q ``[B, Sq, N, H]``; k_pool/v_pool ``[NB, BS, Nkv, H]`` (int8 with
    ``k_scale``/``v_scale`` ``[NB, BS, Nkv]`` fp32); tables ``[B, NBseq]``
    int32; lengths ``[B]`` int32, the absolute position of query row 0.
    → ``[B, Sq, N, H]`` in q.dtype. CUDA tensors launch the kernel (and
    count it in ``paged_attend.launches``, one a call); CPU tensors run the
    plain version."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attend: pass both k_scale and v_scale, or neither")
    if q.device.type == "cpu":
        return paged_attend_plain(
            q, k_pool, v_pool, tables, lengths, k_scale, v_scale,
            scale=scale, sliding_window=sliding_window, logits_soft_cap=logits_soft_cap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attend: no kernel for device {q.device}")
    _check_cuda_args(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, sliding_window)
    cb = chunk_blocks(q.shape[0], k_pool.shape[2], tables.shape[1], _sm_count(q.device.index))
    return _launch_cuda(
        q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale, sliding_window, logits_soft_cap, cb,
    )


paged_attend.launches = 0
