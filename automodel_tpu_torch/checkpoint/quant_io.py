"""Quantized-checkpoint ingest: FP8-blockwise and MXFP4 to bf16, port of
``automodel_tpu/checkpoint/quant_io.py``.

DeepSeek-V3 is published in FP8-blockwise (an fp8 ``weight`` with 128 x
128 ``weight_scale_inv`` tiles) and GPT-OSS in MXFP4 (``*_blocks`` packing
two e2m1 codes a byte, low nibble first, and ``*_scales`` holding one e8m0
exponent a group of 32). ``checkpoint/hf_io.HFCheckpointReader``
dequantizes both while reading, so a state-dict adapter only sees the
logical bf16 tensors.

The dequantizers run on the tensors' device, a chunk of rows at a time, so
a full-width load never holds an fp32 copy of a whole slab. They equal the
JAX package's numpy ones bit for bit: the fp8 product is one fp32
multiply rounded to the output dtype, and the MXFP4 ``code x 2^(scale -
127)`` is exact in fp64 and rounded once to fp32 (numpy's ``ldexp``), then
to the output dtype. The quantizers (``quantize_fp8_blockwise``,
``pack_mxfp4``) write such checkpoints from dense weights: tests and the
card's load check write them from seeded weights.
"""

from __future__ import annotations

import torch

FP8_BLOCK_SIZE = 128
FP8_E4M3_MAX = 448.0

# MXFP4 e2m1 code points, low nibble first (index == 4-bit code)
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)
MXFP4_GROUP = 32  # fp4 values per shared e8m0 scale

# fp32 elements a dequantization chunk holds (64 MiB)
CHUNK_ELEMENTS = 1 << 24


def _fp4_table(device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(FP4_VALUES, dtype=dtype, device=device)


def dequantize_fp8_blockwise(
    weight: torch.Tensor, scale_inv: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
    block_size: int = FP8_BLOCK_SIZE,
) -> torch.Tensor:
    """``weight`` fp8 [M, N] x ``scale_inv`` fp32 [ceil(M/B), ceil(N/B)]
    per-block scales → [M, N] in ``dtype`` on the weight's device, one
    block row at a time (JAX :34)."""
    if weight.dim() != 2:
        raise ValueError(f"fp8 blockwise weight must be 2-D, got {tuple(weight.shape)}")
    m, n = weight.shape
    br, bc = -(-m // block_size), -(-n // block_size)
    if tuple(scale_inv.shape) != (br, bc):
        raise ValueError(
            f"scale_inv shape {tuple(scale_inv.shape)} != expected {(br, bc)} for weight "
            f"{tuple(weight.shape)} at block {block_size}"
        )
    scale = scale_inv.to(device=weight.device, dtype=torch.float32)
    col_scale = scale.repeat_interleave(block_size, dim=1)[:, :n]
    out = torch.empty((m, n), dtype=dtype, device=weight.device)
    for i in range(br):
        r0, r1 = i * block_size, min((i + 1) * block_size, m)
        out[r0:r1] = (weight[r0:r1].float() * col_scale[i][None, :]).to(dtype)
    return out


def quantize_fp8_blockwise(weight: torch.Tensor, block_size: int = FP8_BLOCK_SIZE) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``dequantize_fp8_blockwise`` (JAX :64): per-block absmax
    scaling into float8_e4m3fn plus the fp32 ``scale_inv``."""
    m, n = weight.shape
    br, bc = -(-m // block_size), -(-n // block_size)
    w = weight.float()
    padded = w.new_zeros((br * block_size, bc * block_size))
    padded[:m, :n] = w
    absmax = padded.reshape(br, block_size, bc, block_size).abs().amax(dim=(1, 3))
    scale_inv = torch.where(absmax > 0, absmax / FP8_E4M3_MAX, torch.ones_like(absmax))
    inv = scale_inv.repeat_interleave(block_size, 0).repeat_interleave(block_size, 1)[:m, :n]
    return (w / inv).to(torch.float8_e4m3fn), scale_inv


def dequantize_mxfp4(
    blocks: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
    rows_per_chunk: int | None = None,
) -> torch.Tensor:
    """MXFP4 ``*_blocks`` uint8 [..., R, G, B] + ``*_scales`` uint8 [..., R,
    G] → ``dtype`` in the HF logical layout [..., G*B*2, R], on the blocks'
    device (JAX :84). Each byte packs two e2m1 codes, low nibble first;
    each group of ``2B = 32`` values shares the exponent ``scales - 127``.
    The last two axes are swapped at the end: on disk the quantized tensor
    is stored transposed against the bf16 layout."""
    if tuple(blocks.shape[:-1]) != tuple(scales.shape):
        raise ValueError(f"blocks {tuple(blocks.shape)} / scales {tuple(scales.shape)} mismatch")
    *prefix, g, b = blocks.shape
    flat = blocks.reshape(-1, b)
    exp = scales.to(blocks.device).reshape(-1, 1).to(torch.int32) - 127
    rows = flat.shape[0]
    step = rows_per_chunk or max(1, CHUNK_ELEMENTS // (2 * b))
    table = _fp4_table(blocks.device, torch.float64)
    out = torch.empty((rows, 2 * b), dtype=dtype, device=blocks.device)
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        blk = flat[r0:r1].to(torch.int64)
        sub = torch.empty((r1 - r0, 2 * b), dtype=torch.float64, device=blocks.device)
        sub[:, 0::2] = table[blk & 0x0F]
        sub[:, 1::2] = table[blk >> 4]
        # exact in fp64 (|code| <= 6, exponent -127..128), one rounding to fp32
        sub.mul_(torch.pow(2.0, exp[r0:r1].to(torch.float64)))
        out[r0:r1] = sub.to(torch.float32).to(dtype)
    return out.reshape(*prefix, g * b * 2).swapaxes(-1, -2)


def pack_mxfp4(weight: torch.Tensor, rows_per_chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``dequantize_mxfp4`` (JAX :118): HF-layout [..., C, R] →
    (blocks uint8 [..., R, C/32, 16], scales uint8 [..., R, C/32]) with
    per-group absmax e8m0 scales and the nearest e2m1 code (the lower code
    on a tie, as ``argmin``). The nearest-code search holds a [rows, 32,
    16] distance tensor, so it runs a chunk of rows at a time."""
    w = weight.swapaxes(-1, -2)  # [..., R, C]
    *prefix, r, c = w.shape
    if c % MXFP4_GROUP:
        raise ValueError(f"last dim {c} not a multiple of {MXFP4_GROUP}")
    g = c // MXFP4_GROUP
    grp = w.reshape(-1, MXFP4_GROUP)  # the groups in [..., R, G] order
    n = grp.shape[0]
    step = rows_per_chunk or max(1, CHUNK_ELEMENTS // (MXFP4_GROUP * 16 * 2))
    table = _fp4_table(w.device, torch.float64)
    codes = torch.empty((n, MXFP4_GROUP), dtype=torch.uint8, device=w.device)
    scales = torch.empty((n,), dtype=torch.uint8, device=w.device)
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        x = grp[r0:r1].float()
        absmax = x.abs().amax(dim=-1)
        # numpy's fp32 arithmetic: the ratio, log2 and ceil in fp32
        e = torch.where(absmax > 0, torch.ceil(torch.log2(torch.clamp(absmax, min=1e-30) / 6.0)),
                        torch.zeros_like(absmax))
        e = torch.clamp(e, -127, 128).to(torch.int32)
        scales[r0:r1] = (e + 127).to(torch.uint8)
        scaled = x.double() / torch.pow(2.0, e.double())[:, None]
        codes[r0:r1] = (scaled[..., None] - table).abs().argmin(dim=-1).to(torch.uint8)
    lo, hi = codes[:, 0::2], codes[:, 1::2]
    blocks = (lo | (hi << 4)).reshape(*prefix, r, g, MXFP4_GROUP // 2)
    return blocks, scales.reshape(*prefix, r, g)
