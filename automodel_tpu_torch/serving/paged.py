"""Paged-KV programs: chunked prefill, the paged decode step (fused
kernel or gather backend), and speculative decoding's draft proposal and
verify.

Port of ``automodel_tpu/serving/paged.py`` (``PagedKV``, ``init_pool``,
``build_chunk_prefill_fn``, ``build_paged_decode_fn``,
``build_draft_propose_fn``, ``build_verify_fn``). The pool is a
:class:`PagedKV`: per-layer k/v block tensors ``[L, NB, BS, Nkv, H]`` in the
model's compute dtype, or int8 values with per-(token row, kv head) fp32
scales ``[L, NB, BS, Nkv]`` beside them. The programs update the pool in
place (the JAX programs donate it).

- **chunk prefill**: one prompt chunk of ONE sequence through the model's
  cached attend over the gathered (dequantized) view; the chunk's rows are
  written back, quantizing on write. The JAX program writes the whole view
  back instead; the rows outside the chunk are the ones it gathered, and
  quantize∘dequantize is idempotent on rows written in the compute dtype,
  so both leave earlier and shared prefix blocks bit-identical.
- **paged decode**: one token per slot. ``fused``: each layer scatters its
  token row into the pool and runs the paged-attention kernel over the
  pool in place. ``gather``: each layer gathers the slots' tables into a
  view, attends with ``sdpa_decode``, and scatters the token row back.
- **draft propose**: ``k`` sequential one-token draft steps through
  ``decode_logits`` over the draft's own pool at the shared block tables,
  then ONE more step that feeds the last proposal ``d_k`` with its logits
  dropped (``model.hidden`` only). The JAX program feeds ``cur, d_1 ..
  d_(k-1)`` alone, so ``d_k``'s K/V never reaches its draft pool, and after
  a round that accepts all k the next proposals attend a row that was never
  written (the committed tokens stay right, since verify decides them; the
  accept rate drops). The extra step writes that row; rows past the
  committed length are rewritten before the next round reads them.
- **verify**: one forward of the target over ``[cur, d_1..d_k]`` at the
  slots' offsets (on ``fused``, the paged kernel with Sq = k+1), then
  ``speculative_verify``; inactive slots commit nothing. The pool keeps the
  K/V of every fed token: rejected rows sit past the committed length the
  host keeps, never attended, and the next round overwrites them.

Moving blocks between the device pool and host memory (the spill tier,
JAX :191-336): ``extract_blocks`` is one ``index_select`` over the block
axis on the device and one copy to host memory a pool tensor;
``inject_blocks`` is one ``index_copy_`` a pool tensor, landing the bytes
as given (int8 values and their fp32 scales as they are, no
requantisation). A payload is ``{"k": rows, "v": rows}``, each side
``[L, nb, BS, Nkv, H]`` host tensors or an ``(int8 values, fp32 scales)``
pair; ``split_kv_blocks`` / ``concat_kv_blocks`` cut and join payloads
along the block axis. JAX pads an inject to a power-of-two block count
(``bucket_blocks`` / ``pad_kv_blocks``, the padding aimed at the scratch
block) to bound its compiles; the port has no compiles to bound and
injects the exact count, which leaves the same bytes in every block but
scratch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from automodel_tpu_torch.generation import kv_cache
from automodel_tpu_torch.generation.loop import _primary
from automodel_tpu_torch.generation.sampling import SamplingConfig, sample, speculative_verify, step_generator
from automodel_tpu_torch.ops.paged_attention import dequantize_kv


@dataclasses.dataclass
class PagedKV:
    """The device block pool. ``k``/``v`` are each a tensor ``[L, NB, BS,
    Nkv, H]`` or, when quantized, an ``(int8 values, fp32 scales [L, NB,
    BS, Nkv])`` pair."""

    k: Any
    v: Any

    @property
    def quantized(self) -> bool:
        return isinstance(self.k, tuple)

    @property
    def values_shape(self) -> tuple:
        return tuple((self.k[0] if self.quantized else self.k).shape)

    @property
    def nbytes(self) -> int:
        total = 0
        for side in (self.k, self.v):
            for t in side if isinstance(side, tuple) else (side,):
                total += t.numel() * t.element_size()
        return total

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (k side, v side), views into the pool."""

        def one(side):
            return (side[0][i], side[1][i]) if isinstance(side, tuple) else side[i]

        return one(self.k), one(self.v)


def init_pool(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    device=None,
) -> PagedKV:
    """Zeroed pool; ``quantized`` stores int8 values + fp32 row scales."""
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    if quantized:

        def side():
            return (
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            )

        return PagedKV(k=side(), v=side())
    return PagedKV(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def _gather_side(side, tables: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One layer's pool side + tables [B, NBseq] → contiguous view
    [B, NBseq*BS, Nkv, H] in ``dtype`` (int8 blocks dequantize here)."""
    t = tables.long()
    if isinstance(side, tuple):
        vals, scales = side
        g = dequantize_kv(vals[t], scales[t], dtype)
    else:
        g = side[t].to(dtype)
    B, NBseq, BS, Nkv, H = g.shape
    return g.reshape(B, NBseq * BS, Nkv, H)


class _LayerCache:
    """The model's cache hook: per layer, ``write`` hands the context that
    layer's cache and ``attend`` runs the context's attention. On the view
    paths (chunk prefill, gather decode: ``view_dtype`` set) the cache is a
    view gathered from the pool in that dtype, and the new rows are also
    written into the pool at ``rows_at`` (block, offset) targets."""

    attends_cache = True  # chunk prefill and decode attend the cache

    def __init__(self, pool: PagedKV, ctx, view_tables=None, view_dtype=None, rows_at=None):
        self.pool = pool
        self.ctx = ctx
        self.view_tables = view_tables
        self.view_dtype = view_dtype
        self.rows_at = rows_at

    def write(self, i: int, k: torch.Tensor, v: torch.Tensor):
        sk, sv = self.pool.layer(i)
        if self.view_dtype is None:
            return self.ctx.write(sk, sv, k, v)
        view_k = _gather_side(sk, self.view_tables, self.view_dtype)
        view_v = _gather_side(sv, self.view_tables, self.view_dtype)
        blk, off = self.rows_at
        kv_cache.paged_scatter(sk, k.to(self.view_dtype), blk, off)
        kv_cache.paged_scatter(sv, v.to(self.view_dtype), blk, off)
        return self.ctx.write(view_k, view_v, k, v)

    def attend(self, i: int, q: torch.Tensor, layer_kv, **kw) -> torch.Tensor:
        return self.ctx.attend(q, layer_kv, **kw)


def _decode_plan(pool: PagedKV, tables, lengths, tokens, active, backend: str, block_size: int, compute_dtype):
    """The cache hook and positions of one forward of tokens [B, S] at
    per-slot offsets. ``fused``: the paged context, whose per-layer writes
    scatter into the pool and whose attention runs the paged kernel over
    it, no view. ``gather``: the chunk context over the GATHERED view, the
    S rows also written back into the pool."""
    B, S = tokens.shape
    if backend == "fused":
        cache = _LayerCache(pool, kv_cache.paged_ctx(tables, lengths, S, active, block_size))
    else:
        ctx = kv_cache.chunk_ctx(tables.shape[1] * block_size, S, lengths, torch.where(active, S, 0))
        cache = _LayerCache(
            pool, ctx, view_tables=tables, view_dtype=compute_dtype,
            rows_at=kv_cache.paged_write_targets(tables, lengths, S, active, block_size),
        )
    positions = lengths.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
    return cache, positions


def decode_logits(
    model, pool: PagedKV, tables, lengths, tokens, active, *,
    backend: str, block_size: int, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """tokens [B, S] at per-slot offsets ``lengths`` through one backend,
    their K/V written into the pool. → logits [B, S, V] fp32."""
    cache, positions = _decode_plan(pool, tables, lengths, tokens, active, backend, block_size, compute_dtype)
    return _primary(model(tokens, positions, cache=cache)).float()


def decode_write(
    model, pool: PagedKV, tables, lengths, tokens, active, *,
    backend: str, block_size: int, compute_dtype: torch.dtype,
) -> None:
    """``decode_logits`` without the output head: tokens [B, S] only write
    their K/V into the pool."""
    cache, positions = _decode_plan(pool, tables, lengths, tokens, active, backend, block_size, compute_dtype)
    model.hidden(tokens, positions, cache=cache)


# -- moving blocks between the device pool and host memory --------------------


def _block_index(blocks, device) -> torch.Tensor:
    return torch.as_tensor([int(b) for b in blocks], dtype=torch.long).to(device)


def extract_blocks(pool: PagedKV, blocks) -> tuple:
    """The rows of ``blocks`` copied out of the pool to host memory → ``(k,
    v)``, each ``[L, nb, BS, Nkv, H]`` (or an ``(int8 values, fp32
    scales)`` pair). Positions past a prompt inside its last block are junk
    that no attend reads."""
    k = pool.k[0] if pool.quantized else pool.k
    idx = _block_index(blocks, k.device)

    def side(s):
        if isinstance(s, tuple):
            return tuple(t.index_select(1, idx).cpu() for t in s)
        return s.index_select(1, idx).cpu()

    return side(pool.k), side(pool.v)


def inject_blocks(pool: PagedKV, blocks, kv: dict) -> PagedKV:
    """Scatter payload rows ``kv = {"k": rows, "v": rows}`` into the pool
    blocks named by ``blocks``, in place (→ the pool). An int8 payload
    lands its values and scales as they are, so extract → inject is
    bit-identical."""
    k = pool.k[0] if pool.quantized else pool.k
    idx = _block_index(blocks, k.device)

    def side(s, rows):
        if isinstance(s, tuple):
            if not isinstance(rows, tuple):
                raise ValueError("an int8 pool takes (values, scales) payload pairs")
            for t, r in zip(s, rows):
                t.index_copy_(1, idx, r.to(device=t.device, dtype=t.dtype))
        else:
            if isinstance(rows, tuple):
                raise ValueError(f"a {s.dtype} pool takes raw payload rows, not (values, scales) pairs")
            s.index_copy_(1, idx, rows.to(device=s.device, dtype=s.dtype))

    side(pool.k, kv["k"])
    side(pool.v, kv["v"])
    return pool


def split_kv_blocks(kv: dict) -> list[dict]:
    """One payload a block: ``[L, nb, ...]`` rows → nb ``[L, 1, ...]``
    payloads (copies, so a parked block never pins the whole extract)."""

    def slice_side(s, i):
        if isinstance(s, tuple):
            return tuple(t[:, i : i + 1].clone() for t in s)
        return s[:, i : i + 1].clone()

    first = kv["k"][0] if isinstance(kv["k"], tuple) else kv["k"]
    return [{"k": slice_side(kv["k"], i), "v": slice_side(kv["v"], i)} for i in range(int(first.shape[1]))]


def concat_kv_blocks(payloads: list[dict]) -> dict:
    """Inverse of :func:`split_kv_blocks`: consecutive single-block payloads
    → one ``[L, nb, ...]`` payload."""
    if not payloads:
        raise ValueError("concat_kv_blocks: empty payload list")

    def cat_side(name):
        first = payloads[0][name]
        if isinstance(first, tuple):
            return tuple(torch.cat([p[name][j] for p in payloads], dim=1) for j in range(len(first)))
        return torch.cat([p[name] for p in payloads], dim=1)

    return {"k": cat_side("k"), "v": cat_side("v")}


def kv_nbytes(kv: dict) -> int:
    """Host bytes a payload occupies (scales included): the spill tier's
    budget currency."""
    total = 0
    for side in (kv["k"], kv["v"]):
        for t in side if isinstance(side, tuple) else (side,):
            total += t.numel() * t.element_size()
    return total


def build_chunk_prefill_fn(model, chunk_len: int, compute_dtype=None) -> Callable:
    """→ ``chunk(pool, table [NBseq], chunk_ids [chunk_len], start,
    real_len)`` → ``last_logits [V] fp32`` for ONE sequence, the pool
    updated in place. ``start`` is the absolute position of the chunk's
    first token, ``real_len`` the unpadded chunk length; ``last_logits``
    are those of token ``start + real_len - 1``."""

    @torch.inference_mode()
    def chunk(pool: PagedKV, table: torch.Tensor, chunk_ids: torch.Tensor, start: int, real_len: int):
        BS = pool.values_shape[2]
        cd = compute_dtype or (pool.k.dtype if not pool.quantized else torch.bfloat16)
        dev = chunk_ids.device
        tables = table[None, :]
        starts = torch.tensor([start], device=dev)
        ctx = kv_cache.chunk_ctx(
            table.shape[0] * BS, chunk_len, starts, torch.tensor([real_len], device=dev)
        )
        every = torch.ones((1,), dtype=torch.bool, device=dev)
        cache = _LayerCache(
            pool, ctx, view_tables=tables, view_dtype=cd,
            rows_at=kv_cache.paged_write_targets(tables, starts, chunk_len, every, BS),
        )
        positions = (start + torch.arange(chunk_len, device=dev))[None, :]
        h = _primary(model.hidden(chunk_ids[None, :], positions, cache=cache))
        return model.logits(h[0, real_len - 1]).float()

    return chunk


def build_paged_decode_fn(
    model,
    sampling: SamplingConfig,
    pad_id: int = 0,
    *,
    backend: str = "gather",
    block_size: int = 16,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``step(pool, tables [B, NBseq], lengths [B], cur [B], active [B]
    bool, seed, step_idx)`` → next tokens [B] int32 on the device, the pool
    updated in place. Every ACTIVE slot advances one token (its K/V written
    at ``(table[len // BS], len % BS)``); inactive slots compute junk that
    is masked from the output and written into scratch block 0."""
    if backend not in ("fused", "gather"):
        raise ValueError(f"paged decode backend {backend!r} (want fused|gather)")

    @torch.inference_mode()
    def step(pool, tables, lengths, cur, active, seed: int, step_idx: int):
        logits = decode_logits(
            model, pool, tables, lengths, cur[:, None], active,
            backend=backend, block_size=block_size, compute_dtype=compute_dtype,
        )
        gen = None if sampling.greedy else step_generator(seed, step_idx, logits.device)
        nxt = sample(logits[:, -1], gen, sampling)
        return torch.where(active, nxt, torch.full_like(nxt, pad_id))

    return step


def spec_generator(seed: int, step_idx: int, stream: int, device) -> torch.Generator:
    """The generator of one speculative draw: stream 1 is verify's, stream
    2 + i the draft's i-th step; each apart from ``sample``'s
    (``step_generator(seed, step_idx)``), as JAX folds ``(step, 0)`` and
    ``(step, 1 + i)`` into its key."""
    return step_generator(seed, step_idx * 0x100000001B3 + stream, device)


def build_draft_propose_fn(
    model,
    sampling: SamplingConfig,
    spec_k: int,
    pad_id: int = 0,
    *,
    backend: str = "gather",
    block_size: int = 16,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``propose(pool, tables [B, NBseq], lengths [B], cur [B], active [B]
    bool, seed, step_idx)`` → ``(draft_tokens [B, k] int32, draft_logits [B,
    k, V] fp32, or None under greedy)``, the draft's pool updated in place:
    ``spec_k`` sequential one-token steps, each writing the draft's K/V at
    the shared tables, then one step that writes ``d_k``'s K/V (module
    docstring): k + 1 draft forwards a call."""
    kw = dict(backend=backend, block_size=block_size, compute_dtype=compute_dtype)

    @torch.inference_mode()
    def propose(pool, tables, lengths, cur, active, seed: int, step_idx: int):
        toks, logs = [], []
        length, c = lengths, cur
        for i in range(spec_k):
            lg = decode_logits(model, pool, tables, length, c[:, None], active, **kw)[:, -1]
            gen = None if sampling.greedy else spec_generator(seed, step_idx, 2 + i, lg.device)
            nxt = sample(lg, gen, sampling)
            nxt = torch.where(active, nxt, torch.full_like(nxt, pad_id))
            toks.append(nxt)
            if not sampling.greedy:
                logs.append(lg)
            length = length + 1
            c = nxt.long()
        decode_write(model, pool, tables, length, c[:, None], active, **kw)
        return torch.stack(toks, dim=1), torch.stack(logs, dim=1) if logs else None

    return propose


def build_verify_fn(
    model,
    sampling: SamplingConfig,
    spec_k: int,
    pad_id: int = 0,
    *,
    backend: str = "gather",
    block_size: int = 16,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``verify(pool, tables, lengths, cur [B], drafts [B, k], draft_logits
    [B, k, V] | None, active, seed, step_idx)`` → ``(tokens [B, k+1] int32,
    n_commit [B] int32)``: ONE batched forward over ``[cur, d_1..d_k]`` at
    per-slot offsets (per-query causal masks over the paged cache), then
    ``speculative_verify``; an inactive slot commits 0 tokens."""
    kw = dict(backend=backend, block_size=block_size, compute_dtype=compute_dtype)

    @torch.inference_mode()
    def verify(pool, tables, lengths, cur, drafts, draft_logits, active, seed: int, step_idx: int):
        fed = torch.cat([cur[:, None], drafts.long()], dim=1)  # [B, k+1]
        logits = decode_logits(model, pool, tables, lengths, fed, active, **kw)
        gen = None if sampling.greedy else spec_generator(seed, step_idx, 1, logits.device)
        toks, n = speculative_verify(logits, draft_logits, drafts, gen, sampling)
        n = torch.where(active, n, torch.zeros_like(n))
        toks = torch.where(active[:, None], toks, torch.full_like(toks, pad_id))
        return toks, n

    return verify
