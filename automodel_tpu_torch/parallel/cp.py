"""Context parallelism: ring attention over the ``cp`` group, port of
``automodel_tpu/parallel/cp.py``.

Each rank holds ``S / cp`` tokens of every sequence. Its queries attend to
every rank's keys and values in ``cp`` steps: at step ``s`` it holds the
block of rank ``(rank - s) % cp``, runs one forward of the flash kernel K1
(``ops/ring_flash.flash_block_fwd``, ``csrc/flash_attention.cu``) at that
block's global positions, and merges the partial result into its fp32
(out, lse) (``ops/ring_flash.merge_partials``); then the keys, values and
segment ids move one rank on (``batch_isend_irecv`` within the group),
except after the last step. Sinks (gpt-oss) are folded in after the merge
(JAX :198-204). The backward takes ``delta`` from the folded output and
runs K1's dq and dkv at each step: dq stays on the rank, dk and dv ride the
ring with their block and take one last hop home (JAX :229-245); the sinks'
gradient is the rank's own rows' share, summed across ranks with the other
parameter gradients.

The per-rank step (``ring_fwd_step``: one K1 forward and its merge;
``ring_bwd_step``: one K1 backward) is apart from the rotation, so one
process can drive every rank of a ring in ring order
(``ring_forward_ranks`` / ``ring_backward_ranks``) through the same steps:
the tests and ``chip_smoke.py`` do, and the real ring's sums are taken in
the same order.

Two sequence layouts, as in JAX:

- contiguous: rank r holds positions ``[r S/cp, (r+1) S/cp)``; under a
  causal mask the later ranks do more work (at cp = 4 the last rank has
  seven times the first one's live pairs);
- zigzag (``cp_zigzag``): the sequence is cut into ``2 cp`` chunks and rank
  r holds chunks r and ``2cp-1-r`` (``zigzag_indices``), so every rank has
  the same causal work. The data is permuted into this order on the host
  (``apply_zigzag``); RoPE reads the true positions from ``position_ids``,
  and labels were shifted before the permutation, so the loss is the same.

A rank's positions are non-decreasing in both layouts (zigzag: two runs
with a gap), which is what K1's binary search over them needs.
``install_ring_backend`` registers ``ring`` in the port's
``ATTENTION_BACKENDS``, bound to a mesh's ``cp`` group. The plain XLA ring
of JAX (``_ring_attention_shard_xla``) needs no second port: on CPU
tensors the K1 wrappers run their plain fp32 versions.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from automodel_tpu_torch.ops import ring_flash as rf


def zigzag_indices(seq_len: int, cp: int) -> np.ndarray:
    """Permutation putting global positions into zigzag-layout order: chunk
    list (0, 2cp-1), (1, 2cp-2), ... concatenated rank-major (JAX :48)."""
    if seq_len % (2 * cp):
        raise ValueError(f"seq_len {seq_len} must divide 2*cp={2 * cp}")
    half = seq_len // (2 * cp)
    chunks = np.arange(seq_len).reshape(2 * cp, half)
    order = []
    for r in range(cp):
        order.append(chunks[r])
        order.append(chunks[2 * cp - 1 - r])
    return np.concatenate(order)


def _take(x, idx: np.ndarray, axis: int):
    if isinstance(x, torch.Tensor):
        return torch.index_select(x, axis % x.dim(), torch.from_numpy(idx).to(x.device))
    return np.take(x, idx, axis=axis)


def apply_zigzag(x, cp: int, axis: int = 1):
    """Reorder the seq axis into zigzag layout (numpy arrays or tensors)."""
    return _take(x, zigzag_indices(x.shape[axis], cp), axis)


def undo_zigzag(x, cp: int, axis: int = 1):
    idx = zigzag_indices(x.shape[axis], cp)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(len(idx))
    return _take(x, inv, axis)


def _zigzag_positions(rank: int, s_loc: int, cp: int, device=None) -> torch.Tensor:
    """Global positions of a rank's local tokens in zigzag layout (int32)."""
    half = s_loc // 2
    a = torch.arange(half, dtype=torch.int32, device=device)
    return torch.cat([rank * half + a, (2 * cp - 1 - rank) * half + a])


def rank_positions(rank: int, s_loc: int, cp: int, zigzag: bool, device=None) -> torch.Tensor:
    """Global positions (int32 [s_loc]) of rank ``rank``'s tokens."""
    if zigzag:
        return _zigzag_positions(rank, s_loc, cp, device)
    return torch.arange(rank * s_loc, (rank + 1) * s_loc, dtype=torch.int32, device=device)


def live_pairs(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs a causal / windowed mask leaves visible
    between two position runs (segments aside)."""
    qp, kp = q_pos.long()[:, None], kv_pos.long()[None, :]
    m = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= qp >= kp
    if window is not None:
        m &= qp - kp < window
    return int(m.sum())


# -- the per-rank steps ------------------------------------------------------------


def ring_fwd_step(q, k_blk, v_blk, q_pos, kv_pos, seg_q, seg_kv, out, lse, **kw):
    """One ring step's forward: K1 over (q, this block) at the block's
    positions, merged in fp32 into (out [B, S, N, H], lse [B, N, S])."""
    o_t, lse_t = rf.flash_block_fwd(q, k_blk, v_blk, q_pos, kv_pos, seg_q, seg_kv, **kw)
    return rf.merge_partials(out, lse, o_t.float(), lse_t)


def ring_bwd_step(q, k_blk, v_blk, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, **kw):
    """One ring step's backward: K1's dq and dkv over (q, this block) →
    (dq, dk, dv) fp32."""
    return rf.flash_block_bwd(q, k_blk, v_blk, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, **kw)


def ring_init(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge's starting (out, lse): zeros and ``NEG_INF``."""
    B, S, N, H = q.shape
    return (torch.zeros((B, S, N, H), dtype=torch.float32, device=q.device),
            torch.full((B, N, S), rf.NEG_INF, dtype=torch.float32, device=q.device))


def ring_finish(out: torch.Tensor, lse: torch.Tensor, sinks: Optional[torch.Tensor], dtype: torch.dtype):
    """Fold the sinks into the merged (out, lse) and cast out to ``dtype``."""
    if sinks is not None:
        out, lse = rf.fold_sinks(out, lse, sinks)
    return out.to(dtype), lse


def ring_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The flash backward's delta = rowsum(dO * O), [B, N, S] fp32."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# -- one process driving every rank -----------------------------------------------


def ring_forward_ranks(qs: Sequence[torch.Tensor], ks, vs, segs=None, sinks=None, *, zigzag: bool = False,
                       causal: bool = True, window=None, scale: Optional[float] = None, soft_cap=None):
    """Every rank's forward of a ``cp = len(qs)``-rank ring, in one process:
    rank r's step s attends to the block of rank ``(r - s) % cp``, the one
    the rotation brings. → (outs in q's dtype, lses fp32), one a rank."""
    cp = len(qs)
    s_loc = qs[0].shape[1]
    scale = scale if scale is not None else 1.0 / (qs[0].shape[-1] ** 0.5)
    kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
    segs = segs or [None] * cp
    pos = [rank_positions(r, s_loc, cp, zigzag, qs[0].device) for r in range(cp)]
    outs, lses = [], []
    for r in range(cp):
        out, lse = ring_init(qs[r])
        for s in range(cp):
            j = (r - s) % cp
            out, lse = ring_fwd_step(qs[r], ks[j], vs[j], pos[r], pos[j], segs[r], segs[j], out, lse, **kw)
        out, lse = ring_finish(out, lse, sinks, qs[r].dtype)
        outs.append(out)
        lses.append(lse)
    return outs, lses


def ring_backward_ranks(qs, ks, vs, outs, lses, douts, segs=None, sinks=None, *, zigzag: bool = False,
                        causal: bool = True, window=None, scale: Optional[float] = None, soft_cap=None):
    """Every rank's backward of the ring in one process, from each rank's
    saved (out, lse) and its dout. dk and dv of block j are summed in the
    order the real ring sums them as the block travels (rank j first).
    → (dqs, dks, dvs in the inputs' dtypes, d_sinks fp32 or None)."""
    cp = len(qs)
    s_loc = qs[0].shape[1]
    scale = scale if scale is not None else 1.0 / (qs[0].shape[-1] ** 0.5)
    kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
    segs = segs or [None] * cp
    pos = [rank_positions(r, s_loc, cp, zigzag, qs[0].device) for r in range(cp)]
    deltas = [ring_delta(douts[r], outs[r]) for r in range(cp)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    for s in range(cp):
        for r in range(cp):
            j = (r - s) % cp
            dq_t, dk_t, dv_t = ring_bwd_step(qs[r], ks[j], vs[j], douts[r], lses[r], deltas[r], pos[r], pos[j],
                                             segs[r], segs[j], **kw)
            dq[r] += dq_t
            dk[j] += dk_t
            dv[j] += dv_t
    d_sinks = None
    if sinks is not None:
        d_sinks = sum(rf.sinks_grad(lses[r], deltas[r], sinks) for r in range(cp))
    return ([d.to(q.dtype) for d, q in zip(dq, qs)], [d.to(k.dtype) for d, k in zip(dk, ks)],
            [d.to(v.dtype) for d, v in zip(dv, vs)], d_sinks)


# -- the ring across processes ----------------------------------------------------


def _rotate(group, tensors: list, cp: int, rank: int) -> list:
    """Send each tensor to the next rank of the group and receive the
    previous rank's, in one batched P2P exchange."""
    import torch.distributed as dist

    nxt = dist.get_global_rank(group, (rank + 1) % cp)
    prv = dist.get_global_rank(group, (rank - 1) % cp)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, sinks, group, cp, rank, zigzag, causal, window, scale, soft_cap):
        kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
        s_loc = q.shape[1]
        q_pos = rank_positions(rank, s_loc, cp, zigzag, q.device)
        out, lse = ring_init(q)
        k_blk, v_blk, seg_blk = k, v, seg
        for step in range(cp):
            kv_pos = rank_positions((rank - step) % cp, s_loc, cp, zigzag, q.device)
            out, lse = ring_fwd_step(q, k_blk, v_blk, q_pos, kv_pos, seg, seg_blk, out, lse, **kw)
            if step < cp - 1:
                moving = [k_blk, v_blk] + ([] if seg is None else [seg_blk])
                moved = _rotate(group, moving, cp, rank)
                k_blk, v_blk = moved[:2]
                seg_blk = moved[2] if seg is not None else None
        out, lse = ring_finish(out, lse, sinks, q.dtype)
        ctx.kw, ctx.ring = kw, (group, cp, rank, zigzag)
        ctx.save_for_backward(q, k, v, seg, sinks, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, sinks, out, lse = ctx.saved_tensors
        group, cp, rank, zigzag = ctx.ring
        dout = dout.contiguous()
        s_loc = q.shape[1]
        q_pos = rank_positions(rank, s_loc, cp, zigzag, q.device)
        delta = ring_delta(dout, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        k_blk, v_blk, seg_blk = k, v, seg
        for step in range(cp):
            kv_pos = rank_positions((rank - step) % cp, s_loc, cp, zigzag, q.device)
            dq_t, dk_t, dv_t = ring_bwd_step(q, k_blk, v_blk, dout, lse, delta, q_pos, kv_pos, seg, seg_blk,
                                             **ctx.kw)
            dq += dq_t
            dk += dk_t
            dv += dv_t
            if step < cp - 1:
                # dk / dv ride the ring with their block
                moving = [k_blk, v_blk, dk, dv] + ([] if seg is None else [seg_blk])
                moved = _rotate(group, moving, cp, rank)
                k_blk, v_blk, dk, dv = moved[:4]
                seg_blk = moved[4] if seg is not None else None
            elif cp > 1:
                dk, dv = _rotate(group, [dk, dv], cp, rank)  # the final hop home
        d_sinks = None if sinks is None else rf.sinks_grad(lse, delta, sinks).to(sinks.dtype)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, d_sinks,
                None, None, None, None, None, None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Any = None,
    cp: int = 1,
    rank: int = 0,
    zigzag: bool = False,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ring attention on this rank's shard: q [B, S_loc, N, H], k/v [B,
    S_loc, Nkv, H], segment_ids [B, S_loc], over the ``cp`` ranks of
    ``group`` (this one ``rank`` among them) → [B, S_loc, N, H] in q's
    dtype; differentiable. At cp = 1 it is one K1 call, the same numbers as
    ``flash_attention``."""
    if cp > 1 and group is None:
        raise ValueError(f"ring attention over cp={cp} ranks needs their process group")
    N, H = q.shape[2], q.shape[3]
    if sinks is not None and tuple(sinks.shape) != (N,):
        raise ValueError(f"ring attention: sinks must be [{N}] (one per q head), got {tuple(sinks.shape)}")
    if logits_soft_cap is not None and not logits_soft_cap > 0:
        raise ValueError(f"ring attention: logits soft cap {logits_soft_cap} must be > 0")
    scale = scale if scale is not None else 1.0 / (H**0.5)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return _RingAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), seg, sinks, group, int(cp), int(rank),
        bool(zigzag and cp > 1), causal, sliding_window, scale,
        None if logits_soft_cap is None else float(logits_soft_cap),
    )


def make_ring_attention(mesh_ctx: Any = None, zigzag: bool = False):
    """The ``ring`` backend bound to a mesh's ``cp`` group (one device, cp
    = 1, without a mesh or with a ``cp`` of 1)."""
    cp = 1 if mesh_ctx is None else mesh_ctx.cp_size
    group = mesh_ctx.group("cp") if cp > 1 else None
    rank = mesh_ctx.coordinate("cp") if cp > 1 else 0

    def ring(q, k, v, *, causal: bool = True, scale=None, segment_ids=None, logits_soft_cap=None,
             sliding_window=None, sinks=None, **_ignored):
        return ring_attention(
            q, k, v, group=group, cp=cp, rank=rank, zigzag=zigzag and cp > 1, causal=causal, scale=scale,
            segment_ids=segment_ids, logits_soft_cap=logits_soft_cap, sliding_window=sliding_window, sinks=sinks,
        )

    ring.cp, ring.zigzag = cp, zigzag and cp > 1
    return ring


def install_ring_backend(mesh_ctx: Any = None, zigzag: bool = False) -> None:
    """Register ``ring`` in ``ops.attention.ATTENTION_BACKENDS``, bound to
    this mesh (JAX :420; one mesh a process)."""
    from automodel_tpu_torch.ops.attention import ATTENTION_BACKENDS

    ATTENTION_BACKENDS["ring"] = make_ring_attention(mesh_ctx, zigzag=zigzag)
