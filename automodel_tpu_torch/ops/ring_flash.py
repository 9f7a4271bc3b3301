"""Blockwise (flash) attention: the forward and the dq / dkv backward, with
positional masking, and the single-device ``flash_attention`` built on them.

Port of ``automodel_tpu/ops/ring_flash.py``. ``flash_block_fwd``,
``flash_block_dq`` and ``flash_block_dkv`` wrap the three hand-written
Hopper kernels of ``csrc/flash_attention.cu`` (which replace the Pallas
``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``, and with them what
the library splash kernel computes for ``attn: flash``, the logits soft
cap included), at head_dim 64, 128 and 256: given CUDA tensors they
launch the kernel or raise, given CPU tensors they run ``_flash_fwd_plain``
/ ``_flash_dq_plain`` / ``_flash_dkv_plain``, the same functions in plain
fp32 torch. There is no path from a CUDA tensor to a plain version.

Masking is positional, as in the JAX kernels: callers pass the global
position of every query row (``q_pos``) and key (``kv_pos``); entry (i, j)
is visible when the segment ids agree, ``q_pos[i] >= kv_pos[j]`` under
``causal`` and ``q_pos[i] - kv_pos[j] < window`` under a window. A row that
sees nothing gets out 0 and lse ``NEG_INF``.

``soft_cap`` (Gemma 2's ``attn_logit_softcapping``) caps the scores before
the mask, as splash's ``attn_logits_soft_cap`` does: s = c * tanh(scale *
q.k / c), masked pairs then set to ``NEG_INF``, the lse taken over the
capped scores. The backward carries the cap's derivative: dS = P * (dP -
delta) * (1 - t^2) with t = tanh(scale * q.k / c), recomputed from the
scores (not from s / c); dq = scale * dS.K and dk = scale * dS^T.Q as
without a cap.

The CUDA kernels find their live tiles from the positions, so there the
positions must be non-decreasing: the single-device layout and each
rank's block of the context-parallel ring (``parallel/cp.py``), contiguous
or zigzag (two runs with a gap). ``merge_partials`` merges one ring step's
(out, lse) into the running pair, in plain fp32 torch.

The kernels round P (and dS) to bf16 before the P.V (dS.K, dS^T.Q) products
where the JAX kernels keep them fp32; the plain versions keep them fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from automodel_tpu_torch.telemetry.profiling import cost as _cost

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# the CUDA kernels' limits (csrc/flash_attention.cu)
CUDA_HEAD_DIMS = (64, 128, 256)
CUDA_DTYPES = (torch.bfloat16,)


# -- plain versions ---------------------------------------------------------------


def _mask(q_pos, kv_pos, seg_q, seg_kv, causal: bool, window: Optional[int]) -> torch.Tensor:
    """[B or 1, Sq, Sk] bool: which (query, key) pairs are visible."""
    qp = q_pos.long()[:, None]
    kp = kv_pos.long()[None, :]
    m = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (qp >= kp)
    if window is not None:
        m = m & (qp - kp < window)
    m = m[None]
    if seg_q is not None:
        m = m & (seg_q[:, :, None] == seg_kv[:, None, :])
    return m


def _scores(q, k, scale: float, soft_cap: Optional[float] = None):
    """The scores in fp32, [B, Nkv, rep, Sq, Sk] (head n = g * rep + r): scale
    * q.k, capped to c * tanh(scale * q.k / c) under ``soft_cap`` c. → (s,
    the cap's derivative 1 - t^2 with t = tanh(scale * q.k / c), or None)."""
    B, Sq, N, H = q.shape
    Nkv = k.shape[2]
    qf = q.float().reshape(B, Sq, Nkv, N // Nkv, H)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.float()) * scale
    if soft_cap is None:
        return s, None
    t = torch.tanh(s / soft_cap)
    return soft_cap * t, 1.0 - t * t


def _probs(q, k, lse, mask, scale: float, soft_cap: Optional[float] = None):
    """Recomputed P = exp(s - lse) over visible pairs, [B, Nkv, rep, Sq, Sk]
    fp32 (lse given), as the backward kernels do. → (P, the cap's
    derivative or None)."""
    s, dcap = _scores(q, k, scale, soft_cap)
    B, Nkv, rep, Sq, _ = s.shape
    lse = lse.float().reshape(B, Nkv, rep, Sq, 1)
    m = mask[:, None, None]
    p = torch.where(m, torch.exp(torch.where(m, s - lse, torch.zeros_like(s))), torch.zeros_like(s))
    return p, dcap


def _flash_fwd_plain(q, k, v, q_pos, kv_pos, seg_q, seg_kv, *, causal, window, scale, soft_cap=None):
    """The forward kernel's function in plain fp32 torch: → (out [B, Sq, N, H]
    in q.dtype, lse [B, N, Sq] fp32)."""
    B, Sq, N, H = q.shape
    s, _ = _scores(q, k, scale, soft_cap)
    m = _mask(q_pos, kv_pos, seg_q, seg_kv, causal, window)[:, None, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(m, torch.exp(s - mx), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bkgh->bgrqh", p, v.float())
    safe = l.clamp_min(1e-30)
    out = torch.where(l > 0, acc / safe, torch.zeros_like(acc))
    lse = torch.where(l > 0, mx + torch.log(safe), torch.full_like(l, NEG_INF))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, N, H).to(q.dtype)
    return out, lse.reshape(B, N, Sq)


def _dscores(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, causal, window, scale, soft_cap):
    """(P, dS) of the backward, [B, Nkv, rep, Sq, Sk] fp32: dS = P * (dP -
    delta), times the cap's derivative under a soft cap."""
    B, Sq, N, H = q.shape
    Nkv = k.shape[2]
    p, dcap = _probs(q, k, lse, _mask(q_pos, kv_pos, seg_q, seg_kv, causal, window), scale, soft_cap)
    dp = torch.einsum("bqgrh,bkgh->bgrqk", do.float().reshape(B, Sq, Nkv, N // Nkv, H), v.float())
    ds = p * (dp - delta.float().reshape(B, Nkv, N // Nkv, Sq, 1))
    return p, ds if dcap is None else ds * dcap


def _flash_dq_plain(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, *, causal, window, scale,
                    soft_cap=None):
    """The dq kernel's function in plain fp32 torch: → dq [B, Sq, N, H] fp32."""
    B, Sq, N, H = q.shape
    _, ds = _dscores(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, causal, window, scale, soft_cap)
    dq = scale * torch.einsum("bgrqk,bkgh->bqgrh", ds, k.float())
    return dq.reshape(B, Sq, N, H)


def _flash_dkv_plain(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, *, causal, window, scale,
                     soft_cap=None):
    """The dkv kernel's function in plain fp32 torch: → (dk, dv) [B, Sk,
    Nkv, H] fp32, summed over the q heads of each kv head."""
    B, Sq, N, H = q.shape
    Nkv = k.shape[2]
    rep = N // Nkv
    p, ds = _dscores(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, causal, window, scale, soft_cap)
    dv = torch.einsum("bgrqk,bqgrh->bkgh", p, do.float().reshape(B, Sq, Nkv, rep, H))
    dk = scale * torch.einsum("bgrqk,bqgrh->bkgh", ds, q.float().reshape(B, Sq, Nkv, rep, H))
    return dk, dv


# -- the CUDA kernels -------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from automodel_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("flash_attention")
    if not hasattr(lib, "_flash_bound"):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i] * 8 + [f, f, p]  # B, Sq, Sk, N, Nkv, H, causal, window, scale, cap, stream
        lib.flash_attention_fwd.argtypes = [p] * 9 + shape
        lib.flash_attention_dq.argtypes = [p] * 11 + shape
        lib.flash_attention_dkv.argtypes = [p] * 12 + shape
        for fn in (lib.flash_attention_fwd, lib.flash_attention_dq, lib.flash_attention_dkv):
            fn.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._flash_bound = True
    return lib


def _check_cuda(name: str, q, k, v, q_pos, kv_pos, seg_q, seg_kv, window, soft_cap, **more) -> None:
    """Raise on what the kernels do not take; positions must be
    non-decreasing, which is checked on the card without a host sync."""
    if q.dtype not in CUDA_DTYPES:
        raise ValueError(f"{name}: the CUDA kernel takes {CUDA_DTYPES} q/k/v, got {q.dtype}")
    B, Sq, N, H = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != H or v.shape != k.shape:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Sk, Nkv = k.shape[1], k.shape[2]
    if N % Nkv:
        raise ValueError(f"{name}: {N} heads not a multiple of {Nkv} kv heads")
    if H not in CUDA_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {H} (the CUDA kernel takes {CUDA_HEAD_DIMS})")
    if window is not None and window < 1:
        raise ValueError(f"{name}: sliding window {window} must be >= 1")
    if soft_cap is not None and not soft_cap > 0:
        raise ValueError(f"{name}: logits soft cap {soft_cap} must be > 0")
    tensors = dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos, **more)
    if seg_q is not None:
        tensors.update(seg_q=seg_q, seg_kv=seg_kv)
    for t_name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t_name in ("q", "k", "v", "dout") and t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must start on a 16-byte boundary (TMA)")
    for t_name, t in tensors.items():
        if t_name in ("k", "v", "dout") and t.dtype != q.dtype:
            raise ValueError(f"{name}: {t_name} is {t.dtype}, q is {q.dtype}")
        if t_name in ("lse", "delta") and (t.dtype != torch.float32 or tuple(t.shape) != (B, N, Sq)):
            raise ValueError(f"{name}: {t_name} must be fp32 [{B}, {N}, {Sq}]")
    want = dict(q_pos=(Sq,), kv_pos=(Sk,), seg_q=(B, Sq), seg_kv=(B, Sk))
    for t_name, shape in want.items():
        t = tensors.get(t_name)
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {t_name} must be int32 {list(shape)}")
    if Sq > 1:
        torch._assert_async(torch.all(q_pos[1:] >= q_pos[:-1]), f"{name}: q_pos must be non-decreasing")
    if Sk > 1:
        torch._assert_async(torch.all(kv_pos[1:] >= kv_pos[:-1]), f"{name}: kv_pos must be non-decreasing")


def _shape_args(q, k, causal, window, scale, soft_cap) -> list:
    B, Sq, N, H = q.shape
    Sk, Nkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cap = 0.0 if soft_cap is None else float(soft_cap)  # <= 0: no cap
    return [B, Sq, Sk, N, Nkv, H, int(bool(causal)), -1 if window is None else int(window), float(scale), cap,
            stream]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(lib, rc: int, which: str) -> None:
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_{which} kernel launch failed ({rc}): {msg}")


def _device_kind(name: str, q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return q.device.type


# -- the wrappers -----------------------------------------------------------------



def _attn_flops(q, k, *args, **kwargs) -> float:
    """The plain attention's work a K1 kernel stands for (telemetry/
    profiling/cost.py): one full-rectangle pair of products, 2 x 2·B·N·Sq·Sk·H
    (the forward's QKᵀ and PV; dq's dP and dQ; dkv's dV and dK)."""
    B, Sq, N, H = q.shape
    return 4.0 * B * N * Sq * k.shape[1] * H


@_cost.counted(_attn_flops)
def flash_block_fwd(q, k, v, q_pos, kv_pos, seg_q, seg_kv, *, causal, window, scale, soft_cap=None):
    """q [B, Sq, N, H] x k/v [B, Sk, Nkv, H] → (out [B, Sq, N, H] in q.dtype,
    lse [B, N, Sq] fp32). Positions int32 [Sq] / [Sk]; segment ids int32
    [B, Sq] / [B, Sk] or None; ``soft_cap`` the logits soft cap or None.
    CUDA tensors launch the forward kernel (and count it in
    ``flash_block_fwd.launches``); CPU tensors run the plain version."""
    kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
    if _device_kind("flash_block_fwd", q) == "cpu":
        return _flash_fwd_plain(q, k, v, q_pos, kv_pos, seg_q, seg_kv, **kw)
    _check_cuda("flash_block_fwd", q, k, v, q_pos, kv_pos, seg_q, seg_kv, window, soft_cap)
    B, Sq, N, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, N, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            _ptr(seg_q), _ptr(seg_kv), out.data_ptr(), lse.data_ptr(),
            *_shape_args(q, k, causal, window, scale, soft_cap),
        )
    _raise_on(lib, rc, "fwd")
    flash_block_fwd.launches += 1
    return out, lse


@_cost.counted(_attn_flops)
def flash_block_dq(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, *, causal, window, scale, soft_cap=None):
    """→ dq [B, Sq, N, H] fp32 from the saved lse and delta = rowsum(dO *
    out), both [B, N, Sq] fp32. CUDA tensors launch the dq kernel (counted
    in ``flash_block_dq.launches``); CPU tensors run the plain version."""
    kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
    if _device_kind("flash_block_dq", q) == "cpu":
        return _flash_dq_plain(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, **kw)
    _check_cuda("flash_block_dq", q, k, v, q_pos, kv_pos, seg_q, seg_kv, window, soft_cap, dout=do, lse=lse,
                delta=delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(), _ptr(seg_q), _ptr(seg_kv), dq.data_ptr(),
            *_shape_args(q, k, causal, window, scale, soft_cap),
        )
    _raise_on(lib, rc, "dq")
    flash_block_dq.launches += 1
    return dq


@_cost.counted(_attn_flops)
def flash_block_dkv(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, *, causal, window, scale,
                    soft_cap=None):
    """→ (dk, dv) [B, Sk, Nkv, H] fp32, already summed over each GQA group.
    CUDA tensors launch the dkv kernel (counted in
    ``flash_block_dkv.launches``); CPU tensors run the plain version."""
    kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
    if _device_kind("flash_block_dkv", q) == "cpu":
        return _flash_dkv_plain(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, **kw)
    _check_cuda("flash_block_dkv", q, k, v, q_pos, kv_pos, seg_q, seg_kv, window, soft_cap, dout=do, lse=lse,
                delta=delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(), _ptr(seg_q), _ptr(seg_kv), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(q, k, causal, window, scale, soft_cap),
        )
    _raise_on(lib, rc, "dkv")
    flash_block_dkv.launches += 1
    return dk, dv


flash_block_fwd.launches = 0
flash_block_dq.launches = 0
flash_block_dkv.launches = 0


def flash_block_bwd(q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv, *, causal, window, scale,
                    soft_cap=None):
    """The JAX ``flash_block_bwd``: → (dq [B, Sq, N, H], dk, dv [B, Sk, Nkv,
    H]), all fp32."""
    args = (q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv)
    kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
    dq = flash_block_dq(*args, **kw)
    dk, dv = flash_block_dkv(*args, **kw)
    return dq, dk, dv


def merge_partials(out_a: torch.Tensor, lse_a: torch.Tensor, out_t: torch.Tensor, lse_t: torch.Tensor):
    """Online-softmax merge of two independently normalized partial
    attentions (JAX :407). out [B, S, N, H] fp32, lse [B, N, S] fp32. Rows
    dead on both sides (lse ``NEG_INF``) stay at 0 / ``NEG_INF``."""
    m = torch.maximum(lse_a, lse_t)
    alive = m > NEG_INF / 2
    zero = torch.zeros_like(m)
    wa = torch.where(alive, torch.exp(lse_a - m), zero)
    wt = torch.where(alive, torch.exp(lse_t - m), zero)
    denom = torch.clamp(wa + wt, min=1e-30)
    wa_n = (wa / denom).transpose(1, 2)[..., None]
    wt_n = (wt / denom).transpose(1, 2)[..., None]
    out = out_a * wa_n + out_t * wt_n
    lse = torch.where(alive, m + torch.log(denom), torch.full_like(m, NEG_INF))
    return out, lse


def fold_sinks(out: torch.Tensor, lse: torch.Tensor, sinks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sink is one zero-value virtual key per head, folded in after the
    kernel (JAX :358-371): lse' = logaddexp(lse, sink), out' = out *
    exp(lse - lse') → (out' in out.dtype, lse' fp32 [B, N, S]). With lse'
    saved, the backward kernels' P = exp(s - lse') are the probabilities of
    the softmax extended by the sink column."""
    lse_ext = torch.logaddexp(lse, sinks.float()[None, :, None])
    scale = torch.exp(lse - lse_ext).transpose(1, 2)[..., None]  # [B, S, N, 1]
    return (out.float() * scale).to(out.dtype), lse_ext


def sinks_grad(lse_ext: torch.Tensor, delta: torch.Tensor, sinks: torch.Tensor) -> torch.Tensor:
    """d_sinks [N] fp32: the sink column's dP is dO . v_sink = 0, so dS =
    p_sink (0 - delta), summed over the batch and the rows (JAX :393-396)."""
    p_sink = torch.exp(sinks.float()[None, :, None] - lse_ext)
    return -(p_sink * delta).sum(dim=(0, 2))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos, seg, sinks, causal, window, scale, soft_cap):
        ctx.kw = dict(causal=causal, window=window, scale=scale, soft_cap=soft_cap)
        out, lse = flash_block_fwd(q, k, v, pos, pos, seg, seg, **ctx.kw)
        if sinks is not None:
            out, lse = fold_sinks(out, lse, sinks)
        ctx.save_for_backward(q, k, v, out, lse, pos, seg, sinks)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, pos, seg, sinks = ctx.saved_tensors
        dout = dout.contiguous()
        # delta from the folded output and the kernels fed the extended lse
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # [B, N, S]
        dq, dk, dv = flash_block_bwd(q, k, v, dout, lse, delta, pos, pos, seg, seg, **ctx.kw)
        d_sinks = None if sinks is None else sinks_grad(lse, delta, sinks).to(sinks.dtype)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, d_sinks, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Single-device flash attention over the blockwise kernels, one kv
    "ring step" covering the whole sequence. q [B, S, N, H] x k/v [B, S,
    Nkv, H] → [B, S, N, H] in q.dtype; differentiable (the backward runs
    the dq and dkv kernels). Any S: the kernels mask the ragged edge
    themselves. ``sinks`` [N] (gpt-oss) are folded in after the forward
    kernel, with an exact gradient (``fold_sinks``, ``sinks_grad``);
    ``soft_cap`` (Gemma 2) is applied inside the kernels."""
    S, N, H = q.shape[1], q.shape[2], q.shape[3]
    if sinks is not None and tuple(sinks.shape) != (N,):
        raise ValueError(f"flash_attention: sinks must be [{N}] (one per q head), got {tuple(sinks.shape)}")
    if soft_cap is not None and not soft_cap > 0:
        raise ValueError(f"flash_attention: logits soft cap {soft_cap} must be > 0")
    scale = scale if scale is not None else 1.0 / (H**0.5)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), pos, seg, sinks, causal, sliding_window, scale,
        None if soft_cap is None else float(soft_cap),
    )
