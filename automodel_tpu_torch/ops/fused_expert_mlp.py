"""Fused expert MLP for the MoE experts (``experts: ragged_fused``):
``out = act(lhs @ Wg + gb, lhs @ Wu + ub) @ Wd + db`` per row's group, with
a hand-written backward.

Port of ``automodel_tpu/ops/fused_expert_mlp.py``. ``fwd``, ``bwd_gu``,
``bwd_act``, ``bwd_dwd`` and ``bwd_dx`` wrap the hand-written Hopper
kernels of ``csrc/fused_expert_mlp.cu`` and ``csrc/grouped_matmul.cu``
(together they replace the Pallas ``_kernel``, ``_bwd_gu_kernel``,
``_bwd_dwd_kernel`` and ``_bwd_dx_kernel``): given CUDA tensors they
launch the kernels or raise, given CPU tensors they run ``_fwd_plain`` /
``_bwd_gu_plain`` / ``_bwd_act_plain`` / ``_bwd_dwd_plain`` /
``_bwd_dx_plain``, the same functions in fp32 torch with a loop over
groups. There is no path from a CUDA tensor to a plain version or to a
library grouped GEMM.

The forward is two launches of the grouped matmul's gmm kernel with other
epilogues: the gate_up product writes mid = act(g + gb, u + ub) in bf16
(g, u and the activation in fp32, mid rounded once, as the TPU kernel
rounds it before its down product), then the down product adds db to its
fp32 sum. The TPU kernels recompute the activation's gradient per output
tile; here one pass, ``bwd_act``, writes mid = act(g, u) and dg | du once
per element (each rounded once to bf16, as the TPU kernels round them
before their products), and dW = tgmm(lhs, dg | du), dWd = tgmm(mid, dy)
and dlhs = gmm(dg | du, gate_up, transpose_rhs) run on the grouped-matmul
kernels; the bias grads of gate_up are fp32 sums of the unrounded dg, du
(a kernel of their own), as JAX's are.

The port keeps the stored layouts: gate and up are the two halves of one
``gate_up`` [G, D, 2I] (gate in ``[..., :I]``), read in place, and their
biases one ``gate_up_bias`` [G, 2I]; the JAX functions take the halves
apart. ``lhs`` rows are sorted by group (group g owns rows ``[start_g,
end_g)`` of the cumsum of ``group_sizes``, int32 on lhs's device); rows at
or past ``sum(group_sizes)`` come out as zeros and may hold anything, NaN
included, in ``lhs`` and ``dy``: no kernel reads them.

The activation runs in fp32: ``swiglu`` is ``silu(g) * u`` (with an
optional ``limit``: ``min(silu(g), limit) * clip(u, -limit, limit)``),
``swiglu_oai`` is ``(clip(u, -7, 7) + 1) * g' * sigmoid(1.702 g')`` with
``g' = min(g, 7)``. At a clamp's bound the gradient is 0.5, JAX's rule for
``minimum`` and ``maximum`` (``torch.clamp`` would give 1).

``fused_expert_mlp`` is differentiable. Its backward follows ``_vjp_bwd``
(:702-782): it recomputes ``gu = gmm(lhs, gate_up)`` through K2 (one launch
over the fused weight), adds the biases in the compute dtype, computes
``dmid = gmm(dy, down, transpose_rhs=True)`` through K2, runs ``bwd_act``
once, then ``bwd_dwd`` and ``bwd_gu`` (each weight grad in its primal's
dtype, written by the kernel) and ``bwd_dx`` given its outputs, and casts
each other grad to its primal's dtype. The forward keeps g, u and the
activation in fp32; the backward sees g and u rounded to the compute
dtype, as the JAX path does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from automodel_tpu_torch.telemetry.profiling import cost as _cost

from automodel_tpu_torch.ops import grouped_matmul as gm
from automodel_tpu_torch.ops.grouped_matmul import (
    ALIGN,
    CUDA_DTYPES,
    GMM_TILE_M,
    TGMM_OUT_DTYPES,
    _bounds,
    _gmm_plain,
    _tgmm_plain,
    gmm,
    gmm_plan,
)

ACT_KINDS = ("swiglu", "swiglu_oai")
OAI_CLAMP = 7.0
OAI_ALPHA = 1.702


# -- the activation, fp32 --------------------------------------------------------


def _clip(x: torch.Tensor, lo: Optional[float], hi: float) -> torch.Tensor:
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    return torch.minimum(x, x.new_tensor(hi))


def _clip_grad(x: torch.Tensor, lo: Optional[float], hi: float) -> torch.Tensor:
    """d/dx of ``_clip`` under JAX's rule: 1 inside, 0 outside, 0.5 at a bound."""
    inside = x < hi if lo is None else (x > lo) & (x < hi)
    at = x == hi if lo is None else (x == lo) | (x == hi)
    return torch.where(at, 0.5, inside.float())


def _act_core(g: torch.Tensor, u: torch.Tensor, act_kind: str, limit: Optional[float]) -> torch.Tensor:
    """The post-bias activation (JAX ``_act_core``, :298), in g's dtype:
    fp32 in the plain versions, the compute dtype in ``make_act2``."""
    if act_kind == "swiglu_oai":
        gc = _clip(g, None, OAI_CLAMP)
        return (_clip(u, -OAI_CLAMP, OAI_CLAMP) + 1.0) * (gc * torch.sigmoid(OAI_ALPHA * gc))
    mid = g * torch.sigmoid(g)  # jax.nn.silu's definition, which the kernels compute
    if limit is not None:
        mid = _clip(mid, None, limit)
        u = _clip(u, -limit, limit)
    return mid * u


def _act_grads(g, u, dmid, act_kind: str, limit: Optional[float]) -> tuple[torch.Tensor, torch.Tensor]:
    """(dg, du) fp32 of ``_act_core`` at (g, u) for the upstream ``dmid``:
    JAX's ``jax.vjp`` of it (:321), ties at a clamp's bound included."""
    g, u, dmid = g.float(), u.float(), dmid.float()
    if act_kind == "swiglu_oai":
        gc = _clip(g, None, OAI_CLAMP)
        s = torch.sigmoid(OAI_ALPHA * gc)
        du = dmid * (gc * s) * _clip_grad(u, -OAI_CLAMP, OAI_CLAMP)
        uc = _clip(u, -OAI_CLAMP, OAI_CLAMP)
        dg = dmid * (uc + 1.0) * (s + OAI_ALPHA * gc * s * (1.0 - s)) * _clip_grad(g, None, OAI_CLAMP)
        return dg, du
    s = torch.sigmoid(g)
    silu = g * s
    m, uc = silu, u
    dm = dmid * u
    du_scale = 1.0
    if limit is not None:
        m = _clip(silu, None, limit)
        uc = _clip(u, -limit, limit)
        dm = dmid * uc * _clip_grad(silu, None, limit)
        du_scale = _clip_grad(u, -limit, limit)
    return dm * (s + g * s * (1.0 - s)), dmid * m * du_scale


# -- plain versions ---------------------------------------------------------------


def _groups(group_sizes: torch.Tensor, M: int):
    return [(g, s, e) for g, (s, e) in enumerate(_bounds(group_sizes, M)) if e > s]


def _fwd_plain(lhs, gate_up, down, group_sizes, gate_up_bias=None, down_bias=None, act_kind="swiglu", limit=None):
    """The forward (JAX ``_fwd``, :130) in fp32 torch, one group at a time:
    g, u and the activation in fp32, mid rounded to lhs.dtype before the
    down product (:107-108) → [M, D] in lhs.dtype, rows past the groups 0."""
    M, D = lhs.shape
    I = down.shape[1]
    out = torch.zeros((M, D), dtype=torch.float32, device=lhs.device)
    for g, s, e in _groups(group_sizes, M):
        gu = lhs[s:e].float() @ gate_up[g].float()
        if gate_up_bias is not None:
            gu = gu + gate_up_bias[g].float()
        mid = _act_core(gu[:, :I], gu[:, I:], act_kind, limit).to(lhs.dtype).float()
        y = mid @ down[g].float()
        out[s:e] = y if down_bias is None else y + down_bias[g].float()
    return out.to(lhs.dtype)


def _bwd_gu_plain(lhs, gu, dmid, group_sizes, act_kind="swiglu", limit=None, want_bias=False,
                  out_dtype=torch.float32, dgdu=None):
    """JAX ``_bwd_gu`` (:465) in fp32 torch → (dW [G, D, 2I] = lhs_g^T
    [dg | du] summed in fp32 and cast once to ``out_dtype``, dg, du rounded
    to gu.dtype first (:438-445; dgdu from ``_bwd_act_plain`` unless
    given); dbias [G, 2I] fp32 row sums of the unrounded dg, du or None).
    gu [M, 2I] is the recomputed g | u, in lhs's dtype."""
    M, I = lhs.shape[0], dmid.shape[1]
    if dgdu is None:
        _, dgdu = _bwd_act_plain(gu, dmid, group_sizes, act_kind, limit, want_mid=False)
    dw = _tgmm_plain(lhs, dgdu, group_sizes, out_dtype)
    dbias = None
    if want_bias:
        dbias = torch.zeros((group_sizes.shape[0], 2 * I), dtype=torch.float32, device=lhs.device)
        for g, s, e in _groups(group_sizes, M):
            dbias[g] = torch.cat(_act_grads(gu[s:e, :I], gu[s:e, I:], dmid[s:e], act_kind, limit), dim=1).sum(dim=0)
    return dw, dbias


def _bwd_act_plain(gu, dmid, group_sizes, act_kind="swiglu", limit=None, want_mid=True, want_dgdu=True):
    """The backward's elementwise pass in fp32 torch → (mid [M, I] =
    act(g, u), as JAX's ``_bwd_dwd_kernel`` rounds it (:537-547), or None;
    dgdu [M, 2I] = dg | du of act at (g, u) for dmid, as ``_bwd_dx_kernel``
    rounds them (:629-642), or None), each rounded once to gu.dtype; rows at
    or past sum(group_sizes) zero, whatever gu and dmid hold there."""
    M, I = gu.shape[0], gu.shape[1] // 2
    n = min(int(group_sizes.sum()), M)
    g, u = gu[:n, :I].float(), gu[:n, I:].float()
    mid = dgdu = None
    if want_mid:
        mid = gu.new_zeros((M, I))
        mid[:n] = _act_core(g, u, act_kind, limit).to(gu.dtype)
    if want_dgdu:
        dgdu = gu.new_zeros((M, 2 * I))
        dg, du = _act_grads(g, u, dmid[:n], act_kind, limit)
        dgdu[:n, :I], dgdu[:n, I:] = dg.to(gu.dtype), du.to(gu.dtype)
    return mid, dgdu


def _bwd_dwd_plain(gu, dy, group_sizes, act_kind="swiglu", limit=None, want_bias=False, out_dtype=torch.float32,
                   mid=None):
    """JAX ``_bwd_dwd`` (:560) in fp32 torch → (dWd [G, I, D] = mid_g^T dy_g
    summed in fp32 and cast once to ``out_dtype``, mid from
    ``_bwd_act_plain`` unless given; ddb [G, D] fp32 row sums of dy or
    None)."""
    if mid is None:
        mid, _ = _bwd_act_plain(gu, None, group_sizes, act_kind, limit, want_dgdu=False)
    dwd = _tgmm_plain(mid, dy, group_sizes, out_dtype)
    ddb = None
    if want_bias:
        ddb = torch.zeros((group_sizes.shape[0], dy.shape[1]), dtype=torch.float32, device=dy.device)
        for g, s, e in _groups(group_sizes, dy.shape[0]):
            ddb[g] = dy[s:e].float().sum(dim=0)
    return dwd, ddb


def _bwd_dx_plain(gu, dmid, gate_up, group_sizes, act_kind="swiglu", limit=None, dgdu=None):
    """JAX ``_bwd_dx`` (:649) in fp32 torch → dlhs [M, D] in gu.dtype =
    dg Wg^T + du Wu^T, dg | du from ``_bwd_act_plain`` unless given, rows
    past the groups 0."""
    if dgdu is None:
        _, dgdu = _bwd_act_plain(gu, dmid, group_sizes, act_kind, limit, want_mid=False)
    return _gmm_plain(dgdu, gate_up, group_sizes, transpose_rhs=True)


# -- the CUDA kernels ---------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from automodel_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("fused_expert_mlp")
    if not hasattr(lib, "_fem_bound"):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # ..., M, [D, ]I, G[, act_kind, limit], stream
        lib.fused_expert_mlp_bwd_act.argtypes = [p] * 5 + [i] * 4 + [f, p]
        lib.fused_expert_mlp_bwd_ddb.argtypes = [p] * 3 + [i] * 3 + [p]
        lib.fused_expert_mlp_bwd_dgub.argtypes = [p] * 4 + [i] * 4 + [f, p]
        for fn in ("bwd_act", "bwd_ddb", "bwd_dgub"):
            getattr(lib, f"fused_expert_mlp_{fn}").restype = i
        lib.fused_expert_mlp_error_string.argtypes = [i]
        lib.fused_expert_mlp_error_string.restype = ctypes.c_char_p
        lib._fem_bound = True
    return lib


def _check_act(act_kind: str, limit: Optional[float]) -> None:
    if act_kind not in ACT_KINDS:
        raise ValueError(f"fused expert MLP: act_kind={act_kind!r} (want one of {ACT_KINDS})")
    if limit is not None and not limit > 0:
        raise ValueError(f"fused expert MLP: limit={limit!r} must be > 0")


def _act_args(act_kind: str, limit: Optional[float]) -> list:
    return [ACT_KINDS.index(act_kind), float(limit or 0.0)]


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type == "cpu"


def _check_cuda(name: str, group_sizes: torch.Tensor, shapes: dict, **tensors: Optional[torch.Tensor]) -> None:
    """Raise ValueError on what the kernels do not take: ``shapes`` names
    each tensor's expected shape."""
    first = next(iter(tensors.values()))
    for t_name, t in tensors.items():
        if t is None:
            continue
        if tuple(t.shape) != shapes[t_name]:
            raise ValueError(f"{name}: {t_name} is {tuple(t.shape)}, want {shapes[t_name]}")
        if t.dtype not in CUDA_DTYPES:
            raise ValueError(f"{name}: the CUDA kernel takes {CUDA_DTYPES} operands, {t_name} is {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must start on a 16-byte boundary (TMA, 16-byte loads)")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1 or group_sizes.device != first.device:
        raise ValueError(f"{name}: group_sizes must be int32 [G] on {first.device}")


def _check_dims(name: str, D: int, I: int) -> None:
    if D % ALIGN or I % ALIGN or D < ALIGN or I < ALIGN:
        raise ValueError(f"{name}: D={D} and I={I} must be multiples of {ALIGN}")


def _plan_for(plan: Optional[torch.Tensor], group_sizes: torch.Tensor, M: int, name: str) -> torch.Tensor:
    G = group_sizes.shape[0]
    W = -(-M // GMM_TILE_M) + G + 1
    if plan is None:
        plan = gmm_plan(group_sizes, M)
    if plan.dtype != torch.int32 or tuple(plan.shape) != (4, W) or plan.device != group_sizes.device:
        raise ValueError(f"{name}: plan must be int32 [4, {W}] on {group_sizes.device} (gmm_plan(group_sizes, {M}))")
    return plan


def _ends(group_sizes: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(group_sizes, 0, dtype=torch.int32)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, rc: int, which: str) -> None:
    if rc != 0:
        msg = lib.fused_expert_mlp_error_string(rc).decode()
        raise RuntimeError(f"fused_expert_mlp_{which} kernel launch failed ({rc}): {msg}")


def _gmm_order(K: int, N: int, ends: torch.Tensor, n_major: Optional[bool] = None):
    """(n_major, the ends pointer it reads or None): the order of a group's
    items the gmm kernel takes for a K x N product, as ``gmm`` picks it
    unless ``n_major`` is given."""
    if n_major is None:
        n_major = bool(gm._lib().grouped_matmul_gmm_n_major(K, N))
    return int(n_major), ends.data_ptr() if n_major else None


def _launch_fwd_gu_act(lhs, gate_up, gate_up_bias, plan, ends, act_kind, limit, n_major=None) -> torch.Tensor:
    """The forward's first launch (the gmm kernel with the gate_up
    activation in its epilogue) → mid [M, I] bf16; a group's items in the
    order gmm takes over the whole gate_up unless ``n_major`` is given
    (chip_smoke.py times both)."""
    M, D = lhs.shape
    G, _, I2 = gate_up.shape
    mid = torch.empty((M, I2 // 2), dtype=lhs.dtype, device=lhs.device)
    n_major, ends_ptr = _gmm_order(D, I2, ends, n_major)
    lib = gm._lib()
    with torch.cuda.device(lhs.device):
        rc = lib.grouped_matmul_gmm_act(
            lhs.data_ptr(), gate_up.data_ptr(), _ptr(gate_up_bias), plan.data_ptr(), ends_ptr, mid.data_ptr(),
            M, D, I2 // 2, G, plan.shape[1], n_major, *_act_args(act_kind, limit), _stream(lhs),
        )
    gm._raise_on(lib, rc, "gmm_act")
    return mid


def _launch_fwd_down(mid, down, down_bias, plan, ends, n_major=None) -> torch.Tensor:
    """The forward's second launch (the gmm kernel with the row bias in its
    epilogue) → out [M, D] bf16; ``n_major`` as for ``_launch_fwd_gu_act``."""
    M, I = mid.shape
    G, _, D = down.shape
    out = torch.empty((M, D), dtype=mid.dtype, device=mid.device)
    n_major, ends_ptr = _gmm_order(I, D, ends, n_major)
    lib = gm._lib()
    with torch.cuda.device(mid.device):
        rc = lib.grouped_matmul_gmm_bias(
            mid.data_ptr(), down.data_ptr(), _ptr(down_bias), plan.data_ptr(), ends_ptr, out.data_ptr(),
            M, I, D, G, plan.shape[1], n_major, _stream(mid),
        )
    gm._raise_on(lib, rc, "gmm_bias")
    return out


# -- the wrappers -------------------------------------------------------------------



def _n(group_sizes: torch.Tensor, M: int) -> int:
    return min(int(group_sizes.sum()), M)


def _fwd_flops(lhs, gate_up, down, group_sizes, *args, **kwargs) -> float:
    """The plain forward's work: [n, D] x [D, 2I], then [n, I] x [I, D]."""
    D, I2 = gate_up.shape[1], gate_up.shape[2]
    return 2.0 * _n(group_sizes, lhs.shape[0]) * D * I2 * 1.5


def _bwd_gu_flops(lhs, gu, dmid, group_sizes, *args, **kwargs) -> float:
    return 2.0 * _n(group_sizes, lhs.shape[0]) * lhs.shape[1] * gu.shape[1]


def _bwd_dwd_flops(gu, dy, group_sizes, *args, **kwargs) -> float:
    return 2.0 * _n(group_sizes, gu.shape[0]) * (gu.shape[1] // 2) * dy.shape[1]


def _bwd_dx_flops(gu, dmid, gate_up, group_sizes, *args, **kwargs) -> float:
    return 2.0 * _n(group_sizes, gu.shape[0]) * gu.shape[1] * gate_up.shape[1]


@_cost.counted(_fwd_flops)
def fwd(lhs, gate_up, down, group_sizes, gate_up_bias=None, down_bias=None, act_kind="swiglu", limit=None,
        plan=None) -> torch.Tensor:
    """lhs [M, D] (rows sorted by group), gate_up [G, D, 2I], down [G, I, D],
    optional gate_up_bias [G, 2I] and down_bias [G, D] → out [M, D] in
    lhs.dtype. CUDA tensors launch the two kernels of the forward, the gmm
    kernel with the activation in its epilogue, then with the row bias
    (counted once, in ``fwd.launches``); ``plan`` is ``gmm_plan(group_sizes,
    M)``, built here when not given. CPU tensors run the plain version."""
    _check_act(act_kind, limit)
    M, D = lhs.shape
    G, _, I2 = gate_up.shape
    I = I2 // 2
    if _on_cpu("fused_expert_mlp fwd", lhs):
        return _fwd_plain(lhs, gate_up, down, group_sizes, gate_up_bias, down_bias, act_kind, limit)
    shapes = dict(lhs=(M, D), gate_up=(G, D, 2 * I), down=(G, I, D), gate_up_bias=(G, 2 * I), down_bias=(G, D))
    _check_cuda("fused_expert_mlp fwd", group_sizes, shapes, lhs=lhs, gate_up=gate_up, down=down,
                gate_up_bias=gate_up_bias, down_bias=down_bias)
    _check_dims("fused_expert_mlp fwd", D, I)
    plan = _plan_for(plan, group_sizes, M, "fused_expert_mlp fwd")
    ends = _ends(group_sizes)
    mid = _launch_fwd_gu_act(lhs, gate_up, gate_up_bias, plan, ends, act_kind, limit)
    out = _launch_fwd_down(mid, down, down_bias, plan, ends)
    fwd.launches += 1
    return out


@_cost.counted(_bwd_gu_flops)
def bwd_gu(lhs, gu, dmid, group_sizes, act_kind="swiglu", limit=None, want_bias=False, dgdu=None,
           out_dtype=torch.float32):
    """→ (dW [G, D, 2I] = lhs_g^T [dg | du] summed in fp32 and written in
    ``out_dtype`` (fp32, JAX's ``_bwd_gu``, or bf16, the backward's cast
    taken in the kernel), the gate and up halves of one gradient; dbias
    [G, 2I] fp32, the row sums of the unrounded dg, du, or None). gu
    [M, 2I] is the recomputed g | u (biases added), dmid [M, I]; ``dgdu``
    is ``bwd_act``'s, run here when not given. CUDA tensors launch
    ``bwd_act`` (without ``dgdu``), the tgmm kernel and, with
    ``want_bias``, the bias-grad kernel, counted once in
    ``bwd_gu.launches``; CPU tensors run the plain version."""
    _check_act(act_kind, limit)
    M, D = lhs.shape
    I = dmid.shape[1]
    G = group_sizes.shape[0]
    if _on_cpu("fused_expert_mlp bwd_gu", lhs):
        return _bwd_gu_plain(lhs, gu, dmid, group_sizes, act_kind, limit, want_bias, out_dtype, dgdu)
    _check_cuda("fused_expert_mlp bwd_gu", group_sizes, dict(lhs=(M, D), gu=(M, 2 * I), dmid=(M, I), dgdu=(M, 2 * I)),
                lhs=lhs, gu=gu, dmid=dmid, dgdu=dgdu)
    _check_dims("fused_expert_mlp bwd_gu", D, I)
    if out_dtype not in TGMM_OUT_DTYPES:
        raise ValueError(f"fused_expert_mlp bwd_gu: the CUDA kernel writes {TGMM_OUT_DTYPES}, not {out_dtype}")
    if dgdu is None:
        _, dgdu = bwd_act(gu, dmid, group_sizes, act_kind, limit, want_mid=False)
    dbias = None
    if want_bias:
        dbias = torch.empty((G, 2 * I), dtype=torch.float32, device=lhs.device)
        lib = _lib()
        with torch.cuda.device(lhs.device):
            rc = lib.fused_expert_mlp_bwd_dgub(gu.data_ptr(), dmid.data_ptr(), _ends(group_sizes).data_ptr(),
                                               dbias.data_ptr(), M, I, G, *_act_args(act_kind, limit), _stream(lhs))
        _raise_on(lib, rc, "bwd_dgub")
    dw = gm._tgmm_launch(lhs, dgdu, group_sizes, out_dtype)
    bwd_gu.launches += 1
    return dw, dbias


@_cost.counted(lambda *a, **k: 0.0)  # elementwise: no products
def bwd_act(gu, dmid, group_sizes, act_kind="swiglu", limit=None, want_mid=True, want_dgdu=True):
    """The backward's elementwise pass, once per element → (mid [M, I] or
    None, dgdu [M, 2I] = dg | du or None) in gu.dtype, rows past the groups
    0. gu [M, 2I] is the recomputed g | u (biases added); dmid [M, I] is
    read only for dgdu (may be None without it). CUDA tensors launch the
    kernel (counted in ``bwd_act.launches``); CPU tensors run the plain
    version."""
    _check_act(act_kind, limit)
    if not (want_mid or want_dgdu):
        raise ValueError("fused_expert_mlp bwd_act: want mid, dgdu or both")
    M, I = gu.shape[0], gu.shape[1] // 2
    G = group_sizes.shape[0]
    if _on_cpu("fused_expert_mlp bwd_act", gu):
        return _bwd_act_plain(gu, dmid, group_sizes, act_kind, limit, want_mid, want_dgdu)
    dmid = dmid if want_dgdu else None
    if want_dgdu and dmid is None:
        raise ValueError("fused_expert_mlp bwd_act: dg | du needs dmid")
    _check_cuda("fused_expert_mlp bwd_act", group_sizes, dict(gu=(M, 2 * I), dmid=(M, I)), gu=gu, dmid=dmid)
    _check_dims("fused_expert_mlp bwd_act", ALIGN, I)
    ends = _ends(group_sizes)
    mid = torch.empty((M, I), dtype=gu.dtype, device=gu.device) if want_mid else None
    dgdu = torch.empty((M, 2 * I), dtype=gu.dtype, device=gu.device) if want_dgdu else None
    lib = _lib()
    with torch.cuda.device(gu.device):
        rc = lib.fused_expert_mlp_bwd_act(
            gu.data_ptr(), _ptr(dmid), ends.data_ptr(), _ptr(mid), _ptr(dgdu), M, I, G,
            *_act_args(act_kind, limit), _stream(gu),
        )
    _raise_on(lib, rc, "bwd_act")
    bwd_act.launches += 1
    return mid, dgdu


@_cost.counted(_bwd_dwd_flops)
def bwd_dwd(gu, dy, group_sizes, act_kind="swiglu", limit=None, want_bias=False, out_dtype=torch.float32, mid=None):
    """→ (dWd [G, I, D] = mid_g^T dy_g summed in fp32 and written in
    ``out_dtype`` (fp32, JAX's ``_bwd_dwd``, or bf16, the backward's cast
    taken in the kernel), ddb [G, D] fp32 or None) from the recomputed gu
    [M, 2I] and dy [M, D]; ``mid`` is ``bwd_act``'s, run here when not
    given. CUDA tensors launch ``bwd_act`` (without ``mid``), the ddb
    kernel (with ``want_bias``) and the tgmm kernel, counted once in
    ``bwd_dwd.launches``; CPU tensors run the plain version."""
    _check_act(act_kind, limit)
    M, I = gu.shape[0], gu.shape[1] // 2
    D = dy.shape[1]
    G = group_sizes.shape[0]
    if _on_cpu("fused_expert_mlp bwd_dwd", gu):
        return _bwd_dwd_plain(gu, dy, group_sizes, act_kind, limit, want_bias, out_dtype, mid)
    _check_cuda("fused_expert_mlp bwd_dwd", group_sizes, dict(gu=(M, 2 * I), dy=(M, D), mid=(M, I)),
                gu=gu, dy=dy, mid=mid)
    _check_dims("fused_expert_mlp bwd_dwd", D, I)
    if out_dtype not in TGMM_OUT_DTYPES:
        raise ValueError(f"fused_expert_mlp bwd_dwd: the CUDA kernel writes {TGMM_OUT_DTYPES}, not {out_dtype}")
    if mid is None:
        mid, _ = bwd_act(gu, None, group_sizes, act_kind, limit, want_dgdu=False)
    ddb = None
    if want_bias:
        ddb = torch.empty((G, D), dtype=torch.float32, device=gu.device)
        ends = _ends(group_sizes)
        lib = _lib()
        with torch.cuda.device(gu.device):
            rc = lib.fused_expert_mlp_bwd_ddb(dy.data_ptr(), ends.data_ptr(), ddb.data_ptr(), M, D, G, _stream(dy))
        _raise_on(lib, rc, "bwd_ddb")
    dwd = gm._tgmm_launch(mid, dy, group_sizes, out_dtype)
    bwd_dwd.launches += 1
    return dwd, ddb


@_cost.counted(_bwd_dx_flops)
def bwd_dx(gu, dmid, gate_up, group_sizes, act_kind="swiglu", limit=None, plan=None, dgdu=None) -> torch.Tensor:
    """→ dlhs [M, D] in gu.dtype = dg Wg^T + du Wu^T per row's group, rows
    past the groups 0; ``dgdu`` is ``bwd_act``'s, run here when not given.
    CUDA tensors launch ``bwd_act`` (without ``dgdu``) and the gmm kernel
    over K = 2I with gate_up as the transposed rhs, counted once in
    ``bwd_dx.launches``; CPU tensors run the plain version."""
    _check_act(act_kind, limit)
    M, I = gu.shape[0], gu.shape[1] // 2
    G, D, _ = gate_up.shape
    if _on_cpu("fused_expert_mlp bwd_dx", gu):
        return _bwd_dx_plain(gu, dmid, gate_up, group_sizes, act_kind, limit, dgdu)
    _check_cuda("fused_expert_mlp bwd_dx", group_sizes,
                dict(gu=(M, 2 * I), dmid=(M, I), gate_up=(G, D, 2 * I), dgdu=(M, 2 * I)),
                gu=gu, dmid=dmid, gate_up=gate_up, dgdu=dgdu)
    _check_dims("fused_expert_mlp bwd_dx", D, I)
    plan = _plan_for(plan, group_sizes, M, "fused_expert_mlp bwd_dx")
    if dgdu is None:
        _, dgdu = bwd_act(gu, dmid, group_sizes, act_kind, limit, want_mid=False)
    n_major = bool(gm._lib().grouped_matmul_gmm_n_major(2 * I, D))  # the order gmm would pick
    dlhs = gm._gmm_launch(dgdu, gate_up, group_sizes, plan, D, True, n_major)
    bwd_dx.launches += 1
    return dlhs


fwd.launches = 0
bwd_gu.launches = 0
bwd_act.launches = 0
bwd_dwd.launches = 0
bwd_dx.launches = 0


def add_row_bias(x: torch.Tensor, bias: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x [M, N] + bias[group of the row] in x's dtype; rows past the groups
    get nothing (JAX's :746-759: the gather index clamped, the bias zeroed
    under the mask). The row groups come from a device searchsorted, with
    no host sync."""
    G = bias.shape[0]
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rg = torch.searchsorted(ends, torch.arange(x.shape[0], device=x.device), right=True)
    b = bias.to(x.dtype).index_select(0, rg.clamp_max(G - 1))
    return x + torch.where((rg < G)[:, None], b, torch.zeros((), dtype=x.dtype, device=x.device))


class _FusedExpertMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, gate_up, down, group_sizes, gate_up_bias, down_bias, act_kind, limit, plan):
        ctx.save_for_backward(lhs, gate_up, down, group_sizes, gate_up_bias, down_bias, plan)
        ctx.act = (act_kind, limit)
        return fwd(lhs, gate_up, down, group_sizes, gate_up_bias, down_bias, act_kind, limit, plan=plan)

    @staticmethod
    def backward(ctx, dy):
        lhs, gate_up, down, group_sizes, gub, db, plan = ctx.saved_tensors
        act_kind, limit = ctx.act
        dy = dy.contiguous()
        # K2 for the recompute: one launch over the fused [G, D, 2I] weight
        gu = gmm(lhs, gate_up, group_sizes, plan=plan)
        if gub is not None:
            gu = add_row_bias(gu, gub, group_sizes)
        dmid = gmm(dy, down, group_sizes, transpose_rhs=True, plan=plan)
        # the activation once per element: mid for dWd, dg | du for dlhs
        # and dW, each freed after its last product; both weight grads are
        # written in their primal's dtype by the kernels
        mid, dgdu = bwd_act(gu, dmid, group_sizes, act_kind, limit)
        dwd, ddb = bwd_dwd(gu, dy, group_sizes, act_kind, limit, want_bias=db is not None, out_dtype=down.dtype,
                           mid=mid)
        del mid
        dlhs = bwd_dx(gu, dmid, gate_up, group_sizes, act_kind, limit, plan=plan, dgdu=dgdu)
        dw, dgub = bwd_gu(lhs, gu, dmid, group_sizes, act_kind, limit, want_bias=gub is not None, dgdu=dgdu,
                          out_dtype=gate_up.dtype)
        del dgdu
        return (
            dlhs.to(lhs.dtype), dw, dwd, None,
            None if gub is None else dgub.to(gub.dtype), None if db is None else ddb.to(db.dtype),
            None, None, None,
        )


def fused_expert_mlp(
    lhs: torch.Tensor,
    gate_up: torch.Tensor,
    down: torch.Tensor,
    group_sizes: torch.Tensor,
    gate_up_bias: Optional[torch.Tensor] = None,
    down_bias: Optional[torch.Tensor] = None,
    act_kind: str = "swiglu",
    limit: Optional[float] = None,
    plan: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable fused expert MLP: lhs [M, D] (rows sorted by group) →
    [M, D] in lhs.dtype, all operands in one dtype. ``plan`` as for
    ``grouped_matmul.gmm`` (built once here on CUDA when not given, and
    shared by the forward's and the backward's kernels)."""
    _check_act(act_kind, limit)
    if plan is None and lhs.device.type == "cuda":
        plan = gmm_plan(group_sizes, lhs.shape[0])
    c = lambda t: None if t is None else t.contiguous()
    return _FusedExpertMLP.apply(
        lhs.contiguous(), gate_up.contiguous(), down.contiguous(), group_sizes, c(gate_up_bias), c(down_bias),
        act_kind, limit, plan,
    )
