"""Grouped matmul for the MoE experts: ``gmm`` (optionally with a
transposed rhs), ``tgmm`` and the differentiable ``ragged_dot``.

Port of ``automodel_tpu/ops/grouped_matmul.py``. ``gmm`` and ``tgmm`` wrap
the hand-written Hopper kernels of ``csrc/grouped_matmul.cu`` (which
replace the Pallas ``_gmm_kernel`` and ``_tgmm_kernel``): given CUDA
tensors they launch the kernel or raise, given CPU tensors they run
``_gmm_plain`` / ``_tgmm_plain``, the same functions in fp32 torch with a
loop over groups. There is no path from a CUDA tensor to a plain version or
to a library grouped GEMM.

``lhs`` rows are sorted by group: group g owns rows ``[start_g, end_g)``
of the cumsum of ``group_sizes`` (int32, on lhs's device). Rows at or past
``sum(group_sizes)`` come out of ``gmm`` as zeros; the TPU kernel leaves
them uninitialised.

The gmm kernel walks work units, one per (group, 128-row tile) pair that
overlaps, plus the tail past the last group, each against every n tile, on
a persistent grid in the units' order. ``gmm_plan`` builds that list on the
device with torch ops (cumsum, searchsorted), with no host sync, as the JAX
``_plan`` (:70) does; a caller that runs several products over the same
groups (the MoE layer: two forward and two backward gmms) builds it once
and passes it on. The tgmm kernel walks (group, k tile, n tile) items with
the groups largest first, in the order ``tgmm_group_order`` sorts on the
device. The same gmm kernel with two other epilogues carries the fused
expert MLP's forward (``grouped_matmul_gmm_act``, the gate_up product with
the activation, and ``grouped_matmul_gmm_bias``, the down product with a
row bias), which ``ops/fused_expert_mlp.py`` launches through ``_lib()``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from automodel_tpu_torch.telemetry.profiling import cost as _cost

# the CUDA kernels' limits (csrc/grouped_matmul.cu)
CUDA_DTYPES = (torch.bfloat16,)
GMM_TILE_M = 128
ALIGN = 8  # K and N in multiples of 8 elements (TMA's 16-byte global strides)
TGMM_OUT_DTYPES = (torch.float32, torch.bfloat16)


# -- the work-unit plan -------------------------------------------------------------


def gmm_plan(group_sizes: torch.Tensor, m: int, tm: int = GMM_TILE_M) -> torch.Tensor:
    """int32 [4, W] on group_sizes' device, W = ceil(m / tm) + G + 1: for
    each unit its group (G = the tail past sum(group_sizes), written as
    zeros), its m tile and its row window [first, end) inside that tile.
    Units past the last one have an empty window."""
    dev = group_sizes.device
    gs = group_sizes.to(torch.int64)
    G = gs.shape[0]
    tail = (m - gs.sum()).clamp_min(0).reshape(1)
    ends = torch.cumsum(torch.cat([gs, tail]), 0).clamp_max(m)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    first = starts // tm
    last = torch.maximum(ends - 1, starts) // tm
    ntiles = torch.where(ends > starts, last - first + 1, torch.zeros_like(first))
    wstart = torch.cumsum(ntiles, 0) - ntiles
    total = ntiles.sum()
    W = -(-m // tm) + G + 1
    i = torch.arange(W, device=dev)
    valid = i < total
    j = torch.minimum(i, (total - 1).clamp_min(0))
    # last group whose first unit is <= j: runs of equal wstart (empty
    # groups) resolve to the run's last member, the non-empty one
    g = torch.searchsorted(wstart, j, right=True) - 1
    tile = first[g] + (j - wstart[g])
    row_s = torch.where(valid, torch.maximum(starts[g], tile * tm), torch.zeros_like(j))
    row_e = torch.where(valid, torch.minimum(ends[g], tile * tm + tm), torch.zeros_like(j))
    return torch.stack([g, tile, row_s, row_e]).to(torch.int32).contiguous()


def tgmm_group_order(group_sizes: torch.Tensor) -> torch.Tensor:
    """int32 [G] on group_sizes' device: every group once, the largest
    first (ties in index order), the order in which the tgmm kernel takes
    the groups' items, so that the longest contractions start first."""
    return torch.argsort(group_sizes, descending=True, stable=True).to(torch.int32)


# -- plain versions -----------------------------------------------------------------


def _bounds(group_sizes: torch.Tensor, m: int) -> list[tuple[int, int]]:
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).clamp_max(m).tolist()
    starts = [0] + ends[:-1]
    return list(zip(starts, ends))


def _gmm_plain(lhs, rhs, group_sizes, transpose_rhs: bool = False) -> torch.Tensor:
    """gmm in fp32 torch, one matmul per group → [M, N] in lhs.dtype, rows
    past sum(group_sizes) zero."""
    M = lhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((M, N), dtype=torch.float32, device=lhs.device)
    for g, (s, e) in enumerate(_bounds(group_sizes, M)):
        if e > s:
            w = rhs[g].float()
            out[s:e] = lhs[s:e].float() @ (w.t() if transpose_rhs else w)
    return out.to(lhs.dtype)


def _tgmm_plain(lhs, dout, group_sizes, out_dtype=torch.float32) -> torch.Tensor:
    """tgmm in fp32 torch: [G, K, N], lhs_g^T @ dout_g summed in fp32 and
    cast once to ``out_dtype``, zeros for an empty group."""
    M, K = lhs.shape
    out = torch.zeros((group_sizes.shape[0], K, dout.shape[1]), dtype=torch.float32, device=lhs.device)
    for g, (s, e) in enumerate(_bounds(group_sizes, M)):
        if e > s:
            out[g] = lhs[s:e].float().t() @ dout[s:e].float()
    return out.to(out_dtype)


# -- the CUDA kernels ---------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from automodel_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("grouped_matmul")
    if not hasattr(lib, "_gmm_bound"):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_matmul_gmm.argtypes = [p] * 5 + [i] * 7 + [p]  # ..., M, K, N, G, W, transpose, n_major, stream
        lib.grouped_matmul_tgmm.argtypes = [p] * 5 + [i] * 5 + [p]  # ..., M, K, N, G, out_bf16, stream
        # the fused expert MLP's forward (ops/fused_expert_mlp.py launches them):
        # ..., M, D, I, G, W, n_major, act_kind, limit, stream and ..., M, K, N, G, W, n_major, stream
        lib.grouped_matmul_gmm_act.argtypes = [p] * 6 + [i] * 7 + [ctypes.c_float, p]
        lib.grouped_matmul_gmm_bias.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.grouped_matmul_gmm_act.restype = i
        lib.grouped_matmul_gmm_bias.restype = i
        lib.grouped_matmul_gmm.restype = i
        lib.grouped_matmul_gmm_n_major.argtypes = [i, i]  # K, N -> 1: a group's items n tile by n tile
        lib.grouped_matmul_gmm_n_major.restype = i
        lib.grouped_matmul_tgmm.restype = i
        lib.grouped_matmul_error_string.argtypes = [i]
        lib.grouped_matmul_error_string.restype = ctypes.c_char_p
        lib._gmm_bound = True
    return lib


def _device_kind(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def _check_cuda(name: str, group_sizes: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise ValueError on what the kernels do not take."""
    first = next(iter(tensors.values()))
    for t_name, t in tensors.items():
        if t.dtype not in CUDA_DTYPES:
            raise ValueError(f"{name}: the CUDA kernel takes {CUDA_DTYPES} operands, {t_name} is {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must start on a 16-byte boundary (TMA)")
        if t.shape[-1] % ALIGN:
            raise ValueError(f"{name}: {t_name}'s last dim {t.shape[-1]} must be a multiple of {ALIGN}")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1 or group_sizes.device != first.device:
        raise ValueError(f"{name}: group_sizes must be int32 [G] on {first.device}")


def _raise_on(lib, rc: int, which: str) -> None:
    if rc != 0:
        msg = lib.grouped_matmul_error_string(rc).decode()
        raise RuntimeError(f"grouped_matmul_{which} kernel launch failed ({rc}): {msg}")


# -- the wrappers -------------------------------------------------------------------



def _rows(group_sizes: torch.Tensor, m: int) -> int:
    """Rows the groups cover (a host read of the sizes)."""
    return min(int(group_sizes.sum()), m)


def _gmm_flops(lhs, rhs, group_sizes, transpose_rhs=False, plan=None) -> float:
    """The plain version's work: one [rows_g, K] x [K, N] product a group."""
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    return 2.0 * _rows(group_sizes, lhs.shape[0]) * lhs.shape[1] * N


def _tgmm_flops(lhs, dout, group_sizes, out_dtype=None) -> float:
    return 2.0 * _rows(group_sizes, lhs.shape[0]) * lhs.shape[1] * dout.shape[1]


@_cost.counted(_gmm_flops)
def gmm(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_sizes: torch.Tensor,
    transpose_rhs: bool = False,
    plan: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """lhs [M, K] (rows sorted by group) @ rhs [G, K, N] → [M, N] in
    lhs.dtype; under ``transpose_rhs`` rhs is [G, N, K], read in place.
    CUDA tensors launch the kernel (counted in ``gmm.launches``, or
    ``gmm.launches_t`` with a transposed rhs); ``plan`` is
    ``gmm_plan(group_sizes, M)``, built here when not given. CPU tensors
    run the plain version."""
    M, K = lhs.shape
    G = rhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    if (rhs.shape[2] if transpose_rhs else rhs.shape[1]) != K or group_sizes.shape != (G,):
        raise ValueError(
            f"gmm: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} (transpose_rhs={transpose_rhs}) and "
            f"group_sizes {tuple(group_sizes.shape)} do not match"
        )
    if _device_kind("gmm", lhs) == "cpu":
        return _gmm_plain(lhs, rhs, group_sizes, transpose_rhs)
    _check_cuda("gmm", group_sizes, lhs=lhs, rhs=rhs)
    if rhs.dtype != lhs.dtype:
        raise ValueError(f"gmm: rhs is {rhs.dtype}, lhs is {lhs.dtype}")
    if K % ALIGN or N % ALIGN:  # under transpose_rhs N is rhs's middle dim
        raise ValueError(f"gmm: K={K} and N={N} must be multiples of {ALIGN}")
    if plan is None:
        plan = gmm_plan(group_sizes, M)
    W = -(-M // GMM_TILE_M) + G + 1
    if plan.dtype != torch.int32 or tuple(plan.shape) != (4, W) or plan.device != lhs.device:
        raise ValueError(f"gmm: plan must be int32 [4, {W}] on {lhs.device} (gmm_plan(group_sizes, {M}))")
    out = _gmm_launch(lhs, rhs, group_sizes, plan, N, transpose_rhs, bool(_lib().grouped_matmul_gmm_n_major(K, N)))
    if transpose_rhs:
        gmm.launches_t += 1
    else:
        gmm.launches += 1
    return out


def _gmm_launch(lhs, rhs, group_sizes, plan, N: int, transpose_rhs: bool, n_major: bool) -> torch.Tensor:
    """One launch of the gmm kernel on checked operands, a group's items
    n tile by n tile under ``n_major``, else unit by unit. ``gmm`` takes
    ``grouped_matmul_gmm_n_major(K, N)``; the tests and chip_smoke.py call
    this to time or check the other order."""
    M, K = lhs.shape
    G, W = rhs.shape[0], plan.shape[1]
    # the groups' ends: only the order n tile by n tile reads them
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32) if n_major else None
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    lib = _lib()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        rc = lib.grouped_matmul_gmm(
            lhs.data_ptr(), rhs.data_ptr(), plan.data_ptr(), None if ends is None else ends.data_ptr(),
            out.data_ptr(), M, K, N, G, W, int(bool(transpose_rhs)), int(n_major), stream,
        )
    _raise_on(lib, rc, "gmm")
    return out


@_cost.counted(_tgmm_flops)
def tgmm(
    lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Per group lhs_g^T @ dout_g: lhs [M, K] x dout [M, N] → [G, K, N],
    summed in fp32 and written in ``out_dtype`` (fp32, JAX's ``_tgmm``, or
    bf16, the backward's cast taken in the kernel), zeros for an empty
    group. CUDA tensors launch the kernel (counted in ``tgmm.launches``);
    CPU tensors run the plain version."""
    M, K = lhs.shape
    if dout.dim() != 2 or dout.shape[0] != M or group_sizes.dim() != 1:
        raise ValueError(f"tgmm: lhs {tuple(lhs.shape)} and dout {tuple(dout.shape)} do not match")
    if _device_kind("tgmm", lhs) == "cpu":
        return _tgmm_plain(lhs, dout, group_sizes, out_dtype)
    _check_cuda("tgmm", group_sizes, lhs=lhs, dout=dout)
    if out_dtype not in TGMM_OUT_DTYPES:
        raise ValueError(f"tgmm: the CUDA kernel writes {TGMM_OUT_DTYPES}, not {out_dtype}")
    out = _tgmm_launch(lhs, dout, group_sizes, out_dtype)
    tgmm.launches += 1
    return out


def _tgmm_launch(lhs, dout, group_sizes, out_dtype) -> torch.Tensor:
    """One launch of the tgmm kernel on checked operands (``tgmm`` counts
    its own; the fused expert MLP's dWd counts its own)."""
    M, K = lhs.shape
    G, N = group_sizes.shape[0], dout.shape[1]
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    order = tgmm_group_order(group_sizes)
    out = torch.empty((G, K, N), dtype=out_dtype, device=lhs.device)
    lib = _lib()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        rc = lib.grouped_matmul_tgmm(lhs.data_ptr(), dout.data_ptr(), ends.data_ptr(), order.data_ptr(),
                                     out.data_ptr(), M, K, N, G, int(out_dtype == torch.bfloat16), stream)
    _raise_on(lib, rc, "tgmm")
    return out


gmm.launches = 0
gmm.launches_t = 0
tgmm.launches = 0


class _RaggedDot(torch.autograd.Function):
    """The JAX custom VJP (:318-333): dlhs = gmm(dout, rhs) against the
    opposite axis of rhs, drhs = tgmm(lhs, dout) (or tgmm(dout, lhs) under
    transpose_rhs), both cast to their primal's dtype (drhs's cast inside
    tgmm: the fp32 sum rounded once)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, transpose_rhs, plan):
        ctx.save_for_backward(lhs, rhs, group_sizes, plan)
        ctx.transpose_rhs = transpose_rhs
        return gmm(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs, plan=plan)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes, plan = ctx.saved_tensors
        t = ctx.transpose_rhs
        dout = dout.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(dout, rhs, group_sizes, transpose_rhs=not t, plan=plan).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(dout, lhs, group_sizes, rhs.dtype) if t else tgmm(lhs, dout, group_sizes, rhs.dtype)
        return dlhs, drhs, None, None, None


def ragged_dot(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_sizes: torch.Tensor,
    *,
    transpose_rhs: bool = False,
    plan: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable ``gmm``: the port of the JAX ``ragged_dot`` with its
    custom VJP, the kernels on CUDA tensors and their plain versions on
    CPU tensors. ``plan`` as for ``gmm`` (built once here when not given,
    and reused by the backward's gmm)."""
    if plan is None and lhs.device.type == "cuda":
        plan = gmm_plan(group_sizes, lhs.shape[0])
    return _RaggedDot.apply(lhs.contiguous(), rhs.contiguous(), group_sizes, transpose_rhs, plan)
