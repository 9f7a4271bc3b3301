"""Cost-attributed program accounting, port of
``automodel_tpu/telemetry/profiling/cost.py``: measured FLOPs/bytes of one
real step, category breakdown, roofline classification, measured MFU.

JAX walks the step's jaxpr. The port counts one real step as it runs
(``count_cost``): a ``TorchDispatchMode`` sees every aten op the step
dispatches, forward, backward (autograd's device threads carry the mode)
and optimizer alike, and charges

- matmuls and convolutions their FLOPs by ``torch.utils.flop_counter``'s
  formulas (``dot_flops`` / ``conv_flops``) and their operand + result
  bytes;
- ``torch.distributed`` collectives their result bytes
  (``collective_bytes``);
- every other op its result bytes (``elementwise_bytes``).

The hand-written kernels K1-K4 launch through ``ctypes``, where no
dispatch mode can see them. Each wrapper is therefore decorated with
``counted``: while a counter is active it adds the work its plain torch
version does at the same shapes (the ``ops/`` modules give the formula)
and hides the plain version's own ops when it runs it (a CPU tensor), so
a step reads the same work whatever implements it. For K1 that is the
plain attention's full rectangle: 4·B·N·Sq·Sk·H for the forward (QKᵀ and
PV, as ``sdpa``'s two products and the plain forward count), and the
gradient products its backward takes, split dP and dQ to the dq kernel
and dV and dK to the dkv kernel (4·B·N·Sq·Sk·H each). The kernels' own
recompute of P is not counted, so ``attn: flash`` and ``attn: sdpa`` give
the same ``flops``, as JAX's walker does on the CPU (where its flash falls
back to sdpa).

``hlo_flops`` / ``hlo_bytes`` (XLA's cost analysis) have no counterpart
and stay absent. ``mfu_measured_pct`` = FLOPs / step time / (devices ×
peak); the roofline basis is the device table's peak (utils/flops_utils.py,
989 TFLOP/s dense bf16 for ``NVIDIA H100 80GB HBM3``) and its HBM rate
(3350 GB/s, the figure the kernel bounds in PERF.md use), overridable by
``profiling.peak_tflops`` / ``profiling.hbm_gbps``; unknown devices (the
CPU) classify as ``unknown``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from automodel_tpu_torch.utils.flops_utils import device_peak_tflops

logger = logging.getLogger(__name__)

# HBM bandwidth per card, GB/s; unknown kinds → NaN, never a silent wrong basis
GPU_HBM_GBPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

# composite ops holding products, decomposed when they reach the counter whole
_COMPOSITE_PRODUCTS = ("linear", "matmul", "einsum", "bilinear", "tensordot")
_COLLECTIVE_WORDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast", "allreduce")
_CONV = ("convolution", "_convolution", "cudnn_convolution", "convolution_backward", "_slow_conv2d_forward",
         "convolution_overrideable")


def device_hbm_gbps(device: Any = None) -> float:
    if not torch.cuda.is_available():
        return float("nan")
    return GPU_HBM_GBPS.get(torch.cuda.get_device_name(device), float("nan"))


@dataclasses.dataclass
class ProgramCost:
    """Measured cost of one step (JAX's fields)."""

    program: str = "program"
    flops: float = 0.0  # dot + conv
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    bytes_est: float = 0.0  # every op's result bytes, matmuls' operands too
    elementwise_bytes: float = 0.0  # non-matmul, non-collective result bytes
    collective_bytes: float = 0.0
    collective_ops: int = 0
    dot_ops: int = 0
    eqns: int = 0  # aten ops dispatched (a kernel launch counts one)
    while_loops: int = 0  # no counterpart: a real step runs its loops
    hlo_flops: Optional[float] = None
    hlo_bytes: Optional[float] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


def _nbytes(x: Any) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0.0


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while active into ``cost``."""

    def __init__(self, program: str = "program"):
        super().__init__()
        self.cost = ProgramCost(program=program)
        self.suppressed = 0  # > 0 inside a counted kernel wrapper
        self.errors = 0  # ops whose count failed (the op itself ran)
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if not self.suppressed and packet.__name__ in _COMPOSITE_PRODUCTS and torch.is_inference_mode_enabled():
            # a composite op dispatched whole (inference mode skips the
            # autograd key that decomposes it): count its pieces. Only these,
            # and only there: decomposing an op that has a kernel of its own
            # (silu_backward) would change the step's rounding
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not self.suppressed:
            try:
                self._count(packet, args, kwargs, out)
            except Exception as e:  # the count is never load-bearing for the step
                if not self.errors:
                    logger.warning("cost count of %s failed (%s): the count misses it", packet, e)
                self.errors += 1
        return out

    def _count(self, packet, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        c = self.cost
        c.eqns += 1
        name = packet.__name__
        out_b = _nbytes(out)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            if name in _CONV:
                c.conv_flops += f
            else:
                c.dot_flops += f
                c.dot_ops += 1
            c.flops += f
            c.bytes_est += _nbytes(args) + out_b
        elif any(w in name for w in _COLLECTIVE_WORDS):
            c.collective_bytes += out_b
            c.collective_ops += 1
            c.bytes_est += out_b
        else:
            c.elementwise_bytes += out_b
            c.bytes_est += out_b

    def add_kernel(self, flops: float, nbytes: float) -> None:
        c = self.cost
        c.eqns += 1
        c.dot_ops += 1
        c.dot_flops += flops
        c.flops += flops
        c.bytes_est += nbytes

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None and _ACTIVE is not self:
            raise RuntimeError("a cost counter is already active")
        _ACTIVE = self
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        self._depth -= 1
        if not self._depth:
            _ACTIVE = None
        return super().__exit__(*exc)


_ACTIVE: Optional[CostCounter] = None


def counted(flops_fn: Callable[..., float]) -> Callable:
    """Decorate a kernel wrapper: while a counter is active, add
    ``flops_fn(*args, **kwargs)`` and the bytes of its tensor arguments and
    results, and hide the ops its plain version dispatches. Inactive, one
    None check."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            c = _ACTIVE
            if c is None or c.suppressed:  # inactive, or inside a counted wrapper
                return fn(*args, **kwargs)
            c.suppressed += 1
            try:
                out = fn(*args, **kwargs)
                flops = float(flops_fn(*args, **kwargs))
            finally:
                c.suppressed -= 1
            c.add_kernel(flops, _nbytes(args) + _nbytes(kwargs) + _nbytes(out))
            return out

        return wrapped

    return deco


def count_cost(fn: Callable, *args, program: str = "program", **kwargs) -> tuple[Any, ProgramCost]:
    """Run ``fn(*args, **kwargs)`` once under a counter → (its result, cost)."""
    with CostCounter(program) as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost


# -- roofline + MFU ------------------------------------------------------------


@dataclasses.dataclass
class RooflineConfig:
    """Device basis, overridable from YAML (``profiling.peak_tflops`` /
    ``profiling.hbm_gbps``) — mandatory on the CPU if a classification is
    wanted (the tables return NaN there)."""

    peak_tflops: Optional[float] = None
    hbm_gbps: Optional[float] = None

    def resolve(self) -> tuple[float, float]:
        peak = float(self.peak_tflops) if self.peak_tflops is not None else device_peak_tflops()
        bw = float(self.hbm_gbps) if self.hbm_gbps is not None else device_hbm_gbps()
        return peak, bw


def roofline(cost: ProgramCost, basis: RooflineConfig) -> dict:
    """→ {arithmetic_intensity, ridge_intensity, roofline_class,
    comm_fraction}, JAX's classification. The byte estimate ignores what a
    fused kernel keeps on chip, so the intensity is a lower bound: a
    ``memory_bound`` verdict is conservative, ``compute_bound`` is solid."""
    peak, bw = basis.resolve()
    bytes_basis = cost.bytes_est if cost.bytes_est else cost.hlo_bytes
    intensity = cost.flops / bytes_basis if bytes_basis else float("nan")
    ridge = (peak * 1e12) / (bw * 1e9) if (peak == peak and bw == bw) else float("nan")
    comm_fraction = cost.collective_bytes / cost.bytes_est if cost.bytes_est else 0.0
    if intensity != intensity or ridge != ridge:
        klass = "unknown"
    elif comm_fraction > 0.5:
        klass = "comm_heavy"
    elif intensity >= ridge:
        klass = "compute_bound"
    else:
        klass = "memory_bound"
    return {
        "arithmetic_intensity": round(intensity, 3) if intensity == intensity else None,
        "ridge_intensity": round(ridge, 3) if ridge == ridge else None,
        "roofline_class": klass,
        "comm_fraction": round(comm_fraction, 4),
    }


def mfu_measured_pct(flops_per_step: float, step_time_s: float, n_chips: int, basis: RooflineConfig) -> Optional[float]:
    """Measured-step MFU %. None when the peak basis is unknown (the CPU
    without an override) or the step time is degenerate."""
    peak, _ = basis.resolve()
    if peak != peak or step_time_s <= 0 or n_chips < 1:
        return None
    return 100.0 * flops_per_step / step_time_s / (n_chips * peak * 1e12)


__all__ = [
    "CostCounter",
    "GPU_HBM_GBPS",
    "ProgramCost",
    "RooflineConfig",
    "count_cost",
    "counted",
    "device_hbm_gbps",
    "mfu_measured_pct",
    "roofline",
]
