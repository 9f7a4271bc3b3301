"""Device mesh and distributed context, port of ``automodel_tpu/parallel/mesh.py``.

The canonical axis names, the degrees with ``dp_shard: -1`` inferred from
the world size, the logical axis groupings and ``resolve`` are JAX's. The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group, one process a device, in JAX's axis order ``(pp, dp_replicate,
dp_shard, ep, cp, tp)`` (``tp`` innermost: on one host its ranks are the
neighbours of the NVLink domain). The groupings JAX expresses as tuples of
mesh axes inside a PartitionSpec are flattened sub-meshes here:

- ``fsdp`` (``dp_shard, ep, cp``): the dim FSDP2 shards parameters over;
- ``loss_dp`` (``dp_replicate, dp_shard, ep, cp``): the group the token
  count and the loss sum are all-reduced over;
- ``batch`` (``dp_replicate, dp_shard, ep``): a rank's batch rows;
- ``expert_fsdp`` (``dp_shard, cp``).

``MeshContext`` holds the degrees and, once built over a process group,
the device mesh; ``size``, ``dp_size``, ``resolve`` and the other sizes
need no process group, so the rules can be read (and tested) anywhere.

``initialize_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) where
JAX reads its ``JAX_*`` variables; without it a run is one process and the
group is made over a free localhost port. CUDA runs take NCCL with the
device ``LOCAL_RANK``, ``device: cpu`` runs take gloo; a failed NCCL init
raises, with no fall back to gloo or to one process.

Refused by name: ``pp > 1`` (the pipeline schedules). ``ep > 1`` splits
the MoE families' experts over the ``ep`` ranks, which exchange their
tokens, ``tp > 1`` their intermediate dim, and FSDP2 shards them over
``expert_fsdp`` (``parallel/plans.parallelize``). ``hybrid_mesh_shapes`` computes
the nodes x local-devices split JAX lays over DCN, here the split HSDP
takes across hosts.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import socket
from datetime import timedelta
from typing import Any, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


class MeshAxisName:
    """Canonical mesh axis names (JAX :43-53)."""

    PP = "pp"
    DP_REPLICATE = "dp_replicate"
    DP_SHARD = "dp_shard"
    EP = "ep"
    CP = "cp"
    TP = "tp"

    ALL = (PP, DP_REPLICATE, DP_SHARD, EP, CP, TP)


# Logical axis → physical mesh axes (JAX :56-80, copied).
LOGICAL_AXIS_RULES: dict[Optional[str], tuple[str, ...]] = {
    "batch": (MeshAxisName.DP_REPLICATE, MeshAxisName.DP_SHARD, MeshAxisName.EP),
    "fsdp": (MeshAxisName.DP_SHARD, MeshAxisName.EP, MeshAxisName.CP),
    "loss_dp": (MeshAxisName.DP_REPLICATE, MeshAxisName.DP_SHARD, MeshAxisName.EP, MeshAxisName.CP),
    "seq": (MeshAxisName.CP,),
    "tensor": (MeshAxisName.TP,),
    "expert": (MeshAxisName.EP,),
    "expert_fsdp": (MeshAxisName.DP_SHARD, MeshAxisName.CP),
    "expert_batch": (MeshAxisName.DP_REPLICATE, MeshAxisName.DP_SHARD),
    "stage": (MeshAxisName.PP,),
    "vocab": (MeshAxisName.TP,),
    None: (),
}

# the groupings made flattened sub-meshes of the device mesh
FLAT_GROUPS = ("fsdp", "loss_dp", "batch", "expert_fsdp")


@dataclasses.dataclass
class MeshConfig:
    """Parallelism degrees; -1 for ``dp_shard`` means infer from the world
    size (JAX :83-137). ``dcn`` gives per-axis degrees laid across hosts
    (``hybrid_mesh_shapes``). ``pp_schedule`` and ``pp_zb_queue`` are
    validated as JAX validates them; ``pp > 1`` itself is refused when a
    mesh is built. ``ep`` divides ``dp_shard``: the expert ranks are data
    ranks too, as in JAX."""

    dp_replicate: int = 1
    dp_shard: int = -1  # total data-shard degree INCLUDING ep (dp_shard_total)
    tp: int = 1
    cp: int = 1
    pp: int = 1
    ep: int = 1
    dcn: Optional[dict] = None
    pp_schedule: str = "gpipe"
    pp_zb_queue: Optional[int] = None

    def validate(self, world_size: int) -> "MeshConfig":
        cfg = dataclasses.replace(self)
        known = cfg.dp_replicate * cfg.tp * cfg.cp * cfg.pp
        if cfg.dp_shard == -1:
            if world_size % known != 0:
                raise ValueError(f"world_size {world_size} not divisible by dp_replicate*tp*cp*pp={known}")
            cfg.dp_shard = world_size // known
        total = known * cfg.dp_shard
        if total != world_size:
            raise ValueError(f"Mesh degrees {cfg} product {total} != world size {world_size}")
        if cfg.ep < 1 or cfg.dp_shard % cfg.ep != 0:
            raise ValueError(
                f"distributed.ep={cfg.ep}: ep={cfg.ep} must divide dp_shard_total={cfg.dp_shard} "
                f"(reference invariant ep_shard = dp*cp/ep, mesh_utils.py:179-187)"
            )
        if cfg.pp_schedule not in ("gpipe", "zero_bubble"):
            raise ValueError(f"pp_schedule={cfg.pp_schedule!r} must be gpipe|zero_bubble")
        if cfg.pp_zb_queue is not None and cfg.pp_zb_queue < 1:
            raise ValueError(f"pp_zb_queue={cfg.pp_zb_queue} must be >= 1")
        return cfg

    def check_ported(self) -> None:
        """Raise naming a degree this port does not run yet."""
        if self.pp > 1:
            raise ValueError(
                f"distributed.pp={self.pp}: pipeline parallelism (parallel/pp.py, zero_bubble.py) is not "
                "ported to the torch backend yet"
            )

    @classmethod
    def from_section(cls, section: Optional[dict]) -> "MeshConfig":
        """The recipe's ``distributed:`` section (JAX's recipe :82-92: every
        degree 1 but ``dp_shard``, which defaults to -1). An unknown key
        raises naming it."""
        d = dict(section or {})
        d.pop("platform", None)  # JAX's CPU-device pin; the config's device decides here
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"distributed keys {unknown} are unknown (it takes {sorted(known)})")
        return cls(**{k: v for k, v in d.items() if v is not None})


class MeshContext:
    """The degrees, the logical-axis rules and (once ``build_mesh`` ran
    over a process group) the device mesh with its flattened groupings."""

    def __init__(self, config: MeshConfig, device_mesh: Any = None):
        self.config = config
        self.rules = dict(LOGICAL_AXIS_RULES)
        self.mesh = device_mesh
        self.flat: dict[str, Any] = {}  # the flattened groupings' meshes
        self.shape = {
            MeshAxisName.PP: config.pp,
            MeshAxisName.DP_REPLICATE: config.dp_replicate,
            MeshAxisName.DP_SHARD: config.dp_shard // config.ep,
            MeshAxisName.EP: config.ep,
            MeshAxisName.CP: config.cp,
            MeshAxisName.TP: config.tp,
        }

    @classmethod
    def from_degrees(cls, world_size: int, config: Optional[MeshConfig] = None, **degrees: int) -> "MeshContext":
        """The logical context for ``world_size`` devices, without a
        process group (the rules, the sizes and ``resolve``)."""
        return cls((config or MeshConfig(**degrees)).validate(world_size))

    # -- sizes --------------------------------------------------------------
    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group_size(self, logical: str) -> int:
        """Devices in a logical grouping (``fsdp``, ``loss_dp``, ...)."""
        return math.prod(self.shape[a] for a in self.rules[logical])

    @property
    def dp_size(self) -> int:
        return self.size(MeshAxisName.DP_REPLICATE) * self.size(MeshAxisName.DP_SHARD) * self.size(MeshAxisName.EP)

    @property
    def dp_cp_size(self) -> int:
        return self.dp_size * self.size(MeshAxisName.CP)

    @property
    def tp_size(self) -> int:
        return self.size(MeshAxisName.TP)

    @property
    def cp_size(self) -> int:
        return self.size(MeshAxisName.CP)

    @property
    def pp_size(self) -> int:
        return self.size(MeshAxisName.PP)

    @property
    def ep_size(self) -> int:
        return self.size(MeshAxisName.EP)

    # -- the rules ----------------------------------------------------------
    def resolve(self, logical: Sequence[Any] | None) -> tuple:
        """A logical spec (logical axis names / None / tuples of them, one
        per tensor dim) → the mesh axes of each dim, size-1 axes dropped
        and trailing unsharded dims removed: JAX's PartitionSpec contents
        (:196-219) as a tuple."""
        if logical is None:
            return ()
        phys: list[Any] = []
        for dim in logical:
            names: list[str] = []
            for lg in (dim if isinstance(dim, (tuple, list)) else (dim,)):
                if lg is None:
                    continue
                names.extend(ax for ax in self.rules[lg] if self.shape[ax] > 1)
            phys.append(None if not names else names[0] if len(names) == 1 else tuple(names))
        while phys and phys[-1] is None:
            phys.pop()
        return tuple(phys)

    # -- the device mesh ----------------------------------------------------
    def _need_mesh(self) -> Any:
        if self.mesh is None:
            raise RuntimeError("this MeshContext has no device mesh: build it with parallel.build_mesh")
        return self.mesh

    def submesh(self, logical: str) -> Any:
        """The device (sub-)mesh of a mesh axis or a flattened grouping."""
        mesh = self._need_mesh()
        return self.flat[logical] if logical in self.flat else mesh[logical]

    def group(self, logical: str):
        """The process group of a mesh axis or a flattened grouping."""
        return self.submesh(logical).get_group()

    def coordinate(self, logical: str) -> int:
        """This rank's index in a mesh axis or a flattened grouping."""
        return self.submesh(logical).get_local_rank()

    @property
    def rank(self) -> int:
        return self._need_mesh().get_rank()

    @property
    def device_type(self) -> str:
        return self._need_mesh().device_type

    def fsdp_mesh(self) -> Any:
        """The mesh FSDP2 shards over: ``fsdp``, or (``dp_replicate``,
        ``fsdp``) for HSDP."""
        if self.size(MeshAxisName.DP_REPLICATE) > 1:
            return self._need_mesh()[(MeshAxisName.DP_REPLICATE, "fsdp")]
        return self.submesh("fsdp")

    def expert_fsdp_mesh(self) -> Any:
        """The mesh FSDP2 shards the MoE layers' expert slabs over:
        ``expert_fsdp`` (``dp_shard, cp``: the ranks that hold the same
        experts, as the reference's separate MoE mesh groups them,
        ``mesh_utils.py:302-334``), or (``dp_replicate``, ``expert_fsdp``)
        for HSDP. The slabs' own mesh is (``ep``, ``tp``)."""
        if self.size(MeshAxisName.DP_REPLICATE) > 1:
            return self._need_mesh()[(MeshAxisName.DP_REPLICATE, "expert_fsdp")]
        return self.submesh("expert_fsdp")

    def __repr__(self) -> str:
        return f"MeshContext(shape={self.shape})"


def hybrid_mesh_shapes(config: MeshConfig, world_size: int, n_slices: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Split the mesh shape into (per-host shape, across-host shape) for
    ``n_slices`` hosts (JAX :230-283: DCN granules there, nodes here).
    ``config.dcn`` gives per-axis across-host degrees; by default the outer
    axes (pp, dp_replicate, dp_shard) are laid across hosts in order, and
    tp / cp / ep never are."""
    cfg = config.validate(world_size)
    axes = {
        "pp": cfg.pp,
        "dp_replicate": cfg.dp_replicate,
        "dp_shard": cfg.dp_shard // cfg.ep,
        "ep": cfg.ep,
        "cp": cfg.cp,
        "tp": cfg.tp,
    }
    dcn = dict(cfg.dcn or {})
    if dcn:
        unknown = set(dcn) - set(axes)
        if unknown:
            raise ValueError(f"dcn axes {sorted(unknown)} not mesh axes {list(axes)}")
        prod = int(np.prod(list(dcn.values())))
        if prod != n_slices:
            raise ValueError(f"dcn degrees {dcn} product {prod} != DCN granule (slice) count {n_slices}")
        for a, d in dcn.items():
            if d < 1 or axes[a] % d:
                raise ValueError(f"dcn[{a}]={d} must divide axis degree {axes[a]}")
    else:
        rem = n_slices
        for a in ("pp", "dp_replicate", "dp_shard"):
            g = math.gcd(axes[a], rem)
            if g > 1:
                dcn[a] = g
                rem //= g
        if rem != 1:
            raise ValueError(
                f"cannot lay {n_slices} DCN granules across "
                f"{ {a: axes[a] for a in ('pp', 'dp_replicate', 'dp_shard')} } "
                "without splitting ep/tp/cp over DCN (latency-bound "
                "collectives); set MeshConfig.dcn explicitly to opt in"
            )
    dcn_shape = tuple(dcn.get(a, 1) for a in axes)
    ici_shape = tuple(axes[a] // dcn.get(a, 1) for a in axes)
    return ici_shape, dcn_shape


def build_mesh(config: MeshConfig | None = None, device_type: Optional[str] = None, **degrees: int) -> MeshContext:
    """The device mesh over the initialised process group (JAX :286):
    ``init_device_mesh`` in JAX's axis order, then the groupings flattened.
    ``device_type`` defaults to the group's (``cuda`` under NCCL)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_mesh needs a process group: call parallel.initialize_distributed first")
    config = config or MeshConfig(**degrees)
    config.check_ported()
    config = config.validate(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ctx = MeshContext(config)
    shape = tuple(ctx.shape[a] for a in MeshAxisName.ALL)
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=MeshAxisName.ALL)
    ctx.flat = {name: mesh[LOGICAL_AXIS_RULES[name]]._flatten(name) for name in FLAT_GROUPS}
    ctx.mesh = mesh
    logger.info("Built mesh %s", ctx.shape)
    return ctx


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(device: str | torch.device = "cuda", timeout_s: Optional[float] = None) -> tuple[int, int]:
    """Join (or make) the process group → (rank, world size).

    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``
    / ``MASTER_PORT`` name the rendezvous; without them the run is one
    process and the group is made over a free localhost port. They are
    validated before dialing, as JAX validates its ``JAX_*`` variables, so
    a bad rendezvous fails as a config error rather than a hang. A CUDA
    ``device`` sets the device ``LOCAL_RANK`` and takes NCCL (initialised
    eagerly, so a failure raises here); ``cpu`` takes gloo.
    ``AUTOMODEL_INIT_TIMEOUT_S`` (default 600) bounds the rendezvous. An
    already initialised group is kept."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    device = torch.device(device)
    world_env, rank_env = env.get("WORLD_SIZE"), env.get("RANK")
    if env.get("MASTER_ADDR") and (world_env is None or rank_env is None):
        raise ValueError(
            "MASTER_ADDR is set but WORLD_SIZE / RANK are not — torchrun exports all of RANK, "
            "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT"
        )
    if world_env is None:
        world, rank, local_rank = 1, 0, 0
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    else:
        try:
            world, rank = int(world_env), int(rank_env)
            local_rank = int(env.get("LOCAL_RANK", rank))
        except ValueError:
            raise ValueError(f"invalid process topology: RANK={rank_env!r} WORLD_SIZE={world_env!r}") from None
        if world < 1 or not (0 <= rank < world):
            raise ValueError(f"invalid process topology: rank={rank} world_size={world}")
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if not addr or not (port or "").isdigit():
            raise ValueError(f"MASTER_ADDR={addr!r} / MASTER_PORT={port!r} must name host and port")
        init_method = f"tcp://{addr}:{port}"
    timeout = timedelta(seconds=float(timeout_s or env.get("AUTOMODEL_INIT_TIMEOUT_S", "600")))
    kw: dict = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for but torch.cuda.is_available() is False")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
        kw["device_id"] = torch.device("cuda", local_rank)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {device}")
    logger.info("init_process_group(%s, %s, rank=%d, world_size=%d)", backend, init_method, rank, world)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, timeout=timeout, **kw)
    return rank, world


def destroy_distributed() -> None:
    """Tear down the process group, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
