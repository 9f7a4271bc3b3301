"""Sharding plans from a model's rules, port of ``automodel_tpu/parallel/plans.py``.

JAX matches ``(path_regex, logical_dims)`` rules against param-tree paths
and lets GSPMD place each leaf. Here the same rules, matched against the
JAX path of each of the port's HF-named tensors (``path_str``), decide two
things on a built model (``parallelize``):

1. Tensor parallelism, where a rule names ``tensor``: DTensor plans on the
   ``tp`` mesh. A projection kernel is ``[in, out]`` in JAX and ``[out,
   in]`` here, so ``tensor`` on the out dim is ``ColwiseParallel``
   (``[qkv]_proj``, ``(gate|up)_proj``: their outputs stay sharded on the
   heads and the intermediate dim), on the in dim ``RowwiseParallel``
   (``o_proj``, ``down_proj``: the partial sums all-reduced). The
   embedding (``tensor`` on the vocabulary) is ``RowwiseParallel`` of an
   ``nn.Embedding``: each rank looks its own rows up and the lookups are
   summed. ``lm_head`` (``tensor`` on the vocabulary) is
   ``ColwiseParallel`` with its output left sharded: the vocab-parallel
   loss reads the local logits (``ops/losses.vocab_parallel_cross_entropy``).
   The attention reads its local head counts off the projections, so
   ``tp`` must divide both head counts.
2. The MoE layers' expert slabs, where the rules name ``expert``,
   ``tensor`` and ``expert_fsdp`` (``place_experts``): under ``ep > 1``
   or ``tp > 1`` each slab becomes a DTensor on the (``ep``, ``tp``) mesh,
   ``Shard(0)`` on the expert dim over ``ep`` (a rank holds and updates ``E
   / ep`` experts) and its intermediate dim sharded over ``tp``
   (``gate_up`` [E, D, 2I] and ``gate_up_bias`` on their last dim, ``down``
   [E, I, D] on dim 1; the down bias whole): the canonical layout, which
   checkpoints and exports read as they are, ``moe/experts.tp_slabs``
   turning a rank's shards into its ``[g_r | u_r]`` operands. The layer
   gets its ``ep_group`` (the token exchange of ``a2a`` / ``a2a_fused``,
   ``gspmd``'s slots) and its ``tp_group`` (the partial sums). Each
   layer's ``experts`` module is then its own FSDP2 unit over
   ``expert_fsdp`` (``dp_shard, cp``; with ``dp_replicate`` HSDP), sharding
   the model width (JAX's ``expert_fsdp`` dim) or a bias's first dim no
   other mesh dim splits: the replicas of a rank's experts share the
   shards and sum their gradients by FSDP2's reduce-scatter, as JAX's
   GSPMD does. The shared experts and the attention of the MoE families
   take their TP plans from the same rules (MLA's low-rank ``q_a`` /
   ``kv_a`` stay replicated; GPT-OSS's sinks are sharded by head).
3. FSDP2: ``fully_shard`` on each decoder layer, then on the root, over the
   ``fsdp`` grouping, or the 2-D (``dp_replicate``, ``fsdp``) mesh for
   HSDP. FSDP2 shards each tensor's first dim; which dim JAX's rules name
   ``fsdp`` changes where a shard lies, not what a step computes.

The mixed-precision policy keeps the arithmetic of one process: parameters
are gathered in their own dtype (no ``param_dtype`` cast), and gradients
are reduce-scattered in fp32 and cast back to the param dtype once,
after the sum. One process rounds each gradient to the param dtype once,
after its fp32 matmul accumulation; JAX's GSPMD sums the per-device
partials of one jitted backward before that rounding too. A bf16 reduce
would round each rank's partial first and then the sum. The reduce is a
plain SUM (``set_gradient_divide_factor(1.0)``, sums forced): the train
step divides by the global label-token count, as JAX does.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence

import torch
from torch import nn

from automodel_tpu_torch.parallel.mesh import MeshAxisName, MeshContext

Rules = Sequence[tuple[str, tuple]]

def path_str(name: str, model: Optional[nn.Module] = None) -> str:
    """A port tensor's HF name → the JAX path ``a/b/c`` its rules match
    (the model's ``jax_leaf_of``, the MoE families'; else the dense
    families' ``models/llama/state_dict_adapter.jax_leaf_of``); a name the
    map does not know keeps its dotted parts joined by ``/``."""
    from automodel_tpu_torch.models.llama.state_dict_adapter import jax_leaf_of

    where = getattr(model, "jax_leaf_of", jax_leaf_of)(name)
    return where[0] if where is not None else name.replace(".", "/")


def match_rule(path: str, rules: Rules) -> tuple | None:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return None


def _tensor_dim(spec: tuple) -> Optional[int]:
    """Which dim of a JAX leaf a rule shards on ``tensor``, counted from
    the end (-1 = last), or None."""
    for i, dim in enumerate(spec):
        names = dim if isinstance(dim, (tuple, list)) else (dim,)
        if "tensor" in names:
            return i - len(spec)
    return None


def tp_plan(model: nn.Module, rules: Rules) -> dict[str, Any]:
    """The DTensor plan ``{module name: ParallelStyle}`` for every module
    whose weight a rule shards on ``tensor``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    plan: dict[str, Any] = {}
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, (nn.Linear, nn.Embedding)):
            continue
        spec = match_rule(path_str(f"{mod_name}.weight", model), rules)
        dim = None if spec is None else _tensor_dim(spec)
        if dim is None:
            continue
        if isinstance(mod, nn.Embedding):
            # [V, D] in both packages: tensor on the vocabulary
            if dim != -2:
                raise ValueError(f"{mod_name}: an embedding sharded on its dim {dim} has no plan")
            plan[mod_name] = RowwiseParallel(input_layouts=Replicate(), output_layouts=Replicate())
        elif mod_name == "lm_head":
            plan[mod_name] = ColwiseParallel(output_layouts=Shard(-1), use_local_output=True)
        elif dim == -1:  # JAX [in, out]: the out dim
            plan[mod_name] = ColwiseParallel()
        else:
            plan[mod_name] = RowwiseParallel()
    return plan


def decoder_layers(model: nn.Module) -> list[nn.Module]:
    """The decoder layers FSDP2 wraps one by one."""
    return list(model.model.layers)


def check_tp(model: nn.Module, tp: int) -> None:
    """Raise naming what tensor parallelism cannot split."""
    if tp <= 1:
        return
    cfg = model.config
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        shared = (moe.shared_expert_intermediate_size or moe.moe_intermediate_size) * moe.num_shared_experts
        for what, n in (("moe_intermediate_size", moe.moe_intermediate_size), ("the shared experts' width", shared)):
            if n % tp:
                raise ValueError(f"tp={tp} must divide {what}={n}: each rank runs an I-shard of every expert")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_attention_heads={cfg.num_heads} and num_key_value_heads="
            f"{cfg.num_kv_heads}: each rank attends with whole heads"
        )
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size} (the vocab-parallel embedding and loss)")


# each slab's placements on the (ep, tp) mesh: the expert dim over ep, the
# intermediate dim over tp (models/qwen3_moe SHARDING_RULES), and the dim
# FSDP2 shards over expert_fsdp (the rules' ``expert_fsdp``: the width)
_SLAB_TP_DIM = {"gate_up": 2, "down": 1, "gate_up_bias": 1, "down_bias": None}
_SLAB_EFSDP_DIM = {"gate_up": 1, "down": 2}


def _efsdp_dim(name: str, p: torch.Tensor) -> int:
    """The dim FSDP2 shards a slab on over ``expert_fsdp``: the rules' one,
    or for a bias the first dim neither ``ep`` nor ``tp`` splits (else its
    last, strided over the mesh dim that splits it too)."""
    if name in _SLAB_EFSDP_DIM:
        return _SLAB_EFSDP_DIM[name]
    ep, tp = (p.device_mesh.size(0), p.device_mesh.size(1)) if is_sharded(p) else (1, 1)
    split = {0} if ep > 1 else set()
    if _SLAB_TP_DIM[name] is not None and tp > 1:
        split.add(_SLAB_TP_DIM[name])
    return next((d for d in range(p.dim()) if d not in split), p.dim() - 1)


def place_experts(model: nn.Module, ctx: MeshContext) -> None:
    """Place each MoE layer's expert slabs over (``ep``, ``tp``) and hand
    the layer its groups (module docstring, 2.). Refuses ``ep > 1`` with a
    backend that does not exchange tokens."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from automodel_tpu_torch.moe.experts import EP_BACKENDS, EPGroup
    from automodel_tpu_torch.moe.layer import MoEBlock

    ep, tp = ctx.ep_size, ctx.tp_size
    blocks = [m for m in model.modules() if isinstance(m, MoEBlock)]
    if not blocks or (ep == 1 and tp == 1):
        return
    experts = getattr(model.backend, "experts", None)
    if ep > 1 and experts not in EP_BACKENDS:
        raise ValueError(
            f"distributed.ep={ep} needs the token-exchange experts {list(EP_BACKENDS)}, not experts={experts!r}"
        )
    mesh = ctx.mesh[(MeshAxisName.EP, MeshAxisName.TP)]
    groups = {a: EPGroup(ctx.size(a), ctx.coordinate(a), ctx.group(a)) for a in (MeshAxisName.EP, MeshAxisName.TP)}
    for block in blocks:
        for name, p in list(block.experts.named_parameters(recurse=False)):
            if p.shape[0] % ep:
                raise ValueError(f"num_experts={p.shape[0]} must be divisible by ep={ep}")
            tp_dim = _SLAB_TP_DIM[name]
            placements = [Shard(0), Replicate() if tp_dim is None else Shard(tp_dim)]
            placed = nn.Parameter(distribute_tensor(p.detach(), mesh, placements), requires_grad=p.requires_grad)
            setattr(block.experts, name, placed)
        if ep > 1:
            block.ep_group = groups[MeshAxisName.EP]
        if tp > 1:
            block.tp_group = groups[MeshAxisName.TP]


def _shard_experts(model: nn.Module, ctx: MeshContext, mp: Any) -> None:
    """Each MoE layer's ``experts`` an FSDP2 unit over ``expert_fsdp``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from automodel_tpu_torch.moe.layer import MoEBlock

    mesh = ctx.expert_fsdp_mesh()
    for block in (m for m in model.modules() if isinstance(m, MoEBlock)):
        dims = {id(p): _efsdp_dim(n, p) for n, p in block.experts.named_parameters(recurse=False)}
        fully_shard(block.experts, mesh=mesh, mp_policy=mp, shard_placement_fn=lambda p: Shard(dims[id(p)]))


def _sharded_units(model: nn.Module) -> list:
    from torch.distributed.fsdp import FSDPModule

    return [m for m in model.modules() if isinstance(m, FSDPModule)]


def _distribute_sinks(model: nn.Module, ctx: MeshContext) -> None:
    """GPT-OSS's per-head sinks ``Shard(0)`` over ``tp``, beside the heads
    its q projection's plan shards."""
    from torch.distributed.tensor import Shard, distribute_tensor

    tp_mesh = ctx.submesh(MeshAxisName.TP)
    for mod in model.modules():
        p = getattr(mod, "sinks", None)
        if isinstance(p, nn.Parameter) and not is_sharded(p):
            mod.sinks = nn.Parameter(distribute_tensor(p.detach(), tp_mesh, [Shard(0)]), requires_grad=p.requires_grad)


def parallelize(model: nn.Module, ctx: MeshContext, rules: Optional[Rules] = None, fsdp: bool = True) -> nn.Module:
    """Apply the plans to a built model in place: DTensor TP where the
    rules name ``tensor`` (``tp > 1``), the expert slabs over (``ep``,
    ``tp``), then FSDP2 on each layer's experts over ``expert_fsdp``, on
    each decoder layer and on the root (``fsdp``). The model's ``hidden``
    is registered as an FSDP forward method, so the loss's own path
    unshards the root's parameters too."""
    rules = rules if rules is not None else model.sharding_rules
    tp = ctx.tp_size
    if tp > 1:
        from torch.distributed.tensor.parallel import parallelize_module

        check_tp(model, tp)
        parallelize_module(model, ctx.submesh(MeshAxisName.TP), tp_plan(model, rules))
        _distribute_sinks(model, ctx)
    place_experts(model, ctx)
    if fsdp:
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard, register_fsdp_forward_method

        mesh = ctx.fsdp_mesh()
        mp = MixedPrecisionPolicy(reduce_dtype=torch.float32)
        _shard_experts(model, ctx, mp)
        for layer in decoder_layers(model):
            fully_shard(layer, mesh=mesh, mp_policy=mp)
        fully_shard(model, mesh=mesh, mp_policy=mp)
        for unit in _sharded_units(model):
            # each FSDP unit holds its own reduce settings
            unit.set_gradient_divide_factor(1.0)
            if hasattr(unit, "set_force_sum_reduction_for_comms"):
                unit.set_force_sum_reduction_for_comms(True)
        register_fsdp_forward_method(model, "hidden")
    return model


def is_sharded(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view sharing its storage); a plain
    tensor itself."""
    return t.to_local() if is_sharded(t) else t


def shard_like(tree: Any, params: dict) -> Any:
    """A state tree whose tensors keyed by a sharded parameter's name (the
    optimizer's moments of its local shard) become DTensors laid out as
    that parameter, sharing their storage (``DTensor.from_local``)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        p = params.get(k)
        if isinstance(v, torch.Tensor) and p is not None and is_sharded(p) and v.shape == local(p).shape:
            v = DTensor.from_local(v, p.device_mesh, p.placements, shape=p.shape, stride=p.stride())
        out[k] = shard_like(v, params) if isinstance(v, dict) else v
    return out


def reduce_mesh_dims(t: torch.Tensor) -> tuple[str, ...]:
    """The mesh dims (of more than one rank) a DTensor's sum of squares
    (or element count) is summed over: those it is sharded or partial on."""
    if not is_sharded(t):
        return ()
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(t.placements) if not p.is_replicate() and mesh.size(i) > 1)


_GROUPS: dict = {}


def _group_over(mesh: Any, dims: tuple[str, ...]):
    key = (id(mesh), dims)
    if key not in _GROUPS:
        sub = mesh[dims[0]] if len(dims) == 1 else mesh[dims]._flatten("_".join(("sum",) + dims))
        _GROUPS[key] = sub.get_group()
    return _GROUPS[key]


def global_sums(tensors: Sequence[torch.Tensor], values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-tensor sums over the whole (unsharded) tensors, from each
    tensor's local ``values`` (one scalar a tensor: its local sum of
    squares, its non-finite count): the values of tensors sharded alike
    are all-reduced together over the dims they are sharded on. → [n] in
    the values' dtype."""
    import torch.distributed as dist

    out = torch.stack(list(values))
    by_dims: dict[tuple, list[int]] = {}
    meshes: dict[tuple, Any] = {}
    for i, t in enumerate(tensors):
        dims = reduce_mesh_dims(t)
        if dims:
            by_dims.setdefault(dims, []).append(i)
            meshes[dims] = t.device_mesh
    for dims, idx in by_dims.items():
        part = out[idx].contiguous()
        dist.all_reduce(part, group=_group_over(meshes[dims], dims))
        out[idx] = part
    return out


def global_norms_fp32(tensors: Sequence[torch.Tensor], like: Optional[Sequence[torch.Tensor]] = None) -> list:
    """Each tensor's L2 norm over its whole (unsharded) extent with fp32
    accumulation; ``like`` (default: the tensors) gives each one's
    sharding when ``tensors`` are local shards. A tensor held whole on every
    rank takes its own norm, as one process does; a sharded one the square
    root of its shards' summed squares."""
    like = tensors if like is None else like
    norms = [torch.linalg.vector_norm(local(t), dtype=torch.float32) for t in tensors]
    split = [i for i, t in enumerate(like) if reduce_mesh_dims(t)]
    if split:
        summed = global_sums([like[i] for i in split], [norms[i].square() for i in split]).sqrt()
        for j, i in enumerate(split):
            norms[i] = summed[j]
    return norms
