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
2. Expert parallelism (``ep > 1``), where a rule names ``expert``: each
   MoE layer's expert slabs become DTensors sharded on the expert dim
   (``Shard(0)``) over the ``ep`` mesh dim, so a rank holds and updates
   ``E / ep`` experts, and the layer gets its ``ep_group``, over which the
   ``a2a`` / ``a2a_fused`` experts exchange tokens and ``gspmd`` its
   experts' slots (the backends that take it). The slabs stay whole over ``expert_fsdp`` (``dp_shard,
   cp``) and ``dp_replicate``, where JAX shards them on ``expert_fsdp``:
   FSDP2 leaves them out, and their gradients are summed over those ranks
   (the ranks that hold the same experts) as each microbatch's backward
   accumulates them. Tensor parallelism of the slabs (JAX's ``tp_axis``
   split of the intermediate dim inside the a2a body) is not ported:
   ``tp`` on an MoE family is refused.
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

def path_str(name: str) -> str:
    """A port tensor's HF name → the JAX path ``a/b/c`` its rules match
    (``models/llama/state_dict_adapter.jax_leaf_of``); a name the map does
    not know (the MoE families' expert slabs and routers) keeps its dotted
    parts joined by ``/``."""
    from automodel_tpu_torch.models.llama.state_dict_adapter import jax_leaf_of

    where = jax_leaf_of(name)
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
        spec = match_rule(path_str(f"{mod_name}.weight"), rules)
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
    if getattr(cfg, "moe", None) is not None:
        raise ValueError(
            f"distributed.tp={tp} on an MoE family ({type(model).__name__}): tensor parallelism of the "
            "expert slabs (the a2a body's tp_axis split of the intermediate dim, its partial down "
            "products summed after the combine) is not ported to the torch backend yet"
        )
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_attention_heads={cfg.num_heads} and num_key_value_heads="
            f"{cfg.num_kv_heads}: each rank attends with whole heads"
        )
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size} (the vocab-parallel embedding and loss)")


def expert_parallel(model: nn.Module, ctx: MeshContext) -> set:
    """Split each MoE layer's expert slabs over ``ep`` (``Shard(0)`` on the
    ``ep`` mesh dim) and hand the layer its ``ep_group`` → the slab
    parameters (FSDP2 leaves them out). Their gradients are summed over
    the ranks holding the same experts, when there are more than one."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from automodel_tpu_torch.moe.experts import EP_BACKENDS, EPGroup
    from automodel_tpu_torch.moe.layer import MoEBlock

    ep = ctx.ep_size
    blocks = [m for m in model.modules() if isinstance(m, MoEBlock)]
    experts = getattr(model.backend, "experts", None)
    if blocks and experts not in EP_BACKENDS:
        raise ValueError(
            f"distributed.ep={ep} needs the token-exchange experts {list(EP_BACKENDS)}, not experts={experts!r}"
        )
    ep_mesh = ctx.submesh(MeshAxisName.EP)
    group = EPGroup(ep, ctx.coordinate(MeshAxisName.EP), ctx.group(MeshAxisName.EP))
    replicas = [MeshAxisName.DP_REPLICATE, MeshAxisName.DP_SHARD, MeshAxisName.CP]
    replicas = tuple(a for a in replicas if ctx.size(a) > 1)
    sum_group = _group_over(ctx.mesh, replicas) if replicas else None
    slabs: set = set()
    for block in blocks:
        # every slab (gate_up, down and the gpt-oss biases): the rules name
        # ``expert`` on each one's leading dim (models/qwen3_moe SHARDING_RULES)
        for name, p in list(block.experts.named_parameters(recurse=False)):
            if p.shape[0] % ep:
                raise ValueError(f"num_experts={p.shape[0]} must be divisible by ep={ep}")
            placed = nn.Parameter(distribute_tensor(p.detach(), ep_mesh, [Shard(0)]), requires_grad=p.requires_grad)
            setattr(block.experts, name, placed)
            if sum_group is not None:
                placed.register_post_accumulate_grad_hook(
                    lambda q: dist.all_reduce(q.grad.to_local(), group=sum_group))
            slabs.add(placed)
        block.ep_group = group
    return slabs


def parallelize(model: nn.Module, ctx: MeshContext, rules: Optional[Rules] = None, fsdp: bool = True) -> nn.Module:
    """Apply the plans to a built model in place: DTensor TP where the
    rules name ``tensor`` (``tp > 1``), the expert slabs over ``ep`` (``ep
    > 1``), then FSDP2 on each decoder layer and the root (``fsdp``). The
    model's ``hidden`` is registered as an FSDP forward method, so the
    loss's own path unshards the root's parameters too."""
    rules = rules if rules is not None else model.sharding_rules
    tp = ctx.tp_size
    if tp > 1:
        from torch.distributed.tensor.parallel import parallelize_module

        check_tp(model, tp)
        parallelize_module(model, ctx.submesh(MeshAxisName.TP), tp_plan(model, rules))
    slabs = expert_parallel(model, ctx) if ctx.ep_size > 1 else set()
    if fsdp:
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard, register_fsdp_forward_method

        mesh = ctx.fsdp_mesh()
        mp = MixedPrecisionPolicy(reduce_dtype=torch.float32)
        for layer in decoder_layers(model):
            fully_shard(layer, mesh=mesh, mp_policy=mp, ignored_params=slabs or None)
        fully_shard(model, mesh=mesh, mp_policy=mp, ignored_params=slabs or None)
        for unit in (*decoder_layers(model), model):
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
