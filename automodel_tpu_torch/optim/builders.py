"""Optimizer construction from config, port of
``automodel_tpu/optim/builders.py`` (:88-165): ``adamw`` and ``adam``
(moments in fp32, or in the param dtype with ``moments_dtype: param``),
``lion``, ``sgd``, ``adafactor`` and ``muon``.

Each update follows the optax chain the JAX package builds, in its order:
the fp32 global-norm clip (``clip_by_global_norm_fp32``), the optimizer's
scaling, decoupled weight decay (adamw and lion), then the learning-rate
schedule; the new parameter is ``p + u`` cast back to p's dtype, as
``optax.apply_updates`` and the cast at ``training/train_step.py:188`` do.
The default Adam is written out by hand because ``torch.optim.AdamW``
keeps its moments in the parameter dtype: with bf16 params the second
moment's ``(1 - b2) * g**2`` increment rounds away and it freezes, the
fault :33-44 of the JAX module documents. ``moments_dtype: param`` is that
concession made on purpose (optax's ``scale_by_adam``, half the optimizer
memory), for a model that does not fit otherwise.

``adafactor`` and ``muon`` read a parameter's shape: optax factors,
clips and scales each *leaf* of the JAX param tree, and labels a leaf
``muon`` when it is 2-D. JAX stacks every decoder layer's tensors on a
leading layer axis and stores projection kernels ``[in, out]``, so a layer
kernel is a 3-D leaf (Adam's branch under muon) and a stacked norm scale a
2-D one; an MoE family's expert slabs are ``[L, E, D, 2I]`` leaves, its
router ``[L, D, E]``, DeepSeek-V3's dense prefix a stack of its own. These
two optimizers therefore group the port's tensors into the JAX leaves they
came from (``JaxLeaf``, ``params_from_jax`` read backwards: the dense
families' map, or the model's ``jax_leaf_of``) and compute in the JAX
layout; the elementwise ones need no grouping.

A leaf is never stacked: its update runs tensor by tensor (each a
shard under a mesh, a DTensor whose placement ``like`` gives), and what
optax reduces over the whole leaf is summed from the parts. Adafactor's row and column means, its row-factor mean and the two
RMS clips sum their partial sums over the mesh dims that shard the
reduced dims; Muon's Adam branch is elementwise, and its Newton-Schulz
all-reduces the Gram matrix over the mesh dims that shard the contracted
dim (a leaf sharded on its other dim is gathered first, a small one:
the iteration commutes with a permutation of the rows). Their checkpoint
tree holds each statistic as a DTensor placed as its leaf's parameters
(``JaxLeaf.placed``), so DCP writes it whole and reshards it on load.

Grads in bf16 (one microbatch with bf16 params) round where optax 0.2.6
rounds them: the clip scale is cast to the grad's dtype (:84), and
``(1-b1)·g``, ``g²`` and ``(1-b2)·g²`` are computed in that dtype, the
decay constants rounded to it, before each is added into its fp32 moment.
fp32 grads keep every step in fp32. The bias corrections ``1 - b**count``
are fp32, as optax's.

Updates are in place (params and moments), since a torch step owns its
buffers; the caller decides beforehand whether a step is applied at all.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from automodel_tpu_torch.optim.scheduler import build_lr_schedule


def tensor_norms_fp32(tensors: Iterable[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor's L2 norm with fp32 accumulation whatever its dtype (bf16
    partial sums saturate after a few hundred equal-magnitude terms)."""
    return [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]


def global_norm_fp32(tensors: Iterable[torch.Tensor], norms: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Global L2 norm with fp32 accumulation: the norm of the per-tensor
    norms (``norms`` when the caller already has them)."""
    return torch.linalg.vector_norm(torch.stack(list(norms) if norms is not None else tensor_norms_fp32(tensors)))


@dataclasses.dataclass
class AdamFP32:
    """Clipped Adam/AdamW with fp32 moments over a fixed list of params."""

    params: list
    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    count: int = 0  # updates applied (optax's adam and schedule counts)
    mu: list = dataclasses.field(default_factory=list)
    nu: list = dataclasses.field(default_factory=list)
    trainable: Optional[list] = None  # None: every tensor; False: frozen, no state

    def __post_init__(self):
        self.params = list(self.params)
        if self.trainable is None:
            self.trainable = [True] * len(self.params)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) if t else None for p, t in zip(self.params, self.trainable)]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) if t else None for p, t in zip(self.params, self.trainable)]

    def state_tree(self, names: Sequence[str]) -> dict:
        """The moments keyed by parameter name and the count, a checkpoint
        tree over the live tensors."""
        return {
            "mu": {n: t for n, t in zip(names, self.mu) if t is not None},
            "nu": {n: t for n, t in zip(names, self.nu) if t is not None},
            "count": self.count,
        }

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> None:
        """Apply one step in place from ``grads`` (one per param, any float
        dtype). ``grad_norm`` is the fp32 global norm if the caller has it."""
        clip = None
        if self.grad_clip_norm:
            norm = grad_norm if grad_norm is not None else global_norm_fp32(grads)
            clip = torch.clamp(self.grad_clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        count = self.count + 1
        # the bias corrections in fp32, as optax computes 1 - b**count
        bc1 = float(1 - np.float32(self.b1) ** np.float32(count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(count))
        lr = float(self.schedule(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if mu is None:  # frozen
                continue
            if g.dtype == torch.float32:
                g32 = g if clip is None else g * clip
                mu.mul_(self.b1).add_(g32, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g32, g32, value=1.0 - self.b2)
            else:
                # optax's moment update in the grad's dtype (tree_update_moment):
                # the clip scale, (1 - b1)·g, g² and (1 - b2)·g² each rounded to
                # it, the decay constants too, then added into the fp32 moment
                if clip is not None:
                    g = g * clip.to(g.dtype)
                mu.mul_(self.b1).add_(g * torch.tensor(1.0 - self.b1, dtype=g.dtype))
                nu.mul_(self.b2).add_((g * g) * torch.tensor(1.0 - self.b2, dtype=g.dtype))
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                u.add_(p.float(), alpha=self.weight_decay)
            p.copy_((p.float() + u.mul_(-lr)).to(p.dtype))
        self.count = count


OPTIMIZERS = ("adamw", "adam", "lion", "sgd", "adafactor", "muon")
# optax.contrib.muon's Newton-Schulz defaults (optax 0.2.6)
MUON_NS_COEFFS = (3.4445, -4.775, 2.0315)
MUON_NS_STEPS = 5
MUON_BETA = 0.95
MUON_EPS = 1e-8


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``like``'s dtype, as JAX's weak typing rounds
    it before the op (a Python scalar in a torch op is not rounded)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _bias_correction(t: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    """optax ``tree_bias_correction``: ``1 - decay**count`` in fp32, then the
    division in the moment's dtype."""
    return t / _c(float(np.float32(1) - np.float32(decay) ** np.float32(count)), t)


class _Clipped(Sequence):
    """``clip_by_global_norm_fp32`` read lazily: grad ``i`` times the fp32
    scale cast to its dtype, made when an update reads it, so the clipped
    grads of the whole model never sit in memory at once."""

    def __init__(self, grads: Sequence[torch.Tensor], norm: torch.Tensor, max_norm: float):
        self.grads = grads
        self.scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)

    def __len__(self) -> int:
        return len(self.grads)

    def __getitem__(self, i: int) -> torch.Tensor:
        g = self.grads[i]
        return g * self.scale.to(g.dtype)


def _scale_lr(u: torch.Tensor, lr: float) -> torch.Tensor:
    """``scale_by_learning_rate``: ``-lr`` as an array of the update's dtype."""
    return _c(-lr, u) * u


def _shard_dims(t: torch.Tensor) -> dict[int, tuple]:
    """A DTensor's sharded dims → (its mesh, the names of the mesh dims of
    more than one rank that shard it); {} for a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return {}
    mesh, out = t.device_mesh, {}
    for i, pl in enumerate(t.placements):
        if pl.is_shard() and mesh.size(i) > 1:
            out.setdefault(pl.dim % t.dim(), []).append(mesh.mesh_dim_names[i])
    return {d: (mesh, tuple(v)) for d, v in out.items()}


def _all_reduce(x: torch.Tensor, where: Optional[tuple]) -> torch.Tensor:
    """x summed over the mesh dims ``where`` names ((mesh, dim names), or
    None for nothing to sum)."""
    if where is None:
        return x
    import torch.distributed as dist

    from automodel_tpu_torch.parallel.plans import _group_over

    x = x.contiguous()
    dist.all_reduce(x, group=_group_over(*where))
    return x


def _union(wheres: Sequence[Optional[tuple]]) -> Optional[tuple]:
    """The mesh dims of several sharded dims together (one mesh)."""
    wheres = [w for w in wheres if w is not None]
    if not wheres:
        return None
    names = tuple(dict.fromkeys(n for _, ns in wheres for n in ns))
    return wheres[0][0], names


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """One leaf of the JAX param tree over the port's tensors: ``index`` are
    their positions in the parameter list, stacked on a leading layer axis
    when ``stacked`` (one tensor otherwise), each the leaf's slice
    transposed when ``transposed``."""

    path: str
    index: tuple[int, ...]
    stacked: bool
    transposed: bool

    def gather(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The leaf in the JAX layout, from the port's tensors."""
        ts = [tensors[i].t() if self.transposed else tensors[i] for i in self.index]
        return torch.stack(ts) if self.stacked else ts[0]

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A JAX-layout tensor of the leaf's shape → the port's tensors."""
        parts = list(x.unbind(0)) if self.stacked else [x]
        return [t.t() if self.transposed else t for t in parts]

    def member(self, t: torch.Tensor) -> torch.Tensor:
        """One port tensor in the JAX layout of its slice of the leaf."""
        return t.t() if self.transposed else t

    def shape(self, like: Sequence[torch.Tensor]) -> tuple[int, ...]:
        """The leaf's whole (unsharded) JAX shape."""
        m = tuple(like[self.index[0]].shape)
        m = m[::-1] if self.transposed else m
        return ((len(self.index),) if self.stacked else ()) + m

    def sharding(self, like: Sequence[torch.Tensor]) -> dict[int, tuple]:
        """The member's JAX-layout dims its placement shards → (mesh, dims)."""
        d = _shard_dims(like[self.index[0]])
        return {(1 - k if self.transposed else k): v for k, v in d.items()}

    def placed(self, stat: torch.Tensor, like: Sequence[torch.Tensor], drop: Optional[int] = None) -> torch.Tensor:
        """A statistic of the leaf (its local part in the leaf's JAX layout,
        the leaf's dim ``drop`` reduced away) as a DTensor laid out as the
        leaf's parameters, so a checkpoint holds it whole and reshards it:
        a dim the parameters shard stays sharded, the reduced one is
        replicated (its partial sums were all-reduced). Over plain
        parameters, ``stat`` itself."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.placement_types import _StridedShard

        p = like[self.index[0]]
        if not isinstance(p, DTensor):
            return stat
        placements = []
        for pl in p.placements:
            if pl.is_shard():
                d = pl.dim % p.dim()
                d = (1 - d if self.transposed else d) + int(self.stacked)
                if d == drop:
                    pl = Replicate()
                else:
                    d -= int(drop is not None and d > drop)
                    pl = _StridedShard(d, split_factor=pl.split_factor) if isinstance(pl, _StridedShard) else Shard(d)
            placements.append(pl)
        shape = [n for i, n in enumerate(self.shape(like)) if i != drop]
        stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        return DTensor.from_local(stat, p.device_mesh, placements, shape=torch.Size(shape), stride=tuple(stride))


def jax_leaves(names: Sequence[str], leaf_of: Optional[Callable] = None) -> list[JaxLeaf]:
    """Group the port's parameter names into the JAX leaves they came from
    (``leaf_of``: the model's map, by default the dense families',
    ``models/llama/state_dict_adapter.jax_leaf_of``). Raises naming a
    tensor the map does not know."""
    from automodel_tpu_torch.models.llama.state_dict_adapter import jax_leaf_of

    leaf_of = leaf_of or jax_leaf_of
    groups: dict[str, list] = {}
    for i, name in enumerate(names):
        where = leaf_of(name)
        if where is None:
            raise ValueError(
                f"{name}: its JAX leaf layout is not mapped, so adafactor and muon cannot place its update"
            )
        path, layer, transposed = where
        groups.setdefault(path, []).append((layer, i, transposed))
    leaves = []
    for path, members in groups.items():
        members.sort(key=lambda m: -1 if m[0] is None else m[0])
        leaves.append(JaxLeaf(path, tuple(m[1] for m in members), members[0][0] is not None, members[0][2]))
    return leaves


class _Chain:
    """An optax chain over a fixed list of tensors, updated in place: the
    fp32 clip, the subclass's update rule (``_updates`` yields each
    tensor's final update, learning rate applied), then ``p + u`` cast to
    p's dtype. ``trainable`` (``training/freeze.py``) leaves a frozen tensor
    without state and without an update, as JAX's ``apply_freeze`` routes
    it to ``set_to_zero``."""

    def __init__(self, params, schedule, grad_clip_norm=None, weight_decay=0.0, trainable=None):
        self.params = list(params)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.weight_decay = weight_decay
        self.trainable = [True] * len(self.params) if trainable is None else list(trainable)
        self.count = 0  # updates applied (optax's counts)

    def _zeros(self) -> list:
        """Per-tensor state in the param dtype (optax ``zeros_like``), None
        for a frozen tensor."""
        return [torch.zeros_like(p) if t else None for p, t in zip(self.params, self.trainable)]

    def _updates(self, grads: list, lr: float) -> Iterator[tuple[int, torch.Tensor]]:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> None:
        grads = list(grads)
        if self.grad_clip_norm:
            norm = grad_norm if grad_norm is not None else global_norm_fp32(grads)
            grads = _Clipped(grads, norm, self.grad_clip_norm)
        lr = float(self.schedule(self.count))
        # one tensor's update at a time, applied at once: the updates of
        # the whole model would double the memory of the weights
        for i, u in self._updates(grads, lr):
            p = self.params[i]
            p.copy_((p + u).to(p.dtype))
        self.count += 1

    def state_tree(self, names: Sequence[str]) -> dict:
        """The optimizer's state as a checkpoint tree over its live tensors."""
        tree: dict[str, Any] = {"count": self.count}
        for key, tensors in self.state_lists().items():
            tree[key] = {n: t for n, t in zip(names, tensors) if t is not None}
        return tree

    def state_lists(self) -> dict[str, list]:
        raise NotImplementedError


class AdamParamDtype(_Chain):
    """optax ``scale_by_adam`` with moments in the param dtype
    (``moments_dtype: param``), then decoupled weight decay (adamw), then
    the schedule. The moments take the dtype of their update expression,
    as optax's do (fp32 grads of an accumulated step promote them)."""

    def __init__(self, params, schedule, b1=0.9, b2=0.999, eps=1e-8, **kw):
        super().__init__(params, schedule, **kw)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu, self.nu = self._zeros(), self._zeros()

    def state_lists(self) -> dict[str, list]:
        return {"mu": self.mu, "nu": self.nu}

    def _updates(self, grads, lr):
        c = self.count + 1
        for i, g in enumerate(grads):
            if not self.trainable[i]:
                continue
            mu, nu = self.mu[i], self.nu[i]
            if torch.promote_types(g.dtype, mu.dtype) == mu.dtype:
                # in place when the moment keeps its dtype: each product is
                # rounded to it as in optax's expression, and the sum is the same
                mu.mul_(_c(self.b1, mu)).add_(_c(1 - self.b1, g) * g)
                nu.mul_(_c(self.b2, nu)).add_(_c(1 - self.b2, g) * (g * g))
            else:
                mu = _c(1 - self.b1, g) * g + _c(self.b1, mu) * mu
                nu = _c(1 - self.b2, g) * (g * g) + _c(self.b2, nu) * nu
                self.mu[i], self.nu[i] = mu, nu
            u = _bias_correction(mu, self.b1, c) / (torch.sqrt(_bias_correction(nu, self.b2, c)) + _c(self.eps, nu))
            if self.weight_decay:
                p = self.params[i]
                u = u + _c(self.weight_decay, p) * p
            yield i, _scale_lr(u, lr)


class Lion(_Chain):
    """optax ``scale_by_lion(b1, b2)``: the sign of the interpolated moment,
    the moment (param dtype) updated with ``b2``; then decoupled weight
    decay and the schedule."""

    def __init__(self, params, schedule, b1=0.9, b2=0.99, **kw):
        super().__init__(params, schedule, **kw)
        self.b1, self.b2 = b1, b2
        self.mu = self._zeros()

    def state_lists(self) -> dict[str, list]:
        return {"mu": self.mu}

    def _updates(self, grads, lr):
        for i, g in enumerate(grads):
            if not self.trainable[i]:
                continue
            mu = self.mu[i]
            u = torch.sign(_c(1 - self.b1, g) * g + _c(self.b1, mu) * mu)
            self.mu[i] = _c(1 - self.b2, g) * g + _c(self.b2, mu) * mu
            if self.weight_decay:
                p = self.params[i]
                u = u + _c(self.weight_decay, p) * p
            yield i, _scale_lr(u, lr)


class SGD(_Chain):
    """optax ``trace(decay=b1)`` (heavy-ball momentum, param-dtype trace),
    then the schedule; no weight decay, as in JAX."""

    def __init__(self, params, schedule, b1=0.9, **kw):
        super().__init__(params, schedule, **kw)
        self.b1 = b1
        self.trace = self._zeros()

    def state_lists(self) -> dict[str, list]:
        return {"trace": self.trace}

    def _updates(self, grads, lr):
        for i, g in enumerate(grads):
            if not self.trainable[i]:
                continue
            t = g + _c(self.b1, self.trace[i]) * self.trace[i]
            self.trace[i] = t
            yield i, _scale_lr(t, lr)


def _factored_dims(shape: Sequence[int], min_dim: int = 128) -> Optional[tuple[int, int]]:
    """optax ``_factored_dims``: the two largest axes (numpy's argsort, ties
    included), when the smaller of them reaches ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(_Chain):
    """``optax.adafactor(learning_rate, weight_decay_rate)`` with optax
    0.2.6's defaults: factored second moments over the two largest axes of
    a leaf when both reach 128 (``decay_rate`` 0.8, ``eps`` 1e-30), the
    leaf's update clipped to an RMS of 1, the schedule, scaled by the
    leaf's parameter RMS (at least 1e-3), decoupled weight decay after the
    schedule when set, no momentum. Each leaf is computed in its JAX layout
    (``JaxLeaf``), tensor by tensor (the module docstring). ``like``: the parameters as placed (DTensors
    under a mesh) when ``params`` are their local shards."""

    def __init__(self, params, schedule, leaves: Sequence[JaxLeaf], like=None, **kw):
        super().__init__(params, schedule, **kw)
        self.like = list(like) if like is not None else self.params
        self.leaves = [lf for lf in leaves if all(self.trainable[i] for i in lf.index)]
        self.v_row: dict[str, torch.Tensor] = {}
        self.v_col: dict[str, torch.Tensor] = {}
        self.v: dict[str, torch.Tensor] = {}
        self.dims: dict[str, Optional[tuple[int, int]]] = {}
        for lf in self.leaves:
            shape = lf.shape(self.like)
            dims = self.dims[lf.path] = _factored_dims(shape)
            if lf.stacked and dims is not None and 0 in dims:
                raise ValueError(f"{lf.path}: adafactor factors its layer axis ({shape[0]} layers), which the "
                                 "update tensor by tensor cannot reduce")
            local = (len(lf.index),) * lf.stacked + tuple(lf.member(self.params[lf.index[0]]).shape)
            p = self.params[lf.index[0]]
            zeros = lambda shp: torch.zeros(shp, dtype=p.dtype, device=p.device)
            if dims is None:
                self.v[lf.path] = zeros(local)
            else:
                d1, d0 = dims
                self.v_row[lf.path] = zeros(local[:d0] + local[d0 + 1:])
                self.v_col[lf.path] = zeros(local[:d1] + local[d1 + 1:])

    def state_tree(self, names):
        """The statistics keyed by JAX leaf path, placed as their leaves
        (``JaxLeaf.placed``) and the count."""
        tree = {"count": self.count, "v_row": {}, "v_col": {}, "v": {}}
        for lf in self.leaves:
            dims = self.dims[lf.path]
            if dims is None:
                tree["v"][lf.path] = lf.placed(self.v[lf.path], self.like)
            else:
                tree["v_row"][lf.path] = lf.placed(self.v_row[lf.path], self.like, drop=dims[1])
                tree["v_col"][lf.path] = lf.placed(self.v_col[lf.path], self.like, drop=dims[0])
        return tree

    def _updates(self, grads, lr):
        decay = float(np.float32(1.0) - np.float32(self.count + 1) ** np.float32(-0.8))
        for lf in self.leaves:
            yield from self._leaf(lf, grads, lr, decay)

    def _finish(self, u: torch.Tensor, p: torch.Tensor, lr: float, rms_u, rms_p) -> torch.Tensor:
        u = u / torch.clamp(rms_u, min=1.0)  # clip_by_block_rms(1.0)
        u = _c(lr, u) * u
        u = u * torch.where(rms_p <= 1e-3, _c(1e-3, rms_p), rms_p)  # scale_by_param_block_rms
        if self.weight_decay:
            u = u + _c(self.weight_decay, p) * p
        return -u

    def _leaf(self, lf, grads, lr, decay):
        shape, shard = lf.shape(self.like), lf.sharding(self.like)
        off = int(lf.stacked)  # a member's dim m is the leaf's dim m + off
        dims = self.dims[lf.path]
        at = lambda st, j: st[j] if lf.stacked else st
        sumsq = None
        factors = []
        for j, i in enumerate(lf.index):
            g, p = lf.member(grads[i]), lf.member(self.params[i])
            dt = p.dtype
            sq = (g * g + _c(1e-30, g)).float()
            if dims is not None:
                m1, m0 = dims[0] - off, dims[1] - off
                mean = lambda x, m: _all_reduce(x.sum(dim=m), shard.get(m)) / shape[m + off]
                vr, vc = at(self.v_row[lf.path], j), at(self.v_col[lf.path], j)
                vr.copy_((decay * vr.float() + (1 - decay) * mean(sq, m0)).to(dt))
                vc.copy_((decay * vc.float() + (1 - decay) * mean(sq, m1)).to(dt))
                r1 = m1 - 1 if m1 > m0 else m1  # m1's place in vr
                vr_mean = _all_reduce(vr.float().sum(dim=r1, keepdim=True), shard.get(m1)) / shape[m1 + off]
                factors.append((torch.rsqrt(vr / vr_mean.to(dt)).unsqueeze(m0), torch.rsqrt(vc).unsqueeze(m1)))
                u = g * factors[-1][0] * factors[-1][1]
            else:
                v = at(self.v[lf.path], j)
                v.copy_((decay * v.float() + (1 - decay) * sq).to(dt))
                u = g * torch.rsqrt(v)
            part = torch.stack([(u * u).float().sum(), (p * p).float().sum()])
            sumsq = part if sumsq is None else sumsq + part
        n = math.prod(shape)
        sumsq = _all_reduce(sumsq, _union(list(shard.values()))) / n
        for j, i in enumerate(lf.index):
            g, p = lf.member(grads[i]), lf.member(self.params[i])
            dt = p.dtype
            u = g * factors[j][0] * factors[j][1] if dims is not None else g * torch.rsqrt(at(self.v[lf.path], j))
            rms_u, rms_p = torch.sqrt(sumsq[0].to(u.dtype)), torch.sqrt(sumsq[1].to(dt))
            u = self._finish(u, p, lr, rms_u, rms_p)
            yield i, u.t() if lf.transposed else u


def orthogonalize_newton_schulz(x: torch.Tensor, coeffs=MUON_NS_COEFFS, steps: int = MUON_NS_STEPS,
                                eps: float = MUON_EPS, sharded: Optional[tuple] = None,
                                shape: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """optax ``orthogonalize_via_newton_schulz`` on a 2-D leaf in the JAX
    layout ``[in, out]`` (reduction axis 0): the wider side goes last, the
    Frobenius norm is divided out, then ``steps`` quintic iterations.
    ``sharded``: (dim, (mesh, mesh dims)) when ``x`` is a shard of a leaf
    of the whole ``shape``: the norm and the Gram matrix are summed over
    those mesh dims when the wider side is the sharded one; else the
    shards are gathered (in rank order: the iteration commutes with a
    permutation of the rows) and this rank's rows cut back out."""
    shape = tuple(x.shape) if shape is None else shape
    transposed = shape[0] > shape[1]
    if transposed:
        x = x.t()
    dim = None if sharded is None else (1 - sharded[0] if transposed else sharded[0])
    where = None if sharded is None else sharded[1]
    rows = None
    if dim == 0:
        import torch.distributed as dist

        from automodel_tpu_torch.parallel.plans import _group_over

        group = _group_over(*where)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        rows = (dist.get_rank(group) * x.shape[0], x.shape[0])
        x, where = torch.cat(parts), None
    norm = torch.sqrt(_all_reduce(torch.sum(x * x), where)) if where is not None else torch.linalg.norm(x)
    x = x / (norm + _c(eps, x))
    a0, a1, a2 = (_c(c, x) for c in coeffs)
    for _ in range(steps):
        a = _all_reduce(x @ x.t(), where)
        b = a1 * a + a2 * (a @ a)
        x = a0 * x + b @ x
    if rows is not None:
        x = x.narrow(0, *rows)
    return x.t() if transposed else x


class Muon(_Chain):
    """``optax.contrib.muon(learning_rate, adam_b1, adam_b2,
    weight_decay)`` with its defaults: a leaf that is 2-D in the JAX layout
    takes Muon (momentum ``beta`` 0.95 with Nesterov, Newton-Schulz
    orthogonalized, scaled by ``sqrt(max(1, out / in))``, decoupled weight
    decay, the schedule); every other leaf takes Nesterov AdamW with
    ``adam_b1`` / ``adam_b2`` and no weight decay. So a stacked layer kernel
    ``[L, in, out]`` (and an expert slab ``[L, E, ...]``) takes Adam, while
    the embedding, an untied lm_head and the stacked norm scales ``[L, H]``
    take Muon. Adam's branch is elementwise, so it runs tensor by tensor
    on the (local) tensors; a Muon leaf is stacked (its members are
    vectors, or it is one matrix). ``like``: the parameters as placed."""

    def __init__(self, params, schedule, leaves: Sequence[JaxLeaf], b1=0.9, b2=0.999, like=None, **kw):
        super().__init__(params, schedule, **kw)
        self.b1, self.b2 = b1, b2
        self.like = list(like) if like is not None else self.params
        self.leaves = [lf for lf in leaves if all(self.trainable[i] for i in lf.index)]
        self.muon_leaves = {lf.path for lf in self.leaves if len(lf.shape(self.like)) == 2}

        def zeros(lf):
            p = self.params[lf.index[0]]
            local = (len(lf.index),) * lf.stacked + tuple(lf.member(p).shape)
            return torch.zeros(local, dtype=p.dtype, device=p.device)

        self.mu = {lf.path: zeros(lf) for lf in self.leaves}
        self.nu = {lf.path: zeros(lf) for lf in self.leaves if lf.path not in self.muon_leaves}

    def state_tree(self, names):
        """The moments keyed by JAX leaf path, placed as their leaves
        (``JaxLeaf.placed``) and the count."""
        leaves = {lf.path: lf for lf in self.leaves}
        return {"count": self.count, **{key: {k: leaves[k].placed(t, self.like) for k, t in st.items()}
                                        for key, st in (("mu", self.mu), ("nu", self.nu))}}

    def _updates(self, grads, lr):
        c = self.count + 1
        for lf in self.leaves:
            if lf.path in self.muon_leaves:
                yield from self._muon_leaf(lf, grads, lr, c)
            else:
                yield from self._adam_leaf(lf, grads, lr, c)

    def _muon_leaf(self, lf, grads, lr, c):
        g, mu = lf.gather(grads), self.mu[lf.path]
        beta = MUON_BETA
        mu = _c(1 - beta, g) * g + _c(beta, mu) * mu
        self.mu[lf.path] = mu
        m_hat = _c(beta, mu) * _bias_correction(mu, beta, c + 1) + _c(1 - beta, g) * _bias_correction(g, beta, c)
        shape = lf.shape(self.like)
        shard = lf.sharding(self.like)
        if len(shard) > 1:
            raise ValueError(f"{lf.path}: muon's Newton-Schulz takes a leaf sharded on one dim, not on {sorted(shard)}")
        sharded = next(((d + lf.stacked, w) for d, w in shard.items()), None)
        u = orthogonalize_newton_schulz(m_hat, sharded=sharded, shape=shape)
        u = math.sqrt(max(1.0, shape[1] / shape[0])) * u
        if self.weight_decay:
            p = lf.gather(self.params)
            u = u + _c(self.weight_decay, p) * p
        yield from zip(lf.index, lf.split(_scale_lr(u, lr)))

    def _adam_leaf(self, lf, grads, lr, c):
        # elementwise: each tensor in its own layout, its moments' slice of the
        # leaf's; the moments take their update's dtype, as optax's do
        for st in (self.mu, self.nu):
            dt = torch.promote_types(grads[lf.index[0]].dtype, st[lf.path].dtype)
            if dt != st[lf.path].dtype:
                st[lf.path] = st[lf.path].to(dt)
        for j, i in enumerate(lf.index):
            g = grads[i]
            mu_s, nu_s = (self.mu[lf.path][j], self.nu[lf.path][j]) if lf.stacked else (self.mu[lf.path], self.nu[lf.path])
            if lf.transposed:
                mu_s, nu_s = mu_s.t(), nu_s.t()
            mu = _c(1 - self.b1, g) * g + _c(self.b1, mu_s) * mu_s
            nu = _c(1 - self.b2, g) * (g * g) + _c(self.b2, nu_s) * nu_s
            m_hat = _c(self.b1, mu) * _bias_correction(mu, self.b1, c + 1) + _c(1 - self.b1, g) * _bias_correction(
                g, self.b1, c
            )
            u = m_hat / (torch.sqrt(_bias_correction(nu, self.b2, c)) + _c(MUON_EPS, nu))
            mu_s.copy_(mu)
            nu_s.copy_(nu)
            yield i, _scale_lr(u, lr)


def build_optimizer(
    params: Iterable[torch.Tensor],
    name: str = "adamw",
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    grad_clip_norm: float | None = None,
    lr_schedule: Any | None = None,
    moments_dtype: str | None = None,
    names: Optional[Sequence[str]] = None,
    trainable: Optional[Sequence[bool]] = None,
    leaf_of: Optional[Callable] = None,
    like: Optional[Sequence[torch.Tensor]] = None,
    **sched_kwargs: Any,
):
    """The ``optimizer:`` section over ``params``. Schedule keys may sit in
    ``lr_schedule`` or at the top level (JAX :107); a string ``lr: 1e-2``
    (YAML 1.1 reads dotless scientific notation as a string) is coerced.
    ``names`` (the parameters' names) are needed by ``adafactor`` and
    ``muon``, which compute on the JAX param tree's leaves (``leaf_of``:
    the model's map of a name to its leaf; ``like``: the parameters as
    placed, when ``params`` are their local shards); ``trainable`` freezes
    tensors (``training/freeze.py``)."""
    lr, weight_decay, eps = float(lr), float(weight_decay), float(eps)
    b1, b2 = (float(b) for b in betas)
    grad_clip_norm = float(grad_clip_norm) if grad_clip_norm else None
    if lr_schedule is not None:
        sched_kwargs = dict(lr_schedule)
    schedule = build_lr_schedule(lr=lr, **sched_kwargs)
    params = list(params)
    kw = dict(grad_clip_norm=grad_clip_norm, trainable=trainable)
    if name in ("adafactor", "muon"):
        if names is None:
            raise ValueError(f"optimizer {name!r} needs the parameters' names to find their JAX leaves")
        leaves = jax_leaves(names, leaf_of)
        if name == "adafactor":
            return Adafactor(params, schedule, leaves, like=like, weight_decay=weight_decay, **kw)
        return Muon(params, schedule, leaves, b1=b1, b2=b2, like=like, weight_decay=weight_decay, **kw)
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}; available: {sorted(OPTIMIZERS)}")
    decay = weight_decay if name in ("adamw", "lion") else 0.0
    if name == "lion":
        return Lion(params, schedule, b1=b1, b2=b2, weight_decay=decay, **kw)
    if name == "sgd":
        return SGD(params, schedule, b1=b1, **kw)
    if moments_dtype == "param":
        return AdamParamDtype(params, schedule, b1=b1, b2=b2, eps=eps, weight_decay=decay, **kw)
    if moments_dtype not in (None, "float32"):
        raise ValueError(f"moments_dtype must be None, 'float32' or 'param'; got {moments_dtype!r}")
    return AdamFP32(
        params=params, schedule=schedule, b1=b1, b2=b2, eps=eps, weight_decay=decay,
        grad_clip_norm=grad_clip_norm, trainable=trainable,
    )
