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
2-D one. These two optimizers therefore group the port's tensors into the
JAX leaves they came from (``JaxLeaf``, ``params_from_jax`` read
backwards) and compute in the JAX layout; the elementwise ones need no
grouping.

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


def jax_leaves(names: Sequence[str]) -> list[JaxLeaf]:
    """Group the port's parameter names into the JAX leaves they came from
    (the dense families' map, ``models/llama/state_dict_adapter.jax_leaf_of``).
    Raises naming a tensor the map does not know."""
    from automodel_tpu_torch.models.llama.state_dict_adapter import jax_leaf_of

    groups: dict[str, list] = {}
    for i, name in enumerate(names):
        where = jax_leaf_of(name)
        if where is None:
            raise ValueError(
                f"{name}: its JAX leaf layout is not mapped (only the dense families' are), so "
                "adafactor and muon cannot run on this model in the torch backend yet"
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
    (``JaxLeaf``)."""

    def __init__(self, params, schedule, leaves: Sequence[JaxLeaf], **kw):
        super().__init__(params, schedule, **kw)
        self.leaves = [lf for lf in leaves if all(self.trainable[i] for i in lf.index)]
        self.v_row: dict[str, torch.Tensor] = {}
        self.v_col: dict[str, torch.Tensor] = {}
        self.v: dict[str, torch.Tensor] = {}
        for lf in self.leaves:
            x = lf.gather(self.params)
            dims = _factored_dims(tuple(x.shape))
            if dims is None:
                self.v[lf.path] = torch.zeros_like(x)
            else:
                d1, d0 = dims
                self.v_row[lf.path] = torch.zeros_like(x.select(d0, 0))
                self.v_col[lf.path] = torch.zeros_like(x.select(d1, 0))

    def state_tree(self, names):
        return {"count": self.count, "v_row": dict(self.v_row), "v_col": dict(self.v_col), "v": dict(self.v)}

    def _updates(self, grads, lr):
        decay = float(np.float32(1.0) - np.float32(self.count + 1) ** np.float32(-0.8))
        for lf in self.leaves:
            g, p = lf.gather(grads), lf.gather(self.params)
            dt = p.dtype
            sq = g * g + _c(1e-30, g)
            dims = _factored_dims(tuple(g.shape))
            # the decay is an fp32 array in optax: it promotes, then the
            # statistics are cast back to the param dtype
            if dims is not None:
                d1, d0 = dims
                vr = (decay * self.v_row[lf.path].float() + (1 - decay) * sq.float().mean(dim=d0)).to(dt)
                vc = (decay * self.v_col[lf.path].float() + (1 - decay) * sq.float().mean(dim=d1)).to(dt)
                self.v_row[lf.path], self.v_col[lf.path] = vr, vc
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = torch.rsqrt(vr / vr.mean(dim=reduced_d1, keepdim=True))
                u = g * row_factor.unsqueeze(d0) * torch.rsqrt(vc).unsqueeze(d1)
            else:
                v = (decay * self.v[lf.path].float() + (1 - decay) * sq.float()).to(dt)
                self.v[lf.path] = v
                u = g * torch.rsqrt(v)
            u = u / torch.clamp(_rms(u), min=1.0)  # clip_by_block_rms(1.0)
            u = _c(lr, u) * u
            rms = _rms(p)
            u = u * torch.where(rms <= 1e-3, _c(1e-3, rms), rms)  # scale_by_param_block_rms
            if self.weight_decay:
                u = u + _c(self.weight_decay, p) * p
            u = -u
            yield from zip(lf.index, lf.split(u))


def orthogonalize_newton_schulz(x: torch.Tensor, coeffs=MUON_NS_COEFFS, steps: int = MUON_NS_STEPS,
                                eps: float = MUON_EPS) -> torch.Tensor:
    """optax ``orthogonalize_via_newton_schulz`` on a 2-D leaf in the JAX
    layout ``[in, out]`` (reduction axis 0): the wider side goes last, the
    Frobenius norm is divided out, then ``steps`` quintic iterations."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.t()
    x = x / (torch.linalg.norm(x) + _c(eps, x))
    a0, a1, a2 = (_c(c, x) for c in coeffs)
    for _ in range(steps):
        a = x @ x.t()
        b = a1 * a + a2 * (a @ a)
        x = a0 * x + b @ x
    return x.t() if transposed else x


class Muon(_Chain):
    """``optax.contrib.muon(learning_rate, adam_b1, adam_b2,
    weight_decay)`` with its defaults: a leaf that is 2-D in the JAX layout
    takes Muon (momentum ``beta`` 0.95 with Nesterov, Newton-Schulz
    orthogonalized, scaled by ``sqrt(max(1, out / in))``, decoupled weight
    decay, the schedule); every other leaf takes Nesterov AdamW with
    ``adam_b1`` / ``adam_b2`` and no weight decay. So a stacked layer kernel
    ``[L, in, out]`` takes Adam, while the embedding, an untied lm_head and
    the stacked norm scales ``[L, H]`` take Muon."""

    def __init__(self, params, schedule, leaves: Sequence[JaxLeaf], b1=0.9, b2=0.999, **kw):
        super().__init__(params, schedule, **kw)
        self.b1, self.b2 = b1, b2
        self.leaves = [lf for lf in leaves if all(self.trainable[i] for i in lf.index)]
        self.muon_leaves = {lf.path for lf in self.leaves if lf.gather(self.params).dim() == 2}
        self.mu = {lf.path: torch.zeros_like(lf.gather(self.params)) for lf in self.leaves}
        self.nu = {lf.path: torch.zeros_like(lf.gather(self.params))
                   for lf in self.leaves if lf.path not in self.muon_leaves}

    def state_tree(self, names):
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def _updates(self, grads, lr):
        c = self.count + 1
        for lf in self.leaves:
            g, mu = lf.gather(grads), self.mu[lf.path]
            if lf.path in self.muon_leaves:
                beta = MUON_BETA
                mu = _c(1 - beta, g) * g + _c(beta, mu) * mu
                m_hat = _c(beta, mu) * _bias_correction(mu, beta, c + 1) + _c(1 - beta, g) * _bias_correction(g, beta, c)
                u = orthogonalize_newton_schulz(m_hat)
                u = math.sqrt(max(1.0, u.shape[1] / u.shape[0])) * u
                if self.weight_decay:
                    p = lf.gather(self.params)
                    u = u + _c(self.weight_decay, p) * p
            else:
                nu = self.nu[lf.path]
                mu = _c(1 - self.b1, g) * g + _c(self.b1, mu) * mu
                nu = _c(1 - self.b2, g) * (g * g) + _c(self.b2, nu) * nu
                self.nu[lf.path] = nu
                m_hat = _c(self.b1, mu) * _bias_correction(mu, self.b1, c + 1) + _c(1 - self.b1, g) * _bias_correction(
                    g, self.b1, c
                )
                u = m_hat / (torch.sqrt(_bias_correction(nu, self.b2, c)) + _c(MUON_EPS, nu))
            self.mu[lf.path] = mu
            yield from zip(lf.index, lf.split(_scale_lr(u, lr)))


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
    **sched_kwargs: Any,
):
    """The ``optimizer:`` section over ``params``. Schedule keys may sit in
    ``lr_schedule`` or at the top level (JAX :107); a string ``lr: 1e-2``
    (YAML 1.1 reads dotless scientific notation as a string) is coerced.
    ``names`` (the parameters' names) are needed by ``adafactor`` and
    ``muon``, which compute on the JAX param tree's leaves; ``trainable``
    freezes tensors (``training/freeze.py``)."""
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
        leaves = jax_leaves(names)
        if name == "adafactor":
            return Adafactor(params, schedule, leaves, weight_decay=weight_decay, **kw)
        return Muon(params, schedule, leaves, b1=b1, b2=b2, weight_decay=weight_decay, **kw)
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
