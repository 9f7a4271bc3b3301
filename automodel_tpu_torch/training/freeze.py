"""Parameter freezing by path pattern, port of
``automodel_tpu/training/freeze.py``.

JAX freezes in two pieces: ``optax.multi_transform`` routes a frozen leaf
to ``set_to_zero`` (no optimizer state, no weight decay, no update), and
the train step zeroes its gradient (``build_train_step(grad_mask=...)``),
so ``grad_norm`` is a metric over the trainable leaves only. The port does
the same with a per-tensor mask: the optimizers of ``optim/builders.py``
take it as ``trainable`` (a frozen tensor gets no state and no update) and
``training/train_step.build_train_step`` as ``grad_mask`` (no gradient is
computed for a frozen tensor; it reads as zero).

Patterns are fnmatch-style over JAX's ``a/b/c`` leaf paths (``layers/attn/*``,
``embed/*``), so a config's freeze list means the same in both packages: a
tensor's path is the JAX leaf it came from
(``models/llama/state_dict_adapter.jax_leaf_of``); a tensor that map does
not know matches by its own dotted name with dots as slashes.
"""

from __future__ import annotations

import fnmatch
from typing import Sequence


def param_path(name: str) -> str:
    """The JAX leaf path of a port parameter name."""
    from automodel_tpu_torch.models.llama.state_dict_adapter import jax_leaf_of

    where = jax_leaf_of(name)
    return where[0] if where is not None else name.replace(".", "/")


def freeze_mask(names: Sequence[str], freeze_patterns: Sequence[str]) -> list[bool]:
    """One bool a parameter name: True = trainable, False = frozen."""
    return [not any(fnmatch.fnmatch(param_path(n), pat) for pat in freeze_patterns) for n in names]
