"""Checkpointable host RNG state, port of ``StatefulRNG`` in
``automodel_tpu/training/rng.py``: the Python and numpy generators a data
pipeline draws from. The recipe saves ``state_dict()`` in a checkpoint's
extras under ``"rng"`` and restores it on resume. Device-side randomness
(sampling) is seeded per step and needs no state."""

from __future__ import annotations

import random
from typing import Any

import numpy as np


class StatefulRNG:
    def __init__(self, seed: int = 0, ranked: bool = False, rank: int = 0):
        seed = seed + (rank if ranked else 0)
        self.python = random.Random(seed)
        self.numpy = np.random.default_rng(seed)

    def state_dict(self) -> dict[str, Any]:
        return {"python": self.python.getstate(), "numpy": self.numpy.bit_generator.state}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        pystate = state["python"]
        # JSON gives lists back where the state had tuples; setstate needs tuples
        if isinstance(pystate, list):
            pystate = tuple(tuple(p) if isinstance(p, list) else p for p in pystate)
        self.python.setstate(pystate)
        self.numpy.bit_generator.state = state["numpy"]
