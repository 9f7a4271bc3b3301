"""Train state, port of ``automodel_tpu/training/train_state.py``."""

from __future__ import annotations

import dataclasses

from automodel_tpu_torch.optim.builders import AdamFP32


@dataclasses.dataclass
class TrainState:
    """The trained parameters (a fixed list), their optimizer, and the
    number of optimizer steps taken."""

    params: list
    optimizer: AdamFP32
    step: int = 0
