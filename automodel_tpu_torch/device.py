"""The one rule for where the port runs.

Entry points take a ``device`` of ``cuda`` (the default) or ``cpu``. Asking
for CUDA on a machine without it is an error, never a quiet move to the CPU:
a run that was meant for the card and ran on the host would report host
numbers under the card's name.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """``cuda`` | ``cuda:N`` | ``cpu`` → ``torch.device``. Raises
    ``RuntimeError`` when CUDA is asked for and ``torch.cuda`` is not
    available."""
    if isinstance(name, torch.device):
        name = str(name)
    name = str(name or DEFAULT_DEVICE).strip().lower()
    if name != "cpu" and name != "cuda" and not name.startswith("cuda:"):
        raise ValueError(f"device={name!r} (want cuda|cpu)")
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} was asked for but torch.cuda.is_available() is "
            "False; pass device: cpu (--device=cpu) to run on the CPU"
        )
    return torch.device(name)
