"""Small helpers shared across the port.

The JAX package's ``utils/pytree.py`` (frozen dataclasses registered as
pytrees) has no counterpart: the port uses frozen dataclasses directly and
``dataclasses.replace`` for functional updates.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "f64"]


def resolve_device(device) -> torch.device:
    """The torch device a computation runs on; a CUDA request on a machine
    without a usable GPU raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch.cuda.is_available() "
            "is False"
        )
    return dev


def f64(x, device="cpu") -> torch.Tensor:
    """A float64 tensor of a number, array or tensor (no copy when it
    already is one on ``device``)."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)
