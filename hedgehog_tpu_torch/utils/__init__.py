"""Small helpers shared across the port.

The JAX package's ``utils/pytree.py`` (frozen dataclasses registered as
pytrees) has no counterpart: the port uses frozen dataclasses directly and
``dataclasses.replace`` for functional updates.

Device rule of the deterministic layers (curves, surfaces, interpolation,
the closed forms, the characteristic functions, Carr–Madan, root finding
and calibration): a layer that is given a device (a method's ``device``)
computes on it and passes it to every :func:`f64`; a layer that is given
none computes on :func:`device_of` its tensor arguments, CPU when they are
only numbers.  No layer moves a tensor to the CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "f64", "device_of"]


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


def device_of(*xs) -> torch.device:
    """The device of the first tensor among ``xs`` that is not on the CPU,
    else the CPU: where a deterministic layer computes when its caller names
    no device."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.device
    return torch.device("cpu")
