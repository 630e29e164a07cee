"""Small helpers shared across the port.

The JAX package's ``utils/pytree.py`` (frozen dataclasses registered as
pytrees) has no counterpart: the port uses frozen dataclasses directly and
``dataclasses.replace`` for functional updates.  :func:`map_leaves` walks
such a tree where ``jax.tree`` would: checkpoints (``utils/checkpoint.py``)
and the replicated inputs of a sharded price (``parallel/sharding.py``).

Device rule of the deterministic layers (curves, surfaces, interpolation,
the closed forms, the characteristic functions, Carr–Madan, root finding
and calibration): a layer that is given a device (a method's ``device``)
computes on it and passes it to every :func:`f64`; a layer that is given
none computes on :func:`device_of` its tensor arguments, CPU when they are
only numbers.  No layer moves a tensor to the CPU on its own.
"""

from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

__all__ = ["resolve_device", "f64", "device_of", "map_leaves", "tree_leaves"]


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


def _is_leaf(x) -> bool:
    """A tensor, an array or a number; a bool is a flag, not a leaf."""
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return not isinstance(x, np.bool_)
    return isinstance(x, numbers.Number) and not isinstance(x, bool)


def map_leaves(fn, tree):
    """``tree`` with each leaf (a tensor, numpy array or number) replaced
    by ``fn(leaf)``, visited in ``jax.tree.leaves`` order: dataclass fields
    in field order, dict values in sorted key order, list and tuple items
    in order.  Everything else (dates, markers, strings, flags, None) is
    kept as it is, and a container none of whose leaves changed is
    returned itself (a changed dataclass is rebuilt by
    ``dataclasses.replace``)."""
    if _is_leaf(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changed = {}
        for field in dataclasses.fields(tree):
            value = getattr(tree, field.name)
            new = map_leaves(fn, value)
            if new is not value:
                changed[field.name] = new
        return dataclasses.replace(tree, **changed) if changed else tree
    if isinstance(tree, dict):
        new = {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
        if all(new[k] is tree[k] for k in tree):
            return tree
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [map_leaves(fn, x) for x in tree]
        if all(a is b for a, b in zip(items, tree)):
            return tree
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`map_leaves` order."""
    leaves = []
    map_leaves(lambda x: leaves.append(x) or x, tree)
    return leaves
