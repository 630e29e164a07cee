"""Carry problem and method objects across from the JAX package.

:func:`from_reference` turns a ``hedgehog_tpu`` object (payoff, market,
problem, method, configuration — any tree of its frozen dataclasses) into
the port's equivalent, so that both packages price exactly the same thing:
classes map by name, fields by name, and every array-like leaf goes through
``np.asarray``.  It imports nothing of jax: a jax array converts through
``__array__`` like any other array.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["from_reference"]


@functools.lru_cache(maxsize=None)
def _port_classes() -> dict:
    from .calibration import calibration
    from .core import dates, lenses, payoffs, problems
    from .greeks import greeks
    from .market import inputs, rate_curve, vol_surface
    from .methods import black_scholes, carr_madan, crr, duality, lsm, montecarlo
    from .models import dynamics, rough_bergomi

    classes = {}
    for mod in (dates, payoffs, problems, lenses, inputs, rate_curve, vol_surface, black_scholes,
                carr_madan, crr, lsm, duality, montecarlo, dynamics, rough_bergomi, greeks,
                calibration):
        for name, obj in vars(mod).items():
            if isinstance(obj, type) and dataclasses.is_dataclass(obj) and obj.__module__ == mod.__name__:
                classes[name] = obj
    return classes


def _is_default(field: dataclasses.Field, value) -> bool:
    if field.default is not dataclasses.MISSING:
        default = field.default
    elif field.default_factory is not dataclasses.MISSING:
        default = field.default_factory()
    else:
        return False
    try:
        return bool(value == default)
    except (TypeError, ValueError):  # array-valued comparisons have no single truth value
        return False


def from_reference(obj):
    """The port's counterpart of a ``hedgehog_tpu`` object or leaf.

    Raises TypeError for a class the port does not have, and for a field
    the port lacks unless it holds the reference's default value."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = _port_classes().get(name)
        if cls is None:
            raise TypeError(f"hedgehog_tpu_torch has no counterpart of {name}")
        port_fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for field in dataclasses.fields(obj):
            if not field.init:
                continue
            value = getattr(obj, field.name)
            if field.name in port_fields:
                kwargs[field.name] = from_reference(value)
            elif not _is_default(field, value):
                raise TypeError(
                    f"{name}.{field.name} = {value!r} has no counterpart in the port"
                )
        return cls(**kwargs)
    if obj is None or isinstance(obj, (str, bool, int, float)):
        return obj
    if isinstance(obj, tuple):
        return tuple(from_reference(x) for x in obj)
    arr = np.array(obj)  # a writable copy: torch refuses to share read-only arrays
    return arr.item() if arr.ndim == 0 else arr
