"""The ``solve(problem, method)`` facade: the single entry point.

Port of ``hedgehog_tpu/core/solve.py``: a registry keyed by method class
(with an MRO walk) in place of Julia's multiple dispatch.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["solve", "register_solver", "AbstractPricingMethod"]


class AbstractPricingMethod:
    """Base marker for pricing methods (pricing_methods.jl:6)."""


_SOLVERS: dict[type, Callable] = {}


def register_solver(method_cls: type):
    """Register fn(problem, method) for a method class."""

    def deco(fn: Callable) -> Callable:
        _SOLVERS[method_cls] = fn
        return fn

    return deco


def solve(problem: Any, method: Any):
    """Price ``problem`` with ``method``."""
    for cls in type(method).__mro__:
        if cls in _SOLVERS:
            return _SOLVERS[cls](problem, method)
    raise TypeError(f"no solver registered for method {type(method).__name__}")
