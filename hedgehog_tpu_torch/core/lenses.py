"""Lenses: functional read/write access to any parameter of a problem.

Port of ``hedgehog_tpu/core/lenses.py`` (reference
src/greeks/greeks_problem.jl:9-130, src/pricing_methods/pricing_methods.jl:26-57).
Greeks and calibration are both "rewrite a parameter through a lens,
re-solve, differentiate or optimise": ``lens.set`` rebuilds the frozen
dataclasses with ``dataclasses.replace`` and writes the value unchanged, so
its autograd history (reverse or forward mode) and its device survive the
write, and ``torch.autograd.grad`` of
``solve(lens.set(prob, x), method).price`` differentiates the whole pricer.

Lenses are hashable frozen dataclasses usable as dict keys
(``BatchGreekProblem`` returns ``{lens: greek}``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..market.rate_curve import FlatRateCurve
from ..market.vol_surface import FlatVolSurface, RectVolSurface
from ..utils import device_of, f64

__all__ = ["Lens", "FieldLens", "SpotLens", "VolLens", "ZeroRateSpineLens", "lens_get", "lens_set"]

_frozen = dataclasses.dataclass(frozen=True)


class Lens:
    """Lens protocol: ``lens.get(obj)`` / ``lens.set(obj, value)``; an
    instance called on an object reads it (the reference's ``lens(prob)``,
    greeks_problem.jl:31-33)."""

    def get(self, obj: Any) -> Any:
        raise NotImplementedError

    def set(self, obj: Any, value: Any) -> Any:
        raise NotImplementedError

    def __call__(self, obj: Any) -> Any:
        return self.get(obj)


def _set_attr_path(obj: Any, parts: tuple[str, ...], value: Any) -> Any:
    if not parts:
        return value
    inner = _set_attr_path(getattr(obj, parts[0]), parts[1:], value)
    return dataclasses.replace(obj, **{parts[0]: inner})


def _write_at(grid, index, value) -> torch.Tensor:
    """``grid`` with ``value`` at ``index``, out of place: the value keeps
    its autograd history (a one-hot blend, so forward mode works too)."""
    dev = device_of(grid, value)
    grid = f64(grid, device=dev)
    value = f64(value, device=dev)
    mask = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    mask[index] = True
    return torch.where(mask, value, grid)


@_frozen
class FieldLens(Lens):
    """Dotted attribute-path lens, the ``@optic _.a.b.c`` replacement:
    ``FieldLens("market_inputs.sigma.sigma")`` targets the flat vol
    (vol_quotes.jl:545)."""

    path: str = ""

    def _parts(self) -> tuple[str, ...]:
        return tuple(self.path.split("."))

    def get(self, obj: Any) -> Any:
        for p in self._parts():
            obj = getattr(obj, p)
        return obj

    def set(self, obj: Any, value: Any) -> Any:
        return _set_attr_path(obj, self._parts(), value)


@_frozen
class SpotLens(Lens):
    """Spot price of the market inputs (greeks_problem.jl:18-49)."""

    def get(self, prob: Any) -> Any:
        return prob.market_inputs.spot

    def set(self, prob: Any, value: Any) -> Any:
        return _set_attr_path(prob, ("market_inputs", "spot"), value)


@_frozen
class VolLens(Lens):
    """Vol at (expiry year fraction, strike): a flat surface ignores the
    coordinates; a rect surface needs an exact grid match and raises
    KeyError otherwise (greeks_problem.jl:56-130)."""

    strike: Any = 1
    expiry: Any = 1

    def _indices(self, surf: RectVolSurface) -> tuple[int, int]:
        tenors = np.asarray(torch.as_tensor(surf.tenors).detach().cpu())
        strikes = np.asarray(torch.as_tensor(surf.strikes).detach().cpu())
        i = np.nonzero(tenors == self.expiry)[0]
        j = np.nonzero(strikes == self.strike)[0]
        if i.size == 0 or j.size == 0:
            raise KeyError(
                f"VolLens: no exact match for expiry={self.expiry} strike={self.strike} "
                "in RectVolSurface."
            )
        return int(i[0]), int(j[0])

    def get(self, prob: Any) -> Any:
        surf = prob.market_inputs.sigma
        if isinstance(surf, FlatVolSurface):
            return surf.sigma
        i, j = self._indices(surf)
        return f64(surf.vols, device=device_of(surf.vols))[i, j]

    def set(self, prob: Any, value: Any) -> Any:
        surf = prob.market_inputs.sigma
        if isinstance(surf, FlatVolSurface):
            new_surf = dataclasses.replace(surf, sigma=value)
        else:
            new_surf = surf.with_vols(_write_at(surf.vols, self._indices(surf), value))
        return _set_attr_path(prob, ("market_inputs", "sigma"), new_surf)


@_frozen
class ZeroRateSpineLens(Lens):
    """i-th zero-rate spine point of the rate curve; a flat curve's constant
    rate is its single spine point (pricing_methods.jl:26-60)."""

    i: int = 0

    def get(self, prob: Any) -> Any:
        curve = prob.market_inputs.rate
        if isinstance(curve, FlatRateCurve):
            return curve.rate
        return f64(curve.zero_rates, device=device_of(curve.zero_rates))[self.i]

    def set(self, prob: Any, value: Any) -> Any:
        curve = prob.market_inputs.rate
        if isinstance(curve, FlatRateCurve):
            new_curve = dataclasses.replace(curve, rate=value)
        else:
            new_curve = curve.with_zero_rates(_write_at(curve.zero_rates, self.i, value))
        return _set_attr_path(prob, ("market_inputs", "rate"), new_curve)


def lens_get(prob: Any, lens: Lens) -> Any:
    return lens.get(prob)


def lens_set(prob: Any, lens: Lens, value: Any) -> Any:
    """Module-level ``set(prob, lens, value)`` mirroring the reference API."""
    return lens.set(prob, value)
