"""Volatility surfaces: flat vol and rectangular (tenor × strike) surfaces.

Port of ``hedgehog_tpu/market/vol_surface.py`` (reference
src/market_inputs/vol_surface.jl); the SVI surface lives in ``svi.py`` and
looks up through :func:`get_vol_yf` as these do.  The rectangular
surface stores its vol grid directly; a lookup runs the nested 1-D
interpolation of the reference Interpolator2D (strike first, then tenor)
with constant extrapolation on both axes, recomputed at every lookup, so
bumping one grid vol (``VolLens``) is differentiable.  The price-calibrating
constructor is ``calibration.implied.rect_vol_surface_from_prices``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from ..core.dates import ACT365F, to_ticks, yearfrac
from ..math.interpolation import interp2d_nested
from ..utils import device_of, f64

__all__ = [
    "FlatVolSurface",
    "RectVolSurface",
    "Interpolator2D",
    "get_vol",
    "get_vol_yf",
    "spine_strikes",
    "spine_vols",
    "surface_spine_tenors",
]

_frozen = dataclasses.dataclass(frozen=True)


@_frozen
class Interpolator2D:
    """Rectangular 2-D interpolator, nested y-then-x (reference
    Interpolator2D, vol_surface.jl:12-57): ``itp[x, y]`` evaluates with
    constant extrapolation."""

    x_vals: Any
    y_vals: Any
    values: Any  # (len(x_vals), len(y_vals))
    interp_x: str = "linear"
    interp_y: str = "linear"

    def __getitem__(self, key):
        x, y = key
        return interp2d_nested(x, y, self.x_vals, self.y_vals, self.values,
                               kind_x=self.interp_x, kind_y=self.interp_y)

    def __call__(self, x, y):
        return self[x, y]


@_frozen
class FlatVolSurface:
    """Constant volatility surface (vol_surface.jl:73-98)."""

    sigma: Any
    reference_date: Any = 0

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))


@_frozen
class RectVolSurface:
    """Rectangular (tenor × strike) implied-vol surface
    (vol_surface.jl:105-151): ``tenors`` are year fractions from
    ``reference_date``, ``vols`` has shape (len(tenors), len(strikes))."""

    reference_date: Any
    tenors: Any
    strikes: Any
    vols: Any
    interp_time: str = "linear"
    interp_strike: str = "linear"
    daycount: Any = ACT365F

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))

    @property
    def interpolator(self) -> Interpolator2D:
        return Interpolator2D(self.tenors, self.strikes, self.vols,
                              interp_x=self.interp_time, interp_y=self.interp_strike)

    def with_vols(self, vols) -> "RectVolSurface":
        return RectVolSurface(self.reference_date, self.tenors, self.strikes, vols,
                              interp_time=self.interp_time, interp_strike=self.interp_strike)


AnyVolSurface = Union[FlatVolSurface, RectVolSurface]


def get_vol_yf(surface: AnyVolSurface, t, strike):
    """Vol lookup with the time to expiry in year fractions
    (vol_surface.jl:96-98, :178-180); an ``SVIVolSurface`` evaluates its
    slices."""
    if isinstance(surface, FlatVolSurface):
        return surface.sigma
    if isinstance(surface, RectVolSurface):
        return interp2d_nested(t, strike, surface.tenors, surface.strikes, surface.vols,
                               kind_x=surface.interp_time, kind_y=surface.interp_strike)
    from .svi import SVIVolSurface

    if isinstance(surface, SVIVolSurface):
        return surface.vol_yf(t, strike)
    raise TypeError(f"not a vol surface the port has: {type(surface).__name__}")


def spine_strikes(surface: RectVolSurface) -> torch.Tensor:
    """Strike grid of a rect surface (reference export, src/Hedgehog.jl:75)."""
    return f64(surface.strikes, device=device_of(surface.strikes))


def spine_vols(surface: AnyVolSurface) -> torch.Tensor:
    """Vol grid (rect) or constant vol (flat)."""
    if isinstance(surface, FlatVolSurface):
        return f64(surface.sigma, device=device_of(surface.sigma)).reshape(1, 1)
    return f64(surface.vols, device=device_of(surface.vols))


def surface_spine_tenors(surface: RectVolSurface) -> torch.Tensor:
    """Tenor grid of a rect surface (year fractions from its reference date)."""
    return f64(surface.tenors, device=device_of(surface.tenors))


def get_vol(surface: AnyVolSurface, expiry, strike):
    """Vol lookup at an expiry in ticks or as a date (vol_surface.jl:87-89,
    :158-171)."""
    if isinstance(surface, FlatVolSurface):
        return surface.sigma
    t = yearfrac(surface.reference_date, to_ticks(expiry), surface.daycount)
    return get_vol_yf(surface, t, strike)
