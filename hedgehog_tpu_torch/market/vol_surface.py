"""Flat volatility surface (port of the flat part of
``hedgehog_tpu/market/vol_surface.py``; reference vol_surface.jl:73-98)."""

from __future__ import annotations

import dataclasses
from typing import Any

from ..core.dates import to_ticks

__all__ = ["FlatVolSurface", "get_vol"]


@dataclasses.dataclass(frozen=True)
class FlatVolSurface:
    """Constant volatility surface."""

    sigma: Any
    reference_date: Any = 0

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))


def get_vol(surface: FlatVolSurface, expiry, strike):
    """Vol lookup at an expiry (ticks or date) and strike."""
    if not isinstance(surface, FlatVolSurface):
        raise TypeError(f"the port has flat vol surfaces only; got {type(surface).__name__}")
    return surface.sigma
