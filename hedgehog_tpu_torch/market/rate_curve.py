"""Flat zero curve with discount-factor and zero-rate accessors.

Port of the flat-curve part of ``hedgehog_tpu/market/rate_curve.py``
(reference src/market_inputs/rate_curve.jl:35-38, :149-208).  Accessors
return float64 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.dates import ACT365F, to_ticks, yearfrac
from ..utils import f64

__all__ = ["FlatRateCurve", "df", "df_yf", "zero_rate", "zero_rate_yf"]


@dataclasses.dataclass(frozen=True)
class FlatRateCurve:
    """Constant continuously-compounded zero rate.  ``daycount`` sets the
    date→year-fraction convention of the date-taking accessors."""

    reference_date: Any
    rate: Any
    daycount: Any = ACT365F

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))


def zero_rate_yf(curve: FlatRateCurve, yf) -> torch.Tensor:
    """Zero rate at a year fraction (rate_curve.jl:207-208)."""
    if not isinstance(curve, FlatRateCurve):
        raise TypeError(f"the port has flat rate curves only; got {type(curve).__name__}")
    return torch.broadcast_to(f64(curve.rate), f64(yf).shape)


def zero_rate(curve: FlatRateCurve, t) -> torch.Tensor:
    """Zero rate at a tick timestamp or date (rate_curve.jl:182-197)."""
    return zero_rate_yf(curve, yearfrac(curve.reference_date, to_ticks(t), curve.daycount))


def df_yf(curve: FlatRateCurve, yf) -> torch.Tensor:
    """Discount factor from a year fraction (rate_curve.jl:171-172)."""
    return torch.exp(-zero_rate_yf(curve, yf) * f64(yf))


def df(curve: FlatRateCurve, t) -> torch.Tensor:
    """Discount factor at a tick timestamp or date (rate_curve.jl:149-161)."""
    return df_yf(curve, yearfrac(curve.reference_date, to_ticks(t), curve.daycount))
