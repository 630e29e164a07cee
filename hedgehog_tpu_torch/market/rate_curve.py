"""Rate curves: flat and interpolated zero curves with discount-factor,
zero-rate and forward-rate accessors.

Port of ``hedgehog_tpu/market/rate_curve.py`` (reference
src/market_inputs/rate_curve.jl).  An interpolated curve stores its
zero-rate spine directly (year-fraction tenors and zero rates); the
interpolation is recomputed at every lookup, so bumping a spine point
(``ZeroRateSpineLens``) stays differentiable.  Accessors return float64
tensors on :func:`~hedgehog_tpu_torch.utils.device_of` the curve's and the
query's tensors.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any, Union

import numpy as np
import torch

from ..core.dates import ACT365F, to_ticks, yearfrac
from ..math.interpolation import interp1d
from ..utils import device_of, f64

__all__ = [
    "RateCurve",
    "FlatRateCurve",
    "df",
    "df_yf",
    "zero_rate",
    "zero_rate_yf",
    "forward_rate",
    "spine_tenors",
    "spine_zeros",
    "is_flat",
]


@dataclasses.dataclass(frozen=True)
class FlatRateCurve:
    """Constant continuously-compounded zero rate.  ``daycount`` sets the
    date→year-fraction convention of the date-taking accessors."""

    reference_date: Any
    rate: Any
    daycount: Any = ACT365F

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))


@dataclasses.dataclass(frozen=True)
class RateCurve:
    """Interpolated zero curve over year-fraction tenors (rate_curve.jl:20-24).

    Build it from discount factors with :meth:`from_dfs` (the validated
    ``zr = −log(dfs)/tenors`` constructor, rate_curve.jl:72-97), or directly
    from a zero-rate spine (the path lenses and calibration rebuild on)."""

    reference_date: Any
    tenors: Any
    zero_rates: Any
    interp: str = "linear"
    daycount: Any = ACT365F

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))

    @classmethod
    def from_dfs(cls, reference_date, tenors, dfs, *, interp: str = "linear") -> "RateCurve":
        tenors_np = np.asarray(tenors, dtype=np.float64)
        dfs_np = np.asarray(dfs, dtype=np.float64)
        if tenors_np.size == 0:
            raise ValueError("Input 'tenors' cannot be empty.")
        if tenors_np.shape != dfs_np.shape:
            raise ValueError("Mismatched lengths for 'tenors' and 'dfs'.")
        if not np.all(np.diff(tenors_np) > 0):
            raise ValueError("'tenors' must be sorted strictly increasing.")
        if tenors_np[0] <= 0:
            # a zero tenor would give a NaN/Inf spine point
            raise ValueError("First tenor must be positive.")
        if not np.all(dfs_np > 0):
            raise ValueError("All discount factors must be positive.")
        dev = device_of(tenors, dfs)
        tenors_t, dfs_t = f64(tenors, device=dev), f64(dfs, device=dev)
        return cls(to_ticks(reference_date), tenors_t, -torch.log(dfs_t) / tenors_t, interp=interp)

    def with_zero_rates(self, zero_rates) -> "RateCurve":
        """Functional rebuild with a new zero-rate spine (the lens-set path)."""
        return RateCurve(self.reference_date, self.tenors, zero_rates, interp=self.interp)


AnyRateCurve = Union[RateCurve, FlatRateCurve]


def zero_rate_yf(curve: AnyRateCurve, yf) -> torch.Tensor:
    """Zero rate at a year fraction (rate_curve.jl:207-208)."""
    if isinstance(curve, FlatRateCurve):
        dev = device_of(curve.rate, yf)
        return torch.broadcast_to(f64(curve.rate, device=dev), f64(yf, device=dev).shape)
    if isinstance(curve, RateCurve):
        return interp1d(yf, curve.tenors, curve.zero_rates, kind=curve.interp)
    raise TypeError(f"not a rate curve: {type(curve).__name__}")


def zero_rate(curve: AnyRateCurve, t) -> torch.Tensor:
    """Zero rate at a tick timestamp or date (rate_curve.jl:182-197)."""
    return zero_rate_yf(curve, yearfrac(curve.reference_date, to_ticks(t), curve.daycount))


def df_yf(curve: AnyRateCurve, yf) -> torch.Tensor:
    """Discount factor from a year fraction (rate_curve.jl:171-172)."""
    z = zero_rate_yf(curve, yf)
    return torch.exp(-z * f64(yf, device=z.device))


def df(curve: AnyRateCurve, t) -> torch.Tensor:
    """Discount factor at a tick timestamp or date (rate_curve.jl:149-161)."""
    return df_yf(curve, yearfrac(curve.reference_date, to_ticks(t), curve.daycount))


def forward_rate(curve: AnyRateCurve, t1, t2) -> torch.Tensor:
    """Continuously-compounded forward rate between two year fractions or
    dates (rate_curve.jl:220-241); dates convert independently."""
    if isinstance(t1, (_dt.date, _dt.datetime)):
        t1 = yearfrac(curve.reference_date, t1, curve.daycount)
    if isinstance(t2, (_dt.date, _dt.datetime)):
        t2 = yearfrac(curve.reference_date, t2, curve.daycount)
    if isinstance(t1, (int, float)) and isinstance(t2, (int, float)) and t1 >= t2:
        raise ValueError("Start time must be before end time.")
    df1 = df_yf(curve, t1)
    df2 = df_yf(curve, t2)
    return torch.log(df1 / df2) / (f64(t2, device=df2.device) - f64(t1, device=df2.device))


def spine_tenors(curve: AnyRateCurve) -> torch.Tensor:
    """x-values of the interpolator (rate_curve.jl:253; flat fallback :60)."""
    if isinstance(curve, FlatRateCurve):
        return f64([0.0], device=device_of(curve.rate))
    return f64(curve.tenors, device=device_of(curve.tenors))


def is_flat(curve: AnyRateCurve) -> bool:
    """True for constant-rate curves (reference export, src/Hedgehog.jl:72)."""
    return isinstance(curve, FlatRateCurve)


def spine_zeros(curve: AnyRateCurve) -> torch.Tensor:
    """y-values of the interpolator (rate_curve.jl:263; flat fallback :59)."""
    if isinstance(curve, FlatRateCurve):
        return f64(curve.rate, device=device_of(curve.rate)).reshape(1)
    return f64(curve.zero_rates, device=device_of(curve.zero_rates))
