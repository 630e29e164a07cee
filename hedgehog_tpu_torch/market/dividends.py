"""Discrete cash dividends: a schedule of (ex-date, cash amount) on a
Black-Scholes market.

Port of ``hedgehog_tpu/market/dividends.py``.  Two model conventions, each
exact for the engines that use it:

- **Escrowed model** (terminal-law engines: ``BlackScholesAnalytic``,
  ``CarrMadan`` under ``LognormalDynamics``, the exact terminal samplers
  and the K13 kernel, the CRR lattice): the stochastic part of the spot is
  S* = S − PV(divs ≤ T), a plain GBM, so every closed form applies with the
  spot replaced by the escrowed spot (:func:`escrowed_spot`, through
  ``market.inputs.forward_spot``).  On the CRR lattice the tree evolves S*
  and exercise decisions see the full spot S*ₜ + PVₜ(remaining divs)
  (Hull's textbook method).
- **Spot (piecewise-lognormal) model** (grid engines: ``PDEMethod`` through
  jump conditions V(t⁻, S) = V(t⁺, S − D), and the log-Euler GBM grid
  through ex-date drops S → max(S − D, floor)): the spot follows GBM
  between ex-dates and drops by the cash amount at each one, the ex-dates
  snapped to the nearest grid time (:func:`dividend_step_amounts`), so the
  PDE and the grid Monte Carlo discretize the same model.

``times`` are int64 ticks held in numpy; ``amounts`` is a float64 tensor
(a gradient reaches it).  Entries at or before the reference date, or after
a pricing expiry, are ignored by every consumer.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.dates import _LinearDayCount, to_ticks, yearfrac
from ..utils import device_of, f64
from .rate_curve import df_yf

__all__ = [
    "DividendSchedule",
    "get_dividends",
    "dividend_yearfracs",
    "dividend_pv",
    "escrowed_spot",
    "remaining_dividend_pv",
    "dividend_step_amounts",
]


@dataclasses.dataclass(frozen=True)
class DividendSchedule:
    """Scheduled cash dividends: ``times`` are ex-dates (dates or ticks, any
    iterable), ``amounts`` the cash drops (float64; a tensor that requires
    grad keeps its history)."""

    times: Any
    amounts: Any

    def __post_init__(self):
        times = self.times
        if isinstance(times, torch.Tensor):
            times = times.detach().cpu().numpy()
        if not hasattr(times, "dtype"):  # a list or tuple of dates or ticks
            times = np.asarray([to_ticks(t) for t in times], dtype=np.int64)
        else:
            times = np.asarray(times, dtype=np.int64)
        if times.ndim != 1:
            raise ValueError("DividendSchedule.times must be 1-D")
        object.__setattr__(self, "times", times)
        amounts = torch.as_tensor(self.amounts, dtype=torch.float64)
        if amounts.ndim != 1 or amounts.shape[0] != times.shape[0]:
            raise ValueError(
                f"DividendSchedule needs matching 1-D times/amounts; got "
                f"{times.shape[0]} times, {tuple(amounts.shape)} amounts"
            )
        object.__setattr__(self, "amounts", amounts)


def get_dividends(market):
    """The market's :class:`DividendSchedule`, or None."""
    return getattr(market, "dividends", None)


def dividend_yearfracs(market, device=None) -> torch.Tensor:
    """Ex-date year fractions (n,) from the market's reference date under
    its day-count convention: linear conventions act on the tick array at
    once, calendar ones (30E/360, ACT/ACT) date by date."""
    divs = get_dividends(market)
    dev = device_of(divs.amounts, market.spot) if device is None else device
    dc = getattr(market, "daycount", None)
    if dc is None or isinstance(dc, _LinearDayCount):
        return f64(yearfrac(market.reference_date, divs.times, dc), device=dev)
    ref = market.reference_date
    return f64([yearfrac(ref, int(t), dc) for t in divs.times], device=dev)


def _amounts(market, device) -> torch.Tensor:
    return get_dividends(market).amounts.to(device)


def dividend_pv(market, T, device=None) -> torch.Tensor:
    """PV at t = 0 of the cash dividends with ex-date in (0, T]:
    Σᵢ Dᵢ·df(tᵢ)·1{0 < tᵢ ≤ T}; entries outside the window add exactly 0."""
    divs = get_dividends(market)
    if divs is None:
        dev = device_of(market.spot, T) if device is None else device
        return torch.zeros((), dtype=torch.float64, device=dev)
    t = dividend_yearfracs(market, device)
    dev = t.device
    T = f64(T, device=dev)
    mask = (t > 0.0) & (t <= T + 1e-12)
    pv = _amounts(market, dev) * df_yf(market.rate, t).to(dev)
    return torch.sum(torch.where(mask, pv, torch.zeros_like(pv)))


def escrowed_spot(market, T, device=None) -> torch.Tensor:
    """The escrowed-model spot S₀ − PV(divs ≤ T).  A non-positive escrowed
    spot has no lognormal model behind it, so it raises ValueError at once
    (one read of the value back to the host per call)."""
    pv = dividend_pv(market, T, device)
    esc = f64(market.spot, device=pv.device) - pv
    val = float(esc.detach())
    if val <= 0.0:
        raise ValueError(
            f"escrowed spot {val:.6g} <= 0: the PV of the dividend schedule "
            f"exceeds the spot, so the escrowed lognormal model is undefined "
            f"for this expiry — trim the schedule or price on the spot-model "
            f"grid engines (PDEMethod / grid Monte Carlo)"
        )
    return esc


def remaining_dividend_pv(market, t_eval, T, device=None) -> torch.Tensor:
    """PV at time ``t_eval`` of the dividends with ex-date in (t_eval, T]:
    Σᵢ Dᵢ·df(tᵢ)/df(t_eval)·1{t_eval < tᵢ ≤ T}.  ``t_eval`` may be a tensor
    (one add-back per lattice time); the schedule is a trailing axis."""
    t = dividend_yearfracs(market, device)
    dev = t.device
    t_eval = f64(t_eval, device=dev)
    te = t_eval[..., None]
    mask = (t > te + 1e-12) & (t <= f64(T, device=dev) + 1e-12)
    pv = _amounts(market, dev) * df_yf(market.rate, t).to(dev)
    pv_each = torch.where(mask, pv, torch.zeros_like(pv))
    return torch.sum(pv_each, dim=-1) / df_yf(market.rate, t_eval).to(dev)


def dividend_step_amounts(market, T, steps: int, device=None) -> torch.Tensor:
    """Per-step cash drops (steps,) on a uniform grid over [0, T]: ex-date
    tᵢ ∈ (0, T] is snapped to the nearest grid time k·ΔT (k ≥ 1, halves
    to even) and slot k − 1 carries its cash, so the grid value at k·ΔT is
    post-drop.  Entries sharing a slot sum."""
    divs = get_dividends(market)
    if divs is None:
        dev = device_of(market.spot, T) if device is None else device
        return torch.zeros((steps,), dtype=torch.float64, device=dev)
    t = dividend_yearfracs(market, device)
    dev = t.device
    T = f64(T, device=dev)
    dt = T / steps
    k = torch.clamp(torch.round(t / dt).to(torch.int64), 1, steps)
    mask = (t > 0.0) & (t <= T + 1e-12)
    amt = _amounts(market, dev)
    amt = torch.where(mask, amt, torch.zeros_like(amt))
    return torch.zeros((steps,), dtype=torch.float64, device=dev).index_add(0, k - 1, amt)
