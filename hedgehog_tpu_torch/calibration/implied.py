"""Implied volatility: scalar and batched (whole-surface) inversion.

Port of ``hedgehog_tpu/calibration/implied.py`` (the reference's
``price_to_iv`` / ``iv_to_price``, vol_quotes.jl:495-551, and the
calibrating ``RectVolSurface`` constructor, vol_surface.jl:188-242): one
vectorised bisection inverts a whole tensor of Black-Scholes prices on the
bracket (1e-6, 5.0) of calibration.jl:143, with IFT gradients
(``math.rootfind.implicit_root``).  Every function computes on the device of
the tensors it is given.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.dates import to_ticks, yearfrac
from ..core.payoffs import CallPut
from ..market.rate_curve import FlatRateCurve, RateCurve, zero_rate_yf
from ..market.vol_surface import RectVolSurface
from ..math.rootfind import implicit_root
from ..methods.black_scholes import bs_price
from ..utils import device_of, f64

__all__ = ["implied_vol", "implied_vol_bs", "iv_to_price_bs", "rect_vol_surface_from_prices"]

IV_BRACKET = (1e-6, 5.0)


def iv_to_price_bs(iv, strike, T, spot, rate, cp=1.0):
    """Black-Scholes price from a vol at a flat ``rate`` (ACT/365 ``T``),
    over any broadcastable batch of arguments."""
    dev = device_of(iv, strike, T, spot, rate, cp)
    T, rate, spot = f64(T, device=dev), f64(rate, device=dev), f64(spot, device=dev)
    D = torch.exp(-rate * T)
    F = spot / D
    return bs_price(F, strike, iv, T, D, cp)


def implied_vol_bs(price, strike, T, spot, rate, cp=1.0, *, iters: int = 80):
    """Batched Black-Scholes implied vol with IFT gradients: ``price``,
    ``strike``, ``T`` and ``cp`` broadcast, and one bisection inverts the
    whole grid."""
    dev = device_of(price, strike, T, spot, rate, cp)
    price, strike, T, cp = torch.broadcast_tensors(
        *(f64(x, device=dev) for x in (price, strike, T, cp)))

    def f(sigma):
        return iv_to_price_bs(sigma, strike, T, spot, rate, cp) - price

    lo = torch.full(price.shape, IV_BRACKET[0], dtype=torch.float64, device=dev)
    hi = torch.full(price.shape, IV_BRACKET[1], dtype=torch.float64, device=dev)
    return implicit_root(f, lo, hi, iters=iters)


def rect_vol_surface_from_prices(
    reference_date,
    rate,
    spot,
    tenors,
    strikes,
    prices,
    *,
    call_put_matrix: Optional[Any] = None,
    interp_time: str = "linear",
    interp_strike: str = "linear",
) -> RectVolSurface:
    """A RectVolSurface implied from an option price grid, in one batched
    solve.  ``tenors`` are ACT/365 year fractions from ``reference_date``,
    or dates; ``rate`` is a number, a FlatRateCurve or a RateCurve (each
    tenor's zero rate enters its row); ``prices`` has shape (len(tenors),
    len(strikes)); ``call_put_matrix`` holds ±1 or Call()/Put() (all calls
    by default, vol_surface.jl:207-208)."""
    ref_ticks = to_ticks(reference_date)
    dev = device_of(tenors, strikes, prices, spot)
    if isinstance(tenors, torch.Tensor):
        tenors = f64(tenors, device=dev)
    else:
        tenors = f64([yearfrac(ref_ticks, to_ticks(t)) if hasattr(t, "year") else float(t)
                      for t in tenors], device=dev)
    strikes = f64(strikes, device=dev)
    prices = f64(prices, device=dev)
    n_t, n_k = tenors.shape[0], strikes.shape[0]
    if prices.shape != (n_t, n_k):
        raise ValueError("Price matrix size must match (len(tenors), len(strikes))")
    if call_put_matrix is None:
        cp = torch.ones((n_t, n_k), dtype=torch.float64, device=dev)
    else:
        cp = f64([[x() if isinstance(x, CallPut) else x for x in row] for row in call_put_matrix],
                 device=dev)
    if isinstance(rate, FlatRateCurve):
        rate_val = rate.rate
    elif isinstance(rate, RateCurve):
        rate_val = zero_rate_yf(rate, tenors)[:, None]
    else:
        rate_val = rate
    T_grid = torch.broadcast_to(tenors[:, None], (n_t, n_k))
    K_grid = torch.broadcast_to(strikes[None, :], (n_t, n_k))
    vols = implied_vol_bs(prices, K_grid, T_grid, spot, rate_val, cp)
    return RectVolSurface(ref_ticks, tenors, strikes, vols, interp_time=interp_time,
                          interp_strike=interp_strike)


# the reference exports `implied_vol` (src/Hedgehog.jl:79) without defining it:
# here it is the batched Black-Scholes inversion
implied_vol = implied_vol_bs
