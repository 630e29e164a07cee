"""Dupire local volatility from an implied-vol surface.

Port of ``hedgehog_tpu/models/local_vol.py``.  In Gatheral's total-variance
form, with w(t, y) = σ_imp(K, t)²·t on log-moneyness y = ln(K/F_t),

    σ_loc² = ∂_t w / [1 − (y/w)·∂_y w
                      + ¼(−¼ − 1/w + y²/w²)(∂_y w)²
                      + ½·∂²_yy w]

with every derivative the exact autograd derivative of the interpolated
surface (cubic strike interpolation makes ∂²_yy meaningful).  t and y enter
w as nodes of their own, so one ``torch.autograd.grad`` of the sum over
independent entries gives every entry's partials at once; a second gives
∂²_yy.  The denominator and ∂_t w are floored: an interpolated surface can
break no-arbitrage locally, and a floored local vol keeps the engines
defined.  A flat surface returns σ exactly.

The call enables autograd locally, so it works inside ``torch.no_grad()``,
where it returns a tensor with no graph, as it does when nothing it reads
requires grad; otherwise the result keeps its graph to spot, rate and
surface, so greeks flow through it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..market.inputs import carry_yield
from ..market.rate_curve import df_yf
from ..market.svi import SVIVolSurface
from ..market.vol_surface import FlatVolSurface, get_vol_yf
from ..utils import device_of, f64

__all__ = ["dupire_local_vol"]

#: floors: w below this reads as the short-expiry limit; a Dupire
#: denominator below this flags a local butterfly violation of the
#: interpolated surface and is floored rather than let blow up
_W_FLOOR = 1e-8
_DENOM_FLOOR = 1e-3
_T_FLOOR = 1e-4


def _forward(market, t, dev) -> torch.Tensor:
    """F(t) = spot·e^{−qt}/D(t)."""
    q = f64(carry_yield(market), device=dev)
    return f64(market.spot, device=dev) * torch.exp(-q * t) / df_yf(market.rate, t).to(dev)


def _total_variance(market, t, y, dev) -> torch.Tensor:
    """w(t, y) entry by entry: K = F(t)·e^y at each entry's own t."""
    k = _forward(market, t, dev) * torch.exp(y)
    surf = market.sigma
    sig = surf.vol_paired(t, k) if isinstance(surf, SVIVolSurface) else get_vol_yf(surf, t, k)
    return sig * sig * t


def _grad(out, wrt, create_graph: bool) -> torch.Tensor:
    """∂(Σ out)/∂wrt, zeros where ``out`` does not reach ``wrt``."""
    if not out.requires_grad:
        return torch.zeros_like(wrt)
    return torch.autograd.grad(out.sum(), wrt, create_graph=create_graph,
                               materialize_grads=True)[0]


def _tracks_grad(market, strike) -> bool:
    """True when a tensor the local vol depends on requires grad: the
    strike, spot, carry, or a field of the rate curve or of the surface."""
    leaves = [strike, market.spot, carry_yield(market)]
    for obj in (market.rate, market.sigma):
        leaves += [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return any(isinstance(x, torch.Tensor) and x.requires_grad for x in leaves)


def dupire_local_vol(market, t, strike):
    """σ_loc(strike, t) from ``market``'s implied-vol surface (the Dupire /
    Gatheral total-variance form, exact autograd surface derivatives).
    ``t`` and ``strike`` broadcast (one entry a path or a grid node); a flat
    surface returns σ."""
    if isinstance(market.sigma, FlatVolSurface):
        return market.sigma.sigma
    dev = device_of(t, strike, market.spot)
    t, strike = torch.broadcast_tensors(f64(t, device=dev), f64(strike, device=dev))
    t = torch.clamp(t.detach(), min=_T_FLOOR)
    keep_graph = torch.is_grad_enabled() and _tracks_grad(market, strike)
    with torch.enable_grad():
        y = torch.log(strike / _forward(market, t, dev))
        if not y.requires_grad:
            y = y.detach().requires_grad_(True)
        t_node = t.clone().requires_grad_(True)
        w = _total_variance(market, t_node, y, dev)
        dw_dt, dw_dy = torch.autograd.grad(w.sum(), (t_node, y), create_graph=True,
                                           materialize_grads=True)
        d2w_dy2 = _grad(dw_dy, y, keep_graph)
        w_s = torch.clamp(w, min=_W_FLOOR)
        denom = (1.0 - (y / w_s) * dw_dy
                 + 0.25 * (-0.25 - 1.0 / w_s + (y / w_s) ** 2) * dw_dy**2
                 + 0.5 * d2w_dy2)
        var = torch.clamp(dw_dt, min=_W_FLOOR) / torch.clamp(denom, min=_DENOM_FLOOR)
        sig = torch.sqrt(var)
    return sig if keep_graph else sig.detach()
