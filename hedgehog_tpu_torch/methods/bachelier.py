"""Bachelier (normal-model) closed forms on the device.

Port of ``hedgehog_tpu/methods/bachelier.py``.  On the T-forward
F = S₀·e^{−qT}/D(T) with normal vol σ_N (price units):

    d      = (F − K)/(σ_N √T)
    call   = D·[(F − K)·Φ(d) + σ_N √T·φ(d)]
    put    = D·[(K − F)·Φ(−d) + σ_N √T·φ(d)]
    digital call (cash c) = D·c·Φ(d)

σ_N√T = 0 gives the discounted intrinsic through a double ``torch.where``,
so its gradient stays clean.  Strike grids broadcast, and autograd flows in
every market field.  ``implied_normal_vol`` inverts the vanilla form with
the batched bracketed root of ``math/rootfind.py``, whose gradient is the
implicit-function-theorem one.  ``BachelierAnalytic.device`` names where
the price is computed, the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.payoffs import DigitalOption, European, VanillaOption
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import forward_spot, market_yearfrac
from ..market.rate_curve import df
from ..models.dynamics import NormalDynamics
from ..utils import f64, resolve_device
from .black_scholes import _ncdf, _npdf, _tensors

__all__ = ["BachelierAnalytic", "bachelier_price", "bachelier_digital_price",
           "implied_normal_vol"]


@dataclasses.dataclass(frozen=True)
class BachelierAnalytic(AbstractPricingMethod):
    """Bachelier closed forms for European vanillas and cash-or-nothing
    digitals on :class:`~hedgehog_tpu_torch.market.inputs.BachelierInputs`
    markets, computed on ``device``."""

    device: str = "cuda"

    @property
    def dynamics(self):
        return NormalDynamics()


def bachelier_price(forward, strike, vol, T, discount, cp) -> torch.Tensor:
    """Bachelier vanilla price, branchless; ``vol`` is the normal vol in
    price units per √year.  σ√T = 0 gives the discounted intrinsic."""
    forward, strike, vol, T, discount, cp = _tensors(forward, strike, vol, T, discount, cp)
    sd = vol * torch.sqrt(T)
    ok = sd > 0.0
    sd_safe = torch.where(ok, sd, 1.0)
    d = cp * (forward - strike) / sd_safe
    live = sd * _npdf(d) + cp * (forward - strike) * _ncdf(d)
    m = cp * (forward - strike)
    intrinsic = torch.maximum(m, torch.zeros_like(m))
    return discount * torch.where(ok, live, intrinsic)


def bachelier_digital_price(forward, strike, vol, T, discount, cp, cash=1.0) -> torch.Tensor:
    """Cash-or-nothing digital under the normal model: D·cash·Φ(cp·d)."""
    forward, strike, vol, T, discount, cp, cash = _tensors(forward, strike, vol, T, discount,
                                                           cp, cash)
    sd = vol * torch.sqrt(T)
    ok = sd > 0.0
    sd_safe = torch.where(ok, sd, 1.0)
    d = cp * (forward - strike) / sd_safe
    intrinsic = (cp * (forward - strike) > 0.0).to(torch.float64)
    return discount * cash * torch.where(ok, _ncdf(d), intrinsic)


def implied_normal_vol(price, forward, strike, T, discount, cp, iters: int = 80):
    """Normal implied vol from a discounted premium (the convention of
    :func:`bachelier_price` and of ``solve(...).price``): bisection on
    [0, 8·(TV + |F − K|)/√T], which holds the root of every attainable
    price (the ATM time value σ√T·φ(0) bounds σ below 2.51·TV/√T), then the
    implicit-function-theorem polish, so the result is differentiable in
    price, forward, strike and discount."""
    from ..math.rootfind import implicit_root

    price, forward, strike, T, discount, cp = _tensors(price, forward, strike, T, discount, cp)
    m = cp * (forward - strike)
    tv = price / discount - torch.maximum(m, torch.zeros_like(m))
    hi = 8.0 * (tv + torch.abs(forward - strike) + 1e-12) / torch.sqrt(T)

    def f(sigma_n):
        return bachelier_price(forward, strike, sigma_n, T, discount, cp) - price

    return implicit_root(f, torch.zeros_like(hi), hi.detach(), iters=iters)


@register_solver(BachelierAnalytic)
def _solve_bachelier(prob: PricingProblem, method: BachelierAnalytic) -> AnalyticSolution:
    payoff = prob.payoff
    if not isinstance(payoff, (VanillaOption, DigitalOption)):
        raise TypeError(
            f"BachelierAnalytic prices European vanillas and digitals; "
            f"{type(payoff).__name__} has no normal-model closed form here"
        )
    if not isinstance(payoff.exercise_style, European):
        raise TypeError(
            "BachelierAnalytic is European-only (use LSM on the Bachelier "
            "grid for early exercise)"
        )
    market = prob.market_inputs
    dev = resolve_device(method.device)
    T = f64(market_yearfrac(market, payoff.expiry), device=dev)
    D = f64(df(market.rate, payoff.expiry), device=dev)
    F = forward_spot(market, T, device=dev) / D  # the carry-adjusted T-forward
    K = f64(payoff.strike, device=dev)
    sigma = f64(market.sigma, device=dev)
    cp = payoff.call_put()
    if isinstance(payoff, DigitalOption):
        price = bachelier_digital_price(F, K, sigma, T, D, cp, f64(payoff.cash, device=dev))
    else:
        price = bachelier_price(F, K, sigma, T, D, cp)
    return AnalyticSolution(prob, method, price)
