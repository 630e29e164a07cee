"""Closed-form Black-Scholes for European vanillas — the sanity anchor.

Port of ``BlackScholesAnalytic`` and ``bs_price`` from
``hedgehog_tpu/methods/black_scholes.py`` (reference black_scholes.jl).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.payoffs import VanillaOption, require_european
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import forward_spot, market_yearfrac
from ..market.rate_curve import df
from ..market.vol_surface import get_vol
from ..utils import f64

__all__ = ["BlackScholesAnalytic", "bs_price"]


@dataclasses.dataclass(frozen=True)
class BlackScholesAnalytic(AbstractPricingMethod):
    """Closed-form Black-Scholes for European vanilla options."""


def _ncdf(x: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr(x)


def bs_price(forward, strike, vol, T, discount, cp) -> torch.Tensor:
    """Black formula on the T-forward, branchless:
    price = D·cp·(F·N(cp·d1) − K·N(cp·d2)); σ == 0 or T == 0 gives the
    discounted intrinsic value."""
    forward, strike, vol, T, discount = (f64(x) for x in (forward, strike, vol, T, discount))
    sqrtT = torch.sqrt(T)
    sigma_safe = torch.where(vol > 0, vol, 1.0)
    d1 = (torch.log(forward / strike) + 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    d2 = d1 - sigma_safe * sqrtT
    bs = discount * cp * (forward * _ncdf(cp * d1) - strike * _ncdf(cp * d2))
    intrinsic = discount * torch.clamp(cp * (forward - strike), min=0.0)
    return torch.where((vol > 0) & (T > 0), bs, intrinsic)


@register_solver(BlackScholesAnalytic)
def _solve_bs_analytic(prob: PricingProblem, method: BlackScholesAnalytic) -> AnalyticSolution:
    payoff = prob.payoff
    market = prob.market_inputs
    require_european(payoff, "BlackScholesAnalytic")
    if not isinstance(payoff, VanillaOption):
        raise TypeError(f"the port prices vanillas only; got {type(payoff).__name__}")
    T = market_yearfrac(market, payoff.expiry)
    D = df(market.rate, payoff.expiry)
    F = forward_spot(market, T) / D
    sigma = get_vol(market.sigma, payoff.expiry, payoff.strike)
    price = bs_price(F, payoff.strike, sigma, T, D, payoff.call_put())
    return AnalyticSolution(prob, method, price)
