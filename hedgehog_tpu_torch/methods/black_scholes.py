"""Closed-form Black-Scholes for European vanillas — the sanity anchor.

Port of ``BlackScholesAnalytic``, ``bs_price`` and ``bs_geometry`` from
``hedgehog_tpu/methods/black_scholes.py`` (reference black_scholes.jl).
``BlackScholesAnalytic.device`` names where the price is computed, the GPU
unless the caller asks for the CPU; ``bs_price`` computes on the device of
the tensors it is given.
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
from ..utils import device_of, f64, resolve_device

__all__ = ["BlackScholesAnalytic", "bs_price", "bs_geometry"]


@dataclasses.dataclass(frozen=True)
class BlackScholesAnalytic(AbstractPricingMethod):
    """Closed-form Black-Scholes for European vanilla options, computed on
    ``device``."""

    device: str = "cuda"


def _ncdf(x: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr(x)


def bs_price(forward, strike, vol, T, discount, cp) -> torch.Tensor:
    """Black formula on the T-forward, branchless:
    price = D·cp·(F·N(cp·d1) − K·N(cp·d2)); σ == 0 or T == 0 gives the
    discounted intrinsic value."""
    dev = device_of(forward, strike, vol, T, discount, cp)
    forward, strike, vol, T, discount, cp = (
        f64(x, device=dev) for x in (forward, strike, vol, T, discount, cp))
    sqrtT = torch.sqrt(T)
    sigma_safe = torch.where(vol > 0, vol, 1.0)
    d1 = (torch.log(forward / strike) + 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    d2 = d1 - sigma_safe * sqrtT
    bs = discount * cp * (forward * _ncdf(cp * d1) - strike * _ncdf(cp * d2))
    intrinsic = discount * torch.clamp(cp * (forward - strike), min=0.0)
    return torch.where((vol > 0) & (T > 0), bs, intrinsic)


def bs_geometry(prob: PricingProblem, device=None):
    """(T, K, σ, D, F, √T, d1, d2) on ``device`` (by default the device of
    the spot and strike): the one place the pricer and the analytic greeks
    read the market, the vol looked up from the surface's own reference
    date as the pricer does."""
    payoff = prob.payoff
    market = prob.market_inputs
    if device is None:
        device = device_of(market.spot, payoff.strike)
    K = f64(payoff.strike, device=device)
    sigma = f64(get_vol(market.sigma, payoff.expiry, payoff.strike), device=device)
    T = f64(market_yearfrac(market, payoff.expiry), device=device)
    D = f64(df(market.rate, payoff.expiry), device=device)
    F = forward_spot(market, T, device=device) / D  # carry-adjusted T-forward
    sqrtT = torch.sqrt(T)
    sigma_safe = torch.where(sigma > 0, sigma, 1.0)
    d1 = (torch.log(F / K) + 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    d2 = d1 - sigma_safe * sqrtT
    return T, K, sigma, D, F, sqrtT, d1, d2


@register_solver(BlackScholesAnalytic)
def _solve_bs_analytic(prob: PricingProblem, method: BlackScholesAnalytic) -> AnalyticSolution:
    payoff = prob.payoff
    require_european(payoff, "BlackScholesAnalytic")
    if not isinstance(payoff, VanillaOption):
        raise TypeError(f"the port prices vanillas only; got {type(payoff).__name__}")
    T, K, sigma, D, F, _, _, _ = bs_geometry(prob, resolve_device(method.device))
    price = bs_price(F, K, sigma, T, D, payoff.call_put())
    return AnalyticSolution(prob, method, price)
