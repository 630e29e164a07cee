"""SABR: Hagan et al. (2002) lognormal implied vol and its Black price.

Port of ``hedgehog_tpu/methods/sabr.py``:

    σ(F, K) = A · (z/x(z)) · B(T)
    A   = α / [(FK)^{(1−β)/2} · (1 + (1−β)²/24·L² + (1−β)⁴/1920·L⁴)]
    z   = (ν/α) (FK)^{(1−β)/2} L,   L = ln(F/K)
    x(z)= ln[(√(1−2ρz+z²) + z − ρ)/(1−ρ)]
    B   = 1 + [(1−β)²α²/(24 (FK)^{1−β}) + ρβνα/(4 (FK)^{(1−β)/2})
               + (2−3ρ²)ν²/24]·T

with z/x(z) → 1 at z → 0 taken by its exact series 1 − ρz/2 +
(2 − 3ρ²)z²/12 below |z| = 1e-5 (a double ``torch.where``: the ratio is
0/0 at z = 0).  The price is the Black formula at that vol, smooth in α, ρ,
ν, spot and strike.  Hagan's expansion is itself approximate: good to
~1e-3 relative at moderate ν²T and smile width, and exact at the β = 1,
ν = 0 corner (σ = α).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.payoffs import European, VanillaOption
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import forward_spot, market_yearfrac
from ..market.rate_curve import df
from ..models.dynamics import SABRDynamics
from ..utils import f64, resolve_device
from .black_scholes import _tensors, bs_price

__all__ = ["SABRAnalytic", "hagan_vol"]


@dataclasses.dataclass(frozen=True)
class SABRAnalytic(AbstractPricingMethod):
    """Black price at Hagan's SABR lognormal implied vol, for European
    vanillas on :class:`~hedgehog_tpu_torch.market.inputs.SABRInputs`
    markets, computed on ``device``."""

    device: str = "cuda"

    @property
    def dynamics(self):
        return SABRDynamics()


def hagan_vol(forward, strike, T, alpha, beta, rho, nu) -> torch.Tensor:
    """Hagan et al. (2002) lognormal SABR implied vol, vectorised and
    branchless; ``beta`` a number."""
    forward, strike, T, alpha, rho, nu = _tensors(forward, strike, T, alpha, rho, nu)
    L = torch.log(forward / strike)
    omb = 1.0 - beta
    fk_pow = (forward * strike) ** (0.5 * omb)
    denom = fk_pow * (1.0 + omb**2 / 24.0 * L**2 + omb**4 / 1920.0 * L**4)
    a_term = alpha / denom

    z = (nu / torch.clamp(alpha, min=1e-30)) * fk_pow * L
    small = torch.abs(z) < 1e-5
    z_safe = torch.where(small, 1.0, z)
    x = torch.log((torch.sqrt(1.0 - 2.0 * rho * z_safe + z_safe**2) + z_safe - rho)
                  / (1.0 - rho))
    zx = torch.where(small, 1.0 - 0.5 * rho * z + (2.0 - 3.0 * rho**2) / 12.0 * z**2,
                     z_safe / x)
    b_term = 1.0 + (omb**2 / 24.0 * alpha**2 / fk_pow**2
                    + 0.25 * rho * beta * nu * alpha / fk_pow
                    + (2.0 - 3.0 * rho**2) / 24.0 * nu**2) * T
    return a_term * zx * b_term


@register_solver(SABRAnalytic)
def _solve_sabr_analytic(prob: PricingProblem, method: SABRAnalytic) -> AnalyticSolution:
    payoff = prob.payoff
    if not isinstance(payoff, VanillaOption):
        raise TypeError(
            f"SABRAnalytic prices European VanillaOption (Hagan's expansion "
            f"is an implied-vol formula); got {type(payoff).__name__}"
        )
    if not isinstance(payoff.exercise_style, European):
        raise TypeError("SABRAnalytic is European-only")
    market = prob.market_inputs
    dev = resolve_device(method.device)
    T = f64(market_yearfrac(market, payoff.expiry), device=dev)
    D = f64(df(market.rate, payoff.expiry), device=dev)
    F = forward_spot(market, T, device=dev) / D  # the carry-adjusted T-forward
    K = f64(payoff.strike, device=dev)
    vol = hagan_vol(F, K, T, f64(market.alpha, device=dev), market.beta,
                    f64(market.rho, device=dev), f64(market.nu, device=dev))
    return AnalyticSolution(prob, method, bs_price(F, K, vol, T, D, payoff.call_put()))
