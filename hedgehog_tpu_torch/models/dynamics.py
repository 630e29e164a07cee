"""Price dynamics markers, the lognormal terminal law and the characteristic
functions of log S_T, in native complex128.

Port of the Black-Scholes, Heston and rough-Bergomi parts of
``hedgehog_tpu/models/dynamics.py`` (reference montecarlo.jl:286-320 and
src/distributions/heston.jl:307-319).  The JAX package also carries a
split real/imaginary form for the TPU, which has no complex128; the port
does not need it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import zero_rate
from ..utils import f64

__all__ = [
    "LognormalDynamics",
    "HestonDynamics",
    "RoughBergomiDynamics",
    "lognormal_terminal_law",
    "lognormal_cf",
    "heston_cf",
    "terminal_log_cf",
]


@dataclasses.dataclass(frozen=True)
class LognormalDynamics:
    """Geometric Brownian motion (Black-Scholes)."""


@dataclasses.dataclass(frozen=True)
class HestonDynamics:
    """Heston stochastic volatility (CIR variance)."""


@dataclasses.dataclass(frozen=True)
class RoughBergomiDynamics:
    """Rough Bergomi (Bayer–Friz–Gatheral 2016): no characteristic function,
    so Monte Carlo is its only pricer (models/rough_bergomi.py).  Markets
    carry :class:`~hedgehog_tpu_torch.market.inputs.RoughBergomiInputs`."""


def _c128(u) -> torch.Tensor:
    return torch.as_tensor(u).to(torch.complex128)


def lognormal_terminal_law(market, expiry_ticks):
    """(mean, std) of log S_T under risk-neutral GBM at ``expiry_ticks``
    (montecarlo.jl:293-303, with the drift scaled by T — see the JAX
    module's note on the reference's √T slip), started from the escrowed
    spot when the market carries a dividend schedule."""
    r = zero_rate(market.rate, expiry_ticks)
    dev = r.device
    sigma = f64(market.sigma.sigma, device=dev)
    T = f64(market_yearfrac(market, expiry_ticks), device=dev)
    # discrete cash dividends enter as the escrowed spot S0 − PV(divs ≤ T)
    # (market/dividends.py), so exp(mean + std²/2)·df(T) == forward_spot(T)
    spot = f64(market.spot, device=dev)
    if getattr(market, "dividends", None) is not None:
        from ..market.dividends import escrowed_spot

        spot = escrowed_spot(market, T, device=dev)
    mean = torch.log(spot) + (r - f64(carry_yield(market), device=dev) - 0.5 * sigma**2) * T
    return mean, sigma * torch.sqrt(T)


def lognormal_cf(u, mean, std) -> torch.Tensor:
    """CF of a Normal(mean, std) log-price: E[e^{iuX}]."""
    u = _c128(u)
    mean, std = f64(mean, device=u.device), f64(std, device=u.device)
    return torch.exp(1j * u * mean - 0.5 * std**2 * u**2)


def heston_cf(u, S0, V0, kappa, theta, sigma, rho, r, T) -> torch.Tensor:
    """Heston characteristic function of log S_T ("little trap" form):
      d  = √((κ − ρσiu)² + σ²(iu + u²))
      g  = (κ − ρσiu − d)/(κ − ρσiu + d)
      C  = κθ/σ² · ((κ − ρσiu − d)T − 2·log((1 − g e^{−dT})/(1 − g)))
      D  = (κ − ρσiu − d)/σ² · (1 − e^{−dT})/(1 − g e^{−dT})
      φ  = exp(C + D·V0 + iu·log S0 + iu·rT)
    """
    u = _c128(u)
    S0, V0, kappa, theta, sigma, rho, r, T = (
        f64(p, device=u.device) for p in (S0, V0, kappa, theta, sigma, rho, r, T)
    )
    iu = 1j * u
    beta = kappa - rho * sigma * iu
    d = torch.sqrt(beta**2 + sigma**2 * (iu + u**2))
    g = (beta - d) / (beta + d)
    e_dt = torch.exp(-d * T)
    C = (kappa * theta / sigma**2) * ((beta - d) * T - 2.0 * torch.log((1.0 - g * e_dt) / (1.0 - g)))
    D = ((beta - d) / sigma**2) * ((1.0 - e_dt) / (1.0 - g * e_dt))
    return torch.exp(C + D * V0 + iu * torch.log(S0) + iu * r * T)


def terminal_log_cf(prob, dynamics):
    """φ(u) = E[e^{iu·log S_T}] for the problem's market under ``dynamics``
    at the payoff expiry (used by Carr–Madan)."""
    market = prob.market_inputs
    expiry = prob.payoff.expiry
    if isinstance(dynamics, LognormalDynamics):
        mean, std = lognormal_terminal_law(market, expiry)
        return lambda u: lognormal_cf(u, mean, std)
    if isinstance(dynamics, HestonDynamics):
        from ..market.inputs import forward_spot

        r = zero_rate(market.rate, expiry)
        T = market_yearfrac(market, expiry)
        s_eff = forward_spot(market, T)
        return lambda u: heston_cf(
            u, s_eff, market.V0, market.kappa, market.theta, market.sigma, market.rho, r, T
        )
    raise TypeError(f"no terminal law for dynamics {type(dynamics).__name__}")
