"""Carr–Madan Fourier pricing over the CF of log S_T — the port's oracle.

Port of ``hedgehog_tpu/methods/carr_madan.py`` (reference
src/pricing_methods/carr_madan.jl) with the two-scale panel quadrature and
the CF-decay-aware ``bound="auto"``, evaluated in native complex128:

    integrand(v) = e^{-α·logK}/(2π) · ψ(v) · e^{-i·v·logK}
    ψ(v)         = D(T)·φ(v − (α+1)i) / (α² + α − v² + i·v·(2α+1))

The call price is the real part of ∫_{-bound}^{bound}; puts follow by
parity.  Cash-or-nothing digitals invert the CF by Gil-Pelaez on the same
nodes (``_solve_carr_madan_digital``); the path-dependent payoffs raise.
The panel rule spends ``nodes`` Gauss–Legendre points on the central peak
[−c, c] and max(32, nodes//2) log-substituted points on each tail, so its
accuracy does not depend on the bound.  ``CarrMadan.device`` names where
the nodes, the strikes, the market scalars and the price live: the GPU
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..core.payoffs import (
    AsianOption,
    BarrierOption,
    DigitalOption,
    DoubleBarrierOption,
    LookbackOption,
    VanillaOption,
    parity_transform,
    require_european,
)
from ..core.problems import CarrMadanSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import forward_spot, market_yearfrac
from ..market.rate_curve import df
from ..market.vol_surface import get_vol
from ..models.dynamics import HestonDynamics, LognormalDynamics, terminal_log_cf
from ..utils import f64, resolve_device

__all__ = ["CarrMadan"]


@dataclasses.dataclass(frozen=True)
class CarrMadan(AbstractPricingMethod):
    """Carr–Madan method: damping ``alpha``, integration ``bound`` (a float,
    or "auto" for 16/(σ_eff·√T) with the Heston linear-tail envelope), model
    ``dynamics``, and ``nodes`` Gauss–Legendre points on the central panel,
    computed on ``device``."""

    alpha: float = 1.0
    bound: Any = "auto"
    dynamics: Any = LognormalDynamics()
    nodes: int = 256
    device: str = "cuda"


@functools.lru_cache(maxsize=None)
def _gauss_legendre(n: int):
    """The n-point Gauss–Legendre rule on [−1, 1] (read-only arrays): an
    n × n eigenproblem on the host, tens of ms at n = 256, so it is solved
    once per n rather than once per price."""
    nodes, weights = np.polynomial.legendre.leggauss(n)
    nodes.flags.writeable = weights.flags.writeable = False
    return nodes, weights


def _panel_nodes(bound, n: int, device):
    """n-point GL on [−c, c] plus max(32, n//2) log-substituted GL points on
    each tail [±c, ±bound], with c = min(8, bound/4)."""
    bound = f64(bound, device=device)
    c = torch.clamp(0.25 * bound, max=8.0)
    xc, wc = (f64(a.copy(), device=device) for a in _gauss_legendre(n))
    xt, wt = (f64(a.copy(), device=device) for a in _gauss_legendre(max(32, n // 2)))
    L = torch.log(bound / c)
    t = 0.5 * L * (xt + 1.0)
    v_t = c * torch.exp(t)
    w_t = 0.5 * L * wt * v_t  # dv = v dt
    return torch.cat([xc * c, v_t, -v_t]), torch.cat([wc * c, w_t, w_t])


def _auto_bound(prob: PricingProblem, dynamics, device) -> torch.Tensor:
    """CF-decay-aware truncation 16/(σ_eff·√T), floored at 64; for Heston
    also the linear tail envelope 34/c_lin (carr_madan.py:172-241)."""
    market = prob.market_inputs
    T = f64(market_yearfrac(market, prob.payoff.expiry), device=device)
    if isinstance(dynamics, LognormalDynamics):
        sigma = f64(get_vol(market.sigma, prob.payoff.expiry, prob.payoff.strike), device=device)
        s = torch.sqrt(torch.clamp(torch.min(sigma**2 * T), min=1e-16))
        return torch.clamp(16.0 / s, min=64.0)
    if isinstance(dynamics, HestonDynamics):
        V0, kappa, theta, sigma, rho = (
            f64(p, device=device)
            for p in (market.V0, market.kappa, market.theta, market.sigma, market.rho)
        )
        s2 = theta * T + (V0 - theta) * (1.0 - torch.exp(-kappa * T)) / kappa
        c_lin = torch.sqrt(torch.clamp(1.0 - rho**2, min=2.5e-3)) * (V0 + kappa * theta * T) / sigma
        u_lin = 34.0 / torch.clamp(c_lin, min=1e-8)
        s = torch.sqrt(torch.clamp(s2, min=1e-16))
        return torch.clamp(torch.maximum(16.0 / s, u_lin), 64.0, 1e7)
    raise TypeError(
        f"no CF decay envelope for dynamics {type(dynamics).__name__}: "
        "bound='auto' supports LognormalDynamics and HestonDynamics"
    )


def _quad_nodes(prob: PricingProblem, method: CarrMadan, device):
    bound = method.bound
    if isinstance(bound, str):
        if bound != "auto":
            raise ValueError(
                f"string bound must be 'auto', got {bound!r} (pass a float "
                "for a fixed truncation)"
            )
        bound = _auto_bound(prob, method.dynamics, device)
    return _panel_nodes(bound, method.nodes, device)


def _solve_carr_madan_digital(prob: PricingProblem, method: CarrMadan,
                              device) -> CarrMadanSolution:
    """Cash-or-nothing digital by Gil-Pelaez inversion on the same nodes:
    P(S_T > K) = ½ + (1/π)∫₀^∞ Im[e^{−iu·lnK}φ(u)]/u du.  The integrand is
    even in u, so the symmetric node set integrates it with one ½·Σ w·g;
    digital puts follow from the cash parity."""
    payoff = prob.payoff
    market = prob.market_inputs
    if method.nodes % 2:
        raise ValueError(
            "digital Carr-Madan needs an even node count (an odd "
            "Gauss-Legendre rule places a node at u=0, where the Gil-Pelaez "
            "integrand's 1/u form is indeterminate)"
        )
    K = f64(payoff.strike, device=device)
    D = f64(df(market.rate, payoff.expiry), device=device)
    v, w = _quad_nodes(prob, method, device)
    logK_b = torch.log(K)[..., None]
    phi = terminal_log_cf(prob, method.dynamics)
    g = torch.imag(phi(v + 0.0j) * torch.exp(-1j * v * logK_b)) / v
    p_itm = 0.5 + (0.5 / torch.pi) * torch.sum(w * g, dim=-1)
    call_price = D * f64(payoff.cash, device=device) * p_itm
    price = parity_transform(call_price, payoff, f64(market.spot, device=device), market.rate)
    return CarrMadanSolution(prob, method, price, p_itm)


@register_solver(CarrMadan)
def _solve_carr_madan(prob: PricingProblem, method: CarrMadan) -> CarrMadanSolution:
    payoff = prob.payoff
    require_european(payoff, "CarrMadan", spot_only=True)
    market = prob.market_inputs
    device = resolve_device(method.device)
    if isinstance(payoff, (BarrierOption, AsianOption, DoubleBarrierOption, LookbackOption)):
        raise TypeError(
            f"CarrMadan prices path-independent payoffs (the CF of log S_T "
            f"carries no path law); {type(payoff).__name__} prices "
            f"analytically under Black-Scholes (where a closed form exists) "
            f"or via grid Monte Carlo"
        )
    if isinstance(payoff, DigitalOption):
        return _solve_carr_madan_digital(prob, method, device)
    if not isinstance(payoff, VanillaOption):
        raise TypeError(f"CarrMadan prices vanillas and digitals; got {type(payoff).__name__}")
    K = f64(payoff.strike, device=device)
    logK = torch.log(K)
    alpha = method.alpha
    D = f64(df(market.rate, payoff.expiry), device=device)

    v, w = _quad_nodes(prob, method, device)
    damp = torch.exp(-alpha * logK) / (2.0 * torch.pi)
    logK_b = logK[..., None]  # strike grids broadcast against the nodes

    phi = terminal_log_cf(prob, method.dynamics)
    numerator = D * phi(v - (alpha + 1.0) * 1j)
    denominator = alpha**2 + alpha - v**2 + 1j * v * (2.0 * alpha + 1.0)
    integrand = damp[..., None] * (numerator / denominator) * torch.exp(-1j * v * logK_b)
    integral = torch.sum(w * integrand, dim=-1)
    call_price = integral.real
    T = market_yearfrac(market, payoff.expiry)
    price = parity_transform(call_price, payoff, forward_spot(market, T, device=device),
                             market.rate)
    return CarrMadanSolution(prob, method, price, integral)
