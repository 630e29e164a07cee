"""Price dynamics markers, the lognormal terminal law and the characteristic
functions of log S_T, in native complex128.

Port of ``hedgehog_tpu/models/dynamics.py``: the Black-Scholes, Heston,
rough-Bergomi, jump-diffusion (Merton, Kou, Bates), variance-gamma, normal,
CEV, SABR, local-vol, SLV and Heston-Hull-White markers, the CIR-family Euler update the SLV
pricer and its leverage calibration share, and the characteristic functions
(reference montecarlo.jl:286-320 and src/distributions/heston.jl:307-319).
The JAX package also carries a split real/imaginary form for the TPU, which
has no complex128; the port does not need it.  The ``*_terminal_params``
helpers give every parameter as a float64 tensor on the rate's device (T a
Python float), keeping the market fields' autograd history.
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
    "MertonJumpDynamics",
    "KouJumpDynamics",
    "VarianceGammaDynamics",
    "BatesDynamics",
    "NormalDynamics",
    "CEVDynamics",
    "SABRDynamics",
    "LocalVolDynamics",
    "SLVDynamics",
    "HestonHullWhiteDynamics",
    "cir_family_euler_update",
    "lognormal_terminal_law",
    "merton_terminal_params",
    "kou_terminal_params",
    "vg_terminal_params",
    "bates_jump_factor",
    "lognormal_cf",
    "heston_cf",
    "merton_cf",
    "kou_cf",
    "vg_cf",
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


@dataclasses.dataclass(frozen=True)
class MertonJumpDynamics:
    """Merton (1976) lognormal jump-diffusion: dS/S = (r − λκ̄)dt + σ dW +
    (e^J − 1)dN, J ~ N(μ_J, σ_J²), N a Poisson(λ) process, κ̄ = e^{μ_J +
    σ_J²/2} − 1.  Markets carry :class:`~hedgehog_tpu_torch.market.inputs.MertonInputs`."""


@dataclasses.dataclass(frozen=True)
class KouJumpDynamics:
    """Kou (2002) double-exponential jump-diffusion.  Markets carry
    :class:`~hedgehog_tpu_torch.market.inputs.KouInputs`."""


@dataclasses.dataclass(frozen=True)
class VarianceGammaDynamics:
    """Variance Gamma (Madan–Carr–Chang 1998): Brownian motion with drift
    time-changed by a gamma subordinator.  Markets carry
    :class:`~hedgehog_tpu_torch.market.inputs.VarianceGammaInputs`."""


@dataclasses.dataclass(frozen=True)
class BatesDynamics:
    """Bates (1996): Heston variance plus Merton lognormal jumps.  Markets
    carry :class:`~hedgehog_tpu_torch.market.inputs.BatesInputs`."""


@dataclasses.dataclass(frozen=True)
class NormalDynamics:
    """Bachelier: the T-forward follows dF = σ_N dW (σ_N in price units), so
    it can go negative.  No log-price CF; pricing runs through
    :class:`~hedgehog_tpu_torch.methods.bachelier.BachelierAnalytic` or Monte
    Carlo.  Markets carry :class:`~hedgehog_tpu_torch.market.inputs.BachelierInputs`."""


@dataclasses.dataclass(frozen=True)
class CEVDynamics:
    """Constant elasticity of variance: dS = (r − q)·S dt + σ·S^β dW,
    β ∈ (0, 1), absorbing at zero.  No log-price CF (the law has an atom at
    zero); pricing runs through the Schroder closed form, price-space Euler
    Monte Carlo or the PDE.  Markets carry
    :class:`~hedgehog_tpu_torch.market.inputs.CEVInputs`."""


@dataclasses.dataclass(frozen=True)
class SABRDynamics:
    """SABR on the T-forward: dF = α F^β dW₁, dα = ν α dW₂,
    corr(dW₁, dW₂) = ρ.  No tractable CF; pricing runs through Hagan's
    expansion or Euler Monte Carlo.  Markets carry
    :class:`~hedgehog_tpu_torch.market.inputs.SABRInputs`."""


@dataclasses.dataclass(frozen=True)
class LocalVolDynamics:
    """Dupire local volatility: GBM with σ_loc(t, S) from the market's
    implied-vol surface (models/local_vol.py).  Markets are
    :class:`~hedgehog_tpu_torch.market.inputs.BlackScholesInputs` whose
    ``sigma`` is a surface."""


@dataclasses.dataclass(frozen=True)
class SLVDynamics:
    """Stochastic local vol: Heston variance with a leverage L(t, S)
    calibrated so the model reprices the market's vanilla surface
    (models/slv.py).  No CF; pricing runs through Euler Monte Carlo on a
    calibrated :class:`~hedgehog_tpu_torch.market.inputs.SLVInputs` market."""


@dataclasses.dataclass(frozen=True)
class HestonHullWhiteDynamics:
    """Heston variance with a Hull-White short rate under the equity.  No
    closed form or simple CF under correlation: pricing runs through the
    three-factor conditional mixing Monte Carlo (W_v ⊥ W_r, so log S_T given
    the (V, x) paths is normal;
    methods/heston_hull_white.py).  Markets carry
    :class:`~hedgehog_tpu_torch.market.inputs.HestonHullWhiteInputs`."""


def cir_family_euler_update(x, v, z1, z2, *, lev_x, fk, kappa, theta, sig_v, rho, rho_bar,
                            dt, sqrt_dt):
    """One full-truncation log-Euler step of the CIR-variance family, the
    single (log S, V) update of the SLV pricing stepper
    (methods/heston_euler.py) and of the particle leverage calibration
    (models/slv.py), so the model the calibration fits is the model the
    pricer simulates.  ``lev_x`` is each particle's leverage L(t_k, S).
    V⁺ takes JAX's tie rule at V = 0 (half the gradient to each side), and
    the double-where square root keeps a truncated path's gradient finite."""
    v_plus = torch.maximum(v, torch.zeros_like(v))
    sqrt_v = torch.where(v > 0.0, torch.sqrt(torch.where(v > 0.0, v, 1.0)), 0.0)
    sig_s = lev_x * sqrt_v
    x_new = x + (fk - 0.5 * sig_s**2) * dt + sig_s * sqrt_dt * z1
    v_new = v + kappa * (theta - v_plus) * dt + sig_v * sqrt_v * sqrt_dt * (rho * z1 + rho_bar * z2)
    return x_new, v_new


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


def _carry_log_spot(market, T, dev):
    """log S0 − qT: the carry folded into the log-spot of a one-shot terminal
    law (the drift r stays the discounting rate)."""
    return (torch.log(f64(market.spot, device=dev))
            - f64(carry_yield(market), device=dev) * T)


def merton_terminal_params(market, expiry_ticks):
    """(log_s0, r, T, sigma, lam, mu_j, s_j, kbar) of a Merton market at an
    expiry, κ̄ = expm1(μ_J + σ_J²/2) the jump compensator."""
    r = zero_rate(market.rate, expiry_ticks)
    dev = r.device
    T = market_yearfrac(market, expiry_ticks)
    sigma, lam, mu_j, s_j = (f64(x, device=dev) for x in (
        market.sigma, market.jump_intensity, market.jump_mean, market.jump_std))
    kbar = torch.expm1(mu_j + 0.5 * s_j**2)
    return (_carry_log_spot(market, T, dev), r, T, sigma, lam, mu_j, s_j, kbar)


def kou_terminal_params(market, expiry_ticks):
    """(log_s0, r, T, sigma, lam, p, eta1, eta2, kbar) of a Kou market,
    κ̄ = p·η₁/(η₁−1) + (1−p)·η₂/(η₂+1) − 1."""
    r = zero_rate(market.rate, expiry_ticks)
    dev = r.device
    T = market_yearfrac(market, expiry_ticks)
    sigma, lam, p, e1, e2 = (f64(x, device=dev) for x in (
        market.sigma, market.jump_intensity, market.p_up, market.eta_up, market.eta_down))
    kbar = p * e1 / (e1 - 1.0) + (1.0 - p) * e2 / (e2 + 1.0) - 1.0
    return (_carry_log_spot(market, T, dev), r, T, sigma, lam, p, e1, e2, kbar)


def vg_terminal_params(market, expiry_ticks):
    """(log_s0, r, T, sigma, nu, theta, omega) of a variance-gamma market,
    ω = ln(1 − θν − σ²ν/2)/ν the martingale correction."""
    r = zero_rate(market.rate, expiry_ticks)
    dev = r.device
    T = market_yearfrac(market, expiry_ticks)
    sigma, nu, theta = (f64(x, device=dev) for x in (market.sigma, market.nu, market.theta))
    omega = torch.log(1.0 - theta * nu - 0.5 * sigma**2 * nu) / nu
    return (_carry_log_spot(market, T, dev), r, T, sigma, nu, theta, omega)


def bates_jump_factor(u, lam, mu_j, s_j, T) -> torch.Tensor:
    """Jump multiplier of the Bates CF: exp(λT(e^{iuμ_J − ½u²σ_J²} − 1) −
    iu·λκ̄T), the Merton jump block with its compensator."""
    u = _c128(u)
    lam, mu_j, s_j, T = (f64(x, device=u.device) for x in (lam, mu_j, s_j, T))
    kbar = torch.expm1(mu_j + 0.5 * s_j**2)
    iu = 1j * u
    return torch.exp(lam * T * (torch.exp(iu * mu_j - 0.5 * u**2 * s_j**2) - 1.0)
                     - iu * lam * kbar * T)


def merton_cf(u, log_s0, r, T, sigma, lam, mu_j, s_j, kbar) -> torch.Tensor:
    """Merton CF of log S_T:
    φ(u) = exp(iu·(log S0 + (r − σ²/2 − λκ̄)T) − ½u²σ²T + λT·(e^{iuμ_J − ½u²σ_J²} − 1))."""
    u = _c128(u)
    log_s0, r, T, sigma, lam, mu_j, s_j, kbar = (
        f64(x, device=u.device) for x in (log_s0, r, T, sigma, lam, mu_j, s_j, kbar))
    iu = 1j * u
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    jump = lam * T * (torch.exp(iu * mu_j - 0.5 * u**2 * s_j**2) - 1.0)
    return torch.exp(iu * drift - 0.5 * u**2 * sigma**2 * T + jump)


def kou_cf(u, log_s0, r, T, sigma, lam, p, e1, e2, kbar) -> torch.Tensor:
    """Kou CF of log S_T:
    φ(u) = exp(iu·(log S0 + (r − σ²/2 − λκ̄)T) − ½u²σ²T
               + λT·(p·η₁/(η₁ − iu) + (1−p)·η₂/(η₂ + iu) − 1))."""
    u = _c128(u)
    log_s0, r, T, sigma, lam, p, e1, e2, kbar = (
        f64(x, device=u.device) for x in (log_s0, r, T, sigma, lam, p, e1, e2, kbar))
    iu = 1j * u
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    phi_j = p * e1 / (e1 - iu) + (1.0 - p) * e2 / (e2 + iu)
    return torch.exp(iu * drift - 0.5 * u**2 * sigma**2 * T + lam * T * (phi_j - 1.0))


def vg_cf(u, log_s0, r, T, sigma, nu, theta, omega) -> torch.Tensor:
    """Variance Gamma CF of log S_T:
    φ(u) = e^{iu·(log S0 + (r + ω)T)} · (1 − iuθν + ½σ²ν u²)^{−T/ν}."""
    u = _c128(u)
    log_s0, r, T, sigma, nu, theta, omega = (
        f64(x, device=u.device) for x in (log_s0, r, T, sigma, nu, theta, omega))
    iu = 1j * u
    drift = log_s0 + (r + omega) * T
    base = 1.0 - iu * theta * nu + 0.5 * sigma**2 * nu * u**2
    return torch.exp(iu * drift) * base ** (-T / nu)


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
    if isinstance(dynamics, BatesDynamics):
        from ..market.inputs import forward_spot

        r = zero_rate(market.rate, expiry)
        T = market_yearfrac(market, expiry)
        s_eff = forward_spot(market, T)
        return lambda u: heston_cf(
            u, s_eff, market.V0, market.kappa, market.theta, market.sigma, market.rho, r, T
        ) * bates_jump_factor(u, market.jump_intensity, market.jump_mean, market.jump_std, T)
    if isinstance(dynamics, MertonJumpDynamics):
        params = merton_terminal_params(market, expiry)
        return lambda u: merton_cf(u, *params)
    if isinstance(dynamics, KouJumpDynamics):
        params = kou_terminal_params(market, expiry)
        return lambda u: kou_cf(u, *params)
    if isinstance(dynamics, VarianceGammaDynamics):
        params = vg_terminal_params(market, expiry)
        return lambda u: vg_cf(u, *params)
    raise TypeError(f"no terminal law for dynamics {type(dynamics).__name__}")
