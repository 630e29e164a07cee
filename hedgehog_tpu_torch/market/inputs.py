"""Market-input containers: Black-Scholes, Heston, rough Bergomi, the jump
and variance-gamma families (Merton, Kou, variance gamma, Bates), the
normal and local-vol families (Bachelier, CEV, SABR, SLV), the short-rate
markets (Hull-White, Heston-Hull-White) and the correlated multi-asset
markets (Black-Scholes, Heston), all subclasses of
:class:`AbstractMarketInputs`.

Port of ``hedgehog_tpu/market/inputs.py`` for the markets the port prices
(reference src/market_inputs/market_inputs.jl:28-88).  Scalar rates and vols
are wrapped into a flat curve / flat surface as the reference's convenience
constructors do.  Black-Scholes markets also take an interpolated
``RateCurve`` and a ``RectVolSurface`` or ``SVIVolSurface``, and so do the
Merton, Kou, variance-gamma, Bachelier, CEV, SABR, SLV, Hull-White,
Heston-Hull-White and multi-asset markets (their pricers read the curve, as
the JAX package's do); the Heston, Bates and
rough-Bergomi markets keep a flat rate, the contract the mixing kernels and
estimators drift and discount on (one short rate r: discount e^{−rT}).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.dates import ACT365F, to_ticks, yearfrac
from ..utils import device_of, f64
from .rate_curve import FlatRateCurve, RateCurve
from .svi import SVIVolSurface
from .vol_surface import FlatVolSurface, RectVolSurface

__all__ = [
    "AbstractMarketInputs",
    "BlackScholesInputs",
    "HestonInputs",
    "RoughBergomiInputs",
    "MertonInputs",
    "KouInputs",
    "VarianceGammaInputs",
    "BatesInputs",
    "BachelierInputs",
    "CEVInputs",
    "SABRInputs",
    "SLVInputs",
    "HullWhiteInputs",
    "HestonHullWhiteInputs",
    "MultiAssetBSInputs",
    "MultiAssetHestonInputs",
    "quanto_dividend_yield",
    "carry_yield",
    "forward_spot",
    "market_yearfrac",
]

_frozen = dataclasses.dataclass(frozen=True)


class AbstractMarketInputs:
    """Base marker of the market-input containers (market_inputs.jl:6)."""


def _wrap_rate(rate, reference_date, daycount, curves=False):
    if isinstance(rate, FlatRateCurve) or (curves and isinstance(rate, RateCurve)):
        return rate
    if isinstance(rate, RateCurve):
        raise TypeError(
            "this market drifts and discounts at one short rate: give it a number or a "
            "FlatRateCurve (an interpolated RateCurve prices under BlackScholesInputs)"
        )
    return FlatRateCurve(reference_date, rate, daycount)


def quanto_dividend_yield(r_domestic, r_foreign, q, sigma, fx_vol, corr):
    """The continuous carry that makes a domestic-currency
    :class:`BlackScholesInputs` price a quanto option on a foreign asset
    (payoff converted at a fixed FX rate): under the domestic measure the
    asset drifts at r_f − q − ρ·σ_S·σ_FX while cashflows discount at r_d,
    so ``yield = r_d − r_f + q + ρ·σ_S·σ_FX``.  ``corr`` is the correlation
    of the asset (in its own currency) with the domestic-per-foreign FX
    rate."""
    return r_domestic - r_foreign + q + corr * sigma * fx_vol


def carry_yield(market):
    """Continuous dividend/borrow yield q of a market (0.0 when absent)."""
    return getattr(market, "dividend_yield", 0.0)


def forward_spot(market, T, device=None) -> torch.Tensor:
    """The carry-adjusted escrowed spot ``(spot − PV(cash divs ≤ T))·e^{−qT}``;
    divide by D(T) for the T-forward.  For the terminal-law methods this
    substitution alone prices continuous carry and discrete cash dividends
    in the escrowed convention (market/dividends.py); a market without a
    schedule subtracts nothing.  On ``device``, else on the device of the
    market's tensors."""
    q = carry_yield(market)
    dev = device_of(market.spot, q, T) if device is None else device
    spot = f64(market.spot, device=dev)
    if getattr(market, "dividends", None) is not None:
        from .dividends import escrowed_spot

        # raises when PV(schedule) >= spot: no lognormal model is behind a
        # non-positive escrowed spot
        spot = escrowed_spot(market, T, device=dev)
    return spot * torch.exp(-f64(q, device=dev) * f64(T, device=dev))


def market_yearfrac(market, t):
    """Year fraction from a market's reference date to ``t`` under the
    market's day-count convention."""
    return yearfrac(market.reference_date, t, getattr(market, "daycount", None))


@_frozen
class BlackScholesInputs(AbstractMarketInputs):
    """Black-Scholes market data: reference date (ticks), rate curve, spot,
    vol surface, continuous dividend yield.

    ``dividends`` (default None) attaches a
    :class:`~hedgehog_tpu_torch.market.dividends.DividendSchedule` of
    discrete cash dividends: the terminal-law engines (closed forms,
    Carr–Madan, the exact samplers, CRR) price the escrowed convention
    through :func:`forward_spot`; the grid engines (PDE jump conditions,
    the log-Euler grid's ex-date drops) price the piecewise-lognormal spot
    model (market/dividends.py)."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    dividend_yield: Any = 0.0
    dividends: Any = None
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        if not isinstance(self.sigma, (FlatVolSurface, RectVolSurface, SVIVolSurface)):
            object.__setattr__(self, "sigma", FlatVolSurface(self.sigma, ref))


@_frozen
class HestonInputs(AbstractMarketInputs):
    """Heston market data: dS/S = r dt + √V dW₁; dV = κ(θ−V) dt + σ√V dW₂,
    corr(dW₁, dW₂) = ρ."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


@_frozen
class RoughBergomiInputs(AbstractMarketInputs):
    """Rough Bergomi market data (models/rough_bergomi.py):
    V_t = ξ₀·exp(η·Z_t − ½η²·t^{2H}) with Z a Riemann–Liouville fBM of Hurst
    index H; dS/S = (r − q) dt + √V (ρ dW₁ + √(1−ρ²) dW⊥).  ``xi0`` is the
    flat forward-variance level or a
    :class:`~hedgehog_tpu_torch.models.rough_bergomi.ForwardVarianceCurve`.
    Fields that are 0-dim float64 tensors keep their autograd history."""

    reference_date: Any
    rate: Any
    spot: Any
    xi0: Any
    eta: Any
    hurst: Any
    rho: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


def _host_value(x):
    """A market field as a Python float for a construction-time guard, or
    None for a tensor (never read back from the device; JAX skips traced
    values the same way)."""
    if isinstance(x, torch.Tensor):
        return None
    return float(x)


@_frozen
class MertonInputs(AbstractMarketInputs):
    """Merton (1976) lognormal jump-diffusion market data:
    dS/S = (r − q − λκ̄)dt + σ dW + (e^J − 1)dN with J ~ N(jump_mean,
    jump_std²), N a Poisson(jump_intensity) process and
    κ̄ = e^{jump_mean + jump_std²/2} − 1 the martingale compensator.
    ``sigma`` is the diffusion volatility (a number, not a vol surface)."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    jump_intensity: Any
    jump_mean: Any
    jump_std: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))


@_frozen
class KouInputs(AbstractMarketInputs):
    """Kou (2002) double-exponential jump-diffusion market data:
    dS/S = (r − q − λκ̄)dt + σ dW + (e^J − 1)dN with jump sizes upward
    Exp(eta_up) with probability ``p_up``, downward −Exp(eta_down)
    otherwise, N a Poisson(``jump_intensity``) process, and
    κ̄ = p·η₁/(η₁−1) + (1−p)·η₂/(η₂+1) − 1.  ``eta_up`` must exceed 1
    (E[e^J] finite), checked when it is a number."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    jump_intensity: Any
    p_up: Any
    eta_up: Any
    eta_down: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        e1 = _host_value(self.eta_up)
        if e1 is not None and e1 <= 1.0:
            raise ValueError(f"eta_up must exceed 1 for E[e^J] to be finite (got {e1})")


@_frozen
class VarianceGammaInputs(AbstractMarketInputs):
    """Variance Gamma market data (Madan–Carr–Chang 1998):
    log S_T = log S0 + (r − q + ω)T + θ·G_T + σ·W_{G_T}, the gamma
    subordinator G_T ~ Gamma(T/ν, scale ν), ω = ln(1 − θν − σ²ν/2)/ν the
    martingale correction; 1 − θν − σ²ν/2 > 0 is required (checked when
    the three are numbers)."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    nu: Any
    theta: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        theta, nu, sigma = (_host_value(x) for x in (self.theta, self.nu, self.sigma))
        if None in (theta, nu, sigma):
            return
        margin = 1.0 - theta * nu - 0.5 * sigma**2 * nu
        if margin <= 0.0:
            raise ValueError(
                f"VG needs 1 − θν − σ²ν/2 > 0 for a finite forward "
                f"(got {margin:.6f}); reduce θ·ν or σ²·ν"
            )


@_frozen
class BatesInputs(AbstractMarketInputs):
    """Bates (1996) market data: Heston stochastic variance plus Merton
    lognormal jumps,

        dS/S = (r − q − λκ̄)dt + √V dW₁ + (e^J − 1)dN
        dV   = κ(θ − V)dt + σ√V dW₂,   corr(dW₁, dW₂) = ρ,

    J ~ N(jump_mean, jump_std²), N ~ Poisson(jump_intensity·t) independent
    of (W₁, W₂), κ̄ = e^{μ_J+σ_J²/2} − 1.  A flat rate, as on
    :class:`HestonInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho: Any
    jump_intensity: Any
    jump_mean: Any
    jump_std: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


@_frozen
class BachelierInputs(AbstractMarketInputs):
    """Bachelier (normal) market data: the T-forward F = spot·e^{−qT}/D(T)
    follows dF = σ_N dW with ``sigma`` the normal volatility in price units
    per √year (prices can go negative)."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))


@_frozen
class CEVInputs(AbstractMarketInputs):
    """CEV market data: dS = (r − q)·S dt + σ·S^β dW, elasticity ``beta``
    in (0, 1) (checked when it is a number), absorbing at zero.  ``sigma``
    is the CEV scale: a lognormal vol σ_ln at spot S means σ = σ_ln·S^{1−β}."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    beta: Any
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        b = _host_value(self.beta)
        if b is not None and not 0.0 < b < 1.0:
            raise ValueError(
                f"CEV elasticity beta must lie in (0, 1); got {b} "
                "(beta = 1 IS Black-Scholes — use BlackScholesInputs)"
            )


@_frozen
class SABRInputs(AbstractMarketInputs):
    """SABR market data on the T-forward F = spot·e^{−qT}/D(T):
    dF = α F^β dW₁, dα = ν α dW₂, corr(dW₁, dW₂) = ρ.  ``beta`` is the CEV
    backbone exponent, a plain number (it is fixed, not calibrated)."""

    reference_date: Any
    rate: Any
    spot: Any
    alpha: Any
    beta: Any = 1.0
    rho: Any = 0.0
    nu: Any = 0.0
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))


@_frozen
class SLVInputs(AbstractMarketInputs):
    """Stochastic-local-vol market data (models/slv.py):

        dS/S = (r − q)dt + L(t, S)·√V dW₁
        dV   = κ(θ − V)dt + mixing·σ·√V dW₂,   corr(dW₁, dW₂) = ρ

    ``sigma_surface`` is the market implied-vol surface the model reprices
    (a number is wrapped flat); ``mixing`` ∈ [0, 1] scales the vol of vol
    (0 pure local vol, 1 full Heston); ``leverage`` is the calibrated
    :class:`~hedgehog_tpu_torch.models.slv.LeverageSurface`, None until
    :func:`~hedgehog_tpu_torch.models.slv.calibrate_leverage` fills it."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho: Any
    sigma_surface: Any
    mixing: Any = 1.0
    leverage: Any = None
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        if not isinstance(self.sigma_surface, (FlatVolSurface, RectVolSurface, SVIVolSurface)):
            object.__setattr__(self, "sigma_surface", FlatVolSurface(self.sigma_surface, ref))

    def with_leverage(self, leverage) -> "SLVInputs":
        """A copy carrying a calibrated leverage surface."""
        return dataclasses.replace(self, leverage=leverage)


@_frozen
class HullWhiteInputs(AbstractMarketInputs):
    """Hull-White / G1++ one-factor Gaussian short-rate market:
    dr = (θ(t) − a·r)dt + σ dW with θ(t) fitted so model bonds reproduce
    ``rate`` (a flat or interpolated curve) exactly; models/hull_white.py
    works in the x-factor and never forms θ.  ``a`` (mean reversion, > 0,
    checked when it is a number) and ``sigma`` (absolute short-rate vol) may
    be tensors: rate vega, mean-reversion greeks and (a, σ) calibration run
    through the lenses, key-rate durations through ``ZeroRateSpineLens``."""

    reference_date: Any
    rate: Any
    a: Any
    sigma: Any
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        a = _host_value(self.a)
        if a is not None and a <= 0.0:
            raise ValueError("HullWhiteInputs.a (mean reversion) must be > 0")


@_frozen
class HestonHullWhiteInputs(AbstractMarketInputs):
    """Heston-Hull-White hybrid market:

        dS/S = (r_t − q)dt + √V dW_S
        dV   = κ(θ − V)dt + σ_v √V dW_v,        corr(dW_S, dW_v) = rho_sv
        dr   = (θ_r(t) − a·r)dt + σ_r dW_r,     corr(dW_S, dW_r) = rho_sr

    with W_v ⊥ W_r and θ_r(t) fitted to ``rate`` through the G1++ x-factor
    of :class:`HullWhiteInputs`; rho_sv² + rho_sr² ≤ 1 is the caller's.
    Prices by ``MonteCarlo(HestonHullWhiteDynamics(),
    HestonQE(conditional=True), cfg)``."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho_sv: Any
    a: Any
    sigma_r: Any
    rho_sr: Any = 0.0
    dividend_yield: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        a = _host_value(self.a)
        if a is not None and a <= 0.0:
            raise ValueError("HestonHullWhiteInputs.a must be > 0")


def _host_matrix(x):
    """A float64 numpy copy of a market array for a construction-time check,
    or None for a tensor that requires grad or lives off the CPU (never read
    back from the device; JAX skips traced values the same way)."""
    if isinstance(x, torch.Tensor):
        if x.requires_grad or x.device.type != "cpu":
            return None
        return x.detach().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _check_correlation(c) -> None:
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError("correlation must be a square (n, n) matrix")
    if not np.allclose(c, c.T, atol=1e-12):
        raise ValueError("correlation must be symmetric")
    if not np.allclose(np.diag(c), 1.0, atol=1e-12):
        raise ValueError("correlation must have a unit diagonal")


@_frozen
class MultiAssetBSInputs(AbstractMarketInputs):
    """Correlated multi-asset Black-Scholes market: n lognormal assets with
    ``spots`` (n,), ``sigmas`` (n,) and instantaneous ``correlation`` (n, n;
    symmetric, unit diagonal, positive semi-definite, checked when it is a
    host array).  ``dividend_yields`` (a number or (n,)): asset i drifts at
    r − q_i.  Tensors keep their autograd history (per-asset deltas, the
    correlation greek)."""

    reference_date: Any
    rate: Any
    spots: Any
    sigmas: Any
    correlation: Any
    dividend_yields: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        c = _host_matrix(self.correlation)
        if c is None:
            return
        _check_correlation(c)
        if np.linalg.eigvalsh(c).min() < -1e-10:
            raise ValueError("correlation must be positive semi-definite")


@_frozen
class MultiAssetHestonInputs(AbstractMarketInputs):
    """Correlated multi-asset Heston market: asset i has its own CIR
    variance dV_i = κ_i(θ_i − V_i)dt + σ_i√V_i dW_i^v and spot-vol
    correlation ρ_i; the variances are independent across assets and the
    instantaneous spot-spot correlation is ``correlation`` R.  With
    W_i^s = ρ_i·W_i^v + ρ̄_i·W_i^⊥ (ρ̄ = √(1−ρ²)) the orthogonal drivers
    carry corr R_ij/(ρ̄_i ρ̄_j), which must itself be a correlation matrix:
    the constructor checks it (when the arrays are on the host) and rejects
    an R too strong for the spot-vol correlations."""

    reference_date: Any
    rate: Any
    spots: Any
    V0s: Any
    kappas: Any
    thetas: Any
    sigma_vs: Any
    rhos: Any
    correlation: Any
    dividend_yields: Any = 0.0
    daycount: Any = ACT365F

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount, curves=True))
        c, rhos = _host_matrix(self.correlation), _host_matrix(self.rhos)
        if c is None or rhos is None:
            return
        _check_correlation(c)
        if np.any(np.abs(rhos) >= 1.0):
            raise ValueError("spot-vol correlations must satisfy |rho| < 1")
        rho_bar = np.sqrt(1.0 - rhos**2)
        c_perp = c / np.outer(rho_bar, rho_bar)
        np.fill_diagonal(c_perp, 1.0)
        if np.any(np.abs(c_perp) > 1.0 + 1e-12):
            raise ValueError(
                "spot-spot correlation too strong for the given spot-vol "
                "correlations: |R_ij| must be <= sqrt(1-rho_i^2)*sqrt(1-rho_j^2)"
            )
        if np.linalg.eigvalsh(c_perp).min() < -1e-10:
            raise ValueError(
                "the implied orthogonal-driver correlation matrix "
                "R_ij/(rho_bar_i*rho_bar_j) must be positive semi-definite"
            )
