"""Hull-White / G1++ one-factor Gaussian short-rate model, fitted to the curve.

Port of ``hedgehog_tpu/models/hull_white.py``.  The short rate is
dr = (θ(t) − a·r) dt + σ dW with θ(t) fitted so model bonds reproduce
P(0, ·); everything works in the x-factor r_t = x_t + α(t),
dx = −a·x dt + σ dW, x_0 = 0, so the curve enters through P(0, t) ratios
only (a spine ``RateCurve`` works as it is, and key-rate durations flow
through the same autograd path as every other lens).  Brigo–Mercurio ch. 3:

    B(τ)      = (1 − e^{−aτ})/a
    V(t, T)   = σ²/a²·[T−t + (2/a)e^{−a(T−t)} − (1/2a)e^{−2a(T−t)} − 3/(2a)]
    P(t, T)   = P(0,T)/P(0,t) · exp(½[V(t,T) − V(0,T) + V(0,t)] − B(T−t)·x_t)
    σ_p(T, S) = σ·√((1 − e^{−2aT})/(2a))·B(S − T)
    Γ(t)      = ∫₀ᵗ B(u)² du = [t − 2B(t) + (1−e^{−2at})/(2a)]/a²

Over a step Δ the pair (x', ∫x) given x is jointly Gaussian (exact at any
step count), and the pathwise discount exp(−∫₀ᵗ r) =
P(0,t)·exp(−∫₀ᵗ x − ½σ²Γ(t)) has expectation P(0, t) exactly.  Every
function takes numbers or float64 tensors and computes on the device of its
tensor arguments (the deterministic layers' rule, utils/__init__.py).
"""

from __future__ import annotations

import torch

from ..utils import device_of, f64

__all__ = [
    "hw_b",
    "hw_v",
    "hw_gamma",
    "hw_bond",
    "hw_sigma_p",
    "hw_step_moments",
]


def _t(*xs):
    dev = device_of(*xs)
    return tuple(f64(x, device=dev) for x in xs)


def hw_b(a, tau) -> torch.Tensor:
    """B(τ) = (1 − e^{−aτ})/a (a > 0, checked by the inputs)."""
    a, tau = _t(a, tau)
    return (1.0 - torch.exp(-a * tau)) / a


def hw_v(a, sigma, tau) -> torch.Tensor:
    """V(t, t+τ): the G1++ integrated bond-variance block."""
    a, sigma, tau = _t(a, sigma, tau)
    e1 = torch.exp(-a * tau)
    return (sigma / a) ** 2 * (tau + (2.0 / a) * e1 - (0.5 / a) * e1 * e1 - 1.5 / a)


def hw_gamma(a, t) -> torch.Tensor:
    """Γ(t) = ∫₀ᵗ B(u)² du: the variance kernel of ∫x and of the pathwise
    discount's exponent."""
    a, t = _t(a, t)
    return (t - 2.0 * hw_b(a, t) + (1.0 - torch.exp(-2.0 * a * t)) / (2.0 * a)) / a**2


def hw_bond(p0_t, p0_T, a, sigma, t, T, x_t) -> torch.Tensor:
    """Model ZCB P(t, T) as a function of the x state, fitted to the curve
    (at x = 0, t = 0 it is P(0, T) exactly)."""
    p0_t, p0_T, a, sigma, t, T, x_t = _t(p0_t, p0_T, a, sigma, t, T, x_t)
    half = 0.5 * (hw_v(a, sigma, T - t) - hw_v(a, sigma, T) + hw_v(a, sigma, t))
    return (p0_T / p0_t) * torch.exp(half - hw_b(a, T - t) * x_t)


def hw_sigma_p(a, sigma, T, S) -> torch.Tensor:
    """Lognormal volatility of P(T, S) seen from 0: the ZCB-option vol."""
    a, sigma, T, S = _t(a, sigma, T, S)
    return sigma * torch.sqrt((1.0 - torch.exp(-2.0 * a * T)) / (2.0 * a)) * hw_b(a, S - T)


def hw_step_moments(a, sigma, dt):
    """The exact joint (x', ∫x over the step) transition given x: (decay
    e^{−aΔ}, B(Δ), std_x, coeff c = Cov/std_x, residual std of ∫x after
    projecting on x'), the 2×2 Cholesky of the conditional Gaussian."""
    a, sigma, dt = _t(a, sigma, dt)
    e1 = torch.exp(-a * dt)
    v_x = sigma**2 * (1.0 - e1 * e1) / (2.0 * a)
    v_i = sigma**2 * hw_gamma(a, dt)
    c_xi = sigma**2 * (1.0 - e1) ** 2 / (2.0 * a**2)
    s_x = torch.sqrt(v_x)
    coef = c_xi / s_x
    s_res = torch.sqrt(torch.clamp(v_i - coef**2, min=0.0))
    return e1, hw_b(a, dt), s_x, coef, s_res
