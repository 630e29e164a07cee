"""Heston European call prices from the characteristic function (Lewis's
formula, Albrecher et al.'s stable form of the characteristic function),
float64 NumPy: the quotes a calibration desk fits to.

C = S − √(S·K)·e^{−rT/2}/π · ∫_0^∞ Re[e^{iux} φ(u − i/2)] / (u² + 1/4) du,
x = ln(S/K) + rT, φ the characteristic function of ln(S_T/S) − rT;
Simpson's rule on [0, 400] with steps of 0.005.
"""

from __future__ import annotations

import numpy as np


def _cf(u, T, v0, kappa, theta, sigma, rho):
    iu = 1j * u
    b = kappa - rho * sigma * iu
    d = np.sqrt(b * b + sigma * sigma * (iu + u * u))
    g = (b - d) / (b + d)
    edt = np.exp(-d * T)
    C = kappa * theta / sigma**2 * ((b - d) * T - 2.0 * np.log((1.0 - g * edt) / (1.0 - g)))
    D = (b - d) / sigma**2 * (1.0 - edt) / (1.0 - g * edt)
    return np.exp(C + D * v0)


def call_prices(spot, rate, v0, kappa, theta, sigma, rho, T, strikes, upper: float = 400.0,
                h: float = 0.005) -> np.ndarray:
    """Call prices at the expiry ``T`` (years) for each of ``strikes``."""
    n = int(round(upper / h)) // 2 * 2
    u = np.linspace(0.0, upper, n + 1)
    w = np.full(n + 1, 2.0)
    w[1::2] = 4.0
    w[0] = w[-1] = 1.0
    w *= (u[1] - u[0]) / 3.0
    phi = _cf(u - 0.5j, T, v0, kappa, theta, sigma, rho)
    K = np.asarray(strikes, dtype=np.float64)[:, None]
    x = np.log(spot / K) + rate * T
    integrand = np.real(np.exp(1j * u * x) * phi) / (u * u + 0.25)
    return spot - np.sqrt(spot * K[:, 0]) * np.exp(-0.5 * rate * T) / np.pi * (integrand @ w)
