"""Bivariate standard-normal CDF Φ₂(h, k; ρ), the closed-form primitive
behind compound (Geske) pricing.

Port of ``hedgehog_tpu/math/bvn.py``.  Genz's single-integral form

    Φ₂(h, k; ρ) = Φ(h)·Φ(k)
                + (1/2π) ∫₀^{asin ρ} exp(−(h² − 2hk·sinθ + k²)/(2cos²θ)) dθ

evaluated with one fixed 64-node Gauss–Legendre rule on the θ-interval:
smooth in (h, k, ρ), so autograd reaches the correlation.  |ρ| ≤ 0.99
holds ≤ 2e-9 absolute; the |ρ| = 1 limits are approached continuously
through the clip at 1 − 1e-12.  The rule is kept as numpy constants, so
importing the module computes nothing on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import device_of, f64

__all__ = ["bvn_cdf"]

# 64-point Gauss-Legendre on [0, 1]
_GL_X, _GL_W = np.polynomial.legendre.leggauss(64)
_GL_X = (_GL_X + 1.0) / 2.0
_GL_W = _GL_W / 2.0


def bvn_cdf(h, k, rho) -> torch.Tensor:
    """P(X ≤ h, Y ≤ k) for a standard bivariate normal with correlation ρ,
    broadcasting over all three arguments, on the device of its tensor
    arguments; |ρ| is clipped to 1 − 1e-12."""
    dev = device_of(h, k, rho)
    h, k = f64(h, device=dev), f64(k, device=dev)
    rho = torch.clamp(f64(rho, device=dev), -1.0 + 1e-12, 1.0 - 1e-12)
    gl_x, gl_w = f64(_GL_X, device=dev), f64(_GL_W, device=dev)
    upper = torch.arcsin(rho)
    theta = upper[..., None] * gl_x  # (…, 64)
    sin_t = torch.sin(theta)
    cos2 = 1.0 - sin_t * sin_t
    hh, kk = h[..., None], k[..., None]
    expo = torch.exp(-(hh * hh - 2.0 * hh * kk * sin_t + kk * kk) / (2.0 * cos2))
    integral = upper * torch.sum(gl_w * expo, dim=-1)
    ncdf = torch.special.ndtr
    return ncdf(h) * ncdf(k) + integral / (2.0 * torch.pi)
