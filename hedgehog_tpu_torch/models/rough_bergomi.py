"""Rough Bergomi (Bayer–Friz–Gatheral 2016): the exact Volterra covariance,
its Cholesky factor and that factor's derivative in the Hurst index.

Port of ``hedgehog_tpu/models/rough_bergomi.py``:

    V_t = ξ₀(t)·exp(η·Z_t − ½η²·t^{2H}),  Z_t = √(2H) ∫_0^t (t−s)^{H−½} dW1_s
    dS/S = (r − q) dt + √V_t (ρ dW1 + √(1−ρ²) dW⊥)

The joint Gaussian vector X = (ΔW1_0, …, ΔW1_{n−1}, Z_{t_1}, …, Z_{t_n}) is
drawn exactly from its analytic covariance: X = L·ξ with L the (2n × 2n)
Cholesky factor and ξ standard normals.  Covariances on the grid t_k:

    Cov(ΔW_i, ΔW_j) = Δt·δ_ij
    Cov(Z_t, ΔW_i)  = √(2H)/(H+½)·[(t−t_i)^{H+½} − (t−t_{i+1})_+^{H+½}]
    Var(Z_t)        = t^{2H}
    Cov(Z_s, Z_t)   = 2H·s^{H+½}/(H+½)·∫_0^1 (t−s+s·y^{1/(H+½)})^{H−½} dy

the last by a fixed Gauss–Legendre rule on the smooth substituted integrand.
Everything is float64 and differentiable in ``hurst`` (0-dim tensors keep
their autograd history).  By construction L's ΔW block is diagonal and a
Z row at t_{j+1} has no entry on the increments after t_{j+1}; the kernels
(csrc/rbergomi.cu) read only the entries this structure leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils import f64

__all__ = [
    "ForwardVarianceCurve",
    "volterra_cov",
    "volterra_chol",
    "volterra_chol_dh",
    "rbergomi_variance",
]

_QUAD_NODES = 64


def _leggauss01(nodes: int, device="cpu"):
    """Gauss–Legendre nodes and weights on [0, 1] (numpy's ``leggauss``)."""
    x, w = np.polynomial.legendre.leggauss(nodes)
    return f64((x + 1.0) / 2.0, device=device), f64(w / 2.0, device=device)


def _pow(base, expo):
    """base**expo with an AD-safe base == 0 branch (no 0**e·log 0 NaN)."""
    pos = base > 0.0
    safe = torch.where(pos, base, torch.ones_like(base))
    return torch.where(pos, safe**expo, torch.zeros_like(base))


def volterra_cov(hurst, times, quad_nodes: int = _QUAD_NODES) -> torch.Tensor:
    """Joint covariance of (ΔW_0..ΔW_{n−1}, Z_{t_1}..Z_{t_n}), (2n, 2n)
    float64.  ``times``: the strictly increasing grid t_1 < … < t_n (t_0 = 0
    implied)."""
    t = f64(times)
    h = f64(hurst, device=t.device)
    t0 = torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device), t[:-1]])  # left endpoints
    dt = t - t0
    hp = h + 0.5
    a_block = torch.diag(dt)

    # B[j, i] = Cov(Z_{t_{j+1}}, ΔW_i): the kernel integrated over [t_i, t_{i+1}]
    d_l = t[:, None] - t0[None, :]
    d_r = t[:, None] - t[None, :]
    b_block = torch.sqrt(2.0 * h) / hp * (_pow(d_l, hp) - _pow(torch.clamp(d_r, min=0.0), hp))
    b_block = torch.where(d_l > 0.0, b_block, torch.zeros_like(b_block))

    # C[j, k] = Cov(Z_{t_{j+1}}, Z_{t_{k+1}}): closed-form diagonal t^{2H},
    # the Gauss–Legendre panel (singularity absorbed) off the diagonal
    y, w = _leggauss01(quad_nodes, t.device)
    s = torch.minimum(t[:, None], t[None, :])
    tt = torch.maximum(t[:, None], t[None, :])
    gap = tt - s
    yp = _pow(y, 1.0 / hp)
    base = gap[..., None] + s[..., None] * yp
    # on the diagonal (gap == 0) the integrand is singular at y = 0: the
    # where keeps those lanes finite, the closed form replaces them
    integ = _pow(torch.where(gap[..., None] > 0.0, base, torch.ones_like(base)), h - 0.5)
    panel = torch.sum(integ * w, dim=-1)
    c_off = 2.0 * h / hp * _pow(s, hp) * panel
    c_block = torch.where(gap > 0.0, c_off, _pow(tt, 2.0 * h))

    top = torch.cat([a_block, b_block.T], dim=1)
    bot = torch.cat([b_block, c_block], dim=1)
    cov = torch.cat([top, bot], dim=0)
    return 0.5 * (cov + cov.T)


def _jittered_cov(hurst, horizon, steps: int, quad_nodes: int) -> torch.Tensor:
    """The covariance plus 1e-12 of its largest diagonal entry on the
    diagonal: the matrix is positive definite analytically, the jitter keeps
    the factorization stable."""
    t = (torch.arange(1, steps + 1, dtype=torch.float64) / steps) * f64(horizon)
    cov = volterra_cov(hurst, t, quad_nodes=quad_nodes)
    jitter = 1e-12 * torch.max(torch.diagonal(cov))
    return cov + jitter * torch.eye(2 * steps, dtype=cov.dtype)


def volterra_chol(hurst, horizon, steps: int, quad_nodes: int = _QUAD_NODES) -> torch.Tensor:
    """Lower Cholesky factor (2n × 2n) of :func:`volterra_cov` on the uniform
    grid t_k = k·T/n: exact joint (ΔW, Z) draws are X = L·ξ."""
    return torch.linalg.cholesky(_jittered_cov(hurst, horizon, steps, quad_nodes))


def volterra_chol_dh(hurst, horizon, steps: int, quad_nodes: int = _QUAD_NODES) -> torch.Tensor:
    """dL/dH of :func:`volterra_chol` at ``hurst`` (float64, detached): one
    forward-mode tangent through the covariance (``torch.func.jvp``, the
    input is a scalar), then the Cholesky derivative in closed form,
    dL = L·Φ(L⁻¹·dΣ·L⁻ᵀ) with Φ the lower triangle and half the diagonal
    (what ``jax.jacfwd`` of the factor computes)."""
    h = f64(hurst).detach()
    cov, dcov = torch.func.jvp(lambda x: _jittered_cov(x, float(horizon), steps, quad_nodes),
                               (h,), (torch.ones_like(h),))
    L = torch.linalg.cholesky(cov)
    y = torch.linalg.solve_triangular(L, dcov, upper=False)
    m = torch.linalg.solve_triangular(L, y.T, upper=False).T
    phi = torch.tril(m, diagonal=-1) + 0.5 * torch.diag(torch.diagonal(m))
    return L @ phi


def _interp(x, xp, fp) -> torch.Tensor:
    """``jnp.interp``: piecewise linear in ``xp``, flat outside, on the
    device of ``x``; every argument keeps its autograd history."""
    x = torch.as_tensor(x, dtype=torch.float64)
    xp, fp = f64(xp, device=x.device), f64(fp, device=x.device)
    i = torch.clamp(torch.searchsorted(xp.detach(), x.detach(), right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    flat = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(flat, fp[i - 1], fp[i - 1] + (delta / torch.where(flat, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass(frozen=True)
class ForwardVarianceCurve:
    """Piecewise-linear forward-variance term structure ξ₀(t) (E[V_t] =
    ξ₀(t)): ``tenors`` (year fractions, increasing) and ``xi`` (variance
    levels), flat outside the spine.  Tensors with ``requires_grad`` give
    bucketed vegas through the float64 estimator."""

    tenors: Any
    xi: Any

    def __call__(self, t) -> torch.Tensor:
        return _interp(t, self.tenors, self.xi)


def rbergomi_variance(market, z, t_left) -> torch.Tensor:
    """Variance at the grid's left points from exact Volterra samples:
    V_k = ξ₀(t_k)·exp(η·Z_{t_k} − ½η²·t_k^{2H}) (Z_0 = 0), in the dtype of
    ``z`` (float32 for the ``fp32`` bulk)."""
    dtype, device = z.dtype, z.device
    eta = f64(market.eta, device=device).to(dtype)
    t_left = f64(t_left, device=device)
    t2h = _pow(t_left.to(dtype), f64(2.0 * f64(market.hurst), device=device).to(dtype))
    xi0 = market.xi0
    level = xi0(t_left) if isinstance(xi0, ForwardVarianceCurve) else f64(xi0, device=device)
    return level.to(dtype) * torch.exp(eta * z - 0.5 * eta**2 * t2h)
