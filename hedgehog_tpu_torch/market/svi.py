"""SVI (stochastic-volatility-inspired) implied-volatility surface.

Port of ``hedgehog_tpu/market/svi.py``: Gatheral's raw-SVI slice, the
Gatheral-Jacquier no-arbitrage diagnostics and a per-slice bounded L-BFGS
calibration.  Each expiry slice carries total variance in log-forward
moneyness k = log(K / F_t):

    w(k) = a + b · (ρ·(k − m) + sqrt((k − m)² + σ²))        (raw SVI)

and the surface interpolates total variance linearly in time at fixed
moneyness between slices; outside the tenor range total variance scales
with t (constant IV in k), which keeps w > 0 and the calendar order.

``SVIVolSurface`` evaluates on its ``device`` (the GPU unless the caller
asks for the CPU), and ``calibrate_svi_slices`` fits on its ``device``:
one bounded L-BFGS per slice (``math.optimize.minimize_lbfgs``), each its
own fit as the JAX package's ``vmap`` keeps them.  Evaluations are
differentiable in the parameters, so ``BlackScholesInputs(..., surface)``
prices through ``solve`` with gradients in them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.dates import ACT365F, to_ticks
from ..utils import f64, resolve_device

__all__ = [
    "SVIVolSurface",
    "svi_total_variance",
    "svi_butterfly_margin",
    "svi_calendar_margin",
    "check_svi_arbitrage",
    "calibrate_svi_slices",
]


def _params(params, like):
    return tuple(f64(p, device=like.device) if not isinstance(p, torch.Tensor) else p
                 for p in params)


def svi_total_variance(params, k):
    """Raw-SVI total variance w(k); ``params = (a, b, rho, m, sigma)``
    broadcasting against ``k``."""
    k = k if isinstance(k, torch.Tensor) else f64(k)
    a, b, rho, m, sigma = _params(params, k)
    km = k - m
    return a + b * (rho * km + torch.sqrt(km * km + sigma * sigma))


def _svi_w_dw_d2w(params, k):
    """w, w', w'' of a raw-SVI slice in closed form."""
    a, b, rho, m, sigma = _params(params, k)
    km = k - m
    root = torch.sqrt(km * km + sigma * sigma)
    w = a + b * (rho * km + root)
    dw = b * (rho + km / root)
    d2w = b * sigma * sigma / (root * root * root)
    return w, dw, d2w


def svi_butterfly_margin(params, k_grid):
    """Gatheral-Jacquier butterfly density factor

        g(k) = (1 − k·w′/(2w))² − (w′²/4)·(1/w + 1/4) + w″/2

    on ``k_grid``, returned as the pointwise margin ``min(g, w)``: the slice
    is butterfly-arbitrage-free iff it is ≥ 0 everywhere (differentiable, so
    it can ride a calibration loss as a penalty)."""
    k_grid = k_grid if isinstance(k_grid, torch.Tensor) else f64(k_grid)
    w, dw, d2w = _svi_w_dw_d2w(params, k_grid)
    w_safe = torch.clamp(w, min=1e-12)
    g = ((1.0 - k_grid * dw / (2.0 * w_safe)) ** 2
         - 0.25 * dw * dw * (1.0 / w_safe + 0.25)
         + 0.5 * d2w)
    return torch.minimum(g, w)


def _slices_w(params_slices: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """w of every slice (n, 5) at ``k``: (n, *k.shape)."""
    p = params_slices.reshape((params_slices.shape[0],) + (1,) * k.ndim + (5,))
    return svi_total_variance(tuple(p[..., i] for i in range(5)), k)


def svi_calendar_margin(params_slices, k_grid):
    """Minimum of w_{i+1}(k) − w_i(k) over adjacent slices on ``k_grid``:
    ≥ 0 iff total variance is nondecreasing in maturity at fixed moneyness
    (Gatheral-Jacquier Lemma 2.1); ``params_slices`` has shape (n, 5)."""
    params_slices = f64(params_slices, device=getattr(params_slices, "device", "cpu"))
    k_grid = f64(k_grid, device=params_slices.device)
    w = _slices_w(params_slices, k_grid)
    if w.shape[0] < 2:
        return torch.tensor(float("inf"), dtype=torch.float64, device=w.device)
    return torch.min(torch.diff(w, dim=0))


@dataclasses.dataclass(frozen=True)
class SVIVolSurface:
    """Raw-SVI implied-vol surface: one (a, b, ρ, m, σ) slice per tenor.

    ``tenors`` are year fractions from ``reference_date`` (increasing),
    ``params`` (n, 5), ``forwards`` the forward levels F(tenor) that fix
    the moneyness k = log(K/F) (log-forward linear in t between tenors: a
    flat-forward-rate bridge).  Evaluations run on ``device``, where the
    tensors are moved (their autograd history kept); composes with every
    pricer through ``get_vol`` as the flat and rectangular surfaces do."""

    reference_date: Any
    tenors: Any
    params: Any
    forwards: Any
    daycount: Any = ACT365F
    device: str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))

    def _arrays(self):
        dev = resolve_device(self.device)
        return (dev, f64(self.tenors, device=dev), f64(self.params, device=dev),
                f64(self.forwards, device=dev))

    def forward_at(self, t):
        """F(t): linear log-forward interpolation, flat-forward-rate
        extrapolation from the outermost segments."""
        dev, tt, _, fwd = self._arrays()
        logf = torch.log(fwd)
        t = f64(t, device=dev)
        if tt.shape[0] == 1:
            return torch.exp(logf[0] * torch.ones_like(t))
        idx = torch.clamp(torch.searchsorted(tt, t.reshape(-1), right=True) - 1, 0,
                          tt.shape[0] - 2).reshape(t.shape)
        t0, t1 = tt[idx], tt[idx + 1]
        inner = logf[idx] + (t - t0) / (t1 - t0) * (logf[idx + 1] - logf[idx])
        lo = logf[0] + (logf[1] - logf[0]) / (tt[1] - tt[0]) * (t - tt[0])
        hi = logf[-1] + (logf[-1] - logf[-2]) / (tt[-1] - tt[-2]) * (t - tt[-1])
        return torch.exp(torch.where(t < tt[0], lo, torch.where(t > tt[-1], hi, inner)))

    def total_variance(self, t, strike):
        """w(t, k) with k = log(strike / F(t)): linear in t between the
        slices' total variances at fixed k, proportional to t outside the
        tenor range.  ``t`` is a scalar (strike any shape); loop over
        expiries for time batches."""
        if torch.as_tensor(t).ndim > 0:
            raise TypeError("SVIVolSurface.total_variance takes a scalar t; loop over "
                            "expiries for batched lookups")
        return self._paired_total_variance(t, strike)

    def _paired_total_variance(self, t, strike):
        """:meth:`total_variance` entry by entry, ``t`` broadcast against
        ``strike``."""
        dev, tt, p, _ = self._arrays()
        t, strike = torch.broadcast_tensors(f64(t, device=dev), f64(strike, device=dev))
        k = torch.log(strike / self.forward_at(t))
        w_slices = _slices_w(p, k)  # (n, *k.shape)
        if tt.shape[0] == 1:
            return w_slices[0] * (t / tt[0])
        idx = torch.clamp(torch.searchsorted(tt, t.detach().reshape(-1).contiguous(),
                                             right=True) - 1,
                          0, tt.shape[0] - 2).reshape(t.shape)
        t0, t1 = tt[idx], tt[idx + 1]
        w0 = torch.gather(w_slices, 0, idx[None])[0]
        w1 = torch.gather(w_slices, 0, (idx + 1)[None])[0]
        inner = w0 + (t - t0) / (t1 - t0) * (w1 - w0)
        below = w_slices[0] * (t / tt[0])
        above = w_slices[-1] * (t / tt[-1])
        return torch.where(t < tt[0], below, torch.where(t > tt[-1], above, inner))

    def vol_paired(self, t, strike):
        """Implied vol at pairs (t_i, strike_i), ``t`` broadcast against
        ``strike``: the per-path lookups of the local-vol engines."""
        t = f64(t, device=resolve_device(self.device))
        w = self._paired_total_variance(t, strike)
        return torch.sqrt(torch.clamp(w, min=1e-14) / torch.clamp(t, min=1e-12))

    def vol_yf(self, t, strike):
        t = f64(t, device=resolve_device(self.device))
        w = self.total_variance(t, strike)
        return torch.sqrt(torch.clamp(w, min=1e-14) / torch.clamp(t, min=1e-12))


def check_svi_arbitrage(surface: SVIVolSurface, *, k_lo=-1.5, k_hi=1.5, n=241):
    """No-arbitrage diagnostics on a moneyness grid: (butterfly margin per
    slice (n,), calendar margin); both ≥ 0 on a clean surface."""
    dev, _, p, _ = surface._arrays()
    k_grid = torch.linspace(k_lo, k_hi, n, dtype=torch.float64, device=dev)
    w = svi_butterfly_margin(tuple(p[:, None, i] for i in range(5)), k_grid[None, :])
    return torch.min(w, dim=1).values, svi_calendar_margin(p, k_grid)


# the box of the fit (the JAX package's defaults)
_DEF_LB = np.array([-0.5, 1e-6, -0.999, -2.0, 1e-4])
_DEF_UB = np.array([1.0, 5.0, 0.999, 2.0, 3.0])


def calibrate_svi_slices(tenors, forwards, strikes, ivs, *, x0=None, lb=None, ub=None,
                         weights=None, butterfly_penalty: float = 0.0, max_iters: int = 300,
                         device="cuda"):
    """Fit one raw-SVI slice per tenor to implied vols on ``device`` (the
    GPU unless the caller asks for the CPU), each slice its own bounded
    L-BFGS (math/optimize.py; the reference fits point by point,
    vol_surface.jl:215-233).

    ``strikes`` (n, m) or (m,), ``ivs`` (n, m); the loss of a slice is the
    squared total-variance residual against w = iv²·t, optionally weighted
    ((m,) weights apply to every slice), plus ``butterfly_penalty ·
    Σ relu(−margin)²`` when positive.  Returns ``(params (n, 5), loss (n,),
    converged (n,))``."""
    from ..math.optimize import minimize_lbfgs

    dev = resolve_device(device)
    tenors, forwards, ivs, strikes = (f64(x, device=dev) for x in (tenors, forwards, ivs, strikes))
    if strikes.ndim == 1:
        strikes = torch.broadcast_to(strikes, ivs.shape)
    k = torch.log(strikes / forwards[:, None])
    w_mkt = ivs * ivs * tenors[:, None]
    wts = (torch.ones_like(w_mkt) if weights is None
           else torch.broadcast_to(f64(weights, device=dev), w_mkt.shape))
    lb = f64(_DEF_LB if lb is None else lb, device=dev)
    ub = f64(_DEF_UB if ub is None else ub, device=dev)
    n = tenors.shape[0]
    if x0 is None:
        # a moment-style first guess per slice: the level from the least
        # variance, the wings from the spread, m at the smile's minimum
        w_min = torch.min(w_mkt, dim=1).values
        k_at_min = torch.gather(k, 1, torch.argmin(w_mkt, dim=1)[:, None])[:, 0]
        span = torch.clamp(torch.max(w_mkt, dim=1).values - w_min, min=1e-6)
        x0 = torch.stack([0.8 * w_min,
                          span / torch.clamp(torch.max(torch.abs(k), dim=1).values, min=0.1),
                          torch.zeros_like(w_min), k_at_min, 0.1 * torch.ones_like(w_min)],
                         dim=1)
    else:
        x0 = torch.broadcast_to(f64(x0, device=dev), (n, 5))

    params, losses, converged = [], [], []
    for i in range(n):
        k_row, w_row, wt_row = k[i], w_mkt[i], wts[i]

        def loss(p, k_row=k_row, w_row=w_row, wt_row=wt_row):
            pt = tuple(p[j] for j in range(5))
            resid = svi_total_variance(pt, k_row) - w_row
            out = torch.sum(wt_row * resid * resid)
            if butterfly_penalty > 0.0:
                margin = svi_butterfly_margin(pt, k_row)
                out = out + butterfly_penalty * torch.sum(torch.clamp(-margin, min=0.0) ** 2)
            return out

        res = minimize_lbfgs(loss, x0[i], lb, ub, max_iters=max_iters)
        params.append(res.x)
        losses.append(res.loss)
        converged.append(res.converged)
    return (torch.stack(params), torch.stack(losses),
            torch.tensor(converged, dtype=torch.bool, device=dev))
