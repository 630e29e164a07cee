"""The one-simulation (expiry × strike) rough-Bergomi surface, float64 torch.

Port of ``rbergomi_surface_mc`` from ``hedgehog_tpu/methods/montecarlo.py``:
ONE exact-Volterra simulation on a non-uniform grid that contains every
expiry (each gap's steps proportional to its length, ``config.steps`` in
all: :func:`~.heston_surface.surface_seg_steps`, the Heston surface's rule),
the cumulative mixing factors (∫V dt, ∫√V dW₁) read at each expiry's grid
index, and every strike closed there with the conditional Black-Scholes
formula, so all points share their paths.

Draws, 2n standard normals ξ per path over the whole grid's n steps
(``methods.rough_bergomi_mixing.rbergomi_xi``):

- QMC: Sobol' dims 0..2n−1 of point ``point_offset + path`` shifted by the
  unsplit base key through the exact inverse normal CDF: the JAX package's
  points, bit for bit;
- PRNG: the rough-Bergomi Philox layout of the kernels over the 2n rows (the
  JAX package draws ``jax.random.normal``, whose bits the port cannot match).

Every market field that is a tensor keeps its autograd history (the
forward-variance curve's too), so the surface is a differentiable
calibration objective; ``fp32=True`` runs the draws, the product and the
sums in float32 (the close stays float64).
"""

from __future__ import annotations

import torch

from ..market.inputs import carry_yield
from ..market.rate_curve import zero_rate_yf
from ..models.rough_bergomi import rbergomi_variance, volterra_cov
from ..utils import f64, resolve_device
from .heston_surface import _surface_close_row, surface_seg_steps, validate_surface_expiries
from .montecarlo import Antithetic
from .rough_bergomi_mixing import rbergomi_xi

__all__ = ["rbergomi_surface_mc", "surface_times"]


def surface_times(T_host, steps: int):
    """(grid times t_1 < … < t_n as floats, each expiry's index in them):
    ``steps`` split over the expiry gaps by ``surface_seg_steps``, uniform
    within a gap, each gap ending exactly on its expiry."""
    seg_len, seg_steps = surface_seg_steps(T_host, steps)
    times, exp_idx, prev = [], [], 0.0
    for length, m_i, T_i in zip(seg_len, seg_steps, T_host):
        times += [prev + (k + 1) * length / m_i for k in range(m_i)]
        times[-1] = T_i
        exp_idx.append(len(times) - 1)
        prev = T_i
    return times, exp_idx


def rbergomi_surface_mc(market, expiries, strikes, config, cp=1.0, key=None, point_offset=0,
                        quad_nodes: int = 64, fp32: bool = False, *, device_id=0,
                        device="cuda") -> torch.Tensor:
    """A whole (expiry × strike) European vanilla surface under rough
    Bergomi from ONE exact-Volterra simulation: (n_expiries, n_strikes)
    DISCOUNTED prices, float64 on ``device`` (the GPU unless the caller asks
    for the CPU).  ``expiries``: dates or ticks, strictly increasing; ``cp``:
    +1 call, −1 put."""
    T_host = validate_surface_expiries(market, expiries)
    dev = resolve_device(device)
    times, exp_idx = surface_times(T_host, config.steps)
    t = torch.tensor(times, dtype=torch.float64)
    n = len(times)
    cov = volterra_cov(market.hurst, t, quad_nodes=quad_nodes)
    jitter = 1e-12 * torch.max(torch.diagonal(cov))
    chol = torch.linalg.cholesky(cov + jitter * torch.eye(2 * n, dtype=cov.dtype))
    dtype = torch.float32 if fp32 else torch.float64
    chol = chol.to(device=dev, dtype=dtype)
    xi = rbergomi_xi(config, 2 * n, key, device_id, point_offset, device=dev).to(dtype)
    xi = torch.stack([xi, -xi]) if isinstance(config.variance_reduction, Antithetic) else xi[None]
    x = torch.matmul(chol, xi)
    dw, z = x[:, :n], x[:, n:]

    t = t.to(dev)
    t_left = torch.cat([torch.zeros(1, dtype=t.dtype, device=dev), t[:-1]])
    z_left = torch.cat([torch.zeros_like(z[:, :1]), z[:, :-1]], dim=1)
    v = rbergomi_variance(market, z_left, t_left[None, :, None])
    cum_iv = torch.cumsum(v * (t - t_left).to(dtype)[None, :, None], dim=1)
    cum_j = torch.cumsum(torch.sqrt(v) * dw, dim=1)

    r0 = zero_rate_yf(market.rate, 0.0) - f64(carry_yield(market))
    strikes = f64(strikes, device=dev)
    rows = [_surface_close_row(market, T_host[i], r0.to(dev), cum_iv[:, k].double(),
                               cum_j[:, k].double(), strikes, cp)
            for i, k in enumerate(exp_idx)]
    return torch.stack(rows)
