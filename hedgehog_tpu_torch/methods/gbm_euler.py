"""Log-Euler GBM paths in float64 torch: terminal prices or the whole grid.

Port of ``_gbm_euler_paths`` from ``hedgehog_tpu/methods/montecarlo.py``
(behind ``MonteCarlo(LognormalDynamics(), EulerMaruyama())`` and every
lognormal ``simulate_price_grid``): per step
``x += (r0 − σ²/2)·Δ + σ·√Δ·Z``, which is the exact lognormal transition,
so the grid is exact at its dates.  The normals:

- QMC: Sobol' dims 0..steps − 1 through the exact inverse normal CDF,
  randomized by the unsplit base key (the caller's, or
  ``PRNGKey(config.seed)``), ordered by the Brownian bridge (dim 0 drives
  W(T); math/brownian_bridge.py): the JAX package's points;
- PRNG: the port's Philox layout, Philox block s // 4 of each pair with
  Box–Muller of words (0, 1) and (2, 3) giving the normals of steps
  4k .. 4k + 3, in float64.

Antithetic pairs negate Z.  A spot, rate or vol given as a tensor keeps its
autograd history.  Discrete cash dividends wait for ``market/dividends.py``.
"""

from __future__ import annotations

import math

import torch

from ..market.vol_surface import FlatVolSurface, get_vol
from ..math.brownian_bridge import brownian_bridge_increments
from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64
from .montecarlo import Antithetic, sim_params

__all__ = ["gbm_euler_paths"]

_MASK32 = 0xFFFFFFFF


def _step_normals(config, key=None, device_id=0, point_offset=0, *, dt, device) -> torch.Tensor:
    """(steps, trajectories) unit normals of the log-Euler steps (QMC:
    bridge-ordered Sobol' points; PRNG: the Philox layout above)."""
    steps, paths = config.steps, config.trajectories
    if config.qmc:
        base = prng_key(config.seed) if key is None else key
        zq = torch.special.ndtri(sobol_uniforms(base, paths, steps, skip=point_offset,
                                                device=device))
        return (brownian_bridge_increments(zq, dt, steps) / math.sqrt(dt)).T
    seed = seed_from_key(config, key)
    pair = torch.arange(paths, dtype=torch.int64, device=device)
    cols = []
    for k in range(-(-steps // 4)):
        w = philox_block(pair, k, seed & _MASK32, device_id & _MASK32)
        cols.extend(box_muller(w[0], w[1], dtype=torch.float64))
        cols.extend(box_muller(w[2], w[3], dtype=torch.float64))
    return torch.stack(cols[:steps])


def gbm_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, return_grid: bool,
                    device) -> torch.Tensor:
    """Terminal prices (n_groups, trajectories), or with ``return_grid`` the
    grid (n_groups, steps + 1, trajectories), float64 on ``device``."""
    market, T, r0 = sim_params(prob)
    if getattr(market, "dividends", None) is not None:
        raise TypeError(
            "discrete cash dividends on the GBM grid wait for market/dividends.py, "
            "which the port does not have yet"
        )
    sigma = (market.sigma.sigma if isinstance(market.sigma, FlatVolSurface)
             else get_vol(market.sigma, prob.payoff.expiry, market.spot))
    sigma, r0 = f64(sigma, device=device), f64(r0, device=device)
    steps = config.steps
    dt = T / steps
    z = _step_normals(config, key, device_id, point_offset, dt=dt, device=device)
    z = torch.stack([z, -z], dim=1) if isinstance(config.variance_reduction, Antithetic) else z[:, None]
    drift = (r0 - 0.5 * sigma**2) * dt
    vol_dt = sigma * math.sqrt(dt)
    x = torch.zeros(z.shape[1:], dtype=torch.float64, device=device) + torch.log(
        f64(market.spot, device=device))
    xs = [x]
    for k in range(steps):
        x = x + drift + vol_dt * z[k]
        xs.append(x)
    if return_grid:
        return torch.exp(torch.stack(xs, dim=1))
    return torch.exp(x)
