"""The QE-M terminal sampler in float64 torch: Andersen's QE variance draw
and the martingale-corrected log-price step, path by path.

Port of ``_heston_qe_paths`` from ``hedgehog_tpu/methods/montecarlo.py`` for
terminal prices (``return_grid=False``; the grid output waits for the
path-dependent payoffs), behind ``MonteCarlo(HestonDynamics(), HestonQE())``.
Draws, two normals (z_v, z_x) and one uniform u per step and path:

- QMC: Sobol' dims 3s (z_v), 3s + 1 (z_x), 3s + 2 (u), normals by the exact
  inverse normal CDF, randomized by the first key of ``split(base)`` with the
  base key the caller's or ``PRNGKey(config.seed)`` (the JAX package's
  ``_qmc_normals_and_uniforms(k_z, steps, 2, paths)``), so the points are
  bit-identical to JAX's.  The QE-M kernel's in-kernel stream is randomized
  by the unsplit seed instead, as the TPU kernel's is;
- PRNG: the QE-M Philox layout of the kernels (``qem_draws`` of
  ops/heston_qe_kernel.py), the Box–Muller normals and the uniform in
  float64.

Antithetic pairs mirror z → −z and u → 1 − u.  Every market field that is a
tensor keeps its autograd history.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.counter_rng import prng_key, split
from ..math.sobol import sobol_uniforms
from ..models.heston_qe import qe_constants, qe_step
from ..ops.heston_kernel import seed_from_key
from ..ops.heston_qe_kernel import qem_draws
from ..utils import f64
from .montecarlo import Antithetic, sim_params

__all__ = ["heston_qe_paths", "qe_m_draws"]


def qe_m_draws(config, key=None, device_id=0, point_offset=0, *, device):
    """(z_v, z_x, u), each (steps, n_groups, trajectories) float64 on
    ``device``; the antithetic group holds −z_v, −z_x and 1 − u."""
    steps, paths = config.steps, config.trajectories
    if config.qmc:
        base = prng_key(config.seed) if key is None else np.asarray(key, dtype=np.uint32)
        u = sobol_uniforms(split(base)[0], paths, 3 * steps, skip=point_offset,
                           device=device).reshape(paths, steps, 3)
        z = torch.special.ndtri(u[..., :2])
        z_v, z_x, u = z[..., 0].T, z[..., 1].T, u[..., 2].T
    else:
        pair = torch.arange(paths, dtype=torch.int64, device=device)
        draws = qem_draws(pair, steps, None, seed_from_key(config, key), device_id, 0,
                          dtype=torch.float64)
        z_v, z_x, u = (torch.stack(c) for c in zip(*draws))
    if isinstance(config.variance_reduction, Antithetic):
        return (torch.stack([z_v, -z_v], dim=1), torch.stack([z_x, -z_x], dim=1),
                torch.stack([u, 1.0 - u], dim=1))
    return z_v[:, None], z_x[:, None], u[:, None]


def heston_qe_paths(prob, config, strat, key=None, device_id=0, point_offset=0, *, device):
    """Terminal prices (n_groups, trajectories), float64."""
    market, T, r0 = sim_params(prob)
    dt = T / config.steps
    spot, v0, kappa, theta, sigma, rho, r0 = (
        f64(x, device=device)
        for x in (market.spot, market.V0, market.kappa, market.theta, market.sigma, market.rho,
                  r0))
    c = qe_constants(kappa, theta, sigma, rho, r0, dt)
    z_v, z_x, u = qe_m_draws(config, key, device_id, point_offset, device=device)
    zeros = torch.zeros(z_v.shape[1:], dtype=torch.float64, device=device)
    x, v = torch.log(spot) + zeros, v0 + zeros
    for k in range(config.steps):
        x, v = qe_step(x, v, z_v[k], z_x[k], u[k], c,
                       martingale_correction=strat.martingale_correction)
    return torch.exp(x)
