"""The QE mixing estimator in float64 torch: a QE variance path, then the
conditional Black-Scholes close.

Port of ``_heston_qe_mixing_values`` from ``hedgehog_tpu/methods/montecarlo.py``
(the Romano–Touzi conditional estimator behind
``MonteCarlo(HestonDynamics(), HestonQE(conditional=True))``).  Only V is
simulated; with the CIR identity J = ∫√V dW_v = (V_T − V_0 − κθT + κ·IV)/σ,
logS_T given the path is normal with forward S0·e^{rT + ρJ − ρ²IV/2} and
variance (1 − ρ²)·IV, and IV is the trapezoid sum of the path.

Draws, one normal z and one uniform u per step and path:

- QMC: Sobol' dims 2s (z, by the exact inverse normal CDF) and 2s + 1 (u),
  randomized from the unsplit base key (default: the config's seed), the
  JAX package's ``_qmc_normals_and_uniforms(base, steps, 1, paths)``; the
  QE kernels' in-kernel Sobol' stream draws the same points;
- PRNG: the QE mixing Philox layout of the kernels (csrc/hh_device.cuh),
  uniforms and Box–Muller normals in float64.

Every market field that is a tensor keeps its autograd history.
"""

from __future__ import annotations

import torch

from ..math.counter_rng import prng_key, uniform_from_bits
from ..math.sobol import sobol_uniforms
from ..models.heston_qe import qe_constants, qe_v_step
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64
from .heston_exact_mixing import _conditional_bs_close
from .montecarlo import Antithetic, sim_params

__all__ = ["heston_qe_mixing_values", "qe_mixing_draws"]

_MASK32 = 0xFFFFFFFF


def qe_mixing_draws(config, key=None, device_id=0, point_offset=0, *, device):
    """(z, u), each (steps, n_groups, trajectories) float64 on ``device``;
    the antithetic group holds −z and 1 − u."""
    steps, paths = config.steps, config.trajectories
    if config.qmc:
        u = sobol_uniforms(prng_key(config.seed) if key is None else key, paths, 2 * steps,
                           skip=point_offset, device=device).reshape(paths, steps, 2)
        z, u = torch.special.ndtri(u[..., 0]).T, u[..., 1].T
    else:
        # step s: Philox block s // 2 of the pair; Box–Muller of words 0, 1
        # gives (z of step 2k, z of step 2k + 1), words 2, 3 their uniforms
        seed = seed_from_key(config, key) & _MASK32
        pair = torch.arange(paths, dtype=torch.int64, device=device)
        zs, us = [], []
        for s in range(steps):
            if s % 2 == 0:
                w = philox_block(pair, s // 2, seed, device_id & _MASK32)
                normals = box_muller(w[0], w[1], dtype=torch.float64)
            zs.append(normals[s % 2])
            us.append(uniform_from_bits(w[2 + s % 2]).double())
        z, u = torch.stack(zs), torch.stack(us)
    if isinstance(config.variance_reduction, Antithetic):
        return torch.stack([z, -z], dim=1), torch.stack([u, 1.0 - u], dim=1)
    return z[:, None], u[:, None]


def heston_qe_mixing_values(prob, config, key=None, device_id=0, point_offset=0, *,
                            device):
    """Per-path UNDISCOUNTED conditional vanilla values (n_groups, paths),
    float64; a strike grid gives (n_groups, m, paths) from one path set."""
    market, T, r0 = sim_params(prob)
    dt = T / config.steps
    v0, kappa, theta, sigma, rho, r0 = (
        f64(x, device=device)
        for x in (market.V0, market.kappa, market.theta, market.sigma, market.rho, r0))
    c = qe_constants(kappa, theta, sigma, rho, r0, dt)
    zs, us = qe_mixing_draws(config, key, device_id, point_offset, device=device)
    ktd = kappa * theta * dt
    v = v0 + torch.zeros(zs.shape[1:], dtype=torch.float64, device=device)
    iv = torch.zeros_like(v)
    j = torch.zeros_like(v)
    for z, u in zip(zs, us):
        v_new = qe_v_step(v, z, u, c)
        iv_step = 0.5 * dt * (v + v_new)
        j = j + (v_new - v - ktd + kappa * iv_step) / sigma
        iv = iv + iv_step
        v = v_new
    return _conditional_bs_close(prob, market, T, r0, iv, j)
