"""Full-truncation log-Euler Heston paths in float64 torch.

Port of ``_heston_euler_paths`` / ``_cir_log_euler_paths`` from
``hedgehog_tpu/methods/montecarlo.py`` (heston.jl:7-31 semantics) for the
Heston case (identity leverage, flat drift r0) and terminal prices:

  logS += (r0 − V⁺/2)dt + √(V⁺ dt)·Z₁
  V    += κ(θ − V⁺)dt + σ√(V⁺ dt)·(ρZ₁ + √(1−ρ²)Z₂),  V⁺ = max(V, 0)

Normals come from the Philox layout of the Euler kernel
(csrc/hh_device.cuh) in float64, or under ``qmc=True`` from the JAX
package's layout: Sobol' dims step-major × (Z₁, Z₂), each Brownian path
built by bridge ordering (math/brownian_bridge.py).  Every market field
given as a tensor keeps its autograd history and forward tangents (the
pathwise greeks).  ``return_grid=True``
returns every step's price (the grid of ``simulate_price_grid``) from the
same draws.
"""

from __future__ import annotations

import math

import torch

from ..math.brownian_bridge import brownian_bridge_increments
from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64
from .montecarlo import Antithetic, sim_params

__all__ = ["heston_euler_paths"]

_MASK32 = 0xFFFFFFFF


def _bridge_normals(config, key, dt, point_offset, device) -> torch.Tensor:
    """(steps, 2, paths) unit normals from a randomized Sobol' grid with both
    driving Brownians bridge-ordered (the JAX ``_two_factor_grid_normals``)."""
    steps, paths = config.steps, config.trajectories
    u = sobol_uniforms(prng_key(config.seed) if key is None else key, paths, 2 * steps,
                       skip=point_offset, device=device)
    z = torch.special.ndtri(u).reshape(paths, steps, 2)
    dw = torch.stack([brownian_bridge_increments(z[:, :, c], dt, steps) for c in range(2)])
    return dw.permute(2, 0, 1) / math.sqrt(dt)  # (2, paths, steps) → (steps, 2, paths)


def heston_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *,
                       device, return_grid: bool = False) -> torch.Tensor:
    """Terminal prices (n_groups, trajectories), or with ``return_grid`` the
    grid (n_groups, steps + 1, trajectories), float64."""
    market, T, r0 = sim_params(prob)
    steps = config.steps
    dt = T / steps
    sqrt_dt = math.sqrt(dt)
    spot, v0, kappa, theta, sigma, rho, r0 = (
        f64(x, device=device) for x in (market.spot, market.V0, market.kappa, market.theta,
                                        market.sigma, market.rho, r0))
    rho_bar = torch.sqrt(1.0 - rho**2)
    anti = isinstance(config.variance_reduction, Antithetic)
    zeros = torch.zeros((2 if anti else 1, config.trajectories), dtype=torch.float64,
                        device=device)
    x, v = zeros + torch.log(spot), zeros + v0
    sign = torch.tensor([1.0, -1.0] if anti else [1.0], dtype=torch.float64, device=device)[:, None]
    if config.qmc:
        zq = _bridge_normals(config, key, dt, point_offset, device)
    else:
        seed = seed_from_key(config, key)
        pair = torch.arange(config.trajectories, dtype=torch.int64, device=device)
    xs = [x]
    for s in range(steps):
        if config.qmc:
            z1, z2 = zq[s, 0], zq[s, 1]
        else:
            if s % 2 == 0:
                words = philox_block(pair, s // 2, seed & _MASK32, device_id & _MASK32)
            z1, z2 = box_muller(words[2 * (s % 2)], words[2 * (s % 2) + 1], dtype=torch.float64)
        z1, z2 = sign * z1, sign * z2
        v_plus = torch.clamp(v, min=0.0)
        # double where: sqrt'(0) = inf would turn a truncated path's zero
        # cotangent into NaN
        sqrt_v = torch.where(v > 0.0, torch.sqrt(torch.where(v > 0.0, v, 1.0)), 0.0)
        x = x + (r0 - 0.5 * v_plus) * dt + sqrt_v * sqrt_dt * z1
        v = v + kappa * (theta - v_plus) * dt + sigma * sqrt_v * sqrt_dt * (rho * z1 + rho_bar * z2)
        xs.append(x)
    if return_grid:
        return torch.exp(torch.stack(xs, dim=1))
    return torch.exp(x)
