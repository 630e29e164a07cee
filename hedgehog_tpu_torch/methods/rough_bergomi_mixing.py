"""The rough-Bergomi mixing estimator in torch: exact Volterra draws, the
left-point variance, and the conditional Black-Scholes close; and the
log-Euler spot grid on the same draws.

Port of ``_rbergomi_draws``, ``_rbergomi_left_variance``,
``_rbergomi_mixing_values``, ``_rbergomi_grid_with_variance`` and
``_rbergomi_euler_paths`` from ``hedgehog_tpu/methods/montecarlo.py``
(``MonteCarlo(RoughBergomiDynamics(), RoughBergomiMixing())`` and
``MonteCarlo(RoughBergomiDynamics(), EulerMaruyama())``).  Conditional
on the W1 path, log S_T is normal with the mixing factors IV = Σ V_k Δt and
J = Σ √V_k ΔW_k, so each path closes with the Black-Scholes formula.  The
left-point rule keeps the mixing forward exactly unbiased at any step count.

Draws, 2n standard normals ξ per path (the rows of X = L·ξ), and n more
for the Euler grid's orthogonal spot leg (rows 2n..3n−1):

- QMC: Sobol' dims 0..2n−1 (0..3n−1) of point ``point_offset + path``, randomized by
  the unsplit base key (default: the config's seed), through the exact
  inverse normal CDF: the JAX package's points, bit for bit;
- PRNG: the rough-Bergomi Philox layout of the kernels (csrc/rbergomi.cu):
  block b of pair i gives rows 4b..4b+3 by two Box–Muller pairs whose
  radius uniform lies in (0, 1) (``hh_device.box_muller_open``), here in
  float64.

On both streams a row depends on its index only, so the first 2n rows of
a 3n-row draw are the 2n-row draw's, bit for bit.

The bulk is float64 (``fp32=True``: draws, product and sums in float32, as
the JAX package's TPU serving variant; the close stays float64).  It
materialises (groups, 2n, paths) values: 2^20 pairs at 64 steps take about
2 GB.  Every market field that is a tensor keeps its autograd history.
"""

from __future__ import annotations

import math

import torch

from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..models.rough_bergomi import rbergomi_variance, volterra_chol
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller_open, philox_block
from .heston_exact_mixing import _conditional_bs_close
from ..utils import f64
from .montecarlo import Antithetic, sim_params

__all__ = ["rbergomi_euler_paths", "rbergomi_grid_with_variance", "rbergomi_mixing_values",
           "rbergomi_xi"]

_MASK32 = 0xFFFFFFFF


def rbergomi_xi(config, rows: int, key=None, device_id=0, point_offset=0, *,
                device) -> torch.Tensor:
    """(rows, trajectories) float64 standard normals ξ: Sobol' dims 0..rows−1
    through the exact ``ndtri`` under QMC, else the Philox layout (block b
    → rows 4b..4b+3, ``box_muller_open``)."""
    paths = config.trajectories
    if config.qmc:
        u = sobol_uniforms(prng_key(config.seed) if key is None else key, paths, rows,
                           skip=point_offset, device=device)
        return torch.special.ndtri(u).T
    seed = seed_from_key(config, key) & _MASK32
    pair = torch.arange(paths, dtype=torch.int64, device=device)
    out = []
    for b in range(-(-rows // 4)):
        w = philox_block(pair, b, seed, device_id & _MASK32)
        out += [*box_muller_open(w[0], w[1], dtype=torch.float64),
                *box_muller_open(w[2], w[3], dtype=torch.float64)]
    return torch.stack(out[:rows])


def _rbergomi_draws(prob, config, key, point_offset, quad_nodes: int, dtype, device_id,
                    device, n_extra: int = 0):
    """Exact joint (ΔW1 increments, Z grid points), each (g, n, paths) with
    g = 2 under antithetic pairing: one (2n × 2n) Cholesky factor, then one
    product; and the ``n_extra`` iid normal rows after them, (g, n_extra,
    paths), or None."""
    market, T, _ = sim_params(prob)
    n = config.steps
    chol = volterra_chol(market.hurst, T, n, quad_nodes=quad_nodes).to(device=device, dtype=dtype)
    xi = rbergomi_xi(config, 2 * n + n_extra, key, device_id, point_offset,
                     device=device).to(dtype)
    xi = torch.stack([xi, -xi]) if isinstance(config.variance_reduction, Antithetic) else xi[None]
    x = torch.matmul(chol, xi[:, : 2 * n])
    return x[:, :n], x[:, n:], (xi[:, 2 * n:] if n_extra else None)


def _rbergomi_left_variance(market, z, T, n):
    """Variance at the grid's left points, (g, n, paths): V_0 = ξ₀ exactly,
    V_{t_k} from the exact Volterra samples (k = 1..n−1)."""
    z_left = torch.cat([torch.zeros_like(z[:, :1]), z[:, : n - 1]], dim=1)
    t_left = (torch.arange(n, dtype=torch.float64, device=z.device) / n) * T
    return rbergomi_variance(market, z_left, t_left[None, :, None])


def rbergomi_mixing_values(prob, config, key=None, device_id=0, point_offset=0, quad_nodes=64,
                           fp32: bool = False, *, device) -> torch.Tensor:
    """Per-path UNDISCOUNTED conditional vanilla values (n_groups, paths)
    float64 on ``device``; a strike grid gives (n_groups, m, paths) from one
    path set."""
    market, T, r0 = sim_params(prob)
    n = config.steps
    dtype = torch.float32 if fp32 else torch.float64
    dw, z, _ = _rbergomi_draws(prob, config, key, point_offset, quad_nodes, dtype, device_id,
                               device)
    v = _rbergomi_left_variance(market, z, T, n)
    iv = torch.sum(v, dim=1) * torch.tensor(T / n, dtype=dtype, device=device)
    j = torch.sum(torch.sqrt(v) * dw, dim=1)
    return _conditional_bs_close(prob, market, T, r0, iv.double(), j.double())


def rbergomi_grid_with_variance(prob, config, key=None, device_id=0, point_offset=0,
                                quad_nodes: int = 64, *, device):
    """(spot grid (g, n + 1, paths), left-point variance (g, n, paths)),
    float64: the variance exact at the grid points, the spot log-Euler with
    the left-point variance,
    ΔlogS_k = (r − q − V_k/2)Δt + √V_k·(ρ·ΔW_k + √(1 − ρ²)·√Δt·Z⊥_k).
    Within a segment the log-bridge variance is V_k·Δt."""
    market, T, r0 = sim_params(prob)
    n = config.steps
    dt = T / n
    dw, z, zp = _rbergomi_draws(prob, config, key, point_offset, quad_nodes, torch.float64,
                                device_id, device, n_extra=n)
    v = _rbergomi_left_variance(market, z, T, n)
    spot, rho, r0 = (f64(x, device=device) for x in (market.spot, market.rho, r0))
    dlog = (r0 - 0.5 * v) * dt + torch.sqrt(v) * (
        rho * dw + torch.sqrt(1.0 - rho**2) * math.sqrt(dt) * zp)
    logs = torch.log(spot) + torch.cat(
        [torch.zeros_like(dlog[:, :1]), torch.cumsum(dlog, dim=1)], dim=1)
    return torch.exp(logs), v


def rbergomi_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *,
                         return_grid: bool, device, quad_nodes: int = 64) -> torch.Tensor:
    """Rough-Bergomi spot paths: terminal (g, paths) or the grid
    (g, n + 1, paths) of :func:`rbergomi_grid_with_variance`."""
    grid, _ = rbergomi_grid_with_variance(prob, config, key, device_id, point_offset,
                                          quad_nodes, device=device)
    return grid if return_grid else grid[:, -1]
