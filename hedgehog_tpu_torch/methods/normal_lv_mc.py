"""Monte Carlo of the normal and local-vol families in float64 torch:
Bachelier, CEV, SABR, Dupire local vol and SLV.

Port of ``_bachelier_exact_terminal``, ``_bachelier_euler_paths``,
``_cev_euler_paths``, ``_sabr_euler_paths``, ``_local_vol_euler_paths`` and
``_slv_euler_paths`` of ``hedgehog_tpu/methods/montecarlo.py``; the SLV
paths step on the Heston Euler stepper (methods/heston_euler.py).  Each returns
terminal prices (n_groups, paths) or the grid (n_groups, steps + 1, paths),
n_groups = 2 under antithetic pairing (the twin negates the normals).

- Bachelier: F_T = F₀ + σ_N√T·Z exactly; the Euler grid's increments are
  the exact arithmetic-Brownian transitions, converted to spot by the
  deterministic S_t = F_t·D(T)/D(t)·e^{q(T−t)}.
- CEV: price-space Euler, S' = max(S·(1 + f_k·Δt) + σ·S^β·√Δt·Z, 0), the
  floor being the absorption (a double ``torch.where`` gives absorbed paths
  a literal zero diffusion, so their gradient stays finite).
- SABR on the T-forward: F' = max(F + α·max(F, 0)^β·√Δt·Z₁, 0) and α
  stepped exactly lognormal with Z_v = ρZ₁ + √(1−ρ²)Z₂; the grid converts
  to spot as Bachelier's.
- Local vol: log-Euler with σ_loc(t_k, S) from ``dupire_local_vol`` per
  path and the curve's exact per-step forward rates, so a flat surface
  steps exact GBM.
- SLV: the full-truncation log-Euler of the CIR family with the leverage
  L(t_k, S), the curve's forward rates and the mixing-scaled vol of vol.

Every max(·, 0) takes JAX's gradient tie rule (half to each side), as
``jnp.maximum`` does.

Draws.  Under QMC, Sobol' points of the unsplit base key in the JAX
package's layouts, so every path equals JAX's: Bachelier's exact draw dim
0; one normal a step (dim s) for the Bachelier grid, bridge-ordered, and
for CEV and local vol, not bridge-ordered; SABR two normals a step, dims
2s (Z₁) and 2s + 1 (Z₂).  Under PRNG, Philox (key (seed, device_id),
counter (pair & 0xffffffff, pair >> 32, block, tag)), block s at step s
(the exact draw block 0), words 0, 1 → Box–Muller (Z₁, Z₂); the
one-normal routes take Z₁.  A tag of its own per family: ``BACHELIER_TAG``
(so the one-step grid draws the exact sampler's normal), ``CEV_TAG``,
``SABR_TAG``, ``LOCAL_VOL_TAG``; SLV draws the Heston Euler stream (tag 0),
QMC as the Heston grid (both Brownians bridge-ordered).  The JAX package draws
``jax.random.normal``, which the port does not replay: under PRNG the two
agree in law.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..market.inputs import carry_yield, forward_spot, market_yearfrac
from ..market.rate_curve import df, df_yf
from ..math.brownian_bridge import brownian_bridge_increments
from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..models.local_vol import dupire_local_vol
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64
from .heston_euler import heston_euler_paths
from .montecarlo import Antithetic, _require_no_dividend_schedule

__all__ = [
    "bachelier_exact_terminal",
    "bachelier_euler_paths",
    "cev_euler_paths",
    "sabr_euler_paths",
    "local_vol_euler_paths",
    "slv_euler_paths",
    "forward_ratio",
]

_MASK32 = 0xFFFFFFFF
#: Philox counter tags (the counter's last word) of the families' streams
BACHELIER_TAG = 0x62616368  # "bach"
CEV_TAG = 0x63657620  # "cev "
SABR_TAG = 0x73616272  # "sabr"
LOCAL_VOL_TAG = 0x6C766F6C  # "lvol"


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s tie rule."""
    return torch.maximum(x, torch.zeros_like(x))


def _paired(z: torch.Tensor, anti: bool) -> torch.Tensor:
    """The antithetic group axis in front: (z, −z) or (z,)."""
    return torch.stack([z, -z]) if anti else z[None]


def _draws(config, key, device_id, point_offset, device, *, tag: int, comps: int,
           bridge_dt=None) -> torch.Tensor:
    """(comps, n_groups, steps, paths) unit normals of a per-step route:
    Sobol' dims comps·s + c of the unsplit base key under QMC (dim c's
    normals bridge-ordered when ``bridge_dt`` is given), else Box–Muller of
    words 0, 1 of Philox block s under ``tag``."""
    steps, paths = config.steps, config.trajectories
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        base = prng_key(config.seed) if key is None else key
        u = sobol_uniforms(base, paths, steps * comps, skip=point_offset, device=device)
        z = torch.special.ndtri(u).reshape(paths, steps, comps).permute(2, 1, 0)
        if bridge_dt is not None:
            z = torch.stack([(brownian_bridge_increments(zc.T, bridge_dt, steps)
                              / math.sqrt(bridge_dt)).T for zc in z])
    else:
        seed = seed_from_key(config, key) & _MASK32
        pair = torch.arange(paths, dtype=torch.int64, device=device)
        cols = []
        for s in range(steps):
            w = philox_block(pair, s, seed, device_id & _MASK32, tag)
            cols.append(torch.stack(box_muller(w[0], w[1], dtype=torch.float64)[:comps]))
        z = torch.stack(cols, dim=1)  # (comps, steps, paths)
    return torch.stack([_paired(zc, anti) for zc in z])


def _forward_rates(market, T: float, steps: int, device) -> torch.Tensor:
    """The curve's exact per-step forward rates less the carry, (steps,)."""
    dt = T / steps
    d_grid = df_yf(market.rate, torch.arange(steps + 1, dtype=torch.float64, device=device) * dt)
    return torch.log(d_grid[:-1] / d_grid[1:]) / dt - f64(carry_yield(market), device=device)


def forward_ratio(market, T: float, steps: int, device) -> torch.Tensor:
    """c(t_k) = S_t/F_t = D(T)/D(t_k)·e^{q(T−t_k)} at the grid times,
    (steps + 1,): exact for the deterministic rate and carry."""
    t_k = torch.arange(steps + 1, dtype=torch.float64, device=device) * (T / steps)
    q = f64(carry_yield(market), device=device)
    return df_yf(market.rate, f64(T, device=device)) / df_yf(market.rate, t_k) * torch.exp(
        q * (T - t_k))


def _forward_to_spot(market, T: float, steps: int, grid: torch.Tensor) -> torch.Tensor:
    """A (steps + 1, g, paths) T-forward grid as the (g, steps + 1, paths)
    spot grid."""
    ratio = forward_ratio(market, T, steps, grid.device)
    return torch.movedim(grid * ratio[:, None, None], 0, 1)


def _bachelier_forward_vol(prob, device):
    """(F₀, σ_N, T) of a Bachelier market at the problem's expiry, F₀ the
    carry-adjusted T-forward."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    f0 = forward_spot(market, T, device=device) / df(market.rate, prob.payoff.expiry).to(device)
    return f0, f64(market.sigma, device=device), T


def bachelier_exact_terminal(prob, config, key=None, device_id=0, point_offset=0, *,
                             device) -> torch.Tensor:
    """(n_groups, paths) Bachelier terminal prices F₀ + σ_N√T·Z."""
    f0, sigma_n, T = _bachelier_forward_vol(prob, device)
    z = _draws(dataclasses.replace(config, steps=1), key, device_id, point_offset, device,
               tag=BACHELIER_TAG, comps=1)[0, :, 0]
    return f0 + sigma_n * math.sqrt(T) * z


def bachelier_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                          return_grid: bool) -> torch.Tensor:
    """Bachelier paths on the T-forward, F' = F + σ_N√Δt·Z (exact
    transitions; under QMC the bridge-ordered dim 0 drives F_T, so the
    terminal draw equals the exact sampler's); the grid in spot."""
    f0, sigma_n, T = _bachelier_forward_vol(prob, device)
    steps = config.steps
    dt = T / steps
    z = _draws(config, key, device_id, point_offset, device, tag=BACHELIER_TAG, comps=1,
               bridge_dt=dt)[0]
    vol_dt = sigma_n * math.sqrt(dt)
    f = f0 + torch.zeros((z.shape[0], config.trajectories), dtype=torch.float64, device=device)
    fs = [f]
    for k in range(steps):
        f = f + vol_dt * z[:, k]
        fs.append(f)
    if return_grid:
        return _forward_to_spot(prob.market_inputs, T, steps, torch.stack(fs))
    return f


def cev_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                    return_grid: bool) -> torch.Tensor:
    """CEV Euler paths in price space (the log diffusion σ·S^{β−1} blows up
    as S → 0; the price SDE is where the absorbing boundary lives)."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    sq = math.sqrt(dt)
    z = _draws(config, key, device_id, point_offset, device, tag=CEV_TAG, comps=1)[0]
    fwd = _forward_rates(market, T, steps, device)
    sigma, beta, spot = (f64(x, device=device) for x in (market.sigma, market.beta, market.spot))
    s = spot + torch.zeros((z.shape[0], config.trajectories), dtype=torch.float64, device=device)
    ss = [s]
    for k in range(steps):
        # double where: d(s^β)/ds is infinite at the boundary, so an absorbed
        # path sees a literal zero diffusion
        alive = s > 0.0
        s_safe = torch.where(alive, s, 1.0)
        diffusion = torch.where(alive, sigma * s_safe**beta, 0.0)
        s = _relu(s * (1.0 + fwd[k] * dt) + diffusion * sq * z[:, k])
        ss.append(s)
    return torch.stack(ss, dim=1) if return_grid else s


def sabr_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                     return_grid: bool) -> torch.Tensor:
    """SABR Euler paths under the T-forward measure, where F is driftless
    and F_T = S_T; the grid in spot."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    sq = math.sqrt(dt)
    z1, z2 = _draws(config, key, device_id, point_offset, device, tag=SABR_TAG, comps=2)
    rho, nu, alpha = (f64(x, device=device) for x in (market.rho, market.nu, market.alpha))
    beta = market.beta
    zv = rho * z1 + torch.sqrt(1.0 - rho**2) * z2  # the vol leg, correlation ρ with z1
    f0 = forward_spot(market, T, device=device) / df(market.rate, prob.payoff.expiry).to(device)
    zeros = torch.zeros((z1.shape[0], config.trajectories), dtype=torch.float64, device=device)
    f, a = f0 + zeros, alpha + zeros
    fs = [f]
    for k in range(steps):
        f_new = _relu(f + a * _relu(f) ** beta * sq * z1[:, k])
        a = a * torch.exp(-0.5 * nu**2 * dt + nu * sq * zv[:, k])
        f = f_new
        fs.append(f)
    if return_grid:
        return _forward_to_spot(market, T, steps, torch.stack(fs))
    return f


def local_vol_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                          return_grid: bool) -> torch.Tensor:
    """Dupire local-vol log-Euler paths,
    x' = x + (f_k − σ²_loc/2)Δt + σ_loc√Δt·Z with σ_loc(t_k, S) per path."""
    market = prob.market_inputs
    _require_no_dividend_schedule(
        market, "LocalVolDynamics (the Dupire surface assumes a continuous-carry diffusion)")
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    sq = math.sqrt(dt)
    z = _draws(config, key, device_id, point_offset, device, tag=LOCAL_VOL_TAG, comps=1)[0]
    fwd = _forward_rates(market, T, steps, device)
    x = torch.log(f64(market.spot, device=device)) + torch.zeros(
        (z.shape[0], config.trajectories), dtype=torch.float64, device=device)
    xs = [x]
    for k in range(steps):
        sig = f64(dupire_local_vol(market, k * dt, torch.exp(x)), device=device)
        x = x + (fwd[k] - 0.5 * sig * sig) * dt + sig * sq * z[:, k]
        xs.append(x)
    if return_grid:
        return torch.exp(torch.stack(xs, dim=1))
    return torch.exp(x)


def slv_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                    return_grid: bool) -> torch.Tensor:
    """SLV paths on a calibrated :class:`~hedgehog_tpu_torch.market.inputs.
    SLVInputs` market: the Heston Euler draws (Philox tag 0 under PRNG, the
    bridge-ordered Sobol' pairs under QMC) stepped with the leverage, the
    curve's forward rates less the carry and the mixing-scaled vol of vol
    (methods/heston_euler.py)."""
    market = prob.market_inputs
    if market.leverage is None:
        raise ValueError(
            "SLV market has no calibrated leverage — run "
            "calibrate_leverage(market, horizon) and price on "
            "market.with_leverage(result)"
        )
    T = market_yearfrac(market, prob.payoff.expiry)
    sig_v = f64(market.mixing, device=device) * f64(market.sigma, device=device)
    return heston_euler_paths(prob, config, key, device_id, point_offset, device=device,
                              return_grid=return_grid,
                              slv=(_forward_rates(market, T, config.steps, device), sig_v,
                                   market.leverage))
