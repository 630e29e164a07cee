"""Stochastic local volatility: the leverage surface and its particle
calibration.

Port of ``hedgehog_tpu/models/slv.py``.  SLV puts a state-dependent
leverage on Heston's variance so the model reprices the vanilla surface
while keeping stochastic forward smiles:

    dS/S = (r − q) dt + L(t, S) · √V dW₁
    dV   = κ(θ − V) dt + m·σ_v · √V dW₂,      corr(dW₁, dW₂) = ρ

Gyöngy's matching fixes L²(t, S) = σ_loc²(t, S) / E[V_t | S_t = S], σ_loc the
Dupire local vol of the market surface (models/local_vol.py); the mixing
fraction m runs from pure local vol (0) to full Heston vol of vol (1), and
vanillas reprice at every m.

``calibrate_leverage`` is the Guyon–Henry-Labordère particle method: one
loop over time steps carries the particle cloud (log S, V); at each step a
Nadaraya–Watson Gaussian-kernel regression gives E[V | S] on a fixed
log-spot grid (two (bins × paths) products), the leverage row is fixed,
and the cloud advances one full-truncation Euler step under it through
:func:`~hedgehog_tpu_torch.models.dynamics.cir_family_euler_update`, the
update the pricer takes too.  The loop reads nothing back to the host, and
autograd flows through it: spot, rate, surface and Heston gradients reach
any SLV price.

Draws: the JAX package draws the calibration's (steps, 2, paths) normals
from ``jax.random.normal``, which the port does not replay; the port draws
Philox, key (seed, 0), counter (particle & 0xffffffff, particle >> 32, step,
``LEVERAGE_TAG``), words 0, 1 → Box–Muller (z₁, z₂).  So a calibrated
leverage agrees with JAX's in law; given JAX's normals
(:func:`_particle_leverage`), the calibration agrees path for path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..market.inputs import BlackScholesInputs, carry_yield, market_yearfrac
from ..market.rate_curve import df_yf
from ..market.vol_surface import get_vol_yf
from ..math.interpolation import interp1d
from ..ops.hh_device import box_muller, philox_block
from ..utils import device_of, f64, resolve_device
from .dynamics import cir_family_euler_update
from .local_vol import dupire_local_vol

__all__ = ["LeverageSurface", "leverage_at", "calibrate_leverage"]

#: E[V | S] below this (far wings, where the kernel weights vanish) is floored
_EV_FLOOR = 1e-6
#: leverage cap: a far-wing Dupire vol over a near-zero E[V | S] is clipped so
#: one node cannot destabilise the cloud
_L_MAX = 25.0
#: Philox counter tag (the counter's last word) of the calibration's normals: "slvl"
LEVERAGE_TAG = 0x736C766C
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LeverageSurface:
    """Calibrated leverage L(t_k, x_j) on (time-step left ends × log-spot
    nodes): piecewise constant in t over the calibration's steps, linear in
    log spot with clamped extrapolation."""

    t_grid: Any  # (n_steps,) left ends t_0 = 0 … t_{n−1}
    x_grid: Any  # (n_bins,) log-spot nodes
    values: Any  # (n_steps, n_bins)


def leverage_at(lev: LeverageSurface, t, x) -> torch.Tensor:
    """L(t, x) at a scalar time ``t`` and log spots ``x``: zero-order hold
    in t (the calibration's own convention), linear and clamped in x.  The
    step index is found on the device (no host read)."""
    dev = device_of(x, lev.values, lev.t_grid)
    t_grid = f64(lev.t_grid, device=dev)
    values = f64(lev.values, device=dev)
    k = torch.clamp(torch.searchsorted(t_grid, f64(t, device=dev).reshape(1), right=True) - 1,
                    0, t_grid.shape[0] - 1)
    return interp1d(f64(x, device=dev), f64(lev.x_grid, device=dev), values[k[0]],
                    kind="linear")


def _conditional_variance(x, v, x_grid, bandwidth, shrink=1e-2) -> torch.Tensor:
    """Nadaraya–Watson E[V | log S = x_grid] from the particle cloud, two
    (bins × paths) products.  A ``shrink``-weighted prior at the cloud mean
    regularises nodes the cloud barely visits: a node with less than about
    ``shrink`` particles' worth of kernel mass reads as the mean, not as
    one far particle's V."""
    w = torch.exp(-0.5 * ((x_grid[:, None] - x[None, :]) / bandwidth) ** 2)
    den = torch.sum(w, dim=1)
    num = w @ v
    return (num + shrink * torch.mean(v)) / (den + shrink)


def _atm_vol(bs_market, T: float, dev) -> torch.Tensor:
    """The implied vol at the horizon forward."""
    q = f64(carry_yield(bs_market), device=dev)
    T_t = f64(T, device=dev)
    fwd = f64(bs_market.spot, device=dev) * torch.exp(-q * T_t) / df_yf(bs_market.rate, T_t)
    return f64(get_vol_yf(bs_market.sigma, T_t, fwd), device=dev)


def _calibration_normals(steps: int, paths: int, seed: int, device) -> torch.Tensor:
    """(steps, 2, paths) unit normals of the calibration (layout above)."""
    particle = torch.arange(paths, dtype=torch.int64, device=device)
    rows = []
    for k in range(steps):
        w = philox_block(particle, k, seed & _MASK32, 0, LEVERAGE_TAG)
        rows.append(torch.stack(box_muller(w[0], w[1], dtype=torch.float64)))
    return torch.stack(rows)


def _particle_leverage(market, horizon, z, *, bins: int = 65, bandwidth_mult: float = 1.5,
                      width_sigmas: float = 5.0, device="cuda") -> LeverageSurface:
    """The particle calibration of :func:`calibrate_leverage` on the given
    (steps, 2, paths) normals ``z``: steps and particles are z's."""
    dev = resolve_device(device)
    z = f64(z, device=dev)
    steps, _, paths = z.shape
    T = market_yearfrac(market, horizon)
    q = f64(carry_yield(market), device=dev)
    bs_market = BlackScholesInputs(market.reference_date, market.rate, market.spot,
                                   market.sigma_surface, dividend_yield=carry_yield(market),
                                   daycount=market.daycount)
    dt = T / steps
    sqrt_dt = math.sqrt(dt)
    t_left = torch.arange(steps, dtype=torch.float64, device=dev) * dt
    d_grid = df_yf(market.rate, torch.arange(steps + 1, dtype=torch.float64, device=dev) * dt)
    fwd = torch.log(d_grid[:-1] / d_grid[1:]) / dt - q

    # log-spot grid: centred on the horizon forward, wide enough for the
    # terminal cloud under the ATM vol
    spot = f64(market.spot, device=dev)
    x0 = torch.log(spot)
    drift_T = torch.log(d_grid[0] / d_grid[-1]) - q * T
    half_width = width_sigmas * _atm_vol(bs_market, T, dev) * math.sqrt(T)
    unit = 2.0 * torch.arange(bins, dtype=torch.float64, device=dev) / (bins - 1) - 1.0
    x_grid = x0 + drift_T / 2 + half_width * unit

    kappa, theta, sigma, rho, v0, mixing = (f64(p, device=dev) for p in (
        market.kappa, market.theta, market.sigma, market.rho, market.V0, market.mixing))
    sig_v = mixing * sigma
    rho_bar = torch.sqrt(1.0 - rho**2)
    sig_loc = torch.broadcast_to(f64(dupire_local_vol(bs_market, t_left[:, None],
                                                      torch.exp(x_grid)[None, :]), device=dev),
                                 (steps, bins))
    h_rate = bandwidth_mult * float(paths) ** (-0.2)

    x = x0 + torch.zeros(paths, dtype=torch.float64, device=dev)
    v = v0 + torch.zeros(paths, dtype=torch.float64, device=dev)
    rows = []
    for k in range(steps):
        if k == 0:  # the degenerate cloud at t = 0: E[V | S] is V0 exactly
            ev = v0 + torch.zeros(bins, dtype=torch.float64, device=dev)
        else:
            # jnp.std is the population std: correction 0
            bandwidth = torch.clamp(h_rate * torch.std(x, correction=0), min=1e-4)
            ev = _conditional_variance(x, torch.maximum(v, torch.zeros_like(v)), x_grid,
                                       bandwidth)
        l_row = torch.clamp(sig_loc[k] / torch.sqrt(torch.clamp(ev, min=_EV_FLOOR)), 0.0,
                            _L_MAX)
        x, v = cir_family_euler_update(
            x, v, z[k, 0], z[k, 1], lev_x=interp1d(x, x_grid, l_row, kind="linear"),
            fk=fwd[k], kappa=kappa, theta=theta, sig_v=sig_v, rho=rho, rho_bar=rho_bar,
            dt=dt, sqrt_dt=sqrt_dt)
        rows.append(l_row)
    return LeverageSurface(t_grid=t_left, x_grid=x_grid, values=torch.stack(rows))


def calibrate_leverage(market, horizon, *, steps: int = 64, paths: int = 32768, bins: int = 65,
                       seed: int = 0, bandwidth_mult: float = 1.5, width_sigmas: float = 5.0,
                       device="cuda") -> LeverageSurface:
    """Particle-method leverage calibration (Guyon & Henry-Labordère 2012)
    of an :class:`~hedgehog_tpu_torch.market.inputs.SLVInputs` market on
    ``device``: a :class:`LeverageSurface` over [0, T(horizon)] under which
    the SLV model reprices the market's vanilla surface.

    At each step k the cloud (log S, V) gives E[V | S] on a fixed log-spot
    grid (Gaussian kernel, bandwidth ``bandwidth_mult``·std(x)·paths^(−1/5),
    Silverman's rate), the row L_k = σ_Dupire(t_k, ·)/√E[V | ·] is fixed, and
    the cloud advances one full-truncation Euler step under it; at k = 0
    the conditional variance is V0 exactly.  Differentiable end to end."""
    dev = resolve_device(device)
    z = _calibration_normals(steps, paths, seed, dev)
    return _particle_leverage(market, horizon, z, bins=bins, bandwidth_mult=bandwidth_mult,
                             width_sigmas=width_sigmas, device=dev)
