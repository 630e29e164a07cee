"""Jump-diffusion and variance-gamma Monte Carlo in float64 torch: Merton,
Kou, variance gamma and Bates.

Port of the jump samplers of ``hedgehog_tpu/methods/montecarlo.py``
(:413-640, :981-1157, :1391-1533), behind ``MertonExact``, ``KouExact``,
``VarianceGammaExact``, ``EulerMaruyama`` under the four jump dynamics and
``HestonQE(conditional=True)`` under ``BatesDynamics``.  Every increment is
exact in law: the Merton and Kou grids add a per-step compound-Poisson jump
sum to the exact diffusion step, the variance-gamma grid an exact gamma
subordinator step; only Bates's Euler variance is discretized.  Jump counts
invert the Poisson CDF in a fixed number of trips (``merton_poisson_trips``
checks the tail on the host when the rate is a number) and carry no
derivative; the Merton exact sampler also returns the counts' frozen
log-likelihood, whose likelihood-ratio surrogate makes autograd through
``solve`` unbiased in the jump intensity.

Draws.  Under QMC, Sobol' points from the unsplit base key (the caller's,
or ``PRNGKey(config.seed)``), the JAX package's layouts, so per-path values
agree with it: Merton (z_diffusion, z_jump, u_count) per step, the
diffusion normals bridge-ordered on the grid; Kou (z_diffusion, u_count,
kmax size uniforms) per step; variance gamma (z_gamma, z_normal, u_boost)
per step; the Bates mixing estimator dims [0, steps) for the normals,
[steps, 2·steps) for the QE uniforms and the last for the jump count; the
Bates Euler grid (z_s, z_v, z_jump, u_count) per step.  Under PRNG, Philox
(key (seed, device_id), counter (pair, block, tag); ROADMAP "RNG facts"),
a tag of its own per family, uniforms (w + ½)·2^-32 in float64, normals by
Box–Muller of two words:

- Merton: block s (step s; the terminal sampler block 0), words 0,1 →
  (z_diffusion, z_jump), word 2 → u_count; tag ``MERTON_TAG``;
- Kou: per step nb = 1 + ⌈kmax/4⌉ blocks from s·nb: the first's words 0,1
  → z_diffusion (the second normal unused), word 2 → u_count; size j from
  block s·nb + 1 + j//4, word j % 4; tag ``KOU_TAG``;
- variance gamma: block s, words 0,1 → (z_gamma, z_normal), word 2 →
  u_boost; tag ``VG_TAG``.  The gamma draw is the corrected-saddlepoint
  quantile (boosted below shape 1) on both streams: the port has no exact
  gamma sampler on a counter stream (JAX's PRNG stream uses
  ``jax.random.gamma``);
- Bates mixing: the QE mixing layout of ``HestonQE(conditional=True)``
  (tag 0, so at λ = 0 its values are the Heston estimator's bit for bit),
  and the count's uniform from word 0 of block 0 under ``BATES_TAG``;
- Bates Euler: the Heston Euler layout for (z_s, z_v) (tag 0), and block s
  under ``BATES_TAG`` for the jump: words 0,1 → z_jump, word 2 → u_count.

The antithetic twin negates the normals and mirrors the uniforms to
1 − u, so its jump counts are drawn anew (variance gamma's pair shares G).
"""

from __future__ import annotations

import math

import torch

from ..market.inputs import carry_yield
from ..math.brownian_bridge import brownian_bridge_increments
from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..models.dynamics import (
    kou_terminal_params,
    merton_terminal_params,
    vg_terminal_params,
)
from ..models.heston_exact import gamma_qtl, poisson_inv
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64
from .heston_exact_mixing import conditional_payoff_close, score_surrogate
from .montecarlo import Antithetic, sim_params

__all__ = [
    "merton_poisson_trips",
    "merton_exact_terminal",
    "merton_euler_paths",
    "merton_payoffs_with_score",
    "kou_jump_size",
    "kou_jump_sum",
    "kou_exact_terminal",
    "kou_euler_paths",
    "vg_increments",
    "vg_exact_terminal",
    "vg_euler_paths",
    "bates_qe_mixing_values",
    "bates_euler_paths",
]

_MASK32 = 0xFFFFFFFF
#: Philox counter tags (the counter's last word) of the jump streams
MERTON_TAG = 0x6D657274  # "mert"
KOU_TAG = 0x6B6F7520  # "kou "
VG_TAG = 0x76672020  # "vg  "
BATES_TAG = 0x62617465  # "bate"


def merton_poisson_trips(rate, cap: int = 64, default: int = 64) -> int:
    """The smallest trip count k with P(N > k | rate) < 1e-9 (+1, floored
    at 8); raises when ``cap`` trips cannot meet the bound (rate ≳ 30:
    hundreds of jumps a path want the CF route).  A tensor rate returns
    ``default`` unchecked (no host read; a traced rate in the JAX package
    does the same)."""
    if isinstance(rate, torch.Tensor):
        return default
    r = float(rate)
    p = math.exp(-r)
    cdf, k = p, 0
    while cdf < 1.0 - 1e-9 and k < cap:
        k += 1
        p *= r / k
        cdf += p
    if cdf < 1.0 - 1e-9:
        raise ValueError(
            f"Merton jump count needs a Poisson trip count beyond {cap} "
            f"(λT ≈ {r:.1f}); with hundreds of jumps per path the compound "
            f"process is near-Gaussian — price via CarrMadan(MertonJumpDynamics)"
        )
    return int(max(k + 1, 8))


def _host_rate(intensity, T: float):
    """λ·T as a Python float for the trip check, or the tensor itself."""
    if isinstance(intensity, torch.Tensor):
        return intensity
    return float(intensity) * T


def _base(config, key):
    return prng_key(config.seed) if key is None else key


def _philox(config, key, device_id, paths, device):
    """Block reader ``words(block, tag)`` of each pair's Philox stream."""
    seed = seed_from_key(config, key) & _MASK32
    pair = torch.arange(paths, dtype=torch.int64, device=device)
    return lambda block, tag: philox_block(pair, block, seed, device_id & _MASK32, tag)


def _u32(w: torch.Tensor) -> torch.Tensor:
    """A uint32 word as a float64 uniform (w + ½)·2^-32 in (0, 1)."""
    return (w.double() + 0.5) * 2.0**-32


def _bm(w0, w1):
    return box_muller(w0, w1, dtype=torch.float64)


def _pair(x: torch.Tensor, anti: bool, uniform: bool, dim: int) -> torch.Tensor:
    """The antithetic group axis at ``dim``: (x, −x) or (u, 1 − u)."""
    if not anti:
        return x.unsqueeze(dim)
    return torch.stack([x, 1.0 - x if uniform else -x], dim=dim)


def _qmc_step_draws(config, key, point_offset, n_per_step: int, device):
    """(steps, n_per_step, paths) Sobol' uniforms, dims step-major."""
    steps, paths = config.steps, config.trajectories
    u = sobol_uniforms(_base(config, key), paths, steps * n_per_step, skip=point_offset,
                       device=device)
    return torch.movedim(u.reshape(paths, steps, n_per_step), 0, -1)


def _on(device, params):
    return tuple(x if isinstance(x, float) else x.to(device) for x in params)


# -- Merton ---------------------------------------------------------------------------------


def merton_exact_terminal(prob, config, key=None, device_id=0, point_offset=0, *, device,
                          with_score: bool = False):
    """(n_groups, paths) exact Merton terminal prices; ``with_score=True``
    also returns each path's frozen-count log-likelihood N·log(λT) − λT."""
    market = prob.market_inputs
    log_s0, r, T, sigma, lam, mu_j, s_j, kbar = _on(
        device, merton_terminal_params(market, prob.payoff.expiry))
    rate = lam * T
    kmax = merton_poisson_trips(_host_rate(market.jump_intensity, T))
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    if config.qmc:
        u = sobol_uniforms(_base(config, key), paths, 3, skip=point_offset, device=device)
        z_d, z_j, u_p = torch.special.ndtri(u[:, 0]), torch.special.ndtri(u[:, 1]), u[:, 2]
    else:
        w = _philox(config, key, device_id, paths, device)(0, MERTON_TAG)
        (z_d, z_j), u_p = _bm(w[0], w[1]), _u32(w[2])
    z_d, z_j, u_p = _pair(z_d, anti, False, 0), _pair(z_j, anti, False, 0), _pair(u_p, anti, True, 0)
    n = poisson_inv(rate, u_p, kmax).detach()
    logl = n * torch.log(torch.clamp(rate, min=1e-30)) - rate
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    samples = torch.exp(drift + sigma * math.sqrt(T) * z_d + n * mu_j + torch.sqrt(n) * s_j * z_j)
    if with_score:
        return samples, logl
    return samples


def merton_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                       return_grid: bool):
    """Merton paths, one exact log increment a step: the diffusion step, the
    per-step count and its jump sum's conditional normal N(nμ_J, nσ_J²).
    Terminal (n_groups, paths) or the grid (n_groups, steps + 1, paths)."""
    market = prob.market_inputs
    _, r, T, sigma, lam, mu_j, s_j, kbar = _on(
        device, merton_terminal_params(market, prob.payoff.expiry))
    # a grid carries the carry in the per-step drift, not in log S0
    log_s0 = torch.log(f64(market.spot, device=device))
    r = r - f64(carry_yield(market), device=device)
    steps, paths = config.steps, config.trajectories
    dt = T / steps
    kmax = merton_poisson_trips(_host_rate(market.jump_intensity, dt), default=16)
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        u = _qmc_step_draws(config, key, point_offset, 3, device)
        z = torch.special.ndtri(u[:, :2])
        # the diffusion normals bridge-ordered (dim 0 drives W(T))
        z_d = (brownian_bridge_increments(z[:, 0].T, dt, steps) / math.sqrt(dt)).T
        z_j, u_p = z[:, 1], u[:, 2]
    else:
        words = _philox(config, key, device_id, paths, device)
        cols = []
        for s in range(steps):
            w = words(s, MERTON_TAG)
            cols.append((*_bm(w[0], w[1]), _u32(w[2])))
        z_d, z_j, u_p = (torch.stack(c) for c in zip(*cols))
    z_d, z_j, u_p = _pair(z_d, anti, False, 1), _pair(z_j, anti, False, 1), _pair(u_p, anti, True, 1)
    drift = (r - 0.5 * sigma**2 - lam * kbar) * dt
    vol_dt = sigma * math.sqrt(dt)
    rate = lam * dt
    x = log_s0 + torch.zeros(z_d.shape[1:], dtype=torch.float64, device=device)
    xs = [x]
    for k in range(steps):
        n = poisson_inv(rate, u_p[k], kmax).detach()
        x = x + drift + vol_dt * z_d[k] + n * mu_j + torch.sqrt(n) * s_j * z_j[k]
        xs.append(x)
    if return_grid:
        return torch.exp(torch.stack(xs, dim=1))
    return torch.exp(x)


def merton_payoffs_with_score(prob, config, payoff, key=None, device_id=0, point_offset=0, *,
                              device):
    """Per-path Merton payoffs with the likelihood-ratio surrogate, applied
    per antithetic group before the pair average (the mirrored uniform
    draws another count): the primal is unchanged and autograd is unbiased
    in λ.  (paths,) or (m, paths) for a strike grid."""
    samples, logl = merton_exact_terminal(prob, config, key, device_id, point_offset,
                                          device=device, with_score=True)
    strike = torch.as_tensor(payoff.strike)
    if strike.ndim > 0:
        import dataclasses

        grid = dataclasses.replace(payoff, strike=f64(strike, device=device)[:, None])
        vals = grid(samples[:, None, :])  # (g, m, paths)
    else:
        vals = payoff(samples)
    return torch.mean(score_surrogate(vals, logl), dim=0)


# -- Kou ------------------------------------------------------------------------------------


def kou_jump_size(u, p, e1, e2):
    """Double-exponential jump size from one uniform by the piecewise
    inverse CDF: u < 1 − p → ln(u/(1 − p))/η₂, else −ln((1 − u)/p)/η₁ (the
    dead branch's log argument kept positive, so its gradient stays clean)."""
    down = u < (1.0 - p)
    u_dn = torch.where(down, u, 1.0 - p)
    u_up = torch.where(down, p, 1.0 - u)
    return torch.where(down,
                       torch.log(torch.clamp(u_dn / (1.0 - p), min=1e-300)) / e2,
                       -torch.log(torch.clamp(u_up / p, min=1e-300)) / e1)


def kou_jump_sum(u_count, u_sizes, rate, p, e1, e2, kmax: int):
    """Σ_{j<N} J(u_sizes[j]) with N = poisson_inv(rate, u_count) in a fixed
    ``kmax``-trip masked sum (u_sizes' leading axis the trip); the count
    carries no derivative, the sizes keep (η₁, η₂)'s."""
    n = poisson_inv(rate, u_count, kmax).detach()
    sizes = kou_jump_size(u_sizes, p, e1, e2)
    j = torch.arange(kmax, dtype=torch.float64, device=sizes.device).reshape(
        (kmax,) + (1,) * (sizes.ndim - 1))
    return torch.sum(torch.where(j < n[None], sizes, 0.0), dim=0)


def _kou_philox(words, kmax: int, first_block: int):
    """(z_d, u_c, u_s) of one Kou draw from its blocks (layout above)."""
    w = words(first_block, KOU_TAG)
    z_d, u_c = _bm(w[0], w[1])[0], _u32(w[2])
    sizes = []
    for b in range(-(-kmax // 4)):
        sizes.extend(_u32(x) for x in words(first_block + 1 + b, KOU_TAG))
    return z_d, u_c, torch.stack(sizes[:kmax])


def kou_exact_terminal(prob, config, key=None, device_id=0, point_offset=0, *, device):
    """(n_groups, paths) exact Kou terminal prices: the diffusion normal and
    the compound-Poisson double-exponential jump sum."""
    market = prob.market_inputs
    log_s0, r, T, sigma, lam, p, e1, e2, kbar = _on(
        device, kou_terminal_params(market, prob.payoff.expiry))
    kmax = merton_poisson_trips(_host_rate(market.jump_intensity, T))
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    if config.qmc:
        us = sobol_uniforms(_base(config, key), paths, 2 + kmax, skip=point_offset,
                            device=device).T
        z_d, u_c, u_s = torch.special.ndtri(us[0]), us[1], us[2:]
    else:
        z_d, u_c, u_s = _kou_philox(_philox(config, key, device_id, paths, device), kmax, 0)
    z_d, u_c, u_s = _pair(z_d, anti, False, 0), _pair(u_c, anti, True, 0), _pair(u_s, anti, True, 1)
    jumps = kou_jump_sum(u_c, u_s, lam * T, p, e1, e2, kmax)
    x = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T + sigma * math.sqrt(T) * z_d + jumps
    return torch.exp(x)


def kou_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                    return_grid: bool):
    """Kou paths, one exact log increment a step (the diffusion normal and
    the step's compound-Poisson jump sum): terminal or the whole grid."""
    market = prob.market_inputs
    _, r, T, sigma, lam, p, e1, e2, kbar = _on(
        device, kou_terminal_params(market, prob.payoff.expiry))
    log_s0 = torch.log(f64(market.spot, device=device))
    r = r - f64(carry_yield(market), device=device)
    steps, paths = config.steps, config.trajectories
    dt = T / steps
    kmax = merton_poisson_trips(_host_rate(market.jump_intensity, dt), default=16)
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        us = _qmc_step_draws(config, key, point_offset, 2 + kmax, device)
        z_d, u_c, u_s = torch.special.ndtri(us[:, 0]), us[:, 1], us[:, 2:]
    else:
        words = _philox(config, key, device_id, paths, device)
        nb = 1 + -(-kmax // 4)
        z_d, u_c, u_s = (torch.stack(c) for c in zip(
            *(_kou_philox(words, kmax, s * nb) for s in range(steps))))
    z_d, u_c, u_s = _pair(z_d, anti, False, 1), _pair(u_c, anti, True, 1), _pair(u_s, anti, True, 2)
    drift = (r - 0.5 * sigma**2 - lam * kbar) * dt
    vol_dt = sigma * math.sqrt(dt)
    x = log_s0 + torch.zeros(z_d.shape[1:], dtype=torch.float64, device=device)
    xs = [x]
    for k in range(steps):
        x = x + drift + vol_dt * z_d[k] + kou_jump_sum(u_c[k], u_s[k], lam * dt, p, e1, e2, kmax)
        xs.append(x)
    if return_grid:
        return torch.exp(torch.stack(xs, dim=1))
    return torch.exp(x)


# -- variance gamma -------------------------------------------------------------------------


def vg_increments(config, key, device_id, point_offset, alpha, nu, n_draws: int, *, device):
    """(G, Z), each (n_draws, paths): gamma-subordinator increments
    Gamma(α, scale ν) and unit normals.  G is the corrected-saddlepoint
    gamma quantile, which collapses at small shapes, so below shape 1 (and
    whenever ν or the shape is a tensor, as for a traced shape in the JAX
    package) it takes the boosting identity G_α = G_{α+1}·U^{1/α} with one
    more uniform: the decision reads Python numbers only."""
    paths = config.trajectories
    if config.qmc:
        u = sobol_uniforms(_base(config, key), paths, 3 * n_draws, skip=point_offset,
                           device=device).reshape(paths, n_draws, 3)
        z_g, z_n = torch.special.ndtri(u[..., 0]).T, torch.special.ndtri(u[..., 1]).T
        u_boost = u[..., 2].T
    else:
        words = _philox(config, key, device_id, paths, device)
        cols = []
        for s in range(n_draws):
            w = words(s, VG_TAG)
            cols.append((*_bm(w[0], w[1]), _u32(w[2])))
        z_g, z_n, u_boost = (torch.stack(c) for c in zip(*cols))
    fast = not isinstance(alpha, torch.Tensor) and float(alpha) >= 1.0
    a = f64(alpha, device=device)
    if fast:
        g = gamma_qtl(a, z_g) * nu
    else:
        g = gamma_qtl(a + 1.0, z_g) * u_boost ** (1.0 / a) * nu
    return g, z_n


def _vg_shape(market, T: float, nu):
    """α = T/ν as a Python float when ν is a number, else a tensor."""
    raw = market.nu
    return T / float(raw) if not isinstance(raw, torch.Tensor) else T / nu


def vg_exact_terminal(prob, config, key=None, device_id=0, point_offset=0, *, device):
    """(n_groups, paths) exact variance-gamma terminal prices; the pair
    shares G and negates the conditional normal."""
    market = prob.market_inputs
    log_s0, r, T, sigma, nu, theta, omega = _on(
        device, vg_terminal_params(market, prob.payoff.expiry))
    anti = isinstance(config.variance_reduction, Antithetic)
    g, z = vg_increments(config, key, device_id, point_offset, _vg_shape(market, T, nu), nu, 1,
                         device=device)
    g, z = g[0], _pair(z[0], anti, False, 0)
    return torch.exp(log_s0 + (r + omega) * T + theta * g[None] + sigma * torch.sqrt(g)[None] * z)


def vg_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                   return_grid: bool):
    """Variance-gamma paths, one exact Lévy increment a step (gamma
    subordinator and conditional normal): terminal or the whole grid."""
    market = prob.market_inputs
    _, r, T, sigma, nu, theta, omega = _on(device, vg_terminal_params(market, prob.payoff.expiry))
    log_s0 = torch.log(f64(market.spot, device=device))
    r = r - f64(carry_yield(market), device=device)
    steps = config.steps
    dt = T / steps
    anti = isinstance(config.variance_reduction, Antithetic)
    g, z = vg_increments(config, key, device_id, point_offset, _vg_shape(market, dt, nu), nu,
                         steps, device=device)
    z, g = _pair(z, anti, False, 1), g[:, None]
    drift = (r + omega) * dt
    x = log_s0 + torch.zeros(z.shape[1:], dtype=torch.float64, device=device)
    xs = [x]
    for k in range(steps):
        x = x + drift + theta * g[k] + sigma * torch.sqrt(g[k]) * z[k]
        xs.append(x)
    if return_grid:
        return torch.exp(torch.stack(xs, dim=1))
    return torch.exp(x)


# -- Bates ----------------------------------------------------------------------------------


def _bates_jump_params(market, device):
    lam, mu_j, s_j = (f64(x, device=device) for x in (
        market.jump_intensity, market.jump_mean, market.jump_std))
    return lam, mu_j, s_j, torch.expm1(mu_j + 0.5 * s_j**2)


def bates_qe_mixing_values(prob, config, key=None, device_id=0, point_offset=0, *, device):
    """Per-path UNDISCOUNTED conditional values (n_groups, paths) under
    Bates: given the QE variance path and the jump count N (independent of
    V), log S_T is normal with forward F·e^{ρJ − ρ²IV/2 + N(μ_J + σ_J²/2)
    − λκ̄T} and variance (1 − ρ²)·IV + Nσ_J².  The count carries no
    derivative (the λ greek comes from the CF route)."""
    from ..models.heston_qe import qe_constants, qe_v_step
    from .heston_qe_mixing import qe_mixing_draws

    market, T, r0 = sim_params(prob)
    steps, paths = config.steps, config.trajectories
    dt = T / steps
    spot, v0, kappa, theta, sigma, rho, r0 = (
        f64(x, device=device) for x in (market.spot, market.V0, market.kappa, market.theta,
                                        market.sigma, market.rho, r0))
    c = qe_constants(kappa, theta, sigma, rho, r0, dt)
    lam, mu_j, s_j, kbar = _bates_jump_params(market, device)
    kmax = merton_poisson_trips(_host_rate(market.jump_intensity, T))
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        # not interleaved: [0, steps) normals, [steps, 2·steps) uniforms, one count uniform
        u = sobol_uniforms(_base(config, key), paths, 2 * steps + 1, skip=point_offset,
                           device=device)
        zs = _pair(torch.special.ndtri(u[:, :steps]).T, anti, False, 1)
        us = _pair(u[:, steps:2 * steps].T, anti, True, 1)
        u_n = u[:, -1]
    else:
        zs, us = qe_mixing_draws(config, key, device_id, point_offset, device=device)
        u_n = _u32(_philox(config, key, device_id, paths, device)(0, BATES_TAG)[0])
    u_n = _pair(u_n, anti, True, 0)
    ktd = kappa * theta * dt
    v = v0 + torch.zeros(zs.shape[1:], dtype=torch.float64, device=device)
    iv = torch.zeros_like(v)
    j = torch.zeros_like(v)
    for z, uk in zip(zs, us):
        v_new = qe_v_step(v, z, uk, c)
        iv_step = 0.5 * dt * (v + v_new)
        j = j + (v_new - v - ktd + kappa * iv_step) / sigma
        iv = iv + iv_step
        v = v_new
    n = poisson_inv(lam * T, u_n, kmax).detach()
    f_eff = spot * torch.exp(r0 * T + rho * j - 0.5 * rho**2 * iv
                             + n * (mu_j + 0.5 * s_j**2) - lam * kbar * T)
    return conditional_payoff_close(prob.payoff, f_eff, (1.0 - rho**2) * iv + n * s_j**2)


def bates_euler_paths(prob, config, key=None, device_id=0, point_offset=0, *, device,
                      return_grid: bool):
    """Full-truncation log-Euler Bates paths: the Heston Euler step plus a
    per-step exact compound-Poisson jump (count by inversion, the jump sum
    its conditional normal).  Terminal or the whole grid."""
    market, T, r0 = sim_params(prob)
    steps, paths = config.steps, config.trajectories
    dt = T / steps
    sqrt_dt = math.sqrt(dt)
    spot, v0, kappa, theta, sigma, rho, r0 = (
        f64(x, device=device) for x in (market.spot, market.V0, market.kappa, market.theta,
                                        market.sigma, market.rho, r0))
    lam, mu_j, s_j, kbar = _bates_jump_params(market, device)
    kmax = merton_poisson_trips(_host_rate(market.jump_intensity, dt), default=16)
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        u = _qmc_step_draws(config, key, point_offset, 4, device)
        z = torch.special.ndtri(u[:, :3])
        z1, z2, zj, u_p = z[:, 0], z[:, 1], z[:, 2], u[:, 3]
    else:
        words = _philox(config, key, device_id, paths, device)
        cols = []
        for s in range(steps):
            w = words(s // 2, 0) if s % 2 == 0 else w
            wj = words(s, BATES_TAG)
            cols.append((*_bm(w[2 * (s % 2)], w[2 * (s % 2) + 1]), _bm(wj[0], wj[1])[0],
                         _u32(wj[2])))
        z1, z2, zj, u_p = (torch.stack(c) for c in zip(*cols))
    z1, z2, zj = (_pair(x, anti, False, 1) for x in (z1, z2, zj))
    u_p = _pair(u_p, anti, True, 1)
    rho_bar = torch.sqrt(1.0 - rho**2)
    zeros = torch.zeros(z1.shape[1:], dtype=torch.float64, device=device)
    x, v = zeros + torch.log(spot), zeros + v0
    xs = [x]
    for k in range(steps):
        v_plus = torch.clamp(v, min=0.0)
        # double where: sqrt'(0) = inf would turn a truncated path's zero
        # cotangent into NaN
        sqrt_v = torch.where(v > 0.0, torch.sqrt(torch.where(v > 0.0, v, 1.0)), 0.0)
        n = poisson_inv(lam * dt, u_p[k], kmax).detach()
        x = (x + (r0 - lam * kbar - 0.5 * v_plus) * dt + sqrt_v * sqrt_dt * z1[k]
             + n * mu_j + torch.sqrt(n) * s_j * zj[k])
        v = v + kappa * (theta - v_plus) * dt + sigma * sqrt_v * sqrt_dt * (
            rho * z1[k] + rho_bar * z2[k])
        xs.append(x)
    if return_grid:
        return torch.exp(torch.stack(xs, dim=1))
    return torch.exp(x)
