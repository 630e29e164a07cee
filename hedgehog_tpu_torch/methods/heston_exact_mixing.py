"""The exact-transition segmented mixing estimator in float64 torch, and the
conditional Black-Scholes close it finishes with.

Port of ``_heston_exact_mixing_values``, ``conditional_payoff_close`` and
``_conditional_bs_close`` from ``hedgehog_tpu/methods/montecarlo.py``
(primal only: the JAX version also bakes a likelihood-ratio term into the
values for its greeks, which are not part of this port).
"""

from __future__ import annotations

import torch

from ..core.payoffs import VanillaOption
from ..math.counter_rng import prng_key, uniform_from_bits
from ..math.sobol import sobol_uniforms
from ..models.heston_exact import (
    cir_exact_constants,
    cir_exact_step_score,
    iv_cond_moments,
    iv_gamma_draw,
    poisson_kmax,
)
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64
from .montecarlo import Antithetic, sim_params

__all__ = ["conditional_payoff_close", "heston_exact_mixing_values"]

_MASK32 = 0xFFFFFFFF


def conditional_payoff_close(payoff, f_eff, iv_var):
    """Per-path conditional expectation of a vanilla payoff given a
    lognormal terminal law with forward ``f_eff`` and log-variance
    ``iv_var``: the conditional Black-Scholes formula.  A strike grid gives
    (..., m, paths) from one path set."""
    if not isinstance(payoff, VanillaOption):
        raise TypeError(
            f"the conditional close prices vanillas; got {type(payoff).__name__}"
        )
    var = torch.clamp(iv_var, min=1e-18)
    sd = torch.sqrt(var)
    cp = payoff.call_put()
    strike = f64(payoff.strike, device=f_eff.device)
    if strike.ndim > 0:
        f_eff, sd, var = f_eff[..., None, :], sd[..., None, :], var[..., None, :]
        strike = strike[None, :, None]
    d2 = (torch.log(f_eff / strike) - 0.5 * var) / sd
    d1 = d2 + sd
    ncdf = torch.special.ndtr
    return cp * (f_eff * ncdf(cp * d1) - strike * ncdf(cp * d2))


def _conditional_bs_close(prob, market, T, r0, iv, j):
    """Close (IV, J) mixing factors with the conditional closed form; spot,
    ρ and the drift r0 keep their autograd history."""
    spot, rho, r0 = (f64(x, device=iv.device) for x in (market.spot, market.rho, r0))
    f_eff = spot * torch.exp(r0 * T + rho * j - 0.5 * rho**2 * iv)
    return conditional_payoff_close(prob.payoff, f_eff, (1.0 - rho**2) * iv)


def _draws(config, key, segments, paths, anti, device_id, point_offset, device):
    """(u_pois, z_gam, u_boost, z_iv), each (segments, groups, paths).

    QMC: Sobol' dims 4i..4i+3 per segment (step-major), normals by the exact
    inverse CDF, randomized by ``key`` (default: the config's seed), as the
    JAX estimator.  PRNG: the Philox layout of the exact kernels
    (csrc/hh_device.cuh), uniforms and Box-Muller normals in float64."""
    if config.qmc:
        u = sobol_uniforms(prng_key(config.seed) if key is None else key, paths,
                           segments * 4, skip=point_offset, device=device)
        u = torch.movedim(u.reshape(paths, segments, 4), 0, -1)  # (seg, 4, paths)
        u_pois, u_boost = u[:, 0], u[:, 2]
        z_gam, z_iv = torch.special.ndtri(u[:, 1]), torch.special.ndtri(u[:, 3])
    else:
        seed = seed_from_key(config, key)
        pair = torch.arange(paths, dtype=torch.int64, device=device)
        cols = []
        for s in range(segments):
            w = philox_block(pair, s, seed & _MASK32, device_id & _MASK32)
            z0, z1 = box_muller(w[0], w[1], dtype=torch.float64)
            cols.append((uniform_from_bits(w[2]).double(), z0,
                         uniform_from_bits(w[3]).double(), z1))
        u_pois, z_gam, u_boost, z_iv = (torch.stack(c) for c in zip(*cols))

    def groups(x, is_uniform):
        if not anti:
            return x[:, None]
        return torch.stack([x, 1.0 - x if is_uniform else -x], dim=1)

    return groups(u_pois, True), groups(z_gam, False), groups(u_boost, True), groups(z_iv, False)


def heston_exact_mixing_values(prob, config, key=None, device_id=0, point_offset=0, *,
                               device):
    """Per-path UNDISCOUNTED conditional vanilla values (n_groups, paths),
    float64, from the exact-transition segmented mixing scheme."""
    market, T, r0 = sim_params(prob)
    segments = config.steps
    dt = T / segments
    paths = config.trajectories
    c = cir_exact_constants(market.kappa, market.theta, market.sigma, dt)
    # raises for markets whose Poisson-mixture count cannot be truncated safely
    kmax = poisson_kmax(market.kappa, market.theta, market.sigma, dt, market.V0)
    anti = isinstance(config.variance_reduction, Antithetic)
    u_pois, z_gam, u_boost, z_iv = _draws(config, key, segments, paths, anti, device_id,
                                          point_offset, device)
    v = torch.full((z_gam.shape[1], paths), float(market.V0), dtype=torch.float64, device=device)
    iv = torch.zeros_like(v)
    for i in range(segments):
        y, _ = cir_exact_step_score(v, u_pois[i], z_gam[i], u_boost[i], c, kmax)
        m1, s2 = iv_cond_moments(v, y, c)
        iv = iv + iv_gamma_draw(m1, s2, z_iv[i])
        v = y
    kappa, sigma = float(market.kappa), float(market.sigma)
    j = (v - float(market.V0) - kappa * float(market.theta) * T + kappa * iv) / sigma
    return _conditional_bs_close(prob, market, T, r0, iv, j)

