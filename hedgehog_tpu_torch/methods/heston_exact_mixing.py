"""The exact-transition segmented mixing estimator in float64 torch, and the
conditional Black-Scholes close it finishes with.

Port of ``_heston_exact_mixing_values``, ``conditional_payoff_close`` and
``_conditional_bs_close`` from ``hedgehog_tpu/methods/montecarlo.py``.

The Poisson count of each exact transition is a step function of the
parameters, so plain pathwise AD would drop the dependence of the count's
law on its rate (the V-leg greeks badly biased).  The values therefore
carry the likelihood-ratio surrogate ``vals + sg(vals − b)·(L − sg(L))``
with L the per-path frozen-count Poisson log-likelihood and b the batch
mean (per strike on a strike grid): the primal is unchanged to the bit,
and ``torch.autograd.grad`` or ``torch.func.jvp`` through ``solve`` is
unbiased in every market field given as a tensor.
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

__all__ = ["conditional_payoff_close", "heston_exact_mixing_values", "score_surrogate"]

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


def exact_params(market, device):
    """(V0, κ, θ, σ) as float64 tensors on ``device`` where any is a tensor
    (their history kept), else as floats."""
    fields = (market.V0, market.kappa, market.theta, market.sigma)
    if any(isinstance(x, torch.Tensor) for x in fields):
        return tuple(f64(x, device=device) for x in fields)
    return tuple(float(x) for x in fields)


def score_surrogate(vals, logl):
    """``vals + sg(vals − b)·(L − sg(L))``, b the batch mean (per strike for
    (g, m, paths) values): the primal is ``vals``, the gradient adds the
    score term E[(f − b)·∂L]."""
    if vals.ndim == 3:
        b = torch.mean(vals, dim=(0, -1)).detach()[None, :, None]
        logl = logl[:, None, :]
    else:
        b = torch.mean(vals).detach()
    return vals + (vals - b).detach() * (logl - logl.detach())


def heston_exact_mixing_values(prob, config, key=None, device_id=0, point_offset=0, *,
                               device, with_score=False):
    """Per-path UNDISCOUNTED conditional vanilla values (n_groups, paths),
    float64, from the exact-transition segmented mixing scheme, with the
    likelihood-ratio surrogate baked in; ``with_score=True`` returns the
    plain values and the per-path frozen-count log-likelihood instead."""
    market, T, r0 = sim_params(prob)
    segments = config.steps
    dt = T / segments
    paths = config.trajectories
    v0, kappa, theta, sigma = exact_params(market, device)
    c = cir_exact_constants(kappa, theta, sigma, dt)
    # raises for markets whose Poisson-mixture count cannot be truncated safely
    kmax = poisson_kmax(kappa, theta, sigma, dt, v0)
    anti = isinstance(config.variance_reduction, Antithetic)
    u_pois, z_gam, u_boost, z_iv = _draws(config, key, segments, paths, anti, device_id,
                                          point_offset, device)
    v = torch.zeros((z_gam.shape[1], paths), dtype=torch.float64, device=device) + v0
    iv = torch.zeros_like(v)
    logl = torch.zeros_like(v)
    for i in range(segments):
        y, ll = cir_exact_step_score(v, u_pois[i], z_gam[i], u_boost[i], c, kmax)
        logl = logl + ll
        m1, s2 = iv_cond_moments(v, y, c)
        iv = iv + iv_gamma_draw(m1, s2, z_iv[i])
        v = y
    j = (v - v0 - kappa * theta * T + kappa * iv) / sigma
    vals = _conditional_bs_close(prob, market, T, r0, iv, j)
    if with_score:
        return vals, logl
    return score_surrogate(vals, logl)
