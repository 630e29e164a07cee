"""The one-simulation (expiry × strike) Heston surface, float64 torch.

Port of ``heston_surface_mc`` and its helpers from
``hedgehog_tpu/methods/montecarlo.py``: ONE variance path per trajectory runs
through per-expiry segments to the last expiry, and at each expiry the
(IV, J) carries close every strike with the conditional Black-Scholes
formula, so all points share their paths.  ``config.steps`` is the step (or
exact-segment) budget of the whole horizon; :func:`surface_seg_steps` gives
each gap a count proportional to its length.

Draws, with the step or segment index running across all segments:

- QE (``strategy`` None or ``HestonQE(conditional=True)``): the QE mixing
  draws over ``sum(seg_steps)`` steps (methods/heston_qe_mixing.qe_mixing_draws):
  under QMC the JAX points (Sobol' dims 2s and 2s + 1, exact inverse normal
  CDF), under PRNG Philox block s // 2 at global step s, so a one-expiry
  surface draws the stream of the QE mixing kernels;
- exact (``HestonExactMixing()``): the exact-mixing draws over
  ``sum(seg_steps)`` segments (QMC dims 4k..4k + 3; PRNG Philox block k at
  global segment k), the stream of the exact-mixing kernels.

The QE surface keeps the autograd history of every market field that is a
tensor.  The exact surface is primal only: the JAX package closes it through
a likelihood-ratio surrogate whose gradient the port does not have yet, so it
raises when a market field requires grad rather than return a biased
pathwise gradient.
"""

from __future__ import annotations

import dataclasses

import torch

from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df_yf, zero_rate_yf
from ..utils import f64, resolve_device
from .montecarlo import Antithetic, HestonExactMixing

__all__ = ["heston_surface_mc", "surface_seg_steps", "validate_surface_expiries"]


def surface_seg_steps(T_host, steps: int, min_first: int = 1):
    """(segment lengths, steps per segment): steps proportional to each
    segment's length, at least 1 each, the first floored at ``min_first``
    (the exact scheme's callers pass 2: its two-moment ∫V family needs two
    cumulative segments at every expiry).  The one rounding rule of the
    float64 surface and the surface kernels."""
    T_total = T_host[-1]
    seg_len = [T_host[0]] + [T_host[i + 1] - T_host[i] for i in range(len(T_host) - 1)]
    counts = [max(1, round(steps * s / T_total)) for s in seg_len]
    counts[0] = max(counts[0], min_first)
    return seg_len, counts


def validate_surface_expiries(market, expiries):
    """Expiry year fractions as floats, strictly increasing and after the
    reference date."""
    if len(expiries) == 0:
        raise ValueError("need at least one expiry")
    T_host = [float(market_yearfrac(market, e)) for e in expiries]
    increasing = all(T_host[i] < T_host[i + 1] for i in range(len(T_host) - 1))
    if not increasing or T_host[0] <= 0.0:
        raise ValueError(
            "expiries must be strictly increasing and after the reference "
            f"date; got year-fractions {T_host}"
        )
    return T_host


def _surface_close_row(market, T_i, r0, iv, j, strikes_i, cp_i):
    """Close one expiry's (IV, J) against its strikes with the conditional
    Black-Scholes formula: DISCOUNTED mean prices (m,)."""
    dev = iv.device
    spot, rho = f64(market.spot, device=dev), f64(market.rho, device=dev)
    f_eff = spot * torch.exp(r0 * T_i + rho * j - 0.5 * rho**2 * iv)
    var = torch.clamp((1.0 - rho**2) * iv, min=1e-18)
    sd = torch.sqrt(var)
    f_b, sd_b, var_b = f_eff[:, None, :], sd[:, None, :], var[:, None, :]
    k_b = f64(strikes_i, device=dev)[None, :, None]
    cp_b = f64(cp_i, device=dev)
    if cp_b.ndim > 0:
        cp_b = cp_b[None, :, None]  # per-point call/put signs
    d1 = (torch.log(f_b / k_b) + 0.5 * var_b) / sd_b
    d2 = d1 - sd_b
    ncdf = torch.special.ndtr
    vals = cp_b * (f_b * ncdf(cp_b * d1) - k_b * ncdf(cp_b * d2))
    return df_yf(market.rate, T_i).to(dev) * torch.mean(vals, dim=(0, -1))


def _mixing_surface_rows(market, T_host, per_exp_strikes, per_exp_cp, config, key=None,
                         device_id=0, point_offset=0, *, device):
    """QE core: one variance path through per-expiry segments; at expiry i
    the carries close the strikes ``per_exp_strikes[i]`` with signs
    ``per_exp_cp[i]``.  Returns the list of DISCOUNTED rows."""
    from ..models.heston_qe import qe_constants, qe_v_step
    from .heston_qe_mixing import qe_mixing_draws

    r0 = zero_rate_yf(market.rate, 0.0) - f64(carry_yield(market))
    seg_len, seg_steps = surface_seg_steps(T_host, config.steps)
    zs, us = qe_mixing_draws(dataclasses.replace(config, steps=sum(seg_steps)), key, device_id,
                             point_offset, device=device)
    v0, kappa, theta, sigma, r0 = (
        f64(x, device=device) for x in (market.V0, market.kappa, market.theta, market.sigma, r0))
    v = v0 + torch.zeros(zs.shape[1:], dtype=torch.float64, device=device)
    iv = torch.zeros_like(v)
    j = torch.zeros_like(v)
    rows, offset = [], 0
    for i, steps_i in enumerate(seg_steps):
        dt_i = seg_len[i] / steps_i
        c = qe_constants(kappa, theta, sigma, market.rho, r0, dt_i)
        ktd = kappa * theta * dt_i
        for s in range(offset, offset + steps_i):
            v_new = qe_v_step(v, zs[s], us[s], c)
            iv_step = 0.5 * dt_i * (v + v_new)
            j = j + (v_new - v - ktd + kappa * iv_step) / sigma
            iv = iv + iv_step
            v = v_new
        offset += steps_i
        rows.append(_surface_close_row(market, T_host[i], r0, iv, j, per_exp_strikes[i],
                                       per_exp_cp[i]))
    return rows


def _requires_grad(market) -> bool:
    fields = (market.spot, market.V0, market.kappa, market.theta, market.sigma, market.rho,
              market.rate.rate, carry_yield(market))
    return any(isinstance(x, torch.Tensor) and x.requires_grad for x in fields)


def _exact_surface_rows(market, T_host, per_exp_strikes, per_exp_cp, config, key=None,
                        device_id=0, point_offset=0, *, device):
    """Exact-transition core: per expiry gap the exact CIR transition and
    the gamma-matched conditional ∫V draw of models/heston_exact.py, J
    accumulated through the per-segment CIR identity, the carries closed at
    each expiry.  Primal only (see the module docstring)."""
    from ..models.heston_exact import (
        cir_exact_constants,
        cir_exact_step_score,
        iv_cond_moments,
        iv_gamma_draw,
        poisson_kmax,
    )
    from .heston_exact_mixing import _draws

    if _requires_grad(market):
        raise TypeError(
            "the exact-transition surface is primal only: its unbiased gradient needs the "
            "likelihood-ratio surrogate, which is not ported; use the QE surface "
            "(strategy=None) for gradients"
        )
    r0 = zero_rate_yf(market.rate, 0.0) - f64(carry_yield(market))
    seg_len, seg_steps = surface_seg_steps(T_host, config.steps, min_first=2)
    paths = config.trajectories
    anti = isinstance(config.variance_reduction, Antithetic)
    u_pois, z_gam, u_boost, z_iv = _draws(config, key, sum(seg_steps), paths, anti, device_id,
                                          point_offset, device)
    v0, kappa, theta, sigma = (float(x) for x in (market.V0, market.kappa, market.theta,
                                                  market.sigma))
    v = torch.full(z_gam.shape[1:], v0, dtype=torch.float64, device=device)
    iv = torch.zeros_like(v)
    j = torch.zeros_like(v)
    rows, offset = [], 0
    for i, steps_i in enumerate(seg_steps):
        dt_i = seg_len[i] / steps_i
        c = cir_exact_constants(kappa, theta, sigma, dt_i)
        kmax = poisson_kmax(kappa, theta, sigma, dt_i, v0)
        ktd = kappa * theta * dt_i
        for k in range(offset, offset + steps_i):
            y, _ = cir_exact_step_score(v, u_pois[k], z_gam[k], u_boost[k], c, kmax)
            m1, s2 = iv_cond_moments(v, y, c)
            iv_seg = iv_gamma_draw(m1, s2, z_iv[k])
            iv = iv + iv_seg
            j = j + (y - v - ktd + kappa * iv_seg) / sigma
            v = y
        offset += steps_i
        rows.append(_surface_close_row(market, T_host[i], r0.to(device), iv, j,
                                       per_exp_strikes[i], per_exp_cp[i]))
    return rows


def heston_surface_mc(market, expiries, strikes, config, cp=1.0, key=None, point_offset=0,
                      strategy=None, *, device_id=0, device="cuda") -> torch.Tensor:
    """A whole (expiry × strike) European vanilla surface from ONE
    conditional-MC variance simulation: (n_expiries, n_strikes) DISCOUNTED
    prices, float64 on ``device`` (the GPU unless the caller asks for the
    CPU).  ``expiries``: dates or ticks, strictly increasing; ``cp``: +1
    call, −1 put.  ``strategy=HestonExactMixing()`` swaps the QE variance
    path for the exact-transition scheme (``config.steps`` then counts exact
    segments, the first gap floored at 2)."""
    T_host = validate_surface_expiries(market, expiries)
    dev = resolve_device(device)
    strikes = f64(strikes, device=dev)
    rows_fn = _exact_surface_rows if isinstance(strategy, HestonExactMixing) else _mixing_surface_rows
    n_exp = len(T_host)
    rows = rows_fn(market, T_host, [strikes] * n_exp, [cp] * n_exp, config, key=key,
                   device_id=device_id, point_offset=point_offset, device=dev)
    return torch.stack(rows)
