"""Forward-mode greeks of the QE mixing estimator, float64.

Port of ``heston_mixing_price_and_greeks`` and its helpers from
``hedgehog_tpu/methods/mixing_greeks.py``.  The estimator's per-path value is
a closed-form Black-Scholes function of the path functionals IV = ∫V dt and
J = ∫√V dW_v, so only the QE variance scan needs tangents:

- four directions ride the scan, (V0, κ, θ, σ) (a fifth, T, exists for the
  kernels' backward); each step computes two coefficient arrays once
  (∂vn = cm·∂m + cs·∂s2, models/heston_qe.qe_v_step_with_coeffs) and applies
  them to every direction;
- (spot, ρ, rate) close analytically from the value's partials in (IV, J)
  (:func:`cond_bs_value_and_partials`).

The tangent tables (:func:`greek_tables`) also feed the greek kernels'
tangent table (ops/heston_qe_greeks_kernel.py), so the two cannot drift.
``heston_exact_price_and_greeks`` (the exact scheme's likelihood-ratio
greeks) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..core.payoffs import require_european
from ..market.rate_curve import df_yf
from ..models.heston_qe import qe_constants, qe_v_step_with_coeffs
from ..utils import f64, resolve_device

__all__ = [
    "GREEK_ORDER",
    "cond_bs_value_and_partials",
    "greek_tables",
    "heston_mixing_price_and_greeks",
]

# the 7-parameter order of the greek vector (bench.py, BASELINE.md north star #2)
GREEK_ORDER = ("spot", "V0", "kappa", "theta", "sigma", "rho", "rate")

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def cond_bs_value_and_partials(iv, j, *, f0, log_f0_over_k, strike, rho, cp):
    """Undiscounted conditional BS value Y(IV, J) and its partials
    (Y, Y_iv, Y_j, Y_rho, Y_f0), from e_arg = ρJ − ρ²IV/2, F = F0·e^{e_arg},
    var = (1 − ρ²)·IV, ∂Y/∂F = cp·Φ(cp·d1) and ∂Y/∂sd = F·φ(d1)."""
    e_arg = rho * j - 0.5 * rho**2 * iv
    f_eff = f0 * torch.exp(e_arg)
    rho_bar2 = 1.0 - rho**2
    var = torch.clamp(rho_bar2 * iv, min=1e-18)
    sd = torch.sqrt(var)
    d1 = (log_f0_over_k + e_arg + 0.5 * var) / sd
    d2 = d1 - sd
    ncdf = torch.special.ndtr
    y = cp * (f_eff * ncdf(cp * d1) - strike * ncdf(cp * d2))
    y_f = cp * ncdf(cp * d1)  # forward delta
    vega_sd = f_eff * torch.exp(-0.5 * d1 * d1) * _INV_SQRT_2PI
    y_iv = y_f * f_eff * (-0.5 * rho**2) + vega_sd * rho_bar2 / (2.0 * sd)
    y_j = y_f * f_eff * rho
    y_rho = y_f * f_eff * (j - rho * iv) + vega_sd * (-rho * iv / sd)
    y_f0 = y_f * f_eff / f0
    return y, y_iv, y_j, y_rho, y_f0


def greek_tables(kappa, theta, sigma, T, steps: int):
    """Tangent tables of the directions (V0, κ, θ, σ, T), float64, in closed
    form (the derivatives ``jax.jacfwd`` takes in the JAX package):

    - ``dc`` (5, 5): tangents of the V-draw/IV constants
      [θc, e, c_s2_v, c_s2_c, half_dt], with e = exp(−κT/steps),
      c_s2_v = σ²e(1 − e)/κ, c_s2_c = θσ²(1 − e)²/(2κ), half_dt = T/(2·steps);
    - ``djc`` (5, 3): (α, β, γ) closing the telescoped J chain
      J = (V_T − V0 − κθT + κ·IV)/σ at the end of a path:
      dJ_d = dV_T/σ + (κ/σ)·dIV + α_d·IV + β_d + γ_d·J."""
    k, th, s, T = (float(x) for x in (kappa, theta, sigma, T))
    dt = T / steps
    e = math.exp(-k * dt)
    c1 = s * s * e * (1.0 - e) / k
    c2 = th * s * s * (1.0 - e) ** 2 / (2.0 * k)
    de_dk, de_dT = -dt * e, -k * e / steps
    dc = [
        [0.0, 0.0, 0.0, 0.0, 0.0],  # V0 enters only the initial state
        [0.0, de_dk, s * s * (1.0 - 2.0 * e) * de_dk / k - c1 / k,
         -th * s * s * (1.0 - e) * de_dk / k - c2 / k, 0.0],
        [1.0, 0.0, 0.0, s * s * (1.0 - e) ** 2 / (2.0 * k), 0.0],
        [0.0, 0.0, 2.0 * s * e * (1.0 - e) / k, th * s * (1.0 - e) ** 2 / k, 0.0],
        [0.0, de_dT, s * s * (1.0 - 2.0 * e) * de_dT / k, -th * s * s * (1.0 - e) * de_dT / k,
         0.5 / steps],
    ]
    djc = [  # α = ∂κ/σ, β = −(∂V0 + ∂(κθT))/σ, γ = σ·∂(1/σ)
        [0.0, -1.0 / s, 0.0],
        [1.0 / s, -th * T / s, 0.0],
        [0.0, -k * T / s, 0.0],
        [0.0, 0.0, -1.0 / s],
        [0.0, -k * th / s, 0.0],
    ]
    return (torch.tensor(dc, dtype=torch.float64), torch.tensor(djc, dtype=torch.float64))


def _scan_with_tangents(v0_val, zs, us, c, dc):
    """The mixing scan with ``dc.shape[0]`` forward-tangent directions:
    returns (v_T, iv, j, dv (n_dirs, ...), div (n_dirs, ...)).  ``zs``/``us``
    are (steps, ...) draw tensors."""
    shape = zs.shape[1:]
    n_dirs = dc.shape[0]
    opts = dict(dtype=zs.dtype, device=zs.device)
    v = torch.full(shape, float(v0_val), **opts)
    iv = torch.zeros(shape, **opts)
    j = torch.zeros(shape, **opts)
    dv = torch.zeros((n_dirs,) + shape, **opts)
    dv[0] = 1.0  # ∂V/∂V0 = 1 at t = 0
    div = torch.zeros((n_dirs,) + shape, **opts)

    dc = dc.to(zs.device)
    bshape = (n_dirs,) + (1,) * len(shape)
    d_th, d_e, d_c1, d_c2, d_hdt = (dc[:, k].reshape(bshape) for k in range(5))
    c_th, c_e, c_c1 = c["theta"], c["e"], c["c_s2_v"]
    half_dt = c["half_dt"]
    for z, u in zip(zs, us):
        vn, cm, cs = qe_v_step_with_coeffs(v, z, u, c)
        a_coef = cm * c_e + cs * c_c1
        src = cm[None] * (d_th * (1.0 - c_e) + d_e * (v - c_th)[None]) + cs[None] * (
            d_c1 * v[None] + d_c2)
        dvn = a_coef[None] * dv + src
        v_sum = v + vn
        iv_step = half_dt * v_sum
        j = j + (vn - v) * c["inv_sigma"] + iv_step * c["k_over_sigma"] - c["ktd_over_sigma"]
        div = div + half_dt * (dv + dvn) + d_hdt * v_sum[None]
        iv = iv + iv_step
        v, dv = vn, dvn
    return v, iv, j, dv, div


def heston_mixing_price_and_greeks(prob, method, key=None):
    """Price and the 7-parameter greek dict (keys :data:`GREEK_ORDER`) of a
    European vanilla under ``MonteCarlo(HestonDynamics(),
    HestonQE(conditional=True))``, in one forward pass over the same draws
    as the seeded ``solve`` (so the gradients equal ``torch.autograd.grad``
    of that price to rounding).  The rate greek assumes a flat short rate and
    includes the discount term.  Returns float64 0-dim tensors."""
    from ..models.dynamics import HestonDynamics
    from .heston_qe_mixing import qe_mixing_draws
    from .montecarlo import HestonQE, MonteCarlo, sim_params

    if not (isinstance(method, MonteCarlo) and isinstance(method.dynamics, HestonDynamics)
            and isinstance(method.strategy, HestonQE) and method.strategy.conditional):
        raise TypeError(
            "heston_mixing_price_and_greeks requires MonteCarlo(HestonDynamics, "
            "HestonQE(conditional=True))"
        )
    if method.strategy.use_kernel:
        raise TypeError(
            "heston_mixing_price_and_greeks draws the pure-torch streams; for "
            "use_kernel=True methods use "
            "ops.heston_qe_greeks_kernel.heston_qe_mixing_price_and_greeks "
            "(or torch.autograd.grad through solve, which runs the kernels' backward)"
        )
    require_european(prob.payoff, "heston_mixing_price_and_greeks", spot_only=True)
    if torch.as_tensor(prob.payoff.strike).ndim > 0:
        raise TypeError("scalar strike only (loop over a strike grid outside)")

    device = resolve_device(method.device)
    config = method.config
    # the drift r0 is r − q; the rate greek stays d/dr (∂(r − q)/∂r = 1)
    market, T, r0 = sim_params(prob)
    spot, v0, kappa, theta, sigma, rho, r0 = (
        float(x) for x in (market.spot, market.V0, market.kappa, market.theta, market.sigma,
                           market.rho, r0))
    steps = config.steps
    dt = T / steps
    zs, us = qe_mixing_draws(config, key, 0, 0, device=device)
    c = dict(qe_constants(kappa, theta, sigma, rho, r0, dt), half_dt=0.5 * dt,
             inv_sigma=1.0 / sigma, k_over_sigma=kappa / sigma,
             ktd_over_sigma=kappa * theta * dt / sigma)
    c = {k: f64(x, device=device) for k, x in c.items()}
    # four directions: the T row (the theta greek) is not in GREEK_ORDER
    dc, djc = greek_tables(kappa, theta, sigma, T, steps)
    dc, djc = dc[:4], djc[:4].to(device)
    _v_t, iv, j, dv, div = _scan_with_tangents(v0, zs, us, c, dc)
    bshape = (djc.shape[0],) + (1,) * iv.ndim
    dj = (c["inv_sigma"] * dv + c["k_over_sigma"] * div + djc[:, 0].reshape(bshape) * iv[None]
          + djc[:, 1].reshape(bshape) + djc[:, 2].reshape(bshape) * j[None])

    cp = prob.payoff.call_put()
    strike = float(prob.payoff.strike)
    f0 = spot * math.exp(r0 * T)
    y, y_iv, y_j, y_rho, y_f0 = cond_bs_value_and_partials(
        iv, j, f0=f0, log_f0_over_k=math.log(f0 / strike), strike=strike, rho=rho, cp=cp)

    D = df_yf(market.rate, T).detach().to(device)
    n = y.numel()
    price = D * torch.sum(y) / n
    chain = (torch.sum(y_iv * div, dim=tuple(range(1, div.ndim)))
             + torch.sum(y_j * dj, dim=tuple(range(1, dj.ndim)))) / n
    m_y_f0 = torch.sum(y_f0) / n
    m_y_rho = torch.sum(y_rho) / n
    greeks = {
        "spot": D * m_y_f0 * f0 / spot,
        "V0": D * chain[0],
        "kappa": D * chain[1],
        "theta": D * chain[2],
        "sigma": D * chain[3],
        "rho": D * m_y_rho,
        # flat rate: F0 = S0·e^{rT} inside, e^{−rT} discount outside
        "rate": D * m_y_f0 * f0 * T - T * price,
    }
    return price, greeks
