"""The Heston-Hull-White conditional mixing estimator in float64 torch.

Port of ``_hhw_mixing_values`` of ``hedgehog_tpu/methods/montecarlo.py``
(``MonteCarlo(HestonHullWhiteDynamics(), HestonQE(conditional=True), cfg)``).
With W_v ⊥ W_r, log S_T given the QE variance path and the exact OU rate
path is normal:

    log S_T | (V, x) = log S₀ + ∫r − qT − ½IV + ρ_sv·J_v + ρ_sr·J_r
                       + √((1 − ρ_sv² − ρ_sr²)·IV)·Z⊥,

J_v from the CIR identity (trapezoid IV), J_r = Σ√V_k·ΔW_r,k on the jointly
exact per-step rate block (shock = ∫e^{−a(Δ−u)}dW, ΔW_r; the ∫x increment's
w = ∫B(Δ−u)dW is the exact linear identity (ΔW_r − shock)/a, not a third
draw).  Each path closes with the conditional Black-Scholes form and carries
its pathwise discount relative to the curve, exp(−∫x − ½σ_r²Γ(T)), whose
mean is 1 (the Hull-White martingale identity): the solver multiplies by
P(0, T).

Draws (the JAX package has no QMC stream here; ``qmc=True`` raises
ValueError as there): Philox under ``HHW_TAG`` (key (seed, device_id),
counter (pair & 0xffffffff, pair >> 32, block, tag)), step s taking block 2s
(Box–Muller of words 0, 1 → z_v, z_a; of words 2, 3 → z_b) and word 0 of
block 2s + 1 (the QE uniform, (w + ½)·2^-32).  The antithetic twin negates
the normals and mirrors the uniform.  :func:`hhw_values_from_draws` takes
given draws in the JAX layout, so a test can feed the port JAX's.
"""

from __future__ import annotations

import torch

from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df_yf, spine_zeros
from ..models.heston_qe import qe_constants, qe_v_step
from ..models.hull_white import hw_b, hw_gamma
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import device_of, f64
from .heston_exact_mixing import conditional_payoff_close
from .jump_mc import _u32
from .montecarlo import Antithetic

__all__ = ["hhw_draws", "hhw_mixing_values", "hhw_values_from_draws"]

_MASK32 = 0xFFFFFFFF
#: Philox counter tag (the counter's last word) of the Heston-Hull-White stream
HHW_TAG = 0x68687720  # "hhw "


def hhw_draws(config, key=None, device_id=0, *, device):
    """(z (n_groups, steps, 3, paths), u (n_groups, steps, paths)) float64 on
    ``device``, the JAX estimator's layout: normals (z_v, z_a, z_b) and the
    QE uniform of each step."""
    seed = seed_from_key(config, key) & _MASK32
    pair = torch.arange(config.trajectories, dtype=torch.int64, device=device)
    zs, us = [], []
    for s in range(config.steps):
        w = philox_block(pair, 2 * s, seed, device_id & _MASK32, HHW_TAG)
        z_v, z_a = box_muller(w[0], w[1], dtype=torch.float64)
        z_b = box_muller(w[2], w[3], dtype=torch.float64)[0]
        zs.append(torch.stack([z_v, z_a, z_b]))
        w_u = philox_block(pair, 2 * s + 1, seed, device_id & _MASK32, HHW_TAG)[0]
        us.append(_u32(w_u))
    z, u = torch.stack(zs), torch.stack(us)
    if isinstance(config.variance_reduction, Antithetic):
        return torch.stack([z, -z]), torch.stack([u, 1.0 - u])
    return z[None], u[None]


def hhw_values_from_draws(prob, z: torch.Tensor, u: torch.Tensor, *, device) -> torch.Tensor:
    """Per-path conditional values (n_groups, paths), or (n_groups, m, paths)
    for a strike grid, each times its pathwise discount relative to P(0, T),
    from the draws ``z`` (g, steps, 3, paths) and ``u`` (g, steps, paths)."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = z.shape[1]
    dt = T / steps
    spot, v0, kappa, theta, sig_v, rho_sv, a, sig_r, rho_sr, q = (
        f64(x, device=device) for x in (market.spot, market.V0, market.kappa, market.theta,
                                        market.sigma, market.rho_sv, market.a, market.sigma_r,
                                        market.rho_sr, carry_yield(market)))
    # the QE variance constants (the drift only feeds the X step, unused here)
    c_qe = qe_constants(kappa, theta, sig_v, rho_sv, f64(0.0, device=device), dt)
    ktd = kappa * theta * dt
    e1 = torch.exp(-a * dt)
    b_d = hw_b(a, dt)
    s_sh = torch.sqrt((1.0 - e1 * e1) / (2.0 * a))
    c21 = b_d / s_sh
    s_dw = torch.sqrt(torch.clamp(dt - c21**2, min=1e-30))

    z, u = f64(z, device=device), f64(u, device=device)
    v = v0 + torch.zeros(z.shape[0], z.shape[3], dtype=torch.float64, device=device)
    x = torch.zeros_like(v)
    integ, iv, jr = torch.zeros_like(v), torch.zeros_like(v), torch.zeros_like(v)
    for s in range(steps):
        z_v, z_a, z_b = z[:, s, 0], z[:, s, 1], z[:, s, 2]
        shock = s_sh * z_a
        dwr = c21 * z_a + s_dw * z_b
        w = (dwr - shock) / a  # the exact linear identity
        # double where: QE's exponential branch reaches v == 0 exactly, where
        # d(sqrt)/dv would poison the whole gradient with NaN
        v_pos = v > 0.0
        sqrt_v = torch.where(v_pos, torch.sqrt(torch.where(v_pos, v, 1.0)), 0.0)
        jr = jr + sqrt_v * dwr  # left-point V
        integ = integ + x * b_d + sig_r * w
        x = x * e1 + sig_r * shock
        v_new = qe_v_step(v, z_v, u[:, s], c_qe)
        iv = iv + 0.5 * dt * (v + v_new)
        v = v_new

    j_v = (v - v0 - ktd * steps + kappa * iv) / sig_v
    gamma_t = hw_gamma(a, T)
    curve_dev = device_of(spine_zeros(market.rate))
    ln_p0t = torch.log(df_yf(market.rate, f64(T, device=curve_dev))).to(device)
    int_r = integ - ln_p0t + 0.5 * sig_r**2 * gamma_t
    rho2 = rho_sv**2 + rho_sr**2
    f_eff = spot * torch.exp(int_r - q * T + rho_sv * j_v + rho_sr * jr - 0.5 * rho2 * iv)
    vals = conditional_payoff_close(prob.payoff, f_eff, (1.0 - rho2) * iv)
    disc = torch.exp(-integ - 0.5 * sig_r**2 * gamma_t)
    return vals * (disc[:, None, :] if vals.ndim == 3 else disc)


def hhw_mixing_values(prob, config, key=None, device_id=0, point_offset=0, *,
                      device) -> torch.Tensor:
    """:func:`hhw_values_from_draws` on the Philox stream of ``config``."""
    if config.qmc:
        raise ValueError(
            "qmc=True is not wired into the Heston-Hull-White mixing "
            "estimator yet (5 draws/step); use the PRNG stream"
        )
    z, u = hhw_draws(config, key, device_id, device=device)
    return hhw_values_from_draws(prob, z, u, device=device)
