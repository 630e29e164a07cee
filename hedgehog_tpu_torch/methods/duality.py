"""Andersen-Broadie primal-dual bounds for LSM American/Bermudan prices.

Port of ``hedgehog_tpu/methods/duality.py``.  The LSM policy evaluated on
fresh paths is a LOWER bound in expectation (any concrete stopping rule is
suboptimal); the Andersen-Broadie (2004) dual turns the same frozen policy
into an UPPER bound,

    price ≤ E[ max_t (h_t − M_t) ]        for any martingale M,

with M built from the policy's value process: M_t − M_{t−1} = V̂_t − Ĉ_{t−1},
V̂_t the discounted payoff h_t where the policy exercises and the nested
continuation estimate Ĉ_t where it continues.  A tight [lower, upper]
interval certifies the policy; a wide one flags a misspecified basis.

All inner bundles run in ONE loop over calendar time on a (dates × outer ×
inner) lane tensor on the device, a lane moving once the clock passes its
start date (at clock u the rows of the dates before u, the only ones that
move, are stepped in place), so the nested simulation is elementwise work
with nothing read back to the host.  Two Markov-state samplers, as in the JAX package:

* LognormalDynamics grids (exact per-step lognormal transitions), state S;
* HestonDynamics with ``HestonQE(conditional=True)``: the QE variance step
  and the exact conditional lognormal bridge of the fit grid, state
  (log S, V), regressing on the joint basis.

The outer paths are ``simulate_price_grid`` / ``simulate_conditional_grid``
draws under PRNG with the seed ``config.seed + seed``; the inner draws are
Philox words of the lane index at clock step u under a key derived from the
two seeds (the JAX package's threefry streams are not reproduced).  Memory:
the lane tensors hold steps × n_outer × n_inner float64 each (50 × 4096 ×
128 × 8 B ≈ 0.2 GB), a handful of them at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core.payoffs import VanillaOption
from ..core.problems import PricingProblem
from ..market.vol_surface import FlatVolSurface, get_vol
from ..math.counter_rng import uniform_from_bits
from ..models.dynamics import HestonDynamics, LognormalDynamics
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64, resolve_device
from .lsm import (
    LSM,
    _exercise_mask,
    _fit_grid,
    _is_conditional,
    _joint_basis,
    _lsm_setup,
    _poly_basis,
    device_payoff,
    lsm_backward_induction,
)
from .montecarlo import Antithetic, sim_params

__all__ = ["DualBound", "lsm_dual_bound"]

_MASK32 = 0xFFFFFFFF
#: the Philox key word of the inner bundles (outer paths use device id 0)
_INNER_TAG = 0x0AB1D0A1


@dataclasses.dataclass(frozen=True)
class DualBound:
    """Primal-dual interval for an LSM price: ``lower``/``upper`` the
    out-of-sample policy value and the Andersen-Broadie dual estimate,
    ``se_lower``/``se_upper`` their standard errors over the outer paths,
    ``primal`` the in-sample LSM price (what ``solve`` reports), ``gap`` =
    upper − lower (includes the O(1/√n_inner) dual inflation)."""

    lower: Any
    upper: Any
    se_lower: Any
    se_upper: Any
    primal: Any
    gap: Any


def _inner_words(shape, u: int, seed: int, device):
    """The four Philox words of clock step ``u`` for the lanes of the first
    ``shape[0]`` date rows (the counter is the lane's index in the whole
    lane tensor)."""
    lane = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return [w.reshape(shape) for w in philox_block(lane, u, seed & _MASK32, _INNER_TAG)]


def lsm_dual_bound(prob: PricingProblem, method: LSM, n_outer: int = 2048, n_inner: int = 128,
                   seed: int = 0x0AB1) -> DualBound:
    """Fit the LSM policy on the method's own configuration, then certify
    it: a fresh-path lower bound and the Andersen-Broadie dual upper bound.
    ``n_outer`` fresh outer paths (antithetic pairs), ``n_inner`` nested
    continuation samples per (outer path, date); ``seed`` derives the outer
    and inner streams, distinct from the fit stream.  Float64 0-dim tensors
    on the method's device."""
    payoff = prob.payoff
    if not isinstance(payoff, VanillaOption):
        raise TypeError(
            f"lsm_dual_bound certifies plain-vanilla LSM policies; got {type(payoff).__name__}"
        )
    mc = method.mc_method
    conditional = _is_conditional(mc) and isinstance(mc.dynamics, HestonDynamics)
    if not conditional and not isinstance(mc.dynamics, LognormalDynamics):
        raise TypeError(
            "lsm_dual_bound's nested samplers cover LognormalDynamics grids and "
            "HestonDynamics with HestonQE(conditional=True); other stochastic-vol "
            "policies validate against lattice oracles"
        )
    if torch.as_tensor(payoff.strike).ndim > 0:
        raise TypeError("lsm_dual_bound prices one contract; loop over a strike grid outside")

    device = resolve_device(mc.device)
    payoff = device_payoff(payoff, device)
    log_disc, strike_scale = _lsm_setup(prob, method)
    ex_mask = _exercise_mask(prob, method)  # None = American
    nsteps, degree = mc.config.steps, method.degree
    market, T, r0 = sim_params(prob)
    dt = T / nsteps
    n_outer = 2 * (n_outer // 2)  # antithetic outer pairs

    # 1. fit the policy on the method's own (training) stream
    spots, vols, terminal = _fit_grid(prob, method)
    tau_fit, val_fit, betas_scan = lsm_backward_induction(
        spots, payoff, log_disc, degree, strike_scale, vols=vols, terminal_value=terminal,
        exercise_mask=ex_mask, collect_betas=True)
    primal = torch.mean(torch.exp(tau_fit * log_disc) * val_fit)
    betas_by_t = torch.flip(betas_scan, dims=(0,))  # [t − 1] is the policy at date t

    def exercises(t: int, s, v):
        """The frozen policy's exercise indicator at date t (1 ≤ t ≤ nsteps − 1)."""
        pay = payoff(s)
        s_n = (s / strike_scale).reshape(-1)
        phi = _joint_basis(s_n, v.reshape(-1), degree) if conditional else _poly_basis(s_n, degree)
        ex = (pay > 0.0) & (pay > (phi @ betas_by_t[t - 1]).reshape(s.shape))
        if ex_mask is not None:
            ex = ex & ex_mask[t]
        return ex

    # 2. outer fresh paths through the fit grid's sampler, and the lane stepper
    cfg_o = dataclasses.replace(mc.config, trajectories=n_outer // 2, seed=mc.config.seed + seed,
                                variance_reduction=Antithetic(), qmc=False)
    s_outer, v_outer, _ = _fit_grid(prob, dataclasses.replace(method, rao_blackwell=False),
                                    dataclasses.replace(mc, config=cfg_o))
    inner_seed = (mc.config.seed * 0x9E3779B1 + seed) & _MASK32
    lane_shape = (nsteps, n_outer, n_inner)
    if conditional:
        from ..models.heston_qe import qe_constants, qe_v_step

        kappa, theta, sig_v, rho, r0 = (f64(x, device=device) for x in (
            market.kappa, market.theta, market.sigma, market.rho, r0))
        qe_c = qe_constants(kappa, theta, sig_v, rho, r0, dt)
        ktd = kappa * theta * dt
        rho_bar2 = 1.0 - rho**2
        state = (torch.log(s_outer[:nsteps, :, None]).expand(lane_shape).clone(),
                 v_outer[:nsteps, :, None].expand(lane_shape).clone())

        def lane_step(state, u):
            x, v = state
            w = _inner_words(x.shape, u, inner_seed, device)
            z_v, z_perp = box_muller(w[0], w[1], dtype=torch.float64)
            v_new = qe_v_step(v, z_v, uniform_from_bits(w[2]).double(), qe_c)
            iv = 0.5 * dt * (v + v_new)
            j = (v_new - v - ktd + kappa * iv) / sig_v
            x_new = x + r0 * dt - 0.5 * iv + rho * j + torch.sqrt(
                torch.clamp(rho_bar2 * iv, min=1e-18)) * z_perp
            return x_new, v_new

        def lane_spot_vol(state):
            return torch.exp(state[0]), state[1]
    else:
        sigma = (market.sigma.sigma if isinstance(market.sigma, FlatVolSurface)
                 else get_vol(market.sigma, payoff.expiry, market.spot))
        sigma, r0 = f64(sigma, device=device), f64(r0, device=device)
        drift = (r0 - 0.5 * sigma**2) * dt
        vol_dt = sigma * math.sqrt(dt)
        state = (s_outer[:nsteps, :, None].expand(lane_shape).clone(),)

        def lane_step(state, u):
            (s,) = state
            w = _inner_words(s.shape, u, inner_seed, device)
            z, _ = box_muller(w[0], w[1], dtype=torch.float64)
            return (s * torch.exp(drift + vol_dt * z),)

        def lane_spot_vol(state):
            return state[0], torch.zeros_like(state[0])

    disc_t = torch.exp(torch.arange(nsteps + 1, dtype=torch.float64, device=device) * log_disc)
    h = disc_t[:, None] * payoff(s_outer)  # payoffs discounted to 0
    ex_outer = torch.stack(
        [exercises(t, s_outer[t], v_outer[t] if conditional else torch.zeros_like(s_outer[t]))
         for t in range(1, nsteps)]
        + [torch.ones((n_outer,), dtype=torch.bool, device=device)])  # t = 1..nsteps

    # 3. every nested continuation bundle in one loop over the clock: at
    # clock u the bundles started at dates 0..u − 1 move
    stopped = torch.zeros(lane_shape, dtype=torch.bool, device=device)
    val = torch.zeros(lane_shape, dtype=torch.float64, device=device)
    for u in range(1, nsteps + 1):
        moved = lane_step(tuple(x[:u] for x in state), u)
        for x, x_new in zip(state, moved):
            x[:u] = x_new
        s, v = lane_spot_vol(moved)
        ex_u = exercises(u, s, v) if u < nsteps else torch.ones_like(stopped[:u])
        stop_now = ~stopped[:u] & ex_u
        val[:u] = torch.where(stop_now, torch.exp(u * log_disc) * payoff(s), val[:u])
        stopped[:u] |= stop_now
    c_hat = torch.mean(val, dim=-1)  # (nsteps, n_outer): Ĉ_0 .. Ĉ_{n−1}

    # 4. lower bound: the policy replayed on the outer paths
    tau_out = torch.argmax(ex_outer.to(torch.int32), dim=0) + 1  # the first exercise date
    low_vals = torch.exp(tau_out * log_disc) * payoff(
        torch.gather(s_outer, 0, tau_out[None, :])[0])
    half = n_outer // 2
    pair_vals = 0.5 * (low_vals[:half] + low_vals[half:])
    lower = torch.mean(pair_vals)
    se_lower = torch.std(pair_vals, correction=0) / math.sqrt(half)

    # 5. the dual martingale and the upper bound: Δ_t = V̂_t − Ĉ_{t−1},
    # M_t = Σ_{s ≤ t} Δ_s, U = max_t (h_t − M_t)
    c_cont = torch.cat([c_hat[1:], torch.zeros((1, n_outer), dtype=torch.float64,
                                               device=device)])  # Ĉ_t, t = 1..n
    v_hat = torch.where(ex_outer, h[1:], c_cont)
    slack = h[1:] - torch.cumsum(v_hat - c_hat, dim=0)
    if ex_mask is not None:
        # slot t gates exercise at date t (1..nsteps − 1); expiry always pays
        allowed = torch.cat([ex_mask[1:], torch.ones((1,), dtype=torch.bool, device=device)])
        slack = torch.where(allowed[:, None], slack, -torch.inf)
    up_vals = torch.max(slack, dim=0).values
    upper = torch.mean(up_vals)
    se_upper = torch.std(up_vals, correction=0) / math.sqrt(n_outer)
    return DualBound(lower=lower, upper=upper, se_lower=se_lower, se_upper=se_upper,
                     primal=primal, gap=upper - lower)
