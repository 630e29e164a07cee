"""Heston 2-D PDE pricing by ADI (Craig–Sneyd): ``PDEMethod(HestonDynamics())``.

Port of ``hedgehog_tpu/methods/pde2d.py``.  The Heston backward PDE

    V_t + ½S²v·V_SS + ρσSv·V_Sv + ½σ²v·V_vv + (r−q)S·V_S + κ(θ−v)·V_v − rV = 0

on a (variance × spot) grid, split in the In 't Hout–Foulon (2010) style:

- **A1**, the S-direction operator (½S²v·V_SS + (r−q)S·V_S − ½rV), and
  **A2**, the v-direction operator (½σ²v·V_vv + κ(θ−v)·V_v − ½rV), both by
  the 1-D engine's Péclet-limited convection-diffusion stencil (monotone
  rows; one-sided far-field boundaries, at v = 0 exactly the CIR inflow
  κθ·V_v − ½rV);
- **A0**, the mixed term ρσSv·V_Sv, explicit (central cross stencil);
- **Craig–Sneyd** time stepping: a Douglas predictor (one batched
  tridiagonal solve per direction) and a corrector that restores second
  order with A0 ≠ 0; the Rannacher steps after expiry run the predictor
  fully implicit, without the corrector.

Each implicit solve is one batch of tridiagonal systems by parallel cyclic
reduction (math/linalg.tridiag_solve_pcr): all variance rows along S, then
all spot columns along v (the transpose made contiguous).  The backward
loop reads nothing back to the host: the rate, exercise mask and rebate
line are built before it, the stencils once (a Heston market's rate is
flat) and the implicit matrices once for each θ.

Payoffs: vanillas and digitals (European, American and Bermudan by
projection) and single knock-out barriers (the barrier an S-grid endpoint
with a Dirichlet rebate line over every variance row, pinned again after
the v-solve); European knock-ins by in-out parity, early-exercise
knock-ins raise TypeError.  The grids are frozen (``detach``), and the
price is the bicubic readout at (V0, spot), so autograd through the loop
gives the spot and V0 greeks.  Everything runs on ``method.device``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.payoffs import (
    American,
    BarrierOption,
    Bermudan,
    European,
    KnockIn,
    KnockOut,
    Spot,
    Up,
    VanillaOption,
    bermudan_step_mask,
)
from ..core.problems import PDESolution, PricingProblem
from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df, df_yf
from ..math.interpolation import interp2d_nested
from ..math.linalg import tridiag_solve_pcr
from ..utils import f64, resolve_device
from .pde import _grid_bounds, _sinh_grid, _terminal_condition, convection_diffusion_operator

__all__ = ["solve_pde_heston"]


def _mean_variance(kappa, theta, v0, T: float):
    """E[(1/T)∫₀ᵀ v_t dt], the CIR mean integrated variance (grid sizing)."""
    kt = torch.clamp(kappa * T, min=1e-12)
    return theta + (v0 - theta) * (1.0 - torch.exp(-kt)) / kt


def _heston_grids(p: dict, payoff, method, T: float, dev, s_lo=None, s_hi=None):
    """The frozen spot grid (sinh-clustered at the strike, the 1-D
    engine's bounds) and variance grid (sinh-clustered toward 0 up to
    v_max, the node at v = 0 exactly 0)."""
    sigma_ref = torch.sqrt(_mean_variance(p["kappa"], p["theta"], p["v0"], T))
    lo, hi = _grid_bounds(p["market"], payoff, sigma_ref, T, method.n_std, dev)
    lo = lo if s_lo is None else s_lo
    hi = hi if s_hi is None else s_hi
    k = f64(payoff.strike, device=dev)
    center = torch.minimum(torch.maximum(k, lo), hi)
    s_grid = _sinh_grid(lo, hi, center, method.cluster * k, method.space_steps).detach()
    # v_max covers 5× the level marks and the mean + 10 stationary CIR
    # stds σ√(θ/2κ): truncating the right tail biases Feller-violating markets
    theta, v0, sig_v = p["theta"], p["v0"], p["sigma"]
    v_tail = theta + 10.0 * sig_v * torch.sqrt(theta / (2.0 * torch.clamp(p["kappa"], min=1e-8)))
    v_max = torch.maximum(torch.clamp(5.0 * torch.maximum(theta, v0), min=0.5), v_tail)
    d = torch.clamp(torch.maximum(theta, v0), min=5e-3) / 2.0
    u = torch.linspace(0.0, 1.0, method.var_steps + 1, dtype=torch.float64, device=dev)
    v = d * torch.sinh(u * torch.asinh(v_max / d))
    v_grid = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev), v[1:]]).detach()
    return s_grid, v_grid


def _first_derivative_weights(x):
    """Non-uniform central first-derivative weights (w_m, w_0, w_p) at the
    interior nodes of ``x`` (the explicit mixed stencil)."""
    h = torch.diff(x)
    h_m, h_p = h[:-1], h[1:]
    w_m = -h_p / (h_m * (h_m + h_p))
    w_p = h_m / (h_p * (h_m + h_p))
    return w_m, -(w_m + w_p), w_p


def _apply_tridiag(l, m, u, x):
    """(l, m, u)·x along the last axis (l[..., 0] and u[..., −1] unused)."""
    zero = torch.zeros_like(x[..., :1])
    return (l * torch.cat([zero, x[..., :-1]], dim=-1) + m * x
            + u * torch.cat([x[..., 1:], zero], dim=-1))


def _apply_tridiag_v(l, m, u, x):
    """(l, m, u)·x along the first (variance) axis, the diagonals (n_v + 1,)."""
    zero = torch.zeros_like(x[:1])
    return (l[:, None] * torch.cat([zero, x[:-1]]) + m[:, None] * x
            + u[:, None] * torch.cat([x[1:], zero]))


def solve_pde_heston(prob: PricingProblem, method) -> PDESolution:
    """The Heston ADI price of ``prob`` (a ``HestonInputs`` market) under
    ``method`` (a ``PDEMethod`` whose dynamics is ``HestonDynamics``)."""
    payoff = prob.payoff
    if isinstance(payoff, BarrierOption):
        if isinstance(payoff.knock, KnockIn):
            if not isinstance(payoff.exercise_style, European):
                raise TypeError(
                    "early-exercise knock-ins have no in-out parity; price "
                    "them on the conditional-grid barrier LSM"
                )
            return _solve_heston_knock_in(prob, method)
        return _solve_heston_core(prob, method, barrier=True)
    return _solve_heston_core(prob, method, barrier=False)


def _solve_heston_core(prob: PricingProblem, method, barrier: bool) -> PDESolution:
    payoff = prob.payoff
    market = prob.market_inputs
    dev = resolve_device(method.device)
    T = market_yearfrac(market, payoff.expiry)
    M = method.time_steps
    dt = T / M
    p = dict(market=market, **{name: f64(getattr(market, field), device=dev) for name, field in (
        ("v0", "V0"), ("kappa", "kappa"), ("theta", "theta"), ("sigma", "sigma"), ("rho", "rho"),
        ("spot", "spot"))})
    q = f64(carry_yield(market), device=dev)
    kappa, theta, sig_v, rho = p["kappa"], p["theta"], p["sigma"], p["rho"]

    d_side = s_lo = s_hi = None
    if barrier:
        if torch.as_tensor(payoff.barrier).ndim > 0:
            raise TypeError("PDEMethod prices one (strike, barrier) pair per solve")
        H = f64(payoff.barrier, device=dev)
        if isinstance(payoff.direction, Up):
            s_hi, d_side = H, -1
        else:
            s_lo, d_side = H, 0
    s_grid, v_grid = _heston_grids(p, payoff, method, T, dev, s_lo, s_hi)
    n_v, n_s = v_grid.shape[0], s_grid.shape[0]

    # the Dirichlet rebate line at each time index (barriers only)
    t_edges = torch.arange(M + 1, dtype=torch.float64, device=dev) * dt
    D_T = df(market.rate, payoff.expiry).to(dev)
    if barrier:
        R = f64(payoff.rebate, device=dev)
        d_vals = (R.expand(M + 1) if payoff.rebate_at_hit
                  else R * D_T / df_yf(market.rate, t_edges).to(dev))
    # the port's Heston markets carry a flat rate (HestonInputs refuses a
    # curve), so every step's curve-exact forward rate is the first step's
    log_df = torch.log(df_yf(market.rate, t_edges[:2]).to(dev))
    r = -(log_df[1] - log_df[0]) / dt

    idx_s = torch.arange(n_s, device=dev)
    pin = None if d_side is None else idx_s == (n_s - 1 if d_side == -1 else 0)
    U = torch.broadcast_to(_terminal_condition(payoff, s_grid), (n_v, n_s))
    if pin is not None:
        U = torch.where(pin, d_vals[-1], U)

    style = payoff.exercise_style
    is_bermudan = isinstance(style, Bermudan)
    can_exercise = isinstance(style, American) or is_bermudan
    ex_mask = bermudan_step_mask(style, market, payoff.expiry, M, device=dev) if is_bermudan else None
    intrinsic = payoff(s_grid)[None, :] if can_exercise else None

    # the explicit mixed term c·D_S D_v V, c = ρσ S v, on the interior nodes
    sw_m, sw_0, sw_p = _first_derivative_weights(s_grid)
    vw_m, vw_0, vw_p = _first_derivative_weights(v_grid)
    mix_c = rho * sig_v * s_grid[None, 1:-1] * v_grid[1:-1, None]

    def a0_apply(x):
        dv = vw_m[:, None] * x[:-2] + vw_0[:, None] * x[1:-1] + vw_p[:, None] * x[2:]
        dsdv = sw_m * dv[:, :-2] + sw_0 * dv[:, 1:-1] + sw_p * dv[:, 2:]
        return torch.nn.functional.pad(mix_c * dsdv, (1, 1, 1, 1))

    # A1's diagonals (n_v, n_s) along S and A2's (n_v,) along v
    a1 = convection_diffusion_operator(
        s_grid, 0.5 * v_grid[:, None] * s_grid[None, :] ** 2,
        torch.broadcast_to((r - q) * s_grid, (n_v, n_s)), 0.5 * r)
    a2 = convection_diffusion_operator(
        v_grid, 0.5 * sig_v**2 * v_grid, kappa * (theta - v_grid), 0.5 * r)

    def implicit(th):
        """The implicit matrices I − θΔA1 (with the barrier's identity rows)
        and I − θΔA2."""
        l1, m1, u1 = (-th * dt * a1[0], 1.0 - th * dt * a1[1], -th * dt * a1[2])
        if pin is not None:
            l1, u1 = torch.where(pin, 0.0, l1), torch.where(pin, 0.0, u1)
            m1 = torch.where(pin, 1.0, m1)
        return (l1, m1, u1), (-th * dt * a2[0], 1.0 - th * dt * a2[1], -th * dt * a2[2])

    # the Rannacher steps after expiry (i ≥ M − rannacher) run fully
    # implicit without the corrector
    rann = min(method.rannacher, M)
    mats = {True: (*implicit(1.0), 1.0), False: (*implicit(method.theta), method.theta)}

    def solve_s(mats, rhs, d_val):
        if pin is not None:
            rhs = torch.where(pin, d_val, rhs)
        return tridiag_solve_pcr(*mats, rhs)

    def solve_v(mats, rhs, d_val):
        x = tridiag_solve_pcr(*mats, rhs.T.contiguous()).T
        # the barrier line is constant in v: pinned again
        return x if pin is None else torch.where(pin, d_val, x)

    for i in range(M - 1, -1, -1):
        startup = i >= M - rann
        imp_s, imp_v, th = mats[startup]
        d_val = d_vals[i] if pin is not None else None
        a1U = _apply_tridiag(*a1, U)
        a2U = _apply_tridiag_v(*a2, U)
        a0U = a0_apply(U)
        # Douglas predictor
        y0 = U + dt * (a0U + a1U + a2U)
        y1 = solve_s(imp_s, y0 - th * dt * a1U, d_val)
        U_new = solve_v(imp_v, y1 - th * dt * a2U, d_val)
        if not startup:
            # Craig–Sneyd corrector (second order with the mixed term)
            y0h = y0 + 0.5 * dt * (a0_apply(U_new) - a0U)
            y1h = solve_s(imp_s, y0h - th * dt * a1U, d_val)
            U_new = solve_v(imp_v, y1h - th * dt * a2U, d_val)
        if can_exercise:
            exercised = torch.maximum(U_new, intrinsic)
            U_new = torch.where(ex_mask[i], exercised, U_new) if is_bermudan else exercised
            if pin is not None:  # the barrier endpoint is not exercisable
                U_new = torch.where(pin, d_val, U_new)
        U = U_new

    price_live = interp2d_nested(p["v0"], p["spot"], v_grid, s_grid, U,
                                 kind_x="cubic", kind_y="cubic")
    if barrier:
        knocked0 = (p["spot"] >= H) if isinstance(payoff.direction, Up) else (p["spot"] <= H)
        price = torch.where(knocked0, d_vals[0], price_live)
    else:
        price = price_live
    return PDESolution(prob, method, price, (s_grid, v_grid), U)


def _solve_heston_knock_in(prob: PricingProblem, method) -> PDESolution:
    """European knock-in by in-out parity on the same engine:
    KI(R) = vanilla − KO(0) + R·NT, NT = D_T − (KO(rebate 1 at expiry) − KO(0))."""
    payoff = prob.payoff
    market = prob.market_inputs
    van = VanillaOption(payoff.strike, payoff.expiry, European(), payoff.call_put, Spot())
    ko0 = dataclasses.replace(payoff, knock=KnockOut(), rebate=0.0)
    ko1e = dataclasses.replace(payoff, knock=KnockOut(), rebate=1.0, rebate_at_hit=False)
    p_van = _solve_heston_core(PricingProblem(van, market), method, barrier=False).price
    p_ko0 = _solve_heston_core(PricingProblem(ko0, market), method, barrier=True).price
    p_ko1e = _solve_heston_core(PricingProblem(ko1e, market), method, barrier=True).price
    no_touch = df(market.rate, payoff.expiry).to(p_van.device) - (p_ko1e - p_ko0)
    price = p_van - p_ko0 + f64(payoff.rebate, device=p_van.device) * no_touch
    return PDESolution(prob, method, price, None, None)
