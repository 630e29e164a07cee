"""Longstaff-Schwartz LSM for American and Bermudan options, on the device.

Port of the vanilla slice of ``hedgehog_tpu/methods/lsm.py`` (reference
src/pricing_methods/least_squares_montecarlo.jl):

- simulate the whole (steps + 1 × paths) price grid (antithetic doubles the
  path count, :70-85);
- the stopping state per path is (exercise step τ, exercise value), started
  at the terminal payoff (:112);
- backward over t = steps − 1 … 1: continuation = disc^(τ − t)·value with
  the single-step discount disc = df(T/steps) (:110, :117-118), regressed on
  the in-the-money paths' spot levels (:121-126), exercise where the
  intrinsic value beats the fitted continuation (:156-165);
- price = mean(disc^τ·value) (:132-133).

The regression on a variable in-the-money subset is a masked least-squares
fit through the normal equations with a tiny ridge, solved by the unrolled
Cholesky of math/linalg.py: fixed shapes, and nothing read back to the
host in the loop over steps.  Regressors are the spot over the strike (a
raw degree-5 Vandermonde at spot ~100 would be singular).  Under
``HestonQE(conditional=True)`` the grid is the conditional bridge's, and
the regression runs on the joint (S, V) basis, V being part of Heston's
Markov state; ``rao_blackwell`` replaces the terminal target by its
conditional expectation over the last step.

Single barriers run on the bridge grids of ``methods/bridge_mc.py``
(LognormalDynamics × EulerMaruyama, discrete dividends included, and the
conditional Heston grid with the joint basis): a knock-out carries the
per-segment no-cross factors in its stopping state (the knock-adjusted
continuation, the rebate's hold-value leg, and for American holders the
exercise at first passage), a knock-in integrates the live option's value
at the barrier, from a second regression localized there, against each
path's first-hit-segment law.

Under path sharding (``parallel/sharding.py``) each rank holds its own
paths and the regression is global: ``psum_group`` sums each step's
(n_terms × n_terms) normal equations over the ranks before the ridge, as
the JAX package's ``psum_axis`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.payoffs import (
    American,
    AsianOption,
    BarrierOption,
    Bermudan,
    DoubleBarrierOption,
    KnockIn,
    LookbackOption,
    Spot,
    Up,
    VanillaOption,
    bermudan_step_mask,
)
from ..core.problems import LSMSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import market_yearfrac
from ..market.rate_curve import df, df_yf
from ..math.linalg import cholesky_solve_small
from ..utils import f64, resolve_device
from .montecarlo import (
    HestonQE,
    MonteCarlo,
    sim_params,
    simulate_conditional_grid,
    simulate_price_grid,
)

__all__ = ["LSM", "device_payoff", "lsm_backward_induction", "rb_terminal_value"]


@dataclasses.dataclass(frozen=True)
class LSM(AbstractPricingMethod):
    """LSM over ``mc_method``'s grid (simulated on its device) with a
    polynomial basis of ``degree``.  ``rao_blackwell`` (conditional grids
    only): the terminal target max(S_T − K, 0) is replaced by its exact
    conditional expectation given (S_{n−1}, the variance path), the same
    mean with a lower variance; ignored on the other grids."""

    mc_method: Any = MonteCarlo()
    degree: int = 4
    rao_blackwell: bool = True


def _masked_lstsq_beta(phi, y, w, group=None):
    """β of the fit y ~ phi·β over the rows where w = 1: weighted normal
    equations with a ridge of 1e-10·(1 + tr(A)/n), so a system with no
    in-the-money path stays solvable (its fit is masked out downstream).
    With a ``torch.distributed`` ``group`` the normal equations are summed
    over its ranks first: every rank fits on the paths of all."""
    n_terms = phi.shape[1]
    phw = phi * w[:, None]
    A = phw.T @ phi
    b = phw.T @ y
    if group is not None:
        from ..parallel.collectives import all_reduce_sum, replicate

        A, b = all_reduce_sum(A, group), all_reduce_sum(b, group)
    eye = torch.eye(n_terms, dtype=A.dtype, device=A.device)
    ridge = 1e-10 * eye * (1.0 + torch.trace(A) / n_terms)
    beta = cholesky_solve_small(A + ridge, b)
    return beta if group is None else replicate(beta, group)


def _poly_basis(x, degree: int):
    """(paths, degree + 1) monomials, the reference's Polynomials.fit
    regressors (least_squares_montecarlo.jl:126)."""
    powers = torch.arange(degree + 1, device=x.device)
    return x[:, None] ** powers[None, :]


def _joint_basis(s, v, degree: int):
    """Bivariate monomials s^i·v^j with i + j ≤ degree."""
    terms = [s**i * v**j for i in range(degree + 1) for j in range(degree + 1 - i)]
    return torch.stack(terms, dim=1)


def lsm_backward_induction(spots, payoff, log_disc, degree: int, strike_scale, *,
                           psum_group=None, vols=None, terminal_value=None, exercise_mask=None,
                           collect_betas: bool = False, surv_factors=None, rebate_spec=None,
                           barrier_eval=None, hit_exercise_value=None):
    """Backward stopping-rule induction over a (steps + 1, paths) price grid:
    returns (tau, value) per path, tau as float64.  ``psum_group`` (a
    ``torch.distributed`` group; each rank passes its own paths) makes
    every regression global over the group's ranks.  ``vols`` (a matching
    variance grid) regresses on the joint (S, V) basis; ``terminal_value``
    replaces the terminal payoff as the initial stopping value;
    ``exercise_mask`` (steps,) bool gates exercise per grid date (None:
    every date); ``collect_betas`` also returns the per-step coefficients
    stacked in induction order t = steps − 1 … 1, the frozen policy the
    dual bound replays.

    ``surv_factors`` (knock-outs): the (steps, paths) per-segment bridge
    no-cross factors q_t.  The stopping state gains the future survival
    fsurv = Π_{s=t}^{τ−1} q_s, so the regressed continuation is the
    knock-adjusted value; exercise yields the intrinsic, and the fit is
    weighted by the past survival A_t = Π_{s<t} q_s.  The regressors gain
    q_t, q_t² and q_t·s, the shape of the boundary layer at the barrier.
    ``rebate_spec = (R, at_hit)`` carries the rebate's hold-value leg
    R_t = (1 − q_t)·rb_t + q_t·disc·R_{t+1} in the target;
    ``hit_exercise_value`` (American knock-outs only) is the undiscounted
    intrinsic at the barrier, exercised at first passage:
    rb_t = max(intrinsic(H)·disc^½, rb_t).  Returns (tau, value, fsurv,
    rleg), fsurv = Π_{s=1}^{τ−1} q_s (the t = 0 factor is the caller's).

    ``barrier_eval = (h_scaled, intrinsic_h)`` (knock-ins): each step also
    fits the same continuation targets with a Gaussian kernel in log(S/H)
    on a basis centred at the barrier, and returns (tau, value, ys) with
    ys the live option's value at the barrier at t = steps − 1 … 1 (the
    exercise max at exercise dates only): a scalar per step on spot-only
    grids, per path in v on joint-basis grids."""
    if barrier_eval is not None and surv_factors is not None:
        raise TypeError("barrier_eval is for knock-ins; surv_factors for knock-outs")
    if collect_betas and (barrier_eval is not None or surv_factors is not None):
        raise TypeError("collect_betas supports plain vanilla grids only")
    nsteps = spots.shape[0] - 1
    dev = spots.device
    n = spots.shape[1]
    tau = torch.full((n,), float(nsteps), dtype=torch.float64, device=dev)
    value = payoff(spots[nsteps]) if terminal_value is None else terminal_value
    barrier = surv_factors is not None
    if barrier:
        # past survival A_t = Π_{s<t} q_s, (steps + 1, paths), A_0 = 1
        past_surv = torch.cat([torch.ones_like(surv_factors[:1]),
                               torch.cumprod(surv_factors, dim=0)])
        fsurv = torch.ones((n,), dtype=torch.float64, device=dev)
        rleg = torch.zeros((n,), dtype=torch.float64, device=dev)
        rebate, rebate_at_hit = rebate_spec if rebate_spec is not None else (0.0, False)
        rebate = f64(rebate, device=dev)
        disc = torch.exp(log_disc)
        half_disc = torch.exp(0.5 * log_disc)
    betas, ys = [], []
    for t in range(nsteps - 1, 0, -1):  # t = 0 excluded (lsm.jl:114)
        s_t = spots[t]
        if barrier:
            q_t = surv_factors[t]
            fsurv_cont = fsurv * q_t
            # the rebate leg at t: a hit in [t, t + 1) pays rb_t (at the
            # segment midpoint, or R discounted from expiry), a survivor
            # carries the discounted leg downstream
            rb_t = rebate * half_disc if rebate_at_hit else rebate * torch.exp(
                (nsteps - t) * log_disc)
            if hit_exercise_value is not None:
                rb_t = torch.maximum(hit_exercise_value * half_disc, rb_t)
            rleg_cont = (1.0 - q_t) * rb_t + q_t * disc * rleg
            continuation = torch.exp((tau - t) * log_disc) * value * fsurv_cont + rleg_cont
        else:
            continuation = torch.exp((tau - t) * log_disc) * value
        payoff_t = payoff(s_t)
        itm = payoff_t > 0.0
        w = itm.to(torch.float64)
        if barrier:
            w = w * past_surv[t]
        if vols is None:
            phi = _poly_basis(s_t / strike_scale, degree)
        else:
            phi = _joint_basis(s_t / strike_scale, vols[t], degree)
        if barrier:
            s_n = s_t / strike_scale
            phi = torch.cat([phi, q_t[:, None], (q_t * q_t)[:, None], (q_t * s_n)[:, None]],
                            dim=1)
        beta = _masked_lstsq_beta(phi, continuation, w, psum_group)
        exercise = itm & (payoff_t > phi @ beta)
        if exercise_mask is not None:
            exercise = exercise & exercise_mask[t]
        tau = torch.where(exercise, float(t), tau)
        value = torch.where(exercise, payoff_t, value)
        betas.append(beta)
        if barrier:
            fsurv = torch.where(exercise, 1.0, fsurv_cont)
            rleg = torch.where(exercise, 0.0, rleg_cont)
        elif barrier_eval is not None:
            h_scaled, intrinsic_h = barrier_eval
            # a second regression of the same targets, localized at the
            # barrier (the policy fit is in-the-money only, so at an
            # out-of-the-money barrier it would extrapolate), on powers of
            # u = log(S/H)/hw: well conditioned, and its value at H is β[0]
            lx = torch.log(s_t / (h_scaled * strike_scale))
            hw = torch.clamp(0.5 * torch.std(lx, correction=0), min=0.05)
            u = lx / hw
            w_h = torch.exp(-0.5 * u * u)
            if vols is None:
                cont_h = _masked_lstsq_beta(_poly_basis(u, degree), continuation, w_h,
                                            psum_group)[0]
            else:
                beta_h = _masked_lstsq_beta(_joint_basis(u, vols[t], degree), continuation, w_h,
                                            psum_group)
                cont_h = _joint_basis(torch.zeros_like(u), vols[t], degree) @ beta_h
            # the live option exercises at exercise dates only
            exercised_h = torch.maximum(intrinsic_h, cont_h)
            ys.append(exercised_h if exercise_mask is None
                      else torch.where(exercise_mask[t], exercised_h, cont_h))
    if barrier:
        return tau, value, fsurv, rleg
    if barrier_eval is not None:
        return tau, value, (torch.stack(ys) if ys else torch.zeros((0,), dtype=torch.float64,
                                                                  device=dev))
    if collect_betas:
        return tau, value, torch.stack(betas)
    return tau, value


def device_payoff(payoff, device):
    """``payoff`` with its strike a float64 tensor on ``device``: its
    intrinsic value then copies nothing to the card (a copy of a host
    number waits for the card's queue)."""
    return dataclasses.replace(payoff, strike=f64(payoff.strike, device=device))


def _lsm_setup(prob: PricingProblem, method: LSM):
    """(log of the single-step discount, the strike as the regressors'
    scale), after the exercise-style guards."""
    payoff = prob.payoff
    if not isinstance(payoff.exercise_style, (American, Bermudan)):
        raise TypeError(
            "LSM prices American/Bermudan options (lsm.jl solve signature :99-102; "
            "Bermudan is a beyond-reference extension)."
        )
    if isinstance(payoff, AsianOption):
        raise TypeError(
            "LSM's stopping state carries no running-average state; American "
            "Asian pricing is unsupported"
        )
    if isinstance(payoff, LookbackOption):
        raise TypeError(
            "LSM's stopping state carries no running-extremum state; "
            "American lookback pricing is unsupported"
        )
    if isinstance(payoff, DoubleBarrierOption):
        raise TypeError(
            "barrier LSM carries the single-barrier survival state only; "
            "American double-barrier pricing is unsupported"
        )
    if not isinstance(payoff, (VanillaOption, BarrierOption)):
        raise TypeError(f"the port's LSM has no induction for {type(payoff).__name__}")
    device = resolve_device(method.mc_method.device)
    market = prob.market_inputs
    T = market_yearfrac(market, payoff.expiry)
    # the single-step discount in year fractions (lsm.jl:110)
    disc = df_yf(market.rate, T / method.mc_method.config.steps).to(device)
    return torch.log(disc), f64(payoff.strike, device=device)


def _is_conditional(mc_method) -> bool:
    return isinstance(mc_method.strategy, HestonQE) and mc_method.strategy.conditional


def _flatten_grid(grid):
    """(g, times, paths) → (times, g·paths)."""
    n_groups, ntimes, npaths = grid.shape
    return torch.movedim(grid, 0, 1).reshape(ntimes, n_groups * npaths)


def rb_terminal_value(prob: PricingProblem, spots, vols):
    """E[payoff(S_T) | S_{n−1}, V path] on a conditional (S, V) grid: over
    the last step S_T is lognormal with forward S_{n−1}·e^{r0Δ + ρJ − ρ²IV/2}
    and log-variance (1 − ρ²)·IV (the bridge of
    ``simulate_conditional_grid``), closed by the conditional Black-Scholes
    formula."""
    from .heston_exact_mixing import conditional_payoff_close

    market, T, r0 = sim_params(prob)
    dev = spots.device
    nsteps = spots.shape[0] - 1
    dt = T / nsteps
    kappa, theta, sigma, rho, r0 = (f64(x, device=dev) for x in (
        market.kappa, market.theta, market.sigma, market.rho, r0))
    v_a, v_b = vols[nsteps - 1], vols[nsteps]
    iv = 0.5 * dt * (v_a + v_b)
    j = (v_b - v_a - kappa * theta * dt + kappa * iv) / sigma
    f_eff = spots[nsteps - 1] * torch.exp(r0 * dt + rho * j - 0.5 * rho**2 * iv)
    return conditional_payoff_close(prob.payoff, f_eff, (1.0 - rho**2) * iv)


def _exercise_mask(prob: PricingProblem, method: LSM):
    """None for American; the Bermudan step mask on the grid's device."""
    if not isinstance(prob.payoff.exercise_style, Bermudan):
        return None
    return bermudan_step_mask(prob.payoff.exercise_style, prob.market_inputs,
                              prob.payoff.expiry, method.mc_method.config.steps,
                              device=resolve_device(method.mc_method.device))


def _fit_grid(prob: PricingProblem, method: LSM, mc_method=None):
    """(spots, vols or None, terminal target or None) of ``mc_method``'s
    grid (default: the method's own), flattened to (steps + 1, paths)."""
    mc = method.mc_method if mc_method is None else mc_method
    if _is_conditional(mc):
        s_grid, v_grid = simulate_conditional_grid(prob, mc.config, device=mc.device)
        spots, vols = _flatten_grid(s_grid), _flatten_grid(v_grid)
        terminal = rb_terminal_value(prob, spots, vols) if method.rao_blackwell else None
        return spots, vols, terminal
    return _flatten_grid(simulate_price_grid(prob, mc)), None, None


@register_solver(LSM)
def _solve_lsm(prob: PricingProblem, method: LSM) -> LSMSolution:
    log_disc, strike_scale = _lsm_setup(prob, method)
    if isinstance(prob.payoff, BarrierOption):
        if isinstance(prob.payoff.knock, KnockIn):
            return _solve_lsm_knock_in(prob, method, log_disc, strike_scale)
        return _solve_lsm_knock_out(prob, method, log_disc, strike_scale)
    spots, vols, terminal = _fit_grid(prob, method)
    tau, value = lsm_backward_induction(
        spots, device_payoff(prob.payoff, spots.device), log_disc, method.degree, strike_scale, vols=vols,
        terminal_value=terminal, exercise_mask=_exercise_mask(prob, method))
    price = torch.mean(torch.exp(tau * log_disc) * value)
    return LSMSolution(prob, method, price, (tau, value), spots)


def _barrier_grid(prob: PricingProblem, method: LSM):
    """The guards of the barrier estimators, then the bridge grid flattened
    to (steps + 1, paths): ``(payoff on the device, spots, survival
    factors, segment midpoints, vols or None, spot grid, segment
    variances)``."""
    from .bridge_mc import barrier_grid_factors

    payoff = prob.payoff
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("barrier LSM monitors the spot; use Spot underlying")
    if torch.as_tensor(payoff.strike).ndim > 0 or torch.as_tensor(payoff.barrier).ndim > 0:
        raise TypeError(
            "barrier LSM prices one (strike, barrier) pair per solve; loop "
            "over contracts for grids"
        )
    spot_grid, factors, t_mids, v_grid, seg_vars = barrier_grid_factors(prob, method.mc_method)
    nsteps = factors.shape[0]
    spots = spot_grid.reshape(nsteps + 1, -1)  # (steps + 1, g·paths)
    surv = factors.reshape(nsteps, -1)
    vols = _flatten_grid(v_grid) if v_grid is not None else None
    return (device_payoff(payoff, spots.device), spots, surv, t_mids, vols, spot_grid,
            seg_vars)


def _first_hit(surv):
    """(past survival (steps + 1, paths), P(first hit in segment k) (steps,
    paths)) from the per-segment no-cross factors."""
    past = torch.cat([torch.ones_like(surv[:1]), torch.cumprod(surv, dim=0)])
    return past, past[:-1] * (1.0 - surv)


def _solve_lsm_knock_in(prob: PricingProblem, method: LSM, log_disc,
                        strike_scale) -> LSMSolution:
    """American/Bermudan knock-in LSM, the hit-time estimator on a simulated
    grid (under Heston the live option's value at the hit depends on
    (τ, V_τ), which a lattice cannot carry).  By the strong Markov property

        KI = E[Σ_k 1{first hit ∈ seg k}·D(t_k)·V_live(t_k, H, V_k)] + R·D(T)·P(never hit),

    the first-hit-segment law per path from the bridge factors and
    V_live(t, H, v) the vanilla induction's continuation fitted at the
    barrier (``barrier_eval``).  On Heston grids the never-hit survival of
    the rebate leg takes the Richardson pair with the every-second-node
    pass of the same grid.  Already beyond the barrier at inception, the
    contract is the live option: the same induction's vanilla price."""
    from .bridge_mc import (
        _RICH_W,
        _coarse_bridge_inputs,
        _richardson_applies,
        brownian_bridge_survival_factors,
    )

    market = prob.market_inputs
    payoff, spots, surv, t_mids, vols, spot_grid, seg_vars = _barrier_grid(prob, method)
    dev = spots.device
    barrier = f64(payoff.barrier, device=dev)
    up = isinstance(payoff.direction, Up)
    mc_cfg = method.mc_method.config
    surv_T_coarse = None
    if _richardson_applies(method.mc_method.dynamics, mc_cfg.steps):
        _, T, _ = sim_params(prob)
        lg2, sv2, _ = _coarse_bridge_inputs(torch.log(spot_grid), seg_vars, T, mc_cfg.steps)
        f2 = brownian_bridge_survival_factors(lg2, sv2, torch.log(barrier), up)
        surv_T_coarse = torch.prod(f2, dim=0).reshape(-1)

    intrinsic_h = payoff(barrier)
    tau, value, ys_rev = lsm_backward_induction(
        spots, payoff, log_disc, method.degree, strike_scale, vols=vols,
        exercise_mask=_exercise_mask(prob, method),
        barrier_eval=(barrier / strike_scale, intrinsic_h))
    # V_live(t_k, H[, V_k]) for k = 0..steps: t = 0 reuses t = 1's fit (the
    # induction excludes t = 0), the terminal hit is the intrinsic at H
    ys = torch.flip(ys_rev, dims=(0,))  # t = 1..steps − 1
    y_full = torch.cat([ys[:1], ys, torch.full_like(ys[:1], 0.0) + intrinsic_h], dim=0)
    v_mid = 0.5 * (y_full[:-1] + y_full[1:])  # the segment midpoints' value
    if v_mid.ndim == 1:
        v_mid = v_mid[:, None]  # against the path axis

    past, first_hit = _first_hit(surv)
    d_mid = df_yf(market.rate, t_mids).to(dev)
    knocked_leg = torch.mean(torch.sum(d_mid[:, None] * first_hit * v_mid, dim=0))
    surv_T = past[-1]
    if surv_T_coarse is not None:
        surv_T = _RICH_W * surv_T - (_RICH_W - 1.0) * surv_T_coarse
    D_T = df(market.rate, payoff.expiry).to(dev)
    rebate_leg = f64(payoff.rebate, device=dev) * D_T * torch.mean(surv_T)
    spot = f64(market.spot, device=dev)
    knocked_root = (spot >= barrier) if up else (spot <= barrier)
    vanilla_price = torch.mean(torch.exp(tau * log_disc) * value)
    price = torch.where(knocked_root, vanilla_price, knocked_leg + rebate_leg)
    return LSMSolution(prob, method, price, (tau, value), spots)


def _solve_lsm_knock_out(prob: PricingProblem, method: LSM, log_disc,
                         strike_scale) -> LSMSolution:
    """American/Bermudan knock-out LSM: the stopping induction over the
    bridge grid with the per-segment no-cross factors in the stopping state
    (``lsm_backward_induction``'s ``surv_factors``).  A path contributes
    A_τ·disc^τ·intrinsic(S_τ), A_τ = Π_{s<τ} q_s = q_0·fsurv the survival to
    exercise, plus the rebate, paid only when the barrier is hit before
    exercise: at the hit (Σ_{k<τ} P(first hit in k)·D(t_mid_k)·R) or at
    expiry (R·D(T)·(1 − A_τ)); an American holder at the hit takes the
    better of the intrinsic at H and the rebate."""
    market = prob.market_inputs
    payoff, spots, surv, t_mids, vols, _, _ = _barrier_grid(prob, method)
    dev = spots.device
    ex_mask = _exercise_mask(prob, method)
    # exercise at first passage: continuous (American) exercise only
    hit_ex = (payoff(f64(payoff.barrier, device=dev))
              if ex_mask is None and isinstance(payoff.exercise_style, American) else None)
    rebate = f64(payoff.rebate, device=dev)
    tau, value, fsurv, _ = lsm_backward_induction(
        spots, payoff, log_disc, method.degree, strike_scale, vols=vols, surv_factors=surv,
        rebate_spec=(rebate, payoff.rebate_at_hit), exercise_mask=ex_mask,
        hit_exercise_value=hit_ex)
    a_tau = surv[0] * fsurv  # Π_{s<τ} q_s: the t = 0 segment's factor is ours
    price = torch.mean(a_tau * torch.exp(tau * log_disc) * value)
    nsteps = surv.shape[0]
    D_T = df(market.rate, payoff.expiry).to(dev)
    k = torch.arange(nsteps, dtype=torch.float64, device=dev)
    before_tau = (k[:, None] < tau[None, :]).to(torch.float64)
    _, first_hit = _first_hit(surv)
    d_mid = df_yf(market.rate, t_mids).to(dev)
    if payoff.rebate_at_hit:
        # without a first-passage right (Bermudan) the hit pays the rebate as
        # it stands: a max against a phantom 0 intrinsic would clamp a
        # negative rebate
        hit_pay = d_mid * (rebate if hit_ex is None else torch.maximum(hit_ex, rebate))
        leg = torch.mean(torch.sum(hit_pay[:, None] * first_hit * before_tau, dim=0))
    elif hit_ex is not None:
        # at the hit the holder exercises intrinsic(H) now or holds for the
        # rebate at expiry
        hit_pay = torch.maximum(hit_ex * d_mid, rebate * D_T)
        leg = torch.mean(torch.sum(hit_pay[:, None] * first_hit * before_tau, dim=0))
    else:
        leg = rebate * D_T * torch.mean(1.0 - a_tau)
    return LSMSolution(prob, method, price + leg, (tau, value), spots)
