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

The barrier and knock-in estimators (``surv_factors``, ``rebate_spec``,
``barrier_eval``, ``hit_exercise_value``) wait for the path-dependent
payoffs, and the sharded regression (``psum_axis``) for the port's
sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.payoffs import American, Bermudan, VanillaOption, bermudan_step_mask
from ..core.problems import LSMSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import market_yearfrac
from ..market.rate_curve import df_yf
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


def _masked_lstsq_beta(phi, y, w):
    """β of the fit y ~ phi·β over the rows where w = 1: weighted normal
    equations with a ridge of 1e-10·(1 + tr(A)/n), so a system with no
    in-the-money path stays solvable (its fit is masked out downstream)."""
    n_terms = phi.shape[1]
    phw = phi * w[:, None]
    A = phw.T @ phi
    b = phw.T @ y
    eye = torch.eye(n_terms, dtype=A.dtype, device=A.device)
    ridge = 1e-10 * eye * (1.0 + torch.trace(A) / n_terms)
    return cholesky_solve_small(A + ridge, b)


def _poly_basis(x, degree: int):
    """(paths, degree + 1) monomials, the reference's Polynomials.fit
    regressors (least_squares_montecarlo.jl:126)."""
    powers = torch.arange(degree + 1, device=x.device)
    return x[:, None] ** powers[None, :]


def _joint_basis(s, v, degree: int):
    """Bivariate monomials s^i·v^j with i + j ≤ degree."""
    terms = [s**i * v**j for i in range(degree + 1) for j in range(degree + 1 - i)]
    return torch.stack(terms, dim=1)


def lsm_backward_induction(spots, payoff, log_disc, degree: int, strike_scale, *, vols=None,
                           terminal_value=None, exercise_mask=None,
                           collect_betas: bool = False):
    """Backward stopping-rule induction over a (steps + 1, paths) price grid:
    returns (tau, value) per path, tau as float64.  ``vols`` (a matching
    variance grid) regresses on the joint (S, V) basis; ``terminal_value``
    replaces the terminal payoff as the initial stopping value;
    ``exercise_mask`` (steps,) bool gates exercise per grid date (None:
    every date); ``collect_betas`` also returns the per-step coefficients
    stacked in induction order t = steps − 1 … 1, the frozen policy the
    dual bound replays."""
    nsteps = spots.shape[0] - 1
    tau = torch.full((spots.shape[1],), float(nsteps), dtype=torch.float64, device=spots.device)
    value = payoff(spots[nsteps]) if terminal_value is None else terminal_value
    betas = []
    for t in range(nsteps - 1, 0, -1):  # t = 0 excluded (lsm.jl:114)
        s_t = spots[t]
        continuation = torch.exp((tau - t) * log_disc) * value
        payoff_t = payoff(s_t)
        itm = payoff_t > 0.0
        if vols is None:
            phi = _poly_basis(s_t / strike_scale, degree)
        else:
            phi = _joint_basis(s_t / strike_scale, vols[t], degree)
        beta = _masked_lstsq_beta(phi, continuation, itm.to(torch.float64))
        exercise = itm & (payoff_t > phi @ beta)
        if exercise_mask is not None:
            exercise = exercise & exercise_mask[t]
        tau = torch.where(exercise, float(t), tau)
        value = torch.where(exercise, payoff_t, value)
        betas.append(beta)
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
    if not isinstance(payoff, VanillaOption):
        raise TypeError(
            f"the port's LSM prices vanilla options; {type(payoff).__name__} needs the "
            "barrier and knock-in LSM estimators, which are not ported yet"
        )
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
    spots, vols, terminal = _fit_grid(prob, method)
    tau, value = lsm_backward_induction(
        spots, device_payoff(prob.payoff, spots.device), log_disc, method.degree, strike_scale, vols=vols,
        terminal_value=terminal, exercise_mask=_exercise_mask(prob, method))
    price = torch.mean(torch.exp(tau * log_disc) * value)
    return LSMSolution(prob, method, price, (tau, value), spots)
