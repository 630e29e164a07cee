"""Hull-White pricing: curve-fitted closed forms, exact short-rate Monte
Carlo, and the x-grid backward induction for Bermudan swaptions.

Port of ``hedgehog_tpu/methods/hull_white.py`` (the math is in
models/hull_white.py).  ``solve(problem, method)`` covers:

    ZeroCouponBond  — the curve df (the fit identity; Monte Carlo: the mean
                      pathwise discount)
    BondOption      — the lognormal ZCB-option closed form (σ_p), with the
                      σ_p → 0 intrinsic behind a double ``torch.where``
    Caplet/floorlet — scaled bond put/call; CapFloor the sum of its caplets
    Swaption        — Jamshidian: the critical state x* from the
                      implicit-function-theorem root on [−3, 3], then a sum
                      of bond options (autograd flows through x*)
    HullWhiteMonteCarlo — exact (x, ∫x) joint transitions at any step count
                      with the pathwise stochastic discount; Bermudan
                      swaptions by Longstaff–Schwartz on exact states at the
                      exercise dates
    HullWhiteGrid   — a dense (nodes × nodes) discounted transition matrix
                      per exercise gap, applied by ``torch.matmul``

Every method computes on its ``device`` (the GPU unless the caller asks for
the CPU); market fields that are tensors keep their autograd history, so
rate vega, mean-reversion greeks and key-rate durations
(``ZeroRateSpineLens``) run through the lenses.

Draws.  Under QMC the Monte Carlo takes the JAX package's points,
``_qmc_normals(base, steps, 2, paths)`` of the unsplit base key: Sobol' dims
2s (z₁ of step s) and 2s + 1 (z₂) by the exact inverse normal CDF, so every
path equals JAX's.  Under PRNG, Philox (key (seed, device_id), counter
(pair & 0xffffffff, pair >> 32, block, tag)): block s under ``HW_TAG``,
Box–Muller of words 0, 1 → (z₁, z₂) of step s; the Bermudan LSM block j
under ``HW_BERMUDAN_TAG`` for exercise gap j.  The antithetic twin negates
the normals.  JAX draws ``jax.random.normal`` there, which the port does not
replay: the two agree in law, and ``hw_bermudan_lsm`` takes given normals.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.dates import yearfrac
from ..core.payoffs import BondOption, CapFloor, Caplet, European, Swaption, ZeroCouponBond
from ..core.problems import AnalyticSolution, MonteCarloSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import HullWhiteInputs, market_yearfrac
from ..market.rate_curve import df_yf, spine_zeros
from ..math.linalg import cholesky_solve_small
from ..math.rootfind import implicit_root
from ..models.hull_white import hw_b, hw_bond, hw_gamma, hw_sigma_p, hw_step_moments
from ..utils import device_of, f64, resolve_device
from .montecarlo import Antithetic, SimulationConfig
from .normal_lv_mc import _draws, _paired, _relu

__all__ = [
    "HullWhiteAnalytic",
    "HullWhiteMonteCarlo",
    "HullWhiteGrid",
    "hw_zbo_price",
    "hw_paths",
    "hw_exercise_paths",
    "hw_bermudan_lsm",
]

_frozen = dataclasses.dataclass(frozen=True)
#: Philox counter tags (the counter's last word) of the Hull-White streams
HW_TAG = 0x68772020  # "hw  "
HW_BERMUDAN_TAG = 0x68776265  # "hwbe"

_IR_PAYOFFS = (ZeroCouponBond, BondOption, Caplet, CapFloor, Swaption)


@_frozen
class HullWhiteAnalytic(AbstractPricingMethod):
    """Closed forms for the interest-rate payoffs on :class:`HullWhiteInputs`
    markets, computed on ``device``."""

    device: str = "cuda"


@_frozen
class HullWhiteMonteCarlo(AbstractPricingMethod):
    """Exact-transition short-rate Monte Carlo on ``device``: (x, ∫x) drawn
    jointly from the OU transition law per step (no discretization error at
    any ``config.steps``), the stochastic discount exp(−∫r) carried per
    path; ``config.qmc`` draws the (2 × steps)-dimensional Sobol' stream."""

    config: SimulationConfig = SimulationConfig()
    device: str = "cuda"


@_frozen
class HullWhiteGrid(AbstractPricingMethod):
    """Dense x-grid backward induction for (Bermudan) swaptions: the OU
    transition density and the bank-account weight E[e^{−∫x} | x, x'] are
    closed form over any gap, so the discounted operator between two
    exercise dates is one (nodes × nodes) matrix.  ``nodes`` trapezoid
    points over ``width`` stationary standard deviations."""

    nodes: int = 257
    width: float = 7.0
    device: str = "cuda"


def _yf(market, ticks) -> float:
    return market_yearfrac(market, ticks)


def _df(market, t, device) -> torch.Tensor:
    """P(0, t) for a year fraction or a list of them, on ``device``."""
    curve_dev = device_of(spine_zeros(market.rate))
    return df_yf(market.rate, f64(t, device=curve_dev)).to(device)


def _params(market, device):
    return f64(market.a, device=device), f64(market.sigma, device=device)


def hw_zbo_price(market, t_exp, t_bond, strike, cp, device=None) -> torch.Tensor:
    """ZCB-option closed form: cp = +1 call / −1 put on P(T, S) struck at
    ``strike``, exercising at T = t_exp (year fractions).  σ_p → 0 (or
    T → 0) gives the discounted intrinsic, branch-free (and with finite
    gradients: the dead branch sees σ_p = 1).  On ``device``, else on the
    device of the market's tensors."""
    if device is None:
        device = device_of(market.a, market.sigma, t_bond, strike)
    a, sig = _params(market, device)
    p_t = _df(market, t_exp, device)
    p_s = _df(market, t_bond, device)
    strike, cp = f64(strike, device=device), f64(cp, device=device)
    sp = hw_sigma_p(a, sig, f64(t_exp, device=device), f64(t_bond, device=device))
    ok = sp > 1e-14
    sp_safe = torch.where(ok, sp, 1.0)
    h = torch.log(p_s / (strike * p_t)) / sp_safe + 0.5 * sp_safe
    ncdf = torch.special.ndtr
    live = cp * (p_s * ncdf(cp * h) - strike * p_t * ncdf(cp * (h - sp_safe)))
    intrinsic = _relu(cp * (p_s - strike * p_t))
    return torch.where(ok, live, intrinsic)


def _caplet_as_zbo(market, payoff: Caplet, device):
    """(t_exp, t_end, bond strike K', scale): caplet = scale·ZBP(T, S, K'),
    floorlet = scale·ZBC."""
    tau = yearfrac(payoff.start, payoff.end, market.daycount)
    x = f64(payoff.strike_rate, device=device)
    k_bond = 1.0 / (1.0 + x * tau)
    scale = f64(payoff.notional, device=device) * (1.0 + x * tau)
    return _yf(market, payoff.start), _yf(market, payoff.end), k_bond, scale


def _require_european_swaption(payoff, name):
    if isinstance(payoff, Swaption) and not isinstance(payoff.exercise_style, European):
        raise TypeError(
            f"{name} prices European swaptions; Bermudan exercise prices on "
            "HullWhiteGrid (the x-grid backward induction)"
        )


def _coupons(strike_rate, taus: list, device) -> torch.Tensor:
    """c_i = X·τ_i, plus the principal 1 at the last payment."""
    last = torch.zeros(len(taus), dtype=torch.float64, device=device)
    last[-1] = 1.0
    return f64(strike_rate, device=device) * f64(taus, device=device) + last


def _swap_legs(market, payoff: Swaption, device):
    """(t_exp, payment yfs (n,), coupons c_i (n,)): the fixed+principal leg
    Σ c_i·P(T, t_i) the payer swaption puts against par."""
    t_exp = _yf(market, payoff.expiry)
    times = [_yf(market, d) for d in payoff.payment_dates]
    taus = [t - p for t, p in zip(times, [t_exp] + times[:-1])]
    return t_exp, f64(times, device=device), _coupons(payoff.strike_rate, taus, device)


def _jamshidian_strikes(market, t_exp, times, c, device):
    """Critical x* with Σ c_i·P̂(T, t_i; x*) = 1 (P̂ decreases in x) by the
    differentiable bracketed root, and the per-payment strikes
    K_i = P̂(T, t_i; x*)."""
    a, sig = _params(market, device)
    p_t = _df(market, t_exp, device)
    p_i = _df(market, times, device)

    def bond_at(x):
        return hw_bond(p_t, p_i, a, sig, t_exp, times, x)

    x_star = implicit_root(lambda x: torch.sum(c * bond_at(x)) - 1.0, -3.0, 3.0)
    return bond_at(x_star)


def _require_hw(market, payoff, name):
    if not isinstance(market, HullWhiteInputs):
        raise TypeError(f"{name} prices on HullWhiteInputs markets; got "
                        f"{type(market).__name__}")
    if not isinstance(payoff, _IR_PAYOFFS):
        raise TypeError(
            f"{name} prices the interest-rate payoff family "
            f"(ZeroCouponBond/BondOption/Caplet/Swaption); got "
            f"{type(payoff).__name__}"
        )


@register_solver(HullWhiteAnalytic)
def _solve_hw_analytic(prob: PricingProblem, method: HullWhiteAnalytic) -> AnalyticSolution:
    payoff, market = prob.payoff, prob.market_inputs
    _require_hw(market, payoff, "HullWhiteAnalytic")
    device = resolve_device(method.device)
    if isinstance(payoff, ZeroCouponBond):
        price = _df(market, _yf(market, payoff.maturity), device)
    elif isinstance(payoff, BondOption):
        price = hw_zbo_price(market, _yf(market, payoff.expiry),
                             _yf(market, payoff.bond_maturity), payoff.strike,
                             payoff.call_put(), device=device)
    elif isinstance(payoff, Caplet):
        t_exp, t_end, k_bond, scale = _caplet_as_zbo(market, payoff, device)
        cp_bond = -payoff.call_put()  # caplet = bond put, floorlet = bond call
        price = scale * hw_zbo_price(market, t_exp, t_end, k_bond, cp_bond, device=device)
    elif isinstance(payoff, CapFloor):
        price = sum(_solve_hw_analytic(dataclasses.replace(prob, payoff=c), method).price
                    for c in payoff.caplets())
    else:  # Swaption
        _require_european_swaption(payoff, "HullWhiteAnalytic")
        t_exp, times, c = _swap_legs(market, payoff, device)
        strikes = _jamshidian_strikes(market, t_exp, times, c, device)
        cp_bond = -1.0 if payoff.payer else 1.0  # payer = basket of bond puts
        per_leg = hw_zbo_price(market, t_exp, times, strikes, cp_bond, device=device)
        price = f64(payoff.notional, device=device) * torch.sum(c * per_leg)
    return AnalyticSolution(prob, method, price)


def hw_paths(market, t_exp: float, config: SimulationConfig, key=None, device_id=0, *,
             device):
    """Exact (x_T, ∫₀ᵀ x) per path, (n_groups, paths) each: ``config.steps``
    exact joint OU transitions."""
    a, sig = _params(market, device)
    e1, b_dt, s_x, coef, s_res = hw_step_moments(a, sig, t_exp / config.steps)
    z = _draws(config, key, device_id, 0, device, tag=HW_TAG, comps=2)  # (2, g, steps, P)
    x = torch.zeros((z.shape[1], z.shape[3]), dtype=torch.float64, device=device)
    integ = torch.zeros_like(x)
    for z1, z2 in z.permute(2, 0, 1, 3):
        x_new = x * e1 + s_x * z1
        integ = integ + (x * b_dt + coef * z1 + s_res * z2)
        x = x_new
    return x, integ


@register_solver(HullWhiteMonteCarlo)
def _solve_hw_mc(prob: PricingProblem, method: HullWhiteMonteCarlo) -> MonteCarloSolution:
    payoff, market = prob.payoff, prob.market_inputs
    _require_hw(market, payoff, "HullWhiteMonteCarlo")
    config = method.config
    device = resolve_device(method.device)
    if isinstance(payoff, CapFloor):
        # per-period seeds decorrelate the legs
        price = 0.0
        for i, c in enumerate(payoff.caplets()):
            leg = dataclasses.replace(method, config=dataclasses.replace(
                config, seed=config.seed + 7919 * i))
            price = price + _solve_hw_mc(dataclasses.replace(prob, payoff=c), leg).price
        return MonteCarloSolution(prob, method, price, None)
    a, sig = _params(market, device)
    if isinstance(payoff, ZeroCouponBond):
        t_exp = _yf(market, payoff.maturity)

        def terminal(x):
            return torch.ones_like(x)
    elif isinstance(payoff, BondOption):
        t_exp, t_bond = _yf(market, payoff.expiry), _yf(market, payoff.bond_maturity)
        cp = payoff.call_put()
        p_t, p_b = _df(market, t_exp, device), _df(market, t_bond, device)
        strike = f64(payoff.strike, device=device)

        def terminal(x):
            return _relu(cp * (hw_bond(p_t, p_b, a, sig, t_exp, t_bond, x) - strike))
    elif isinstance(payoff, Caplet):
        t_exp, t_end, k_bond, scale = _caplet_as_zbo(market, payoff, device)
        cp_bond = -payoff.call_put()
        p_t, p_e = _df(market, t_exp, device), _df(market, t_end, device)

        def terminal(x):
            return scale * _relu(cp_bond * (hw_bond(p_t, p_e, a, sig, t_exp, t_end, x) - k_bond))
    else:  # Swaption
        if not isinstance(payoff.exercise_style, European):
            return hw_bermudan_lsm(prob, method)
        t_exp, times, c = _swap_legs(market, payoff, device)
        p_t, p_i = _df(market, t_exp, device), _df(market, times, device)
        sign = 1.0 if payoff.payer else -1.0
        notional = f64(payoff.notional, device=device)

        def terminal(x):
            p = hw_bond(p_t, p_i[:, None, None], a, sig, t_exp, times[:, None, None], x)
            leg = torch.sum(c[:, None, None] * p, dim=0)
            return notional * _relu(sign * (1.0 - leg))

    if t_exp <= 0.0:
        # expiry on the reference date (a spot-start cap's first period):
        # the value is known, and the transition at dt = 0 would be 0/0
        x_T = torch.zeros((1, config.trajectories), dtype=torch.float64, device=device)
        x_int = torch.zeros_like(x_T)
    else:
        x_T, x_int = hw_paths(market, t_exp, config, device=device)
    # the pathwise stochastic discount: its mean is the curve df exactly
    disc = _df(market, t_exp, device) * torch.exp(-x_int - 0.5 * sig**2 * hw_gamma(a, t_exp))
    vals = disc * terminal(x_T)
    return MonteCarloSolution(prob, method, torch.mean(vals, dim=(0, -1)), vals)


def _hw_kernel(market, t_a: float, t_b: float, x_from, x_to, w_to, device) -> torch.Tensor:
    """The discounted transition operator between two dates on the x grid,
    K[i, j] = E[e^{−∫_{t_a}^{t_b} r} · 1{x_{t_b} ≈ x_j} | x_{t_a} = x_i]·w_j:
    the deterministic exp(−∫α) block × the exact OU density × E[e^{−∫x} |
    x_i, x_j] (lognormal in the conditional Gaussian of ∫x) × the trapezoid
    weight."""
    a, sig = _params(market, device)
    delta = t_b - t_a
    e1 = torch.exp(-a * delta)
    b = hw_b(a, delta)
    v_x = sig**2 * (1.0 - e1 * e1) / (2.0 * a)
    s_x = torch.sqrt(v_x)
    c = sig**2 * (1.0 - e1) ** 2 / (2.0 * a**2)
    beta = c / v_x
    v_res = _relu(sig**2 * hw_gamma(a, delta) - c * beta)
    det = (_df(market, t_b, device) / _df(market, t_a, device)
           * torch.exp(-0.5 * sig**2 * (hw_gamma(a, t_b) - hw_gamma(a, t_a))))
    diff = x_to[None, :] - x_from[:, None] * e1
    dens = torch.exp(-0.5 * (diff / s_x) ** 2) / (s_x * math.sqrt(2.0 * math.pi))
    mu_i_cond = x_from[:, None] * b + beta * diff
    return det * dens * torch.exp(-mu_i_cond + 0.5 * v_res) * w_to[None, :]


def _swap_intrinsic_on_grid(market, payoff: Swaption, e_j: float, x, device) -> torch.Tensor:
    """Exercise value at e_j (a year fraction) on the x states: the remaining
    swap's fixed+principal leg against par, co-terminal accruals from e_j."""
    a, sig = _params(market, device)
    sign = 1.0 if payoff.payer else -1.0
    times = [_yf(market, d) for d in payoff.payment_dates if _yf(market, d) > e_j + 1e-12]
    taus = [t - p for t, p in zip(times, [e_j] + times[:-1])]
    coup = _coupons(payoff.strike_rate, taus, device)
    t_arr = f64(times, device=device)
    p = hw_bond(_df(market, e_j, device), _df(market, times, device)[:, None], a, sig, e_j,
                t_arr[:, None], x[None, :])
    leg = torch.sum(coup[:, None] * p, dim=0)
    return f64(payoff.notional, device=device) * _relu(sign * (1.0 - leg))


@register_solver(HullWhiteGrid)
def _solve_hw_grid(prob: PricingProblem, method: HullWhiteGrid) -> AnalyticSolution:
    payoff, market = prob.payoff, prob.market_inputs
    _require_hw(market, payoff, "HullWhiteGrid")
    if not isinstance(payoff, Swaption):
        raise TypeError(
            "HullWhiteGrid prices (Bermudan) Swaptions; ZCBs/bond options/"
            "caplets price on HullWhiteAnalytic / HullWhiteMonteCarlo"
        )
    device = resolve_device(method.device)
    ex = [_yf(market, t) for t in payoff.exercise_ticks()]
    a, sig = _params(market, device)
    s_stat = sig * torch.sqrt((1.0 - torch.exp(-2.0 * a * ex[-1])) / (2.0 * a))
    n = method.nodes
    x = torch.linspace(-method.width, method.width, n, dtype=torch.float64,
                       device=device) * s_stat
    ends = torch.ones(n, dtype=torch.float64, device=device)
    ends[0] = ends[-1] = 0.5
    w_trap = (x[1] - x[0]) * ends
    value = _swap_intrinsic_on_grid(market, payoff, ex[-1], x, device)
    for j in range(len(ex) - 2, -1, -1):
        cont = _hw_kernel(market, ex[j], ex[j + 1], x, x, w_trap, device) @ value
        value = torch.maximum(_swap_intrinsic_on_grid(market, payoff, ex[j], x, device), cont)
    k0 = _hw_kernel(market, 0.0, ex[0], torch.zeros(1, dtype=torch.float64, device=device), x,
                    w_trap, device)
    return AnalyticSolution(prob, method, (k0 @ value)[0])


def hw_exercise_paths(market, ex_times: list, z: torch.Tensor, *, device):
    """Exact states at the exercise dates from the normals ``z``
    (m, 2, n_groups, paths): (x (m, g, P), disc (m, g, P)), disc the
    pathwise discount to 0, P(0, e_j)·exp(−∫x − ½σ²Γ(e_j)); one exact joint
    (x, ∫x) transition per exercise gap."""
    a, sig = _params(market, device)
    x = torch.zeros(z.shape[2:], dtype=torch.float64, device=device)
    integ = torch.zeros_like(x)
    xs, discs = [], []
    prev = 0.0
    for j, e_j in enumerate(ex_times):
        e1, b_dt, s_x, coef, s_res = hw_step_moments(a, sig, e_j - prev)
        d_i = x * b_dt + coef * z[j, 0] + s_res * z[j, 1]
        x = x * e1 + s_x * z[j, 0]
        integ = integ + d_i
        xs.append(x)
        discs.append(_df(market, e_j, device) * torch.exp(-integ - 0.5 * sig**2
                                                         * hw_gamma(a, e_j)))
        prev = e_j
    return torch.stack(xs), torch.stack(discs)


def hw_bermudan_lsm(prob: PricingProblem, method: HullWhiteMonteCarlo, degree: int = 4,
                    z=None) -> MonteCarloSolution:
    """Bermudan swaption by Longstaff–Schwartz under stochastic discounting,
    the cross-engine of :class:`HullWhiteGrid`.  The pathwise discount D_j
    is not a function of x_j alone, so the regression target is the forward
    value h_τ/D_j on an x-monomial basis over in-the-money paths; exercise
    where the intrinsic exceeds the fit (a lower bound in expectation).
    ``z`` (m, 2, paths) replaces the Philox normals (one row a gap; the
    antithetic twin negates them)."""
    payoff, market = prob.payoff, prob.market_inputs
    config = method.config
    device = resolve_device(method.device)
    ex_times = [_yf(market, t) for t in payoff.exercise_ticks()]
    m = len(ex_times)
    if z is None:  # Philox under qmc=True too: JAX draws its PRNG stream there
        z = _draws(dataclasses.replace(config, steps=m, qmc=False), None, 0, 0, device,
                   tag=HW_BERMUDAN_TAG, comps=2).permute(2, 0, 1, 3)
    else:
        anti = isinstance(config.variance_reduction, Antithetic)
        z = _paired(f64(z, device=device), anti).permute(1, 2, 0, 3)
    xs, discs = hw_exercise_paths(market, ex_times, z, device=device)
    shape = xs.shape[1:]
    intr = torch.stack([_swap_intrinsic_on_grid(market, payoff, ex_times[j],
                                                xs[j].reshape(-1), device).reshape(shape)
                        for j in range(m)])
    h = discs * intr  # exercise values discounted to 0
    value = h[m - 1]
    sig = f64(market.sigma, device=device)
    x_scale = torch.clamp(sig * math.sqrt(ex_times[-1]), min=1e-8)
    powers = torch.arange(degree + 1, dtype=torch.float64, device=device)
    eye = torch.eye(degree + 1, dtype=torch.float64, device=device)
    for j in range(m - 2, -1, -1):
        xj = (xs[j] / x_scale).reshape(-1)
        target = (value / torch.clamp(discs[j], min=1e-300)).reshape(-1)
        w = (intr[j] > 0.0).reshape(-1).to(torch.float64)
        phi = xj[:, None] ** powers[None, :]
        phw = phi * w[:, None]
        amat = phw.T @ phi
        bvec = phw.T @ target
        ridge = 1e-10 * eye * (1.0 + torch.trace(amat) / (degree + 1))
        beta = cholesky_solve_small(amat + ridge, bvec)
        fitted = (phi @ beta).reshape(shape)
        exercise = (intr[j] > 0.0) & (intr[j] > fitted)
        value = torch.where(exercise, h[j], value)
    return MonteCarloSolution(prob, method, torch.mean(value), value)
