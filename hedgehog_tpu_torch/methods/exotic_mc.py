"""Grid Monte Carlo for the path-dependent payoffs that need no bridge:
Asians, variance swaps, forward starts, cliquets, and the two-date
contracts (compound and chooser).

Port of ``_solve_asian_mc``, ``heston_variance_swap_strike``,
``_solve_variance_swap_mc``, ``_solve_forward_start_mc``,
``_solve_cliquet_mc`` and ``_solve_two_date_mc`` from
``hedgehog_tpu/methods/montecarlo.py``.  Each simulates a price grid
(``simulate_price_grid``) on the method's device under any grid dynamics
and reads its fixings off it; ``config.steps`` must put the fixing dates
on the grid.  The two-date contracts draw the decision-date spot exactly
and close with the inner Black-Scholes value.
"""

from __future__ import annotations

import torch

from ..core.dates import yearfrac
from ..core.payoffs import CompoundOption, GeometricAverage, require_european
from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df
from ..market.vol_surface import FlatVolSurface
from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..models.dynamics import LognormalDynamics, NormalDynamics
from ..ops.gbm_kernel import gbm_normals
from ..utils import device_of, f64, resolve_device
from .black_scholes import bs_price
from .montecarlo import (
    Antithetic,
    MonteCarloSolution,
    _require_no_dividend_schedule,
    simulate_price_grid,
)

__all__ = ["heston_variance_swap_strike"]


def _discount(prob, device):
    return f64(df(prob.market_inputs.rate, prob.payoff.expiry), device=device)


def _solve_asian_mc(prob, method):
    """Asian Monte Carlo: the price grid under any grid strategy, the mean
    (arithmetic or geometric) of the fixings S_{t_1..t_n} = grid[1:], the
    vanilla intrinsic of it; ``config.steps == observations``."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    config = method.config
    if config.steps != payoff.observations:
        raise ValueError(
            f"Asian MC needs config.steps == observations so grid times are "
            f"the fixing dates; got steps={config.steps}, "
            f"observations={payoff.observations}"
        )
    if torch.as_tensor(payoff.strike).ndim > 0:
        raise TypeError("Asian MC prices one strike per solve; vmap for grids")
    if isinstance(payoff.averaging, GeometricAverage) and isinstance(method.dynamics,
                                                                     NormalDynamics):
        raise TypeError(
            "geometric averaging is undefined under NormalDynamics "
            "(Bachelier paths can go negative); use ArithmeticAverage"
        )
    discount = _discount(prob, resolve_device(method.device))
    obs = simulate_price_grid(prob, method)[:, 1:, :]  # (g, steps, paths)
    if isinstance(payoff.averaging, GeometricAverage):
        avg = torch.exp(torch.mean(torch.log(obs), dim=1))
    else:
        avg = torch.mean(obs, dim=1)
    vals = payoff(avg)
    price = discount * torch.mean(vals, dim=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def heston_variance_swap_strike(market, T) -> torch.Tensor:
    """The continuously sampled Heston fair variance
    E[(1/T)∫₀ᵀ V dt] = θ + (V0 − θ)(1 − e^{−κT})/(κT), the oracle of the
    discretely sampled Monte Carlo (which carries an O(dt) correction)."""
    dev = device_of(market.kappa, market.theta, market.V0, T)
    kappa, theta, v0, T = (f64(x, device=dev) for x in (market.kappa, market.theta,
                                                        market.V0, T))
    kT = kappa * T
    return theta + (v0 - theta) * -torch.expm1(-kT) / kT


def _solve_variance_swap_mc(prob, method):
    """Variance-swap Monte Carlo: the price grid under any grid dynamics,
    RV = Σ ln(S_i/S_{i-1})²/T over it, notional·(RV − K_var);
    ``config.steps == observations``."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    _require_no_dividend_schedule(
        prob.market_inputs, "realized-variance legs (standard variance "
        "swaps EXCLUDE ex-date drops from the return sum)"
    )
    config = method.config
    if config.steps != payoff.observations:
        raise ValueError(
            f"variance-swap MC needs config.steps == observations so grid "
            f"times are the fixing dates; got steps={config.steps}, "
            f"observations={payoff.observations}"
        )
    discount = _discount(prob, resolve_device(method.device))
    T = market_yearfrac(prob.market_inputs, payoff.expiry)
    lr = torch.diff(torch.log(simulate_price_grid(prob, method)), dim=1)
    vals = payoff(torch.sum(lr * lr, dim=1) / T)  # (g, paths)
    price = discount * torch.mean(vals, dim=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_forward_start_mc(prob, method):
    """Forward-start Monte Carlo: the price grid under any grid dynamics,
    the fixing S_{t_start} read off it (``start`` must fall on a grid
    time), max(cp·(S_T − k·S_fix), 0)."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    market = prob.market_inputs
    _require_no_dividend_schedule(
        market, "forward-start strikes (k·S_fix across an ex-date is a term-sheet convention)"
    )
    config = method.config
    T = market_yearfrac(market, payoff.expiry)
    t1 = yearfrac(market.reference_date, payoff.start, getattr(market, "daycount", None))
    frac = float(t1) / float(T) * config.steps
    idx = round(frac)
    if abs(frac - idx) > 1e-9 or not (0 < idx < config.steps):
        raise ValueError(
            f"forward-start MC needs the start date on the step grid: "
            f"t_start/T·steps = {frac:.6f} is not an interior integer — "
            f"choose config.steps as a multiple of T/(T − t_start) structure"
        )
    discount = _discount(prob, resolve_device(method.device))
    grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
    vals = payoff(grid[:, idx], grid[:, -1])
    price = discount * torch.mean(vals, dim=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_cliquet_mc(prob, method):
    """Cliquet Monte Carlo: the price grid under any grid dynamics, the
    period returns S_i/S_{i-1} − 1, the clipped sum at expiry;
    ``config.steps == observations``."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    _require_no_dividend_schedule(
        prob.market_inputs, "cliquet returns (ex-date drops would enter "
        "the return legs; dividend treatment is a term-sheet convention)"
    )
    config = method.config
    if config.steps != payoff.observations:
        raise ValueError(
            f"cliquet MC needs config.steps == observations so grid times "
            f"are the reset dates; got steps={config.steps}, "
            f"observations={payoff.observations}"
        )
    discount = _discount(prob, resolve_device(method.device))
    grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
    rets = grid[:, 1:] / grid[:, :-1] - 1.0  # (g, steps, paths)
    vals = payoff(torch.movedim(rets, 1, -1))  # periods last → (g, paths)
    price = discount * torch.mean(vals, dim=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_two_date_mc(prob, method):
    """Compound and chooser Monte Carlo: S_{t₁} from the exact lognormal
    law (the curve forward and the carry), closed with the inner
    Black-Scholes value at the decision date and discounted at D(t₁);
    lognormal dynamics under a flat vol only."""
    payoff = prob.payoff
    market = prob.market_inputs
    config = method.config
    if not isinstance(method.dynamics, LognormalDynamics):
        raise TypeError(
            "compound/chooser MC closes with the inner Black-Scholes value; "
            "use LognormalDynamics"
        )
    if not isinstance(market.sigma, FlatVolSurface):
        raise TypeError("compound/chooser MC needs a flat vol (one σ both legs)")
    device = resolve_device(method.device)
    sigma, q, spot = (f64(x, device=device) for x in (market.sigma.sigma, carry_yield(market),
                                                      market.spot))
    is_compound = isinstance(payoff, CompoundOption)
    t1_ticks = payoff.decision_date if is_compound else payoff.choose_date
    t1 = f64(market_yearfrac(market, t1_ticks), device=device)
    T2 = f64(market_yearfrac(market, payoff.expiry), device=device)
    D1 = f64(df(market.rate, t1_ticks), device=device)
    D2 = f64(df(market.rate, payoff.expiry), device=device)
    D12, tau = D2 / D1, T2 - t1

    paths = config.trajectories
    if config.qmc:
        z = torch.special.ndtri(sobol_uniforms(prng_key(config.seed), paths, 1,
                                               device=device)[:, 0])
    else:
        z = gbm_normals(paths, config.seed, 0, device, torch.float64)
    z = torch.stack([z, -z]) if isinstance(config.variance_reduction, Antithetic) else z[None]
    f1 = spot * torch.exp(-q * t1) / D1  # the exact t₁-forward
    s_t1 = f1 * torch.exp(-0.5 * sigma**2 * t1 + sigma * torch.sqrt(t1) * z)

    fwd_inner = s_t1 * torch.exp(-q * tau) / D12
    if is_compound:
        inner = bs_price(fwd_inner, f64(payoff.inner_strike, device=device), sigma, tau, D12,
                         payoff.inner_call_put())
        vals = payoff.decision_value(inner)
    else:
        strike = f64(payoff.strike, device=device)
        vals = torch.maximum(bs_price(fwd_inner, strike, sigma, tau, D12, 1.0),
                             bs_price(fwd_inner, strike, sigma, tau, D12, -1.0))
    price = D1 * torch.mean(vals)
    return MonteCarloSolution(prob, method, price, vals)
