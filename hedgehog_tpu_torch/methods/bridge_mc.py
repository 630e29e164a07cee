"""Brownian-bridge Monte Carlo for the path-dependent payoffs: single and
double barriers, lookbacks and autocallables.

Port of the bridge primitives and estimators of
``hedgehog_tpu/methods/montecarlo.py`` (``brownian_bridge_survival_factors``
… ``_solve_autocall_mc``).  A stepped grid whose path is Brownian in log
space within each segment carries the continuous monitoring: per-segment
no-cross factors 1 − exp(−2·d0·d1/σ²_k) for a barrier, the two-sided image
series for a corridor, and an exact inverse-CDF draw of each segment's
extremum for a lookback.  The grids: GBM log-Euler (σ²Δt, exact at any
step count) or one exact bridge over [0, T] (``BlackScholesExact``), the
conditional Heston QE grid (trapezoid ∫V), the exact Heston grid (sampled
∫V), the rough-Bergomi Euler grid (V_k·Δt) and, for barriers, the
Bachelier grid in price space (the T-forward is Brownian; the barrier maps
to H/c(t) at each grid time, σ_N²Δt).  On Heston grids the
barrier estimators combine the fine and the every-second-node pass of the
same grid by Richardson's weight 2^α/(2^α − 1), α = 0.75.

Every factor is smooth in the grid, so autograd through ``solve`` gives
pathwise greeks; the masked branches go through a double ``torch.where``
so that no overflowing exponent reaches a gradient.  Every tensor lives on
the method's device.  The lookback's extremum uniforms are a Philox stream
of their own (counter tag ``LOOK_TAG``) under PRNG and QMC alike: the JAX
package draws them from ``jax.random``, which the port does not replay, so
the lookback agrees with it in law.
"""

from __future__ import annotations

import torch

from ..core.payoffs import KnockOut, Up, require_european
from ..market.rate_curve import df, df_yf
from ..market.vol_surface import FlatVolSurface, get_vol
from ..math.counter_rng import uniform_from_bits
from ..models.dynamics import (
    HestonDynamics,
    LognormalDynamics,
    NormalDynamics,
    RoughBergomiDynamics,
)
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import philox_block
from ..utils import f64, resolve_device

__all__ = [
    "brownian_bridge_survival_factors",
    "brownian_bridge_survival",
    "brownian_bridge_extremum",
    "double_bridge_survival_factors",
    "barrier_grid_factors",
    "lookback_uniforms",
]

_MASK32 = 0xFFFFFFFF
#: Philox counter tag (last counter word) of the lookback's extremum uniforms: "look"
LOOK_TAG = 0x6C6F6F6B


def brownian_bridge_survival_factors(log_grid, seg_vars, log_barrier, up: bool):
    """Per-segment Brownian-bridge no-cross factors 1 − exp(−2·d0·d1/σ²_k),
    zero where either endpoint lies beyond the barrier, shape (steps, ...).

    ``log_grid``: (steps + 1, ...) coordinates in which the path is Brownian
    within segments; ``seg_vars``: (steps, ...) or a scalar;
    ``log_barrier`` a scalar or a per-grid-time (steps + 1,)-leading tensor."""
    x0, x1 = log_grid[:-1], log_grid[1:]
    b = torch.as_tensor(log_barrier, dtype=log_grid.dtype, device=log_grid.device)
    if b.ndim > 0 and b.shape[0] != log_grid.shape[0]:
        raise ValueError(
            f"a non-scalar barrier must carry the (steps+1,)-leading "
            f"per-grid-time axis (got shape {tuple(b.shape)} against a "
            f"{tuple(log_grid.shape)} grid); broadcast-style barriers are "
            f"ambiguous with the time-varying form"
        )
    b0, b1 = (b, b) if b.ndim == 0 else (b[:-1], b[1:])
    d0 = (b0 - x0) if up else (x0 - b0)
    d1 = (b1 - x1) if up else (x1 - b1)
    inside = (d0 > 0.0) & (d1 > 0.0)
    var = torch.clamp(torch.as_tensor(seg_vars, dtype=log_grid.dtype, device=log_grid.device),
                      min=1e-30)
    # double where: the dead branch's positive exponent must never be
    # computed, or its overflow poisons the masked gradient
    arg = torch.where(inside, -2.0 * d0 * d1 / var, 0.0)
    return torch.where(inside, -torch.expm1(arg), 0.0)


def brownian_bridge_survival(log_grid, seg_vars, log_barrier, up: bool):
    """Per-path no-cross probability: the product over segments of
    :func:`brownian_bridge_survival_factors`."""
    return torch.prod(brownian_bridge_survival_factors(log_grid, seg_vars, log_barrier, up),
                      dim=0)


def brownian_bridge_extremum(log_grid, seg_vars, u, maximum: bool):
    """Running extremum of the continuous path by exact per-segment bridge
    draws: given endpoints (a, b) and variance s², the bridge maximum is
    M = ½·(a + b + √((a − b)² − 2·s²·log1p(−u))), the minimum the reflected
    root; the path's extremum is the max (min) over segments.  ``u``:
    (steps, ...) uniforms in [0, 1).  Returns shape ``(...)``."""
    a, b = log_grid[:-1], log_grid[1:]
    var = torch.clamp(torch.as_tensor(seg_vars, dtype=log_grid.dtype, device=log_grid.device),
                      min=1e-30)
    rad = torch.sqrt((a - b) ** 2 - 2.0 * var * torch.log1p(-u))
    if maximum:
        return torch.amax(0.5 * (a + b + rad), dim=0)
    return torch.amin(0.5 * (a + b - rad), dim=0)


def double_bridge_survival_factors(log_grid, seg_vars, log_lower, log_upper,
                                   n_images: int = 5):
    """Per-segment two-sided no-exit factors for the corridor (log_lower,
    log_upper): with endpoints ã, b̃ above the lower barrier, width c and
    variance s²,

        Σ_n [ e^{−2nc(nc + b̃ − ã)/s²} − e^{−2(nc + ã)(nc + b̃)/s²} ],

    zero where an endpoint lies outside, truncated at ``n_images`` and
    clipped to [0, 1]."""
    x0, x1 = log_grid[:-1], log_grid[1:]
    c = log_upper - log_lower
    at = x0 - log_lower
    bt = x1 - log_lower
    inside = (at > 0.0) & (bt > 0.0) & (at < c) & (bt < c)
    var = torch.clamp(torch.as_tensor(seg_vars, dtype=log_grid.dtype, device=log_grid.device),
                      min=1e-30)
    # double where: park the dead branch mid-corridor
    at_s = torch.where(inside, at, 0.5 * c)
    bt_s = torch.where(inside, bt, 0.5 * c)
    p = torch.zeros_like(at_s)
    for n in range(-n_images, n_images + 1):
        nc = n * c
        p = p + torch.exp(-2.0 * nc * (nc + bt_s - at_s) / var)
        p = p - torch.exp(-2.0 * (nc + at_s) * (nc + bt_s) / var)
    return torch.where(inside, torch.clamp(p, 0.0, 1.0), 0.0)


def lookback_uniforms(config, segments: int, device, device_id: int = 0) -> torch.Tensor:
    """(segments, trajectories) float64 uniforms in [0, 1) of the lookback's
    bridge extrema: Philox block b with counter (path, b, ``LOOK_TAG``) gives
    segments 4b..4b + 3 of path ``path``, one word each."""
    seed = seed_from_key(config, None) & _MASK32
    path = torch.arange(config.trajectories, dtype=torch.int64, device=device)
    words = []
    for b in range(-(-segments // 4)):
        words.extend(philox_block(path, b, seed, device_id & _MASK32, LOOK_TAG))
    return torch.stack([uniform_from_bits(w).double() for w in words[:segments]])


# The estimators need the Monte Carlo taxonomy; montecarlo re-exports the
# primitives above, so it is imported after them.
from . import montecarlo as mc  # noqa: E402


def _mid_times(T, steps: int, device) -> torch.Tensor:
    """The segments' midpoints (k + ½)·T/steps, where the at-hit rebate leg
    discounts a hit."""
    return (torch.arange(steps, dtype=torch.float64, device=device) + 0.5) * (T / steps)


def _flat_or_spot_vol(market, expiry):
    return (market.sigma.sigma if isinstance(market.sigma, FlatVolSurface)
            else get_vol(market.sigma, expiry, market.spot))


def _supports_bridge_grid(method) -> bool:
    """True when :func:`_bridge_log_grid` takes this (dynamics, strategy):
    the rule behind ``ki_monitoring='auto'``."""
    dyn, strat = method.dynamics, method.strategy
    if isinstance(dyn, LognormalDynamics) and isinstance(strat, mc.EulerMaruyama):
        return not strat.use_kernel
    if isinstance(dyn, HestonDynamics) and isinstance(strat, mc.HestonQE):
        return strat.conditional and not strat.use_kernel
    if isinstance(dyn, HestonDynamics) and isinstance(strat, mc.HestonExactMixing):
        return not strat.use_kernel
    return isinstance(dyn, RoughBergomiDynamics) and isinstance(strat, mc.EulerMaruyama)


def _bridge_log_grid(prob, method, what: str):
    """The stepped grid of the bridge estimators: ``(spot_grid, seg_vars,
    v_grid)`` with ``spot_grid`` (steps + 1, g, paths) in price space,
    ``seg_vars`` a scalar tensor or (steps, g, paths), and ``v_grid`` the
    (g, steps + 1, paths) variance grid on the Heston grids (else None).
    ``what`` names the payoff family in the errors."""
    market = prob.market_inputs
    dyn, strat, config = method.dynamics, method.strategy, method.config
    device = resolve_device(method.device)
    _, T, _ = mc.sim_params(prob)

    if isinstance(dyn, LognormalDynamics) and isinstance(strat, mc.EulerMaruyama):
        if strat.use_kernel:
            raise TypeError(
                "the fused GBM kernels return terminal samples without the "
                f"bridge factors; drop use_kernel=True for {what} payoffs"
            )
        sigma = f64(_flat_or_spot_vol(market, prob.payoff.expiry), device=device)
        grid = mc.simulate_price_grid(prob, method)  # (g, steps+1, paths)
        return torch.movedim(grid, 1, 0), sigma**2 * (T / config.steps), None
    if isinstance(dyn, HestonDynamics) and isinstance(strat, mc.HestonQE) and strat.conditional:
        if strat.use_kernel:
            raise TypeError(
                f"{what} pricing on the conditional grid is a pure-torch "
                "feature; drop use_kernel=True"
            )
        s_grid, v_grid = mc.simulate_conditional_grid(prob, config, device=device)
        dt = T / config.steps
        iv = 0.5 * dt * (v_grid[:, :-1] + v_grid[:, 1:])  # (g, steps, paths)
        return torch.movedim(s_grid, 1, 0), torch.movedim(iv, 1, 0), v_grid
    if isinstance(dyn, HestonDynamics) and isinstance(strat, mc.HestonExactMixing):
        if strat.use_kernel:
            raise TypeError(
                f"{what} pricing on the exact-transition grid is a pure-torch "
                "feature; drop use_kernel=True"
            )
        # exact transitions and sampled per-segment ∫V: the bridge clock is
        # the integrated variance in law
        s_grid, v_grid, iv_segs = mc.simulate_exact_conditional_grid(prob, config,
                                                                     device=device)
        return torch.movedim(s_grid, 1, 0), torch.movedim(iv_segs, 1, 0), v_grid
    if isinstance(dyn, RoughBergomiDynamics) and isinstance(strat, mc.EulerMaruyama):
        from .rough_bergomi_mixing import rbergomi_grid_with_variance

        s_grid, v = rbergomi_grid_with_variance(prob, config, device=device)
        # within a segment the log-bridge variance is the frozen left-point
        # V_k·Δt, the stepper's own
        return torch.movedim(s_grid, 1, 0), torch.movedim(v * (T / config.steps), 1, 0), None
    raise TypeError(
        f"{what} grids need LognormalDynamics with EulerMaruyama, "
        "HestonDynamics with HestonQE(conditional=True) or "
        "HestonExactMixing, or RoughBergomiDynamics with EulerMaruyama; got "
        f"({type(dyn).__name__}, {type(strat).__name__})"
    )


def barrier_grid_factors(prob, method):
    """A stepped price grid and its per-segment bridge no-cross factors for
    ``prob.payoff`` (a BarrierOption): ``(spot_grid, factors, t_mids,
    v_grid, seg_vars)`` of shapes (steps + 1, g, paths), (steps, g, paths),
    (steps,), the (g, steps + 1, paths) Heston variance grid or None, and
    the segment variances the factors were built from."""
    payoff = prob.payoff
    up = isinstance(payoff.direction, Up)
    _, T, _ = mc.sim_params(prob)
    if isinstance(method.dynamics, NormalDynamics) and isinstance(method.strategy,
                                                                  mc.EulerMaruyama):
        spot_grid, factors, seg_vars = _bachelier_barrier_factors(prob, method, T, up)
        v_grid = None
    else:
        spot_grid, seg_vars, v_grid = _bridge_log_grid(prob, method, "barrier")
        log_b = torch.log(f64(payoff.barrier, device=spot_grid.device))
        factors = brownian_bridge_survival_factors(torch.log(spot_grid), seg_vars, log_b, up)
    t_mids = _mid_times(T, method.config.steps, spot_grid.device)
    return spot_grid, factors, t_mids, v_grid, seg_vars


def _bachelier_barrier_factors(prob, method, T: float, up: bool):
    """The Bachelier grid's bridge factors in price space: the T-forward
    F = S/c(t), c = D(T)/D(t)·e^{q(T−t)}, is the Brownian coordinate, so the
    barrier is the per-grid-time level H/c(t_k) and a segment's variance
    σ_N²Δt.  ``(spot_grid, factors, seg_vars)``."""
    if method.strategy.use_kernel:
        raise TypeError("Bachelier has no fused kernel; drop use_kernel=True")
    from .normal_lv_mc import forward_ratio

    market = prob.market_inputs
    steps = method.config.steps
    spot_grid = torch.movedim(mc.simulate_price_grid(prob, method), 1, 0)  # (steps+1, g, paths)
    dev = spot_grid.device
    c = forward_ratio(market, T, steps, dev)
    barrier_k = (f64(prob.payoff.barrier, device=dev) / c)[:, None, None]
    seg_vars = f64(market.sigma, device=dev) ** 2 * (T / steps)
    factors = brownian_bridge_survival_factors(spot_grid / c[:, None, None], seg_vars,
                                               barrier_k, up)
    return spot_grid, factors, seg_vars


# Richardson weight 2^α/(2^α − 1) of the bridge-bias extrapolation on
# Heston grids: α = 0.75 was measured in the JAX package against a 2-D ADI
# oracle (the within-segment bias mixes √Δt and Δt terms)
_RICH_ALPHA = 0.75
_RICH_W = 2.0 ** _RICH_ALPHA / (2.0 ** _RICH_ALPHA - 1.0)


def _richardson_applies(dyn, steps: int) -> bool:
    """The extrapolation is Heston's only (α was measured there; the
    rough-Bergomi bias exponent depends on the Hurst index), at an even
    step count of at least 4."""
    return isinstance(dyn, HestonDynamics) and steps % 2 == 0 and steps >= 4


def _barrier_path_values(pay, factors, t_mids, payoff, market, discount):
    """Per-path barrier values from per-segment survival factors, shared by
    the single- and double-barrier estimators and by both passes of the
    Richardson pair."""
    surv = torch.prod(factors, dim=0)
    rebate = f64(payoff.rebate, device=pay.device)
    if isinstance(payoff.knock, KnockOut):
        vals = pay * surv
        if payoff.rebate_at_hit:
            # P(first hit in segment k) = (Π_{j<k} f_j)·(1 − f_k), each hit
            # discounted at the segment midpoint, carried as d(t_mid)/D(T)
            cum = torch.cumprod(factors, dim=0)
            prev = torch.cat([torch.ones_like(factors[:1]), cum[:-1]], dim=0)
            first_hit = prev * (1.0 - factors)  # (steps, g, paths)
            d_mid = df_yf(market.rate, t_mids).to(pay.device)  # (steps,)
            reb = torch.sum(d_mid[:, None, None] * first_hit, dim=0)
            vals = vals + (rebate / discount) * reb
        else:
            vals = vals + rebate * (1.0 - surv)
    else:  # KnockIn: the rebate pays at expiry iff never touched
        vals = pay * (1.0 - surv) + rebate * surv
    return vals


def _coarse_bridge_inputs(log_grid, seg_vars, T, steps: int):
    """Every-second-node view of the same grid, the half-resolution pass of
    the Richardson pair: segment variances summed in pairs, midpoints at
    (k + ½)·2Δt."""
    sv = seg_vars.reshape((steps // 2, 2) + tuple(seg_vars.shape[1:])).sum(dim=1)
    return log_grid[::2], sv, _mid_times(T, steps // 2, log_grid.device)


def _one_bridge_grid(prob, method, what: str):
    """``BlackScholesExact``'s grid: (log S0, log S_T) of the exact terminal
    draws, (2, g, paths), and the one segment's variance σ²T.  ``what``
    names the payoff family in the errors."""
    market = prob.market_inputs
    mc._require_no_dividend_schedule(market, "the one-bridge BlackScholesExact path estimator")
    if getattr(method.strategy, "use_kernel", False):
        noun = "state" if what == "lookback" else "factors"
        raise TypeError(
            "the fused GBM kernels return terminal samples without the "
            f"bridge {noun}; drop use_kernel=True for {what} payoffs"
        )
    _, T, _ = mc.sim_params(prob)
    samples = mc.simulate_terminal_prices(prob, method)  # (g, paths)
    sigma = f64(_flat_or_spot_vol(market, prob.payoff.expiry), device=samples.device)
    log_s0 = torch.log(f64(market.spot, device=samples.device)) + torch.zeros_like(samples)
    return torch.stack([log_s0, torch.log(samples)]), sigma**2 * T


def _is_one_bridge(method) -> bool:
    return (isinstance(method.dynamics, LognormalDynamics)
            and isinstance(method.strategy, mc.BlackScholesExact))


def _solve_barrier_mc(prob, method):
    """Barrier Monte Carlo: a grid, its per-segment bridge no-cross
    correction, the unconditional intrinsic at expiry (knock-in =
    intrinsic·(1 − survival) per path).  ``BlackScholesExact`` needs one
    exact bridge over [0, T]; on Heston grids the Richardson pair of the
    fine and the every-second-node pass (steps even, ≥ 4)."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    if torch.as_tensor(payoff.strike).ndim > 0 or torch.as_tensor(payoff.barrier).ndim > 0:
        raise TypeError(
            "barrier MC prices one (strike, barrier) pair per solve; vmap "
            "over contracts for grids"
        )
    market = prob.market_inputs
    dyn, config = method.dynamics, method.config
    device = resolve_device(method.device)
    discount = f64(df(market.rate, payoff.expiry), device=device)
    up = isinstance(payoff.direction, Up)
    log_b = torch.log(f64(payoff.barrier, device=device))
    _, T, _ = mc.sim_params(prob)
    coarse = None

    if _is_one_bridge(method):
        log_grid, seg_vars = _one_bridge_grid(prob, method, "barrier")
        factors = brownian_bridge_survival_factors(log_grid, seg_vars, log_b, up)
        t_mids = _mid_times(T, 1, device)
        s_t = torch.exp(log_grid[-1])
    elif isinstance(dyn, (HestonDynamics, RoughBergomiDynamics)):
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "barrier")
        log_grid = torch.log(spot_grid)
        factors = brownian_bridge_survival_factors(log_grid, seg_vars, log_b, up)
        t_mids = _mid_times(T, config.steps, device)
        s_t = spot_grid[-1]
        if _richardson_applies(dyn, config.steps):
            lg2, sv2, tm2 = _coarse_bridge_inputs(log_grid, seg_vars, T, config.steps)
            coarse = (brownian_bridge_survival_factors(lg2, sv2, log_b, up), tm2)
    else:
        spot_grid, factors, t_mids, _, _ = barrier_grid_factors(prob, method)
        s_t = spot_grid[-1]

    pay = payoff(s_t)  # unconditional terminal intrinsic, (g, paths)
    vals = _barrier_path_values(pay, factors, t_mids, payoff, market, discount)
    if coarse is not None:
        vals_2h = _barrier_path_values(pay, coarse[0], coarse[1], payoff, market, discount)
        vals = _RICH_W * vals - (_RICH_W - 1.0) * vals_2h
    price = discount * torch.mean(vals, dim=(0, -1))
    return mc.MonteCarloSolution(prob, method, price, vals)


def _solve_double_barrier_mc(prob, method):
    """Double-barrier Monte Carlo: the two-sided per-segment no-exit
    correction, the unconditional intrinsic at expiry; rebates as the
    single barrier's (at the hit time: the double one-touch, which the
    closed form lacks); the Richardson pair on Heston grids."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    if any(torch.as_tensor(x).ndim > 0 for x in (payoff.strike, payoff.lower, payoff.upper)):
        raise TypeError(
            "double-barrier MC prices one (strike, lower, upper) triple per "
            "solve; vmap over contracts for grids"
        )
    market = prob.market_inputs
    dyn, config = method.dynamics, method.config
    device = resolve_device(method.device)
    discount = f64(df(market.rate, payoff.expiry), device=device)
    log_l = torch.log(f64(payoff.lower, device=device))
    log_u = torch.log(f64(payoff.upper, device=device))
    _, T, _ = mc.sim_params(prob)

    if _is_one_bridge(method):
        log_grid, seg_vars = _one_bridge_grid(prob, method, "barrier")
        t_mids = _mid_times(T, 1, device)
    else:
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "barrier")
        log_grid = torch.log(spot_grid)
        t_mids = _mid_times(T, config.steps, device)

    factors = double_bridge_survival_factors(log_grid, seg_vars, log_l, log_u)
    pay = payoff(torch.exp(log_grid[-1]))  # unconditional terminal intrinsic
    vals = _barrier_path_values(pay, factors, t_mids, payoff, market, discount)
    if _richardson_applies(dyn, config.steps):
        lg2, sv2, tm2 = _coarse_bridge_inputs(log_grid, seg_vars, T, config.steps)
        f2 = double_bridge_survival_factors(lg2, sv2, log_l, log_u)
        vals_2h = _barrier_path_values(pay, f2, tm2, payoff, market, discount)
        vals = _RICH_W * vals - (_RICH_W - 1.0) * vals_2h
    price = discount * torch.mean(vals, dim=(0, -1))
    return mc.MonteCarloSolution(prob, method, price, vals)


def _solve_lookback_mc(prob, method):
    """Lookback Monte Carlo: a grid, an exact bridge extremum draw per
    segment (:func:`brownian_bridge_extremum`), the payout on (S_T, the
    extremum).  No discretization bias on GBM grids (``BlackScholesExact``
    needs one bridge); the Heston grids take the segment's ∫V.  Antithetic
    groups reflect the uniforms to 1 − u."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    if torch.as_tensor(payoff.strike).ndim > 0:
        raise TypeError(
            "lookback MC prices one contract per solve; vmap over contracts for grids"
        )
    market = prob.market_inputs
    config = method.config
    device = resolve_device(method.device)
    discount = f64(df(market.rate, payoff.expiry), device=device)
    maximum = payoff.uses_maximum

    if _is_one_bridge(method):
        log_grid, seg_vars = _one_bridge_grid(prob, method, "lookback")
    else:
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "lookback")
        log_grid = torch.log(spot_grid)

    u_b = lookback_uniforms(config, log_grid.shape[0] - 1, device)
    # antithetic groups reflect the uniforms with the grid draws; the clip
    # keeps the reflected u = 1 off log1p(−u)'s pole
    anti = isinstance(config.variance_reduction, mc.Antithetic)
    u = torch.stack([u_b, 1.0 - u_b], dim=1) if anti else u_b[:, None]
    u = torch.clamp(u, 0.0, 1.0 - 1e-16)
    ext_log = brownian_bridge_extremum(log_grid, seg_vars, u, maximum)
    spot = f64(market.spot, device=device)
    run = spot if payoff.running_extremum is None else f64(payoff.running_extremum,
                                                           device=device)
    log_run = torch.log(run)
    ext_log = torch.maximum(ext_log, log_run) if maximum else torch.minimum(ext_log, log_run)
    vals = payoff(torch.exp(log_grid[-1]), torch.exp(ext_log))  # (g, paths)
    price = discount * torch.mean(vals, dim=(0, -1))
    return mc.MonteCarloSolution(prob, method, price, vals)


def _solve_autocall_mc(prob, method):
    """Autocallable Monte Carlo (snowball and phoenix): a grid under any grid
    dynamics, one walk over the ``periods`` observation dates (the call
    cascade and the phoenix memory coupons as masks), every leg discounted
    at its own payment date.  ``ki_monitoring='continuous'`` takes the
    bridge's down-crossing probabilities, ``'observations'`` the dates
    only, ``'auto'`` continuous where the grid carries bridge factors."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    market = prob.market_inputs
    config = method.config
    n = payoff.periods
    if config.steps % n != 0:
        raise ValueError(
            f"autocallable MC needs config.steps to be a multiple of "
            f"periods so observation dates are grid points; got "
            f"steps={config.steps}, periods={n}"
        )
    m = config.steps // n
    _, T, _ = mc.sim_params(prob)
    device = resolve_device(method.device)
    s0 = f64(market.spot, device=device)
    kib = f64(payoff.knock_in_barrier, device=device) * s0

    monitoring = payoff.ki_monitoring
    if monitoring == "auto":
        monitoring = "continuous" if _supports_bridge_grid(method) else "observations"
    if monitoring == "continuous":
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "autocallable")
        factors = brownian_bridge_survival_factors(torch.log(spot_grid), seg_vars,
                                                   torch.log(kib), up=False)
        surv = torch.prod(factors, dim=0)  # (g, paths)
        obs = spot_grid[m::m]  # (n, g, paths)
    else:
        spot_grid = torch.movedim(mc.simulate_price_grid(prob, method), 1, 0)
        obs = spot_grid[m::m]
        surv = torch.all(obs >= kib, dim=0).to(spot_grid.dtype)

    t_obs = torch.arange(1, n + 1, dtype=torch.float64, device=device) * (T / n)
    d_obs = df_yf(market.rate, t_obs).to(device)
    notional, c = (f64(x, device=device) for x in (payoff.notional, payoff.coupon))
    b_ac = f64(payoff.autocall_barrier, device=device) * s0
    phoenix = payoff.coupon_barrier is not None
    b_cpn = f64(payoff.coupon_barrier, device=device) * s0 if phoenix else None

    alive = torch.ones(obs.shape[1:], dtype=torch.bool, device=device)
    disc_pay = torch.zeros(obs.shape[1:], dtype=torch.float64, device=device)
    unpaid = torch.zeros(obs.shape[1:], dtype=torch.float64, device=device)
    for i in range(n):
        s_i = obs[i]
        if phoenix:
            cpn_hit = alive & (s_i >= b_cpn)
            disc_pay = disc_pay + torch.where(cpn_hit, (unpaid + 1.0) * c * notional * d_obs[i],
                                              0.0)
            unpaid = torch.where(cpn_hit, 0.0, torch.where(alive, unpaid + 1.0, unpaid))
        call_hit = alive & (s_i >= b_ac)
        redemption = notional if phoenix else notional * (1.0 + (i + 1) * c)
        disc_pay = disc_pay + torch.where(call_hit, redemption * d_obs[i], 0.0)
        alive = alive & ~call_hit

    term_no_ki = notional if phoenix else notional * (1.0 + n * c)
    airbag = notional * torch.clamp(spot_grid[-1] / s0, max=1.0)
    disc_pay = disc_pay + torch.where(
        alive, d_obs[-1] * (surv * term_no_ki + (1.0 - surv) * airbag), 0.0)
    price = torch.mean(disc_pay, dim=(0, -1))
    return mc.MonteCarloSolution(prob, method, price, disc_pay)
