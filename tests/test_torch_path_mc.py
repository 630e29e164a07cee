"""Lookbacks, Asians, forward starts, cliquets, variance swaps and the
two-date contracts by Monte Carlo, against the JAX package on the CPU
(autocallables and digitals: tests/test_torch_autocall_mc.py).

Under QMC both packages draw the same Sobol' points, so each path's value
agrees to 1e-9 relative on the GBM log-Euler, conditional Heston QE, exact
Heston and rough-Bergomi Euler grids.  The lookback's extremum uniforms are
the port's own Philox stream: its values are held per path against JAX's
``brownian_bridge_extremum`` fed the same uniforms, and its price in law
(within 4 SE) against the closed form, as is the geometric Asian's under
PRNG."""

import dataclasses
import datetime as dt
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import bridge_mc as pbr

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)  # T = 1
START = REF + dt.timedelta(days=146)  # t = 0.4: the second of five steps
T1 = dt.date(2024, 7, 1)
CPU = "cpu"
PAIRS = 1 << 10
STEPS = 5  # one step count for every grid: each grid compiles once in JAX
BS = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.25, dividend_yield=0.01)
HESTON = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.5, -0.7)
RBERGOMI = hh.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.9, 0.1, -0.9)
GRIDS = {
    "gbm euler": (BS, hh.LognormalDynamics(), hh.EulerMaruyama()),
    "qe conditional": (HESTON, hh.HestonDynamics(), hh.HestonQE(conditional=True)),
    "rbergomi euler": (RBERGOMI, hh.RoughBergomiDynamics(), hh.EulerMaruyama()),
}


def _close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _method(grid, steps, qmc=True, pairs=PAIRS, seed=3):
    market, dyn, strat = GRIDS[grid] if isinstance(grid, str) else grid
    cfg = hh.SimulationConfig(pairs, steps, hh.Antithetic(), seed, qmc)
    return market, hh.MonteCarlo(dyn, strat, cfg)


def _port(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _per_path(payoff, grid, steps):
    market, method = _method(grid, steps)
    prob = hh.PricingProblem(payoff, market)
    want = hh.solve(prob, method)
    got = ht.solve(ht.from_reference(prob), _port(method))
    assert got.ensemble.device.type == CPU
    assert tuple(got.ensemble.shape) == tuple(want.ensemble.shape)
    _close(got.ensemble, want.ensemble)
    _close(got.price, want.price)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("payoff", [
    hh.AsianOption(100.0, EXPIRY, STEPS),
    hh.AsianOption(95.0, EXPIRY, STEPS, call_put=hh.Put(), averaging=hh.GeometricAverage()),
    hh.Cliquet(EXPIRY, STEPS, -0.02, 0.05, 10.0),
    hh.VarianceSwap(0.05, EXPIRY, STEPS, 100.0),
], ids=["asian", "geometric asian put", "cliquet", "variance swap"])
def test_grid_payoffs_match_reference_per_path(grid, payoff):
    _per_path(payoff, grid, STEPS)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_forward_start_matches_reference_per_path(grid):
    _per_path(hh.ForwardStartOption(1.02, EXPIRY, START), grid, STEPS)


@pytest.mark.parametrize("payoff", [
    hh.CompoundOption(4.0, T1, 100.0, EXPIRY),
    hh.CompoundOption(3.0, T1, 105.0, EXPIRY, call_put=hh.Put(), inner_call_put=hh.Put()),
    hh.ChooserOption(100.0, EXPIRY, T1),
], ids=["call on call", "put on put", "chooser"])
def test_two_date_mc_matches_reference_per_path(payoff):
    _per_path(payoff, (BS, hh.LognormalDynamics(), hh.BlackScholesExact()), 1)


@pytest.mark.parametrize("grid,steps", [
    ((BS, hh.LognormalDynamics(), hh.BlackScholesExact()), 1),
    ("gbm euler", STEPS),
    ("qe conditional", STEPS),
    ((HESTON, hh.HestonDynamics(), hh.HestonExactMixing()), STEPS),
    ("rbergomi euler", STEPS),
], ids=["one bridge", "gbm euler", "qe conditional", "exact", "rbergomi euler"])
@pytest.mark.parametrize("payoff", [
    hh.LookbackOption(EXPIRY),
    hh.LookbackOption(EXPIRY, 105.0, hh.FixedStrike(), hh.Call(), running_extremum=103.0),
], ids=["floating call", "fixed call running"])
def test_lookback_matches_the_reference_bridge_on_the_same_uniforms(grid, steps, payoff):
    """The port's lookback values are JAX's bridge extremum of JAX's grid,
    fed the port's uniforms (reflected across each antithetic pair)."""
    market, method = _method(grid, steps)
    prob = hh.PricingProblem(payoff, market)
    got = ht.solve(ht.from_reference(prob), _port(method)).ensemble
    if steps == 1:
        sigma = market.sigma.sigma
        T = float(hh.yearfrac(REF, EXPIRY))
        samples = hh.simulate_terminal_prices(prob, method)
        log_grid = jnp.stack([jnp.full_like(samples, jnp.log(100.0)), jnp.log(samples)])
        seg = sigma**2 * T
    else:
        spot_grid, seg, _ = jmc._bridge_log_grid(prob, method, "lookback")
        log_grid = jnp.log(spot_grid)
    u = pbr.lookback_uniforms(_port(method).config, steps, CPU).numpy()
    u = np.clip(np.stack([u, 1.0 - u], axis=1), 0.0, 1.0 - 1e-16)
    ext = jmc.brownian_bridge_extremum(log_grid, seg, u, payoff.uses_maximum)
    run = 100.0 if payoff.running_extremum is None else payoff.running_extremum
    ext = jnp.maximum(ext, jnp.log(run)) if payoff.uses_maximum else jnp.minimum(ext,
                                                                                 jnp.log(run))
    _close(got, payoff(jnp.exp(log_grid[-1]), jnp.exp(ext)))


def _in_law(payoff, strat, steps, qmc):
    cfg = ht.SimulationConfig(1 << 13, steps, ht.Antithetic(), 17, qmc)
    prob = ht.from_reference(hh.PricingProblem(payoff, BS))
    closed = float(ht.solve(prob, ht.BlackScholesAnalytic(device=CPU)).price)
    sol = ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), strat, cfg, device=CPU))
    pair = sol.ensemble.mean(dim=0)
    se = math.exp(-0.05) * float(pair.std()) / math.sqrt(pair.numel())
    assert abs(float(sol.price) - closed) <= 4.0 * se, (float(sol.price), closed, se)


@pytest.mark.parametrize("qmc", [False, True])
@pytest.mark.parametrize("payoff", [
    hh.LookbackOption(EXPIRY),
    hh.LookbackOption(EXPIRY, call_put=hh.Put()),
    hh.LookbackOption(EXPIRY, 105.0, hh.FixedStrike()),
    hh.LookbackOption(EXPIRY, 95.0, hh.FixedStrike(), hh.Put(), running_extremum=97.0),
], ids=["floating call", "floating put", "fixed call", "fixed put running"])
def test_lookback_prices_lie_within_4_se_of_the_closed_form(payoff, qmc):
    _in_law(payoff, ht.BlackScholesExact(), 1, qmc)


def test_geometric_asian_prng_lies_within_4_se_of_the_closed_form():
    _in_law(hh.AsianOption(100.0, EXPIRY, 12, averaging=hh.GeometricAverage()),
            ht.EulerMaruyama(), 12, False)


def test_heston_variance_swap_strike_matches_reference():
    port = ht.from_reference(HESTON)
    for T in (0.25, 1.0, 3.0):
        _close(ht.heston_variance_swap_strike(port, T), hh.heston_variance_swap_strike(HESTON, T),
               rtol=1e-14)


def test_path_mc_refusals_match_reference():
    cfg = hh.SimulationConfig(64, 6, hh.Antithetic(), 0)
    gbm = hh.MonteCarlo(hh.LognormalDynamics(), hh.EulerMaruyama(), cfg)
    cases = [
        (BS, gbm, hh.AsianOption(100.0, EXPIRY, 12), ValueError, "observations"),
        (BS, gbm, hh.Cliquet(EXPIRY, 4), ValueError, "observations"),
        (BS, gbm, hh.VarianceSwap(0.04, EXPIRY, 5), ValueError, "observations"),
            (BS, gbm, hh.ForwardStartOption(1.0, EXPIRY, T1), ValueError, "step grid"),
        (HESTON, hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg),
         hh.ChooserOption(100.0, EXPIRY, T1), TypeError, "LognormalDynamics"),
        (BS, hh.MonteCarlo(hh.LognormalDynamics(), hh.BlackScholesExact(), cfg),
         dataclasses.replace(hh.LookbackOption(EXPIRY), strike=jnp.array([1.0, 2.0])),
         TypeError, "one contract"),
        (HESTON, hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(), cfg),
         hh.LookbackOption(EXPIRY), TypeError, "lookback grids need"),
        (HESTON, hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg),
         hh.AsianOption(100.0, EXPIRY, 6, exercise_style=hh.American()), TypeError,
         "European"),
    ]
    for market, method, payoff, err, match in cases:
        prob = hh.PricingProblem(payoff, market)
        with pytest.raises(err, match=match):
            hh.solve(prob, method)
        with pytest.raises(err, match=match):
            ht.solve(ht.from_reference(prob), _port(method))
    # the multi-asset payoffs reach methods/multi_asset.py, which refuses
    # the arithmetic basket's closed form as JAX does
    market = hh.MultiAssetBSInputs(REF, 0.05, jnp.asarray([100.0, 95.0]), jnp.asarray([0.25, 0.2]),
                                   jnp.asarray([[1.0, 0.5], [0.5, 1.0]]))
    prob = hh.PricingProblem(hh.BasketOption(95.0, EXPIRY, jnp.asarray([0.5, 0.5])), market)
    with pytest.raises(TypeError, match="no lognormal closed form"):
        hh.solve(prob, hh.BlackScholesAnalytic())
    with pytest.raises(TypeError, match="no lognormal closed form"):
        ht.solve(ht.from_reference(prob), ht.BlackScholesAnalytic(device=CPU))


def test_path_mc_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    prob = ht.from_reference(hh.PricingProblem(hh.Cliquet(EXPIRY, 8), BS))
    cfg = ht.SimulationConfig(64, 8, ht.Antithetic(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), cfg))
