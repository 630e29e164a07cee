"""Single- and double-barrier Monte Carlo against the JAX package on the CPU.

Under QMC both packages draw the same Sobol' points, so each path's value
agrees to 1e-9 relative on every bridge grid: one exact bridge
(``BlackScholesExact``), the GBM log-Euler grid, the conditional Heston QE
grid and the exact Heston grid (with the Richardson pair and without), and
the rough-Bergomi Euler grid.  Under PRNG the GBM prices lie within 4 SE of
the closed forms.  The greeks through these estimators are in
tests/test_torch_exotic_greeks.py."""

import dataclasses
import datetime as dt
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CPU = "cpu"
PAIRS = 1 << 10
BS = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.25, dividend_yield=0.01)
H = (0.04, 2.0, 0.04, 0.5, -0.7)
HESTON = hh.HestonInputs(REF, 0.03, 100.0, *H)
RBERGOMI = hh.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.9, 0.1, -0.9)

GRIDS = {
    "one bridge": (BS, hh.LognormalDynamics(), hh.BlackScholesExact(), 1),
    "gbm euler": (BS, hh.LognormalDynamics(), hh.EulerMaruyama(), 8),
    "qe richardson": (HESTON, hh.HestonDynamics(), hh.HestonQE(conditional=True), 8),
    "exact richardson": (HESTON, hh.HestonDynamics(), hh.HestonExactMixing(), 4),
    "exact two steps": (HESTON, hh.HestonDynamics(), hh.HestonExactMixing(), 2),  # no Richardson
    "rbergomi euler": (RBERGOMI, hh.RoughBergomiDynamics(), hh.EulerMaruyama(), 6),
}

PAYOFFS = {
    "down-out call": hh.BarrierOption(100.0, EXPIRY, 85.0),
    "up-in put rebate": hh.BarrierOption(100.0, EXPIRY, 120.0, call_put=hh.Put(),
                                         direction=hh.Up(), knock=hh.KnockIn(), rebate=2.0),
    "up-out call at hit": hh.BarrierOption(95.0, EXPIRY, 125.0, direction=hh.Up(),
                                           rebate=3.0, rebate_at_hit=True),
    "double knock-out at hit": hh.DoubleBarrierOption(100.0, EXPIRY, 80.0, 125.0,
                                                      rebate=1.0, rebate_at_hit=True),
    "double knock-in put": hh.DoubleBarrierOption(100.0, EXPIRY, 85.0, 120.0,
                                                  call_put=hh.Put(), knock=hh.KnockIn(),
                                                  rebate=0.5),
}


def _close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _method(grid, qmc=True, pairs=PAIRS, seed=3):
    market, dyn, strat, steps = GRIDS[grid]
    cfg = hh.SimulationConfig(pairs, steps, hh.Antithetic(), seed, qmc)
    return market, hh.MonteCarlo(dyn, strat, cfg)


def _port(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("payoff", list(PAYOFFS))
def test_barrier_values_match_reference_per_path(grid, payoff):
    market, method = _method(grid)
    prob = hh.PricingProblem(PAYOFFS[payoff], market)
    want = hh.solve(prob, method)
    got = ht.solve(ht.from_reference(prob), _port(method))
    assert got.ensemble.device.type == CPU
    assert tuple(got.ensemble.shape) == tuple(want.ensemble.shape)
    _close(got.ensemble, want.ensemble)
    _close(got.price, want.price)


def test_barrier_grid_factors_match_reference():
    from hedgehog_tpu.methods import montecarlo as jmc
    from hedgehog_tpu_torch.methods import bridge_mc as pbr

    market, method = _method("qe richardson")
    prob = hh.PricingProblem(PAYOFFS["down-out call"], market)
    want = jmc.barrier_grid_factors(prob, method)
    got = pbr.barrier_grid_factors(ht.from_reference(prob), _port(method))
    for g, w in zip(got, want):
        _close(g, w)


def _se_price(sol, discount):
    pair = sol.ensemble.mean(dim=0) if sol.ensemble.ndim == 2 else sol.ensemble
    return float(sol.price), discount * float(pair.std()) / math.sqrt(pair.numel())


@pytest.mark.parametrize("payoff,grid", [
    (hh.BarrierOption(100.0, EXPIRY, 90.0), "one bridge"),
    (hh.BarrierOption(100.0, EXPIRY, 120.0, call_put=hh.Put(), direction=hh.Up(),
                      knock=hh.KnockIn(), rebate=2.0), "one bridge"),
    (hh.BarrierOption(105.0, EXPIRY, 125.0, direction=hh.Up()), "gbm euler"),
    (hh.DoubleBarrierOption(100.0, EXPIRY, 80.0, 125.0, rebate=1.0), "one bridge"),
    (hh.DoubleBarrierOption(95.0, EXPIRY, 75.0, 130.0, call_put=hh.Put()), "gbm euler"),
])
def test_prng_gbm_prices_lie_within_4_se_of_the_closed_forms(payoff, grid):
    _, method = _method(grid, qmc=False, pairs=1 << 12, seed=8)
    prob = ht.from_reference(hh.PricingProblem(payoff, BS))
    closed = float(ht.solve(prob, ht.BlackScholesAnalytic(device=CPU)).price)
    price, se = _se_price(ht.solve(prob, _port(method)), math.exp(-0.05))
    assert abs(price - closed) <= 4.0 * se, (price, closed, se)


def test_knock_in_plus_knock_out_is_the_vanilla_per_path():
    market, method = _method("exact richardson")
    ko = hh.BarrierOption(100.0, EXPIRY, 85.0)
    ki = dataclasses.replace(ko, knock=hh.KnockIn())
    port = _port(method)
    v_ko, v_ki = (ht.solve(ht.from_reference(hh.PricingProblem(p, market)), port).ensemble
                  for p in (ko, ki))
    grid = ht.methods.montecarlo.simulate_exact_conditional_grid(
        ht.from_reference(hh.PricingProblem(ko, market)), port.config, device=CPU)[0]
    _close(v_ko + v_ki, torch.clamp(grid[:, -1] - 100.0, min=0.0), rtol=1e-12, atol=1e-12)


def test_barrier_refusals_match_reference():
    ko = PAYOFFS["down-out call"]
    cfg = hh.SimulationConfig(64, 2, hh.Antithetic(), 0)
    cases = [
        (HESTON, hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(), cfg), ko, "barrier grids need"),
        (BS, hh.MonteCarlo(hh.LognormalDynamics(), hh.EulerMaruyama(use_kernel=True), cfg), ko,
         "fused GBM kernels"),
        (BS, hh.MonteCarlo(hh.LognormalDynamics(), hh.BlackScholesExact(use_kernel=True), cfg),
         PAYOFFS["double knock-in put"], "fused GBM kernels"),
        (HESTON, hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True,
                                                                use_kernel=True), cfg), ko,
         "drop use_kernel"),
        (BS, hh.MonteCarlo(hh.LognormalDynamics(), hh.BlackScholesExact(), cfg),
         dataclasses.replace(ko, strike=jnp.array([90.0, 100.0])), "one \\(strike, barrier\\)"),
        (BS, hh.MonteCarlo(hh.LognormalDynamics(), hh.BlackScholesExact(), cfg),
         dataclasses.replace(ko, exercise_style=hh.American()), "European"),
    ]
    for market, method, payoff, match in cases:
        prob = hh.PricingProblem(payoff, market)
        with pytest.raises(TypeError, match=match):
            hh.solve(prob, method)
        with pytest.raises(TypeError, match=match):
            ht.solve(ht.from_reference(prob), _port(method))


def test_barrier_mc_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, method = _method("gbm euler")
    prob = ht.from_reference(hh.PricingProblem(PAYOFFS["down-out call"], BS))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.solve(prob, ht.from_reference(method))
