"""Pathwise greeks through the bridge estimators against ``jax.grad`` of the
JAX solve on the CPU: on the same Sobol' points the barrier's delta and
V0-vega through ``GreekProblem`` with ForwardAD and with ReverseAD agree to
1e-8 on the conditional Heston QE grid and on the exact Heston grid (both
with the Richardson pair), and the continuously monitored autocallable's
delta on the GBM grid."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CPU = "cpu"
H = (0.04, 2.0, 0.04, 0.5, -0.7)
STRATEGIES = {"qe richardson": (hh.HestonQE(conditional=True), 8),
              "exact richardson": (hh.HestonExactMixing(), 4)}


def _close(got, want, rtol=1e-8, atol=1e-12):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("grid", list(STRATEGIES))
def test_heston_barrier_greeks_match_jax_grad(grid):
    strat, steps = STRATEGIES[grid]
    cfg = hh.SimulationConfig(1 << 9, steps, hh.Antithetic(), 3, True)
    method = hh.MonteCarlo(hh.HestonDynamics(), strat, cfg)
    payoff = hh.BarrierOption(100.0, EXPIRY, 85.0, rebate=1.0, rebate_at_hit=True)

    def jax_price(spot, v0):
        m = hh.HestonInputs(REF, 0.03, spot, v0, *H[1:])
        return hh.solve(hh.PricingProblem(payoff, m), method).price

    want = jax.grad(jax_price, argnums=(0, 1))(jnp.float64(100.0), jnp.float64(H[0]))
    prob = ht.from_reference(hh.PricingProblem(payoff, hh.HestonInputs(REF, 0.03, 100.0, *H)))
    port = dataclasses.replace(ht.from_reference(method), device=CPU)
    for lens, w in ((ht.SpotLens(), want[0]), (ht.FieldLens("market_inputs.V0"), want[1])):
        for greek in (ht.ForwardAD(), ht.ReverseAD()):
            _close(ht.solve(ht.GreekProblem(prob, lens), greek, port).greek, w)


def test_continuous_autocall_delta_matches_jax_grad():
    cfg = hh.SimulationConfig(1 << 9, 8, hh.Antithetic(), 4, True)
    method = hh.MonteCarlo(hh.LognormalDynamics(), hh.EulerMaruyama(), cfg)
    payoff = hh.Autocallable(EXPIRY, 4, 1.05, 0.06, 0.75, ki_monitoring="continuous")

    def jax_price(spot):
        return hh.solve(hh.PricingProblem(payoff, hh.BlackScholesInputs(REF, 0.03, spot, 0.3)),
                        method).price

    want = jax.grad(jax_price)(jnp.float64(100.0))
    prob = ht.from_reference(hh.PricingProblem(payoff, hh.BlackScholesInputs(REF, 0.03, 100.0,
                                                                              0.3)))
    port = dataclasses.replace(ht.from_reference(method), device=CPU)
    for greek in (ht.ForwardAD(), ht.ReverseAD()):
        _close(ht.solve(ht.GreekProblem(prob, ht.SpotLens()), greek, port).greek, want)
