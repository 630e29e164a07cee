"""Autocallables and digitals by Monte Carlo against the JAX package on the
CPU: under QMC each path's value agrees to 1e-9 relative, the autocallable
(snowball and phoenix; continuous, observation-date and automatic knock-in
monitoring) on the GBM log-Euler, conditional Heston QE, exact Heston and
rough-Bergomi Euler grids, the digital through the terminal samples and
the conditional mixing closes."""

import dataclasses
import datetime as dt

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


def _per_path(payoff, grid, steps):
    market, dyn, strat = GRIDS[grid] if isinstance(grid, str) else grid
    method = hh.MonteCarlo(dyn, strat, hh.SimulationConfig(PAIRS, steps, hh.Antithetic(), 3,
                                                           True))
    prob = hh.PricingProblem(payoff, market)
    want = hh.solve(prob, method)
    port = dataclasses.replace(ht.from_reference(method), device=CPU)
    got = ht.solve(ht.from_reference(prob), port)
    assert got.ensemble.device.type == CPU
    assert tuple(got.ensemble.shape) == tuple(want.ensemble.shape)
    _close(got.ensemble, want.ensemble)
    _close(got.price, want.price)


AUTOCALLS = {
    "snowball continuous": hh.Autocallable(EXPIRY, 4, 1.0, 0.05, 0.7,
                                           ki_monitoring="continuous"),
    "phoenix auto": hh.Autocallable(EXPIRY, 4, 1.05, 0.02, 0.75, 0.85, 100.0),
    "snowball observations": hh.Autocallable(EXPIRY, 4, 1.02, 0.04, 0.8,
                                             ki_monitoring="observations"),
}


# the exact grid has no price-grid route (observation monitoring) in either package
@pytest.mark.parametrize("grid,name", [(g, n) for g in (*GRIDS, "exact") for n in AUTOCALLS
                                       if (g, n) != ("exact", "snowball observations")])
def test_autocallable_matches_reference_per_path(grid, name):
    if grid == "exact":
        grid = (HESTON, hh.HestonDynamics(), hh.HestonExactMixing())
    _per_path(AUTOCALLS[name], grid, 8)


@pytest.mark.parametrize("grid,payoff", [
    ((BS, hh.LognormalDynamics(), hh.BlackScholesExact()), hh.DigitalOption(105.0, EXPIRY)),
    ("qe conditional", hh.DigitalOption(95.0, EXPIRY, call_put=hh.Put(), cash=10.0)),
    ((HESTON, hh.HestonDynamics(), hh.HestonExactMixing()), hh.DigitalOption(100.0, EXPIRY)),
], ids=["terminal", "qe mixing close", "exact mixing close"])
def test_digital_mc_matches_reference_per_path(grid, payoff):
    _per_path(payoff, grid, 2)


def test_autocall_refusals_match_reference():
    cfg = hh.SimulationConfig(64, 6, hh.Antithetic(), 0)
    for method, err, match in (
            (hh.MonteCarlo(hh.LognormalDynamics(), hh.EulerMaruyama(), cfg), ValueError,
             "multiple of"),
            (hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(),
                           dataclasses.replace(cfg, steps=8)), TypeError, "unsupported")):
        market = BS if isinstance(method.dynamics, hh.LognormalDynamics) else HESTON
        prob = hh.PricingProblem(hh.Autocallable(EXPIRY, 4, ki_monitoring="observations"),
                                 market)
        with pytest.raises(err, match=match):
            hh.solve(prob, method)
        with pytest.raises(err, match=match):
            ht.solve(ht.from_reference(prob),
                     dataclasses.replace(ht.from_reference(method), device=CPU))


def test_autocall_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    prob = ht.from_reference(hh.PricingProblem(AUTOCALLS["phoenix auto"], BS))
    cfg = ht.SimulationConfig(64, 8, ht.Antithetic(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), cfg))
