"""The Hull-White Monte Carlo of the port (``HullWhiteMonteCarlo`` of
methods/hull_white.py: the exact (x, ∫x) transitions and the Bermudan
Longstaff–Schwartz) against the JAX package on the CPU.

Under QMC the port draws JAX's Sobol' points, so every path's discounted
value equals JAX's to 1e-10.  The Bermudan LSM has no QMC stream in JAX:
given the normals JAX draws, the port's per-path values and price equal
JAX's to 1e-10.  On the port's own Philox streams the estimators agree in
law with the closed forms (within 4 SE) and the LSM with the grid at
tests/unit/test_hull_white.py's tolerances; the spot-start cap's first
period is the known fixing, not a 0/0 (:305)."""

import dataclasses
import datetime as dt
import math

import jax
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import hull_white as jhw

REF = dt.date(2024, 1, 1)
CPU = "cpu"
PATH_RTOL = 1e-10
SWAP_DATES = [dt.date(2026, 1, 1), dt.date(2027, 1, 1), dt.date(2028, 1, 1)]
TENORS = np.array([0.5, 1.0, 2.0, 3.0, 5.0])
ZEROS = np.array([0.02, 0.025, 0.03, 0.032, 0.035])
E, B = dt.date(2025, 1, 1), dt.date(2028, 1, 1)
PAYOFFS = {
    "zcb": hh.ZeroCouponBond(dt.date(2027, 1, 1)),
    "bond call": hh.BondOption(0.92, E, B),
    "bond put": hh.BondOption(0.92, E, B, call_put=hh.Put()),
    "caplet": hh.Caplet(0.03, E, dt.date(2025, 7, 1), notional=100.0),
    "payer": hh.Swaption(0.032, E, SWAP_DATES, payer=True, notional=100.0),
    "receiver": hh.Swaption(0.032, E, SWAP_DATES, payer=False, notional=100.0),
}
BERMUDAN = hh.Swaption(0.032, E, SWAP_DATES, payer=True, notional=100.0,
                       exercise_style=hh.Bermudan([dt.date(2026, 1, 1), dt.date(2027, 1, 1)]))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jmarket():
    return hh.HullWhiteInputs(REF, hh.RateCurve.from_dfs(REF, TENORS, np.exp(-ZEROS * TENORS)),
                              0.1, 0.012)


def _pmarket():
    return ht.from_reference(_jmarket())


def _config(pairs, steps=4, seed=0, qmc=False, anti=True):
    return hh.SimulationConfig(pairs, steps, hh.Antithetic() if anti else hh.NoVarianceReduction(),
                               seed, qmc)


def _psolve(payoff, method):
    return ht.solve(ht.PricingProblem(ht.from_reference(payoff), _pmarket()),
                    dataclasses.replace(ht.from_reference(method), device=CPU))


def _analytic(payoff):
    return float(_psolve(payoff, hh.HullWhiteAnalytic()).price)


def _price_and_values(sol):
    return sol.price, sol.ensemble


@pytest.mark.parametrize("name", list(PAYOFFS))
def test_qmc_paths_match_reference(name):
    method = hh.HullWhiteMonteCarlo(_config(2048, qmc=True, anti=name != "bond put"))
    prob = hh.PricingProblem(PAYOFFS[name], _jmarket())
    want_price, want = jax.jit(lambda: _price_and_values(hh.solve(prob, method)))()
    sol = _psolve(PAYOFFS[name], method)
    assert sol.ensemble.shape == want.shape
    np.testing.assert_allclose(sol.ensemble.numpy(), np.asarray(want), rtol=PATH_RTOL, atol=1e-14)
    assert float(sol.price) == pytest.approx(float(want_price), rel=PATH_RTOL)


def test_bermudan_lsm_matches_reference_on_its_draws():
    """``hw_bermudan_lsm`` on the normals ``_hw_exercise_paths`` draws
    (``jax.random.normal(PRNGKey(seed), (m, 2, paths))``): the same exercise
    decisions, per-path values and price."""
    method = hh.HullWhiteMonteCarlo(_config(4096, seed=3))
    prob = hh.PricingProblem(BERMUDAN, _jmarket())
    want_price, want = jax.jit(lambda: _price_and_values(jhw._solve_hw_bermudan_lsm(prob,
                                                                                   method)))()
    z = jax.random.normal(jax.random.PRNGKey(3), (3, 2, 4096), dtype=np.float64)
    got = ht.methods.hull_white.hw_bermudan_lsm(
        ht.PricingProblem(ht.from_reference(BERMUDAN), _pmarket()),
        ht.HullWhiteMonteCarlo(ht.from_reference(method.config), device=CPU), z=np.array(z))
    np.testing.assert_allclose(got.ensemble.numpy(), np.asarray(want), rtol=PATH_RTOL, atol=1e-14)
    assert float(got.price) == pytest.approx(float(want_price), rel=PATH_RTOL)


def _se(vals: torch.Tensor) -> float:
    pairs = vals.mean(dim=0)
    return float(pairs.std()) / math.sqrt(pairs.numel())


@pytest.mark.parametrize("name", list(PAYOFFS))
def test_prng_stream_agrees_with_closed_form(name):
    """The Philox stream (``HW_TAG``) at 2^14 antithetic pairs × 4 exact steps
    within 4 SE of the closed form; the ZCB is the martingale discount."""
    sol = _psolve(PAYOFFS[name], hh.HullWhiteMonteCarlo(_config(2**14, seed=11)))
    assert bool(torch.isfinite(sol.ensemble).all())
    want, se = _analytic(PAYOFFS[name]), _se(sol.ensemble)
    assert abs(float(sol.price) - want) <= 4.0 * se + 1e-12, (float(sol.price), want, se)


def test_capfloor_strip_and_spot_start_cap():
    """A cap's legs on seeds seed + 7919·i (test_hull_white.py:276) within the
    JAX test's 2e-2, and a spot-start cap, whose first leg fixes today, is
    finite and within 2e-2 too (:305)."""
    strip = [dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2025, 7, 1), dt.date(2026, 1, 1)]
    spot_start = [REF, dt.date(2024, 7, 1), dt.date(2025, 1, 1)]
    for dates in (strip, spot_start):
        cap = hh.CapFloor(0.03, dates, notional=100.0)
        pm = float(_psolve(cap, hh.HullWhiteMonteCarlo(_config(30_000, 2))).price)
        assert np.isfinite(pm)
        assert pm == pytest.approx(_analytic(cap), rel=2e-2)
    # the spot-start leg alone is deterministic: every path the same value
    first = hh.Caplet(0.03, REF, dt.date(2024, 7, 1), notional=100.0)
    vals = _psolve(first, hh.HullWhiteMonteCarlo(_config(64, 2))).ensemble
    assert vals.shape == (1, 64) and float(vals.std()) == 0.0
    assert float(vals[0, 0]) == pytest.approx(_analytic(first), rel=1e-14)


def test_bermudan_lsm_agrees_with_the_grid():
    """test_hull_white.py:315: the LSM on the Philox stream (``HW_BERMUDAN_TAG``,
    2^16 antithetic pairs) within 1e-2 of the grid and at most a whisker
    above it (a frozen policy is a lower bound)."""
    pg = float(_psolve(BERMUDAN, hh.HullWhiteGrid()).price)
    pl = float(_psolve(BERMUDAN, hh.HullWhiteMonteCarlo(_config(2**16))).price)
    assert pl == pytest.approx(pg, rel=1e-2)
    assert pl < pg * 1.005


def test_guards():
    mc = ht.HullWhiteMonteCarlo(ht.SimulationConfig(64), device=CPU)
    with pytest.raises(TypeError, match="HullWhiteInputs"):
        ht.solve(ht.PricingProblem(ht.ZeroCouponBond(E),
                                   ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)), mc)
    with pytest.raises(TypeError, match="interest-rate payoff"):
        ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, E), _pmarket()), mc)
