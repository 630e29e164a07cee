"""The local-vol dynamics of the port's 1-D PDE (methods/pde.py: Dupire's
σ_loc at each step's mid time on the grid nodes) against the JAX package on
the CPU: an American put on a cubic surface with carry to 1e-10 (the
projection and the mid-step Dupire rows), then tests/unit/test_pde.py's
oracles on the port (a flat surface is Black-Scholes; vols in tenor only
integrate to the expiry's total variance) and the dividend-schedule
refusal."""

import dataclasses
import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)  # T = 1 (ACT/365)
CPU = "cpu"
TENORS = np.array([0.25, 0.5, 1.0, 1.5, 2.0])
STRIKES = np.array([70.0, 80.0, 90.0, 100.0, 110.0, 120.0, 135.0])
IVS = np.stack([0.22 + 0.01 * i - 0.12 * np.log(STRIKES / 100.0) for i in range(len(TENORS))])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_american_put_matches_reference():
    jm = hh.BlackScholesInputs(REF, 0.03, 100.0, hh.RectVolSurface(
        REF, jnp.asarray(TENORS), jnp.asarray(STRIKES), jnp.asarray(IVS), interp_strike="cubic"),
        dividend_yield=0.01)
    pm = ht.from_reference(jm)
    pde = hh.PDEMethod(dynamics=hh.LocalVolDynamics(), space_steps=120, time_steps=60)
    p_pde = dataclasses.replace(ht.from_reference(pde), device=CPU)
    # the American put: the mid-step Dupire rows and the exercise projection
    # (the Dirichlet rows are the CEV file's)
    payoff = hh.VanillaOption(110.0, EXPIRY, hh.American(), hh.Put(), hh.Spot())
    want = float(hh.solve(hh.PricingProblem(payoff, jm), pde).price)
    got = float(ht.solve(ht.PricingProblem(ht.from_reference(payoff), pm), p_pde).price)
    assert got == pytest.approx(want, rel=1e-10)


def test_flat_surface_is_black_scholes():
    """tests/unit/test_pde.py:258."""
    flat = ht.BlackScholesInputs(REF, 0.05, 100.0, 0.25)
    o = ht.VanillaOption(105.0, EXPIRY)
    lv = float(ht.solve(ht.PricingProblem(o, flat), ht.PDEMethod(
        ht.LocalVolDynamics(), 200, 64, device=CPU)).price)
    bs = float(ht.solve(ht.PricingProblem(o, flat), ht.BlackScholesAnalytic(device=CPU)).price)
    assert lv == pytest.approx(bs, abs=2e-3)


def test_term_structure_integrates_the_total_variance():
    """tests/unit/test_pde.py:269: vols in tenor only."""
    surf = ht.RectVolSurface(REF, torch.tensor([0.25, 0.5, 1.0]), torch.tensor([50.0, 200.0]),
                             torch.tensor([[0.15, 0.15], [0.20, 0.20], [0.25, 0.25]]))
    o = ht.VanillaOption(100.0, EXPIRY)
    lv = float(ht.solve(ht.PricingProblem(o, ht.BlackScholesInputs(REF, 0.03, 100.0, surf)),
                        ht.PDEMethod(ht.LocalVolDynamics(), 200, 100, device=CPU)).price)
    bs = float(ht.solve(ht.PricingProblem(o, ht.BlackScholesInputs(REF, 0.03, 100.0, 0.25)),
                        ht.BlackScholesAnalytic(device=CPU)).price)
    assert lv == pytest.approx(bs, abs=2e-3)


def test_dividend_schedule_is_refused():
    divs = ht.DividendSchedule((dt.date(2024, 6, 1),), torch.tensor([1.0], dtype=torch.float64))
    m = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2, dividends=divs)
    with pytest.raises(TypeError, match="LognormalDynamics"):
        ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY), m),
                 ht.PDEMethod(ht.LocalVolDynamics(), 40, 10, device=CPU))
