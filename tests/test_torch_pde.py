"""The 1-D finite-difference engine (methods/pde.py) against the JAX package
on the CPU.

Every route (European, American, Bermudan, digital, knock-out with either
rebate, the knock-in parity, a root already knocked) agrees with JAX's to
rel 1e-10 at 120 × 60 (the dividend jump conditions in
tests/test_torch_dividends.py),
and so do the frozen grid and the t = 0 value slice of ``PDESolution``;
with the guards.  The lognormal cases of tests/unit/test_pde.py, on the
port against its own closed forms and lattice, are in
tests/test_torch_pde_oracles.py."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import pde as jpde
from hedgehog_tpu_torch.methods import pde as ppde

REF = dt.date(2025, 1, 1)
EXP = dt.date(2026, 1, 1)
CPU = "cpu"
QUARTERS = tuple(dt.date(2025, m, 1) for m in (4, 7, 10))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pde(space=400, time=200, **kw):
    return ht.PDEMethod(space_steps=space, time_steps=time, device=CPU, **kw)


def _bs_mkt(sigma=0.2, spot=100.0, rate=0.05, q=0.0):
    return ht.BlackScholesInputs(REF, rate, spot, sigma, dividend_yield=q)


# -- every route against JAX's ------------------------------------------------------------

ROUTES = {
    "european call": (hh.VanillaOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot()), {}),
    "european put, carry": (hh.VanillaOption(95.0, EXP, hh.European(), hh.Put(), hh.Spot()),
                            dict(q=0.03)),
    "american put": (hh.VanillaOption(110.0, EXP, hh.American(), hh.Put(), hh.Spot()), {}),
    "bermudan put": (hh.VanillaOption(110.0, EXP, hh.Bermudan(QUARTERS), hh.Put(), hh.Spot()),
                     {}),
    "digital call": (hh.DigitalOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot(),
                                      cash=1.0), {}),
    "digital put": (hh.DigitalOption(105.0, EXP, hh.European(), hh.Put(), hh.Spot(),
                                     cash=2.0), {}),
    "up-out call": (hh.BarrierOption(100.0, EXP, 130.0, hh.European(), hh.Call(), hh.Spot(),
                                     hh.Up(), hh.KnockOut()), {}),
    "down-out put, rebate at hit": (hh.BarrierOption(
        100.0, EXP, 80.0, hh.European(), hh.Put(), hh.Spot(), hh.Down(), hh.KnockOut(),
        rebate=2.0, rebate_at_hit=True), {}),
    "american down-out call, rebate at expiry": (hh.BarrierOption(
        100.0, EXP, 85.0, hh.American(), hh.Call(), hh.Spot(), hh.Down(), hh.KnockOut(),
        rebate=1.0), {}),
    "up-in call, rebate (parity)": (hh.BarrierOption(
        100.0, EXP, 130.0, hh.European(), hh.Call(), hh.Spot(), hh.Up(), hh.KnockIn(),
        rebate=1.5), {}),
    "knocked root": (hh.BarrierOption(100.0, EXP, 80.0, hh.European(), hh.Put(), hh.Spot(),
                                      hh.Down(), hh.KnockOut(), rebate=3.0,
                                      rebate_at_hit=True), dict(spot=75.0)),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_matches_reference(name):
    payoff, kw = ROUTES[name]
    market = hh.BlackScholesInputs(REF, 0.05, kw.get("spot", 100.0), 0.2,
                                   dividend_yield=kw.get("q", 0.0))
    jprob = hh.PricingProblem(payoff, market)
    method = hh.PDEMethod(space_steps=120, time_steps=60)
    want = hh.solve(jprob, method)
    got = ht.solve(ht.from_reference(jprob), dataclasses.replace(ht.from_reference(method),
                                                                 device=CPU))
    assert isinstance(got, ht.PDESolution)
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    if want.grid_spots is None:
        assert got.grid_spots is None and got.grid_values is None
        return
    assert tuple(got.grid_spots.shape) == tuple(got.grid_values.shape) == (121,)
    np.testing.assert_allclose(got.grid_spots.numpy(), np.asarray(want.grid_spots), rtol=1e-12)
    np.testing.assert_allclose(got.grid_values.numpy(), np.asarray(want.grid_values),
                               rtol=1e-10, atol=1e-11)


def test_operator_matches_reference():
    """The Péclet-limited generator on a stretched grid, with per-row drift
    and kill (a batch of operators), to 1e-13."""
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.uniform(0.2, 2.0, 41))
    dcoef = 0.5 * 0.04 * x**2
    drift = rng.uniform(-3.0, 3.0, (3, 41)) * x
    kill = np.array([[0.01], [0.05], [-0.02]])
    want = jpde.convection_diffusion_operator(x, dcoef, drift, kill)
    got = ppde.convection_diffusion_operator(torch.tensor(x), torch.tensor(dcoef),
                                             torch.tensor(drift), torch.tensor(kill))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=1e-13)


# -- guards ---------------------------------------------------------------------------------


def test_pde_rejects_unsupported():
    mkt = _bs_mkt()
    pde = _pde(40, 10)
    o = ht.VanillaOption(100.0, EXP, ht.European(), ht.Call(), ht.Spot())
    with pytest.raises(TypeError, match="running state"):
        ht.solve(ht.PricingProblem(ht.AsianOption(100.0, EXP, 12), mkt), pde)
    with pytest.raises(TypeError, match="one contract per solve"):
        ht.solve(ht.PricingProblem(dataclasses.replace(o, strike=np.array([90.0, 100.0])), mkt),
                 pde)
    with pytest.raises(TypeError, match="evolves the spot"):
        ht.solve(ht.PricingProblem(dataclasses.replace(o, underlying=ht.Forward()), mkt), pde)
    with pytest.raises(TypeError, match="prices HestonInputs markets"):
        ht.solve(ht.PricingProblem(o, mkt), dataclasses.replace(pde, dynamics=ht.HestonDynamics()))
    with pytest.raises(TypeError, match="supports Lognormal/CEV/LocalVol"):
        ht.solve(ht.PricingProblem(o, mkt),
                 dataclasses.replace(pde, dynamics=ht.RoughBergomiDynamics()))
    with pytest.raises(TypeError, match="BlackScholesInputs"):
        ht.solve(ht.PricingProblem(o, ht.HestonInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3,
                                                      -0.7)), pde)
    ki_am = ht.BarrierOption(100.0, EXP, 130.0, ht.American(), ht.Call(), ht.Spot(), ht.Up(),
                             ht.KnockIn())
    with pytest.raises(TypeError, match="no in-out parity"):
        ht.solve(ht.PricingProblem(ki_am, mkt), pde)
    with pytest.raises(TypeError, match=r"one \(strike, barrier\) pair"):
        ht.solve(ht.PricingProblem(ht.BarrierOption(100.0, EXP, np.array([80.0, 85.0])), mkt),
                 pde)


def test_from_reference_carries_the_method():
    method = ht.from_reference(hh.PDEMethod(space_steps=64, time_steps=32, theta=0.6,
                                            rannacher=3, n_std=6.0, cluster=0.2))
    assert isinstance(method, ht.PDEMethod)
    assert (method.space_steps, method.time_steps, method.theta, method.rannacher,
            method.n_std, method.cluster) == (64, 32, 0.6, 3, 6.0, 0.2)
    assert method.device == "cuda"
