"""The Heston 2-D ADI solver (methods/pde2d.py) against the JAX package on
the CPU.

Every route (European call and put, digital, American and Bermudan put,
up- and down-and-out with the rebate paid at expiry and at the hit, an
American knock-out, the European knock-in by parity, a knocked root and a
Feller-violating corner) agrees with JAX's ``solve_pde_heston`` to rel
1e-10 on equal frozen grids at 48 × 16 × 24 (spot × variance × time), and
so does the t = 0 value surface; the spot and V0 greeks by autograd equal
``jax.grad`` to 1e-8.  Each JAX solve compiles its own XLA program, so the
cases are few and small (tests/conftest.py records an XLA:CPU crash on the
large ADI program)."""

import dataclasses
import datetime as dt

import jax
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2025, 1, 1)
EXP = dt.date(2026, 1, 1)
CPU = "cpu"
MKT = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.05, 0.4, -0.7)
FELLER = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 1.0, 0.04, 1.0, -0.9)
QUARTERS = tuple(dt.date(2025, m, 1) for m in (4, 7, 10))
GRID = dict(space_steps=48, var_steps=16, time_steps=24)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_pde(**kw):
    return hh.PDEMethod(dynamics=hh.HestonDynamics(), **{**GRID, **kw})


def _port(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _barrier(k, h, cp, direction, knock=hh.KnockOut(), style=hh.European(), **kw):
    return hh.BarrierOption(k, EXP, h, style, cp, hh.Spot(), direction, knock, **kw)


ROUTES = {
    "european call": (hh.VanillaOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot()), MKT),
    "european put": (hh.VanillaOption(95.0, EXP, hh.European(), hh.Put(), hh.Spot()), MKT),
    "digital call": (hh.DigitalOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot(),
                                      cash=2.0), MKT),
    "american put": (hh.VanillaOption(110.0, EXP, hh.American(), hh.Put(), hh.Spot()), MKT),
    "bermudan put": (hh.VanillaOption(110.0, EXP, hh.Bermudan(QUARTERS), hh.Put(), hh.Spot()),
                     MKT),
    "up-out call, rebate at expiry": (_barrier(100.0, 130.0, hh.Call(), hh.Up(), rebate=1.0),
                                      MKT),
    "down-out call, rebate at hit": (_barrier(100.0, 85.0, hh.Call(), hh.Down(), rebate=2.0,
                                              rebate_at_hit=True), MKT),
    "american down-out put": (_barrier(100.0, 80.0, hh.Put(), hh.Down(), rebate=1.0,
                                       style=hh.American()), MKT),
    "up-in call, rebate (parity)": (_barrier(100.0, 130.0, hh.Call(), hh.Up(), hh.KnockIn(),
                                             rebate=1.5), MKT),
    "knocked root": (_barrier(100.0, 105.0, hh.Put(), hh.Down(), rebate=3.0,
                              rebate_at_hit=True), MKT),
    "feller-violating call": (hh.VanillaOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot()),
                              FELLER),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_matches_reference(name):
    payoff, market = ROUTES[name]
    jprob = hh.PricingProblem(payoff, market)
    want = hh.solve(jprob, _jax_pde())
    got = ht.solve(ht.from_reference(jprob), _port(_jax_pde()))
    assert isinstance(got, ht.PDESolution)
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    if want.grid_spots is None:
        assert got.grid_spots is None and got.grid_values is None
        return
    for g, w in zip(got.grid_spots, want.grid_spots):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0.0)
    assert tuple(got.grid_values.shape) == (GRID["var_steps"] + 1, GRID["space_steps"] + 1)
    np.testing.assert_allclose(got.grid_values.numpy(), np.asarray(want.grid_values),
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("field", ["spot", "V0"])
def test_autograd_greeks_match_jax_grad(field):
    """d price / d spot and d price / d V0 by autograd through the loop and
    the bicubic readout, against ``jax.grad`` (test_pde_heston.py:117), 1e-8."""
    payoff = hh.VanillaOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot())
    x0 = float(getattr(MKT, field))
    want = float(jax.grad(lambda x: hh.solve(
        hh.PricingProblem(payoff, dataclasses.replace(MKT, **{field: x})), _jax_pde()).price)(x0))
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    market = dataclasses.replace(ht.from_reference(MKT), **{field: x})
    price = ht.solve(ht.PricingProblem(ht.from_reference(payoff), market), _port(_jax_pde())).price
    (got,) = torch.autograd.grad(price, x)
    assert float(got) == pytest.approx(want, rel=1e-8)


def test_guards():
    method = _port(_jax_pde())
    ki = ht.BarrierOption(100.0, EXP, 130.0, ht.American(), ht.Call(), ht.Spot(), ht.Up(),
                          ht.KnockIn())
    with pytest.raises(TypeError, match="early-exercise knock-ins"):
        ht.solve(ht.PricingProblem(ki, ht.from_reference(MKT)), method)
    bs = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
    call = ht.VanillaOption(100.0, EXP, ht.European(), ht.Call(), ht.Spot())
    with pytest.raises(TypeError, match="HestonInputs"):
        ht.solve(ht.PricingProblem(call, bs), method)
    grid = ht.VanillaOption(np.array([90.0, 100.0]), EXP, ht.European(), ht.Call(), ht.Spot())
    with pytest.raises(TypeError, match="one contract per solve"):
        ht.solve(ht.PricingProblem(grid, ht.from_reference(MKT)), method)


def test_from_reference_carries_var_steps():
    method = ht.from_reference(hh.PDEMethod(dynamics=hh.HestonDynamics(), var_steps=24))
    assert method.var_steps == 24 and isinstance(method.dynamics, ht.HestonDynamics)
    assert ht.PDEMethod().var_steps == 64 and ht.PDEMethod().device == "cuda"
