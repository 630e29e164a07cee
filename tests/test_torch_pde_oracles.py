"""The 1-D finite-difference engine (methods/pde.py) on the port alone, on
the CPU: the lognormal cases of tests/unit/test_pde.py at their sizes,
against the port's Black-Scholes closed forms (Reiner–Rubinstein for the
barriers) and its CRR lattice, autograd greeks through the frozen grid
included."""

import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu_torch as ht

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


def _price(payoff, market, method) -> float:
    return float(ht.solve(ht.PricingProblem(payoff, market), method).price)


BS = ht.BlackScholesAnalytic(device=CPU)



def test_pde_european_matches_analytic():
    mkt = _bs_mkt()
    for strike, cp in [(90.0, ht.Call()), (100.0, ht.Call()), (100.0, ht.Put()),
                       (110.0, ht.Put())]:
        o = ht.VanillaOption(strike, EXP, ht.European(), cp, ht.Spot())
        np.testing.assert_allclose(_price(o, mkt, _pde()), _price(o, mkt, BS), atol=6e-4)


def test_pde_put_call_parity_and_dividend_yield():
    mkt = _bs_mkt(q=0.03)
    call = ht.VanillaOption(100.0, EXP, ht.European(), ht.Call(), ht.Spot())
    put = ht.VanillaOption(100.0, EXP, ht.European(), ht.Put(), ht.Spot())
    pc, pp = _price(call, mkt, _pde()), _price(put, mkt, _pde())
    D = float(ht.df(mkt.rate, call.expiry))
    np.testing.assert_allclose(pc - pp, 100.0 * np.exp(-0.03) - 100.0 * D, atol=1e-3)
    np.testing.assert_allclose(pc, _price(call, mkt, BS), atol=6e-4)


def test_pde_solution_grid_slice_is_exposed():
    o = ht.VanillaOption(100.0, EXP, ht.European(), ht.Call(), ht.Spot())
    sol = ht.solve(ht.PricingProblem(o, _bs_mkt()), _pde(200, 64))
    assert sol.grid_spots.shape == sol.grid_values.shape == (201,)
    assert not sol.grid_spots.requires_grad
    assert bool(torch.all(torch.diff(sol.grid_values) >= -1e-9))


def test_pde_american_put_vs_crr():
    mkt = _bs_mkt()
    am = ht.VanillaOption(110.0, EXP, ht.American(), ht.Put(), ht.Spot())
    p_pde = _price(am, mkt, _pde(400, 400))
    np.testing.assert_allclose(p_pde, _price(am, mkt, ht.CoxRossRubinsteinMethod(
        2000, device=CPU)), rtol=1e-3)
    eu = ht.VanillaOption(110.0, EXP, ht.European(), ht.Put(), ht.Spot())
    assert p_pde > _price(eu, mkt, _pde())


def test_pde_bermudan_brackets_and_degenerates():
    mkt = _bs_mkt()
    berm = ht.VanillaOption(110.0, EXP, ht.Bermudan(QUARTERS), ht.Put(), ht.Spot())
    eu = ht.VanillaOption(110.0, EXP, ht.European(), ht.Put(), ht.Spot())
    am = ht.VanillaOption(110.0, EXP, ht.American(), ht.Put(), ht.Spot())
    pde = _pde(300, 120)
    p_b, p_e, p_a = (_price(o, mkt, pde) for o in (berm, eu, am))
    assert p_e - 1e-9 <= p_b <= p_a + 1e-9
    berm0 = ht.VanillaOption(110.0, EXP, ht.Bermudan(()), ht.Put(), ht.Spot())
    np.testing.assert_allclose(_price(berm0, mkt, pde), p_e, rtol=1e-12)
    np.testing.assert_allclose(p_b, _price(berm, mkt, ht.CoxRossRubinsteinMethod(
        1200, device=CPU)), rtol=2e-3)


def test_pde_digital_matches_analytic():
    mkt = _bs_mkt()
    dig = ht.DigitalOption(100.0, EXP, ht.European(), ht.Call(), ht.Spot(), cash=1.0)
    np.testing.assert_allclose(_price(dig, mkt, _pde(600, 300)), _price(dig, mkt, BS),
                               atol=5e-4)


def test_pde_knock_out_barriers_vs_reiner_rubinstein():
    mkt = _bs_mkt()
    cases = [
        ht.BarrierOption(100.0, EXP, 130.0, ht.European(), ht.Call(), ht.Spot(), ht.Up(),
                         ht.KnockOut()),
        ht.BarrierOption(100.0, EXP, 80.0, ht.European(), ht.Put(), ht.Spot(), ht.Down(),
                         ht.KnockOut(), rebate=2.0, rebate_at_hit=True),
        ht.BarrierOption(100.0, EXP, 85.0, ht.European(), ht.Call(), ht.Spot(), ht.Down(),
                         ht.KnockOut(), rebate=1.0),
    ]
    for bo in cases:
        np.testing.assert_allclose(_price(bo, mkt, _pde()), _price(bo, mkt, BS), atol=8e-4)


def test_pde_knock_in_parity():
    mkt = _bs_mkt()
    ki = ht.BarrierOption(100.0, EXP, 130.0, ht.European(), ht.Call(), ht.Spot(), ht.Up(),
                          ht.KnockIn())
    np.testing.assert_allclose(_price(ki, mkt, _pde()), _price(ki, mkt, BS), atol=8e-4)


def test_pde_american_knock_out_vs_crr():
    bo = ht.BarrierOption(100.0, EXP, 80.0, ht.American(), ht.Put(), ht.Spot(), ht.Down(),
                          ht.KnockOut())
    mkt = _bs_mkt()
    np.testing.assert_allclose(_price(bo, mkt, _pde(400, 400)), _price(
        bo, mkt, ht.CoxRossRubinsteinMethod(2000, device=CPU)), rtol=2e-3)


def test_pde_spot_beyond_barrier_is_knocked():
    bo = ht.BarrierOption(100.0, EXP, 80.0, ht.European(), ht.Put(), ht.Spot(), ht.Down(),
                          ht.KnockOut(), rebate=3.0, rebate_at_hit=True)
    np.testing.assert_allclose(_price(bo, _bs_mkt(spot=75.0), _pde()), 3.0, rtol=1e-12)


def test_pde_autograd_greeks_match_analytic():
    """Delta and vega through the frozen grid, the coefficients and the
    cubic readout (autograd), and gamma, against Black-Scholes."""
    o = ht.VanillaOption(100.0, EXP, ht.European(), ht.Call(), ht.Spot())

    def grads(method, create_graph=False):
        spot = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
        sigma = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
        price = ht.solve(ht.PricingProblem(o, ht.BlackScholesInputs(REF, 0.05, spot, sigma)),
                         method).price
        delta, vega = torch.autograd.grad(price, (spot, sigma), create_graph=create_graph)
        gamma = (torch.autograd.grad(delta, spot)[0] if create_graph else None)
        return delta, vega, gamma

    d_p, v_p, g_p = grads(_pde(), True)
    d_b, v_b, g_b = grads(BS, True)
    np.testing.assert_allclose(float(d_p.detach()), float(d_b.detach()), rtol=2e-4)
    np.testing.assert_allclose(float(v_p.detach()), float(v_b.detach()), rtol=2e-4)
    np.testing.assert_allclose(float(g_p), float(g_b), rtol=1e-3)


def test_pde_strike_loop_matches_analytic():
    mkt = _bs_mkt()
    pde = _pde(200, 64)
    for k in (80.0, 90.0, 100.0, 110.0, 120.0):
        o = ht.VanillaOption(k, EXP, ht.European(), ht.Call(), ht.Spot())
        np.testing.assert_allclose(_price(o, mkt, pde), _price(o, mkt, BS), atol=2e-3)
