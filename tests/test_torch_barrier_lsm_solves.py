"""The knock-out and knock-in LSM solves against the JAX package on the
CPU, on the same QMC grids (GBM log-Euler with and without dividends; the
conditional Heston grid in tests/test_torch_barrier_lsm_heston.py): the
stopping steps equal, the price to rel 1e-10, the spot grid to 1e-12."""

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
QUARTERS = (dt.date(2024, 4, 1), dt.date(2024, 7, 1), dt.date(2024, 10, 1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=1e-13)


BS = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.25)
BS_DIVS = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.25, dividends=hh.DividendSchedule(
    [dt.date(2024, 6, 1)], [3.0]))


def _jmc(paths=1024, steps=16):
    cfg = hh.SimulationConfig(paths, steps, hh.Antithetic(), 0, True)
    return hh.MonteCarlo(hh.LognormalDynamics(), hh.EulerMaruyama(), cfg)


def _port_lsm(method):
    port = ht.from_reference(method)
    return dataclasses.replace(port, mc_method=dataclasses.replace(port.mc_method, device=CPU))


SOLVES = {
    "gbm am down-out put": (hh.BarrierOption(110.0, EXPIRY, 80.0, hh.American(), hh.Put()), BS),
    "gbm am up-out call, rebate at hit": (hh.BarrierOption(
        100.0, EXPIRY, 120.0, hh.American(), hh.Call(), direction=hh.Up(), rebate=3.0,
        rebate_at_hit=True), BS),
    "gbm am up-out put, rebate at expiry": (hh.BarrierOption(
        100.0, EXPIRY, 120.0, hh.American(), hh.Put(), direction=hh.Up(), rebate=3.0), BS),
    "gbm bermudan up-out call, rebate at hit": (hh.BarrierOption(
        100.0, EXPIRY, 120.0, hh.Bermudan(QUARTERS), hh.Call(), direction=hh.Up(), rebate=3.0,
        rebate_at_hit=True), BS),
    "gbm am down-in put, rebate": (hh.BarrierOption(
        110.0, EXPIRY, 85.0, hh.American(), hh.Put(), knock=hh.KnockIn(), rebate=2.0), BS),
    "gbm bermudan down-in put": (hh.BarrierOption(
        110.0, EXPIRY, 85.0, hh.Bermudan(QUARTERS), hh.Put(), knock=hh.KnockIn()), BS),
    "dividends am down-in put": (hh.BarrierOption(
        110.0, EXPIRY, 85.0, hh.American(), hh.Put(), knock=hh.KnockIn()), BS_DIVS),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_barrier_lsm_solve_matches_reference(name):
    payoff, market = SOLVES[name]
    jprob = hh.PricingProblem(payoff, market)
    method = hh.LSM(_jmc(), 4)
    want = hh.solve(jprob, method)
    got = ht.solve(ht.from_reference(jprob), _port_lsm(method))
    np.testing.assert_array_equal(got.stopping_info[0].numpy(), np.asarray(want.stopping_info[0]))
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    _close(got.spot_paths, want.spot_paths, 1e-12)
