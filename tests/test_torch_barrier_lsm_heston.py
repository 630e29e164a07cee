"""The knock-out and knock-in LSM solves on the conditional Heston QE grid
(the joint (S, V) basis; the knock-in's never-hit survival with its
Richardson pair) against the JAX package on the CPU, on the same QMC
points: the stopping steps equal, the price to rel 1e-10."""

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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=1e-13)


HESTON = hh.HestonInputs(REF, 0.05, 100.0, 0.0625, 2.0, 0.0625, 0.4, -0.6)


def _jmc(paths=1024, steps=16):
    cfg = hh.SimulationConfig(paths, steps, hh.Antithetic(), 0, True)
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg)


def _port_lsm(method):
    port = ht.from_reference(method)
    return dataclasses.replace(port, mc_method=dataclasses.replace(port.mc_method, device=CPU))


SOLVES = {
    "heston am down-out put": (hh.BarrierOption(
        110.0, EXPIRY, 80.0, hh.American(), hh.Put()), HESTON),
    "heston am down-in put, rebate (Richardson)": (hh.BarrierOption(
        110.0, EXPIRY, 85.0, hh.American(), hh.Put(), knock=hh.KnockIn(), rebate=2.0), HESTON),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_heston_barrier_lsm_solve_matches_reference(name):
    payoff, market = SOLVES[name]
    jprob = hh.PricingProblem(payoff, market)
    method = hh.LSM(_jmc(), 3)
    want = hh.solve(jprob, method)
    got = ht.solve(ht.from_reference(jprob), _port_lsm(method))
    np.testing.assert_array_equal(got.stopping_info[0].numpy(), np.asarray(want.stopping_info[0]))
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    _close(got.spot_paths, want.spot_paths, 1e-12)
