"""The PDE's discrete-dividend jump conditions against the JAX package on
the CPU: V(t⁻, S) = V(t⁺, S − D) at each ex-date snapped to the grid, with
exercise just before the drop (American, and a Bermudan whose date is the
ex-date) and a knock-out's Dirichlet row pinned again, at 120 × 60: the
price to rel 1e-10, the frozen grid to 1e-12 and the t = 0 slice to
1e-10."""

import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
PDE = ht.PDEMethod(space_steps=120, time_steps=60, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_PDE_DIVS = hh.DividendSchedule([dt.date(2024, 6, 1)], [5.0])
SPOT_MODEL_PDE = {
    "american call": hh.VanillaOption(100.0, EXPIRY, hh.American(), hh.Call(), hh.Spot()),
    "bermudan call on the ex-date": hh.VanillaOption(
        100.0, EXPIRY, hh.Bermudan([dt.date(2024, 6, 1)]), hh.Call(), hh.Spot()),
    "european put": hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Put(), hh.Spot()),
    "american up-out call": hh.BarrierOption(100.0, EXPIRY, 130.0, hh.American(), hh.Call(),
                                             hh.Spot(), hh.Up(), hh.KnockOut()),
}


@pytest.mark.parametrize("name", sorted(SPOT_MODEL_PDE))
def test_spot_model_pde_matches_reference(name):
    jprob = hh.PricingProblem(SPOT_MODEL_PDE[name], hh.BlackScholesInputs(
        REF, 0.05, 100.0, 0.25, dividends=_PDE_DIVS))
    method = hh.PDEMethod(space_steps=120, time_steps=60)
    want = hh.solve(jprob, method)
    got = ht.solve(ht.from_reference(jprob), PDE)
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    np.testing.assert_allclose(got.grid_spots.numpy(), np.asarray(want.grid_spots), rtol=1e-12)
    np.testing.assert_allclose(got.grid_values.numpy(), np.asarray(want.grid_values),
                               rtol=1e-10, atol=1e-11)
