"""The bridge Monte Carlo barrier estimators against the port's own Heston
ADI: the check of tests/agreement/test_heston_barrier_pde.py (and of the
Richardson α = 0.75 in methods/bridge_mc.py) with the port on both sides.

A continuously monitored down-and-out call on three Heston markets (the
last Feller-violating, 2κθ = 0.08 < σ_v² = 0.81): the bridge estimator on
the conditional QE grid (per-segment no-cross factors on the sampled ∫V,
extrapolated at α = 0.75) within 25 bp of the ADI at its defaults (400 ×
64 × 200), the JAX test's bound; here at 2^16 QMC pairs × 64 steps, one
seed, where the JAX test averages two PRNG seeds of 2^18 pairs.  The
exact-transition grid (8 segments) within 1% as there."""

import datetime as dt

import pytest
import torch

import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
K, H = 100.0, 85.0
CPU = "cpu"
CASES = [(0.3, 2.0), (0.6, 2.0), (0.9, 1.0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prob(sigma_v, kappa):
    market = ht.HestonInputs(REF, 0.03, 100.0, 0.04, kappa, 0.04, sigma_v, -0.7)
    ko = ht.BarrierOption(K, EXPIRY, H, direction=ht.Down(), knock=ht.KnockOut())
    return ht.PricingProblem(ko, market)


def _adi(prob) -> float:
    return float(ht.solve(prob, ht.PDEMethod(ht.HestonDynamics(), device=CPU)).price)


@pytest.mark.parametrize("sigma_v,kappa", CASES)
def test_bridge_richardson_vs_adi_down_out_call(sigma_v, kappa):
    prob = _prob(sigma_v, kappa)
    cfg = ht.SimulationConfig(trajectories=1 << 16, steps=64, variance_reduction=ht.Antithetic(),
                              seed=0, qmc=True)
    mc = float(ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True),
                                            cfg, device=CPU)).price)
    pde = _adi(prob)
    assert abs(mc - pde) / pde < 25e-4, (
        f"bridge-MC {mc:.5f} vs ADI {pde:.5f}: {(mc - pde) / pde * 1e4:+.1f} bp "
        f"at sigma_v={sigma_v}")


def test_exact_transition_grid_prices_barriers():
    prob = _prob(0.3, 2.0)
    cfg = ht.SimulationConfig(trajectories=1 << 15, steps=8, variance_reduction=ht.Antithetic(),
                              seed=0)
    mc = float(ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonExactMixing(), cfg,
                                            device=CPU)).price)
    assert mc == pytest.approx(_adi(prob), rel=1e-2)
