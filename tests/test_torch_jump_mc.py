"""The jump and variance-gamma samplers (methods/jump_mc.py) against the JAX
package on the CPU.

Under QMC the port draws JAX's Sobol' points, so every per-path value is
held to JAX's at 1e-10: the Merton, Kou and variance-gamma exact terminal
prices and Euler grids (the variance-gamma grid at a per-step shape below
1, through the boosting identity), the Bates mixing values (JAX's
non-interleaved layout) and the Bates Euler grid, antithetic and not.
Autograd through the Merton ``solve`` (the likelihood-ratio surrogate
for λ, pathwise for the rest) equals ``jax.grad`` on the same points to
1e-8.  Then the guards, as JAX raises them, and the Bates λ = 0 corner,
which on the port's Philox streams is the Heston estimator path by path."""

import dataclasses
import datetime as dt

import jax
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import heston_euler, heston_qe_mixing, jump_mc

REF = dt.date(2025, 1, 1)
EXP = dt.date(2026, 1, 1)
CPU = "cpu"
CALL = hh.VanillaOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot())
MERTON = hh.MertonInputs(REF, 0.03, 100.0, 0.2, 0.5, -0.1, 0.15, dividend_yield=0.01)
KOU = hh.KouInputs(REF, 0.03, 100.0, 0.2, 1.0, 0.4, 10.0, 5.0, dividend_yield=0.01)
VG = hh.VarianceGammaInputs(REF, 0.03, 100.0, 0.2, 0.3, -0.14)
BATES = hh.BatesInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.5, -0.7, 0.3, -0.1, 0.1)

#: name: (market, dynamics, strategy, steps, what is compared)
CASES = {
    "merton exact": (MERTON, hh.MertonJumpDynamics(), hh.MertonExact(), 1, "terminal"),
    "merton grid": (MERTON, hh.MertonJumpDynamics(), hh.EulerMaruyama(), 4, "grid"),
    "kou exact": (KOU, hh.KouJumpDynamics(), hh.KouExact(), 1, "terminal"),
    "kou grid": (KOU, hh.KouJumpDynamics(), hh.EulerMaruyama(), 3, "grid"),
    "vg exact": (VG, hh.VarianceGammaDynamics(), hh.VarianceGammaExact(), 1, "terminal"),
    "vg grid, boosted": (VG, hh.VarianceGammaDynamics(), hh.EulerMaruyama(), 12, "grid"),
    "bates mixing": (BATES, hh.BatesDynamics(), hh.HestonQE(conditional=True), 6, "values"),
    "bates grid": (BATES, hh.BatesDynamics(), hh.EulerMaruyama(), 4, "grid"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _draws(jprob, jmethod, what):
    prob, method = ht.from_reference(jprob), _port(jmethod)
    if what == "terminal":
        return (np.asarray(jmc.simulate_terminal_prices(jprob, jmethod)),
                ht.simulate_terminal_prices(prob, method))
    if what == "grid":
        return (np.asarray(jmc.simulate_price_grid(jprob, jmethod)),
                ht.simulate_price_grid(prob, method))
    return (np.asarray(jmc.simulate_conditional_values(jprob, jmethod)),
            ht.simulate_conditional_values(prob, method))


@pytest.mark.parametrize("name,anti", [(n, True) for n in sorted(CASES)]
                         + [(n, False) for n in ("merton exact", "vg grid, boosted",
                                                 "bates mixing")])
def test_qmc_values_match_reference_per_path(name, anti):
    market, dyn, strat, steps, what = CASES[name]
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    jprob = hh.PricingProblem(CALL, market)
    jmethod = hh.MonteCarlo(dyn, strat, hh.SimulationConfig(512, steps, vr, 7, True))
    want, got = _draws(jprob, jmethod, what)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_qmc_point_offset_matches_reference():
    jprob = hh.PricingProblem(CALL, MERTON)
    jmethod = hh.MonteCarlo(hh.MertonJumpDynamics(), hh.EulerMaruyama(),
                            hh.SimulationConfig(256, 3, hh.Antithetic(), 2, True))
    want = np.asarray(jmc.simulate_price_grid(jprob, jmethod, point_offset=1000))
    got = ht.simulate_price_grid(ht.from_reference(jprob), _port(jmethod), point_offset=1000)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("field", ["jump_intensity", "jump_std", "spot"])
def test_merton_solve_gradients_match_jax_grad(field):
    """λ through the frozen-count likelihood-ratio surrogate, the others
    pathwise, on JAX's QMC points: 1e-8."""
    jmethod = hh.MonteCarlo(hh.MertonJumpDynamics(), hh.MertonExact(),
                            hh.SimulationConfig(4096, 1, hh.Antithetic(), 3, True))
    x0 = float(getattr(MERTON, field))
    want = float(jax.grad(lambda x: hh.solve(
        hh.PricingProblem(CALL, dataclasses.replace(MERTON, **{field: x})), jmethod).price)(x0))
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    market = dataclasses.replace(ht.from_reference(MERTON), **{field: x})
    price = ht.solve(ht.PricingProblem(ht.from_reference(CALL), market), _port(jmethod)).price
    (got,) = torch.autograd.grad(price, x)
    assert float(got) == pytest.approx(want, rel=1e-8)


def test_merton_mc_path_values_match_solve_and_reference():
    jprob = hh.PricingProblem(CALL, MERTON)
    jmethod = hh.MonteCarlo(hh.MertonJumpDynamics(), hh.MertonExact(),
                            hh.SimulationConfig(1024, 1, hh.Antithetic(), 5, True))
    want = np.asarray(jmc.mc_path_values(jprob, jmethod))
    got = ht.mc_path_values(ht.from_reference(jprob), _port(jmethod))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    sol = ht.solve(ht.from_reference(jprob), _port(jmethod))
    assert torch.equal(sol.ensemble, got)


# -- guards -------------------------------------------------------------------------------


def _solve(market, dyn, strat, steps=2, qmc=False, payoff=None):
    method = ht.MonteCarlo(dyn, strat, ht.SimulationConfig(256, steps, seed=0, qmc=qmc),
                           device=CPU)
    return ht.solve(ht.PricingProblem(payoff or ht.from_reference(CALL), market), method)


@pytest.mark.parametrize("dyn,market", [
    (ht.MertonJumpDynamics(), MERTON), (ht.KouJumpDynamics(), KOU),
    (ht.VarianceGammaDynamics(), VG), (ht.BatesDynamics(), BATES)],
    ids=["merton", "kou", "vg", "bates"])
def test_jump_dynamics_have_no_fused_kernel(dyn, market):
    market = ht.from_reference(market)
    with pytest.raises(TypeError, match="no fused kernel"):
        _solve(market, dyn, ht.EulerMaruyama(use_kernel=True))
    with pytest.raises(ValueError, match="qmc=True"):
        _solve(market, dyn, ht.EulerMaruyama(use_kernel=True), qmc=True)
    # the Brownian-bridge barrier estimators refuse jump grids
    doc = ht.BarrierOption(100.0, EXP, 80.0)
    with pytest.raises(TypeError, match="grids need"):
        _solve(market, dyn, ht.EulerMaruyama(), payoff=doc)


def test_bates_and_merton_guards():
    bates = ht.from_reference(BATES)
    with pytest.raises(TypeError, match="Heston-only"):
        _solve(bates, ht.BatesDynamics(), ht.HestonQE(conditional=True, use_kernel=True))
    with pytest.raises(TypeError, match=r"HestonQE\(conditional=True\)"):
        _solve(bates, ht.BatesDynamics(), ht.HestonExactMixing())
    merton = ht.from_reference(MERTON)
    with pytest.raises(TypeError, match="unsupported"):
        _solve(merton, ht.MertonJumpDynamics(), ht.HestonQE())
    hot = dataclasses.replace(merton, jump_intensity=80.0)
    with pytest.raises(ValueError, match="Poisson trip count"):
        _solve(hot, ht.MertonJumpDynamics(), ht.MertonExact())
    assert jump_mc.merton_poisson_trips(torch.tensor(80.0)) == 64  # a tensor rate: unchecked
    with pytest.raises(TypeError, match="conditional"):
        ht.simulate_price_grid(ht.PricingProblem(ht.from_reference(CALL), bates), ht.MonteCarlo(
            ht.BatesDynamics(), ht.HestonQE(conditional=True), ht.SimulationConfig(16, 2),
            device=CPU))


def test_bates_zero_intensity_is_heston_path_by_path():
    """At λ = 0 the Bates mixing values and Euler grid, on the Philox
    streams, are the Heston QE mixing estimator's and Heston Euler grid's
    bit for bit (they draw the same variance stream; the jump terms add
    exact zeros)."""
    bates = dataclasses.replace(ht.from_reference(BATES), jump_intensity=0.0)
    heston = ht.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.5, -0.7)
    call = ht.from_reference(CALL)
    cfg = ht.SimulationConfig(1024, 5, ht.Antithetic(), 11)
    got = jump_mc.bates_qe_mixing_values(ht.PricingProblem(call, bates), cfg, device=CPU)
    want = heston_qe_mixing.heston_qe_mixing_values(ht.PricingProblem(call, heston), cfg,
                                                    device=CPU)
    assert torch.equal(got, want)
    got = jump_mc.bates_euler_paths(ht.PricingProblem(call, bates), cfg, device=CPU,
                                    return_grid=True)
    want = heston_euler.heston_euler_paths(ht.PricingProblem(call, heston), cfg, device=CPU,
                                           return_grid=True)
    assert torch.equal(got, want)
