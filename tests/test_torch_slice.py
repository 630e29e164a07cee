"""The main path end to end: ``hedgehog_tpu_torch.solve`` against
``hedgehog_tpu.solve`` on the bench market (bench.py), with the problem and
method built in JAX and carried across by ``from_reference``; and the
slice's error paths."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
MARKET = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)


def _problem(strike=100.0, cp=hh.Call(), exercise=hh.European()):
    return hh.PricingProblem(hh.VanillaOption(strike, EXPIRY, exercise, cp, hh.Spot()), MARKET)


def _method(use_kernel, trajectories=4096, seed=2):
    cfg = hh.SimulationConfig(trajectories=trajectories, steps=2,
                              variance_reduction=hh.Antithetic(), seed=seed, qmc=True)
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(use_kernel=use_kernel), cfg)


def _cpu(method):
    """The port's counterpart of a JAX method, run on the CPU."""
    return dataclasses.replace(ht.from_reference(method), device="cpu")


@pytest.mark.parametrize("strike,cp", [(100.0, hh.Call()), (90.0, hh.Put()),
                                       (np.array([90.0, 100.0, 110.0]), hh.Call())])
def test_pure_estimator_solve_matches_reference(strike, cp):
    """qmc=True, same seed: the same Sobol' points on both sides, float64
    throughout, so prices agree to rel 1e-9 (a strike grid prices every
    strike from one path set on both sides)."""
    prob, method = _problem(strike, cp), _method(False)
    want = np.asarray(hh.solve(prob, method).price)
    got = ht.solve(ht.from_reference(prob), _cpu(method))
    assert got.price.shape == want.shape
    np.testing.assert_allclose(got.price.numpy(), want, rtol=1e-9)
    assert got.ensemble.dtype == torch.float64


def test_kernel_strategy_on_cpu_matches_reference():
    """use_kernel=True on CPU tensors runs the fp32 twin of the CUDA kernel
    (Beasley-Springer-Moro normals, polished reciprocals); the JAX package
    off the TPU prices the same Sobol' points with its float64 estimator:
    rel 1e-5 covers the fp32 arithmetic over 8192 paths."""
    prob, method = _problem(), _method(True)
    want = float(hh.solve(prob, method).price)
    got = ht.solve(ht.from_reference(prob), _cpu(method))
    assert float(got.price) == pytest.approx(want, rel=1e-5)
    assert got.ensemble.shape == (2, 4096) and bool(torch.isfinite(got.ensemble).all())


def test_main_path_against_carr_madan():
    """PRNG stream, 16384 pairs: within 4 standard errors plus 1 bp of
    scheme bias of the port's own Carr-Madan price."""
    prob = ht.from_reference(_problem())
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device="cpu")).price)
    cfg = ht.SimulationConfig(16384, 2, ht.Antithetic(), 4, False)
    sol = ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonExactMixing(True), cfg,
                                       device="cpu"))
    disc = float(ht.df(prob.market_inputs.rate, prob.payoff.expiry))
    se = disc * float(sol.ensemble.mean(dim=0).std()) / np.sqrt(16384)
    assert abs(float(sol.price) - cm) <= 4 * se + 1e-4 * cm


def test_american_payoff_raises():
    prob = ht.from_reference(_problem(exercise=hh.American()))
    for method in (_cpu(_method(True)), _cpu(_method(False)),
                   ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device="cpu"),
                   ht.MonteCarlo(ht.HestonDynamics(), ht.EulerMaruyama(True),
                                 ht.SimulationConfig(64, 4), device="cpu")):
        with pytest.raises(TypeError, match="European"):
            ht.solve(prob, method)


def test_strike_grid_with_kernel_raises():
    prob = ht.from_reference(_problem(np.array([90.0, 110.0])))
    with pytest.raises(TypeError, match="strike grids"):
        ht.solve(prob, _cpu(_method(True)))


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = ht.from_reference(_problem())
    method = dataclasses.replace(ht.from_reference(_method(True)), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.solve(prob, method)


def test_unsupported_combinations_raise():
    prob = ht.from_reference(_problem())
    with pytest.raises(TypeError, match="never materializes"):
        ht.simulate_terminal_prices(prob, _cpu(_method(True)))
    with pytest.raises(TypeError, match="_gbm_euler_paths, is not ported"):
        ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(),
                                     ht.SimulationConfig(64, 4), device="cpu"))
    with pytest.raises(TypeError, match="unsupported"):
        ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.BlackScholesExact(),
                                     ht.SimulationConfig(64, 4), device="cpu"))
    with pytest.raises(TypeError, match="conditional Monte Carlo"):
        ht.simulate_conditional_values(
            prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.HestonExactMixing(), device="cpu"))
    with pytest.raises(ValueError, match="period"):
        ht.SimulationConfig(trajectories=2**30 + 1, qmc=True)
