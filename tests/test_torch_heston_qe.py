"""The QE variance step (models/heston_qe.py) and the float64 QE mixing
estimator behind ``MonteCarlo(HestonDynamics(), HestonQE(conditional=True))``
against the JAX package, with inputs made from a numpy seed and problems
carried across by ``from_reference``; and the strategy's dispatch."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.models import heston_qe as jm
from hedgehog_tpu_torch.models import heston_qe as pm

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
MARKET = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)


def _problem(strike=100.0, cp=hh.Call()):
    return hh.PricingProblem(hh.VanillaOption(strike, EXPIRY, hh.European(), cp, hh.Spot()),
                             MARKET)


def _method(use_kernel=False, trajectories=2048, steps=5, seed=3, qmc=True, conditional=True):
    cfg = hh.SimulationConfig(trajectories=trajectories, steps=steps,
                              variance_reduction=hh.Antithetic(), seed=seed, qmc=qmc)
    return hh.MonteCarlo(hh.HestonDynamics(),
                         hh.HestonQE(use_kernel=use_kernel, conditional=conditional), cfg)


def _cpu(method):
    """The port's counterpart of a JAX method, run on the CPU."""
    return dataclasses.replace(ht.from_reference(method), device="cpu")


@pytest.mark.parametrize("match_gammas", [False, True])
def test_qe_constants_match_reference(match_gammas):
    args = (2.0, 0.04, 0.3, -0.7, 0.03, 0.25)
    want = jm.qe_constants(*args, match_gammas=match_gammas)
    got = pm.qe_constants(*args, match_gammas=match_gammas)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12, err_msg=k)


def _step_inputs():
    """Variance states and draws covering both ψ branches (small and large V
    against θ), the u ≤ p plateau of the exponential branch (u near 0), and
    the ψ and m floors (constants with a vanishing s2 and a vanishing mean)."""
    rng = np.random.default_rng(20261016)
    v = np.concatenate([rng.uniform(0.0, 0.2, 64), rng.uniform(0.0, 1e-4, 64), [0.0, 1e-12]])
    z = rng.standard_normal(v.size)
    u = np.concatenate([rng.uniform(0.0, 1.0, 96), rng.uniform(0.0, 0.05, v.size - 96)])
    base = jm.qe_constants(2.0, 0.04, 0.3, -0.7, 0.03, 0.1)
    wild = jm.qe_constants(6.21, 0.019, 0.61, -0.7, 0.03, 0.5)  # Feller-violating
    floors = dict(base, c_s2_v=0.0, c_s2_c=1e-40)  # ψ at its 1e-12 floor
    tiny_m = dict(base, theta=1e-31, e=0.5)  # m below the 1e-30 floor where v = 0
    return v, z, u, (base, wild, floors, tiny_m)


def test_qe_v_steps_match_reference():
    """qe_v_step and qe_v_step_with_coeffs (vn, cm, cs) to rtol 1e-12 (float64
    on both sides, same operation order; exact zeros on the plateaus)."""
    v, z, u, consts = _step_inputs()
    branches = set()
    for c in consts:
        pc = {k: torch.tensor(np.asarray(x), dtype=torch.float64) for k, x in c.items()}
        jc = {k: jnp.asarray(x) for k, x in c.items()}
        vt, zt, ut = (torch.as_tensor(x) for x in (v, z, u))
        want = np.asarray(jm.qe_v_step(jnp.asarray(v), jnp.asarray(z), jnp.asarray(u), jc))
        np.testing.assert_allclose(pm.qe_v_step(vt, zt, ut, pc).numpy(), want, rtol=1e-12,
                                   atol=1e-300)
        jw = jm.qe_v_step_with_coeffs(jnp.asarray(v), jnp.asarray(z), jnp.asarray(u), jc)
        pw = pm.qe_v_step_with_coeffs(vt, zt, ut, pc)
        for name, g, w in zip(("vn", "cm", "cs"), pw, jw):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-300,
                                       err_msg=name)
        _, use_quad, *_ = pm._qe_v_draw(vt, zt, ut, pc)
        branches |= set(use_quad.tolist())
    assert branches == {True, False}


@pytest.mark.parametrize("strike,cp", [(100.0, hh.Call()), (90.0, hh.Put()),
                                       (np.array([90.0, 100.0, 110.0]), hh.Call())],
                         ids=["atm_call", "otm_put", "strike_grid"])
def test_pure_estimator_solve_matches_reference(strike, cp):
    """qmc=True, same seed: the same Sobol' points on both sides, float64
    throughout, so prices agree to rel 1e-9 (a strike grid prices every
    strike from one path set on both sides)."""
    prob, method = _problem(strike, cp), _method()
    want = np.asarray(hh.solve(prob, method).price)
    got = ht.solve(ht.from_reference(prob), _cpu(method))
    assert got.price.shape == want.shape
    np.testing.assert_allclose(got.price.numpy(), want, rtol=1e-9)
    assert got.ensemble.dtype == torch.float64


def test_values_match_reference_per_path():
    """The per-path values of the float64 estimator, QMC with a point offset:
    rel 1e-9 path by path."""
    from hedgehog_tpu.methods.montecarlo import _heston_qe_mixing_values
    from hedgehog_tpu_torch.methods.heston_qe_mixing import heston_qe_mixing_values

    prob, method = _problem(), _method(steps=4)
    want = np.asarray(_heston_qe_mixing_values(prob, method.config, jax.random.PRNGKey(3),
                                               point_offset=4096))
    got = heston_qe_mixing_values(ht.from_reference(prob), ht.from_reference(method.config),
                                  point_offset=4096, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


def test_kernel_strategy_on_cpu_matches_reference():
    """use_kernel=True on CPU tensors runs the fp32 twin of the CUDA kernel
    (Beasley-Springer-Moro normals, polished reciprocals); the JAX package
    off the TPU prices the same Sobol' points with its float64 estimator:
    rel 1e-5 covers the fp32 arithmetic over 8192 paths."""
    prob, method = _problem(), _method(True, trajectories=4096, steps=11)
    want = float(hh.solve(prob, method).price)
    got = ht.solve(ht.from_reference(prob), _cpu(method))
    assert float(got.price) == pytest.approx(want, rel=1e-5)
    assert got.ensemble.shape == (2, 4096) and bool(torch.isfinite(got.ensemble).all())


@pytest.mark.parametrize("use_kernel", [False, True], ids=["estimator", "twin"])
def test_main_path_against_carr_madan(use_kernel):
    """PRNG stream, 16384 pairs, 11 steps: within 4 standard errors plus 5 bp
    (the QE-11 scheme bias, +3.5 bp in bench.py) of the port's Carr–Madan."""
    prob = ht.from_reference(_problem())
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device="cpu")).price)
    cfg = ht.SimulationConfig(16384, 11, ht.Antithetic(), 4, False)
    sol = ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(),
                                       ht.HestonQE(use_kernel=use_kernel, conditional=True), cfg,
                                       device="cpu"))
    disc = float(ht.df(prob.market_inputs.rate, prob.payoff.expiry))
    se = disc * float(sol.ensemble.mean(dim=0).std()) / np.sqrt(16384)
    assert abs(float(sol.price) - cm) <= 4 * se + 5e-4 * cm


def test_strategy_carries_across_and_dispatches():
    """The mixing strategy carries across and never gives terminal samples;
    the default ``HestonQE()`` is the QE-M terminal sampler, which ``solve``
    and ``simulate_terminal_prices`` run."""
    method = _cpu(_method(True))
    assert method.strategy == ht.HestonQE(martingale_correction=True, use_kernel=True,
                                          conditional=True)
    prob = ht.from_reference(_problem())
    with pytest.raises(TypeError, match="never materializes"):
        ht.simulate_terminal_prices(prob, method)
    qe_m = dataclasses.replace(method, strategy=ht.HestonQE(),
                               config=ht.SimulationConfig(64, 3, ht.Antithetic(), 3, True))
    samples = ht.simulate_terminal_prices(prob, qe_m)
    assert samples.shape == (2, 64) and bool(torch.isfinite(samples).all())
    sol = ht.solve(prob, qe_m)
    assert torch.equal(sol.ensemble, samples)
    with pytest.raises(TypeError, match="strike grids"):
        ht.solve(ht.from_reference(_problem(np.array([90.0, 110.0]))), method)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = ht.from_reference(_problem())
    for use_kernel in (False, True):
        method = dataclasses.replace(ht.from_reference(_method(use_kernel)), device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            ht.solve(prob, method)
