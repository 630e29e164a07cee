"""The forward-mode greeks of the QE mixing estimator
(methods/mixing_greeks.py) against the JAX package, against autograd through
the port's own seeded ``solve``, and the differentiable kernel-backed
``solve`` (K7 forward, K11 backward; their twins on the CPU)."""

import dataclasses
import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import mixing_greeks as jmg
from hedgehog_tpu_torch.methods import mixing_greeks as pmg

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
SPOT, R = 100.0, 0.03
H = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)
CASES = [(hh.Call(), 100.0), (hh.Put(), 90.0)]
CASE_IDS = ["atm_call", "otm_put"]


def _method(n_pairs=2048, steps=6, qmc=True, seed=0, use_kernel=False):
    cfg = hh.SimulationConfig(trajectories=n_pairs, steps=steps,
                              variance_reduction=hh.Antithetic(), seed=seed, qmc=qmc)
    return hh.MonteCarlo(hh.HestonDynamics(),
                         hh.HestonQE(conditional=True, use_kernel=use_kernel), cfg)


def _cpu(method):
    """The port's counterpart of a JAX method, run on the CPU."""
    return dataclasses.replace(ht.from_reference(method), device="cpu")


def _problem(cp, strike):
    return hh.PricingProblem(hh.VanillaOption(strike, EXPIRY, hh.European(), cp, hh.Spot()),
                             hh.HestonInputs(REF, R, SPOT, *H.values()))


@pytest.mark.parametrize("cp,strike", CASES, ids=CASE_IDS)
def test_price_and_greeks_match_reference(cp, strike):
    """QMC, the same Sobol' points on both sides, float64: the price to rel
    1e-12 and every greek to rel 1e-9."""
    prob, method = _problem(cp, strike), _method()
    p_ref, g_ref = jmg.heston_mixing_price_and_greeks(prob, method)
    price, greeks = ht.heston_mixing_price_and_greeks(ht.from_reference(prob),
                                                      _cpu(method))
    np.testing.assert_allclose(float(price), float(p_ref), rtol=1e-12)
    assert tuple(greeks) == ht.GREEK_ORDER == jmg.GREEK_ORDER
    for k in ht.GREEK_ORDER:
        np.testing.assert_allclose(float(greeks[k]), float(g_ref[k]), rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def test_tables_and_partials_match_reference():
    want_dc, want_dj = jmg.greek_tables(2.0, 0.04, 0.3, 366 / 365, 7)
    got_dc, got_dj = pmg.greek_tables(2.0, 0.04, 0.3, 366 / 365, 7)
    np.testing.assert_allclose(got_dc.numpy(), np.asarray(want_dc), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got_dj.numpy(), np.asarray(want_dj), rtol=1e-12, atol=1e-15)
    rng = np.random.default_rng(7)
    iv, j = rng.uniform(0.005, 0.1, 64), rng.normal(0.0, 0.2, 64)
    kw = dict(f0=103.0, log_f0_over_k=np.log(103.0 / 95.0), strike=95.0, rho=-0.7)
    for cp in (1.0, -1.0):
        want = jmg.cond_bs_value_and_partials(jnp.asarray(iv), jnp.asarray(j), cp=cp, **kw)
        got = pmg.cond_bs_value_and_partials(torch.as_tensor(iv), torch.as_tensor(j), cp=cp, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)


def _params():
    return [torch.tensor(x, dtype=torch.float64, requires_grad=True)
            for x in (SPOT, *H.values(), R)]


def _solve_price(params, cp, strike, method):
    spot, v0, kappa, theta, sigma, rho, r = params
    market = ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
    payoff = ht.VanillaOption(strike, EXPIRY, ht.European(), cp, ht.Spot())
    return ht.solve(ht.PricingProblem(payoff, market), method).price


@pytest.mark.parametrize("cp,strike", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("qmc", [False, True], ids=["prng", "qmc"])
def test_forward_greeks_match_reverse_ad(qmc, cp, strike):
    """The forward greeks equal torch.autograd.grad through the port's seeded
    solve (the same draws, the same estimator, another derivation): the
    price to rel 1e-12, the greeks to rel 1e-9 (mirrors
    tests/agreement/test_kernel_greeks.py:48-72)."""
    method = _cpu(_method(4096, 8, qmc=qmc))
    port_cp = ht.Call() if isinstance(cp, hh.Call) else ht.Put()
    params = _params()
    price = _solve_price(params, port_cp, strike, method)
    g_ref = torch.autograd.grad(price, params)
    p_new, g_new = ht.heston_mixing_price_and_greeks(ht.from_reference(_problem(cp, strike)),
                                                     method)
    np.testing.assert_allclose(float(p_new), float(price.detach()), rtol=1e-12)
    for k, g in zip(ht.GREEK_ORDER, g_ref):
        np.testing.assert_allclose(float(g_new[k]), float(g), rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("qmc", [False, True], ids=["prng", "qmc"])
def test_autograd_through_kernel_solve(qmc):
    """use_kernel=True on CPU tensors: the K7 twin forward and the K11 twin
    backward.  Under QMC the float64 estimator draws the same points, so the
    gradients match its forward greeks to fp32 accuracy (within 2e-4 of the
    largest greek, plus 2e-4 relative); under PRNG the twin's float32 and
    the estimator's float64 Box–Muller normals differ in the last bits, so
    the same bound holds (both follow the same Philox layout)."""
    method = _cpu(_method(4096, 6, qmc=qmc, use_kernel=True))
    params = _params()
    price = _solve_price(params, ht.Call(), 100.0, method)
    grads = np.array([float(g) for g in torch.autograd.grad(price, params)])
    assert np.isfinite(grads).all()
    ref_method = _cpu(_method(4096, 6, qmc=qmc))
    p_ref, g_ref = ht.heston_mixing_price_and_greeks(
        ht.from_reference(_problem(hh.Call(), 100.0)), ref_method)
    want = np.array([float(g_ref[k]) for k in ht.GREEK_ORDER])
    assert float(price.detach()) == pytest.approx(float(p_ref), rel=1e-5)
    assert (np.abs(grads - want) <= 2e-4 * np.abs(want).max() + 2e-4 * np.abs(want)).all(), (
        grads, want)


def test_wrong_methods_raise():
    prob = ht.from_reference(_problem(hh.Call(), 100.0))
    qe_m = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(), ht.SimulationConfig(64, 2),
                         device="cpu")
    exact = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonExactMixing(), ht.SimulationConfig(64, 2),
                          device="cpu")
    for bad in (qe_m, exact):
        with pytest.raises(TypeError, match="requires MonteCarlo"):
            ht.heston_mixing_price_and_greeks(prob, bad)
    with pytest.raises(TypeError, match="use_kernel=True"):
        ht.heston_mixing_price_and_greeks(prob, _cpu(_method(use_kernel=True)))
    grid = ht.from_reference(_problem(hh.Call(), np.array([90.0, 110.0])))
    with pytest.raises(TypeError, match="scalar strike"):
        ht.heston_mixing_price_and_greeks(grid, _cpu(_method()))
    # the reference raises the same for the QE-M strategy
    with pytest.raises(TypeError):
        jmg.heston_mixing_price_and_greeks(
            _problem(hh.Call(), 100.0),
            hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(), hh.SimulationConfig(64, 2)))


def test_greek_vector_against_carr_madan_differences():
    """Pathwise greeks at 2^15 QMC pairs and 12 steps against central
    Carr–Madan differences, at the reference's tolerances
    (tests/agreement/test_flagship_greeks.py:52-66): spot h = 0.5 within rel
    3e-2; σ h = 1e-3 within rel 1.5e-1 or abs 5e-2; rate h = 1e-4 within rel
    1e-2; V0 and θ positive for an ATM call."""
    prob = ht.from_reference(_problem(hh.Call(), 100.0))
    _, g = ht.heston_mixing_price_and_greeks(prob, _cpu(_method(2**15, 12)))

    def cm(i, h):
        vals = [SPOT, *H.values(), R]
        out = []
        for sign in (1.0, -1.0):
            p = list(vals)
            p[i] += sign * h
            spot, v0, kappa, theta, sigma, rho, r = p
            market = ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
            out.append(float(ht.solve(ht.PricingProblem(prob.payoff, market),
                                      ht.CarrMadan(1.0, 32.0, ht.HestonDynamics(),
                                                   device="cpu")).price))
        return (out[0] - out[1]) / (2 * h)

    assert float(g["spot"]) == pytest.approx(cm(0, 0.5), rel=3e-2)
    assert float(g["sigma"]) == pytest.approx(cm(4, 1e-3), rel=1.5e-1, abs=5e-2)
    assert float(g["rate"]) == pytest.approx(cm(6, 1e-4), rel=1e-2)
    assert float(g["V0"]) > 0 and float(g["theta"]) > 0
