"""Multi-asset Heston in the port (``multi_asset_heston_terminal_prices`` of
methods/multi_asset.py, ``MultiAssetHestonInputs``) against the JAX package
on the CPU.

Under QMC the port takes JAX's Sobol' points (laid out steps × 3 × n), so
every path of a basket, a spread and a rainbow equals JAX's to 1e-10, on
two and three assets; the correlation greek and the per-asset deltas
through autograd equal ``jax.grad`` on those points to 1e-8.  On the port's
Philox stream (``MA_HESTON_TAG``) the oracles of
tests/unit/test_multi_asset_heston.py hold: σ_v → 0 against Stulz and
Margrabe within 4 SE, and the n = 1 basket against the single-asset mixing
estimator (rel 1e-2, QMC both).  The constructor's checks and the
boundary-feasible correlation (the Cholesky's 1e-9 jitter) as in JAX."""

import dataclasses
import datetime as dt
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CORR = [[1.0, 0.5], [0.5, 1.0]]
CPU = "cpu"
PATH_RTOL = 1e-10
GRAD_RTOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _heston2(mod, sigma_vs=(0.3, 0.4), rhos=(-0.6, -0.5), corr=CORR, spots=(100.0, 95.0)):
    return mod.MultiAssetHestonInputs(REF, 0.03, list(spots), [0.04, 0.09], [2.0, 1.5],
                                      [0.04, 0.09], list(sigma_vs), list(rhos), corr,
                                      dividend_yields=[0.01, 0.0])


def _heston3(mod):
    off = 0.3
    corr = [[1.0, off, 0.1], [off, 1.0, off], [0.1, off, 1.0]]
    return mod.MultiAssetHestonInputs(REF, 0.03, [100.0, 95.0, 105.0], [0.04, 0.09, 0.04],
                                      [2.0, 1.5, 2.0], [0.04, 0.09, 0.04], [0.3, 0.4, 0.3],
                                      [-0.6, -0.5, -0.3], corr)


def _mc(paths, steps, qmc, seed=0):
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True),
                         hh.SimulationConfig(paths, steps, hh.Antithetic(), seed, qmc))


def _port(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


CASES = {
    "basket": (lambda: hh.BasketOption(97.0, EXPIRY, [0.5, 0.5]), _heston2),
    "spread": (lambda: hh.SpreadOption(5.0, EXPIRY), _heston2),
    "worst-of put": (lambda: hh.RainbowOption(100.0, EXPIRY, best=False, call_put=hh.Put()),
                     _heston2),
    "3-asset best-of": (lambda: hh.RainbowOption(100.0, EXPIRY, best=True), _heston3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_qmc_paths_match_reference(name):
    payoff, market = CASES[name]
    prob = hh.PricingProblem(payoff(), market(hh))
    method = _mc(512, 4, True)
    want_price, want = jax.jit(lambda: (lambda s: (s.price, s.ensemble))(hh.solve(prob,
                                                                                   method)))()
    got = ht.solve(ht.from_reference(prob), _port(method))
    np.testing.assert_allclose(got.ensemble.numpy(), np.asarray(want), rtol=PATH_RTOL,
                               atol=1e-12)
    assert float(got.price) == pytest.approx(float(want_price), rel=PATH_RTOL)


def test_correlation_greek_and_deltas_match_jax():
    """dV/dR₁₂ of the best-of call and the per-asset deltas of the basket
    through the whole correlated simulation, against ``jax.grad`` on the
    same QMC points; the signs of test_multi_asset_heston.py:78."""
    method = _mc(512, 4, True)
    rb, basket = hh.RainbowOption(100.0, EXPIRY, best=True), hh.BasketOption(97.0, EXPIRY,
                                                                            [0.5, 0.5])

    def jprice(payoff, spots, c12):
        corr = jnp.stack([jnp.stack([1.0, c12]), jnp.stack([c12, 1.0])])
        m = hh.MultiAssetHestonInputs(REF, 0.03, spots, [0.04, 0.09], [2.0, 1.5], [0.04, 0.09],
                                      [0.3, 0.4], [-0.6, -0.5], corr)
        return hh.solve(hh.PricingProblem(payoff, m), method).price

    for payoff in (rb, basket):
        want = jax.jit(jax.grad(lambda s, c, po=payoff: jprice(po, s, c), argnums=(0, 1)))(
            jnp.asarray([100.0, 95.0]), 0.5)
        spots = torch.tensor([100.0, 95.0], dtype=torch.float64, requires_grad=True)
        c12 = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        one = torch.ones_like(c12)
        m = ht.MultiAssetHestonInputs(REF, 0.03, spots, [0.04, 0.09], [2.0, 1.5], [0.04, 0.09],
                                      [0.3, 0.4], [-0.6, -0.5],
                                      torch.stack([torch.stack([one, c12]),
                                                   torch.stack([c12, one])]))
        price = ht.solve(ht.PricingProblem(ht.from_reference(payoff), m), _port(method)).price
        deltas, d_c = torch.autograd.grad(price, (spots, c12))
        np.testing.assert_allclose(deltas.numpy(), np.asarray(want[0]), rtol=GRAD_RTOL)
        assert float(d_c) == pytest.approx(float(want[1]), rel=GRAD_RTOL)
        if payoff is rb:
            assert float(d_c) < 0.0  # a best-of falls with correlation
        else:
            assert bool(((deltas > 0.0) & (deltas < 1.0)).all())


def _price_and_se(payoff, market, method):
    sol = ht.solve(ht.PricingProblem(payoff, market), method)
    pairs = sol.ensemble.mean(dim=0)
    return float(sol.price), math.exp(-0.03) * float(pairs.std()) / math.sqrt(pairs.numel())


@pytest.mark.parametrize("payoff", [ht.RainbowOption(100.0, EXPIRY, best=True),
                                    ht.RainbowOption(100.0, EXPIRY, best=False),
                                    ht.SpreadOption(0.0, EXPIRY)], ids=["best-of", "worst-of",
                                                                          "exchange"])
def test_sigma_v_zero_against_stulz_and_margrabe(payoff):
    """σ_v → 0 with V0 = θ (test_multi_asset_heston.py:34): each marginal is a
    constant-vol lognormal, so the Philox-stream price is within 4 SE of the
    Black-Scholes closed form."""
    m = ht.MultiAssetHestonInputs(REF, 0.03, [100.0, 95.0], [0.04, 0.09], [2.0, 1.5],
                                  [0.04, 0.09], [1e-4, 1e-4], [0.0, 0.0], CORR)
    p, se = _price_and_se(payoff, m, _port(_mc(2**14, 8, False, seed=2)))
    bs = ht.MultiAssetBSInputs(REF, 0.03, [100.0, 95.0], [0.2, 0.3], CORR)
    want = float(ht.solve(ht.PricingProblem(payoff, bs), ht.BlackScholesAnalytic(device=CPU)).price)
    assert abs(p - want) <= 4.0 * se, (p, want, se)


def test_single_asset_reduction_matches_conditional_mc():
    """n = 1, weight 1 (test_multi_asset_heston.py:59): the basket call equals
    the single-asset Heston vanilla of the conditional mixing estimator,
    QMC both, rel 1e-2."""
    m1 = ht.MultiAssetHestonInputs(REF, 0.03, [100.0], [0.04], [2.0], [0.04], [0.3], [-0.6],
                                   [[1.0]])
    method = _port(_mc(1 << 13, 32, True))
    p_multi = float(ht.solve(ht.PricingProblem(ht.BasketOption(100.0, EXPIRY, [1.0]), m1),
                             method).price)
    single = ht.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.6)
    p_single = float(ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY), single),
                              method).price)
    assert p_multi == pytest.approx(p_single, rel=1e-2)


def test_validation_and_boundary_feasible_correlation():
    """test_multi_asset_heston.py:117 and :128: an R too strong for the
    spot-vol correlations is refused; an equicorrelation −0.5 − 5e-12 that
    the check accepts at its −1e-10 slack prices finitely (the 1e-9 jitter)."""
    with pytest.raises(ValueError, match="too strong"):
        _heston2(ht, rhos=(-0.9, -0.9), corr=[[1.0, 0.6], [0.6, 1.0]])
    with pytest.raises(ValueError, match="\\|rho\\| < 1"):
        _heston2(ht, rhos=(-1.0, 0.0))
    with pytest.raises(ValueError, match="symmetric"):
        _heston2(ht, corr=[[1.0, 0.5], [0.4, 1.0]])
    with pytest.raises(ValueError, match="positive semi-definite"):
        ht.MultiAssetHestonInputs(REF, 0.03, [1.0] * 3, [0.04] * 3, [2.0] * 3, [0.04] * 3,
                                  [0.3] * 3, [0.0] * 3,
                                  [[1.0, 0.9, -0.9], [0.9, 1.0, 0.9], [-0.9, 0.9, 1.0]])
    off = -0.5 - 5e-12
    m = ht.MultiAssetHestonInputs(REF, 0.03, [100.0, 95.0, 105.0], [0.04, 0.09, 0.04],
                                  [2.0, 1.5, 2.0], [0.04, 0.09, 0.04], [0.3, 0.4, 0.3],
                                  [0.0, 0.0, 0.0],
                                  [[1.0, off, off], [off, 1.0, off], [off, off, 1.0]])
    method = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(),
                           ht.SimulationConfig(2_000, 4, ht.Antithetic(), 0), device=CPU)
    p = float(ht.solve(ht.PricingProblem(ht.BasketOption(97.0, EXPIRY, [1 / 3] * 3), m),
                       method).price)
    assert math.isfinite(p) and p > 0.0
