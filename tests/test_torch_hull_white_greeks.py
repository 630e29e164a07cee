"""The Hull-White greeks and calibration of the port (``HullWhiteAnalytic`` of
methods/hull_white.py under autograd) against the JAX package on the CPU:
the swaption vega through the critical state x* (the implicit-function
root) and the mean-reversion greek against ``jax.grad`` to 1e-8 and the
vega against central differences (tests/unit/test_hull_white.py:155), and
the key-rate durations through ``ZeroRateSpineLens`` and ``ReverseAD``
against ``jax.grad`` through the same lenses to 1e-8; and (a, σ) fitted to
a caplet strip by L-BFGS through ``CalibrationProblem``
(test_hull_white.py:187) against JAX's fitted parameters to 1e-6."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
CPU = "cpu"
GRAD_RTOL = 1e-8
SWAP_DATES = [dt.date(2026, 1, 1), dt.date(2027, 1, 1), dt.date(2028, 1, 1)]
TENORS = np.array([0.5, 1.0, 2.0, 3.0, 5.0])
ZEROS = np.array([0.02, 0.025, 0.03, 0.032, 0.035])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcurve():
    return hh.RateCurve.from_dfs(REF, TENORS, np.exp(-ZEROS * TENORS))


def _jmarket(a=0.1, sigma=0.012):
    return hh.HullWhiteInputs(REF, _jcurve(), a, sigma)


def _pmarket(a=0.1, sigma=0.012):
    return ht.HullWhiteInputs(REF, ht.RateCurve.from_dfs(REF, TENORS, np.exp(-ZEROS * TENORS)),
                              a, sigma)


def _pprice(payoff, market):
    return float(ht.solve(ht.PricingProblem(ht.from_reference(payoff), market),
                          ht.HullWhiteAnalytic(device=CPU)).price)


PAYER = hh.Swaption(0.032, dt.date(2025, 1, 1), SWAP_DATES, payer=True, notional=100.0)


def test_swaption_vega_and_mean_reversion_greeks_match_jax():
    """The vega through x* (the implicit-function root) and dV/da against
    ``jax.grad`` (one jitted ``value_and_grad``), and the vega against central
    differences as test_hull_white.py:155."""
    sw = PAYER

    def jpx(a, sig):
        return hh.solve(hh.PricingProblem(sw, _jmarket(a, sig)), hh.HullWhiteAnalytic()).price

    _, (want_a, want_vega) = jax.jit(jax.value_and_grad(jpx, argnums=(0, 1)))(0.1, 0.012)
    a, sig = (torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (0.1, 0.012))
    method = ht.HullWhiteAnalytic(device=CPU)
    price = ht.solve(ht.PricingProblem(ht.from_reference(sw), _pmarket(a, sig)), method).price
    d_a, vega = (float(g) for g in torch.autograd.grad(price, (a, sig)))
    assert vega == pytest.approx(float(want_vega), rel=GRAD_RTOL)
    assert d_a == pytest.approx(float(want_a), rel=GRAD_RTOL)
    eps = 1e-5
    up, dn = (_pprice(sw, _pmarket(0.1, 0.012 + d)) for d in (eps, -eps))
    assert vega == pytest.approx((up - dn) / (2 * eps), rel=1e-6)


def test_key_rate_durations_match_jax():
    """∂V/∂(zero-rate spine point i) through ``BatchGreekProblem`` and
    ``ReverseAD`` against ``jax.grad`` of JAX's price through the same
    lenses (jitted)."""
    sw = PAYER
    lenses = tuple(hh.ZeroRateSpineLens(i) for i in range(5))
    jprob = hh.PricingProblem(sw, _jmarket())

    def jpx(z):
        prob = jprob
        for i, lens in enumerate(lenses):
            prob = lens.set(prob, z[i])
        return hh.solve(prob, hh.HullWhiteAnalytic()).price

    spine = jnp.asarray([lens.get(jprob) for lens in lenses])
    want = np.asarray(jax.jit(jax.grad(jpx))(spine))
    got = ht.solve(ht.BatchGreekProblem(ht.PricingProblem(ht.from_reference(sw), _pmarket()),
                                        tuple(ht.from_reference(lens) for lens in lenses)),
                   ht.ReverseAD(), ht.HullWhiteAnalytic(device=CPU))
    g = np.array([float(v) for v in got.values()])
    np.testing.assert_allclose(g, want, rtol=GRAD_RTOL, atol=1e-12)
    assert np.max(np.abs(g)) > 1.0  # real rate risk somewhere


def test_calibration_to_caplets_matches_jax():
    """(a, σ) fitted to a caplet strip by L-BFGS through the lenses
    (test_hull_white.py:187), against JAX's fitted parameters."""
    true = _jmarket(a=0.08, sigma=0.014)
    starts = [dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2026, 1, 1),
              dt.date(2027, 1, 1)]
    caplets = [hh.Caplet(0.03, s, dt.date(s.year + (s.month + 6 > 12),
                                          (s.month + 6 - 1) % 12 + 1, 1), notional=100.0)
               for s in starts]
    quotes = [float(hh.solve(hh.PricingProblem(c, true), hh.HullWhiteAnalytic()).price)
              for c in caplets]
    calib = hh.CalibrationProblem(
        hh.BasketPricingProblem(tuple(caplets), _jmarket(a=0.05, sigma=0.01)),
        jnp.asarray(quotes), jnp.asarray([0.05, 0.01]), hh.HullWhiteAnalytic(),
        (hh.FieldLens("market_inputs.a"), hh.FieldLens("market_inputs.sigma")))
    algo, lb, ub = hh.OptimizerAlgo(max_iters=200), [1e-3, 1e-4], [1.0, 0.1]
    want = np.asarray(hh.solve(calib, algo, lb=jnp.asarray(lb), ub=jnp.asarray(ub)).u)
    port = ht.from_reference(calib)
    port = dataclasses.replace(port, pricing_method=ht.HullWhiteAnalytic(device=CPU))
    got = ht.solve(port, ht.from_reference(algo), lb=torch.tensor(lb, dtype=torch.float64),
                   ub=torch.tensor(ub, dtype=torch.float64)).u.detach().numpy()
    assert got[1] == pytest.approx(0.014, rel=2e-2)
    assert got[0] == pytest.approx(0.08, rel=2e-1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
