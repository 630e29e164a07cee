"""Multi-asset Black-Scholes in the port (methods/multi_asset.py, the
multi-asset payoffs and inputs, ``quanto_dividend_yield``) against the JAX
package on the CPU.

Margrabe, Kirk, the geometric basket (two and three assets), the four
Stulz rainbows and the public closed-form functions agree with JAX's to
1e-12; the correlation greek and the per-asset deltas through autograd
agree with ``jax.grad`` to 1e-8.  Under QMC the correlated terminal draw
takes JAX's Sobol' points, so every path equals JAX's to 1e-10.  On the
port's Philox stream (``MA_BS_TAG``) Margrabe, the geometric basket and the
Stulz best-of and worst-of agree with their closed forms within 4 SE, and
Kirk at tests/unit/test_multi_asset.py's tolerances.  Then the JAX suite's
checks (test_multi_asset.py, test_quanto.py): AM-GM, the correlation
validation and the guards with JAX's exception types, and the quanto carry
against a foreign-measure Monte Carlo."""

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

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)  # T = 1 (ACT/365)
CPU = "cpu"
RTOL = 1e-12
GRAD_RTOL = 1e-8
PATH_RTOL = 1e-10
CORR3 = [[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jmarket(rho=0.5, q=0.0):
    return hh.MultiAssetBSInputs(REF, 0.03, jnp.asarray([100.0, 95.0]), jnp.asarray([0.25, 0.2]),
                                 jnp.asarray([[1.0, rho], [rho, 1.0]]), dividend_yields=q)


def _jmarket3():
    return hh.MultiAssetBSInputs(REF, 0.03, jnp.asarray([100.0, 95.0, 110.0]),
                                 jnp.asarray([0.25, 0.2, 0.3]), jnp.asarray(CORR3))


def _payoffs():
    w = jnp.asarray([0.6, 0.4])
    return {
        "exchange": hh.SpreadOption(0.0, EXPIRY),
        "kirk call": hh.SpreadOption(5.0, EXPIRY),
        "kirk put": hh.SpreadOption(15.0, EXPIRY, call_put=hh.Put()),
        "geometric call": hh.BasketOption(95.0, EXPIRY, w, geometric=True),
        "geometric put": hh.BasketOption(95.0, EXPIRY, w, call_put=hh.Put(), geometric=True),
        "best-of call": hh.RainbowOption(100.0, EXPIRY, best=True),
        "worst-of call": hh.RainbowOption(100.0, EXPIRY, best=False),
        "best-of put": hh.RainbowOption(100.0, EXPIRY, best=True, call_put=hh.Put()),
        "worst-of put": hh.RainbowOption(100.0, EXPIRY, best=False, call_put=hh.Put()),
    }


def _analytic(payoff, jmarket):
    return float(ht.solve(ht.PricingProblem(ht.from_reference(payoff), ht.from_reference(jmarket)),
                          ht.BlackScholesAnalytic(device=CPU)).price)


def _jax_analytic(payoff, jmarket):
    return float(hh.solve(hh.PricingProblem(payoff, jmarket), hh.BlackScholesAnalytic()).price)


@pytest.mark.parametrize("q", [0.0, 0.02])
@pytest.mark.parametrize("name", list(_payoffs()))
def test_closed_forms_match_reference(name, q):
    payoff, m = _payoffs()[name], _jmarket(q=q)
    assert _analytic(payoff, m) == pytest.approx(_jax_analytic(payoff, m), rel=RTOL)


def test_three_asset_geometric_basket_and_exports_match_reference():
    gb = hh.BasketOption(100.0, EXPIRY, jnp.asarray([0.4, 0.3, 0.3]), call_put=hh.Put(),
                         geometric=True)
    assert _analytic(gb, _jmarket3()) == pytest.approx(_jax_analytic(gb, _jmarket3()), rel=RTOL)
    args = (100.0, 95.0, 0.25, 0.2, 0.5)
    for cp in (1.0, -1.0):
        assert float(ht.margrabe_price(*args, 1.0, cp)) == pytest.approx(
            float(hh.margrabe_price(*args, 1.0, cp)), rel=RTOL)
        assert float(ht.kirk_spread_price(100.0, 95.0, 5.0, 0.25, 0.2, 0.5, 1.0, 0.97, cp)) == \
            pytest.approx(float(hh.kirk_spread_price(100.0, 95.0, 5.0, 0.25, 0.2, 0.5, 1.0, 0.97,
                                                     cp)), rel=RTOL)
    want = hh.geometric_basket_price([100.0, 95.0], [0.5, 0.5], [0.25, 0.2],
                                     [[1.0, 0.3], [0.3, 1.0]], 97.0, 1.0, 0.97, 1.0)
    got = ht.geometric_basket_price([100.0, 95.0], [0.5, 0.5], [0.25, 0.2],
                                    [[1.0, 0.3], [0.3, 1.0]], 97.0, 1.0, 0.97, 1.0)
    assert float(got) == pytest.approx(float(want), rel=RTOL)
    rb = (100.0, 95.0, 0.25, 0.2, 0.5, 100.0, 1.0, 0.97)
    assert float(ht.stulz_min_call_price(*rb)) == pytest.approx(
        float(hh.stulz_min_call_price(*rb)), rel=RTOL)
    np.testing.assert_allclose([float(x) for x in ht.rainbow_prices(*rb)],
                               [float(x) for x in hh.rainbow_prices(*rb)], rtol=RTOL)


def test_correlation_greek_and_deltas_match_jax():
    """dV/dρ of the exchange option and of the best-of call, and the per-asset
    deltas of the geometric basket and Kirk's spread, through autograd against
    ``jax.grad`` (test_multi_asset.py:62)."""
    p = _payoffs()

    def jprice(payoff, spots, rho):
        m = hh.MultiAssetBSInputs(REF, 0.03, spots, jnp.asarray([0.25, 0.2]),
                                  jnp.stack([jnp.stack([1.0, rho]), jnp.stack([rho, 1.0])]))
        return hh.solve(hh.PricingProblem(payoff, m), hh.BlackScholesAnalytic()).price

    for name in ("exchange", "kirk call", "geometric call", "best-of call"):
        s0 = jnp.asarray([100.0, 95.0])
        want = jax.jit(jax.grad(lambda s, r, po=p[name]: jprice(po, s, r), argnums=(0, 1)))(
            s0, 0.5)
        spots = torch.tensor([100.0, 95.0], dtype=torch.float64, requires_grad=True)
        rho = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        corr = torch.stack([torch.stack([torch.ones_like(rho), rho]),
                            torch.stack([rho, torch.ones_like(rho)])])
        m = ht.MultiAssetBSInputs(REF, 0.03, spots, torch.tensor([0.25, 0.2],
                                                                 dtype=torch.float64), corr)
        price = ht.solve(ht.PricingProblem(ht.from_reference(p[name]), m),
                         ht.BlackScholesAnalytic(device=CPU)).price
        deltas, d_rho = torch.autograd.grad(price, (spots, rho))
        np.testing.assert_allclose(deltas.numpy(), np.asarray(want[0]), rtol=GRAD_RTOL)
        assert float(d_rho) == pytest.approx(float(want[1]), rel=GRAD_RTOL), name
    assert float(d_rho) != 0.0


def _mc(pairs, qmc, seed=0):
    return hh.MonteCarlo(hh.LognormalDynamics(), hh.BlackScholesExact(),
                         hh.SimulationConfig(pairs, 1, hh.Antithetic(), seed, qmc))


def _port_mc(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


@pytest.mark.parametrize("name", ["kirk call", "geometric put", "worst-of call", "3-asset"])
def test_qmc_paths_match_reference(name):
    if name == "3-asset":
        payoff, m = hh.BasketOption(100.0, EXPIRY, jnp.asarray([0.4, 0.3, 0.3])), _jmarket3()
    else:
        payoff, m = _payoffs()[name], _jmarket(q=0.01)
    method = _mc(1024, True)
    prob = hh.PricingProblem(payoff, m)
    want_price, want = jax.jit(lambda: (lambda s: (s.price, s.ensemble))(hh.solve(prob,
                                                                                   method)))()
    got = ht.solve(ht.from_reference(prob), _port_mc(method))
    np.testing.assert_allclose(got.ensemble.numpy(), np.asarray(want), rtol=PATH_RTOL,
                               atol=1e-12)
    assert float(got.price) == pytest.approx(float(want_price), rel=PATH_RTOL)


def _price_and_se(payoff, jmarket, pairs=2**16, seed=0):
    sol = ht.solve(ht.PricingProblem(ht.from_reference(payoff), ht.from_reference(jmarket)),
                   _port_mc(_mc(pairs, False, seed)))
    D = math.exp(-0.03)
    pair_vals = sol.ensemble.mean(dim=0)
    return float(sol.price), D * float(pair_vals.std()) / math.sqrt(pair_vals.numel())


@pytest.mark.parametrize("name", ["exchange", "geometric call", "best-of call", "worst-of put"])
def test_prng_stream_agrees_with_closed_forms(name):
    payoff = _payoffs()[name]
    p, se = _price_and_se(payoff, _jmarket())
    want = _analytic(payoff, _jmarket())
    assert abs(p - want) <= 4.0 * se, (p, want, se)


def test_kirk_against_prng_mc_and_am_gm():
    """Kirk within test_multi_asset.py:42's tolerances (3e-3 at K = 5, 6e-3 at
    K = 15; its MC error is far smaller at 2^18 pairs), and the arithmetic
    basket above the geometric (AM-GM)."""
    for K, tol in ((5.0, 3e-3), (15.0, 6e-3)):
        sp = hh.SpreadOption(K, EXPIRY)
        p, se = _price_and_se(sp, _jmarket(), 2**18, seed=1)
        assert abs(p / _analytic(sp, _jmarket()) - 1.0) <= tol + 4.0 * se / p, K
    w = jnp.asarray([0.6, 0.4])
    arith, _ = _price_and_se(hh.BasketOption(95.0, EXPIRY, w), _jmarket())
    assert arith >= _analytic(hh.BasketOption(95.0, EXPIRY, w, geometric=True), _jmarket())


def test_correlation_validation_and_guards():
    """test_multi_asset.py:72 and :51, with JAX's exception types."""
    two = (torch.tensor([1.0, 1.0], dtype=torch.float64),) * 2
    with pytest.raises(ValueError, match="symmetric"):
        ht.MultiAssetBSInputs(REF, 0.03, *two, np.array([[1.0, 0.5], [0.2, 1.0]]))
    with pytest.raises(ValueError, match="unit diagonal"):
        ht.MultiAssetBSInputs(REF, 0.03, *two, np.array([[1.1, 0.5], [0.5, 1.0]]))
    with pytest.raises(ValueError, match="square"):
        ht.MultiAssetBSInputs(REF, 0.03, *two, np.array([1.0, 0.5]))
    with pytest.raises(ValueError, match="positive semi-definite"):
        ht.MultiAssetBSInputs(REF, 0.03, [1.0] * 3, [0.2] * 3,
                              np.array([[1.0, 0.99, -0.99], [0.99, 1.0, 0.99],
                                        [-0.99, 0.99, 1.0]]))
    analytic = ht.BlackScholesAnalytic(device=CPU)
    with pytest.raises(TypeError, match="no lognormal closed form"):
        ht.solve(ht.PricingProblem(ht.BasketOption(95.0, EXPIRY, [0.6, 0.4]),
                                   ht.from_reference(_jmarket())), analytic)
    with pytest.raises(TypeError, match="two-asset"):
        ht.solve(ht.PricingProblem(ht.RainbowOption(100.0, EXPIRY),
                                   ht.from_reference(_jmarket3())), analytic)
    with pytest.raises(TypeError, match="European"):
        ht.solve(ht.PricingProblem(ht.SpreadOption(0.0, EXPIRY, ht.American()),
                                   ht.from_reference(_jmarket())), analytic)
    with pytest.raises(TypeError, match="no lognormal closed form"):
        hh.solve(hh.PricingProblem(hh.BasketOption(95.0, EXPIRY, jnp.asarray([0.6, 0.4])),
                                   _jmarket()), hh.BlackScholesAnalytic())


def test_quanto_carry():
    """``quanto_dividend_yield`` equals JAX's, and the quanto call it prices
    matches a foreign-measure Monte Carlo with the explicit Radon-Nikodym
    weight (test_quanto.py:28), numpy draws from a seed: rel 5e-3."""
    args = (0.05, 0.02, 0.01, 0.25, 0.12, -0.35)
    y = ht.quanto_dividend_yield(*args)
    assert y == pytest.approx(float(hh.quanto_dividend_yield(*args)), rel=1e-15)
    assert ht.quanto_dividend_yield(0.05, 0.02, 0.01, 0.25, 0.12, 0.0) == pytest.approx(
        0.05 - 0.02 + 0.01, rel=1e-15)
    S0, K, r_d, r_f, q, sig, sig_x, rho = 100.0, 105.0, *args
    opt = ht.VanillaOption(K, EXPIRY)
    bs = ht.BlackScholesAnalytic(device=CPU)
    quanto = float(ht.solve(ht.PricingProblem(opt, ht.BlackScholesInputs(
        REF, r_d, S0, sig, dividend_yield=y)), bs).price)
    rng = np.random.default_rng(0)
    z1 = rng.standard_normal(1 << 19)
    z2 = rho * z1 + math.sqrt(1 - rho**2) * rng.standard_normal(1 << 19)
    z1, z2 = np.concatenate([z1, -z1]), np.concatenate([z2, -z2])
    s_t = S0 * np.exp((r_f - q - 0.5 * sig**2) + sig * z1)
    x_ratio = np.exp((r_d - r_f + 0.5 * sig_x**2) + sig_x * z2)
    mc = math.exp(-r_d) * float(np.mean(np.maximum(s_t - K, 0.0) / x_ratio
                                        * math.exp(r_d - r_f)))
    assert quanto == pytest.approx(mc, rel=5e-3)
    plain = float(ht.solve(ht.PricingProblem(opt, ht.BlackScholesInputs(
        REF, r_d, S0, sig, dividend_yield=ht.quanto_dividend_yield(r_d, r_f, q, sig, 0.0,
                                                                   rho))), bs).price)
    assert quanto > plain  # ρ < 0 raises the drift
