"""The Bachelier (normal) family of the port (methods/bachelier.py,
``BachelierExact`` and the Bachelier grid of methods/normal_lv_mc.py, its
barrier bridge in methods/bridge_mc.py) against the JAX package on the
CPU.

The closed forms, the digital and a strike grid agree with JAX's to 1e-12,
delta and vega through autograd with ``jax.grad`` to 1e-8, and
``implied_normal_vol`` round-trips with its implicit-function gradient.
Under QMC the exact draw and the Euler grid equal JAX's path by path to
1e-10 (the grid's terminal equals the exact draw: bridge ordering), and
so do the barrier bridge factors, H mapped to H/c(t) per grid time.
Then the JAX suite's own oracles on the port: the r = 0 image method for
the down-and-out call (tests/unit/test_bachelier.py:177), parity, the
guards (:238), PRNG prices within 4 SE of the closed form, and sigma
recovery by calibration."""

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
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import bridge_mc
from hedgehog_tpu_torch.methods import montecarlo as pmc

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)  # T = 1 under ACT/365
R, SPOT, SIGMA_N, Q = 0.05, 100.0, 20.0, 0.01
D = math.exp(-R)
F = SPOT / D
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jmarket(rate=R, sigma=SIGMA_N, q=0.0):
    return hh.BachelierInputs(REF, rate, SPOT, sigma, dividend_yield=q)


def _pmarket(rate=R, sigma=SIGMA_N, q=0.0, spot=SPOT):
    return ht.BachelierInputs(REF, rate, spot, sigma, dividend_yield=q)


def _jopt(strike=95.0, cp=None, style=None):
    return hh.VanillaOption(strike, EXPIRY, style or hh.European(), cp or hh.Call(), hh.Spot())


def _popt(strike=95.0, cp=None, style=None):
    return ht.VanillaOption(strike, EXPIRY, style or ht.European(), cp or ht.Call(), ht.Spot())


def _cpu(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _analytic(prob):
    return ht.solve(prob, ht.BachelierAnalytic(device=CPU)).price


@pytest.mark.parametrize("cp", ["call", "put"])
@pytest.mark.parametrize("q", [0.0, Q])
def test_closed_forms_match_reference(cp, q):
    cpj, cpp = (hh.Call(), ht.Call()) if cp == "call" else (hh.Put(), ht.Put())
    ks = np.array([60.0, 90.0, 95.0, 100.0, 105.0, 140.0])
    want = hh.solve(hh.PricingProblem(hh.VanillaOption(jnp.asarray(ks), EXPIRY, hh.European(),
                                                       cpj, hh.Spot()), _jmarket(q=q)),
                    hh.BachelierAnalytic()).price
    got = _analytic(ht.PricingProblem(ht.VanillaOption(ks, EXPIRY, ht.European(), cpp,
                                                       ht.Spot()), _pmarket(q=q)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    jd = hh.DigitalOption(95.0, EXPIRY, hh.European(), cpj, hh.Spot(), cash=2.5)
    want = hh.solve(hh.PricingProblem(jd, _jmarket(q=q)), hh.BachelierAnalytic()).price
    got = _analytic(ht.from_reference(hh.PricingProblem(jd, _jmarket(q=q))))
    assert float(got) == pytest.approx(float(want), rel=1e-12)


def test_atm_zero_vol_and_negative_forward():
    p = float(_analytic(ht.PricingProblem(_popt(F), _pmarket())))
    assert p == pytest.approx(D * SIGMA_N / math.sqrt(2 * math.pi), abs=1e-12)
    p0 = float(_analytic(ht.PricingProblem(_popt(95.0), _pmarket(sigma=0.0))))
    assert p0 == pytest.approx(D * (F - 95.0), abs=1e-12)
    neg = _pmarket(rate=0.0, sigma=10.0, spot=-5.0)  # a negative underlying still prices
    c = float(_analytic(ht.PricingProblem(_popt(0.0), neg)))
    p = float(_analytic(ht.PricingProblem(_popt(0.0, ht.Put()), neg)))
    assert math.isfinite(c) and c > 0.0
    assert p - c == pytest.approx(5.0, abs=1e-12)
    # the σ = 0 branch keeps a clean gradient (double where)
    s = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    v = _analytic(ht.PricingProblem(_popt(95.0), _pmarket(sigma=s)))
    (g,) = torch.autograd.grad(v, s)
    assert torch.isfinite(g)


def test_autograd_greeks_match_jax_grad():
    def jprice(spot, sigma, rate):
        m = hh.BachelierInputs(REF, rate, spot, sigma, dividend_yield=Q)
        return hh.solve(hh.PricingProblem(_jopt(95.0), m), hh.BachelierAnalytic()).price

    want = jax.grad(jprice, argnums=(0, 1, 2))(SPOT, SIGMA_N, R)
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (SPOT, SIGMA_N, R)]
    m = ht.BachelierInputs(REF, leaves[2], leaves[0], leaves[1], dividend_yield=Q)
    got = torch.autograd.grad(_analytic(ht.PricingProblem(_popt(95.0), m)), leaves)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-8)
    d = (F - 95.0) / SIGMA_N  # q = 0: delta = Φ(d), vega = D·√T·φ(d)
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (SPOT, SIGMA_N)]
    price = _analytic(ht.PricingProblem(_popt(95.0), ht.BachelierInputs(REF, R, *leaves)))
    delta, vega = torch.autograd.grad(price, leaves)
    assert float(delta) == pytest.approx(0.5 * (1 + math.erf(d / math.sqrt(2))), rel=1e-10)
    assert float(vega) == pytest.approx(D * math.exp(-0.5 * d * d) / math.sqrt(2 * math.pi),
                                        rel=1e-10)


def test_implied_normal_vol_roundtrip_and_ift_gradient():
    """tests/unit/test_bachelier.py:84, and the gradient against jax.grad."""
    c = float(_analytic(ht.PricingProblem(_popt(95.0), _pmarket())))
    iv = float(ht.implied_normal_vol(c, F, 95.0, 1.0, D, 1.0))
    assert iv == pytest.approx(SIGMA_N, abs=1e-8)
    assert iv == pytest.approx(float(hh.implied_normal_vol(c, F, 95.0, 1.0, D, 1.0)), rel=1e-12)
    pr = torch.tensor(c, dtype=torch.float64, requires_grad=True)
    fw = torch.tensor(F, dtype=torch.float64, requires_grad=True)
    (g_p, g_f) = torch.autograd.grad(ht.implied_normal_vol(pr, fw, 95.0, 1.0, D, 1.0), (pr, fw))
    want = jax.grad(lambda p, f: hh.implied_normal_vol(p, f, 95.0, 1.0, D, 1.0),
                    argnums=(0, 1))(jnp.float64(c), jnp.float64(F))
    assert float(g_p) == pytest.approx(float(want[0]), rel=1e-8)
    assert float(g_f) == pytest.approx(float(want[1]), rel=1e-8)
    d = (F - 95.0) / SIGMA_N
    vega = D * math.exp(-0.5 * d * d) / math.sqrt(2 * math.pi)
    assert float(g_p) == pytest.approx(1.0 / vega, rel=1e-6)


@pytest.mark.parametrize("anti", [True, False])
def test_qmc_paths_match_reference(anti):
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    cfg = hh.SimulationConfig(384, 5, vr, 3, True)
    prob = hh.PricingProblem(_jopt(), _jmarket(q=Q))
    exact = hh.MonteCarlo(hh.NormalDynamics(), hh.BachelierExact(), cfg)
    euler = hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), cfg)
    pprob = ht.from_reference(prob)
    for method, fn in ((exact, "simulate_terminal_prices"), (euler, "simulate_terminal_prices"),
                       (euler, "simulate_price_grid")):
        want = np.asarray(getattr(jmc, fn)(prob, method))
        got = getattr(pmc, fn)(pprob, _cpu(method)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    # the bridge-ordered grid ends on the exact sampler's draw
    t_exact = pmc.simulate_terminal_prices(pprob, _cpu(exact))
    t_euler = pmc.simulate_terminal_prices(pprob, _cpu(euler))
    np.testing.assert_allclose(t_euler.numpy(), t_exact.numpy(), rtol=1e-12)
    # and so does the PRNG grid at one step (the exact sampler's block)
    one = _cpu(dataclasses.replace(euler, config=dataclasses.replace(cfg, steps=1, qmc=False)))
    ex = _cpu(dataclasses.replace(exact, config=dataclasses.replace(cfg, qmc=False)))
    np.testing.assert_array_equal(pmc.simulate_terminal_prices(pprob, one).numpy(),
                                  pmc.simulate_terminal_prices(pprob, ex).numpy())


def test_barrier_grid_factors_match_reference():
    """The price-space bridge of JAX montecarlo.py:1771-1787, per path."""
    cfg = hh.SimulationConfig(256, 8, hh.Antithetic(), 0, True)
    for direction, H in ((hh.Down(), 85.0), (hh.Up(), 120.0)):
        payoff = hh.BarrierOption(95.0, EXPIRY, H, hh.European(), hh.Call(), hh.Spot(),
                                  direction, hh.KnockOut())
        prob = hh.PricingProblem(payoff, _jmarket(q=Q))
        method = hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), cfg)
        want = jmc.barrier_grid_factors(prob, method)
        got = bridge_mc.barrier_grid_factors(ht.from_reference(prob), _cpu(method))
        for g, w in zip((got[0], got[1], got[2]), (want[0], want[1], want[2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
        assert float(got[4]) == pytest.approx(float(want[4]), rel=1e-14)
        j_price = float(hh.solve(prob, method).price)
        p_price = float(ht.solve(ht.from_reference(prob), _cpu(method)).price)
        assert p_price == pytest.approx(j_price, rel=1e-10)


def test_barrier_image_method_r0():
    """tests/unit/test_bachelier.py:177: at r = 0 the down-and-out call is
    C(F₀) − C(2H − F₀) exactly (reflection), 2^16 QMC pairs × 32 steps."""
    H, K = 85.0, 90.0
    doc = ht.BarrierOption(K, EXPIRY, H, ht.European(), ht.Call(), ht.Spot(), ht.Down(),
                           ht.KnockOut())
    cfg = ht.SimulationConfig(1 << 16, 32, ht.Antithetic(), 0, True)
    mc = ht.MonteCarlo(ht.NormalDynamics(), ht.EulerMaruyama(), cfg, device=CPU)
    p_mc = float(ht.solve(ht.PricingProblem(doc, _pmarket(rate=0.0)), mc).price)
    c = float(_analytic(ht.PricingProblem(_popt(K), _pmarket(rate=0.0))))
    c_img = float(_analytic(ht.PricingProblem(_popt(K), _pmarket(rate=0.0, spot=2 * H - SPOT))))
    assert p_mc == pytest.approx(c - c_img, rel=2e-3)


def test_prng_prices_within_four_se():
    prob = ht.PricingProblem(_popt(95.0), _pmarket(q=Q))
    want = float(_analytic(prob))
    for strat, steps in ((ht.BachelierExact(), 1), (ht.EulerMaruyama(), 16)):
        mc = ht.MonteCarlo(ht.NormalDynamics(), strat,
                           ht.SimulationConfig(1 << 15, steps, ht.Antithetic(), 11), device=CPU)
        vals = ht.mc_path_values(prob, mc)
        p = D * float(vals.mean())
        se = D * float(vals.std()) / math.sqrt(vals.numel())
        assert abs(p - want) <= 4.0 * se, (type(strat).__name__, p, want, se)


def test_asian_and_guards():
    cfg = ht.SimulationConfig(1 << 12, 4, ht.Antithetic(), 0, True)
    mc = ht.MonteCarlo(ht.NormalDynamics(), ht.EulerMaruyama(), cfg, device=CPU)
    asian = ht.AsianOption(95.0, EXPIRY, 4, ht.European(), ht.Call(), ht.Spot(),
                           ht.ArithmeticAverage())
    c = float(_analytic(ht.PricingProblem(_popt(95.0), _pmarket())))
    pa = float(ht.solve(ht.PricingProblem(asian, _pmarket()), mc).price)
    assert 0.0 < pa < c  # averaging reduces optionality
    geo = dataclasses.replace(asian, averaging=ht.GeometricAverage())
    with pytest.raises(TypeError, match="geometric averaging is undefined"):
        ht.solve(ht.PricingProblem(geo, _pmarket()), mc)
    # tests/unit/test_bachelier.py:238
    with pytest.raises(TypeError, match="European-only"):
        _analytic(ht.PricingProblem(_popt(95.0, ht.Put(), ht.American()), _pmarket()))
    with pytest.raises(TypeError, match="no fused kernel"):
        ht.solve(ht.PricingProblem(_popt(), _pmarket()),
                 ht.MonteCarlo(ht.NormalDynamics(), ht.EulerMaruyama(use_kernel=True),
                               ht.SimulationConfig(256, 2, seed=0), device=CPU))
    with pytest.raises(TypeError, match="normal-model closed form"):
        _analytic(ht.PricingProblem(ht.BarrierOption(95.0, EXPIRY, 80.0), _pmarket()))
    with pytest.raises(TypeError, match="unsupported"):
        ht.solve(ht.PricingProblem(_popt(), _pmarket()),
                 ht.MonteCarlo(ht.NormalDynamics(), ht.HestonQE(),
                               ht.SimulationConfig(256, 2, seed=0), device=CPU))


def test_calibration_recovers_sigma():
    """tests/unit/test_bachelier.py's lens-driven recovery of σ_N."""
    payoffs = [_popt(k) for k in (90.0, 100.0, 110.0)]
    quotes = torch.stack([_analytic(ht.PricingProblem(p, _pmarket(sigma=17.5)))
                          for p in payoffs])
    calib = ht.CalibrationProblem(
        ht.BasketPricingProblem(payoffs, _pmarket(sigma=10.0)), quotes,
        torch.tensor([10.0], dtype=torch.float64),
        pricing_method=ht.BachelierAnalytic(device=CPU),
        accessors=(ht.FieldLens("market_inputs.sigma"),),
    )
    sol = ht.solve(calib, ht.OptimizerAlgo(), lb=torch.tensor([1.0], dtype=torch.float64),
                   ub=torch.tensor([50.0], dtype=torch.float64))
    assert bool(sol.converged)
    assert float(sol.u[0]) == pytest.approx(17.5, abs=1e-4)
