"""The CEV family of the port (methods/cev.py, the CEV Euler grid of
methods/normal_lv_mc.py, the CEV dynamics of the 1-D PDE) against the JAX
package on the CPU.

``ncx2_cdf``, ``cev_survival`` and the call, put and digital prices agree
with JAX's to 1e-12 (the incomplete gamma runs JAX's own series and
continued fraction); the greeks through autograd agree with ``jax.grad``
to 1e-8, the β-greek included, which flows through the hand-written
backward of P(a, x) in ``a`` (forward mode too).  Under QMC the Euler grid
equals JAX's path by path to 1e-10, LSM on it stops on the same steps, and
the PDE agrees to 1e-10.  Then the JAX suite's oracles on the port:
parity, the downward skew, the digital as the strike derivative, the PRNG
grid against the closed form, the PDE against Schroder, and the guards
(tests/unit/test_cev.py:147)."""

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
from hedgehog_tpu_torch.methods import cev as pcev
from hedgehog_tpu_torch.methods import montecarlo as pmc

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)  # T = 1
S0, RATE, Q, BETA = 100.0, 0.05, 0.01, 0.5
SIGMA = 0.2 * S0 ** (1 - BETA)  # ~20% lognormal-equivalent at the spot
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jmarket(**kw):
    kw.setdefault("dividend_yield", Q)
    return hh.CEVInputs(REF, RATE, S0, SIGMA, BETA, **kw)


def _pmarket(spot=S0, sigma=SIGMA, beta=BETA, rate=RATE, q=Q):
    return ht.CEVInputs(REF, rate, spot, sigma, beta, dividend_yield=q)


def _popt(K, cp=None, style=None):
    return ht.VanillaOption(K, EXPIRY, style or ht.European(), cp or ht.Call(), ht.Spot())


def _analytic(payoff, market=None):
    return ht.solve(ht.PricingProblem(payoff, market or _pmarket()),
                    ht.CEVAnalytic(device=CPU)).price


def _cpu(method):
    port = ht.from_reference(method)
    if isinstance(port, ht.LSM):
        return dataclasses.replace(port, mc_method=dataclasses.replace(port.mc_method, device=CPU))
    return dataclasses.replace(port, device=CPU)


NCX2_CASES = [(5.0, 3.0, 2.0), (100.0, 4.0, 200.0), (2500.0, 20.0, 2400.0), (40.0, 0.5, 30.0),
              (1.0, 2.5, 0.0), (0.0, 3.0, 4.0), (60.0, 2.0, 90.0)]


def test_ncx2_cdf_matches_reference_and_scipy():
    from scipy.stats import ncx2

    for x, k, lam in NCX2_CASES:
        got = float(ht.ncx2_cdf(x, k, lam))
        assert got == pytest.approx(float(hh.ncx2_cdf(x, k, lam)), rel=1e-12, abs=1e-15)
        if x > 0.0 and lam > 0.0:
            assert got == pytest.approx(float(ncx2.cdf(x, k, lam)), rel=1e-10)
    with pytest.raises(ValueError, match="cannot cover"):
        ht.ncx2_cdf(10.0, 2.0, 2e5, terms=64)


def test_incomplete_gamma_derivatives_match_jax():
    """P(a, x) and ∂P/∂a, ∂P/∂x on both sides of the diagonal, reverse and
    forward mode, against jax.scipy.special.gammainc and jax.grad."""
    a = np.array([0.25, 1.5, 3.0, 20.0, 49.5, 50.5, 80.0, 1250.0, 1300.0])
    x = np.array([2.0, 0.5, 7.0, 25.0, 50.0, 50.0, 60.0, 1250.0, 1250.0])
    want = np.asarray(jax.scipy.special.gammainc(a, x))
    ga, gx = jax.vmap(jax.grad(jax.scipy.special.gammainc, argnums=(0, 1)))(a, x)
    at = torch.tensor(a, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    p = pcev.gammainc(at, xt)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-12, atol=1e-15)
    g_a, g_x = torch.autograd.grad(p.sum(), (at, xt))
    np.testing.assert_allclose(g_a.numpy(), np.asarray(ga), rtol=1e-8, atol=1e-15)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(gx), rtol=1e-8, atol=1e-15)
    _, tangent = torch.func.jvp(lambda u: pcev.gammainc(u, torch.tensor(x)),
                                (torch.tensor(a),), (torch.ones(len(a), dtype=torch.float64),))
    np.testing.assert_allclose(tangent.numpy(), np.asarray(ga), rtol=1e-8, atol=1e-15)


@pytest.mark.parametrize("q", [0.0, Q])
def test_prices_match_reference(q):
    ks = np.array([60.0, 80.0, 100.0, 120.0, 150.0])
    for cpj, cpp in ((hh.Call(), ht.Call()), (hh.Put(), ht.Put())):
        jgrid = hh.VanillaOption(jnp.asarray(ks), EXPIRY, hh.European(), cpj, hh.Spot())
        want = hh.solve(hh.PricingProblem(jgrid, _jmarket(dividend_yield=q)),
                        hh.CEVAnalytic()).price
        got = _analytic(ht.VanillaOption(ks, EXPIRY, ht.European(), cpp, ht.Spot()),
                        _pmarket(q=q))
        # atol 1e-13 of the spot: the deep out-of-the-money call is a
        # difference of two legs of the spot's size, whose lgamma-weighted
        # sums round differently in the two packages
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13 * S0)
        jd = hh.DigitalOption(100.0, EXPIRY, hh.European(), cpj, hh.Spot(), cash=3.0)
        want = hh.solve(hh.PricingProblem(jd, _jmarket(dividend_yield=q)), hh.CEVAnalytic()).price
        got = _analytic(ht.from_reference(jd), _pmarket(q=q))
        assert float(got) == pytest.approx(float(want), rel=1e-12)
    surv = ht.cev_survival(S0, 100.0, RATE - q, SIGMA, BETA, 1.0)
    assert float(surv) == pytest.approx(float(hh.cev_survival(S0, 100.0, RATE - q, SIGMA, BETA,
                                                              1.0)), rel=1e-12)


def test_greeks_match_jax_grad_including_beta():
    """tests/unit/test_cev.py:106 against jax.grad: delta, CEV-scale vega,
    rho, carry and the β-greek (through ∂P/∂a)."""
    def jprice(s, sg, b, r, q):
        m = hh.CEVInputs(REF, r, s, sg, b, dividend_yield=q)
        opt = hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())
        return hh.solve(hh.PricingProblem(opt, m), hh.CEVAnalytic()).price

    vals = (S0, SIGMA, BETA, RATE, Q)
    want = jax.grad(jprice, argnums=(0, 1, 2, 3, 4))(*vals)
    leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in vals]
    s, sg, b, r, q = leaves
    got = torch.autograd.grad(_analytic(_popt(100.0), _pmarket(s, sg, b, r, q)), leaves)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-8)
    assert 0.3 < float(got[0]) < 0.9 and float(got[1]) > 0.0
    eps = 1e-5
    fd = (float(_analytic(_popt(100.0), _pmarket(beta=BETA + eps)))
          - float(_analytic(_popt(100.0), _pmarket(beta=BETA - eps)))) / (2 * eps)
    assert float(got[2]) == pytest.approx(fd, rel=1e-5)


def test_parity_skew_and_digital_is_strike_derivative():
    for K in (85.0, 105.0):
        c = float(_analytic(_popt(K)))
        p = float(_analytic(_popt(K, ht.Put())))
        assert c - p == pytest.approx(S0 * math.exp(-Q) - K * math.exp(-RATE), abs=1e-10)
    m0 = _pmarket(q=0.0)
    ivs = [float(ht.implied_vol(_analytic(_popt(K), m0), K, 1.0, S0, RATE))
           for K in (80.0, 100.0, 120.0)]
    assert ivs[0] > ivs[1] > ivs[2]
    dig = ht.DigitalOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    pd = float(_analytic(dig))
    k = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
    (dk,) = torch.autograd.grad(_analytic(_popt(k)), k)
    assert pd == pytest.approx(-float(dk), rel=1e-9)
    put = dataclasses.replace(dig, call_put=ht.Put())
    assert pd + float(_analytic(put)) == pytest.approx(math.exp(-RATE), rel=1e-10)


@pytest.mark.parametrize("anti", [True, False])
def test_qmc_grid_matches_reference(anti):
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    cfg = hh.SimulationConfig(256, 12, vr, 5, True)
    # a high vol puts some paths on the absorbing boundary
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                             hh.CEVInputs(REF, RATE, S0, 9.0, BETA, dividend_yield=Q))
    method = hh.MonteCarlo(hh.CEVDynamics(), hh.EulerMaruyama(), cfg)
    want = np.asarray(jmc.simulate_price_grid(prob, method))
    got = pmc.simulate_price_grid(ht.from_reference(prob), _cpu(method)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert (want[:, -1] == 0.0).any()
    want = np.asarray(jmc.simulate_terminal_prices(prob, method))
    got = pmc.simulate_terminal_prices(ht.from_reference(prob), _cpu(method)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_pathwise_greeks_on_absorbing_paths_match_jax_grad():
    """The max(·, 0) tie rule and the absorbed paths' double where: delta and
    vega of the Euler solve (QMC) against jax.grad on the same points."""
    cfg = hh.SimulationConfig(256, 12, hh.Antithetic(), 5, True)
    method = hh.MonteCarlo(hh.CEVDynamics(), hh.EulerMaruyama(), cfg)

    def jprice(s, sg):
        m = hh.CEVInputs(REF, RATE, s, sg, BETA, dividend_yield=Q)
        opt = hh.VanillaOption(90.0, EXPIRY, hh.European(), hh.Put(), hh.Spot())
        return hh.solve(hh.PricingProblem(opt, m), method).price

    want = jax.grad(jprice, argnums=(0, 1))(S0, 9.0)
    leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (S0, 9.0)]
    price = ht.solve(ht.PricingProblem(_popt(90.0, ht.Put()), _pmarket(*leaves)), _cpu(method))
    got = torch.autograd.grad(price.price, leaves)
    for g, w in zip(got, want):
        assert np.isfinite(float(g))
        assert float(g) == pytest.approx(float(w), rel=1e-8)


def test_lsm_on_cev_grid_matches_reference():
    cfg = hh.SimulationConfig(1024, 16, hh.Antithetic(), 0, True)
    method = hh.LSM(hh.MonteCarlo(hh.CEVDynamics(), hh.EulerMaruyama(), cfg), 4)
    prob = hh.PricingProblem(hh.VanillaOption(110.0, EXPIRY, hh.American(), hh.Put(), hh.Spot()),
                             _jmarket())
    want = hh.solve(prob, method)
    got = ht.solve(ht.from_reference(prob), _cpu(method))
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    np.testing.assert_array_equal(got.stopping_info[0].numpy(), np.asarray(want.stopping_info[0]))
    np.testing.assert_allclose(got.stopping_info[1].numpy(), np.asarray(want.stopping_info[1]),
                               rtol=1e-10, atol=1e-12)
    eu = float(_analytic(_popt(110.0, ht.Put())))
    assert eu < float(got.price) < 1.3 * eu  # the early-exercise premium of the ITM put


def test_prng_euler_price_within_four_se_of_closed_form():
    """64 steps, 2^15 PRNG pairs: the Euler bias sits inside 4 SE
    (scripts/normal_lv_bias.py measures it)."""
    mc = ht.MonteCarlo(ht.CEVDynamics(), ht.EulerMaruyama(),
                       ht.SimulationConfig(1 << 15, 64, ht.Antithetic(), 3), device=CPU)
    prob = ht.PricingProblem(_popt(100.0), _pmarket())
    vals = ht.mc_path_values(prob, mc)
    D = math.exp(-RATE)
    p = D * float(vals.mean())
    se = D * float(vals.std()) / math.sqrt(vals.numel())
    assert abs(p - float(_analytic(_popt(100.0)))) <= 4.0 * se


def test_pde_matches_reference_and_schroder():
    """tests/unit/test_pde.py:243's CEV market on the JAX defaults (400 ×
    200): against JAX's PDE to 1e-10 and Schroder's closed form to 2e-4;
    the American put above the European."""
    jm = hh.CEVInputs(REF, 0.05, 100.0, sigma=2.0, beta=0.5)
    pde = hh.PDEMethod(dynamics=hh.CEVDynamics())
    for payoff in (hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                   hh.VanillaOption(110.0, EXPIRY, hh.American(), hh.Put(), hh.Spot()),
                   hh.BarrierOption(100.0, EXPIRY, 80.0, hh.European(), hh.Call(), hh.Spot(),
                                    hh.Down(), hh.KnockOut())):
        prob = hh.PricingProblem(payoff, jm)
        want = float(hh.solve(prob, pde).price)
        got = float(ht.solve(ht.from_reference(prob), _cpu(pde)).price)
        assert got == pytest.approx(want, rel=1e-10)
    pm = ht.from_reference(jm)
    cf = float(_analytic(_popt(100.0), pm))
    p_pde = float(ht.solve(ht.PricingProblem(_popt(100.0), pm), _cpu(pde)).price)
    assert p_pde == pytest.approx(cf, rel=2e-4)
    am = float(ht.solve(ht.PricingProblem(_popt(110.0, ht.Put(), ht.American()), pm),
                        _cpu(pde)).price)
    eu = float(ht.solve(ht.PricingProblem(_popt(110.0, ht.Put()), pm), _cpu(pde)).price)
    assert am > eu


def test_guards():
    """tests/unit/test_cev.py:147."""
    with pytest.raises(ValueError, match="beta"):
        ht.CEVInputs(REF, RATE, S0, SIGMA, 1.3)
    with pytest.raises(TypeError, match="CEVInputs"):
        _analytic(_popt(100.0), ht.BlackScholesInputs(REF, RATE, S0, 0.2))
    with pytest.raises(TypeError, match="European-only"):
        _analytic(_popt(100.0, ht.Put(), ht.American()))
    with pytest.raises(TypeError, match="no fused kernel"):
        ht.solve(ht.PricingProblem(_popt(100.0), _pmarket()),
                 ht.MonteCarlo(ht.CEVDynamics(), ht.EulerMaruyama(use_kernel=True),
                               ht.SimulationConfig(64, 2), device=CPU))
    with pytest.raises(TypeError, match="CEVInputs"):
        ht.solve(ht.PricingProblem(_popt(100.0), ht.BlackScholesInputs(REF, RATE, S0, 0.2)),
                 ht.PDEMethod(ht.CEVDynamics(), 40, 10, device=CPU))
    with pytest.raises(TypeError, match="no terminal law"):
        ht.solve(ht.PricingProblem(_popt(100.0), _pmarket()),
                 ht.CarrMadan(1.0, 32.0, ht.CEVDynamics(), device=CPU))
