"""The SABR family of the port (methods/sabr.py and the SABR Euler grid of
methods/normal_lv_mc.py) against the JAX package on the CPU.

``hagan_vol`` (its small-z series included) and the prices agree with
JAX's to 1e-12, the α, ρ, ν and spot greeks through autograd with
``jax.grad`` to 1e-8; under QMC the Euler grid (two normals a step,
step-major) equals JAX's path by path to 1e-10 and LSM on it stops on the
same steps.  Then the JAX suite's oracles on the port: the β = 1, ν = 0
corner is Black-Scholes, ρ < 0 skews the smile, the PRNG Euler price sits
within 4 SE plus Hagan's expansion error of the closed form, a smile
calibration recovers (α, ρ, ν), and the guards
(tests/unit/test_sabr.py:119)."""

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
from hedgehog_tpu.methods.sabr import hagan_vol as j_hagan
from hedgehog_tpu_torch.methods import montecarlo as pmc

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)  # T = 1 (ACT/365)
CPU = "cpu"
#: Hagan's expansion error bound at this market (sabr.py:22-24: ~1e-3 relative)
HAGAN_REL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jmarket(alpha=0.2, beta=0.7, rho=-0.3, nu=0.4, q=0.0):
    return hh.SABRInputs(REF, 0.03, 100.0, alpha, beta, rho, nu, dividend_yield=q)


def _pmarket(alpha=0.2, beta=0.7, rho=-0.3, nu=0.4, q=0.0, spot=100.0):
    return ht.SABRInputs(REF, 0.03, spot, alpha, beta, rho, nu, dividend_yield=q)


def _popt(strike=100.0, cp=None, style=None):
    return ht.VanillaOption(strike, EXPIRY, style or ht.European(), cp or ht.Call(), ht.Spot())


def _analytic(payoff, market=None):
    return ht.solve(ht.PricingProblem(payoff, market or _pmarket()),
                    ht.SABRAnalytic(device=CPU)).price


def _cpu(method):
    port = ht.from_reference(method)
    if isinstance(port, ht.LSM):
        return dataclasses.replace(port, mc_method=dataclasses.replace(port.mc_method, device=CPU))
    return dataclasses.replace(port, device=CPU)


@pytest.mark.parametrize("beta", [0.3, 0.7, 1.0])
def test_hagan_vol_matches_reference(beta):
    F, T = 100.0, 1.0
    ks = np.array([60.0, 85.0, F - 1e-3, F - 1e-7, F, F + 1e-7, F + 1e-3, 115.0, 160.0])
    # just outside the series window (|z| ~ 1e-4 at K = F ± 1e-3) x(z) is the
    # log of a ratio 1 + O(z): a last-bit difference of the two packages' log
    # comes back amplified by 1/z, so those two strikes hold to 1e-10
    near = np.isclose(np.abs(ks - F), 1e-3)
    for rho, nu in ((-0.3, 0.4), (0.5, 1.2), (0.0, 0.0)):
        want = np.asarray(j_hagan(F, jnp.asarray(ks), T, 0.2, beta, rho, nu))
        got = ht.hagan_vol(F, torch.tensor(ks), T, 0.2, beta, rho, nu).numpy()
        np.testing.assert_allclose(got[~near], want[~near], rtol=1e-12)
        np.testing.assert_allclose(got[near], want[near], rtol=1e-10)
    vols = ht.hagan_vol(F, torch.tensor(ks[2:7]), T, 0.2, beta, -0.3, 0.4).numpy()
    assert abs(vols[1] - vols[2]) < 1e-8 and abs(vols[3] - vols[2]) < 1e-8
    k = torch.tensor(F, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(ht.hagan_vol(F, k, T, 0.2, beta, -0.3, 0.4), k)
    want = jax.grad(lambda kk: j_hagan(F, kk, T, 0.2, beta, -0.3, 0.4))(F)
    assert float(g) == pytest.approx(float(want), rel=1e-8)


@pytest.mark.parametrize("q", [0.0, 0.02])
def test_prices_and_greeks_match_reference(q):
    ks = np.array([80.0, 95.0, 105.0, 125.0])
    for cpj, cpp in ((hh.Call(), ht.Call()), (hh.Put(), ht.Put())):
        jgrid = hh.VanillaOption(jnp.asarray(ks), EXPIRY, hh.European(), cpj, hh.Spot())
        want = hh.solve(hh.PricingProblem(jgrid, _jmarket(q=q)), hh.SABRAnalytic()).price
        got = _analytic(ht.VanillaOption(ks, EXPIRY, ht.European(), cpp, ht.Spot()),
                        _pmarket(q=q))
        # atol 1e-15 of the strikes: the deep out-of-the-money put is a
        # difference of two legs of the strike's size
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)

    def jprice(alpha, rho, nu, spot):
        m = hh.SABRInputs(REF, 0.03, spot, alpha, 0.7, rho, nu, dividend_yield=q)
        opt = hh.VanillaOption(95.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())
        return hh.solve(hh.PricingProblem(opt, m), hh.SABRAnalytic()).price

    vals = (0.2, -0.3, 0.4, 100.0)
    want = jax.grad(jprice, argnums=(0, 1, 2, 3))(*vals)
    a, r, n, s = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in vals)
    got = torch.autograd.grad(_analytic(_popt(95.0), _pmarket(a, 0.7, r, n, q, s)), (a, r, n, s))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-8)


def test_lognormal_corner_and_skew():
    p_sabr = float(_analytic(_popt(), _pmarket(0.2, 1.0, 0.0, 0.0)))
    p_bs = float(ht.solve(ht.PricingProblem(_popt(), ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)),
                          ht.BlackScholesAnalytic(device=CPU)).price)
    assert p_sabr == pytest.approx(p_bs, rel=1e-12)
    vols = ht.hagan_vol(100.0, torch.tensor([85.0, 100.0, 115.0], dtype=torch.float64), 1.0,
                        0.2, 0.7, -0.5, 0.5)
    assert float(vols[0]) > float(vols[1])
    grid = _analytic(ht.VanillaOption(np.array([85.0, 95.0, 105.0, 120.0]), EXPIRY))
    assert bool((torch.diff(grid) < 0).all())


@pytest.mark.parametrize("anti", [True, False])
def test_qmc_grid_matches_reference(anti):
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    cfg = hh.SimulationConfig(256, 10, vr, 4, True)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                             _jmarket(q=0.01))
    method = hh.MonteCarlo(hh.SABRDynamics(), hh.EulerMaruyama(), cfg)
    for fn in ("simulate_price_grid", "simulate_terminal_prices"):
        want = np.asarray(getattr(jmc, fn)(prob, method))
        got = getattr(pmc, fn)(ht.from_reference(prob), _cpu(method)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_lsm_on_sabr_grid_matches_reference():
    cfg = hh.SimulationConfig(1024, 16, hh.Antithetic(), 0, True)
    method = hh.LSM(hh.MonteCarlo(hh.SABRDynamics(), hh.EulerMaruyama(), cfg), 4)
    prob = hh.PricingProblem(hh.VanillaOption(105.0, EXPIRY, hh.American(), hh.Put(), hh.Spot()),
                             _jmarket())
    want = hh.solve(prob, method)
    got = ht.solve(ht.from_reference(prob), _cpu(method))
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    np.testing.assert_array_equal(got.stopping_info[0].numpy(), np.asarray(want.stopping_info[0]))
    assert float(got.price) > float(_analytic(_popt(105.0, ht.Put())))


def test_prng_euler_price_against_hagan():
    """tests/unit/test_sabr.py's agreement on the PRNG stream: 2^15 pairs ×
    64 steps within 4 SE plus Hagan's expansion error (HAGAN_REL)."""
    prob = ht.PricingProblem(_popt(100.0), _pmarket())
    mc = ht.MonteCarlo(ht.SABRDynamics(), ht.EulerMaruyama(),
                       ht.SimulationConfig(1 << 15, 64, ht.Antithetic(), 2), device=CPU)
    vals = ht.mc_path_values(prob, mc)
    D = math.exp(-0.03)
    p = D * float(vals.mean())
    se = D * float(vals.std()) / math.sqrt(vals.numel())
    want = float(_analytic(_popt(100.0)))
    assert abs(p - want) <= 4.0 * se + HAGAN_REL * want


def test_smile_calibration_roundtrip():
    """tests/unit/test_sabr.py's recovery of (α, ρ, ν) at fixed β from Hagan
    smile prices."""
    strikes = [80.0, 90.0, 100.0, 110.0, 125.0]
    payoffs = [_popt(k) for k in strikes]
    quotes = torch.stack([_analytic(p, _pmarket(0.25, 0.7, -0.4, 0.6)) for p in payoffs])
    calib = ht.CalibrationProblem(
        ht.BasketPricingProblem(payoffs, _pmarket(0.15, 0.7, -0.1, 0.3)), quotes,
        torch.tensor([0.15, -0.1, 0.3], dtype=torch.float64),
        pricing_method=ht.SABRAnalytic(device=CPU),
        accessors=(ht.FieldLens("market_inputs.alpha"), ht.FieldLens("market_inputs.rho"),
                   ht.FieldLens("market_inputs.nu")),
    )
    sol = ht.solve(calib, ht.OptimizerAlgo(max_iters=300),
                   lb=torch.tensor([0.01, -0.95, 0.01], dtype=torch.float64),
                   ub=torch.tensor([2.0, 0.95, 3.0], dtype=torch.float64))
    assert bool(sol.converged)
    a, r_, n_ = (float(x) for x in sol.u)
    assert a == pytest.approx(0.25, rel=3e-2)
    assert r_ == pytest.approx(-0.4, rel=5e-2)
    assert n_ == pytest.approx(0.6, rel=5e-2)


def test_guards():
    """tests/unit/test_sabr.py:119."""
    with pytest.raises(TypeError, match="no terminal law"):
        ht.solve(ht.PricingProblem(_popt(), _pmarket()),
                 ht.CarrMadan(1.0, 32.0, ht.SABRDynamics(), device=CPU))
    with pytest.raises(TypeError, match="European-only"):
        _analytic(_popt(100.0, ht.Put(), ht.American()))
    with pytest.raises(TypeError, match="no fused kernel"):
        ht.solve(ht.PricingProblem(_popt(), _pmarket()),
                 ht.MonteCarlo(ht.SABRDynamics(), ht.EulerMaruyama(use_kernel=True),
                               ht.SimulationConfig(128, 2), device=CPU))
    with pytest.raises(TypeError, match="implied-vol formula"):
        _analytic(ht.DigitalOption(100.0, EXPIRY))
    with pytest.raises(TypeError, match="supports Lognormal/CEV/LocalVol"):
        ht.solve(ht.PricingProblem(_popt(), _pmarket()),
                 ht.PDEMethod(ht.SABRDynamics(), 40, 10, device=CPU))
