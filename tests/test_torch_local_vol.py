"""Dupire local volatility in the port (models/local_vol.py, the local-vol
Euler grid of methods/normal_lv_mc.py, the local-vol dynamics of the 1-D
PDE) against the JAX package on the CPU.

``dupire_local_vol`` agrees with JAX's to 1e-12 relative on a flat
surface (σ exactly), on the cubic Heston-implied surface of
tests/unit/test_local_vol.py:33-50 (its implied vols come from the port's
Carr–Madan here and go to both packages as numbers) and on an SVI surface;
its spot, rate and surface gradients agree with ``jax.grad`` to 1e-8, and
inside ``torch.no_grad()`` it returns a tensor with no graph.  Under QMC
the local-vol Euler grid equals JAX's path by path to 1e-10 (the PDE's
rows: tests/test_torch_local_vol_pde.py).  Then the JAX suite's oracles on
the port: the flat surface is GBM, the Dupire round trip reprices the
Heston vanillas (test_local_vol.py:53), the skew, and the dividend-schedule
guard."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import montecarlo as pmc

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)  # T = 1 (ACT/365)
CPU = "cpu"
TENORS = np.array([0.25, 0.5, 1.0, 1.5, 2.0])
STRIKES = np.array([70.0, 80.0, 90.0, 100.0, 110.0, 120.0, 135.0])
HESTON = (0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def heston_ivs():
    """Heston Carr–Madan prices inverted to implied vols on the (tenor ×
    strike) grid (the port's Carr–Madan and implied vol)."""
    hmkt = ht.HestonInputs(REF, *HESTON)
    cm = ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device=CPU)
    ivs = []
    for tt in TENORS:
        po = ht.VanillaOption(torch.tensor(STRIKES), ht.add_yearfrac(REF, float(tt)))
        px = ht.solve(ht.PricingProblem(po, hmkt), cm).price
        ivs.append(ht.implied_vol_bs(px, torch.tensor(STRIKES), float(tt), 100.0, 0.03).numpy())
    return np.stack(ivs)


def _markets(ivs, q=0.0):
    j = hh.BlackScholesInputs(REF, 0.03, 100.0, hh.RectVolSurface(
        REF, jnp.asarray(TENORS), jnp.asarray(STRIKES), jnp.asarray(ivs), interp_time="linear",
        interp_strike="cubic"), dividend_yield=q)
    p = ht.BlackScholesInputs(REF, 0.03, 100.0, ht.RectVolSurface(
        REF, torch.tensor(TENORS), torch.tensor(STRIKES), torch.tensor(ivs),
        interp_time="linear", interp_strike="cubic"), dividend_yield=q)
    return j, p


def _grid():
    ts = np.array([0.0, 0.1, 0.3, 0.5, 0.77, 1.0, 1.3, 2.0, 2.5])
    ks = np.array([55.0, 75.0, 90.0, 100.0, 112.0, 130.0, 150.0])
    return np.meshgrid(ts, ks, indexing="ij")


def _jax_lv(market, T, K):
    f = jax.vmap(jax.vmap(lambda t, k: hh.dupire_local_vol(market, t, k)))
    return np.asarray(f(jnp.asarray(T), jnp.asarray(K)))


def test_flat_surface_is_sigma():
    flat = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
    assert ht.dupire_local_vol(flat, 0.5, 110.0) == 0.2
    assert float(hh.dupire_local_vol(hh.BlackScholesInputs(REF, 0.03, 100.0, 0.2), 0.5,
                                     110.0)) == 0.2


@pytest.mark.parametrize("q", [0.0, 0.02])
def test_cubic_surface_matches_reference(heston_ivs, q):
    jm, pm = _markets(heston_ivs, q)
    T, K = _grid()
    got = ht.dupire_local_vol(pm, torch.tensor(T), torch.tensor(K))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), _jax_lv(jm, T, K), rtol=1e-12)


def test_svi_surface_matches_reference():
    tenors = np.array([0.25, 0.5, 1.0])
    fwds = 100.0 * np.exp(0.03 * tenors)
    params = np.array([[0.010, 0.10, -0.30, 0.00, 0.20], [0.018, 0.12, -0.35, 0.02, 0.25],
                       [0.032, 0.14, -0.40, 0.05, 0.30]])
    jm = hh.BlackScholesInputs(REF, 0.03, 100.0, hh.SVIVolSurface(
        REF, jnp.asarray(tenors), jnp.asarray(params), jnp.asarray(fwds)))
    pm = ht.BlackScholesInputs(REF, 0.03, 100.0, ht.SVIVolSurface(
        REF, torch.tensor(tenors), torch.tensor(params), torch.tensor(fwds), device=CPU))
    T, K = _grid()
    got = ht.dupire_local_vol(pm, torch.tensor(T), torch.tensor(K))
    np.testing.assert_allclose(got.numpy(), _jax_lv(jm, T, K), rtol=1e-12)


def test_gradients_match_jax_grad_and_no_grad_gives_no_graph(heston_ivs):
    jm, _ = _markets(heston_ivs)

    def jlv(spot, rate, vols):
        surf = dataclasses.replace(jm.sigma, vols=vols)
        m = hh.BlackScholesInputs(REF, rate, spot, surf)
        return hh.dupire_local_vol(m, 0.77, 93.0)

    want = jax.grad(jlv, argnums=(0, 1, 2))(100.0, 0.03, jnp.asarray(heston_ivs))
    spot, rate, vols = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                        for x in (100.0, 0.03, heston_ivs))
    pm = ht.BlackScholesInputs(REF, rate, spot, ht.RectVolSurface(
        REF, torch.tensor(TENORS), torch.tensor(STRIKES), vols, interp_strike="cubic"))
    lv = ht.dupire_local_vol(pm, 0.77, 93.0)
    got = torch.autograd.grad(lv, (spot, rate, vols))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-12)
    with torch.no_grad():
        lv0 = ht.dupire_local_vol(pm, 0.77, 93.0)
    assert lv0.grad_fn is None and not lv0.requires_grad
    assert float(lv0) == float(lv)


def test_local_vol_sees_the_skew(heston_ivs):
    _, pm = _markets(heston_ivs)
    lo, atm, hi = (float(ht.dupire_local_vol(pm, 1.0, k)) for k in (80.0, 100.0, 120.0))
    assert lo > atm > hi


@pytest.mark.parametrize("anti", [True, False])
def test_qmc_grid_matches_reference(heston_ivs, anti):
    jm, _ = _markets(heston_ivs, 0.01)
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    cfg = hh.SimulationConfig(192, 6, vr, 2, True)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                             jm)
    method = hh.MonteCarlo(hh.LocalVolDynamics(), hh.EulerMaruyama(), cfg)
    want = np.asarray(jmc.simulate_price_grid(prob, method))
    got = pmc.simulate_price_grid(ht.from_reference(prob),
                                  dataclasses.replace(ht.from_reference(method), device=CPU))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_flat_surface_mc_is_gbm():
    """tests/unit/test_local_vol.py:19, 2^15 QMC pairs × 16 steps."""
    flat = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
    opt = ht.VanillaOption(100.0, EXPIRY)
    cfg = ht.SimulationConfig(1 << 15, 16, ht.Antithetic(), 0, True)
    p_lv = float(ht.solve(ht.PricingProblem(opt, flat), ht.MonteCarlo(
        ht.LocalVolDynamics(), ht.EulerMaruyama(), cfg, device=CPU)).price)
    p_bs = float(ht.solve(ht.PricingProblem(opt, flat), ht.BlackScholesAnalytic(device=CPU)).price)
    assert p_lv == pytest.approx(p_bs, rel=2e-3)


def test_dupire_roundtrip_reprices_the_surface(heston_ivs):
    """tests/unit/test_local_vol.py:53: LV Monte Carlo (2^15 QMC pairs × 50
    steps) on the Heston-implied surface reprices the Heston vanillas."""
    _, pm = _markets(heston_ivs)
    hmkt = ht.HestonInputs(REF, *HESTON)
    cm = ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device=CPU)
    cfg = ht.SimulationConfig(1 << 15, 50, ht.Antithetic(), 0, True)
    ks = [90.0, 100.0, 110.0]
    mc = ht.MonteCarlo(ht.LocalVolDynamics(), ht.EulerMaruyama(), cfg, device=CPU)
    got = ht.solve(ht.PricingProblem(ht.VanillaOption(torch.tensor(ks), EXPIRY), pm), mc).price
    for K, tol, g in zip(ks, (3e-3, 3e-3, 5e-3), got):
        want = float(ht.solve(ht.PricingProblem(ht.VanillaOption(K, EXPIRY), hmkt), cm).price)
        assert float(g) == pytest.approx(want, rel=tol), K


def test_dividend_schedule_is_refused(heston_ivs):
    _, pm = _markets(heston_ivs)
    divs = ht.DividendSchedule((dt.date(2024, 6, 1),), torch.tensor([1.0], dtype=torch.float64))
    m = dataclasses.replace(pm, dividends=divs)
    with pytest.raises(TypeError, match="DividendSchedule"):
        ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY), m),
                 ht.MonteCarlo(ht.LocalVolDynamics(), ht.EulerMaruyama(),
                               ht.SimulationConfig(64, 2), device=CPU))
