"""Stochastic local vol in the port (models/slv.py, the SLV branch of
methods/heston_euler.py) against the JAX package on the CPU.

The Nadaraya–Watson conditional variance and one step of the shared
CIR-family Euler update agree with JAX's on the same particle cloud to
1e-12.  The particle calibration, given the normals JAX draws, returns
JAX's leverage surface to 1e-10 (the port's own calibration draws Philox
and agrees in law: tests/test_torch_slv_oracles.py).  On JAX's calibrated
leverage, carried across by ``from_reference``, the SLV Euler grid under
QMC equals JAX's path by path to 1e-10 and LSM on it stops on the same
steps.  On the PRNG stream a leverage of ones at mixing 1 is the port's
Heston Euler path to 1e-12.  Then the guards (tests/unit/test_slv.py:93-105)
and the leverage lookup's clamps."""

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
from hedgehog_tpu.models import dynamics as jdyn
from hedgehog_tpu.models import slv as jslv
from hedgehog_tpu_torch.methods import montecarlo as pmc
from hedgehog_tpu_torch.models import dynamics as pdyn
from hedgehog_tpu_torch.models import slv as pslv

REF = dt.date(2025, 1, 1)
EXPIRY = dt.date(2026, 1, 1)
CPU = "cpu"
CAL = dict(steps=8, paths=2048, bins=21)
CAL_SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _skew_surface():
    strikes = np.array([70.0, 85.0, 100.0, 115.0, 130.0])
    vols = np.stack([np.clip(0.25 - 0.10 * np.log(strikes / 100.0), 0.12, 0.45)] * 2)
    return hh.RectVolSurface(REF, np.array([0.5, 1.5]), strikes, vols, interp_strike="cubic")


def _jmarket(mixing=1.0, surface=None):
    return hh.SLVInputs(REF, 0.03, 100.0, V0=0.0625, kappa=1.5, theta=0.0625, sigma=0.5,
                        rho=-0.6, sigma_surface=_skew_surface() if surface is None else surface,
                        mixing=mixing, dividend_yield=0.01)


@pytest.fixture(scope="module")
def calibrated():
    """(JAX market with JAX's leverage, JAX's normals of that calibration)."""
    m = _jmarket()
    lev = hh.calibrate_leverage(m, EXPIRY, seed=CAL_SEED, **CAL)
    z = jax.random.normal(jax.random.PRNGKey(CAL_SEED), (CAL["steps"], 2, CAL["paths"]),
                          dtype=jnp.float64)
    return m.with_leverage(lev), np.asarray(z)


def _cpu(method):
    port = ht.from_reference(method)
    if isinstance(port, ht.LSM):
        return dataclasses.replace(port, mc_method=dataclasses.replace(port.mc_method, device=CPU))
    return dataclasses.replace(port, device=CPU)


def _cloud(n=3000):
    rng = np.random.default_rng(11)
    x = np.log(100.0) + 0.25 * rng.standard_normal(n)
    v = np.abs(0.06 + 0.03 * rng.standard_normal(n))
    return x, v, np.linspace(3.9, 5.3, 17)


def test_conditional_variance_matches_reference():
    x, v, grid = _cloud()
    for bw in (0.03, 0.2):
        want = np.asarray(jslv._conditional_variance(jnp.asarray(x), jnp.asarray(v),
                                                     jnp.asarray(grid), bw))
        got = pslv._conditional_variance(torch.tensor(x), torch.tensor(v), torch.tensor(grid), bw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_cir_family_euler_step_matches_reference():
    x, v, grid = _cloud()
    v = v - 0.05  # some particles truncated
    rng = np.random.default_rng(5)
    z1, z2 = rng.standard_normal((2, x.size))
    lev_row = 1.0 + 0.3 * np.sin(np.arange(grid.size))
    kw = dict(fk=0.02, kappa=1.5, theta=0.06, sig_v=0.5, rho=-0.6, rho_bar=np.sqrt(1 - 0.36),
              dt=1 / 64, sqrt_dt=np.sqrt(1 / 64))
    want = jdyn.cir_family_euler_update(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(z1), jnp.asarray(z2),
        lev_x=jnp.interp(jnp.asarray(x), jnp.asarray(grid), jnp.asarray(lev_row)), **kw)
    got = pdyn.cir_family_euler_update(
        torch.tensor(x), torch.tensor(v), torch.tensor(z1), torch.tensor(z2),
        lev_x=ht.interp1d(torch.tensor(x), torch.tensor(grid), torch.tensor(lev_row)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_calibration_on_jax_normals_matches_reference(calibrated):
    m, z = calibrated
    lev = pslv._particle_leverage(ht.from_reference(dataclasses.replace(m, leverage=None)),
                                  EXPIRY, torch.tensor(z), bins=CAL["bins"], device=CPU)
    for name in ("t_grid", "x_grid", "values"):
        np.testing.assert_allclose(getattr(lev, name).numpy(), np.asarray(getattr(m.leverage, name)),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("anti", [True, False])
def test_qmc_grid_on_jax_leverage_matches_reference(calibrated, anti):
    m, _ = calibrated
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    method = hh.MonteCarlo(hh.SLVDynamics(), hh.EulerMaruyama(),
                           hh.SimulationConfig(256, 8, vr, 0, True))
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                             m)
    for fn in ("simulate_price_grid", "simulate_terminal_prices"):
        want = np.asarray(getattr(jmc, fn)(prob, method))
        got = getattr(pmc, fn)(ht.from_reference(prob), _cpu(method)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_lsm_on_slv_grid_matches_reference(calibrated):
    m, _ = calibrated
    method = hh.LSM(hh.MonteCarlo(hh.SLVDynamics(), hh.EulerMaruyama(),
                                  hh.SimulationConfig(1024, 8, hh.Antithetic(), 0, True)), 3)
    prob = hh.PricingProblem(hh.VanillaOption(105.0, EXPIRY, hh.American(), hh.Put(), hh.Spot()),
                             m)
    want = hh.solve(prob, method)
    got = ht.solve(ht.from_reference(prob), _cpu(method))
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    np.testing.assert_array_equal(got.stopping_info[0].numpy(), np.asarray(want.stopping_info[0]))


def test_unit_leverage_is_heston_euler_on_prng():
    """Leverage 1 at mixing 1 on a flat curve steps the Heston Euler draws
    (Philox tag 0); σ² enters as (√V⁺)², not V⁺, so to ~1e-12."""
    heston = (0.04, 2.0, 0.05, 0.4, -0.7)
    cfg = ht.SimulationConfig(4096, 12, ht.Antithetic(), 9)
    ones = ht.LeverageSurface(torch.arange(12, dtype=torch.float64) / 12,
                              torch.tensor([3.0, 6.0], dtype=torch.float64),
                              torch.ones((12, 2), dtype=torch.float64))
    slv = ht.SLVInputs(REF, 0.03, 100.0, *heston, sigma_surface=0.2, mixing=1.0,
                       leverage=ones)
    hes = ht.HestonInputs(REF, 0.03, 100.0, *heston)
    call = ht.VanillaOption(100.0, EXPIRY)
    got = pmc.simulate_price_grid(ht.PricingProblem(call, slv), ht.MonteCarlo(
        ht.SLVDynamics(), ht.EulerMaruyama(), cfg, device=CPU))
    want = pmc.simulate_price_grid(ht.PricingProblem(call, hes), ht.MonteCarlo(
        ht.HestonDynamics(), ht.EulerMaruyama(), cfg, device=CPU))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_leverage_lookup_clamps():
    """tests/unit/test_slv.py:165."""
    lev = ht.LeverageSurface(t_grid=torch.tensor([0.0, 0.5], dtype=torch.float64),
                             x_grid=torch.tensor([4.0, 4.5, 5.0], dtype=torch.float64),
                             values=torch.tensor([[1.0, 2.0, 3.0], [2.0, 3.0, 4.0]],
                                                 dtype=torch.float64))
    assert float(ht.leverage_at(lev, 0.2, torch.tensor(4.25))) == pytest.approx(1.5)
    assert float(ht.leverage_at(lev, 0.9, torch.tensor(3.0))) == pytest.approx(2.0)
    assert float(ht.leverage_at(lev, -0.1, torch.tensor(9.0))) == pytest.approx(3.0)


def test_guards():
    """tests/unit/test_slv.py:93-105."""
    m = ht.from_reference(_jmarket())
    call = ht.VanillaOption(100.0, EXPIRY)
    mc = ht.MonteCarlo(ht.SLVDynamics(), ht.EulerMaruyama(),
                       ht.SimulationConfig(64, 2, ht.Antithetic(), 7), device=CPU)
    with pytest.raises(ValueError, match="calibrate_leverage"):
        ht.solve(ht.PricingProblem(call, m), mc)
    with pytest.raises(TypeError, match="no terminal law"):
        ht.solve(ht.PricingProblem(call, m), ht.CarrMadan(dynamics=ht.SLVDynamics(), device=CPU))
    with pytest.raises(TypeError, match="no fused kernel"):
        ht.solve(ht.PricingProblem(call, m),
                 dataclasses.replace(mc, strategy=ht.EulerMaruyama(use_kernel=True)))
