"""models/heston_exact and the pure float64 exact-mixing estimator against
the JAX package on the CPU.  Both sides run the same formulas in float64, so
agreement is to near f64 rounding (rel 1e-12 for the closed forms; the
Newton and continued-fraction chains stay within a few ulps)."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods.montecarlo import _heston_exact_mixing_values as jax_exact_values
from hedgehog_tpu.models import heston_exact as jx
from hedgehog_tpu_torch.methods.heston_exact_mixing import heston_exact_mixing_values
from hedgehog_tpu_torch.models import heston_exact as px

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
T = 366 / 365
# (kappa, theta, sigma, dt, v0): the bench market at 2 segments, a
# Feller-violating market, and a short-segment high-vol-of-vol one
MARKETS = [(2.0, 0.04, 0.3, T / 2, 0.04), (6.21, 0.019, 0.61, 0.25, 0.010201),
           (1.0, 0.09, 1.0, 0.05, 0.09)]
RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol, atol=0.0)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.mark.parametrize("mkt", MARKETS)
def test_constants_and_coefficients(mkt):
    kappa, theta, sigma, dt_, _ = mkt
    for got, want in ((px.cir_exact_constants(kappa, theta, sigma, dt_),
                       jx.cir_exact_constants(kappa, theta, sigma, dt_)),
                      (px.cir_exact_shared_coeffs(kappa, theta, sigma),
                       jx.cir_exact_shared_coeffs(kappa, theta, sigma)),
                      (px.cir_exact_kernel_coeffs(kappa, theta, sigma, dt_),
                       jx.cir_exact_kernel_coeffs(kappa, theta, sigma, dt_))):
        assert got.keys() == want.keys()
        for name in want:
            _close(got[name], want[name])


@pytest.mark.parametrize("mkt", MARKETS)
def test_poisson_kmax_matches_reference(mkt):
    assert px.poisson_kmax(*mkt) == jx.poisson_kmax(*mkt)


def test_poisson_kmax_raises_on_untruncatable_rate():
    """σ ≈ 0.03: the noncentral χ² is near deterministic and its Poisson
    count explodes; both packages refuse rather than clamp."""
    args = (2.0, 0.04, 0.03, 0.5, 0.04)
    with pytest.raises(ValueError, match="Poisson trip count"):
        jx.poisson_kmax(*args)
    with pytest.raises(ValueError, match="Poisson trip count"):
        px.poisson_kmax(*args)


@pytest.mark.parametrize("nu", [-0.55, 0.78, 3.0])
def test_bessel_ratio(nu):
    z = np.geomspace(1e-3, 320.0, 257)
    _close(px.bessel_ratio(nu, _t(z)), jx.bessel_ratio(nu, jnp.asarray(z)))


@pytest.mark.parametrize("trips", [2, 3])
def test_lam_of_eta(trips):
    eta = np.linspace(-8.0, 8.0, 401)
    _close(px.lam_of_eta(_t(eta), trips), jx.lam_of_eta(jnp.asarray(eta), trips))


def test_gamma_qtl():
    alpha, z = np.meshgrid(np.geomspace(0.3, 60.0, 33), np.linspace(-5.5, 5.5, 45))
    _close(px.gamma_qtl(_t(alpha), _t(z)), jx.gamma_qtl(jnp.asarray(alpha), jnp.asarray(z)),
           rtol=1e-11)


def test_poisson_inv():
    rng = np.random.default_rng(1)
    mu, u = rng.uniform(0.0, 12.0, 2000), rng.uniform(0.0, 1.0, 2000)
    np.testing.assert_array_equal(px.poisson_inv(_t(mu), _t(u), 32).numpy(),
                                  np.asarray(jx.poisson_inv(jnp.asarray(mu), jnp.asarray(u), 32)))


@pytest.mark.parametrize("mkt", MARKETS)
def test_transition_moments_and_draw(mkt):
    kappa, theta, sigma, dt_, v0 = mkt
    rng = np.random.default_rng(2)
    n = 3000
    x = rng.gamma(2.0, theta / 2.0, n)
    u_pois, u_boost = rng.uniform(1e-6, 1.0, n), rng.uniform(1e-6, 1.0, n)
    z_gam, z_iv = rng.standard_normal(n), rng.standard_normal(n)
    kmax = px.poisson_kmax(*mkt)
    cp, cj = px.cir_exact_constants(kappa, theta, sigma, dt_), jx.cir_exact_constants(
        kappa, theta, sigma, dt_)
    y_p, ll_p = px.cir_exact_step_score(_t(x), _t(u_pois), _t(z_gam), _t(u_boost), cp, kmax)
    y_j, ll_j = jx.cir_exact_step_score(*(jnp.asarray(a) for a in (x, u_pois, z_gam, u_boost)),
                                        cj, kmax)
    _close(y_p, y_j, rtol=1e-11)
    _close(ll_p, ll_j, rtol=1e-11)
    m_p, s_p = px.iv_cond_moments(_t(x), y_p, cp)
    m_j, s_j = jx.iv_cond_moments(jnp.asarray(x), y_j, cj)
    _close(m_p, m_j, rtol=1e-10)
    _close(s_p, s_j, rtol=1e-9)  # l2 − l1/κ cancels a few digits
    _close(px.iv_gamma_draw(m_p, s_p, _t(z_iv)), jx.iv_gamma_draw(m_j, s_j, jnp.asarray(z_iv)),
           rtol=1e-9)


@pytest.mark.parametrize("cp", ["Call", "Put"])
def test_pure_estimator_per_path_matches_reference(cp):
    """Same seed and qmc=True: both estimators see the same Sobol' points, so
    the float64 per-path values agree (rel 1e-9; a Poisson count could only
    flip on an f64 threshold)."""
    market = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = hh.PricingProblem(hh.VanillaOption(105.0, EXPIRY, hh.European(), getattr(hh, cp)(),
                                              hh.Spot()), market)
    cfg = hh.SimulationConfig(trajectories=4096, steps=2, variance_reduction=hh.Antithetic(),
                              seed=3, qmc=True)
    want = np.asarray(jax_exact_values(prob, cfg, jax.random.PRNGKey(3), point_offset=64))
    got = heston_exact_mixing_values(ht.from_reference(prob), ht.from_reference(cfg),
                                     point_offset=64, device="cpu").numpy()
    assert got.shape == want.shape == (2, 4096)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
