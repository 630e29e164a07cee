"""The port's CF-inversion sampler (hedgehog_tpu_torch/distributions/
sample_from_cf.py) against the JAX package's, on the gamma and exponential
laws of tests/unit/test_sample_from_cf.py, and the cases of that file.

Tolerances: the port's series against JAX's to 1e-12 relative in the
mean and 1e-11 in std, h and the weights (of the largest weight; see
``_assert_series_close``), the CDF and its inverse to 1e-12;
against the analytic laws, the JAX tests' own (atol 2e-3 on the CDF, rel
2e-3 / 1e-2 on the moments); the port's draws come from its own Philox
stream, so they agree with the law, not with JAX's draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammainc
from scipy.special import gammainc as sp_gammainc

import hedgehog_tpu.distributions.sample_from_cf as jsf
from hedgehog_tpu_torch.distributions.sample_from_cf import (
    CFSeries,
    cdf_from_cf,
    cdf_series_weights,
    invert_cdf_series,
    moments_from_cf,
    sample_from_cf,
    truncation_error_estimate,
)

K_SHAPE, THETA = 2.5, 1.3  # Gamma(k, θ): cf(a) = (1 − iθa)^{−k}
LAM = 0.7  # Exponential(λ): cf(a) = λ/(λ − ia)
RTOL = 1e-12


def gamma_cf(a):
    return (1.0 - 1j * THETA * torch.as_tensor(a, dtype=torch.complex128)) ** (-K_SHAPE)


def gamma_cf_jax(a):
    return (1.0 - 1j * THETA * a) ** (-K_SHAPE)


def exp_cf(a):
    return LAM / (LAM - 1j * torch.as_tensor(a, dtype=torch.complex128))


def exp_cf_jax(a):
    return LAM / (LAM - 1j * a)


def gamma_cdf(x):
    return sp_gammainc(K_SHAPE, np.asarray(x) / THETA)


def _assert_series_close(got, want, rtol=RTOL):
    """mean to ``rtol``; std, h and the weights at h·j to 10·rtol: the
    second difference at h0 = 1e-2 amplifies φ's rounding by 1/(h0²·E[X²])
    and the variance E[X²] − mean² by E[X²]/var (~1e4·3.5 for Gamma(2.5,
    0.5))."""
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=rtol)
    for field in ("std", "h"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=10 * rtol)
    w = np.asarray(want.weights)
    np.testing.assert_allclose(got.weights.numpy(), w, rtol=0, atol=10 * rtol * np.abs(w).max())


@pytest.mark.parametrize("law", ["gamma", "exponential"])
def test_moments_from_cf(law):
    cf, cf_jax = (gamma_cf, gamma_cf_jax) if law == "gamma" else (exp_cf, exp_cf_jax)
    mean, std = moments_from_cf(cf)
    want_mean, want_std = jsf.moments_from_cf(cf_jax)
    assert float(mean) == pytest.approx(float(want_mean), rel=RTOL)
    assert float(std) == pytest.approx(float(want_std), rel=10 * RTOL)
    true_mean, true_std = ((K_SHAPE * THETA, np.sqrt(K_SHAPE) * THETA) if law == "gamma"
                           else (1 / LAM, 1 / LAM))
    # central differences at h0 = 1e-2 carry an O(h0²) bias (sample_from_cf.jl:50)
    assert float(mean) == pytest.approx(true_mean, rel=2e-3)
    assert float(std) == pytest.approx(true_std, rel=1e-2)


@pytest.mark.parametrize("law, n_terms", [("gamma", 256), ("exponential", 512)])
def test_series_and_cdf_match_reference(law, n_terms):
    cf, cf_jax = (gamma_cf, gamma_cf_jax) if law == "gamma" else (exp_cf, exp_cf_jax)
    series = cdf_series_weights(cf, n_terms=n_terms)
    want = jsf.cdf_series_weights(cf_jax, n_terms=n_terms)
    _assert_series_close(series, want)
    x = np.linspace(0.05, 12.0 if law == "gamma" else 8.0, 200)
    got = cdf_from_cf(torch.from_numpy(x), series).numpy()
    np.testing.assert_allclose(got, np.asarray(jsf.cdf_from_cf(jnp.asarray(x), want)), rtol=0,
                               atol=RTOL)
    exact = gamma_cdf(x) if law == "gamma" else 1.0 - np.exp(-LAM * x)
    np.testing.assert_allclose(got, exact, atol=2e-3 if law == "gamma" else 5e-3)


def test_invert_cdf_roundtrip_matches_reference():
    series = cdf_series_weights(gamma_cf, n_terms=256)
    u = np.linspace(0.02, 0.98, 97)
    x = invert_cdf_series(torch.from_numpy(u), series).numpy()
    want = np.asarray(jsf.invert_cdf_series(jnp.asarray(u),
                                            jsf.cdf_series_weights(gamma_cf_jax, n_terms=256)))
    np.testing.assert_allclose(x, want, rtol=RTOL)
    np.testing.assert_allclose(gamma_cdf(x), u, atol=2e-3)


def test_sample_from_cf_ks():
    """KS distance of 20k draws from the port's Philox stream against the
    analytic gamma CDF: 1.63/√n plus the series tolerance."""
    xs = np.sort(sample_from_cf(0, gamma_cf, 20_000, n_terms=256).numpy())
    emp = (np.arange(1, xs.size + 1) - 0.5) / xs.size
    assert np.max(np.abs(gamma_cdf(xs) - emp)) < 1.63 / np.sqrt(xs.size) + 2e-3
    again = sample_from_cf(0, gamma_cf, 64, n_terms=256)
    other = sample_from_cf(1, gamma_cf, 64, n_terms=256)
    assert torch.equal(again, torch.from_numpy(np.asarray(
        sample_from_cf(0, gamma_cf, 20_000, n_terms=256)[:64])))
    assert not torch.equal(again, other)


def test_truncation_error_estimate_orders():
    """The tail estimate flags a too-short series and passes a long one."""
    e_short = float(truncation_error_estimate(cdf_series_weights(gamma_cf, n_terms=8)))
    e_long = float(truncation_error_estimate(cdf_series_weights(gamma_cf, n_terms=512)))
    assert e_long < 1e-3 < e_short * 50
    assert e_long < e_short / 10
    want = jsf.truncation_error_estimate(jsf.cdf_series_weights(gamma_cf_jax, n_terms=512))
    assert e_long == pytest.approx(float(want), rel=1e-10)


def test_stateful_cf_carry_threading():
    """A CF with a carry sees its frequencies in increasing order, the
    carry threaded through the moments and the series; a block of B
    frequencies a call gives the same series."""
    seen = []

    def cf(a, count):
        seen.append(torch.as_tensor(a).reshape(-1)[-1].item())
        return gamma_cf(a), count + 1.0

    series = cdf_series_weights(cf, n_terms=64, carry0=torch.tensor(0.0, dtype=torch.float64))
    x = np.linspace(0.1, 8.0, 50)
    np.testing.assert_allclose(cdf_from_cf(torch.from_numpy(x), series).numpy(), gamma_cdf(x),
                               atol=5e-3)
    assert np.all(np.diff(seen[2:]) > 0)  # after the two moment evaluations at ±h0
    for block in (8, 64):
        blocked = cdf_series_weights(cf, n_terms=64, carry0=torch.tensor(0.0), block_size=block)
        assert torch.equal(blocked.weights, series.weights)
    with pytest.raises(ValueError, match="divide"):
        cdf_series_weights(cf, n_terms=64, carry0=torch.tensor(0.0), block_size=7)


def test_batched_cf():
    """A batched CF (one law per lane) builds per-lane series, as JAX's."""
    thetas = np.array([0.5, 1.0, 2.0])

    def cf(a):
        return (1.0 - 1j * torch.from_numpy(thetas) * torch.as_tensor(a, dtype=torch.float64)) ** (
            -K_SHAPE)

    def cf_jax(a):
        return (1.0 - 1j * jnp.asarray(thetas) * a) ** (-K_SHAPE)

    series = cdf_series_weights(cf, n_terms=256)
    assert series.weights.shape == (256, 3)
    _assert_series_close(series, jsf.cdf_series_weights(cf_jax, n_terms=256))
    got = cdf_from_cf(torch.full((3,), 2.0, dtype=torch.float64), series).numpy()
    np.testing.assert_allclose(got, np.asarray(gammainc(K_SHAPE, 2.0 / jnp.asarray(thetas))),
                               atol=2e-3)
    grid = cdf_from_cf(torch.full((4, 3), 2.0, dtype=torch.float64), series)
    assert grid.shape == (4, 3) and torch.equal(grid[2], torch.from_numpy(got))
    assert isinstance(series, CFSeries)
