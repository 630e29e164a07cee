"""The port's Broadie-Kaya sampler (hedgehog_tpu_torch/distributions/
broadie_kaya.py, ``HestonBroadieKaya``) against the JAX package's, and the
cases of tests/agreement/test_broadie_kaya.py, on the CPU.

The draws cannot match JAX's (``jax.random.poisson``/``gamma`` against the
port's Philox stream), so each step is held on the same inputs:

- the ∫V CDF series for one V_T vector: the port's closed-form moments
  against JAX's central differences to the latter's accuracy (1e-6, 2e-6;
  see ``test_series_moments_match_reference``), the weights at the
  reference's own frequencies h·j to 1e-10 of each path's largest weight;
- ∫V from the same V_T and uniforms to 1e-9 through the port's series at
  the reference's moments, 1e-12 through the reference's series, and 1e-8
  through the port's own closed-form moments (see
  ``test_integrated_variance_from_the_same_uniforms``);
- the close from the same (V_T, ∫V, z) to 1e-12;
- block-size independence of the series at 1e-12;
- prices in law: within 4 standard errors of Carr-Madan (the JAX test's
  market), and the JAX tests' relative limits.
"""

import dataclasses
import datetime as dt
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import hedgehog_tpu as hh
import hedgehog_tpu.distributions.broadie_kaya as jbk
import hedgehog_tpu.distributions.sample_from_cf as jsf
import hedgehog_tpu_torch as ht
from hedgehog_tpu_torch.distributions import broadie_kaya as bk
from hedgehog_tpu_torch.distributions.sample_from_cf import (
    CFSeries,
    cdf_series_weights,
    invert_cdf_series,
)
from hedgehog_tpu_torch.models.heston_exact import (
    cir_exact_constants,
    cir_exact_step_score,
    iv_cond_moments,
    poisson_kmax,
)

REF = dt.date(2025, 1, 1)
EXPIRY = dt.date(2025, 12, 31)
# V0 = 0.04, kappa = 1.5, theta = 0.04, sigma = 0.3, rho = -0.6 (the JAX test's market)
HESTON = (0.04, 1.5, 0.04, 0.3, -0.6)
J_MARKET = hh.HestonInputs(REF, 0.05, 100.0, *HESTON)
J_PROB = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                           J_MARKET)
PROB = ht.from_reference(J_PROB)
T = (365 - 1) / 365
CIR = (0.04, 2.0, 0.04, 0.3, 1.0)  # V0, kappa, theta, sigma, T of the series checks
N_SERIES, TERMS = 256, 64
PAIRS = 2**14


def _mc(pairs, anti=True, seed=42, strat=None, qmc=False):
    cfg = ht.SimulationConfig(pairs, 1, ht.Antithetic() if anti else ht.NoVarianceReduction(),
                              seed, qmc)
    return ht.MonteCarlo(ht.HestonDynamics(), strat or ht.HestonBroadieKaya(), cfg, device="cpu")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vt():
    return np.random.default_rng(3).uniform(0.005, 0.09, N_SERIES)


@pytest.fixture(scope="module")
def reference_series(vt):
    return jbk.heston_integrated_variance_weights(jnp.asarray(vt), *CIR, TERMS)


@pytest.fixture(scope="module")
def carr_madan():
    return float(ht.solve(PROB, ht.CarrMadan(1.0, 32.0, ht.HestonDynamics(), device="cpu")).price)


@pytest.fixture(scope="module")
def bk_solution():
    return ht.solve(PROB, _mc(PAIRS))


@pytest.fixture(scope="module")
def bk_samples(bk_solution):
    return bk_solution.ensemble


def _price_and_se(samples, strike=100.0, rate=0.05, T=T):
    payoffs = torch.clamp(samples - strike, min=0.0).mean(dim=0) * math.exp(-rate * T)
    return float(payoffs.mean()), float(payoffs.std() / math.sqrt(payoffs.numel()))


def test_series_moments_match_reference(vt, reference_series):
    """The port's moments are the closed form (``iv_cond_moments`` through
    the Bessel ratio of ``log_besseli_complex``); JAX's are central
    differences of the CF at h0 = 1e-2, with an O(h0²) bias (~1e-7 in the
    mean) and, in the std, the CF's rounding over h0²·var (~5e-7): the
    mean agrees to 1e-6 and the std to 2e-6; the closed form equals the
    exact-mixing scheme's moments (whose ratio is a continued fraction
    below z = 24) to 1e-12."""
    mean, std = bk.integrated_variance_moments(torch.from_numpy(vt), *CIR)
    got = bk.heston_integrated_variance_weights(torch.from_numpy(vt), *CIR, TERMS)
    assert torch.equal(got.mean, mean) and torch.equal(got.std, std)
    np.testing.assert_allclose(mean.numpy(), np.asarray(reference_series.mean), rtol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(reference_series.std), rtol=2e-6)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(reference_series.h), rtol=2e-6)
    V0, kappa, theta, sigma, T = CIR
    c = cir_exact_constants(kappa, theta, sigma, T)
    m1, s2 = iv_cond_moments(torch.full((N_SERIES,), V0, dtype=torch.float64),
                             torch.from_numpy(vt), c)
    np.testing.assert_allclose(mean.numpy(), m1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(std.numpy(), s2.sqrt().numpy(), rtol=1e-12)


def test_series_weights_match_reference_at_its_frequencies(vt, reference_series):
    """The port's CF and angle unwrap at the reference's h·j, weight by
    weight, to 1e-10 of each path's largest weight."""
    cf, carry0 = bk.heston_integrated_variance_cf(torch.from_numpy(vt), *CIR)
    js = torch.arange(1, TERMS + 1, dtype=torch.float64)[:, None]
    phi, _ = cf(torch.tensor(np.asarray(reference_series.h)) * js, carry0)
    got = (2.0 / math.pi) * phi.real / js
    want = np.asarray(reference_series.weights)
    scale = np.abs(want).max(axis=0)
    assert np.max(np.abs(got.numpy() - want) / scale) < 1e-10


def test_integrated_variance_from_the_same_uniforms(vt, reference_series):
    """∫V from the same V_T and uniforms: through the port's CF series at
    the reference's moments to 1e-9 (through the reference's own series to
    1e-12); through the port's whole step, its closed-form moments
    included, to 1e-8: a pair's ∫V moves with the step h by up to ~1e-2 of
    h's relative change (the series' aliasing beyond 2·(mean + 5·std)), and
    the reference's h is off the exact by its central differences' ~5e-7."""
    u = np.random.default_rng(4).uniform(1e-6, 1.0 - 1e-6, N_SERIES)
    want = np.asarray(jsf.invert_cdf_series(jnp.asarray(u), reference_series))
    ref_moments = tuple(torch.tensor(np.asarray(x)) for x in reference_series[:2])
    cf, carry0 = bk.heston_integrated_variance_cf(torch.from_numpy(vt), *CIR)
    at_ref = cdf_series_weights(cf, TERMS, carry0=carry0, moments=ref_moments, block_size=TERMS)
    np.testing.assert_allclose(invert_cdf_series(torch.from_numpy(u), at_ref).numpy(), want,
                               rtol=1e-9)
    same = CFSeries(*(torch.tensor(np.asarray(x)) for x in reference_series))
    np.testing.assert_allclose(invert_cdf_series(torch.from_numpy(u), same).numpy(), want,
                               rtol=1e-12)
    series = bk.heston_integrated_variance_weights(torch.from_numpy(vt), *CIR, TERMS)
    rel = np.abs(invert_cdf_series(torch.from_numpy(u), series).numpy() / want - 1.0)
    assert np.max(rel) < 1e-8


@pytest.mark.parametrize("block", [1, 8, TERMS])
def test_block_size_independence(vt, block):
    whole = bk.heston_integrated_variance_weights(torch.from_numpy(vt), *CIR, TERMS)
    got = bk.heston_integrated_variance_weights(torch.from_numpy(vt), *CIR, TERMS,
                                                block_size=block)
    scale = whole.weights.abs().max(dim=0).values
    assert float(((got.weights - whole.weights).abs() / scale).max()) < 1e-12
    assert torch.equal(got.h, whole.h)


def test_scalar_scan_path_with_batched_paths():
    """A term count that only a block of 1 divides (100, not a multiple of
    8) agrees with 104 terms in blocks of 8 on the shared weights (the JAX
    test's regression)."""
    VT = torch.tensor([0.03, 0.05, 0.041], dtype=torch.float64)
    s100 = bk.heston_integrated_variance_weights(VT, 0.04, 2.0, 0.04, 0.3, 1.0, 100, block_size=1)
    s104 = bk.heston_integrated_variance_weights(VT, 0.04, 2.0, 0.04, 0.3, 1.0, 104, block_size=8)
    np.testing.assert_allclose(s100.weights.numpy(), s104.weights[:100].numpy(), rtol=1e-12)


def test_reference_draws_close_and_invert_alike():
    """JAX's sampler at a small size: from its own V_T, uniforms and
    normals (re-drawn from the same key split), the port's ∫V agrees to
    1e-9 at the reference's moments (1e-8 with its own, as in
    ``test_integrated_variance_from_the_same_uniforms``) and its close to
    the sampler's terminal prices to 1e-12."""
    S0, r, n, terms, iters = 100.0, 0.05, 128, 32, 64
    V0, kappa, theta, sigma, rho = HESTON
    key = jax.random.PRNGKey(3)
    want = np.asarray(jbk._bk_terminal_from_params(key, S0, V0, kappa, theta, sigma, rho, r, T,
                                                   n, True, terms, iters))
    k_vt, k_u, k_z = jax.random.split(key, 3)
    em = -np.expm1(-kappa * T)
    d = 4.0 * kappa * theta / sigma**2
    lam = 4.0 * kappa * np.exp(-kappa * T) * V0 / (sigma**2 * em)
    c = sigma**2 * em / (4.0 * kappa)
    VT = c * jbk.sample_noncentral_chisq(k_vt, d, lam, (n,))
    series = jbk.heston_integrated_variance_weights(VT, V0, kappa, theta, sigma, T, terms)
    u = jax.random.uniform(k_u, (n,), dtype=jnp.float64, minval=1e-12, maxval=1.0 - 1e-12)
    IV = np.asarray(jsf.invert_cdf_series(u, series, iters=iters))
    z = torch.tensor(np.asarray(jax.random.normal(k_z, (n,), dtype=jnp.float64)))
    VT_t, u_t = torch.tensor(np.asarray(VT)), torch.tensor(np.asarray(u))
    cf, carry0 = bk.heston_integrated_variance_cf(VT_t, V0, kappa, theta, sigma, T)
    at_ref = cdf_series_weights(cf, terms, carry0=carry0, block_size=terms, moments=tuple(
        torch.tensor(np.asarray(x)) for x in series[:2]))
    np.testing.assert_allclose(invert_cdf_series(u_t, at_ref, iters=iters).numpy(), IV, rtol=1e-9)
    own = invert_cdf_series(u_t, bk.heston_integrated_variance_weights(
        VT_t, V0, kappa, theta, sigma, T, terms), iters=iters).numpy()
    assert np.max(np.abs(own / IV - 1.0)) < 1e-8
    got = bk.bk_close(S0, V0, kappa, theta, sigma, rho, r, T, VT_t, torch.from_numpy(IV),
                      torch.stack([z, -z]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_solve_matches_carr_madan(bk_solution, bk_samples, carr_madan):
    """2^14 antithetic pairs on the CPU within 4 SE of Carr-Madan, and
    solve's price the mean of its samples (the JAX tests: rel 2e-2)."""
    price, se = _price_and_se(bk_samples)
    assert abs(price - carr_madan) <= 4.0 * se
    assert price == pytest.approx(carr_madan, rel=2e-2)
    assert float(bk_solution.price) == pytest.approx(price, rel=1e-12)
    assert bk_solution.price.dtype == torch.float64 and bk_samples.shape == (2, PAIRS)
    head = ht.simulate_terminal_prices(PROB, _mc(256))
    assert torch.equal(head, bk_samples[:, :256])  # a pair's draws are its own


def test_bk_vs_euler(bk_samples):
    """The JAX test's Euler cross-check (25 000 antithetic pairs × 200
    steps, rel 5e-2)."""
    cfg = ht.SimulationConfig(25_000, 200, ht.Antithetic(), 7)
    euler = float(ht.solve(PROB, ht.MonteCarlo(ht.HestonDynamics(), ht.EulerMaruyama(), cfg,
                                               device="cpu")).price)
    assert _price_and_se(bk_samples)[0] == pytest.approx(euler, rel=5e-2)


def test_antithetic_pairs_share_vt_and_integrated_variance():
    """A pair shares V_T and ∫V and negates z (heston.jl:296-297): log S of
    the two members sum to twice the conditional mean; the first member is
    the one-group path of the same pair."""
    strat = ht.HestonBroadieKaya(cf_terms=32)
    paths = bk.broadie_kaya_paths(PROB, _mc(512, strat=strat).config, strat, device="cpu")
    V0, kappa, theta, sigma, rho = HESTON
    mu = (math.log(100.0) + 0.05 * T - 0.5 * paths.IV
          + (rho / sigma) * (paths.VT - V0 - kappa * theta * T + kappa * paths.IV))
    np.testing.assert_allclose(torch.log(paths.ST).sum(dim=0).numpy(), (2.0 * mu).numpy(),
                               rtol=1e-12)
    one = ht.simulate_terminal_prices(PROB, _mc(512, anti=False, strat=strat))
    assert one.shape == (1, 512) and torch.equal(one[0], paths.ST[0])


def test_vt_is_the_exact_mixing_first_segment():
    """Block 0 of a pair is the exact-mixing segment block: V_T equals
    ``cir_exact_step_score`` on the same words, bit for bit."""
    strat = ht.HestonBroadieKaya(cf_terms=16)
    paths = bk.broadie_kaya_paths(PROB, _mc(4096, strat=strat).config, strat, device="cpu")
    pair = torch.arange(4096, dtype=torch.int64)
    dr = bk.broadie_kaya_draws(pair, 42)
    V0, kappa, theta, sigma, _ = HESTON
    c = cir_exact_constants(kappa, theta, sigma, T)
    want, _ = cir_exact_step_score(torch.full((4096,), V0, dtype=torch.float64), dr.u_pois,
                                   dr.z_gam, dr.u_boost, c, poisson_kmax(kappa, theta, sigma, T, V0))
    assert torch.equal(paths.VT, want)


def test_noncentral_chisq_moments():
    """E[V_T] and Var[V_T] against the CIR closed forms (the JAX test's
    400 000 draws, rel 5e-3 and 2e-2)."""
    kappa, theta, sigma, V0, Tv = 1.5, 0.04, 0.3, 0.04, 1.0
    em = -np.expm1(-kappa * Tv)
    d = 4 * kappa * theta / sigma**2
    lam = 4 * kappa * np.exp(-kappa * Tv) * V0 / (sigma**2 * em)
    c = sigma**2 * em / (4 * kappa)
    vt = c * bk.sample_noncentral_chisq(0, d, lam, 400_000, device="cpu")
    mean = V0 * np.exp(-kappa * Tv) + theta * em
    var = (V0 * sigma**2 / kappa * (np.exp(-kappa * Tv) - np.exp(-2 * kappa * Tv))
           + theta * sigma**2 / (2 * kappa) * em**2)
    assert float(vt.mean()) == pytest.approx(mean, rel=5e-3)
    assert float(vt.var()) == pytest.approx(var, rel=2e-2)


@pytest.mark.parametrize("mu", [0.0, 0.5, 30.0, 408.0, 5_000.0, 1e5])
def test_poisson_window_inverts_any_rate(mu):
    """The counts are scipy's Poisson quantiles at every uniform (away from
    a tie with the CDF), at rates past the exact scheme's trip cap."""
    u = torch.from_numpy(np.random.default_rng(5).uniform(1e-9, 1.0 - 1e-9, 20_000))
    window = bk.poisson_window(mu)
    got = window.counts(u).numpy()
    want = scipy.stats.poisson.ppf(u.numpy(), mu)
    tie = np.abs(scipy.stats.poisson.cdf(want, mu) - u.numpy()) < 1e-12
    assert np.array_equal(got[~tie], want[~tie])
    # a uniform of exactly 0 (uniform_from_bits gives it) inverts to the
    # window's first count, not to 0 (whose mass past μ ≈ 160 is < 1e-30)
    assert window.counts(torch.zeros(1, dtype=torch.float64)).item() == window.k0


def test_qmc_raises_value_error():
    with pytest.raises(ValueError, match="HestonBroadieKaya"):
        ht.solve(PROB, _mc(64, qmc=True))
    lognormal = ht.MonteCarlo(ht.LognormalDynamics(), ht.HestonBroadieKaya(),
                              ht.SimulationConfig(64), device="cpu")
    with pytest.raises(TypeError, match="unsupported"):
        ht.simulate_terminal_prices(PROB, lognormal)


def test_gradient_request_raises():
    """Broadie-Kaya gives no derivative: autograd through its samples
    raises a RuntimeError naming it (the price itself is unchanged)."""
    v0 = torch.tensor(0.04, dtype=torch.float64, requires_grad=True)
    prob = dataclasses.replace(PROB, market_inputs=dataclasses.replace(PROB.market_inputs, V0=v0))
    mc = _mc(64, strat=ht.HestonBroadieKaya(cf_terms=16))
    price = ht.solve(prob, mc).price
    assert float(price.detach()) == float(ht.solve(PROB, mc).price)
    with pytest.raises(RuntimeError, match="HestonBroadieKaya"):
        torch.autograd.grad(price, v0)


def test_weekly_low_vol_of_vol_market_samples():
    """T = 1 week, σ = 0.1: λ/2 ≈ 408 is past the exact scheme's trip cap,
    and ∫V's mean (7.7e-4) drowns the JAX moments' second difference (its
    std is noise: 3× too wide or clamped at 1e-6, 15× too narrow).  The
    port's closed-form moments agree with the exact-mixing scheme's to 1e-2
    (its Bessel ratio is a 4-term asymptotic series above z = 24, ≤ 7e-5,
    and the variance amplifies it), and the price sits within 4 SE of
    Carr-Madan."""
    V0, kappa, theta, sigma, Tw = 0.04, 2.0, 0.04, 0.1, 7 / 365
    with pytest.raises(ValueError, match="trip count"):
        poisson_kmax(kappa, theta, sigma, Tw, V0)
    c = cir_exact_constants(kappa, theta, sigma, Tw)
    assert bk.poisson_window(V0 * c["lam_fac"]).k0 > 0
    VT = torch.tensor([0.035, 0.04, 0.045], dtype=torch.float64)
    series = bk.heston_integrated_variance_weights(VT, V0, kappa, theta, sigma, Tw, 128)
    m1, s2 = iv_cond_moments(torch.full_like(VT, V0), VT, c)
    np.testing.assert_allclose(series.mean.numpy(), m1.numpy(), rtol=1e-4)
    np.testing.assert_allclose(series.std.numpy(), s2.sqrt().numpy(), rtol=1e-2)
    ref = jbk.heston_integrated_variance_weights(jnp.asarray(VT.numpy()), V0, kappa, theta, sigma,
                                                 Tw, 128)
    assert np.all(np.abs(np.asarray(ref.std) / s2.sqrt().numpy() - 1.0) > 0.5)
    market = ht.HestonInputs(REF, 0.03, 100.0, V0, kappa, theta, sigma, -0.7)
    prob = ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2025, 1, 8), ht.European(), ht.Call(),
                                              ht.Spot()), market)
    samples = ht.simulate_terminal_prices(prob, _mc(2048, seed=3))
    price, se = _price_and_se(samples, rate=0.03, T=Tw)
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device="cpu")).price)
    assert bool(torch.isfinite(samples).all()) and abs(price - cm) <= 4.0 * se


def test_entry_point_runs_on_the_gpu_by_default():
    """``MonteCarlo`` with no device asks for the GPU, and without one the
    call raises in resolve_device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mc = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonBroadieKaya(), ht.SimulationConfig(64))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.solve(PROB, mc)


def test_from_reference_carries_the_strategy():
    j = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonBroadieKaya(cf_terms=64, inversion_iters=48),
                      hh.SimulationConfig(trajectories=32))
    port = ht.from_reference(j)
    assert port.strategy == ht.HestonBroadieKaya(cf_terms=64, inversion_iters=48)
