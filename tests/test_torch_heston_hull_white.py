"""The Heston-Hull-White mixing estimator of the port
(methods/heston_hull_white.py) against the JAX package on the CPU.

JAX draws this estimator from ``jax.random`` only (no QMC), so the port is
fed the normals and uniforms JAX draws (``jax.random.split`` of the base
key, ``_normals`` and ``jax.random.uniform``): per path, calls, puts, a
digital and a strike grid equal JAX's to 1e-10, and the full 9-parameter
greek vector through autograd equals ``jax.grad`` on those draws to 1e-8.
On the port's Philox stream (``HHW_TAG``) the estimator agrees in law with
tests/unit/test_heston_hull_white.py's oracles: the Black-Scholes-Hull-White
closed form at σ_v → 0, the Heston mixing estimator at σ_r → 0, parity and
the martingale discount (each within 4 SE).  The guards refuse what JAX
refuses, with its exception types."""

import dataclasses
import datetime as dt
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import heston_hull_white as phhw

REF, EXP = dt.date(2024, 1, 1), dt.date(2024, 12, 31)  # T = 1
T = 1.0
CPU = "cpu"
PATH_RTOL = 1e-10
GRAD_RTOL = 1e-8
PARAMS = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho_sv=-0.6, a=0.1, sigma_r=0.012,
              rho_sr=-0.3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _market(mod, spot=100.0, rate=0.03, **kw):
    p = {**PARAMS, **kw}
    return mod.HestonHullWhiteInputs(REF, rate, spot, p["V0"], p["kappa"], p["theta"],
                                     p["sigma"], p["rho_sv"], p["a"], p["sigma_r"], p["rho_sr"])


def _jax_draws(config):
    """The draws of JAX's ``_hhw_mixing_values``: (z (g, steps, 3, P), u (g, steps, P))."""
    anti = isinstance(config.variance_reduction, hh.Antithetic)
    k_z, k_u = jax.random.split(jax.random.PRNGKey(config.seed))
    z = jmc._normals(k_z, (config.steps, 3, config.trajectories), anti)
    u = jax.random.uniform(k_u, (config.steps, config.trajectories), dtype=jnp.float64)
    return np.array(z), np.array(jnp.stack([u, 1.0 - u]) if anti else u[None])


CONFIG = hh.SimulationConfig(2048, 8, hh.Antithetic(), 3)
PAYOFFS = {
    "call": hh.VanillaOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot()),
    "put": hh.VanillaOption(95.0, EXP, hh.European(), hh.Put(), hh.Spot()),
    "digital": hh.DigitalOption(105.0, EXP, hh.European(), hh.Call(), hh.Spot()),
    "strike grid": hh.VanillaOption(jnp.asarray([90.0, 100.0, 110.0]), EXP, hh.European(),
                                    hh.Call(), hh.Spot()),
}


@pytest.mark.parametrize("name", list(PAYOFFS))
def test_values_match_reference_on_its_draws(name):
    prob = hh.PricingProblem(PAYOFFS[name], _market(hh))
    want = jax.jit(lambda: jmc._hhw_mixing_values(prob, CONFIG, None))()
    z, u = _jax_draws(CONFIG)
    got = phhw.hhw_values_from_draws(ht.from_reference(prob), z, u, device=CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PATH_RTOL, atol=1e-13)


def test_greek_vector_matches_jax_on_its_draws():
    """∂price/∂(spot, V0, κ, θ, σ_v, ρ_sv, a, σ_r, ρ_sr) through autograd
    against ``jax.grad`` of JAX's estimator on the same draws (the √V double
    where keeps it finite where QE's exponential branch reaches V = 0)."""
    payoff = PAYOFFS["call"]
    x0 = np.array([100.0] + list(PARAMS.values()))

    def jprice(x):
        m = _market(hh, spot=x[0], **dict(zip(PARAMS, x[1:])))
        vals = jmc._hhw_mixing_values(hh.PricingProblem(payoff, m), CONFIG, None)
        return jnp.exp(-0.03 * T) * jnp.mean(vals)

    want = np.asarray(jax.jit(jax.grad(jprice))(jnp.asarray(x0)))
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    prob = ht.PricingProblem(ht.from_reference(payoff), _market(
        ht, spot=x[0], **{k: x[i + 1] for i, k in enumerate(PARAMS)}))
    z, u = _jax_draws(CONFIG)
    price = math.exp(-0.03 * T) * phhw.hhw_values_from_draws(prob, z, u, device=CPU).mean()
    (got,) = torch.autograd.grad(price, x)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL, atol=1e-12)


def _mc(pairs, steps=32, seed=0):
    return ht.MonteCarlo(ht.HestonHullWhiteDynamics(), ht.HestonQE(conditional=True),
                         ht.SimulationConfig(pairs, steps, ht.Antithetic(), seed), device=CPU)


def _opt(strike=100.0, cp=None):
    return ht.VanillaOption(strike, EXP, call_put=cp or ht.Call())


def _price_and_se(prob, method):
    """(price, SE) as floats, or lists of them for a strike grid."""
    sol = ht.solve(prob, method)
    pairs = sol.ensemble.mean(dim=0)
    D = float(ht.df(prob.market_inputs.rate, EXP))
    se = D * pairs.std(dim=-1) / math.sqrt(pairs.shape[-1])
    return sol.price.tolist(), se.tolist()


def _bshw_price(strike, s_s, a, sr, rho_sr, r=0.03, spot=100.0, cp=1.0):
    """The Black-Scholes-Hull-White closed form (Brigo–Mercurio): Black on the
    T-forward, total variance σ²T + 2ρσσ_r(T − B(T))/a + σ_r²Γ(T)."""
    b = float(ht.models.hull_white.hw_b(a, T))
    g = float(ht.models.hull_white.hw_gamma(a, T))
    tot = s_s**2 * T + 2 * rho_sr * s_s * sr * (T - b) / a + sr**2 * g
    p0t = np.exp(-r * T)
    f = spot / p0t
    sd = np.sqrt(tot)
    d1 = (np.log(f / strike) + 0.5 * tot) / sd
    return p0t * cp * (f * norm.cdf(cp * d1) - strike * norm.cdf(cp * (d1 - sd)))


def test_black_scholes_hull_white_corner():
    """σ_v → 0, V0 = θ (test_heston_hull_white.py:55): the estimator is exact
    in law there, so each strike within 4 SE of the closed form, cross term
    2ρσσ_r included."""
    s_s, a, sr, rho_sr = 0.2, 0.1, 0.015, -0.3
    m = _market(ht, V0=s_s**2, theta=s_s**2, sigma=1e-8, rho_sv=0.0, a=a, sigma_r=sr,
                rho_sr=rho_sr)
    prob = ht.PricingProblem(_opt(torch.tensor([90.0, 100.0, 110.0], dtype=torch.float64)), m)
    got, se = _price_and_se(prob, _mc(2**14, 16))
    for k, g, s in zip((90.0, 100.0, 110.0), got, se):
        want = _bshw_price(k, s_s, a, sr, rho_sr)
        assert abs(g - want) <= 4.0 * s, (k, g, want, s)


def test_heston_corner():
    """σ_r → 0 (test_heston_hull_white.py:66): the hybrid against the port's
    Heston mixing estimator on the same market, within 4 combined SE."""
    m = _market(ht, rho_sv=-0.7, sigma_r=1e-10, rho_sr=0.0)
    p, se = _price_and_se(ht.PricingProblem(_opt(), m), _mc(2**14, 16))
    hm = ht.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    heston = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True),
                           ht.SimulationConfig(2**14, 16, ht.Antithetic(), 1), device=CPU)
    ph, se_h = _price_and_se(ht.PricingProblem(_opt(), hm), heston)
    assert abs(p - ph) <= 4.0 * math.hypot(se, se_h), (p, ph, se, se_h)


def test_parity_and_martingale_discount():
    """Call − put = S₀ − K·P(0, T) (test_heston_hull_white.py:81): per path
    (C − P)(K) = (F_eff − K)·D_path, so the difference of two strikes'
    parities measures E[D_path] = 1, the Hull-White martingale identity; both
    within 4 SE of the per-path differences."""
    m = _market(ht)
    method = _mc(2**14, 16, seed=5)
    ks = torch.tensor([80.0, 120.0], dtype=torch.float64)
    calls = ht.solve(ht.PricingProblem(_opt(ks), m), method)
    puts = ht.solve(ht.PricingProblem(_opt(ks, ht.Put()), m), method)
    D = math.exp(-0.03 * T)
    diff = (calls.ensemble - puts.ensemble).mean(dim=0) * D  # (2, pairs)
    n = diff.shape[-1]
    for i, k in enumerate(ks.tolist()):
        se = float(diff[i].std()) / math.sqrt(n)
        assert abs(float(diff[i].mean()) - (100.0 - k * D)) <= 4.0 * se
    disc = (diff[0] - diff[1]) / (40.0 * D)  # per pair: D_path / P(0, T)
    assert abs(float(disc.mean()) - 1.0) <= 4.0 * float(disc.std()) / math.sqrt(n)


def test_strike_grid_equals_single_strikes():
    m = _market(ht)
    method = _mc(1024, 8)
    ks = [90.0, 100.0, 110.0]
    grid = ht.solve(ht.PricingProblem(_opt(torch.tensor(ks, dtype=torch.float64)), m),
                    method).price
    singles = [float(ht.solve(ht.PricingProblem(_opt(k), m), method).price) for k in ks]
    np.testing.assert_allclose(grid.numpy(), singles, rtol=1e-12)


def test_dispatch_guards():
    """test_heston_hull_white.py:113, and the use_kernel and terminal-sample
    refusals of montecarlo.py:3146 and :3303, with JAX's exception types."""
    prob = ht.PricingProblem(_opt(), _market(ht))
    cfg = ht.SimulationConfig(64, 2)
    dyn = ht.HestonHullWhiteDynamics()
    with pytest.raises(TypeError, match="conditional mixing"):
        ht.solve(prob, ht.MonteCarlo(dyn, ht.HestonQE(), cfg, device=CPU))
    with pytest.raises(ValueError, match="qmc"):
        ht.solve(prob, ht.MonteCarlo(dyn, ht.HestonQE(conditional=True),
                                     dataclasses.replace(cfg, qmc=True), device=CPU))
    with pytest.raises(TypeError, match="single-factor Heston"):
        ht.solve(prob, ht.MonteCarlo(dyn, ht.HestonQE(conditional=True, use_kernel=True), cfg,
                                     device=CPU))
    with pytest.raises(TypeError, match="conditional mixing"):
        ht.simulate_terminal_prices(prob, ht.MonteCarlo(dyn, ht.EulerMaruyama(), cfg,
                                                        device=CPU))
    with pytest.raises(TypeError, match="European"):
        ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, EXP, ht.American()), _market(ht)),
                 ht.MonteCarlo(dyn, ht.HestonQE(conditional=True), cfg, device=CPU))
    jprob = hh.PricingProblem(PAYOFFS["call"], _market(hh))
    for strat, exc in ((hh.HestonQE(conditional=True, use_kernel=True), TypeError),
                       (hh.HestonQE(), TypeError)):
        with pytest.raises(exc):
            hh.solve(jprob, hh.MonteCarlo(hh.HestonHullWhiteDynamics(), strat,
                                          hh.SimulationConfig(64, 2)))
