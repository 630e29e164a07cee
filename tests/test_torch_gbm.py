"""The exact lognormal (GBM) terminal sampler behind the default
``MonteCarlo`` (methods/gbm_exact.py) and its kernel's twin (K13,
ops/gbm_kernel.py) against the JAX package and the Black-Scholes formula:
the QMC terminals path by path, the PRNG prices within 4 standard errors,
the pathwise delta by ``torch.autograd.grad``, and the routes of
``simulate_terminal_prices`` under ``LognormalDynamics``.  Problems and
methods are built in JAX and carried across by ``from_reference``."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods.montecarlo import _gbm_exact_terminal
from hedgehog_tpu_torch.methods.gbm_exact import gbm_exact_terminal
from hedgehog_tpu_torch.ops import gbm_kernel as gbk

REF, EXPIRY = dt.date(2020, 1, 1), dt.date(2021, 1, 1)
MARKET = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.20)


def _problem(strike=100.0, cp=hh.Call(), market=MARKET):
    return hh.PricingProblem(hh.VanillaOption(strike, EXPIRY, hh.European(), cp, hh.Spot()),
                             market)


def _config(trajectories=4096, seed=3, qmc=True, antithetic=True):
    vr = hh.Antithetic() if antithetic else hh.NoVarianceReduction()
    return hh.SimulationConfig(trajectories=trajectories, steps=1, variance_reduction=vr,
                               seed=seed, qmc=qmc)


def _cpu(method):
    """The port's counterpart of a JAX method, run on the CPU."""
    return dataclasses.replace(ht.from_reference(method), device="cpu")


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("offset", [0, 4096])
def test_qmc_terminals_match_reference_per_path(antithetic, offset):
    """One Sobol' dimension through the exact float64 ``ndtri``, shifted by
    the unsplit base key: the JAX package's points, so every terminal price
    agrees to rel 1e-12."""
    prob, cfg = _problem(), _config(antithetic=antithetic)
    want = np.asarray(_gbm_exact_terminal(prob, cfg, jax.random.PRNGKey(3), point_offset=offset))
    got = gbm_exact_terminal(ht.from_reference(prob), ht.from_reference(cfg),
                             point_offset=offset, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("strike,cp", [(100.0, hh.Call()), (90.0, hh.Put()),
                                       (np.array([90.0, 100.0, 110.0]), hh.Call())],
                         ids=["atm_call", "otm_put", "strike_grid"])
def test_default_montecarlo_matches_reference(strike, cp):
    """``MonteCarlo(config=cfg)`` with every other default, on the CPU,
    against the JAX package's ``MonteCarlo(config=cfg)``: the same terminals
    under QMC and the same price, to rel 1e-12."""
    prob, cfg = ht.from_reference(_problem(strike, cp)), _config()
    want = hh.solve(_problem(strike, cp), hh.MonteCarlo(config=cfg))
    got = ht.solve(prob, ht.MonteCarlo(config=ht.from_reference(cfg), device="cpu"))
    np.testing.assert_allclose(got.ensemble.numpy(), np.asarray(want.ensemble), rtol=1e-12)
    np.testing.assert_allclose(got.price.numpy(), np.asarray(want.price), rtol=1e-12)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["float64", "kernel_twin"])
def test_prng_price_against_black_scholes(use_kernel):
    """PRNG stream, 2^17 antithetic pairs: within 4 standard errors of the
    per-pair payoffs of the Black-Scholes price (the draw is exact, so no
    bias allowance; mirrors tests/agreement/test_montecarlo_black_scholes.py)."""
    prob = ht.from_reference(_problem())
    bs = float(ht.solve(prob, ht.BlackScholesAnalytic(device="cpu")).price)
    cfg = ht.from_reference(_config(2**17, seed=5, qmc=False))
    sol = ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.BlackScholesExact(use_kernel),
                                       cfg, device="cpu"))
    disc = float(ht.df(prob.market_inputs.rate, prob.payoff.expiry))
    se = disc * float(ht.reduce_payoffs(sol.ensemble, prob.payoff).std()) / np.sqrt(2**17)
    assert abs(float(sol.price) - bs) <= 4 * se


@pytest.mark.parametrize("antithetic", [True, False])
def test_kernel_twin_and_float64_sampler_draw_the_same_normals(antithetic):
    """K13's Philox layout (one block per four pairs, both Box–Muller pairs)
    drawn in float32 by the twin and in float64 by the sampler: the same
    terminals to fp32 rounding (rel 1e-5), on a ragged path count."""
    prob = ht.from_reference(_problem())
    cfg = ht.from_reference(_config(1003, seed=9, qmc=False, antithetic=antithetic))
    f64 = gbm_exact_terminal(prob, cfg, device="cpu")
    twin = ht.simulate_terminal_prices(prob, ht.MonteCarlo(
        ht.LognormalDynamics(), ht.BlackScholesExact(use_kernel=True), cfg, device="cpu"))
    assert twin.dtype == torch.float64 and twin.shape == f64.shape == (1 + antithetic, 1003)
    np.testing.assert_allclose(twin.numpy(), f64.numpy(), rtol=1e-5)
    # the four normals of one Philox block are pairs 4g .. 4g + 3
    z = gbk.gbm_normals(10, 9, 0, "cpu", torch.float64)
    assert torch.equal(z[4:8], gbk.gbm_normals(8, 9, 0, "cpu", torch.float64)[4:])


def test_lognormal_routes():
    """EulerMaruyama(use_kernel=True) under LognormalDynamics runs K13 (the
    log-Euler increments sum to the exact law), as in the JAX package; the
    kernel strategies refuse qmc=True; EulerMaruyama(use_kernel=False)
    (``_gbm_euler_paths``) is not ported and says so."""
    prob = ht.from_reference(_problem())
    cfg = ht.from_reference(_config(256, qmc=False))
    euler = ht.simulate_terminal_prices(prob, ht.MonteCarlo(
        ht.LognormalDynamics(), ht.EulerMaruyama(use_kernel=True), cfg, device="cpu"))
    exact = ht.simulate_terminal_prices(prob, ht.MonteCarlo(
        ht.LognormalDynamics(), ht.BlackScholesExact(use_kernel=True), cfg, device="cpu"))
    assert torch.equal(euler, exact)
    qmc = dataclasses.replace(cfg, qmc=True)
    for strat in (ht.BlackScholesExact(use_kernel=True), ht.EulerMaruyama(use_kernel=True)):
        with pytest.raises(ValueError, match="qmc"):
            ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), strat, qmc, device="cpu"))
    with pytest.raises(TypeError, match="_gbm_euler_paths"):
        ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), cfg,
                                     device="cpu"))
    with pytest.raises(TypeError, match="unsupported"):
        ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.BlackScholesExact(), cfg,
                                     device="cpu"))


def test_pathwise_delta_through_solve_matches_analytic():
    """``torch.autograd.grad`` of the float64 ``BlackScholesExact`` price at
    100,000 paths with respect to a spot tensor: the analytic delta within
    rel 3e-2, and the price within rel 3e-2 (the reference's
    greeks_agreement.jl bound, tests/agreement/test_montecarlo_black_scholes.py:90-95)."""
    spot = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
    market = ht.BlackScholesInputs(REF, 0.05, spot, 0.20)
    payoff = ht.VanillaOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    cfg = ht.SimulationConfig(trajectories=100_000, steps=1, seed=42)
    price = ht.solve(ht.PricingProblem(payoff, market), ht.MonteCarlo(config=cfg,
                                                                      device="cpu")).price
    (delta,) = torch.autograd.grad(price, [spot])
    an = ht.solve(ht.from_reference(_problem()), ht.BlackScholesAnalytic(device="cpu")).price
    delta_an = float(hh.solve(hh.GreekProblem(_problem(), hh.SpotLens()), hh.AnalyticGreek(),
                              hh.BlackScholesAnalytic()).greek)
    assert float(delta) == pytest.approx(delta_an, rel=3e-2)
    assert float(price.detach()) == pytest.approx(float(an), rel=3e-2)


def test_autograd_under_qmc_matches_jax_grad():
    """Spot, rate and vol as 0-dim float64 tensors: the QMC price's gradient
    against ``jax.grad`` through the JAX ``solve`` on the same points, to
    rel 1e-9."""
    cfg = _config(2048)

    def jax_price(p):
        spot, r, vol = p
        return hh.solve(_problem(market=hh.BlackScholesInputs(REF, r, spot, vol)),
                        hh.MonteCarlo(config=cfg)).price

    vals = (100.0, 0.05, 0.2)
    want = np.asarray(jax.grad(jax_price)(jnp.asarray(vals)))
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in vals]
    spot, r, vol = leaves
    payoff = ht.VanillaOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    price = ht.solve(ht.PricingProblem(payoff, ht.BlackScholesInputs(REF, r, spot, vol)),
                     ht.MonteCarlo(config=ht.from_reference(cfg), device="cpu")).price
    got = np.array([float(g) for g in torch.autograd.grad(price, leaves)])
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_kernel_guards_and_cpu_launches_nothing():
    before = gbk.GBM_KERNEL.launches
    out = gbk.gbm_exact_terminal(4.6, 0.2, n_paths=5, seed=1, antithetic=False, device="cpu")
    assert out.shape == (1, 5) and out.dtype == torch.float32
    assert gbk.GBM_KERNEL.launches == before
    with pytest.raises(ValueError, match="n_paths"):
        gbk.gbm_exact_terminal(4.6, 0.2, n_paths=0, seed=1, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        gbk._gbm_terminal(torch.tensor([4.6, 0.2], dtype=torch.float64), 8, True, 0, 0)
