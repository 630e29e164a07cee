"""Greeks through the exact-mixing flagship against the JAX package.

The exact transition's Poisson count is a step function of the parameters,
so a pathwise derivative alone misses the dependence of the count's law on
its rate.  Both packages bake the likelihood-ratio surrogate into the
estimator's values, so ForwardAD and ReverseAD through ``solve`` and
``heston_exact_price_and_greeks`` give the same unbiased greek vector.
These tests pin that: each of the seven greeks of the port (bench.py's
market, 4096 QMC pairs × 2 segments) equals the JAX package's
``heston_exact_price_and_greeks`` to rel 1e-8 (abs 1e-9) and is not zero;
the float64 Euler route's pathwise greeks (the same fault) against
``jax.grad`` through its ``solve``; ``lam_of_eta``'s implicit derivative in both modes against gradcheck and
JAX's custom JVP; the exact surface's gradient against ``jax.grad``; the
guards; and the entry points' default device."""

import dataclasses
import datetime as dt
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods.mixing_greeks import heston_exact_price_and_greeks as jax_exact_greeks
from hedgehog_tpu.models import heston_exact as jx
from hedgehog_tpu_torch.models import heston_exact as px

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
R, SPOT, STRIKE = 0.03, 100.0, 100.0
HESTON = (0.04, 2.0, 0.04, 0.3, -0.7)  # V0, kappa, theta, sigma, rho
RTOL, ATOL = 1e-8, 1e-9
LENSES = {
    "spot": "market_inputs.spot", "V0": "market_inputs.V0", "kappa": "market_inputs.kappa",
    "theta": "market_inputs.theta", "sigma": "market_inputs.sigma", "rho": "market_inputs.rho",
    "rate": "market_inputs.rate.rate",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the host's cores, and torch's default of a thread per core in each of
    them oversubscribes the CPU (a one-second LSM then takes minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(cp=hh.Call()):
    market = hh.HestonInputs(REF, R, SPOT, *HESTON)
    return hh.PricingProblem(hh.VanillaOption(STRIKE, EXPIRY, hh.European(), cp, hh.Spot()),
                             market)


def _method(pairs=4096, seed=1, qmc=True):
    cfg = hh.SimulationConfig(pairs, 2, hh.Antithetic(), seed, qmc)
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(), cfg)


def _port(method):
    return dataclasses.replace(ht.from_reference(method), device="cpu")


@pytest.fixture(scope="module")
def reference():
    price, greeks = jax_exact_greeks(_problem(), _method())
    return float(price), {k: float(v) for k, v in greeks.items()}


def _assert_greek(name, got, want):
    assert got != 0.0, name
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL), (name, got, want)


def test_price_and_greeks_match_reference(reference):
    price, greeks = ht.heston_exact_price_and_greeks(ht.from_reference(_problem()),
                                                     _port(_method()))
    assert float(price) == pytest.approx(reference[0], rel=1e-12)
    assert tuple(greeks) == ht.GREEK_ORDER
    for name, value in greeks.items():
        _assert_greek(name, float(value), reference[1][name])


@pytest.mark.parametrize("greek_method", [ht.ForwardAD(), ht.ReverseAD()],
                         ids=["forward", "reverse"])
@pytest.mark.parametrize("name", list(LENSES))
def test_ad_through_solve_matches_reference(reference, greek_method, name):
    """The fault this pins: through the exact ``solve`` the V0, κ, θ and σ
    greeks were 0.0 under ForwardAD and a RuntimeError under ReverseAD
    (the parameters cut to floats).  No tensor-to-float conversion warning
    may be raised on the way."""
    prob = ht.from_reference(_problem())
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*Converting a tensor.*")
        got = ht.solve(ht.GreekProblem(prob, ht.FieldLens(LENSES[name])), greek_method,
                       _port(_method())).greek
    _assert_greek(name, float(got), reference[1][name])


def test_batch_reverse_ad_matches_reference(reference):
    prob = ht.from_reference(_problem())
    lenses = [ht.FieldLens(path) for path in LENSES.values()]
    got = ht.solve(ht.BatchGreekProblem(prob, lenses), ht.ReverseAD(), _port(_method()))
    for name, lens in zip(LENSES, lenses):
        _assert_greek(name, float(got[lens]), reference[1][name])


def test_put_and_prng_price_equals_solve():
    """The greek function's price is the seeded ``solve`` price on the same
    draws (a put; the PRNG stream too), and its greeks equal ReverseAD's."""
    for qmc in (True, False):
        prob = ht.from_reference(_problem(hh.Put()))
        method = _port(_method(pairs=2048, seed=4, qmc=qmc))
        price, greeks = ht.heston_exact_price_and_greeks(prob, method)
        assert float(price) == pytest.approx(float(ht.solve(prob, method).price), rel=1e-13)
        rv = ht.solve(ht.GreekProblem(prob, ht.FieldLens("market_inputs.sigma")), ht.ReverseAD(),
                      method).greek
        assert float(greeks["sigma"]) == pytest.approx(float(rv), rel=1e-10)


def test_surrogate_leaves_the_primal_unchanged():
    prob = ht.from_reference(_problem())
    method = _port(_method())
    from hedgehog_tpu_torch.methods.heston_exact_mixing import heston_exact_mixing_values

    sigma = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    p2 = dataclasses.replace(prob, market_inputs=dataclasses.replace(prob.market_inputs,
                                                                     sigma=sigma))
    vals = heston_exact_mixing_values(p2, method.config, device="cpu")
    plain, logl = heston_exact_mixing_values(prob, method.config, device="cpu", with_score=True)
    assert torch.equal(vals.detach(), plain)
    assert logl.shape == plain.shape and bool(torch.isfinite(logl).all())


def test_guards():
    prob = ht.from_reference(_problem())
    kernel = dataclasses.replace(_port(_method()), strategy=ht.HestonExactMixing(use_kernel=True))
    with pytest.raises(TypeError, match="primal-only"):
        ht.heston_exact_price_and_greeks(prob, kernel)
    with pytest.raises(TypeError, match="HestonExactMixing"):
        ht.heston_exact_price_and_greeks(prob, dataclasses.replace(
            _port(_method()), strategy=ht.HestonQE(conditional=True)))
    american = dataclasses.replace(prob, payoff=dataclasses.replace(
        prob.payoff, exercise_style=ht.American()))
    with pytest.raises(TypeError, match="European"):
        ht.heston_exact_price_and_greeks(american, _port(_method()))
    grid = dataclasses.replace(prob, payoff=dataclasses.replace(
        prob.payoff, strike=np.array([90.0, 110.0])))
    with pytest.raises(TypeError, match="scalar strike"):
        ht.heston_exact_price_and_greeks(grid, _port(_method()))


def test_kernel_route_still_refuses_derivatives():
    """The exact kernels stay primal-only (K2 through ``no_derivative``)."""
    prob = ht.from_reference(_problem())
    kernel = dataclasses.replace(_port(_method()), strategy=ht.HestonExactMixing(use_kernel=True))
    with pytest.raises(NotImplementedError):
        ht.solve(ht.GreekProblem(prob, ht.FieldLens("market_inputs.sigma")), ht.ReverseAD(),
                 kernel)


# -- the same fault on the float64 Euler route ------------------------------


@pytest.fixture(scope="module")
def euler_reference():
    prob = _problem()
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.EulerMaruyama(),
                           hh.SimulationConfig(1024, 16, hh.Antithetic(), 1, True))
    lenses = [hh.FieldLens(path) for path in LENSES.values()]
    got = hh.solve(hh.BatchGreekProblem(prob, lenses), hh.ReverseAD(), method)
    return method, {name: float(got[lens]) for name, lens in zip(LENSES, lenses)}


@pytest.mark.parametrize("greek_method", [ht.ForwardAD(), ht.ReverseAD()],
                         ids=["forward", "reverse"])
def test_euler_pathwise_greeks_match_reference(euler_reference, greek_method):
    """The float64 full-truncation Euler estimator read its market as floats
    too (every greek 0.0 under ForwardAD, a RuntimeError under ReverseAD);
    its pathwise greeks now equal JAX's ``jax.grad`` through the same
    ``solve`` on the same Sobol' points."""
    method, want = euler_reference
    prob = ht.from_reference(_problem())
    for name, path in LENSES.items():
        got = ht.solve(ht.GreekProblem(prob, ht.FieldLens(path)), greek_method, _port(method))
        assert float(got.greek) != 0.0, name
        assert float(got.greek) == pytest.approx(want[name], rel=1e-10, abs=1e-12), name


# -- lam_of_eta: the implicit derivative in both modes ----------------------

ETAS = np.concatenate([np.linspace(-3.0, -0.6, 9), np.linspace(-0.45, 0.45, 7),
                       np.linspace(0.6, 3.0, 9)])


def test_lam_of_eta_gradcheck_both_modes():
    eta = torch.tensor(ETAS, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda e: px.lam_of_eta(e, 3), (eta,),
                                    check_forward_ad=True, check_backward_ad=True)


@pytest.mark.parametrize("trips", [2, 3])
def test_lam_of_eta_derivative_matches_jax_custom_jvp(trips):
    eta = np.linspace(-6.0, 6.0, 241)
    _, want = jax.jvp(lambda e: jx.lam_of_eta(e, trips), (jnp.asarray(eta),),
                      (jnp.ones_like(jnp.asarray(eta)),))
    x = torch.tensor(eta, dtype=torch.float64, requires_grad=True)
    (rev,) = torch.autograd.grad(px.lam_of_eta(x, trips).sum(), x)
    _, fwd = torch.func.jvp(lambda e: px.lam_of_eta(e, trips), (x.detach(),),
                            (torch.ones_like(x.detach()),))
    np.testing.assert_allclose(rev.numpy(), np.asarray(want), rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want), rtol=1e-12, atol=0.0)


def test_gamma_qtl_gradient_matches_jax():
    alpha, z = np.meshgrid(np.geomspace(0.5, 40.0, 9), np.linspace(-4.0, 4.0, 11))
    want = jax.grad(lambda a: jnp.sum(jx.gamma_qtl(a, jnp.asarray(z))))(jnp.asarray(alpha))
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(px.gamma_qtl(a, torch.tensor(z)).sum(), a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-14)


# -- the exact surface's gradient against jax.grad --------------------------

SURF_EXPIRIES = [dt.date(2024, 7, 1), dt.date(2025, 1, 1)]
SURF_STRIKES = [90.0, 100.0, 110.0]


def test_exact_surface_gradient_matches_jax():
    cfg = hh.SimulationConfig(1024, 4, hh.Antithetic(), 2, True)
    weights = np.linspace(0.5, 1.5, len(SURF_EXPIRIES) * len(SURF_STRIKES)).reshape(2, 3)

    def jax_loss(p):
        market = hh.HestonInputs(REF, p[6], p[0], *(p[i] for i in range(1, 6)))
        surf = hh.heston_surface_mc(market, SURF_EXPIRIES, SURF_STRIKES, cfg,
                                    strategy=hh.HestonExactMixing())
        return jnp.sum(jnp.asarray(weights) * surf)

    p0 = np.array([SPOT, *HESTON, R])
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(p0)))
    p = torch.tensor(p0, dtype=torch.float64, requires_grad=True)
    market = ht.HestonInputs(REF, p[6], p[0], *(p[i] for i in range(1, 6)))
    surf = ht.heston_surface_mc(market, SURF_EXPIRIES, SURF_STRIKES, ht.from_reference(cfg),
                                strategy=ht.HestonExactMixing(), device="cpu")
    (got,) = torch.autograd.grad((torch.tensor(weights) * surf).sum(), p)
    assert (got != 0.0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9)


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    method = dataclasses.replace(_port(_method()), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.heston_exact_price_and_greeks(ht.from_reference(_problem()), method)
