"""The port's calibration against the JAX package: the cases of
tests/unit/test_calibration.py (Black-Scholes vol recovery, the root-find,
the five-parameter Heston recovery over Carr-Madan, the batched
implied-vol round trip, the IFT gradient, ``rect_vol_surface_from_prices``,
``argmin_ift``), the conditional basket fast path and the calibration
through it of tests/agreement/test_conditional_mc.py:330-413, the kernel
route's basket, and the device rule of the deterministic pricers.

Problems are built in JAX and carried across with ``from_reference``; the
pricing methods run on the CPU.  Deterministic outputs agree with the JAX
package's to 1e-10 relative; calibrations are held to the JAX tests' own
tolerances (BS vol atol 1e-5, Heston rel 1e-1, the MC basket rel 5e-2)."""

import dataclasses
import datetime as dt
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2020, 1, 1)
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The fits run thousands of small float64 ops: one intra-op thread a
    test process, so that parallel test workers do not oversubscribe the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu(obj):
    """A JAX problem or method carried across, its pricing method on the CPU."""
    port = ht.from_reference(obj)
    if isinstance(port, ht.CalibrationProblem):
        return dataclasses.replace(port, pricing_method=_cpu_method(port.pricing_method))
    return _cpu_method(port)


def _cpu_method(method):
    return dataclasses.replace(method, device="cpu")


def _bs_calibration():
    r, S0 = 0.05, 100.0
    market = hh.BlackScholesInputs(REF, r, S0, 0.25)
    expiry = dt.date(2020, 12, 31)
    payoffs = [hh.VanillaOption(K, expiry, hh.European(), hh.Call(), hh.Spot())
               for K in np.arange(60.0, 141.0, 5.0)]
    quotes = [float(hh.solve(hh.PricingProblem(p, market), hh.BlackScholesAnalytic()).price)
              for p in payoffs]
    return hh.CalibrationProblem(hh.BasketPricingProblem(payoffs,
                                                         hh.BlackScholesInputs(REF, r, S0, 0.15)),
                                 jnp.asarray(quotes), jnp.asarray([0.15]),
                                 hh.BlackScholesAnalytic(), (hh.VolLens(1, 1),))


def test_bs_vol_recovery_lbfgs():
    """atol 1e-5 on the vol, as the JAX test; the port's L-BFGS is optax's
    step for step, and its iteration count is held beside JAX's."""
    calib = _bs_calibration()
    want = hh.solve(calib, hh.OptimizerAlgo(max_iters=100))
    got = ht.solve(_cpu(calib), ht.OptimizerAlgo(max_iters=100))
    assert float(got.u[0]) == pytest.approx(0.25, abs=1e-5)
    assert float(got.u[0]) == pytest.approx(float(want.u[0]), abs=1e-5)
    assert got.converged and 0 < got.iterations < 100
    assert got.iterations == int(want.iterations)  # JAX: 8
    assert got.evaluations >= got.iterations
    assert got.u.device.type == "cpu" and got.u.dtype == torch.float64


def test_bs_implied_vol_rootfind():
    r, S0 = 0.05, 100.0
    payoff = hh.VanillaOption(110.0, dt.date(2020, 12, 31), hh.European(), hh.Put(), hh.Spot())
    quote = float(hh.solve(hh.PricingProblem(payoff, hh.BlackScholesInputs(REF, r, S0, 0.3)),
                           hh.BlackScholesAnalytic()).price)
    calib = hh.CalibrationProblem(hh.BasketPricingProblem([payoff],
                                                          hh.BlackScholesInputs(REF, r, S0, 0.5)),
                                  jnp.asarray([quote]), jnp.asarray([0.5]),
                                  hh.BlackScholesAnalytic(), (hh.VolLens(1, 1),))
    want = hh.solve(calib, hh.RootFinderAlgo())
    got = ht.solve(_cpu(calib), ht.RootFinderAlgo())
    assert float(got.u) == pytest.approx(0.3, abs=1e-10)
    assert float(got.u) == pytest.approx(float(want.u), rel=RTOL)
    assert bool(got.converged) and float(got.loss) < 1e-20
    with pytest.raises(ValueError, match="single parameter"):
        ht.solve(dataclasses.replace(_cpu(calib), accessors=(ht.VolLens(), ht.SpotLens())),
                 ht.RootFinderAlgo())


def _heston_calibration(method):
    true = (0.010201, 6.21, 0.019, 0.61, -0.7)
    r, S0 = 0.0319, 100.0
    expiries = [REF + dt.timedelta(days=d) for d in (90, 180, 365)]
    payoffs = [ht.VanillaOption(K, e, ht.European(), ht.Call(), ht.Spot())
               for e in expiries for K in np.arange(60.0, 141.0, 5.0)]
    quotes = torch.stack([ht.solve(ht.PricingProblem(p, ht.HestonInputs(REF, r, S0, *true)),
                                   method).price for p in payoffs])
    guess = [0.02, 3.0, 0.03, 0.4, -0.3]
    lenses = tuple(ht.FieldLens(f"market_inputs.{n}")
                   for n in ("V0", "kappa", "theta", "sigma", "rho"))
    calib = ht.CalibrationProblem(ht.BasketPricingProblem(payoffs, ht.HestonInputs(REF, r, S0,
                                                                                   *guess)),
                                  quotes, guess, method, lenses)
    return calib, true


def test_heston_calibration_recovery():
    """BASELINE config 5 (bench.py:716-774): 51 Carr-Madan quotes, five
    parameters, bounded L-BFGS; rel 1e-1 as the JAX test.  The JAX test is
    marked slow and does not run here."""
    calib, true = _heston_calibration(ht.CarrMadan(1.0, 32.0, ht.HestonDynamics(), device="cpu"))
    res = ht.solve(calib, ht.OptimizerAlgo(max_iters=300), lb=[1e-5, 1e-3, 1e-5, 1e-3, -0.99],
                   ub=[1.0, 20.0, 1.0, 5.0, 0.99])
    assert res.converged and 0 < res.iterations <= 300
    for got, want in zip(res.u.tolist(), true):
        assert got == pytest.approx(want, rel=1e-1)


def test_basket_prices_one_strike_grid_per_expiry():
    """Homogeneous vanillas under Carr-Madan price as one strike-grid call
    per expiry, equal to the per-payoff solves and to the JAX package's."""
    from hedgehog_tpu_torch.calibration.calibration import _basket_prices

    market = hh.HestonInputs(REF, 0.0319, 100.0, 0.010201, 6.21, 0.019, 0.61, -0.7)
    payoffs = [hh.VanillaOption(K, REF + dt.timedelta(days=d), hh.European(), hh.Put(), hh.Spot())
               for K in (80.0, 100.0, 125.0) for d in (90, 365)]
    method = hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())
    basket = ht.from_reference(hh.BasketPricingProblem(payoffs, market))
    got = _basket_prices(basket, _cpu(method))
    loop = [ht.solve(ht.PricingProblem(p, basket.market_inputs), _cpu(method)).price
            for p in basket.payoffs]
    want = [hh.solve(hh.PricingProblem(p, market), method).price for p in payoffs]
    np.testing.assert_allclose(got.numpy(), torch.stack(loop).numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_batched_implied_vol_roundtrip():
    T = np.array([[0.25, 0.25], [1.0, 1.0]])
    K = np.array([[90.0, 110.0], [90.0, 110.0]])
    sigma = np.array([[0.2, 0.3], [0.25, 0.35]])
    prices = ht.iv_to_price_bs(torch.tensor(sigma), torch.tensor(K), torch.tensor(T), 100.0, 0.02)
    np.testing.assert_allclose(prices.numpy(), np.asarray(hh.iv_to_price_bs(sigma, K, T, 100.0,
                                                                           0.02)), rtol=RTOL)
    ivs = ht.implied_vol_bs(prices, torch.tensor(K), torch.tensor(T), 100.0, 0.02)
    np.testing.assert_allclose(ivs.numpy(), sigma, atol=1e-10)
    want = hh.implied_vol_bs(jnp.asarray(prices.numpy()), K, T, 100.0, 0.02)
    np.testing.assert_allclose(ivs.numpy(), np.asarray(want), rtol=RTOL)
    assert ht.implied_vol is ht.implied_vol_bs


def test_implied_vol_gradient_ift():
    """d(sigma)/d(price) = 1/vega by the implicit function theorem, and the
    JAX package's gradient, to 1e-10."""
    price0 = ht.iv_to_price_bs(0.25, 100.0, 1.0, 100.0, 0.02).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(ht.implied_vol_bs(price0, 100.0, 1.0, 100.0, 0.02).sum(), price0)
    s = torch.tensor(0.25, dtype=torch.float64, requires_grad=True)
    (vega,) = torch.autograd.grad(ht.iv_to_price_bs(s, 100.0, 1.0, 100.0, 0.02), s)
    assert float(g) == pytest.approx(1.0 / float(vega), rel=1e-8)
    want = jax.grad(lambda p: hh.implied_vol_bs(p, 100.0, 1.0, 100.0, 0.02).sum())(
        jnp.asarray(float(price0.detach())))
    assert float(g) == pytest.approx(float(want), rel=RTOL)


def test_implicit_root_gradient_in_a_captured_parameter():
    """The IFT gradient reaches a parameter captured by f: x*(a) = √a."""
    a = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    res = ht.implicit_root_full(lambda x: x * x - a, 0.0, 4.0)
    assert bool(res.converged) and float(res.root) == pytest.approx(2.0**0.5, rel=1e-14)
    (g,) = torch.autograd.grad(res.root, a)
    assert float(g) == pytest.approx(0.5 / 2.0**0.5, rel=1e-10)
    out = ht.implicit_root_full(lambda x: x * x + a, 0.0, 4.0)  # no sign change: the endpoint
    assert not bool(out.converged) and float(out.root) == 0.0
    assert float(ht.bisect_root(lambda x: x - 1.5, 0.0, 4.0)) == 1.5


def test_rect_vol_surface_from_prices_roundtrip():
    tenors = np.array([0.25, 0.5, 1.0])
    strikes = np.array([80.0, 100.0, 120.0])
    sigma = np.array([[0.30, 0.25, 0.28], [0.32, 0.26, 0.29], [0.34, 0.27, 0.30]])
    prices = np.asarray(hh.iv_to_price_bs(sigma, strikes[None, :], tenors[:, None], 100.0, 0.03))
    curve = hh.RateCurve.from_dfs(REF, [0.5, 2.0], [0.985, 0.94])
    for rate in (0.03, curve):
        want = hh.rect_vol_surface_from_prices(REF, rate, 100.0, jnp.asarray(tenors),
                                               jnp.asarray(strikes), jnp.asarray(prices))
        got = ht.rect_vol_surface_from_prices(REF, ht.from_reference(rate), 100.0,
                                              torch.tensor(tenors), torch.tensor(strikes),
                                              torch.tensor(prices))
        np.testing.assert_allclose(got.vols.numpy(), np.asarray(want.vols), rtol=RTOL)
        if rate == 0.03:
            np.testing.assert_allclose(got.vols.numpy(), sigma, atol=1e-10)
            assert float(ht.get_vol_yf(got, 0.375, 90.0)) == pytest.approx(
                float(np.mean([0.30, 0.25, 0.32, 0.26])), abs=1e-10)
    with pytest.raises(ValueError, match="Price matrix size"):
        ht.rect_vol_surface_from_prices(REF, 0.03, 100.0, tenors, strikes, prices[:2])


def test_argmin_ift_gradients():
    """f(x, c) = |x − c|² + 0.1|x|²: x*(c) = c/1.1, dx*/dc = I/1.1; the
    optimiser's iterates follow optax's (the same iteration count)."""
    from hedgehog_tpu.math.optimize import argmin_ift as jax_argmin_ift
    from hedgehog_tpu.math.optimize import minimize_lbfgs as jax_minimize

    def f(x, c):
        return torch.sum((x - c) ** 2) + 0.1 * torch.sum(x**2)

    def jf(x, c):
        return jnp.sum((x - c) ** 2) + 0.1 * jnp.sum(x**2)

    c0 = torch.tensor([0.5, 0.7], dtype=torch.float64)
    res = ht.minimize_lbfgs(lambda x: f(x, c0), torch.tensor([2.0, -1.0], dtype=torch.float64),
                            max_iters=60)
    want = jax_minimize(lambda x: jf(x, jnp.asarray([0.5, 0.7])), jnp.array([2.0, -1.0]),
                        max_iters=60)
    assert res.converged and res.iterations == int(want.iterations)
    np.testing.assert_allclose(res.x.numpy(), c0.numpy() / 1.1, rtol=1e-6)
    c = c0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(ht.argmin_ift(f, res.x, c) ** 2), c)
    np.testing.assert_allclose(g.numpy(), 2.0 * c0.numpy() / 1.1**2, rtol=1e-5)
    jg = jax.grad(lambda cc: jnp.sum(jax_argmin_ift(jf, jnp.asarray(res.x.numpy()), cc) ** 2))(
        jnp.asarray([0.5, 0.7]))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL)


# ---- Monte Carlo baskets and calibration -----------------------------------------

MC_EXPIRY = dt.date(2021, 1, 1)
MC_MARKET = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
MC_STRIKES = (85.0, 95.0, 100.0, 105.0, 120.0)


def _mc_method(pairs, steps=12, qmc=True, seed=3, use_kernel=False):
    cfg = hh.SimulationConfig(trajectories=pairs, steps=steps, variance_reduction=hh.Antithetic(),
                              seed=seed, qmc=qmc)
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True, use_kernel=use_kernel),
                         cfg)


def test_conditional_basket_fast_path():
    """One simulation prices mixed calls and puts at two expiries, equal to
    the JAX package's fast path on the same QMC points (1e-10); a basket the
    fast path does not take falls back to one solve per payoff."""
    payoffs = [hh.VanillaOption(k, e, hh.European(), cp, hh.Spot())
               for e in (dt.date(2020, 7, 1), MC_EXPIRY)
               for k, cp in ((90.0, hh.Call()), (100.0, hh.Put()), (110.0, hh.Call()))]
    basket = hh.BasketPricingProblem(tuple(payoffs), MC_MARKET)
    method = _mc_method(2048, steps=4)
    want = hh.solve(basket, method)
    got = ht.solve(ht.from_reference(basket), _cpu(method))
    assert isinstance(got, ht.BasketPricingSolution) and len(got.solutions) == 6
    for a, b in zip(got.solutions, want.solutions):
        assert float(a.price) == pytest.approx(float(b.price), rel=RTOL)
    single = ht.solve(ht.from_reference(hh.BasketPricingProblem((payoffs[0],), MC_MARKET)),
                      _cpu(_mc_method(256, steps=2, use_kernel=True)))
    assert single.solutions[0].ensemble is not None  # the per-payoff loop's MonteCarloSolution


def test_kernel_route_basket_loops_over_payoffs():
    """Under use_kernel=True (K7's plain twin on the CPU) the basket loops
    over payoffs, each equal to its own solve."""
    from hedgehog_tpu_torch.calibration.calibration import _basket_prices

    basket = ht.from_reference(hh.BasketPricingProblem(
        tuple(hh.VanillaOption(k, MC_EXPIRY, hh.European(), hh.Call(), hh.Spot())
              for k in MC_STRIKES), MC_MARKET))
    method = _cpu(_mc_method(512, use_kernel=True))
    got = _basket_prices(basket, method)
    for p, g in zip(basket.payoffs, got):
        assert float(g) == float(ht.solve(ht.PricingProblem(p, basket.market_inputs),
                                          method).price)


MC_PAYOFFS = tuple(hh.VanillaOption(k, MC_EXPIRY, hh.European(), hh.Call(), hh.Spot())
                   for k in MC_STRIKES)


@functools.lru_cache(maxsize=None)
def _mc_quotes():
    cm = hh.CarrMadan(1.0, 64.0, hh.HestonDynamics(), nodes=1024)
    strikes = jnp.asarray(MC_STRIKES)
    return jnp.asarray(hh.solve(hh.PricingProblem(dataclasses.replace(MC_PAYOFFS[0],
                                                                      strike=strikes),
                                                  MC_MARKET), cm).price)


def _mc_calibration(method):
    payoffs, quotes = MC_PAYOFFS, _mc_quotes()
    guess = hh.HestonInputs(REF, 0.03, 100.0, 0.09, 2.0, 0.04, 0.6, -0.7)
    return hh.CalibrationProblem(hh.BasketPricingProblem(payoffs, guess), quotes,
                                 jnp.asarray([0.09, 0.6]), method,
                                 (hh.FieldLens("market_inputs.V0"),
                                  hh.FieldLens("market_inputs.sigma")))


def test_calibration_through_conditional_mc_public_api():
    """tests/agreement/test_conditional_mc.py:380-413 on the port: V0 and σ
    within rel 5e-2 of 0.04 and 0.30 through the fast path (one simulation
    per objective; JAX took 15 iterations on this problem)."""
    calib = _cpu(_mc_calibration(_mc_method(20_000, seed=0)))
    res = ht.solve(calib, ht.OptimizerAlgo(), lb=[1e-3, 0.05], ub=[0.5, 1.5])
    assert float(res.u[0]) == pytest.approx(0.04, rel=5e-2)
    assert float(res.u[1]) == pytest.approx(0.30, rel=5e-2)
    assert res.converged


def test_calibration_problem_carried_across_prices_the_same():
    """One JAX CalibrationProblem drives both packages: the objective at the
    first guess agrees to 1e-10 (the same QMC points)."""
    from hedgehog_tpu.calibration.calibration import _apply_lenses as jax_apply
    from hedgehog_tpu.calibration.calibration import _basket_prices as jax_prices
    from hedgehog_tpu_torch.calibration.calibration import _apply_lenses, _basket_prices

    calib = _mc_calibration(_mc_method(1024, steps=4, seed=0))
    port = _cpu(calib)
    assert isinstance(port, ht.CalibrationProblem) and port.accessors == (
        ht.FieldLens("market_inputs.V0"), ht.FieldLens("market_inputs.sigma"))
    x = [0.05, 0.4]
    want = jax_prices(jax_apply(calib.pricing_problem, calib.accessors, jnp.asarray(x)),
                      calib.pricing_method)
    got = _basket_prices(_apply_lenses(port.pricing_problem, port.accessors,
                                       torch.tensor(x, dtype=torch.float64)),
                         port.pricing_method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_calibration_objective_through_the_kernel_route():
    """The calibration objective and its gradient under use_kernel=True (on
    the CPU through K7's and K11's plain twins: one forward per payoff, one
    backward per payoff) against the float64 fast path on the same QMC
    points: the twins are float32 per path (rel 1e-4)."""
    from hedgehog_tpu_torch.calibration.calibration import _apply_lenses, _basket_prices

    calib = _cpu(_mc_calibration(_mc_method(1024, seed=0, use_kernel=True)))
    fast = _cpu(_mc_calibration(_mc_method(1024, seed=0)))
    quotes = torch.as_tensor(calib.quotes)

    def objective_and_grad(c):
        x = torch.tensor([0.05, 0.4], dtype=torch.float64, requires_grad=True)
        prices = _basket_prices(_apply_lenses(c.pricing_problem, c.accessors, x),
                                c.pricing_method)
        loss = torch.sum((prices - quotes) ** 2)
        return prices.detach(), loss.detach(), torch.autograd.grad(loss, x)[0]

    p_k, l_k, g_k = objective_and_grad(calib)
    p_f, l_f, g_f = objective_and_grad(fast)
    np.testing.assert_allclose(p_k.numpy(), p_f.numpy(), rtol=1e-4)
    np.testing.assert_allclose(l_k.numpy(), l_f.numpy(), rtol=1e-4)
    np.testing.assert_allclose(g_k.numpy(), g_f.numpy(), rtol=1e-4)


# ---- the device rule ----------------------------------------------------------


@pytest.mark.parametrize("method", [ht.CarrMadan(1.0, "auto", ht.HestonDynamics()),
                                    ht.BlackScholesAnalytic()], ids=["carr_madan", "bs"])
def test_deterministic_pricers_raise_without_a_gpu(method, monkeypatch):
    """CarrMadan and BlackScholesAnalytic run on the GPU by default; with no
    usable GPU they raise, and with device="cpu" they price on the CPU.  So
    do the Black-Scholes closed-form greeks, which take the pricing method's
    device and the GPU where no method is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert method.device == "cuda"
    market = MC_MARKET if isinstance(method, ht.CarrMadan) else hh.BlackScholesInputs(
        REF, 0.03, 100.0, 0.2)
    prob = ht.from_reference(hh.PricingProblem(
        hh.VanillaOption(100.0, MC_EXPIRY, hh.European(), hh.Call(), hh.Spot()), market))
    with pytest.raises(RuntimeError, match="is_available"):
        ht.solve(prob, method)
    price = ht.solve(prob, _cpu_method(method)).price
    assert price.device.type == "cpu" and torch.isfinite(price)
    if isinstance(method, ht.BlackScholesAnalytic):
        gprob = ht.GreekProblem(prob, ht.SpotLens())
        for args in ((), (method,)):
            with pytest.raises(RuntimeError, match="is_available"):
                ht.solve(gprob, ht.AnalyticGreek(), *args)
        delta = ht.solve(gprob, ht.AnalyticGreek(), _cpu_method(method)).greek
        assert delta.device.type == "cpu" and 0.0 < float(delta) < 1.0
    calib = ht.CalibrationProblem(ht.BasketPricingProblem([prob.payoff], prob.market_inputs),
                                  [float(price)], [0.2], method, (ht.FieldLens(
                                      "market_inputs.spot"),))
    with pytest.raises(RuntimeError, match="is_available"):
        ht.solve(calib, ht.OptimizerAlgo(max_iters=2))
