"""The port's greeks against the JAX package: the cases of
tests/agreement/test_greeks_agreement.py (AD against FD against the closed
forms, theta in ticks, the rate-spine pillar deltas through a cubic curve,
the one-pass greek vector) with each greek held against the JAX package's
own, the Black-Scholes goldens of tests/unit/test_black_scholes.py, and the
greek vector of the kernel route.

Problems are built in JAX and carried across with ``from_reference``; the
pricing methods run on the CPU.  AD, analytic and FD greeks (the same
stencils) agree with the JAX package's to 1e-10 relative, except where a
finite difference divides a rounding difference by a tiny bump (stated)."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2020, 1, 1)
EXPIRY = dt.date(2021, 1, 1)
BS = hh.BlackScholesAnalytic()
BS_PORT = ht.BlackScholesAnalytic(device="cpu")
RTOL = 1e-10


def make_prob(strike=1.2, cp=hh.Put(), rate=0.2, sigma=0.4, spot=1.0, und=hh.Forward()):
    payoff = hh.VanillaOption(strike, EXPIRY, hh.European(), cp, und)
    return hh.PricingProblem(payoff, hh.BlackScholesInputs(REF, rate, spot, sigma))


def both(gprob, method, rtol=RTOL, atol=1e-300):
    """The greek from both packages, held together; returns the port's."""
    want = float(hh.solve(gprob, method, BS).greek)
    got = ht.solve(ht.from_reference(gprob), ht.from_reference(method), BS_PORT).greek
    assert float(got) == pytest.approx(want, rel=rtol, abs=atol)
    return float(got)


@pytest.mark.parametrize("lens", [hh.VolLens(1, 1), hh.FieldLens("market_inputs.spot"),
                                  hh.SpotLens()], ids=["vol", "field_spot", "spot"])
def test_first_order_ad_vs_fd(lens):
    gp = make_prob()
    gp = hh.GreekProblem(gp, lens)
    ad = both(gp, hh.ForwardAD())
    rv = both(gp, hh.ReverseAD())
    fd = both(gp, hh.FiniteDifference(1e-4))
    assert ad == pytest.approx(fd, rel=1e-5)
    assert ad == pytest.approx(rv, rel=1e-12)


@pytest.mark.parametrize("scheme", [hh.FDForward(), hh.FDBackward(), hh.FDCentral()])
def test_fd_schemes_match_reference(scheme):
    both(hh.GreekProblem(make_prob(), hh.FieldLens("market_inputs.spot")),
         hh.FiniteDifference(1e-4, scheme))


@pytest.mark.parametrize("lens", [hh.FieldLens("market_inputs.spot"), hh.VolLens(1, 1)],
                         ids=["spot", "vol"])
def test_second_order_ad_vs_fd(lens):
    gp = hh.SecondOrderGreekProblem(make_prob(), lens, lens)
    ad = both(gp, hh.ForwardAD())
    rv = both(gp, hh.ReverseAD())
    fd = both(gp, hh.FiniteDifference(1e-4))
    assert ad == pytest.approx(fd, rel=1e-5)
    assert ad == pytest.approx(rv, rel=1e-12)


def test_mixed_second_order_matches_reference():
    gp = hh.SecondOrderGreekProblem(make_prob(), hh.SpotLens(), hh.VolLens(1, 1))
    ad = both(gp, hh.ForwardAD())
    assert ad == pytest.approx(both(gp, hh.ReverseAD()), rel=1e-12)
    assert ad == pytest.approx(both(gp, hh.FiniteDifference(1e-4)), rel=1e-5)


def test_ad_fd_analytic_triple():
    prob = make_prob(strike=1.0, cp=hh.Call(), rate=0.03, sigma=1.0)
    vol_lens, spot_lens = hh.VolLens(1, 1), hh.FieldLens("market_inputs.spot")
    vega = [both(hh.GreekProblem(prob, vol_lens), m)
            for m in (hh.ForwardAD(), hh.FiniteDifference(1e-4), hh.AnalyticGreek())]
    assert vega[0] == pytest.approx(vega[1], rel=1e-5)
    assert vega[0] == pytest.approx(vega[2], rel=1e-5)
    for lens, fd_rel in ((spot_lens, 1e-5), (vol_lens, 1e-3)):
        gp2 = hh.SecondOrderGreekProblem(prob, lens, lens)
        ad, fd, an = (both(gp2, m)
                      for m in (hh.ForwardAD(), hh.FiniteDifference(1e-4), hh.AnalyticGreek()))
        assert ad == pytest.approx(fd, rel=fd_rel)
        assert ad == pytest.approx(an, rel=1e-5)


def test_theta_in_ticks():
    """The 1e-12 relative bump on ~6.4e13 ticks moves the price by ~1e-9, so
    the FD theta carries the packages' rounding differences amplified ~1e7:
    held to the JAX test's 5e-3 against the AD theta, not to the JAX FD."""
    prob = make_prob(strike=1.0, cp=hh.Call(), rate=0.03, sigma=1.0)
    gp = hh.GreekProblem(prob, hh.FieldLens("payoff.expiry"))
    theta_ad = both(gp, hh.ForwardAD())
    theta_an = both(gp, hh.AnalyticGreek())
    theta_rv = both(gp, hh.ReverseAD())
    theta_fd = float(ht.solve(ht.from_reference(gp), ht.FiniteDifference(1e-12), BS_PORT).greek)
    assert theta_ad == pytest.approx(theta_fd, rel=5e-3)
    assert theta_ad == pytest.approx(theta_an, rel=1e-8)
    assert theta_ad == pytest.approx(theta_rv, rel=1e-12)


def test_zero_rate_pillar_deltas():
    """Pillar deltas through a cubic curve: AD against FD (the JAX test's
    rel 1e-6, abs 1e-9) and each against the JAX package's.  The FD bump of
    a ~3% rate by 1e-5 is ~3e-7, so price rounding (~1e-16 of ~0.4) reaches
    the FD delta at ~1e-10 absolute: FD against the JAX FD to abs 1e-9."""
    payoff = hh.VanillaOption(1.0, dt.date(2020, 4, 2), hh.European(), hh.Put(), hh.Forward())
    rates = np.array([0.03, 0.032, 0.07, 0.042, 0.03])
    tenors = np.array([0.25, 0.5, 1.0, 2.0, 5.0])
    curve = hh.RateCurve.from_dfs(REF, tenors, np.exp(-rates * tenors), interp="cubic")
    prob = hh.PricingProblem(payoff, hh.BlackScholesInputs(REF, curve, 1.0, 1.0))
    for i in range(len(ht.spine_zeros(ht.from_reference(curve)))):
        gp = hh.GreekProblem(prob, hh.ZeroRateSpineLens(i))
        g_ad = both(gp, hh.ForwardAD())
        g_rv = both(gp, hh.ReverseAD())
        g_fd = both(gp, hh.FiniteDifference(1e-5), rtol=0.0, atol=1e-9)
        assert g_ad == pytest.approx(g_fd, rel=1e-6, abs=1e-9), f"pillar {i}"
        assert g_ad == pytest.approx(g_rv, rel=1e-10, abs=1e-18)


@pytest.mark.parametrize("method", [hh.ReverseAD(), hh.ForwardAD(), hh.FiniteDifference(1e-4),
                                    hh.AnalyticGreek()],
                         ids=["reverse", "forward", "fd", "analytic"])
def test_batch_greeks_single_pass(method):
    prob = make_prob(strike=1.0, cp=hh.Call(), rate=0.03, sigma=0.5)
    lenses = (hh.SpotLens(), hh.VolLens(1, 1), hh.ZeroRateSpineLens(0))
    if isinstance(method, hh.AnalyticGreek):
        lenses = lenses[:2]
    bp = hh.BatchGreekProblem(prob, lenses)
    want = hh.solve(bp, method, BS)
    got = ht.solve(ht.from_reference(bp), ht.from_reference(method), BS_PORT)
    assert set(got) == {ht.from_reference(lens) for lens in lenses}
    for lens in lenses:
        plens = ht.from_reference(lens)
        assert float(got[plens]) == pytest.approx(float(want[lens]), rel=RTOL)
        single = float(ht.solve(ht.GreekProblem(ht.from_reference(prob), plens), ht.ForwardAD(),
                                BS_PORT).greek)
        fd = isinstance(method, hh.FiniteDifference)
        assert float(got[plens]) == pytest.approx(single, rel=1e-5 if fd else 1e-10)


@pytest.mark.parametrize("cp,strike,expiry,want", [
    (hh.Call(), 90.0, 1.0, 16.6994), (hh.Put(), 90.0, 1.0, 2.3101),
    (hh.Put(), 110.0, dt.date(2024, 4, 1), 9.8237)], ids=["call", "put", "put_91d"])
def test_quantlib_goldens_and_their_greeks(cp, strike, expiry, want):
    """QuantLib goldens (atol 1e-4, tests/unit/test_black_scholes.py:52-57),
    and their delta and vega by AD, FD and closed form."""
    ref = dt.date(2024, 1, 1)
    expiry = hh.add_yearfrac(ref, expiry) if isinstance(expiry, float) else expiry
    prob = hh.PricingProblem(hh.VanillaOption(strike, expiry, hh.European(), cp, hh.Spot()),
                             hh.BlackScholesInputs(ref, 0.05, 100.0, 0.2))
    assert float(ht.solve(ht.from_reference(prob), BS_PORT).price) == pytest.approx(want, abs=1e-4)
    for lens in (hh.SpotLens(), hh.VolLens(1, 1)):
        gp = hh.GreekProblem(prob, lens)
        ad, fd, an = (both(gp, m)
                      for m in (hh.ReverseAD(), hh.FiniteDifference(1e-4), hh.AnalyticGreek()))
        assert ad == pytest.approx(an, rel=1e-10)
        assert ad == pytest.approx(fd, rel=1e-6)


def test_analytic_greek_refuses_what_it_lacks():
    prob = ht.from_reference(make_prob())
    with pytest.raises(ValueError, match="Unsupported lens"):
        ht.solve(ht.GreekProblem(prob, ht.ZeroRateSpineLens(0)), ht.AnalyticGreek(), BS_PORT)


# ---- the kernel route ---------------------------------------------------------

HESTON = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
HESTON_LENSES = (hh.SpotLens(), *(hh.FieldLens(f"market_inputs.{n}")
                                  for n in ("V0", "kappa", "theta", "sigma", "rho")),
                 hh.ZeroRateSpineLens(0))


def _heston_method(use_kernel, pairs=4096, steps=4, qmc=False):
    cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 1, qmc)
    return ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True, use_kernel=use_kernel),
                         cfg, device="cpu")


def _heston_prob():
    return ht.from_reference(hh.PricingProblem(
        hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()), HESTON))


@pytest.mark.parametrize("qmc", [False, True], ids=["prng", "qmc"])
def test_batch_reverse_ad_through_the_kernel_route(qmc):
    """BatchGreekProblem(ReverseAD) of the 7-parameter Heston vector through
    ``use_kernel=True`` (on the CPU: K7's and K11's plain twins, one forward
    and one backward) against ``torch.autograd.grad`` of the same solve, and
    against the float64 estimator's greeks on the same stream (the twins are
    float32 per path: rel 1e-4, abs 1e-4)."""
    prob = _heston_prob()
    method = _heston_method(True, qmc=qmc)
    lenses = tuple(ht.from_reference(lens) for lens in HESTON_LENSES)
    got = ht.solve(ht.BatchGreekProblem(prob, lenses), ht.ReverseAD(), method)
    leaves = [torch.tensor(float(lens.get(prob)), dtype=torch.float64, requires_grad=True)
              for lens in lenses]
    p = prob
    for lens, leaf in zip(lenses, leaves):
        p = lens.set(p, leaf)
    direct = torch.autograd.grad(ht.solve(p, method).price, leaves)
    f64_greeks = ht.solve(ht.BatchGreekProblem(prob, lenses), ht.ReverseAD(),
                          _heston_method(False, qmc=qmc))
    for lens, d in zip(lenses, direct):
        assert float(got[lens]) == pytest.approx(float(d), rel=1e-12, abs=1e-15)
        assert float(got[lens]) == pytest.approx(float(f64_greeks[lens]), rel=1e-4, abs=1e-4)


def test_forward_mode_through_the_kernel_route_raises():
    """The kernels have a backward only (as the JAX package's): forward-mode
    and second-order greeks through use_kernel=True raise a TypeError naming
    the alternatives, and never return a derivative."""
    prob, method = _heston_prob(), _heston_method(True, pairs=256)
    spot = ht.SpotLens()
    for gprob, gm in ((ht.GreekProblem(prob, spot), ht.ForwardAD()),
                      (ht.BatchGreekProblem(prob, (spot,)), ht.ForwardAD()),
                      (ht.SecondOrderGreekProblem(prob, spot, spot), ht.ForwardAD()),
                      (ht.SecondOrderGreekProblem(prob, spot, spot), ht.ReverseAD())):
        with pytest.raises(TypeError, match="ReverseAD.*use_kernel=False"):
            ht.solve(gprob, gm, method)


def _kernel_method(strategy, dynamics=None, steps=4, pairs=256):
    cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 1, False)
    return ht.MonteCarlo(dynamics or ht.HestonDynamics(), strategy, cfg, device="cpu")


def _surface_kernel(v0):
    """K9/K12's differentiable view at a small size, differentiable in V0."""
    from hedgehog_tpu_torch.ops.heston_qe_greeks_kernel import heston_qe_mixing_surface_price_diff

    return heston_qe_mixing_surface_price_diff(
        np.log(100.0), v0, 0.03, 2.0, 0.04, 0.3, -0.7, (0.5, 1.0), (90.0, 100.0, 110.0),
        seg_steps=(4, 4), n_strikes=3, n_blocks=1, n_batches=1, seed=5, device="cpu").sum()


def _solve_kernel_route(method, market, lens):
    prob = ht.PricingProblem(ht.VanillaOption(100.0, ht.from_reference(EXPIRY)), market)
    return lambda x: ht.solve(lens.set(prob, x), method).price


_BS_MARKET = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
_RB_MARKET = ht.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.5, 0.1, -0.7)
_V0 = ht.FieldLens("market_inputs.V0")
_KERNEL_ROUTES = {
    "K7": lambda: _solve_kernel_route(_kernel_method(ht.HestonQE(conditional=True,
                                                                 use_kernel=True)),
                                      ht.from_reference(HESTON), _V0),
    "K14": lambda: _solve_kernel_route(_kernel_method(ht.RoughBergomiMixing(use_kernel=True),
                                                      ht.RoughBergomiDynamics()),
                                       _RB_MARKET, ht.SpotLens()),
    "K12": lambda: _surface_kernel,
    "K1": lambda: _solve_kernel_route(_kernel_method(ht.EulerMaruyama(use_kernel=True)),
                                      ht.from_reference(HESTON), _V0),
    "K2": lambda: _solve_kernel_route(_kernel_method(ht.HestonExactMixing(use_kernel=True),
                                                     steps=2),
                                      ht.from_reference(HESTON), _V0),
    "K5": lambda: _solve_kernel_route(_kernel_method(ht.HestonQE(use_kernel=True)),
                                      ht.from_reference(HESTON), _V0),
    "K13": lambda: _solve_kernel_route(_kernel_method(ht.BlackScholesExact(use_kernel=True),
                                                      ht.LognormalDynamics(), steps=1),
                                       _BS_MARKET, ht.FieldLens("market_inputs.sigma.sigma")),
}


@pytest.mark.parametrize("kernel", list(_KERNEL_ROUTES))
@pytest.mark.parametrize("mode", ["forward", "second", "reverse"])
def test_kernels_refuse_the_derivatives_they_cannot_give(kernel, mode):
    """The refusals sit in the kernels' autograd Functions, so they hold for
    torch.func and torch.autograd applied to a use_kernel=True price
    directly, not only through solve(GreekProblem): the kernels with a
    backward (K7→K11, K14→K17, K12) give first-order reverse mode (K7's and
    K12's the same by torch.func.grad as by torch.autograd.grad) and refuse
    forward mode and a second derivative with a TypeError naming the
    alternatives; the kernels that read host floats (K1, K2, K5, K13) refuse
    every derivative with NotImplementedError.  None returns a derivative."""
    f = _KERNEL_ROUTES[kernel]()
    x0 = torch.tensor(0.2 if kernel == "K13" else (100.0 if kernel == "K14" else 0.04),
                      dtype=torch.float64)
    backward_only = kernel in ("K7", "K14", "K12")
    x = x0.clone().requires_grad_(True)
    if mode == "reverse":
        if backward_only:
            (g,) = torch.autograd.grad(f(x), x)
            assert torch.isfinite(g) and float(g) != 0.0
            if kernel != "K14":  # K17's backward builds its inputs with numpy
                assert float(torch.func.grad(f)(x0)) == float(g)
            return
        with pytest.raises(NotImplementedError, match=f"{kernel} .*use_kernel=False"):
            torch.autograd.grad(f(x), x)
        return
    error = (TypeError, "ReverseAD.*use_kernel=False") if backward_only else (
        NotImplementedError, f"{kernel} .*use_kernel=False")
    with pytest.raises(error[0], match=error[1]):
        if mode == "forward":
            torch.func.jvp(f, (x0,), (torch.ones_like(x0),))
        else:
            (g,) = torch.autograd.grad(f(x), x, create_graph=True)
            torch.autograd.grad(g, x)


def test_forward_ad_through_the_float64_estimator():
    """ForwardAD through the float64 QE mixing estimator equals ReverseAD."""
    prob, method = _heston_prob(), _heston_method(False, pairs=1024)
    for lens in (ht.SpotLens(), ht.FieldLens("market_inputs.V0")):
        fwd = ht.solve(ht.GreekProblem(prob, lens), ht.ForwardAD(), method).greek
        rev = ht.solve(ht.GreekProblem(prob, lens), ht.ReverseAD(), method).greek
        assert float(fwd) == pytest.approx(float(rev), rel=1e-12)


def test_greek_problem_carried_across_prices_the_same():
    """One JAX GreekProblem drives both packages."""
    gp = hh.GreekProblem(make_prob(strike=1.0, cp=hh.Call(), rate=0.03, sigma=0.5), hh.SpotLens())
    port = ht.from_reference(gp)
    assert isinstance(port, ht.GreekProblem) and port.wrt == ht.SpotLens()
    assert float(ht.solve(port.pricing_problem, BS_PORT).price) == pytest.approx(
        float(hh.solve(gp.pricing_problem, BS).price), rel=RTOL)
    assert ht.from_reference(hh.FiniteDifference(1e-3, hh.FDForward())) == ht.FiniteDifference(
        1e-3, ht.FDForward())
    method = ht.from_reference(BS)
    assert method == ht.BlackScholesAnalytic() and dataclasses.replace(method, device="cpu") == \
        BS_PORT
