"""The bivariate normal, the exotic payoffs, the Black-Scholes exotic closed
forms and the Carr–Madan digital against the JAX package on the CPU.

Everything here is deterministic: torch float64 agrees with JAX float64 to
1e-12 relative or 1e-14 absolute (a value of a few 1e-15 is rounding of a
difference of O(1) terms); autograd deltas and vegas of the barrier and
lookback closed forms agree with ``jax.grad`` to 1e-9."""

import dataclasses
import datetime as dt
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import black_scholes as jbs
from hedgehog_tpu_torch.math.bvn import bvn_cdf
from hedgehog_tpu_torch.methods import black_scholes as pbs

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
T1 = dt.date(2024, 7, 1)
R, Q, SPOT, SIGMA = 0.05, 0.02, 100.0, 0.25
H = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)
CPU = "cpu"
RTOL, ATOL = 1e-12, 1e-14


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _bs(q=Q, sigma=SIGMA, r=R, spot=SPOT):
    return hh.BlackScholesInputs(REF, r, spot, sigma, dividend_yield=q)


def _both(payoff, market=None, method=None, port=None):
    """(port price, JAX price) of ``payoff`` under ``method`` (default the
    closed forms) and its port counterpart (default carried across)."""
    prob = hh.PricingProblem(payoff, market or _bs())
    method = method or hh.BlackScholesAnalytic()
    want = hh.solve(prob, method).price
    port = port or dataclasses.replace(ht.from_reference(method), device=CPU)
    return ht.solve(ht.from_reference(prob), port).price, want


# -- bvn -----------------------------------------------------------------------


@pytest.mark.parametrize("rho", [-0.99, -0.5, 0.0, 0.7, 0.99])
def test_bvn_cdf_matches_reference(rho):
    rng = np.random.default_rng(int(100 * rho) + 107)
    h, k = rng.uniform(-3.5, 3.5, (2, 33))
    _close(bvn_cdf(torch.tensor(h), torch.tensor(k), rho), hh.bvn_cdf(h, k, rho))


def test_bvn_cdf_broadcasts_and_differentiates():
    h = np.linspace(-2, 2, 5)[:, None]
    k = np.linspace(-1, 3, 4)[None, :]
    rho = np.array([-0.3, 0.2, 0.6, 0.9])
    _close(bvn_cdf(torch.tensor(h), torch.tensor(k), torch.tensor(rho)), hh.bvn_cdf(h, k, rho))
    r = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    g = torch.autograd.grad(bvn_cdf(0.5, -0.3, r), r)[0]
    want = jax.grad(lambda x: hh.bvn_cdf(0.5, -0.3, x))(0.6)
    _close(g, want, rtol=1e-9)


# -- payoffs --------------------------------------------------------------------


PAYOFFS = {
    "digital": hh.DigitalOption(105.0, EXPIRY, hh.European(), hh.Put(), hh.Spot(), 7.0),
    "barrier": hh.BarrierOption(100.0, EXPIRY, 120.0, hh.European(), hh.Call(), hh.Spot(),
                                hh.Up(), hh.KnockOut(), 2.0, True),
    "double": hh.DoubleBarrierOption(100.0, EXPIRY, 80.0, 125.0, call_put=hh.Put(),
                                     knock=hh.KnockIn(), rebate=1.5),
    "asian": hh.AsianOption(100.0, EXPIRY, 12, call_put=hh.Put(),
                            averaging=hh.GeometricAverage()),
    "lookback": hh.LookbackOption(EXPIRY, 95.0, hh.FixedStrike(), hh.Put(),
                                  running_extremum=92.0),
    "forward start": hh.ForwardStartOption(0.95, EXPIRY, T1, call_put=hh.Put()),
    "compound": hh.CompoundOption(4.0, T1, 100.0, EXPIRY, call_put=hh.Put(),
                                  inner_call_put=hh.Put()),
    "chooser": hh.ChooserOption(100.0, EXPIRY, T1),
    "cliquet": hh.Cliquet(EXPIRY, 6, -0.01, 0.05, 2.0),
    "autocallable": hh.Autocallable(EXPIRY, 6, 1.02, 0.04, 0.65, 0.8, 3.0, "continuous"),
    "variance swap": hh.VarianceSwap(0.05, EXPIRY, 52, 10.0),
}


@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_payoffs_carry_across_and_pay_as_the_reference(name):
    ref = PAYOFFS[name]
    port = ht.from_reference(ref)
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        assert type(got).__name__ == type(want).__name__ or float(got) == float(want), f.name
    rng = np.random.default_rng(3)
    s = rng.uniform(60.0, 140.0, (2, 9))
    if name == "lookback":
        assert port.uses_maximum == ref.uses_maximum
        _close(port(torch.tensor(s[0]), torch.tensor(s[1])), ref(s[0], s[1]))
    elif name == "forward start":
        _close(port(torch.tensor(s[0]), torch.tensor(s[1])), ref(s[0], s[1]))
    elif name == "compound":
        _close(port.decision_value(torch.tensor(s[0] / 10)), ref.decision_value(s[0] / 10))
    elif name == "cliquet":
        ret = rng.uniform(-0.1, 0.1, (9, 6))
        _close(port(torch.tensor(ret)), ref(ret))
    elif name == "variance swap":
        _close(port(torch.tensor(s[0] / 1e3)), ref(s[0] / 1e3))
    elif name not in ("chooser", "autocallable"):
        _close(port(torch.tensor(s[0])), ref(s[0]))


def test_payoff_validation_matches_reference():
    for ctor in (hh, ht):
        with pytest.raises(ValueError, match="knock-outs only"):
            ctor.BarrierOption(100.0, EXPIRY, 90.0, knock=ctor.KnockIn(), rebate=1.0,
                               rebate_at_hit=True)
        with pytest.raises(ValueError, match="knock-outs only"):
            ctor.DoubleBarrierOption(100.0, EXPIRY, 80.0, 120.0, knock=ctor.KnockIn(),
                                     rebate_at_hit=True)
        with pytest.raises(ValueError, match="precede"):
            ctor.CompoundOption(4.0, EXPIRY, 100.0, T1)
        with pytest.raises(ValueError, match="precede"):
            ctor.ChooserOption(100.0, T1, EXPIRY)
        with pytest.raises(ValueError, match="ki_monitoring"):
            ctor.Autocallable(EXPIRY, ki_monitoring="daily")


def test_digital_parity_transform():
    D = float(np.exp(-R * float(hh.yearfrac(REF, EXPIRY))))
    put = ht.from_reference(PAYOFFS["digital"])
    call = dataclasses.replace(put, call_put=ht.Call())
    rate = ht.from_reference(_bs()).rate
    p = ht.parity_transform(torch.tensor(3.0, dtype=torch.float64), put, SPOT, rate)
    _close(p, 7.0 * D - 3.0)
    assert float(ht.parity_transform(torch.tensor(3.0, dtype=torch.float64), call, SPOT,
                                     rate)) == 3.0


# -- closed forms -----------------------------------------------------------------

STRIKES = np.array([[85.0], [100.0], [115.0]])
BARRIERS = {True: np.array([[100.0, 105.0, 120.0, 140.0]]),  # up: at spot and above
            False: np.array([[60.0, 80.0, 95.0, 100.0]])}  # down: below and at spot


@pytest.mark.parametrize("cp,up,knock_in,rebate,at_hit,carry", [
    (cp, up, ki, rb, hit, q)
    for cp, up, ki in itertools.product((1.0, -1.0), (True, False), (True, False))
    for rb, hit in ((0.0, False), (3.0, False), (3.0, True))
    for q in (0.0, 0.03)
    if not (ki and hit)
])
def test_bs_barrier_price_matches_reference(cp, up, knock_in, rebate, at_hit, carry):
    T, D = 1.0, np.exp(-R)
    args = (SPOT, STRIKES, BARRIERS[up], SIGMA, T, D, cp)
    kw = dict(up=up, knock_in=knock_in, rebate=rebate, rebate_at_hit=at_hit, carry=carry)
    want = jbs.bs_barrier_price(*args, **kw)
    got = pbs.bs_barrier_price(*(torch.tensor(a, dtype=torch.float64) for a in args[:-1]),
                               cp, **kw)
    _close(got, want)
    # σ = 0: the deterministic path
    args0 = (SPOT, STRIKES, BARRIERS[up], 0.0, T, D, cp)
    got0 = pbs.bs_barrier_price(*(torch.tensor(a, dtype=torch.float64) for a in args0[:-1]),
                                cp, **kw)
    _close(got0, jbs.bs_barrier_price(*args0, **kw))


@pytest.mark.parametrize("cp,knock_in,rebate,carry", [
    (cp, ki, rb, q) for cp in (1.0, -1.0) for ki in (True, False) for rb in (0.0, 2.0)
    for q in (0.0, 0.03)])
def test_bs_double_barrier_price_matches_reference(cp, knock_in, rebate, carry):
    lower = np.array([[70.0, 80.0, 90.0, 100.0]])
    upper = np.array([[110.0], [125.0], [150.0]])
    args = (SPOT, 100.0, lower, upper, SIGMA, 1.0, np.exp(-R), cp)
    kw = dict(knock_in=knock_in, rebate=rebate, carry=carry)
    got = pbs.bs_double_barrier_price(*(torch.tensor(a, dtype=torch.float64)
                                        for a in args[:-1]), cp, **kw)
    # the image series sums ±terms of the spot's size (100) that cancel to
    # prices near zero: its rounding is 1e-14 of the spot, not of the price
    _close(got, jbs.bs_double_barrier_price(*args, **kw), atol=1e-14 * SPOT)


@pytest.mark.parametrize("fixed,cp,carry", [
    (f, cp, q) for f in (True, False) for cp in (1.0, -1.0) for q in (0.0, 0.05, 0.03)])
def test_bs_lookback_price_matches_reference(fixed, cp, carry):
    # carry 0.05 = r: b = 0 exactly, the Taylor limit
    ext = np.array([[88.0], [100.0], [112.0]])
    ext = np.maximum(ext, SPOT) if (cp > 0) == fixed else np.minimum(ext, SPOT)
    strikes = np.array([[90.0, 100.0, 110.0]])
    args = (SPOT, strikes, ext, SIGMA, 1.0, np.exp(-R), cp)
    got = pbs.bs_lookback_price(*(torch.tensor(a, dtype=torch.float64) for a in args[:-1]),
                                cp, fixed=fixed, carry=carry)
    _close(got, jbs.bs_lookback_price(*args, fixed=fixed, carry=carry))


@pytest.mark.parametrize("n,cp,carry", [(n, cp, q) for n in (1, 12, 252) for cp in (1.0, -1.0)
                                        for q in (0.0, 0.03)])
def test_bs_geometric_asian_and_digital_match_reference(n, cp, carry):
    strikes = np.linspace(80.0, 120.0, 41)
    args = (SPOT, strikes, SIGMA, 1.0, np.exp(-R), cp)
    got = pbs.bs_geometric_asian_price(*(torch.tensor(a, dtype=torch.float64)
                                         for a in args[:-1]), cp, n, carry=carry)
    _close(got, jbs.bs_geometric_asian_price(*args, n, carry=carry))
    fwd = SPOT * np.exp(R - carry)
    dargs = (fwd, strikes, SIGMA * n / 12, 1.0, np.exp(-R), cp)
    got = pbs.bs_digital_price(*(torch.tensor(a, dtype=torch.float64) for a in dargs[:-1]),
                               cp, 3.0)
    _close(got, jbs.bs_digital_price(*dargs, 3.0))


def _solve_cases():
    C, P = hh.Call(), hh.Put()
    yield "digital call", hh.DigitalOption(105.0, EXPIRY, cash=10.0)
    yield "digital put", hh.DigitalOption(95.0, EXPIRY, call_put=P, cash=10.0)
    yield "up-out call at-hit", hh.BarrierOption(100.0, EXPIRY, 120.0, call_put=C,
                                                 direction=hh.Up(), rebate=3.0,
                                                 rebate_at_hit=True)
    yield "down-in put", hh.BarrierOption(95.0, EXPIRY, 85.0, call_put=P, knock=hh.KnockIn(),
                                          rebate=1.0)
    yield "touched down-out", hh.BarrierOption(100.0, EXPIRY, 101.0, rebate=2.0,
                                               rebate_at_hit=True)
    yield "double knock-out", hh.DoubleBarrierOption(100.0, EXPIRY, 80.0, 125.0, rebate=1.0)
    yield "double knock-in put", hh.DoubleBarrierOption(100.0, EXPIRY, 80.0, 125.0,
                                                        call_put=P, knock=hh.KnockIn())
    yield "geometric asian", hh.AsianOption(100.0, EXPIRY, 12, averaging=hh.GeometricAverage())
    yield "floating lookback call", hh.LookbackOption(EXPIRY)
    yield "fixed lookback put", hh.LookbackOption(EXPIRY, 100.0, hh.FixedStrike(), P,
                                                  running_extremum=93.0)
    yield "forward start", hh.ForwardStartOption(1.05, EXPIRY, T1)
    yield "forward start put", hh.ForwardStartOption(0.95, EXPIRY, T1, call_put=P)
    yield "cliquet", hh.Cliquet(EXPIRY, 12, -0.01, 0.04, 100.0)
    yield "variance swap", hh.VarianceSwap(0.05, EXPIRY, 52, 100.0)
    for w1, w2 in itertools.product((C, P), (C, P)):
        yield f"compound {w1} on {w2}", hh.CompoundOption(4.0, T1, 100.0, EXPIRY,
                                                          call_put=w1, inner_call_put=w2)
    yield "chooser", hh.ChooserOption(100.0, EXPIRY, T1)


CASES = dict(_solve_cases())


@pytest.mark.parametrize("name", list(CASES))
def test_closed_form_solve_matches_reference(name):
    got, want = _both(CASES[name])
    assert got.device.type == CPU
    _close(got, want)


def test_closed_forms_on_a_curve():
    """A RateCurve and zero carry: the flat rate r = −ln(D)/T of the closed
    forms, the curve's discounts, the two-date forms' D(t1)."""
    curve = hh.RateCurve(REF, jnp.array([0.25, 1.0, 2.0]), jnp.array([0.02, 0.04, 0.05]))
    market = hh.BlackScholesInputs(REF, curve, SPOT, SIGMA)
    for name in ("up-out call at-hit", "double knock-out", "compound Call() on Put()",
                 "chooser", "forward start", "cliquet"):
        got, want = _both(CASES[name], market)
        _close(got, want)


@pytest.mark.parametrize("wrt", ["spot", "sigma"])
def test_barrier_and_lookback_closed_form_greeks_match_jax_grad(wrt):
    def jax_price(x, payoff):
        spot, sigma = (x, SIGMA) if wrt == "spot" else (SPOT, x)
        return hh.solve(hh.PricingProblem(payoff, _bs(spot=spot, sigma=sigma)),
                        hh.BlackScholesAnalytic()).price

    x0 = SPOT if wrt == "spot" else SIGMA
    for name in ("up-out call at-hit", "down-in put", "floating lookback call",
                 "fixed lookback put"):
        payoff = CASES[name]
        want = jax.grad(jax_price)(jnp.float64(x0), payoff)
        x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
        spot, sigma = (x, SIGMA) if wrt == "spot" else (SPOT, x)
        market = ht.BlackScholesInputs(REF, R, spot, sigma, dividend_yield=Q)
        prob = ht.PricingProblem(ht.from_reference(payoff), market)
        price = ht.solve(prob, ht.BlackScholesAnalytic(device=CPU)).price
        got = torch.autograd.grad(price, x)[0]
        _close(got, want, rtol=1e-9, atol=1e-12)


def test_closed_form_refusals_match_reference():
    surf = hh.RectVolSurface(REF, jnp.array([0.5, 1.0]), jnp.array([90.0, 110.0]),
                             0.2 * jnp.ones((2, 2)))
    bs_surf = hh.BlackScholesInputs(REF, R, SPOT, surf)
    for payoff, match in (
            (CASES["cliquet"], "flat vol"), (CASES["forward start"], "flat vol"),
            (CASES["variance swap"], "non-flat"), (CASES["floating lookback call"], "flat vol"),
            (CASES["chooser"], "flat vol")):
        for pkg, method in ((hh, hh.BlackScholesAnalytic()),
                            (ht, ht.BlackScholesAnalytic(device=CPU))):
            prob = hh.PricingProblem(payoff, bs_surf)
            with pytest.raises(TypeError, match=match):
                pkg.solve(prob if pkg is hh else ht.from_reference(prob), method)
    for payoff, match in ((hh.AsianOption(100.0, EXPIRY, 12), "arithmetic"),
                          (hh.DoubleBarrierOption(100.0, EXPIRY, 80.0, 120.0,
                                                  rebate_at_hit=True), "one-touch"),
                          (hh.BarrierOption(100.0, EXPIRY, 90.0, hh.American()), "European")):
        with pytest.raises(TypeError, match=match):
            hh.solve(hh.PricingProblem(payoff, _bs()), hh.BlackScholesAnalytic())
        with pytest.raises(TypeError, match=match):
            ht.solve(ht.from_reference(hh.PricingProblem(payoff, _bs())),
                     ht.BlackScholesAnalytic(device=CPU))


def test_closed_forms_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    prob = ht.from_reference(hh.PricingProblem(CASES["up-out call at-hit"], _bs()))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.solve(prob, ht.BlackScholesAnalytic())


# -- Carr–Madan digital ------------------------------------------------------------


@pytest.mark.parametrize("model,cp", [(m, cp) for m in ("bs", "heston")
                                      for cp in ("call", "put")])
def test_carr_madan_digital_matches_reference(model, cp):
    cpo = hh.Call() if cp == "call" else hh.Put()
    strikes = np.linspace(80.0, 120.0, 41)
    payoff = hh.DigitalOption(jnp.asarray(strikes), EXPIRY, hh.European(), cpo, hh.Spot(), 5.0)
    if model == "bs":
        market, dyn = _bs(), hh.LognormalDynamics()
    else:
        market, dyn = hh.HestonInputs(REF, 0.03, SPOT, *H.values()), hh.HestonDynamics()
    method = hh.CarrMadan(1.0, "auto", dyn, engine="complex")
    port = ht.CarrMadan(1.0, "auto", ht.from_reference(dyn), device=CPU)
    got, want = _both(payoff, market, method, port)
    _close(got, want)
    if model == "bs":
        closed, _ = _both(payoff, market)
        _close(got, closed, rtol=1e-9, atol=1e-10)


def test_carr_madan_digital_refusals_match_reference():
    prob = hh.PricingProblem(CASES["digital call"], _bs())
    odd = hh.CarrMadan(1.0, "auto", hh.LognormalDynamics(), nodes=255, engine="complex")
    with pytest.raises(ValueError, match="even node count"):
        hh.solve(prob, odd)
    with pytest.raises(ValueError, match="even node count"):
        ht.solve(ht.from_reference(prob),
                 ht.CarrMadan(1.0, "auto", ht.LognormalDynamics(), 255, device=CPU))
    barrier = ht.from_reference(hh.PricingProblem(CASES["down-in put"], _bs()))
    with pytest.raises(TypeError, match="path-independent"):
        ht.solve(barrier, ht.CarrMadan(1.0, 32.0, ht.LognormalDynamics(), device=CPU))
