"""The Hull-White closed forms and x-grid of the port (models/hull_white.py,
``HullWhiteAnalytic`` and ``HullWhiteGrid`` of methods/hull_white.py) against
the JAX package on the CPU.

The model's blocks, zero-coupon bonds, bond options, caplets, caps and
Jamshidian swaptions agree with JAX's to 1e-12 (the greeks:
tests/test_torch_hull_white_greeks.py).  Then the JAX suite's identities on
the port (tests/unit/test_hull_white.py):
the curve fit, bond and FRA parity, the σ = 0 intrinsic with a finite
gradient, the cap strip, and the guards with JAX's exception types."""

import dataclasses
import datetime as dt

import jax
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.models import hull_white as jhw
from hedgehog_tpu_torch.models import hull_white as phw

REF = dt.date(2024, 1, 1)
CPU = "cpu"
RTOL = 1e-12
GRAD_RTOL = 1e-8
SWAP_DATES = [dt.date(2026, 1, 1), dt.date(2027, 1, 1), dt.date(2028, 1, 1)]
TENORS = np.array([0.5, 1.0, 2.0, 3.0, 5.0])
ZEROS = np.array([0.02, 0.025, 0.03, 0.032, 0.035])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcurve():
    return hh.RateCurve.from_dfs(REF, TENORS, np.exp(-ZEROS * TENORS))


def _jmarket(a=0.1, sigma=0.012):
    return hh.HullWhiteInputs(REF, _jcurve(), a, sigma)


def _pmarket(a=0.1, sigma=0.012):
    return ht.HullWhiteInputs(REF, ht.RateCurve.from_dfs(REF, TENORS, np.exp(-ZEROS * TENORS)),
                              a, sigma)


def _cpu(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _jprice(payoff, method, market=None):
    """JAX's price, jitted (one compile instead of the eager per-operation
    ones)."""
    prob = hh.PricingProblem(payoff, market or _jmarket())
    return float(jax.jit(lambda: hh.solve(prob, method).price)())


def _pprice(payoff, method, market=None):
    prob = ht.PricingProblem(ht.from_reference(payoff), market or _pmarket())
    return float(ht.solve(prob, _cpu(method)).price)


def _berm(payer=True):
    return hh.Swaption(0.032, dt.date(2025, 1, 1), SWAP_DATES, payer=payer, notional=100.0,
                       exercise_style=hh.Bermudan([dt.date(2026, 1, 1), dt.date(2027, 1, 1)]))


def _payoffs():
    e, b = dt.date(2025, 1, 1), dt.date(2028, 1, 1)
    strip = [dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2025, 7, 1), dt.date(2026, 1, 1)]
    return {
        "zcb": hh.ZeroCouponBond(dt.date(2027, 1, 1)),
        "bond call": hh.BondOption(0.92, e, b, call_put=hh.Call()),
        "bond put": hh.BondOption(0.92, e, b, call_put=hh.Put()),
        "caplet": hh.Caplet(0.03, e, dt.date(2025, 7, 1), notional=100.0),
        "floorlet": hh.Caplet(0.03, e, dt.date(2025, 7, 1), notional=100.0, call_put=hh.Put()),
        "cap": hh.CapFloor(0.03, strip, notional=100.0),
        "floor": hh.CapFloor(0.03, strip, notional=100.0, call_put=hh.Put()),
        "spot-start cap": hh.CapFloor(0.03, [REF, dt.date(2024, 7, 1), dt.date(2025, 1, 1)],
                                      notional=100.0),
        "payer": hh.Swaption(0.032, e, SWAP_DATES, payer=True, notional=100.0),
        "receiver": hh.Swaption(0.032, e, SWAP_DATES, payer=False, notional=100.0),
    }


def test_model_blocks_match_reference():
    a, sig = 0.1, 0.012
    tau = np.array([0.0, 0.25, 1.0, 4.5])
    pairs = [(jhw.hw_b(a, tau), phw.hw_b(a, tau)),
             (jhw.hw_v(a, sig, tau), phw.hw_v(a, sig, tau)),
             (jhw.hw_gamma(a, tau), phw.hw_gamma(a, tau)),
             (jhw.hw_bond(0.97, 0.9, a, sig, 1.0, 3.0, np.array([-0.02, 0.0, 0.03])),
              phw.hw_bond(0.97, 0.9, a, sig, 1.0, 3.0, np.array([-0.02, 0.0, 0.03]))),
             (jhw.hw_sigma_p(a, sig, 1.0, tau[1:] + 1.0), phw.hw_sigma_p(a, sig, 1.0, tau[1:] + 1.0))]
    pairs += list(zip(jhw.hw_step_moments(a, sig, 0.25), phw.hw_step_moments(a, sig, 0.25)))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("name", list(_payoffs()))
def test_closed_forms_match_reference(name):
    payoff = _payoffs()[name]
    want = _jprice(payoff, hh.HullWhiteAnalytic())
    got = _pprice(payoff, hh.HullWhiteAnalytic())
    assert got == pytest.approx(want, rel=RTOL, abs=1e-15)


def test_hw_zbo_price_export_matches_reference():
    strikes = np.array([0.85, 0.9, 0.95])
    for cp in (1.0, -1.0):
        want = hh.hw_zbo_price(_jmarket(), 1.0, np.array([2.0, 3.0, 4.0]), strikes, cp)
        got = ht.hw_zbo_price(_pmarket(), 1.0, np.array([2.0, 3.0, 4.0]), strikes, cp)
        # a put 30 σ out of the money is 0 to cancellation (JAX: 3.6e-35)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-15)


def test_curve_fit_and_parities():
    """The fit identity, bond put-call parity, FRA parity on the caplet and
    the cap strip, and the payer-receiver forward swap
    (test_hull_white.py:37, :59, :80, :120, :276)."""
    m = _pmarket()
    dfy = lambda t: float(ht.df_yf(m.rate, t))  # noqa: E731
    yf = lambda d: ht.yearfrac(REF, d)  # noqa: E731
    p = {name: _pprice(po, hh.HullWhiteAnalytic()) for name, po in _payoffs().items()}
    assert p["zcb"] == pytest.approx(dfy(yf(dt.date(2027, 1, 1))), rel=1e-14)
    t_e, t_b = yf(dt.date(2025, 1, 1)), yf(dt.date(2028, 1, 1))
    assert p["bond call"] - p["bond put"] == pytest.approx(dfy(t_b) - 0.92 * dfy(t_e), abs=1e-12)

    def fra(start, end):
        t1, t2 = yf(start), yf(end)
        tau = t2 - t1
        return 100.0 * tau * ((dfy(t1) / dfy(t2) - 1.0) / tau - 0.03) * dfy(t2)

    assert p["caplet"] - p["floorlet"] == pytest.approx(
        fra(dt.date(2025, 1, 1), dt.date(2025, 7, 1)), abs=1e-10)
    cap = ht.from_reference(_payoffs()["cap"])
    assert p["cap"] == pytest.approx(sum(_pprice(c, hh.HullWhiteAnalytic())
                                         for c in cap.caplets()), rel=1e-14)
    assert p["cap"] - p["floor"] == pytest.approx(
        sum(fra(ht.ticks_to_datetime(c.start), ht.ticks_to_datetime(c.end))
            for c in cap.caplets()), abs=1e-10)
    times = [yf(d) for d in SWAP_DATES]
    c = 0.032 * np.diff([t_e] + times)
    c[-1] += 1.0
    fwd = 100.0 * (dfy(t_e) - sum(ci * dfy(ti) for ci, ti in zip(c, times)))
    assert p["payer"] - p["receiver"] == pytest.approx(fwd, abs=1e-9)


def test_sigma_zero_is_discounted_intrinsic_with_finite_gradient():
    """σ = 0 takes the intrinsic branch (test_hull_white.py:77), and the
    double where keeps autograd in σ finite there."""
    bo = hh.BondOption(0.90, dt.date(2025, 1, 1), dt.date(2028, 1, 1))
    got = _pprice(bo, hh.HullWhiteAnalytic(), _pmarket(sigma=0.0))
    assert got == pytest.approx(_jprice(bo, hh.HullWhiteAnalytic(), _jmarket(sigma=0.0)),
                                abs=1e-14)
    m = _pmarket()
    intrinsic = max(float(ht.df_yf(m.rate, 4.0)) - 0.90 * float(ht.df_yf(m.rate, 1.0)), 0.0)
    assert got == pytest.approx(intrinsic, abs=1e-12)
    sig = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    price = ht.solve(ht.PricingProblem(ht.from_reference(bo), _pmarket(sigma=sig)),
                     ht.HullWhiteAnalytic(device=CPU)).price
    (g,) = torch.autograd.grad(price, sig)
    assert torch.isfinite(g)


def test_payoff_validation_and_guards():
    """test_hull_white.py:221 and :290, with JAX's exception types."""
    m = _pmarket()
    with pytest.raises(ValueError, match="bond_maturity"):
        ht.BondOption(0.9, dt.date(2026, 1, 1), dt.date(2025, 1, 1))
    with pytest.raises(ValueError, match="increasing"):
        ht.Swaption(0.03, dt.date(2025, 1, 1), [dt.date(2027, 1, 1), dt.date(2026, 1, 1)])
    with pytest.raises(ValueError, match="increasing"):
        ht.CapFloor(0.03, [dt.date(2025, 1, 1), dt.date(2024, 7, 1)])
    with pytest.raises(ValueError, match="caplet end"):
        ht.Caplet(0.03, dt.date(2025, 1, 1), dt.date(2025, 1, 1))
    with pytest.raises(ValueError, match="reset dates"):
        ht.Swaption(0.03, dt.date(2025, 1, 1), SWAP_DATES,
                    exercise_style=ht.Bermudan([dt.date(2026, 6, 1)]))
    with pytest.raises(TypeError, match="European or Bermudan"):
        ht.Swaption(0.03, dt.date(2025, 1, 1), SWAP_DATES, exercise_style=ht.American())
    with pytest.raises(ValueError, match="mean reversion"):
        ht.HullWhiteInputs(REF, 0.03, 0.0, 0.01)
    with pytest.raises(ValueError, match="must be > 0"):
        ht.HestonHullWhiteInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.6, -0.1, 0.01)
    analytic = ht.HullWhiteAnalytic(device=CPU)
    with pytest.raises(TypeError, match="interest-rate payoff"):
        ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2025, 1, 1)), m), analytic)
    with pytest.raises(TypeError, match="HullWhiteInputs"):
        ht.solve(ht.PricingProblem(ht.ZeroCouponBond(dt.date(2025, 1, 1)),
                                   ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)), analytic)
    with pytest.raises(TypeError, match="HullWhiteGrid"):
        ht.solve(ht.PricingProblem(ht.from_reference(_berm()), m), analytic)
    with pytest.raises(TypeError, match="Swaption"):
        ht.solve(ht.PricingProblem(ht.ZeroCouponBond(dt.date(2025, 1, 1)), m),
                 ht.HullWhiteGrid(device=CPU))
    # the same refusals in the JAX package
    with pytest.raises(TypeError, match="HullWhiteGrid"):
        hh.solve(hh.PricingProblem(_berm(), _jmarket()), hh.HullWhiteAnalytic())
