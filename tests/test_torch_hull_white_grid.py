"""The Hull-White x-grid of the port (``HullWhiteGrid`` of
methods/hull_white.py) against the JAX package on the CPU.

The grid's European corner and its Bermudan agree with JAX's to 1e-12 and
the corner with Jamshidian to 2e-4 (tests/unit/test_hull_white.py:247); the
Bermudan grid vega agrees with ``jax.grad`` to 1e-8; the Bermudan dominates
its single-date Europeans and converges in the node count (:260)."""

import dataclasses
import datetime as dt
import functools

import jax
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

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
    return float(hh.solve(hh.PricingProblem(payoff, market or _jmarket()), method).price)


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


@functools.lru_cache(maxsize=None)
def _jax_value_and_vega(payer: bool, bermudan: bool):
    """JAX's grid price and dσ of a swaption, one jitted ``value_and_grad``
    (one compile instead of the eager per-operation ones)."""
    payoff = _berm(payer) if bermudan else _payoffs()["payer" if payer else "receiver"]

    def px(sig):
        return hh.solve(hh.PricingProblem(payoff, _jmarket(sigma=sig)), hh.HullWhiteGrid()).price

    value, vega = jax.jit(jax.value_and_grad(px))(0.012)
    return payoff, float(value), float(vega)


def _port_value_and_vega(payoff):
    sig = torch.tensor(0.012, dtype=torch.float64, requires_grad=True)
    price = ht.solve(ht.PricingProblem(ht.from_reference(payoff), _pmarket(sigma=sig)),
                     ht.HullWhiteGrid(device=CPU)).price
    (vega,) = torch.autograd.grad(price, sig)
    return float(price), float(vega)


@pytest.mark.parametrize("payer", [True, False])
def test_grid_matches_reference_and_jamshidian(payer):
    for bermudan in (False, True):
        payoff, want, _ = _jax_value_and_vega(payer, bermudan)
        assert _pprice(payoff, hh.HullWhiteGrid()) == pytest.approx(want, rel=RTOL)
    # the European corner against Jamshidian (test_hull_white.py:247)
    european = _payoffs()["payer" if payer else "receiver"]
    assert _pprice(european, hh.HullWhiteGrid()) == pytest.approx(
        _pprice(european, hh.HullWhiteAnalytic()), rel=2e-4)


@pytest.mark.parametrize("bermudan", [False, True])
def test_grid_vega_matches_jax(bermudan):
    """The vega through the whole backward induction (kernel matrices and
    exercise maxima) against ``jax.grad``, and central differences as
    test_hull_white.py:323."""
    payoff, _, want = _jax_value_and_vega(True, bermudan)
    price, vega = _port_value_and_vega(payoff)
    assert vega == pytest.approx(want, rel=GRAD_RTOL)
    if bermudan:
        eps = 1e-5
        up, dn = (_pprice(payoff, hh.HullWhiteGrid(), _pmarket(sigma=0.012 + d))
                  for d in (eps, -eps))
        assert vega == pytest.approx((up - dn) / (2 * eps), rel=1e-6)


def test_bermudan_dominates_europeans_and_converges():
    """test_hull_white.py:260: Bermudan ≥ every single-date European, ≤ their
    sum, and 257 nodes within 3e-4 of 513."""
    pb = _pprice(_berm(), hh.HullWhiteGrid())
    singles = [_pprice(hh.Swaption(0.032, d0, rem, payer=True, notional=100.0),
                       hh.HullWhiteAnalytic())
               for d0, rem in [(dt.date(2025, 1, 1), SWAP_DATES),
                               (dt.date(2026, 1, 1), SWAP_DATES[1:]),
                               (dt.date(2027, 1, 1), SWAP_DATES[2:])]]
    assert max(singles) - 1e-8 <= pb <= sum(singles) + 1e-8
    assert pb == pytest.approx(_pprice(_berm(), hh.HullWhiteGrid(nodes=513)), rel=3e-4)
