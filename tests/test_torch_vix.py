"""VIX futures and options in the port (methods/vix.py) against the JAX
package on the CPU.

At small quadrature sizes (16 nodes × 128 series terms, the same arguments
on both sides; the window covers λ ≤ 164 and these markets' λ is about
0.5) futures, calls and puts under Heston and Bates agree with JAX's to
1e-12, on both sides of the series/Edgeworth switch, and ``vix_params`` too;
the greeks are in tests/test_torch_vix_oracles.py, with the oracles of
tests/unit/test_vix.py on the port alone."""

import datetime as dt
import math

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import vix as jvix
from hedgehog_tpu_torch.methods import vix as pvix

REF = dt.date(2025, 1, 1)
EXPIRY = dt.date(2025, 7, 1)
R = 0.03
CPU = "cpu"
RTOL = 1e-12
ATOL = 1e-12 * 20.0  # a put far out of the money is call + K − F: 1e-12 of the index level
SMALL = dict(nodes=16, terms=128)
TAU = 30.0 / 365.0
JUMPS = (0.3, -0.1, 0.15)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _market(mod, sigma_v=0.6, kappa=2.0, theta=0.05, v0=0.04, rho=-0.7, jumps=None):
    if jumps is not None:
        return mod.BatesInputs(REF, R, 100.0, v0, kappa, theta, sigma_v, rho, *jumps)
    return mod.HestonInputs(REF, R, 100.0, v0, kappa, theta, sigma_v, rho)


def _pprice(payoff, market, **kw):
    return ht.solve(ht.PricingProblem(ht.from_reference(payoff), market),
                    ht.VIXAnalytic(**{**SMALL, **kw}, device=CPU)).price


STRIKES = (15.0, 20.0, 25.0)
P0 = np.array([0.04, 2.0, 0.05, 0.6, -0.7])  # V0, κ, θ, σ, ρ


def _payoffs(mod):
    """The future, then calls and puts at ``STRIKES``."""
    return ([mod.VIXFuture(EXPIRY)] + [mod.VIXOption(K, EXPIRY) for K in STRIKES]
            + [mod.VIXOption(K, EXPIRY, call_put=mod.Put()) for K in STRIKES])


def _jax_price(payoff, x, bates=False):
    """JAX's ``solve`` price on the market of parameters x (eager: its
    operations compile once per shape and serve every later call)."""
    m = _market(hh, *[x[i] for i in (3, 1, 2, 0, 4)], jumps=JUMPS if bates else None)
    return hh.solve(hh.PricingProblem(payoff, m), hh.VIXAnalytic(**SMALL)).price


def _jax_prices(x, bates=False):
    return np.array([float(_jax_price(p, x, bates)) for p in _payoffs(hh)])


def _port_prices(market):
    return torch.stack([_pprice(p, market) for p in _payoffs(hh)])


@pytest.mark.parametrize("bates", [False, True], ids=["heston", "bates"])
def test_prices_match_reference(bates):
    want = _jax_prices(P0, bates)
    got = _port_prices(_market(ht, jumps=JUMPS if bates else None))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_vix_params_match_reference():
    T = float(hh.yearfrac(REF, EXPIRY))
    for jumps in (None, JUMPS):
        want = jvix.vix_params(_market(hh, jumps=jumps), T, TAU)
        got = pvix.vix_params(_market(ht, jumps=jumps), T, TAU)
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=RTOL)


def _lam(sigma_v):
    return float(pvix.vix_params(_market(ht, sigma_v=sigma_v), hh.yearfrac(REF, EXPIRY), TAU)[4])


@pytest.mark.parametrize("side", [0.8, 1.25], ids=["series", "edgeworth"])
def test_both_branches_match_reference(side):
    """σ_v chosen so that λ sits at 0.8 and 1.25 times the 128-term window's
    switch point 1.96·(128/14)²: the series and the Edgeworth tail."""
    lam_max = 1.96 * (SMALL["terms"] / 14.0) ** 2
    sigma_v = 0.6 * math.sqrt(_lam(0.6) / (side * lam_max))
    assert _lam(sigma_v) == pytest.approx(side * lam_max, rel=1e-9)
    x = P0.copy()
    x[3] = sigma_v
    np.testing.assert_allclose(_port_prices(_market(ht, sigma_v=sigma_v)).numpy(),
                               _jax_prices(x), rtol=RTOL, atol=ATOL)
