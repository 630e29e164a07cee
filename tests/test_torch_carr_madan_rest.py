"""The rest of Carr–Madan in the port: the single Gauss–Legendre rule
(``quadrature="gl"``), the engine field, ``carr_madan_fft_smile`` and
``carr_madan_error_estimate``, against the JAX package on the CPU (1e-12)
and in the cases of tests/unit/test_carr_madan_quadrature.py (:74 the
legacy rule, :104 and :148 the error estimate, :191 the FFT smile) and
tests/unit/test_round3_fixes.py:134-136 (the Gauss–Legendre rule refuses
the auto bound)."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import carr_madan as jcm
from hedgehog_tpu_torch.methods import carr_madan as pcm

REF = dt.date(2024, 1, 1)
CPU = "cpu"


def _expiry(days):
    return REF + dt.timedelta(days=days)


def _bs_prob(days, sigma, strike, ns=ht):
    return ns.PricingProblem(ns.VanillaOption(strike, _expiry(days), ns.European(), ns.Call(),
                                              ns.Spot()),
                             ns.BlackScholesInputs(REF, 0.03, 100.0, sigma))


def _cm(*args, **kw):
    return ht.CarrMadan(*args, device=CPU, **kw)


def _bs(prob) -> float:
    return float(ht.solve(prob, ht.BlackScholesAnalytic(device=CPU)).price)


def test_legacy_gl_rule():
    prob = _bs_prob(365, 0.4, 100.0)
    cm = float(ht.solve(prob, _cm(1.0, 16.0, ht.LognormalDynamics(), quadrature="gl")).price)
    assert cm == pytest.approx(_bs(prob), abs=1e-6)
    with pytest.raises(ValueError, match="quadrature"):
        ht.solve(prob, _cm(1.0, 32.0, ht.LognormalDynamics(), quadrature="nope"))


def test_gl_refuses_the_auto_bound():
    prob = _bs_prob(366, 0.2, 100.0)
    with pytest.raises(ValueError, match="panel"):
        ht.solve(prob, _cm(1.0, "auto", ht.LognormalDynamics(), quadrature="gl"))
    p = float(ht.solve(prob, _cm(1.0, 64.0, ht.LognormalDynamics(), quadrature="gl")).price)
    assert p == pytest.approx(_bs(prob), rel=1e-2)


@pytest.mark.parametrize("bound,nodes", [(16.0, 256), (200.0, 512)])
def test_gl_rule_matches_reference(bound, nodes):
    jprob = _bs_prob(180, 0.3, 95.0, ns=hh)
    method = hh.CarrMadan(1.0, bound, hh.LognormalDynamics(), nodes=nodes, quadrature="gl")
    want = float(hh.solve(jprob, method).price)
    got = float(ht.solve(ht.from_reference(jprob),
                         dataclasses.replace(ht.from_reference(method), device=CPU)).price)
    assert got == pytest.approx(want, rel=1e-12)


def test_engine_field():
    prob = _bs_prob(365, 0.2, 100.0)
    prices = {e: float(ht.solve(prob, _cm(1.0, "auto", ht.LognormalDynamics(), engine=e)).price)
              for e in ("auto", "complex")}
    assert prices["auto"] == prices["complex"]
    with pytest.raises(TypeError, match="complex128"):
        _cm(1.0, "auto", ht.LognormalDynamics(), engine="pair")
    with pytest.raises(TypeError, match="engine='pair'"):
        ht.from_reference(hh.CarrMadan(engine="pair"))
    port = ht.from_reference(hh.CarrMadan(1.0, 32.0, hh.HestonDynamics(), 128, engine="complex",
                                          quadrature="gl"))
    assert (port.engine, port.quadrature, port.nodes, port.bound) == ("complex", "gl", 128, 32.0)


def test_error_estimate_flags_bad_config_and_passes_good():
    prob = _bs_prob(7, 0.05, 100.0)
    bad = ht.carr_madan_error_estimate(prob, _cm(1.0, 32.0, ht.LognormalDynamics()))
    good = ht.carr_madan_error_estimate(prob, _cm(1.0, "auto", ht.LognormalDynamics()))
    true_err = abs(float(ht.solve(prob, _cm(1.0, 32.0, ht.LognormalDynamics())).price) - _bs(prob))
    assert bad["total"] > 0.1 * true_err > 0.0
    assert good["total"] < 1e-8


def test_error_estimate_array_strikes():
    prob = ht.PricingProblem(
        ht.VanillaOption(np.array([90.0, 100.0, 110.0]), _expiry(365), ht.European(), ht.Call(),
                         ht.Spot()),
        ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2))
    est = ht.carr_madan_error_estimate(prob, _cm(1.0, "auto", ht.LognormalDynamics()))
    assert tuple(est["price"].shape) == (3,)
    assert est["total"] < 1e-8


def test_error_estimate_matches_reference():
    market = hh.MertonInputs(REF, 0.03, 100.0, 0.2, 0.5, -0.1, 0.15)
    jprob = hh.PricingProblem(hh.VanillaOption(105.0, _expiry(30), hh.European(), hh.Call(),
                                               hh.Spot()), market)
    method = hh.CarrMadan(1.0, "auto", hh.MertonJumpDynamics())
    want = jcm.carr_madan_error_estimate(jprob, method)
    got = pcm.carr_madan_error_estimate(ht.from_reference(jprob),
                                        dataclasses.replace(ht.from_reference(method), device=CPU))
    assert float(got["price"]) == pytest.approx(float(want["price"]), rel=1e-12)
    for key in ("refinement", "tail", "total"):
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-13), key


def test_auto_bound_rejects_unknown_dynamics():
    class Mystery:
        pass

    with pytest.raises(TypeError, match="auto"):
        ht.solve(_bs_prob(30, 0.2, 100.0), _cm(1.0, "auto", Mystery()))


FFT_CASES = {
    "black-scholes": (hh.BlackScholesInputs(REF, 0.03, 100.0, 0.2), hh.LognormalDynamics()),
    "heston": (hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7), hh.HestonDynamics()),
    "variance gamma": (hh.VarianceGammaInputs(REF, 0.03, 100.0, 0.18, 0.25, -0.14),
                       hh.VarianceGammaDynamics()),
}


@pytest.mark.parametrize("name", sorted(FFT_CASES))
def test_fft_smile_matches_reference_and_panel_engine(name):
    """One FFT prices the log-strike grid: equal to JAX's smile within 1e-12
    at every strike K ≥ 1, and to the per-strike panel engine (1e-8).  The
    two packages' FFTs (torch's and XLA's) differ by ~1e-13 in the raw
    transform; below K = 1 (k < 0) the damping e^{−αk} amplifies that to
    ~1e-6 on a ~100 call at K = e^{−10}, in both packages alike."""
    market, dyn = FFT_CASES[name]
    jprob = hh.PricingProblem(hh.VanillaOption(100.0, _expiry(365), hh.European(), hh.Call(),
                                               hh.Spot()), market)
    jk, jc = (np.asarray(x) for x in jcm.carr_madan_fft_smile(jprob, dyn, n=8192))
    pk, pc = pcm.carr_madan_fft_smile(ht.from_reference(jprob), ht.from_reference(dyn), n=8192,
                                      device=CPU)
    np.testing.assert_allclose(pk.numpy(), jk, rtol=1e-14)
    undamped = jk >= 1.0
    np.testing.assert_allclose(pc.numpy()[undamped], jc[undamped], rtol=0.0, atol=1e-12)
    Ks, calls = pcm.carr_madan_fft_smile(ht.from_reference(jprob), ht.from_reference(dyn),
                                         device=CPU)
    Ks, calls = Ks.numpy(), calls.numpy()
    idx = np.where((Ks > 60) & (Ks < 170))[0][::37]
    assert len(idx) >= 3
    strikes = torch.tensor(Ks[idx])
    port_market = ht.from_reference(market)
    panel = ht.solve(ht.PricingProblem(ht.VanillaOption(strikes, _expiry(365), ht.European(),
                                                        ht.Call(), ht.Spot()), port_market),
                     _cm(1.0, "auto", ht.from_reference(dyn))).price.numpy()
    np.testing.assert_allclose(calls[idx], panel, atol=1e-8)
