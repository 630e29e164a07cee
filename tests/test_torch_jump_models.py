"""The jump and variance-gamma families' deterministic layers against the
JAX package on the CPU: the market inputs and their guards, the terminal
parameters, the complex128 CFs (Merton, Kou, variance gamma, the Bates jump
factor), ``terminal_log_cf`` under the four dynamics, the Carr–Madan auto
bound, Carr–Madan prices (panel and Gauss–Legendre, calls, puts, digitals)
and ``MertonAnalytic`` (vanilla, digital, strike grid, the truncation
guard), all to rel 1e-12; then the model checks of tests/unit/test_merton,
test_kou, test_variance_gamma and test_bates that need no Monte Carlo, on
the port alone (corners, parity, skews, dividend identities, CF greeks
against central differences)."""

import dataclasses
import datetime as dt
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import carr_madan as jcm
from hedgehog_tpu.models import dynamics as jdyn
from hedgehog_tpu_torch.methods import carr_madan as pcm
from hedgehog_tpu_torch.models import dynamics as pdyn

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CPU = "cpu"

MARKETS = {
    "merton": (hh.MertonInputs(REF, 0.03, 100.0, 0.2, 0.5, -0.1, 0.15, dividend_yield=0.01),
               hh.MertonJumpDynamics()),
    "kou": (hh.KouInputs(REF, 0.05, 100.0, 0.16, 1.0, 0.4, 10.0, 5.0, dividend_yield=0.02),
            hh.KouJumpDynamics()),
    "vg": (hh.VarianceGammaInputs(REF, 0.05, 100.0, 0.18, 0.25, -0.14), hh.VarianceGammaDynamics()),
    "kou on a curve": (hh.KouInputs(REF, hh.RateCurve(REF, jnp.array([0.5, 1.0, 2.0]),
                                                      jnp.array([0.02, 0.03, 0.035])),
                                    100.0, 0.16, 1.0, 0.4, 10.0, 5.0), hh.KouJumpDynamics()),
    "bates": (hh.BatesInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7, 0.5, -0.1, 0.15,
                             dividend_yield=0.01), hh.BatesDynamics()),
}
PARAMS = {"merton": (jdyn.merton_terminal_params, pdyn.merton_terminal_params),
          "kou": (jdyn.kou_terminal_params, pdyn.kou_terminal_params),
          "kou on a curve": (jdyn.kou_terminal_params, pdyn.kou_terminal_params),
          "vg": (jdyn.vg_terminal_params, pdyn.vg_terminal_params)}


def _opt(strike=100.0, cp=None, expiry=EXPIRY):
    return hh.VanillaOption(strike, expiry, hh.European(), cp or hh.Call(), hh.Spot())


def _port(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _both(jprob, jmethod):
    want = np.asarray(hh.solve(jprob, jmethod).price)
    got = ht.solve(ht.from_reference(jprob), _port(jmethod)).price.numpy()
    return got, want


# -- the reference's functions, 1e-12 ------------------------------------------------------


@pytest.mark.parametrize("family", sorted(PARAMS))
def test_terminal_params_match_reference(family):
    market, _ = MARKETS[family]
    want = PARAMS[family][0](market, ht.to_ticks(EXPIRY))
    got = PARAMS[family][1](ht.from_reference(market), ht.to_ticks(EXPIRY))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-14, abs=1e-16)


U = np.concatenate([np.linspace(-40.0, 40.0, 17) + 0.0j, np.linspace(-40.0, 40.0, 9) - 2.0j])


@pytest.mark.parametrize("family", sorted(MARKETS))
def test_terminal_log_cf_matches_reference(family):
    market, dyn = MARKETS[family]
    jprob = hh.PricingProblem(_opt(), market)
    want = np.asarray(jdyn.terminal_log_cf(jprob, dyn)(jnp.asarray(U)))
    got = pdyn.terminal_log_cf(ht.from_reference(jprob), ht.from_reference(dyn))(
        torch.tensor(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def test_cf_functions_match_reference():
    args = dict(merton=(4.6, 0.03, 1.0, 0.2, 0.5, -0.1, 0.15, math.expm1(-0.1 + 0.5 * 0.15**2)),
                kou=(4.6, 0.05, 1.0, 0.16, 1.0, 0.4, 10.0, 5.0, 0.02),
                vg=(4.6, 0.05, 1.0, 0.18, 0.25, -0.14, -0.01))
    for name in ("merton", "kou", "vg"):
        want = np.asarray(getattr(jdyn, f"{name}_cf")(jnp.asarray(U), *args[name]))
        got = getattr(pdyn, f"{name}_cf")(torch.tensor(U), *args[name]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
    want = np.asarray(jdyn.bates_jump_factor(jnp.asarray(U), 0.5, -0.1, 0.15, 1.0))
    got = pdyn.bates_jump_factor(torch.tensor(U), 0.5, -0.1, 0.15, 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


AUTO_CASES = {**{k: v for k, v in MARKETS.items()},
              "vg one week": (hh.VarianceGammaInputs(REF, 0.05, 100.0, 0.18, 0.25, -0.14),
                              hh.VarianceGammaDynamics()),
              "bates feller": (hh.BatesInputs(REF, 0.03, 100.0, 0.04, 1.0, 0.04, 1.0, -0.9, 0.3,
                                              -0.05, 0.1), hh.BatesDynamics())}


@pytest.mark.parametrize("name", sorted(AUTO_CASES))
def test_auto_bound_matches_reference(name):
    market, dyn = AUTO_CASES[name]
    expiry = dt.date(2024, 1, 8) if "week" in name else EXPIRY
    jprob = hh.PricingProblem(_opt(expiry=expiry), market)
    want = float(jcm._auto_bound(jprob, dyn))
    got = float(pcm._auto_bound(ht.from_reference(jprob), ht.from_reference(dyn), CPU))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("family,rule", [(f, "panel") for f in sorted(MARKETS)]
                         + [("merton", "gl"), ("bates", "gl")])
def test_carr_madan_matches_reference(family, rule):
    market, dyn = MARKETS[family]
    method = (hh.CarrMadan(1.0, "auto", dyn) if rule == "panel"
              else hh.CarrMadan(1.0, 64.0, dyn, nodes=512, quadrature="gl"))
    for payoff in (_opt(95.0), _opt(105.0, hh.Put()),
                   hh.DigitalOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())):
        got, want = _both(hh.PricingProblem(payoff, market), method)
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=type(payoff).__name__)


@pytest.mark.parametrize("payoff", [
    _opt(), _opt(90.0, hh.Put()),
    hh.DigitalOption(100.0, EXPIRY, hh.European(), hh.Put(), hh.Spot(), 2.0),
    hh.VanillaOption(np.array([80.0, 95.0, 100.0, 110.0, 130.0]), EXPIRY, hh.European(),
                     hh.Call(), hh.Spot()),
], ids=["call", "put", "digital put", "strike grid"])
def test_merton_analytic_matches_reference(payoff):
    got, want = _both(hh.PricingProblem(payoff, MARKETS["merton"][0]), hh.MertonAnalytic())
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_merton_series_guard_and_sized_series():
    hot = hh.MertonInputs(REF, 0.03, 100.0, 0.2, 25.0, -0.1, 0.15)
    jprob = hh.PricingProblem(_opt(), hot)
    with pytest.raises(ValueError, match="truncates"):
        ht.solve(ht.from_reference(jprob), ht.MertonAnalytic(device=CPU))
    got, want = _both(jprob, hh.MertonAnalytic(n_terms=120))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    cm = ht.solve(ht.from_reference(jprob), ht.CarrMadan(1.0, "auto", ht.MertonJumpDynamics(),
                                                          device=CPU)).price
    assert float(got) == pytest.approx(float(cm), rel=1e-6)
    am = ht.VanillaOption(100.0, EXPIRY, ht.American(), ht.Put(), ht.Spot())
    with pytest.raises(TypeError, match="European-only"):
        ht.solve(ht.PricingProblem(am, ht.from_reference(MARKETS["merton"][0])),
                 ht.MertonAnalytic(device=CPU))


def test_inputs_guards_and_carry_across():
    with pytest.raises(ValueError, match="eta_up must exceed 1"):
        ht.KouInputs(REF, 0.05, 100.0, 0.16, 1.0, 0.4, 0.9, 5.0)
    with pytest.raises(ValueError, match="finite forward"):
        ht.VarianceGammaInputs(REF, 0.05, 100.0, 0.5, 2.0, 0.5)
    # tensors are not read back for the construction-time guards
    ht.KouInputs(REF, 0.05, 100.0, 0.16, 1.0, 0.4, torch.tensor(0.9), 5.0)
    curve = ht.RateCurve(REF, np.array([0.5, 1.0, 2.0]), np.array([0.02, 0.03, 0.035]))
    ht.MertonInputs(REF, curve, 100.0, 0.2, 0.5, -0.1, 0.15)
    with pytest.raises(TypeError, match="one short rate"):
        ht.BatesInputs(REF, curve, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7, 0.5, -0.1, 0.15)
    for market, dyn in MARKETS.values():
        port = ht.from_reference(market)
        assert type(port).__name__ == type(market).__name__
        assert type(ht.from_reference(dyn)).__name__ == type(dyn).__name__
    for strat in (hh.MertonExact(), hh.KouExact(), hh.VarianceGammaExact()):
        assert type(ht.from_reference(strat)).__name__ == type(strat).__name__


# -- model checks on the port alone (tests/unit/test_merton.py and kin) --------------------


def _p(payoff, market, method) -> float:
    return float(ht.solve(ht.PricingProblem(payoff, market), method).price)


def _cm(dyn):
    return ht.CarrMadan(1.0, "auto", dyn, device=CPU)


def _popt(strike=100.0, cp=None):
    return ht.VanillaOption(strike, EXPIRY, ht.European(), cp or ht.Call(), ht.Spot())


def test_merton_corners_and_parity():
    m = ht.MertonInputs(REF, 0.03, 100.0, 0.2, 0.5, -0.1, 0.15)
    series = ht.MertonAnalytic(device=CPU)
    assert _p(_popt(), m, series) == pytest.approx(_p(_popt(), m, _cm(ht.MertonJumpDynamics())),
                                                   abs=1e-6)
    m0 = dataclasses.replace(m, jump_intensity=0.0)
    bs = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
    assert _p(_popt(), m0, series) == pytest.approx(
        _p(_popt(), bs, ht.BlackScholesAnalytic(device=CPU)), abs=1e-6)
    T = 365 / 365
    parity = _p(_popt(), m, series) - _p(_popt(cp=ht.Put()), m, series)
    assert parity == pytest.approx(100.0 - 100.0 * math.exp(-0.03 * T), abs=1e-10)
    dig = ht.DigitalOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot(), 1.0)
    assert _p(dig, m, _cm(ht.MertonJumpDynamics())) == pytest.approx(_p(dig, m, series),
                                                                      abs=2e-6)


def test_kou_corner_skew_and_dividend_identity():
    def kou(**kw):
        kw = {"jump_intensity": 1.0, "p_up": 0.4, "eta_up": 10.0, "eta_down": 5.0, **kw}
        return ht.KouInputs(REF, 0.05, 100.0, 0.16, **kw)

    cm = _cm(ht.KouJumpDynamics())
    bs = _p(_popt(), ht.BlackScholesInputs(REF, 0.05, 100.0, 0.16),
            ht.BlackScholesAnalytic(device=CPU))
    assert _p(_popt(), kou(jump_intensity=0.0), cm) == pytest.approx(bs, abs=1e-6)
    assert _p(_popt(), kou(), cm) > bs
    put = _popt(90.0, ht.Put())
    assert _p(put, kou(p_up=0.2), cm) > _p(put, kou(p_up=0.8), cm) + 0.5
    shifted = ht.KouInputs(REF, 0.05, 100.0 * math.exp(-0.03), 0.16, 1.0, 0.4, 10.0, 5.0)
    assert _p(_popt(), kou(dividend_yield=0.03), cm) == pytest.approx(_p(_popt(), shifted, cm),
                                                                       abs=1e-10)


def test_vg_skew_and_dividend_identity():
    cm = _cm(ht.VarianceGammaDynamics())

    def vg(**kw):
        return ht.VarianceGammaInputs(REF, 0.05, kw.pop("spot", 100.0), 0.18,
                                      **{"nu": 0.25, "theta": -0.14, **kw})

    put = _popt(90.0, ht.Put())
    assert _p(put, vg(theta=-0.14), cm) > _p(put, vg(theta=0.14), cm) + 0.3
    assert _p(_popt(), vg(dividend_yield=0.03), cm) == pytest.approx(
        _p(_popt(), vg(spot=100.0 * math.exp(-0.03)), cm), abs=1e-9)


def test_bates_corners_and_dividend_identity():
    cm = _cm(ht.BatesDynamics())

    def bates(**kw):
        kw = {"jump_intensity": 0.5, "jump_mean": -0.1, "jump_std": 0.15, **kw}
        return ht.BatesInputs(REF, 0.05, kw.pop("spot", 100.0), 0.04, 2.0, 0.04, 0.3, -0.7, **kw)

    heston = ht.HestonInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    ph = _p(_popt(), heston, _cm(ht.HestonDynamics()))
    assert _p(_popt(), bates(jump_intensity=0.0), cm) == pytest.approx(ph, abs=1e-9)
    assert _p(_popt(), bates(), cm) > ph
    bm = ht.BatesInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.01, 0.0, 0.5, -0.1, 0.15)
    mm = ht.MertonInputs(REF, 0.05, 100.0, 0.2, 0.5, -0.1, 0.15)
    assert _p(_popt(), bm, cm) == pytest.approx(_p(_popt(), mm, ht.MertonAnalytic(device=CPU)),
                                                rel=1e-4)
    assert _p(_popt(), bates(dividend_yield=0.03), cm) == pytest.approx(
        _p(_popt(), bates(spot=100.0 * math.exp(-0.03)), cm), abs=1e-9)


@pytest.mark.parametrize("family,fields", [
    ("kou", ("jump_intensity", "p_up", "eta_up", "eta_down")),
    ("vg", ("sigma", "nu", "theta")),
    ("merton", ("jump_intensity", "jump_mean", "jump_std")),
])
def test_cf_greeks_match_central_differences(family, fields):
    """Carr–Madan is smooth in every jump parameter: autograd against central
    differences at rel 1e-4 (test_kou.py / test_variance_gamma.py)."""
    market = ht.from_reference(MARKETS[family][0])
    cm = _cm(ht.from_reference(MARKETS[family][1]))
    for field in fields:
        x0 = float(getattr(market, field))
        x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
        price = ht.solve(ht.PricingProblem(_popt(), dataclasses.replace(market, **{field: x})),
                         cm).price
        (g,) = torch.autograd.grad(price, x)
        h = 1e-5 * max(1.0, abs(x0))
        up, dn = (_p(_popt(), dataclasses.replace(market, **{field: x0 + s}), cm)
                  for s in (h, -h))
        assert float(g) == pytest.approx((up - dn) / (2 * h), rel=1e-4), field
