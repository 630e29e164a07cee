"""The barrier and knock-in CRR lattices against the JAX package on the CPU.

Every barrier lattice (knock-out with bridge-corrected edges, European
knock-in by parity, American and Bermudan knock-in by the hit-time
quadrature; rebates at the hit and at expiry; a root already knocked)
agrees with JAX's to rtol 1e-12 at 300 steps.  The cases of
tests/unit/test_barrier_crr.py and tests/unit/test_american_knock_in.py
run on the port, with the dispatch's guards."""

import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)  # 365 days: T = 1 under ACT/365
CPU = "cpu"
QUARTERS = (dt.date(2024, 4, 1), dt.date(2024, 7, 1), dt.date(2024, 10, 1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _crr(steps):
    return ht.CoxRossRubinsteinMethod(steps, device=CPU)


def _market(lib=ht, sigma=0.25, rate=0.05, spot=100.0, q=0.0):
    return lib.BlackScholesInputs(REF, rate, spot, sigma, dividend_yield=q)


def _barrier(style=None, lib=ht, **kw):
    kw.setdefault("strike", 100.0)
    kw.setdefault("expiry", EXPIRY)
    return lib.BarrierOption(exercise_style=style if style is not None else lib.European(), **kw)


def _price(payoff, steps=1000, market=None) -> float:
    return float(ht.solve(ht.PricingProblem(payoff, market or _market()), _crr(steps)).price)


# -- every lattice against JAX's ----------------------------------------------------------

LATTICES = {
    "eu up-out call": dict(barrier=120.0, direction=hh.Up(), knock=hh.KnockOut()),
    "eu down-out put, rebate at hit": dict(barrier=80.0, direction=hh.Down(),
                                           knock=hh.KnockOut(), call_put=hh.Put(),
                                           rebate=2.0, rebate_at_hit=True),
    "am down-out put": dict(style="am", strike=110.0, barrier=80.0, direction=hh.Down(),
                            knock=hh.KnockOut(), call_put=hh.Put()),
    "am up-out call, rebate at hit": dict(style="am", barrier=120.0, direction=hh.Up(),
                                          knock=hh.KnockOut(), rebate=3.0, rebate_at_hit=True),
    "am up-out call, rebate at expiry": dict(style="am", barrier=120.0, direction=hh.Up(),
                                             knock=hh.KnockOut(), rebate=30.0),
    "bermudan up-out call, rebate": dict(style="berm", barrier=120.0, direction=hh.Up(),
                                         knock=hh.KnockOut(), rebate=3.0),
    "am down-out put, knocked root": dict(style="am", strike=110.0, barrier=105.0,
                                          direction=hh.Down(), knock=hh.KnockOut(),
                                          call_put=hh.Put(), rebate=4.0),
    "eu up-in call, rebate": dict(barrier=120.0, direction=hh.Up(), knock=hh.KnockIn(),
                                  rebate=2.5),
    "eu down-in put": dict(barrier=80.0, direction=hh.Down(), knock=hh.KnockIn(),
                           call_put=hh.Put()),
    "am down-in put, rebate": dict(style="am", strike=110.0, barrier=85.0, direction=hh.Down(),
                                   knock=hh.KnockIn(), call_put=hh.Put(), rebate=2.0),
    "am down-in call (OTM barrier)": dict(style="am", barrier=80.0, direction=hh.Down(),
                                          knock=hh.KnockIn()),
    "bermudan down-in put": dict(style="berm", strike=110.0, barrier=85.0, direction=hh.Down(),
                                 knock=hh.KnockIn(), call_put=hh.Put()),
    "am up-in put, knocked root": dict(style="am", strike=110.0, barrier=100.0,
                                       direction=hh.Up(), knock=hh.KnockIn(),
                                       call_put=hh.Put()),
}


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_lattice_matches_reference(name):
    kw = dict(LATTICES[name])
    style = {"am": hh.American(), "berm": hh.Bermudan(QUARTERS)}.get(kw.pop("style", None),
                                                                    hh.European())
    market = _market(hh, q=0.01)
    jprob = hh.PricingProblem(_barrier(style, hh, **kw), market)
    want = float(hh.solve(jprob, hh.CoxRossRubinsteinMethod(300)).price)
    got = ht.solve(ht.from_reference(jprob), _crr(300)).price
    assert got.dtype == torch.float64 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-12, abs=1e-13)


# -- tests/unit/test_barrier_crr.py --------------------------------------------------------

EURO_CASES = [
    dict(barrier=120.0, direction=ht.Up(), knock=ht.KnockOut(), call_put=ht.Call()),
    dict(barrier=80.0, direction=ht.Down(), knock=ht.KnockOut(), call_put=ht.Call()),
    dict(barrier=80.0, direction=ht.Down(), knock=ht.KnockOut(), call_put=ht.Put()),
    dict(barrier=120.0, direction=ht.Up(), knock=ht.KnockIn(), call_put=ht.Call()),
    dict(barrier=80.0, direction=ht.Down(), knock=ht.KnockIn(), call_put=ht.Put()),
    dict(barrier=120.0, direction=ht.Up(), knock=ht.KnockOut(), call_put=ht.Call(), rebate=3.0),
    dict(barrier=120.0, direction=ht.Up(), knock=ht.KnockOut(), call_put=ht.Call(), rebate=3.0,
         rebate_at_hit=True),
    dict(barrier=80.0, direction=ht.Down(), knock=ht.KnockIn(), call_put=ht.Put(), rebate=2.0),
]


@pytest.mark.parametrize("case", EURO_CASES)
def test_european_vs_reiner_rubinstein(case):
    prob = ht.PricingProblem(_barrier(**case), _market())
    ana = float(ht.solve(prob, ht.BlackScholesAnalytic(device=CPU)).price)
    assert float(ht.solve(prob, _crr(1000)).price) == pytest.approx(ana, rel=2e-2)


def test_in_out_parity_on_the_lattice():
    common = dict(barrier=120.0, direction=ht.Up(), call_put=ht.Call(), rebate=2.5)
    ki = _price(_barrier(knock=ht.KnockIn(), **common), 300)
    ko = _price(_barrier(knock=ht.KnockOut(), **common), 300)
    van = _price(ht.VanillaOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot()), 300)
    d_t = float(ht.df(_market().rate, ht.to_ticks(EXPIRY)))
    assert ki + ko == pytest.approx(van + 2.5 * d_t, abs=1e-10)


def test_american_knock_out_ordering():
    kw = dict(strike=110.0, barrier=80.0, direction=ht.Down(), knock=ht.KnockOut(),
              call_put=ht.Put())
    am = _price(_barrier(ht.American(), **kw))
    eu = _price(_barrier(**kw))
    van = _price(ht.VanillaOption(110.0, EXPIRY, ht.American(), ht.Put(), ht.Spot()))
    assert eu <= am <= van * (1.0 + 1e-4)
    assert am > eu + 1.0


def test_american_up_out_call_has_early_exercise_premium():
    kw = dict(barrier=120.0, direction=ht.Up(), knock=ht.KnockOut(), call_put=ht.Call())
    assert _price(_barrier(ht.American(), **kw)) > 5 * _price(_barrier(**kw))


def test_knocked_root():
    kw = dict(barrier=90.0, direction=ht.Down(), knock=ht.KnockOut(), call_put=ht.Put(),
              strike=110.0)
    low = _market(spot=80.0)
    d_t = float(ht.df(low.rate, ht.to_ticks(EXPIRY)))
    assert _price(_barrier(rebate=4.0, rebate_at_hit=True, **kw), 50, low) == pytest.approx(
        4.0, abs=1e-12)
    assert _price(_barrier(rebate=4.0, **kw), 50, low) == pytest.approx(4.0 * d_t, abs=1e-12)


# -- tests/unit/test_american_knock_in.py ----------------------------------------------------


def _ki(strike, barrier, style, cp, direction, rebate=0.0):
    return ht.BarrierOption(strike, EXPIRY, barrier, style, cp, ht.Spot(), direction,
                            ht.KnockIn(), rebate=rebate)


def test_american_up_in_call_equals_european_parity():
    am = _price(_ki(100.0, 120.0, ht.American(), ht.Call(), ht.Up()), 2000)
    eu = _price(_ki(100.0, 120.0, ht.European(), ht.Call(), ht.Up()), 2000)
    an = float(ht.solve(ht.PricingProblem(_ki(100.0, 120.0, ht.European(), ht.Call(), ht.Up()),
                                          _market()), ht.BlackScholesAnalytic(device=CPU)).price)
    np.testing.assert_allclose(am, eu, rtol=1e-3)
    np.testing.assert_allclose(am, an, rtol=5e-4)


def test_immediate_knock_in_is_american_vanilla():
    ki = _price(_ki(110.0, 100.0, ht.American(), ht.Put(), ht.Up()))
    van = _price(ht.VanillaOption(110.0, EXPIRY, ht.American(), ht.Put(), ht.Spot()))
    np.testing.assert_allclose(ki, van, rtol=1e-4)


def test_american_knock_in_put_bounds():
    aki = _price(_ki(110.0, 85.0, ht.American(), ht.Put(), ht.Down()))
    eki = _price(_ki(110.0, 85.0, ht.European(), ht.Put(), ht.Down()))
    ako = _price(ht.BarrierOption(110.0, EXPIRY, 85.0, ht.American(), ht.Put(), ht.Spot(),
                                  ht.Down(), ht.KnockOut()))
    van = _price(ht.VanillaOption(110.0, EXPIRY, ht.American(), ht.Put(), ht.Spot()))
    assert eki < aki <= van * (1 + 1e-12), (eki, aki, van)
    assert aki + ako >= van - 1e-6


def test_american_knock_in_step_convergence():
    p250, p500, p1000 = (_price(_ki(110.0, 85.0, ht.American(), ht.Put(), ht.Down()), n)
                         for n in (250, 500, 1000))
    assert abs(p1000 - p500) < abs(p500 - p250) + 1e-6
    np.testing.assert_allclose(p500, p1000, rtol=2e-4)


def test_american_knock_in_rebate_is_european_no_touch_bond():
    am_r = _price(_ki(110.0, 85.0, ht.American(), ht.Put(), ht.Down(), 2.0))
    am_0 = _price(_ki(110.0, 85.0, ht.American(), ht.Put(), ht.Down()))
    eu_r = _price(_ki(110.0, 85.0, ht.European(), ht.Put(), ht.Down(), 2.0))
    eu_0 = _price(_ki(110.0, 85.0, ht.European(), ht.Put(), ht.Down()))
    np.testing.assert_allclose(am_r - am_0, eu_r - eu_0, rtol=5e-3)


def test_bermudan_knock_in_between_european_and_american():
    eu = _price(_ki(110.0, 85.0, ht.European(), ht.Put(), ht.Down()))
    be = _price(_ki(110.0, 85.0, ht.Bermudan(QUARTERS), ht.Put(), ht.Down()))
    am = _price(_ki(110.0, 85.0, ht.American(), ht.Put(), ht.Down()))
    assert eu - 1e-9 <= be <= am + 1e-9, (eu, be, am)


def test_knock_in_dominates_with_nearer_barrier():
    near = _price(_ki(100.0, 95.0, ht.American(), ht.Put(), ht.Down()), 500)
    far = _price(_ki(100.0, 80.0, ht.American(), ht.Put(), ht.Down()), 500)
    assert near > far > 0.0


# -- dispatch and guards ------------------------------------------------------------------


def test_guards():
    mkt = _market()
    with pytest.raises(TypeError, match="monitors the spot"):
        ht.solve(ht.PricingProblem(_barrier(barrier=80.0, underlying=ht.Forward()), mkt),
                 _crr(50))
    with pytest.raises(TypeError, match=r"one \(strike, barrier\) pair"):
        ht.solve(ht.PricingProblem(_barrier(barrier=80.0, strike=np.array([95.0, 105.0])),
                                   mkt), _crr(50))
    with pytest.raises(TypeError, match=r"one \(strike, barrier\) pair"):
        ht.solve(ht.PricingProblem(_barrier(ht.American(), barrier=np.array([80.0, 85.0]),
                                            knock=ht.KnockIn()), mkt), _crr(50))
    with pytest.raises(TypeError, match="running-average"):
        ht.solve(ht.PricingProblem(ht.AsianOption(100.0, EXPIRY, 12), mkt), _crr(50))
    with pytest.raises(TypeError, match="running-extremum"):
        ht.solve(ht.PricingProblem(ht.LookbackOption(EXPIRY), mkt), _crr(50))
    with pytest.raises(TypeError, match="single-barrier bridge correction"):
        ht.solve(ht.PricingProblem(ht.DoubleBarrierOption(100.0, EXPIRY, 80.0, 120.0), mkt),
                 _crr(50))
    with pytest.raises(TypeError, match="no induction for VarianceSwap"):
        ht.solve(ht.PricingProblem(ht.VarianceSwap(0.04, EXPIRY, 12), mkt), _crr(50))
    divs = ht.BlackScholesInputs(REF, 0.05, 100.0, 0.25,
                                 dividends=ht.DividendSchedule([dt.date(2024, 6, 1)], [2.0]))
    for knock, style in ((ht.KnockOut(), ht.American()), (ht.KnockIn(), ht.American()),
                         (ht.KnockIn(), ht.European())):
        with pytest.raises(TypeError, match="dividend-free GBM path law"):
            ht.solve(ht.PricingProblem(_barrier(style, barrier=80.0, knock=knock), divs),
                     _crr(50))


@pytest.mark.parametrize("style", ["European", "American"])
def test_digital_on_the_lattice(style):
    """The vanilla induction takes the digital's payoff as it stands, as
    JAX's lattice does (rtol 1e-12; the American digital is worth more)."""
    dig = hh.DigitalOption(105.0, EXPIRY, getattr(hh, style)(), hh.Call(), hh.Spot(), cash=10.0)
    jprob = hh.PricingProblem(dig, _market(hh))
    want = float(hh.solve(jprob, hh.CoxRossRubinsteinMethod(300)).price)
    got = float(ht.solve(ht.from_reference(jprob), _crr(300)).price)
    assert got == pytest.approx(want, rel=1e-12)
    eu = ht.DigitalOption(105.0, EXPIRY, ht.European(), ht.Call(), ht.Spot(), cash=10.0)
    assert got >= _price(eu, 300) - 1e-12
