"""Discrete cash dividends (market/dividends.py) against the JAX package on
the CPU.

The dividend algebra agrees to rel 1e-14 (every day count, an ex-date on a
half grid step); the escrowed engines (Black-Scholes, Carr–Madan, CRR) to
1e-12; the log-Euler QMC grid with its ex-date drops per path to 1e-11 and
the float64 exact QMC draw to 1e-12.  The cases of
tests/unit/test_discrete_dividends.py run on the port at small sizes, with
the guards' messages."""

import dataclasses
import datetime as dt
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.market import dividends as jdiv
from hedgehog_tpu.models import dynamics as jdyn
from hedgehog_tpu_torch.market import dividends as pdiv
from hedgehog_tpu_torch.models import dynamics as pdyn

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
EX_DATES = [dt.date(2024, 4, 1), dt.date(2024, 10, 1)]
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _schedule(amts=(2.0, 2.0), lib=hh):
    return lib.DividendSchedule(EX_DATES, list(amts))


def _mkt(divs=None, lib=hh, **kw):
    return lib.BlackScholesInputs(REF, 0.03, 100.0, 0.2, dividends=divs, **kw)


def _vo(cp=None, style=None, strike=100.0, lib=ht):
    return lib.VanillaOption(strike, EXPIRY, style or lib.European(), cp or lib.Call(),
                             lib.Spot())


def _cfg(paths=1 << 12, steps=24, lib=ht):
    return lib.SimulationConfig(trajectories=paths, steps=steps,
                                variance_reduction=lib.Antithetic(), seed=0, qmc=True)


def _cpu(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _price(prob, method) -> float:
    return float(ht.solve(prob, method).price)


BS = ht.BlackScholesAnalytic(device=CPU)
PDE = ht.PDEMethod(space_steps=120, time_steps=60, device=CPU)


# -- the dividend algebra ------------------------------------------------------------


DAYCOUNTS = {"act365f": hh.Act365Fixed(), "act360": hh.Act360(),
             "thirty360e": hh.Thirty360E(), "actact": hh.ActActISDA()}
SCHEDULE = [dt.date(2023, 12, 1), dt.date(2024, 2, 29), dt.date(2024, 5, 31),
            dt.date(2024, 8, 15), dt.date(2024, 12, 31), dt.date(2025, 3, 1)]


@pytest.mark.parametrize("name", sorted(DAYCOUNTS))
def test_dividend_algebra_matches_reference(name):
    """PV, the remaining PV at lattice times, the per-step drops and the
    escrowed spot, every entry outside (0, T] masked, to rel 1e-14."""
    rng = np.random.default_rng(21)
    amounts = rng.uniform(0.5, 3.0, len(SCHEDULE))
    jm = hh.BlackScholesInputs(REF, 0.04, 100.0, 0.2, daycount=DAYCOUNTS[name],
                               dividends=hh.DividendSchedule(SCHEDULE, amounts))
    pm = ht.from_reference(jm)
    assert isinstance(pm.dividends, pdiv.DividendSchedule)
    np.testing.assert_array_equal(pm.dividends.times, jm.dividends.times)
    np.testing.assert_allclose(pdiv.dividend_yearfracs(pm).numpy(),
                               np.asarray(jdiv.dividend_yearfracs(jm)), rtol=1e-15)
    T = float(hh.market_yearfrac(jm, hh.to_ticks(EXPIRY)))
    for window in (T, 0.5 * T):
        assert float(pdiv.dividend_pv(pm, window)) == pytest.approx(
            float(jdiv.dividend_pv(jm, window)), rel=1e-14)
        assert float(pdiv.escrowed_spot(pm, window)) == pytest.approx(
            float(jdiv.escrowed_spot(jm, window)), rel=1e-14)
    t_eval = np.arange(40) * (T / 40)
    np.testing.assert_allclose(pdiv.remaining_dividend_pv(pm, torch.tensor(t_eval), T).numpy(),
                               np.asarray(jdiv.remaining_dividend_pv(jm, jnp.asarray(t_eval), T)),
                               rtol=1e-14, atol=1e-15)
    for steps in (7, 48, 365):
        np.testing.assert_allclose(pdiv.dividend_step_amounts(pm, T, steps).numpy(),
                                   np.asarray(jdiv.dividend_step_amounts(jm, T, steps)),
                                   rtol=1e-14, atol=0)


def test_ex_date_on_a_half_grid_step():
    """ACT/360 over 360 days: T = 1 exactly, and with 4 steps the ex-dates
    at t = 0.375 and 0.625 sit on half steps 1.5 and 2.5.  Both round half
    to even, to grid time 2: slot 1 carries both amounts, as in JAX."""
    divs = [dt.date(2024, 1, 1) + dt.timedelta(days=d) for d in (135, 225)]
    jm = hh.BlackScholesInputs(REF, 0.04, 100.0, 0.2, daycount=hh.Act360(),
                               dividends=hh.DividendSchedule(divs, [1.25, 0.5]))
    pm = ht.from_reference(jm)
    T = float(hh.market_yearfrac(jm, hh.to_ticks(REF + dt.timedelta(days=360))))
    assert T == 1.0
    got = pdiv.dividend_step_amounts(pm, T, 4).numpy()
    np.testing.assert_array_equal(got, [0.0, 1.75, 0.0, 0.0])
    np.testing.assert_array_equal(got, np.asarray(jdiv.dividend_step_amounts(jm, T, 4)))


def test_no_schedule_and_empty_schedule():
    plain = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
    assert float(pdiv.dividend_pv(plain, 1.0)) == 0.0
    assert pdiv.dividend_step_amounts(plain, 1.0, 5).tolist() == [0.0] * 5
    empty = ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2, dividends=ht.DividendSchedule([], []))
    p0, pe = _price(ht.PricingProblem(_vo(), plain), BS), _price(ht.PricingProblem(_vo(), empty), BS)
    assert pe == pytest.approx(p0, abs=1e-12)


def test_dividend_pv_and_masking():
    mkt = _mkt(_schedule(lib=ht), lib=ht)
    T = ht.yearfrac(REF, EXPIRY)
    t1, t2 = ht.yearfrac(REF, EX_DATES[0]), ht.yearfrac(REF, EX_DATES[1])
    expected = 2.0 * math.exp(-0.03 * t1) + 2.0 * math.exp(-0.03 * t2)
    assert float(ht.dividend_pv(mkt, T)) == pytest.approx(expected, rel=1e-12)
    assert float(ht.dividend_pv(mkt, 0.5 * (t1 + t2))) == pytest.approx(
        2.0 * math.exp(-0.03 * t1), rel=1e-12)
    late = ht.DividendSchedule([dt.date(2026, 1, 1)], [5.0])
    assert float(ht.dividend_pv(_mkt(late, lib=ht), T)) == 0.0
    assert float(ht.forward_spot(mkt, T)) == pytest.approx(100.0 - expected, rel=1e-14)


# -- the escrowed engines --------------------------------------------------------------


@pytest.mark.parametrize("q", [0.0, 0.01])
@pytest.mark.parametrize("cp", ["Call", "Put"])
def test_escrowed_engines_match_reference(cp, q):
    """Black-Scholes, Carr–Madan, and CRR (European and American, with the
    remaining-dividend add-back on exercise nodes) to 1e-12."""
    jm = _mkt(_schedule(), dividend_yield=q)
    cases = [(hh.European(), hh.BlackScholesAnalytic()),
             (hh.European(), hh.CarrMadan(1.0, "auto", hh.LognormalDynamics())),
             (hh.European(), hh.CoxRossRubinsteinMethod(300)),
             (hh.American(), hh.CoxRossRubinsteinMethod(300))]
    for style, method in cases:
        jprob = hh.PricingProblem(_vo(getattr(hh, cp)(), style, lib=hh), jm)
        want = float(hh.solve(jprob, method).price)
        got = _price(ht.from_reference(jprob), _cpu(method))
        assert got == pytest.approx(want, rel=1e-12), (type(method).__name__, style)


def test_lognormal_terminal_law_is_escrowed():
    jm = _mkt(_schedule())
    mean_j, std_j = jdyn.lognormal_terminal_law(jm, hh.to_ticks(EXPIRY))
    mean_p, std_p = pdyn.lognormal_terminal_law(ht.from_reference(jm), ht.to_ticks(EXPIRY))
    assert float(mean_p) == pytest.approx(float(mean_j), rel=1e-15)
    assert float(std_p) == pytest.approx(float(std_j), rel=1e-15)
    T = ht.yearfrac(REF, EXPIRY)
    fwd = math.exp(float(mean_p) + 0.5 * float(std_p) ** 2) * math.exp(-0.03 * T)
    assert fwd == pytest.approx(float(ht.forward_spot(ht.from_reference(jm), T)), rel=1e-14)


# -- the sampled paths -------------------------------------------------------------


def test_euler_grid_with_drops_matches_reference_per_path():
    """The log-Euler QMC grid with ex-date drops on the same Sobol' points,
    every path value to 1e-11."""
    divs = hh.DividendSchedule([dt.date(2024, 3, 15), dt.date(2024, 6, 1), dt.date(2024, 9, 9)],
                               [1.5, 4.0, 2.5])
    jm = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.25, dividends=divs)
    jprob = hh.PricingProblem(_vo(hh.Put(), lib=hh), jm)
    method = hh.MonteCarlo(hh.LognormalDynamics(), hh.EulerMaruyama(), _cfg(lib=hh))
    want = np.asarray(jax.device_get(hh.simulate_price_grid(jprob, method)))
    got = ht.simulate_price_grid(ht.from_reference(jprob), _cpu(method)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-11)
    # a drop leaves the path below its undropped self from the ex-date on
    plain = ht.simulate_price_grid(
        ht.PricingProblem(_vo(ht.Put()), ht.BlackScholesInputs(REF, 0.05, 100.0, 0.25)),
        _cpu(method)).numpy()
    assert np.all(got[:, -1] < plain[:, -1])
    jsol = hh.solve(jprob, method)
    assert _price(ht.from_reference(jprob), _cpu(method)) == pytest.approx(
        float(jsol.price), rel=1e-11)


def test_exact_draw_is_escrowed_per_path():
    """The float64 BlackScholesExact QMC draw from the escrowed law, each
    path to 1e-12 and the price to 1e-12."""
    jm = _mkt(_schedule())
    jprob = hh.PricingProblem(_vo(lib=hh), jm)
    method = hh.MonteCarlo(hh.LognormalDynamics(), hh.BlackScholesExact(), _cfg(lib=hh))
    want = np.asarray(jax.device_get(hh.simulate_terminal_prices(jprob, method)))
    got = ht.simulate_terminal_prices(ht.from_reference(jprob), _cpu(method)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert _price(ht.from_reference(jprob), _cpu(method)) == pytest.approx(
        float(hh.solve(jprob, method).price), rel=1e-12)


def test_k13_twin_draws_from_the_escrowed_law():
    """``BlackScholesExact(use_kernel=True)`` on the CPU runs K13's float32
    twin from the escrowed (mean, std): within 4 SE of the escrowed closed
    form, and not of the undivided one."""
    mkt = _mkt(_schedule(lib=ht), lib=ht)
    prob = ht.PricingProblem(_vo(), mkt)
    cfg = ht.SimulationConfig(1 << 16, 1, ht.Antithetic(), 3)
    sol = ht.solve(prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.BlackScholesExact(
        use_kernel=True), cfg, device=CPU))
    D = math.exp(-0.03 * ht.yearfrac(REF, EXPIRY))
    pair = torch.clamp(sol.ensemble - 100.0, min=0.0).mean(dim=0)  # each pair's payoff
    se = D * float(pair.std()) / math.sqrt(pair.numel())
    assert abs(float(sol.price) - _price(prob, BS)) <= 4.0 * se
    undivided = _price(ht.PricingProblem(_vo(), _mkt(lib=ht)), BS)
    assert abs(float(sol.price) - undivided) > 20.0 * se


# -- the cases of tests/unit/test_discrete_dividends.py on the port ---------------------


def test_escrowed_engines_agree():
    mkt = _mkt(_schedule(lib=ht), lib=ht)
    T = ht.yearfrac(REF, EXPIRY)
    pv = float(ht.dividend_pv(mkt, T))
    oracle = ht.BlackScholesInputs(REF, 0.03, 100.0 - pv, 0.2)
    for cp in (ht.Call(), ht.Put()):
        prob = ht.PricingProblem(_vo(cp), mkt)
        p = _price(prob, BS)
        assert p == pytest.approx(_price(ht.PricingProblem(_vo(cp), oracle), BS), abs=1e-12)
        cm = _price(prob, ht.CarrMadan(1.0, "auto", ht.LognormalDynamics(), device=CPU))
        assert cm == pytest.approx(p, rel=1e-6)
        mc = _price(prob, ht.MonteCarlo(ht.LognormalDynamics(), ht.BlackScholesExact(),
                                        _cfg(1 << 15), device=CPU))
        assert mc == pytest.approx(p, rel=3e-3)
    crr = _price(ht.PricingProblem(_vo(), mkt), ht.CoxRossRubinsteinMethod(500, device=CPU))
    assert crr == pytest.approx(_price(ht.PricingProblem(_vo(), mkt), BS), rel=2e-3)


def test_put_call_parity_with_schedule():
    mkt = _mkt(_schedule(lib=ht), lib=ht, dividend_yield=0.01)
    T = ht.yearfrac(REF, EXPIRY)
    lhs = float(ht.forward_spot(mkt, T)) - 100.0 * math.exp(-0.03 * T)
    for method in (BS, ht.CarrMadan(1.0, "auto", ht.LognormalDynamics(), device=CPU)):
        c = _price(ht.PricingProblem(_vo(ht.Call()), mkt), method)
        p = _price(ht.PricingProblem(_vo(ht.Put()), mkt), method)
        assert c - p == pytest.approx(lhs, rel=1e-6, abs=1e-6)


def _spot_model_market(amount=5.0, ex=dt.date(2024, 6, 1)):
    return ht.BlackScholesInputs(REF, 0.05, 100.0, 0.25,
                                 dividends=ht.DividendSchedule([ex], [amount]))


def test_spot_model_pde_matches_grid_mc():
    mkt = _spot_model_market()
    mc = ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), _cfg(1 << 15, 48),
                       device=CPU)
    pde = ht.PDEMethod(space_steps=300, time_steps=120, device=CPU)
    for cp in (ht.Call(), ht.Put()):
        prob = ht.PricingProblem(_vo(cp), mkt)
        assert _price(prob, mc) == pytest.approx(_price(prob, pde), rel=5e-3)
    p_esc = _price(ht.PricingProblem(_vo(), mkt), BS)
    p_pde = _price(ht.PricingProblem(_vo(), mkt), pde)
    assert abs(p_pde - p_esc) / p_esc < 0.05
    assert p_pde != pytest.approx(p_esc, rel=1e-4)  # two different models


def test_american_call_exercises_before_ex_div():
    mkt = _spot_model_market()
    pde = ht.PDEMethod(space_steps=300, time_steps=120, device=CPU)
    eu = _price(ht.PricingProblem(_vo(), mkt), pde)
    am = _price(ht.PricingProblem(_vo(style=ht.American()), mkt), pde)
    assert am > eu + 0.05
    mkt0 = ht.BlackScholesInputs(REF, 0.05, 100.0, 0.25)
    eu0 = _price(ht.PricingProblem(_vo(), mkt0), pde)
    am0 = _price(ht.PricingProblem(_vo(style=ht.American()), mkt0), pde)
    assert am0 == pytest.approx(eu0, rel=1e-3)
    crr = ht.CoxRossRubinsteinMethod(500, device=CPU)
    prem_crr = (_price(ht.PricingProblem(_vo(style=ht.American()), mkt), crr)
                - _price(ht.PricingProblem(_vo(), mkt), crr))
    assert prem_crr > 0.05
    assert prem_crr == pytest.approx(am - eu, rel=0.4)


def test_american_put_lsm_matches_pde():
    mkt = _spot_model_market(4.0)
    po = _vo(ht.Put(), ht.American())
    p_pde = _price(ht.PricingProblem(po, mkt),
                   ht.PDEMethod(space_steps=300, time_steps=120, device=CPU))
    lsm = ht.LSM(ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), _cfg(1 << 12, 32),
                               device=CPU), 4)
    assert _price(ht.PricingProblem(po, mkt), lsm) == pytest.approx(p_pde, rel=2e-2)


def test_knock_out_pde_with_dividends_is_sane():
    mkt = _spot_model_market(3.0)
    pde = ht.PDEMethod(space_steps=300, time_steps=120, device=CPU)
    van = _price(ht.PricingProblem(_vo(), mkt), pde)
    uoc = ht.BarrierOption(100.0, EXPIRY, 130.0, ht.European(), ht.Call(), ht.Spot(), ht.Up(),
                           ht.KnockOut())
    ko = _price(ht.PricingProblem(uoc, mkt), pde)
    ki = _price(ht.PricingProblem(dataclasses.replace(uoc, knock=ht.KnockIn()), mkt), pde)
    assert 0.0 < ko < van
    assert ko + ki == pytest.approx(van, rel=1e-8)
    mc = ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), _cfg(1 << 15, 48),
                       device=CPU)
    assert _price(ht.PricingProblem(uoc, mkt), mc) == pytest.approx(ko, rel=2e-2)


def test_dividend_gradients_flow():
    amounts = torch.tensor([2.0, 2.0], dtype=torch.float64, requires_grad=True)
    mkt = _mkt(ht.DividendSchedule(EX_DATES, amounts), lib=ht)
    price = ht.solve(ht.PricingProblem(_vo(), mkt), BS).price
    (g,) = torch.autograd.grad(price, amounts)
    # ∂C/∂D_i = −df(t_i)·∂C/∂S: negative for a call, |g| < 1
    assert bool((g < 0.0).all()) and bool((g > -1.0).all())
    spot = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
    mkt_s = ht.BlackScholesInputs(REF, 0.03, spot, 0.2, dividends=_schedule(lib=ht))
    (delta,) = torch.autograd.grad(ht.solve(ht.PricingProblem(_vo(), mkt_s), PDE).price, spot)
    assert 0.3 < float(delta) < 0.8


def test_bermudan_pde_exercises_on_ex_date():
    ex = dt.date(2024, 7, 1)
    mkt = _spot_model_market(6.0, ex)
    pde = ht.PDEMethod(space_steps=300, time_steps=120, device=CPU)
    eu = _price(ht.PricingProblem(_vo(), mkt), pde)
    am = _price(ht.PricingProblem(_vo(style=ht.American()), mkt), pde)
    bm = _price(ht.PricingProblem(_vo(style=ht.Bermudan([ex])), mkt), pde)
    assert eu <= bm + 1e-12 and bm <= am + 1e-12
    assert bm > eu + 0.05
    assert bm == pytest.approx(am, rel=2e-2)


def test_calendar_daycount_with_schedule():
    p360 = _price(ht.PricingProblem(_vo(), _mkt(_schedule(lib=ht), lib=ht,
                                                 daycount=ht.Thirty360E())), BS)
    p365 = _price(ht.PricingProblem(_vo(), _mkt(_schedule(lib=ht), lib=ht)), BS)
    assert p360 == pytest.approx(p365, rel=2e-2)


def test_from_reference_carries_the_schedule():
    jm = _mkt(_schedule((1.5, 2.5)))
    pm = ht.from_reference(jm)
    assert isinstance(pm.dividends, ht.DividendSchedule)
    assert pm.dividends.amounts.dtype == torch.float64
    assert pm.dividends.amounts.tolist() == [1.5, 2.5]
    assert pm.daycount == ht.ACT365F


# -- guards ---------------------------------------------------------------------------


def test_guards():
    mkt = _mkt(_schedule(lib=ht), lib=ht)
    uoc = ht.BarrierOption(100.0, EXPIRY, 130.0, ht.European(), ht.Call(), ht.Spot(), ht.Up(),
                           ht.KnockOut())
    with pytest.raises(TypeError, match="escrowed"):
        ht.solve(ht.PricingProblem(uoc, mkt), BS)
    with pytest.raises(TypeError, match="barrier CRR assumes a dividend-free"):
        ht.solve(ht.PricingProblem(uoc, mkt), ht.CoxRossRubinsteinMethod(100, device=CPU))
    with pytest.raises(TypeError, match="one-bridge"):
        ht.solve(ht.PricingProblem(uoc, mkt), ht.MonteCarlo(
            ht.LognormalDynamics(), ht.BlackScholesExact(), _cfg(1 << 10), device=CPU))
    with pytest.raises(TypeError, match="DividendSchedule"):
        ht.solve(ht.PricingProblem(ht.VarianceSwap(0.04, EXPIRY, 48), mkt),
                 ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), _cfg(1 << 10),
                               device=CPU))
    with pytest.raises(TypeError, match="need a Spot underlying"):
        ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY, ht.American(), ht.Call(),
                                                    ht.Forward()), mkt),
                 ht.CoxRossRubinsteinMethod(50, device=CPU))
    with pytest.raises(ValueError, match="matching"):
        ht.DividendSchedule(EX_DATES, [1.0])
    with pytest.raises(ValueError, match="1-D"):
        ht.DividendSchedule(np.zeros((2, 1), dtype=np.int64), [1.0, 2.0])


def test_escrowed_spot_exceeding_schedule_raises():
    big = ht.DividendSchedule(EX_DATES, [60.0, 60.0])
    with pytest.raises(ValueError, match="escrowed spot"):
        ht.solve(ht.PricingProblem(_vo(), _mkt(big, lib=ht)), BS)
    with pytest.raises(ValueError, match="escrowed spot"):
        ht.solve(ht.PricingProblem(_vo(), _mkt(big, lib=ht)),
                 ht.CoxRossRubinsteinMethod(50, device=CPU))
