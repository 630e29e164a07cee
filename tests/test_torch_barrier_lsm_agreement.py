"""The barrier and knock-in LSM estimators on the port alone, on the CPU:
the cases of tests/agreement/test_american_barrier.py and
test_american_knock_in_mc.py against the port's CRR lattice and its own
limits, on QMC grids of at most 2^12 antithetic pairs.  The first-passage
exercise leg of the knock-outs converges from above at O(Δt) (+2.4% at
64 steps, +0.7% at 200 for the down-and-out put; +0.9% at 400 for the
up-and-out call), so those contracts keep the JAX suite's tolerances at
200, 400 and (Heston) 100 steps; the rest run at 32 steps."""

import dataclasses
import datetime as dt

import pytest
import torch

import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CPU = "cpu"
QUARTERS = (dt.date(2024, 4, 1), dt.date(2024, 7, 1), dt.date(2024, 10, 1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _mc(market=None, steps=32, paths=1 << 12, heston=False, qmc=True):
    cfg = ht.SimulationConfig(paths, steps, ht.Antithetic(), 0, qmc)
    if heston:
        return ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True), cfg, device=CPU)
    return ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), cfg, device=CPU)


def _bs():
    return ht.BlackScholesInputs(REF, 0.05, 100.0, 0.25)


def _solve(payoff, market, method) -> float:
    return float(ht.solve(ht.PricingProblem(payoff, market), method).price)


def _crr(steps=500):
    return ht.CoxRossRubinsteinMethod(steps, device=CPU)


def _amer_ko(**kw):
    kw.setdefault("strike", 110.0)
    kw.setdefault("direction", ht.Down())
    kw.setdefault("call_put", ht.Put())
    return ht.BarrierOption(expiry=EXPIRY, exercise_style=ht.American(), knock=ht.KnockOut(),
                            **kw)


KI = ht.BarrierOption(110.0, EXPIRY, 85.0, ht.American(), ht.Put(), ht.Spot(), ht.Down(),
                      ht.KnockIn())


def test_down_out_put_vs_crr():
    po = _amer_ko(barrier=80.0)
    assert _solve(po, _bs(), ht.LSM(_mc(steps=200), 4)) == pytest.approx(
        _solve(po, _bs(), _crr(2000)), rel=1e-2)


def test_up_out_call_is_bounded_lower_estimate():
    po = _amer_ko(strike=100.0, barrier=120.0, direction=ht.Up(), call_put=ht.Call())
    lsm, crr = _solve(po, _bs(), ht.LSM(_mc(steps=400), 4)), _solve(po, _bs(), _crr(2000))
    assert 0.98 * crr <= lsm <= 1.01 * crr


@pytest.mark.parametrize("at_hit", [False, True])
def test_rebate_legs_vs_crr(at_hit):
    po = _amer_ko(strike=100.0, barrier=120.0, direction=ht.Up(), call_put=ht.Put(), rebate=3.0,
                  rebate_at_hit=at_hit)
    assert _solve(po, _bs(), ht.LSM(_mc(), 4)) == pytest.approx(_solve(po, _bs(), _crr()),
                                                                rel=1e-2)


def test_exercise_preempts_rebate():
    p0, p3 = (_solve(_amer_ko(barrier=80.0, rebate=r), _bs(), ht.LSM(_mc(), 4)) for r in (0.0, 3.0))
    assert p3 == pytest.approx(p0, abs=5e-3)


def test_rebate_dominant_policy():
    po = _amer_ko(strike=100.0, barrier=120.0, direction=ht.Up(), call_put=ht.Call(),
                  rebate=30.0, rebate_at_hit=True)
    assert _solve(po, _bs(), ht.LSM(_mc(), 4)) == pytest.approx(_solve(po, _bs(), _crr()),
                                                                rel=1e-2)


def test_heston_knock_out_bounds_and_far_barrier():
    hm = ht.HestonInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    mc = _mc(steps=100, heston=True)
    am = _amer_ko(barrier=80.0)
    p_am = _solve(am, hm, ht.LSM(mc, 3))
    p_eu = _solve(dataclasses.replace(am, exercise_style=ht.European()), hm, mc)
    van = ht.VanillaOption(110.0, EXPIRY, ht.American(), ht.Put(), ht.Spot())
    p_van = _solve(van, hm, ht.LSM(mc, 3))
    assert p_eu - 0.05 <= p_am <= p_van + 0.10
    p_far = _solve(_amer_ko(barrier=1e-6), hm, ht.LSM(mc, 3))
    assert p_far == pytest.approx(p_van, rel=2e-3)
    spot = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
    hm_s = dataclasses.replace(hm, spot=spot)
    (delta,) = torch.autograd.grad(ht.solve(ht.PricingProblem(am, hm_s), ht.LSM(mc, 3)).price,
                                   spot)
    assert -1.0 < float(delta) < -0.3


def test_lsm_american_knock_in_prices():
    ki = ht.BarrierOption(110.0, EXPIRY, 80.0, ht.American(), ht.Put(), ht.Spot(), ht.Down(),
                          ht.KnockIn())
    p = _solve(ki, _bs(), ht.LSM(_mc(steps=25, paths=2048), 3))
    van = _solve(ht.VanillaOption(110.0, EXPIRY, ht.American(), ht.Put(), ht.Spot()), _bs(),
                 _crr())
    assert 0.0 < p < van


def test_gbm_knock_in_vs_crr_quadrature():
    assert _solve(KI, _bs(), ht.LSM(_mc(), 4)) == pytest.approx(_solve(KI, _bs(), _crr()),
                                                                rel=2e-2)


def test_gbm_bermudan_and_otm_barrier_corners():
    kib = dataclasses.replace(KI, exercise_style=ht.Bermudan(QUARTERS))
    lsm_b = _solve(kib, _bs(), ht.LSM(_mc(), 4))
    assert lsm_b == pytest.approx(_solve(kib, _bs(), _crr()), rel=2e-2)
    assert lsm_b < _solve(KI, _bs(), ht.LSM(_mc(), 4))
    kic = ht.BarrierOption(100.0, EXPIRY, 80.0, ht.American(), ht.Call(), ht.Spot(), ht.Down(),
                           ht.KnockIn())
    assert _solve(kic, _bs(), ht.LSM(_mc(), 4)) == pytest.approx(_solve(kic, _bs(), _crr()),
                                                                 rel=5e-2)


def test_knocked_at_inception_is_vanilla_lsm():
    ki0 = ht.BarrierOption(110.0, EXPIRY, 100.0, ht.American(), ht.Put(), ht.Spot(), ht.Up(),
                           ht.KnockIn())
    van = ht.VanillaOption(110.0, EXPIRY, ht.American(), ht.Put(), ht.Spot())
    mc = _mc(steps=16, paths=2048)
    assert _solve(ki0, _bs(), ht.LSM(mc, 4)) == pytest.approx(_solve(van, _bs(), ht.LSM(mc, 4)),
                                                              rel=1e-12)


def test_heston_degenerate_limit_matches_bs():
    hm = ht.HestonInputs(REF, 0.05, 100.0, 0.0625, 2.0, 0.0625, 1e-3, 0.0)
    assert _solve(KI, hm, ht.LSM(_mc(heston=True), 3)) == pytest.approx(
        _solve(KI, _bs(), _crr()), rel=2e-2)


def test_heston_knock_in_bounds_and_rebate():
    hm = ht.HestonInputs(REF, 0.05, 100.0, 0.0625, 2.0, 0.0625, 0.4, -0.6)
    mc = _mc(heston=True, qmc=False)
    ki_am = _solve(KI, hm, ht.LSM(mc, 3))
    eu = dataclasses.replace(KI, exercise_style=ht.European())
    ki_eu = _solve(eu, hm, mc)
    van_am = _solve(ht.VanillaOption(110.0, EXPIRY, ht.American(), ht.Put(), ht.Spot()), hm,
                    ht.LSM(mc, 3))
    assert ki_eu < ki_am <= van_am, (ki_eu, ki_am, van_am)
    assert ki_am > ki_eu * 1.02
    # the rebate pays iff never touched: the same increment as the European's
    am_r = _solve(dataclasses.replace(KI, rebate=2.0), hm, ht.LSM(mc, 3))
    eu_r = _solve(dataclasses.replace(eu, rebate=2.0), hm, mc)
    assert am_r - ki_am == pytest.approx(eu_r - ki_eu, rel=1e-6)
