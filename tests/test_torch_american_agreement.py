"""The statistical agreement checks of early exercise, on the port alone:
tests/agreement/test_american_options.py (LSM against CRR),
tests/unit/test_bermudan.py (the lattice's limits and ordering, LSM against
CRR on the quarterly schedule), tests/agreement/test_conditional_lsm.py
(the conditional Heston bridge and its LSM) and
tests/agreement/test_dual_bound.py (the Andersen-Broadie interval), at
their tolerances, at the sizes stated per test (the CPU's)."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu_torch as ht
from hedgehog_tpu_torch.methods import lsm as plsm
from hedgehog_tpu_torch.methods import montecarlo as pmc

REF = dt.date(2020, 1, 1)
EXPIRY_1Y = dt.date(2021, 1, 1)
CPU = "cpu"
BERM_REF, BERM_EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)
QUARTERS = (dt.date(2024, 4, 1), dt.date(2024, 7, 1), dt.date(2024, 10, 1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the host's cores, and torch's default of a thread per core in each of
    them oversubscribes the CPU (a one-second LSM then takes minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _crr(steps):
    return ht.CoxRossRubinsteinMethod(steps, device=CPU)


def _lsm_bs(trajectories, steps, degree, seed, strat=None):
    cfg = ht.SimulationConfig(trajectories, steps, ht.Antithetic(), seed)
    mc = ht.MonteCarlo(ht.LognormalDynamics(), strat or ht.BlackScholesExact(), cfg, device=CPU)
    return ht.LSM(mc, degree)


def _bs_prob(strike, expiry, style, cp, rate, spot, sigma):
    return ht.PricingProblem(ht.VanillaOption(strike, expiry, style, cp, ht.Spot()),
                             ht.BlackScholesInputs(REF, rate, spot, sigma))


def test_american_put_lsm_vs_crr():
    prob = _bs_prob(100.0, EXPIRY_1Y, ht.American(), ht.Put(), 0.05, 100.0, 0.2)
    crr = float(ht.solve(prob, _crr(1000)).price)
    lsm = float(ht.solve(prob, _lsm_bs(25_000, 100, 5, 12345)).price)
    assert lsm == pytest.approx(crr, rel=0.02)


def test_american_call_high_rate_lsm_vs_crr():
    prob = _bs_prob(100.0, EXPIRY_1Y, ht.American(), ht.Call(), 0.15, 120.0, 0.3)
    crr = float(ht.solve(prob, _crr(800)).price)
    lsm = float(ht.solve(prob, _lsm_bs(15_000, 100, 5, 54321)).price)
    assert lsm == pytest.approx(crr, rel=0.03)


@pytest.mark.parametrize("strike", [80.0, 90.0, 100.0, 110.0, 120.0])
def test_multiple_strike_agreement(strike):
    prob = _bs_prob(strike, dt.date(2020, 7, 1), ht.American(), ht.Put(), 0.05, 100.0, 0.25)
    crr = float(ht.solve(prob, _crr(500)).price)
    lsm = float(ht.solve(prob, _lsm_bs(10_000, 50, 4, int(strike) * 1000)).price)
    assert lsm == pytest.approx(crr, rel=0.05 if strike < 100.0 else 0.03)


def test_early_exercise_premium_consistency():
    amer = _bs_prob(110.0, EXPIRY_1Y, ht.American(), ht.Put(), 0.03, 100.0, 0.3)
    euro = _bs_prob(110.0, EXPIRY_1Y, ht.European(), ht.Put(), 0.03, 100.0, 0.3)
    euro_bs = float(ht.solve(euro, ht.BlackScholesAnalytic(device=CPU)).price)
    amer_crr = float(ht.solve(amer, _crr(800)).price)
    amer_lsm = float(ht.solve(amer, _lsm_bs(40_000, 100, 5, 0)).price)
    assert amer_crr >= euro_bs and amer_lsm >= euro_bs
    assert amer_lsm - euro_bs == pytest.approx(amer_crr - euro_bs, rel=0.04)


def test_lsm_rejects_european():
    prob = _bs_prob(100.0, EXPIRY_1Y, ht.European(), ht.Put(), 0.05, 100.0, 0.2)
    with pytest.raises(TypeError):
        ht.solve(prob, _lsm_bs(1000, 10, 3, 0))


def _berm_put(style):
    return ht.PricingProblem(ht.VanillaOption(110.0, BERM_EXPIRY, style, ht.Put(), ht.Spot()),
                             ht.BlackScholesInputs(BERM_REF, 0.05, 100.0, 0.25))


def test_bermudan_crr_degenerate_limits_and_ordering():
    crr = _crr(1000)
    p_eu = float(ht.solve(_berm_put(ht.European()), ht.BlackScholesAnalytic(device=CPU)).price)
    p_am = float(ht.solve(_berm_put(ht.American()), crr).price)
    p_b0 = float(ht.solve(_berm_put(ht.Bermudan(())), crr).price)
    p_bq = float(ht.solve(_berm_put(ht.Bermudan(QUARTERS)), crr).price)
    all_dates = tuple(ht.add_yearfrac(ht.to_ticks(BERM_REF), t)
                      for t in np.arange(1, 1000) / 1000.0)
    p_ball = float(ht.solve(_berm_put(ht.Bermudan(all_dates)), crr).price)
    assert p_b0 == pytest.approx(p_eu, rel=2e-3)
    assert p_ball == p_am  # mask all True is American to the bit
    assert p_eu < p_bq < p_am
    assert p_bq > p_eu + 0.05 and p_am > p_bq + 0.01


def test_bermudan_lsm_quarterly_matches_crr():
    cfg = ht.SimulationConfig(1 << 14, 48, ht.Antithetic(), 0, True)
    mc = ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), cfg, device=CPU)
    prob = _berm_put(ht.Bermudan(QUARTERS))
    p_lsm = float(ht.solve(prob, ht.LSM(mc, 4)).price)
    assert p_lsm == pytest.approx(float(ht.solve(prob, _crr(1000)).price), rel=2e-2)


def test_bermudan_heston_conditional_ordering():
    hm = ht.HestonInputs(BERM_REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    cfg = ht.SimulationConfig(1 << 13, 48, ht.Antithetic(), 0, True)
    mc = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True), cfg, device=CPU)
    put = _berm_put(ht.Bermudan(QUARTERS)).payoff
    p_b = float(ht.solve(ht.PricingProblem(put, hm), ht.LSM(mc, 3)).price)
    p_a = float(ht.solve(ht.PricingProblem(dataclasses.replace(put, exercise_style=ht.American()),
                                           hm), ht.LSM(mc, 3)).price)
    p_e = float(ht.solve(ht.PricingProblem(dataclasses.replace(put, exercise_style=ht.European()),
                                           hm), mc).price)
    assert p_e - 0.05 <= p_b <= p_a + 0.05
    assert p_b > p_e + 0.3


def test_bermudan_guards():
    with pytest.raises(TypeError, match="European"):
        ht.solve(_berm_put(ht.Bermudan(QUARTERS)), ht.BlackScholesAnalytic(device=CPU))
    with pytest.raises(ValueError, match="outside"):
        ht.solve(_berm_put(ht.Bermudan((dt.date(2025, 6, 1),))), _crr(100))


HESTON_REF, HESTON_EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)


def _heston_put(style=None):
    market = ht.HestonInputs(HESTON_REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    return ht.PricingProblem(ht.VanillaOption(105.0, HESTON_EXPIRY, style or ht.American(),
                                              ht.Put(), ht.Spot()), market)


def _heston_lsm(strategy, n, steps, degree, seed=0, **kw):
    cfg = ht.SimulationConfig(n, steps, ht.Antithetic(), seed)
    return ht.LSM(ht.MonteCarlo(ht.HestonDynamics(), strategy, cfg, device=CPU), degree, **kw)


def test_conditional_grid_european_matches_carr_madan():
    prob = _heston_put(ht.European())
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device=CPU)).price)
    s_grid, v_grid = pmc.simulate_conditional_grid(
        prob, ht.SimulationConfig(1 << 14, 16, ht.Antithetic()), device=CPU)
    payoff = torch.mean(torch.clamp(105.0 - s_grid[:, -1, :], min=0.0))
    D = float(np.exp(-0.03 * ht.yearfrac(HESTON_REF, ht.to_ticks(HESTON_EXPIRY))))
    assert D * float(payoff) == pytest.approx(cm, rel=2e-2)
    assert bool((v_grid >= 0.0).all())


def test_conditional_lsm_vs_euler_and_qe_lsm():
    prob = _heston_put()
    p_cond = float(ht.solve(prob, _heston_lsm(ht.HestonQE(conditional=True), 1 << 14, 32, 3)).price)
    p_qe = float(ht.solve(prob, _heston_lsm(ht.HestonQE(), 1 << 14, 32, 4, seed=1)).price)
    p_euler = float(ht.solve(prob, _heston_lsm(ht.EulerMaruyama(), 1 << 14, 64, 4, seed=2)).price)
    assert p_cond == pytest.approx(p_qe, rel=2e-2)
    assert p_cond == pytest.approx(p_euler, rel=2e-2)


def test_conditional_lsm_american_premium_and_rao_blackwell():
    prob = _heston_put()
    method = _heston_lsm(ht.HestonQE(conditional=True), 1 << 13, 24, 3)
    p_am = float(ht.solve(prob, method).price)
    p_eu = float(ht.solve(_heston_put(ht.European()),
                          ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device=CPU)).price)
    assert p_am >= p_eu - 1e-2
    rb = _heston_lsm(ht.HestonQE(conditional=True), 1 << 14, 16, 3)
    plain = dataclasses.replace(rb, rao_blackwell=False)
    assert float(ht.solve(prob, rb).price) == pytest.approx(float(ht.solve(prob, plain).price),
                                                            rel=1e-2)


def test_rao_blackwell_terminal_target():
    prob = _heston_put()
    s_grid, v_grid = pmc.simulate_conditional_grid(
        prob, ht.SimulationConfig(1 << 13, 16, ht.Antithetic()), device=CPU)
    spots, vols = plsm._flatten_grid(s_grid), plsm._flatten_grid(v_grid)
    term = plsm.rb_terminal_value(prob, spots, vols).numpy()
    raw = prob.payoff(spots[-1]).numpy()
    np.testing.assert_allclose(term.mean(), raw.mean(), rtol=2e-2)
    assert term.var() < raw.var()


DUAL_REF, DUAL_EXP = dt.date(2024, 1, 1), dt.date(2024, 12, 31)


def _dual_lsm(trajectories=20_000, steps=24, degree=5, seed=0):
    cfg = ht.SimulationConfig(trajectories, steps, seed=seed)
    return ht.LSM(ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), cfg, device=CPU),
                  degree)


def _dual_put(style=None, cp=None, strike=110.0, sigma=0.3):
    return ht.PricingProblem(
        ht.VanillaOption(strike, DUAL_EXP, style or ht.American(), cp or ht.Put(), ht.Spot()),
        ht.BlackScholesInputs(DUAL_REF, 0.05, 100.0, sigma))


def _bracket(db, truth, k=3.0):
    lo, up = float(db.lower), float(db.upper)
    assert np.isfinite(lo) and np.isfinite(up) and lo <= up
    assert lo - k * float(db.se_lower) <= truth <= up + k * float(db.se_upper)


def test_dual_bound_brackets_crr():
    """tests/agreement/test_dual_bound.py's deep-ITM put at 12 steps and
    1024 × 48 nested paths (there: 24 steps, 4096 × 128): the interval
    brackets CRR(2000) within 3 SE, and the primal sits inside it."""
    prob = _dual_put()
    truth = float(ht.solve(prob, _crr(2000)).price)
    db = ht.lsm_dual_bound(prob, _dual_lsm(steps=12), n_outer=1024, n_inner=48)
    _bracket(db, truth)
    assert float(db.gap) < 0.05 * truth
    lo, up = float(db.lower), float(db.upper)
    assert lo - 3 * float(db.se_lower) <= float(db.primal) <= up + 3 * float(db.se_upper)


def test_dual_bound_call_without_dividends_is_european():
    prob = _dual_put(cp=ht.Call(), strike=100.0, sigma=0.2)
    euro = float(ht.solve(dataclasses.replace(prob, payoff=dataclasses.replace(
        prob.payoff, exercise_style=ht.European())), ht.BlackScholesAnalytic(device=CPU)).price)
    db = ht.lsm_dual_bound(prob, _dual_lsm(steps=12), n_outer=1024, n_inner=48)
    assert float(db.lower) - 3 * float(db.se_lower) <= euro
    assert float(db.upper) + 3 * float(db.se_upper) >= euro
    assert float(db.gap) < 0.06 * euro


def test_dual_bound_bermudan_brackets_lattice():
    dates = [dt.date(2024, 4, 1), dt.date(2024, 7, 1), dt.date(2024, 10, 1)]
    prob = _dual_put(ht.Bermudan(dates))
    truth = float(ht.solve(prob, _crr(2000)).price)
    amer = float(ht.solve(_dual_put(), _crr(2000)).price)
    db = ht.lsm_dual_bound(prob, _dual_lsm(steps=12), n_outer=1024, n_inner=48)
    _bracket(db, truth)
    assert float(db.lower) - 3 * float(db.se_lower) < amer


def test_dual_bound_misspecified_basis_widens_the_gap():
    """At the agreement test's own size (24 steps, 2048 × 64 nested paths):
    smaller ones let the inner sampling's inflation hide the basis."""
    prob = _dual_put()
    db_good = ht.lsm_dual_bound(prob, _dual_lsm(degree=5), n_outer=2048, n_inner=64)
    db_bad = ht.lsm_dual_bound(prob, _dual_lsm(degree=1), n_outer=2048, n_inner=64)
    assert float(db_bad.gap) > 1.5 * float(db_good.gap)


def test_dual_bound_smoke_bracket_small():
    prob = _dual_put()
    truth = float(ht.solve(prob, _crr(500)).price)
    db = ht.lsm_dual_bound(prob, _dual_lsm(6_000, 12, seed=3), n_outer=512, n_inner=32)
    _bracket(db, truth, k=4.0)


def test_dual_bound_heston_conditional_policy_certified():
    """The joint-basis conditional-LSM policy under the QE-bridge nested
    sampler brackets an independent Euler-grid LSM primal (there: 1024 ×
    64 nested paths; here 12 steps)."""
    market = ht.HestonInputs(DUAL_REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = ht.PricingProblem(ht.VanillaOption(110.0, DUAL_EXP, ht.American(), ht.Put(),
                                              ht.Spot()), market)
    lsm_c = ht.LSM(ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True),
                                 ht.SimulationConfig(20_000, 12, seed=0), device=CPU), degree=3)
    db = ht.lsm_dual_bound(prob, lsm_c, n_outer=1024, n_inner=64)
    lo, up = float(db.lower), float(db.upper)
    assert np.isfinite(lo) and np.isfinite(up) and lo <= up
    p_euler = float(ht.solve(prob, ht.LSM(ht.MonteCarlo(
        ht.HestonDynamics(), ht.EulerMaruyama(), ht.SimulationConfig(30_000, 48, seed=2),
        device=CPU), degree=4)).price)
    assert lo - 3 * float(db.se_lower) <= p_euler
    assert up + 3 * float(db.se_upper) >= p_euler - 0.05
    assert lo - 3 * float(db.se_lower) <= float(db.primal) <= up + 3 * float(db.se_upper)


def test_dual_bound_scope_guards():
    heston = ht.HestonInputs(DUAL_REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    put = _dual_put().payoff
    lsm_h = ht.LSM(ht.MonteCarlo(ht.HestonDynamics(), ht.EulerMaruyama(),
                                 ht.SimulationConfig(256, 8), device=CPU))
    with pytest.raises(TypeError, match="LognormalDynamics"):
        ht.lsm_dual_bound(ht.PricingProblem(put, heston), lsm_h, 128, 16)
    grid = dataclasses.replace(_dual_put(), payoff=dataclasses.replace(
        put, strike=np.array([100.0, 110.0])))
    with pytest.raises(TypeError, match="one contract"):
        ht.lsm_dual_bound(grid, _dual_lsm(256, 8), 128, 16)
