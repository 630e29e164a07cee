"""Early exercise (CRR lattice, LSM and its dual bound), the Monte Carlo
grids and per-path values they stand on, and the small solvers, against the
JAX package on the CPU.

Deterministic parts agree to rounding: the CRR lattice to 1e-12 (and the
goldens of tests/unit/test_binomial_tree.py to 1e-8), the grids and
``mc_path_values`` on the same Sobol' points to 1e-12, the backward
induction on a shared numpy grid to 1e-10, LSM ``solve`` under QMC to 1e-10
(the grid and the regression in float64 on both sides), linalg to 1e-12.
The statistical agreement checks run on the port alone in
tests/test_torch_american_agreement.py."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.math import linalg as jlinalg
from hedgehog_tpu.methods import lsm as jlsm
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.math import linalg as plinalg
from hedgehog_tpu_torch.methods import lsm as plsm
from hedgehog_tpu_torch.methods import montecarlo as pmc

REF = dt.date(2020, 1, 1)
EXPIRY_1Y = dt.date(2021, 1, 1)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the host's cores, and torch's default of a thread per core in each of
    them oversubscribes the CPU (a one-second LSM then takes minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mc(method):
    return dataclasses.replace(ht.from_reference(method), device=CPU)


def _cpu_lsm(method):
    port = ht.from_reference(method)
    return dataclasses.replace(port, mc_method=dataclasses.replace(port.mc_method, device=CPU))


def _crr(steps):
    return ht.CoxRossRubinsteinMethod(steps, device=CPU)


# -- (e) linalg ----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 6, 10])
def test_cholesky_solve_small_matches_reference(n):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n))
    A = m @ m.T + n * np.eye(n)
    b = rng.standard_normal(n)
    want = np.asarray(jlinalg.cholesky_solve_small(jnp.asarray(A), jnp.asarray(b)))
    got = plinalg.cholesky_solve_small(torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(A @ got, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("solver", ["tridiag_solve", "tridiag_solve_pcr"])
@pytest.mark.parametrize("n", [2, 7, 33])
def test_tridiagonal_solvers_match_reference(solver, n):
    rng = np.random.default_rng(100 + n)
    dl, du = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    d = 3.0 + rng.uniform(0, 1, n)
    b = rng.standard_normal(n)
    want = np.asarray(getattr(jlinalg, solver)(*(jnp.asarray(x) for x in (dl, d, du, b))))
    got = getattr(plinalg, solver)(*(torch.tensor(x) for x in (dl, d, du, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_interpolation_uses_the_thomas_solve():
    from hedgehog_tpu_torch.math import interpolation

    assert interpolation.tridiag_solve is plinalg.tridiag_solve


# -- (f) the CRR lattice ---------------------------------------------------------

GOLD_MARKET = hh.BlackScholesInputs(REF, 0.2, 1.0, 0.4)
GOLD_EXPIRY = dt.date(2020, 12, 31)


@pytest.mark.parametrize("cp, und, golden", [
    (hh.Call(), hh.Spot(), 0.25225758542934945),
    (hh.Put(), hh.Forward(), 0.07409148128021317),
], ids=["call_spot", "put_forward"])
def test_crr_goldens(cp, und, golden):
    prob = hh.PricingProblem(hh.VanillaOption(1.0, GOLD_EXPIRY, hh.American(), cp, und),
                             GOLD_MARKET)
    got = float(ht.solve(ht.from_reference(prob), _crr(80)).price)
    assert got == pytest.approx(golden, abs=1e-8)
    assert got == pytest.approx(float(hh.solve(prob, hh.CoxRossRubinsteinMethod(80)).price),
                                rel=1e-12)


QUARTERS_2020 = (dt.date(2020, 4, 1), dt.date(2020, 7, 1), dt.date(2020, 10, 1))


@pytest.mark.parametrize("style", [hh.European(), hh.American(), hh.Bermudan(QUARTERS_2020)],
                         ids=["european", "american", "bermudan"])
@pytest.mark.parametrize("und", [hh.Spot(), hh.Forward()], ids=["spot", "forward"])
@pytest.mark.parametrize("cp", [hh.Call(), hh.Put()], ids=["call", "put"])
def test_crr_matches_reference(style, und, cp):
    """A strike grid (the leading strike axis) under carry, every exercise
    style and underlying."""
    market = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.25, 0.02)
    prob = hh.PricingProblem(hh.VanillaOption(jnp.array([85.0, 100.0, 115.0]), EXPIRY_1Y, style,
                                              cp, und), market)
    want = np.asarray(hh.solve(prob, hh.CoxRossRubinsteinMethod(150)).price)
    got = ht.solve(ht.from_reference(prob), _crr(150)).price.numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_crr_per_strike_vols_from_a_surface():
    surf = hh.RectVolSurface(REF, jnp.array([0.5, 1.0, 2.0]), jnp.array([80.0, 100.0, 120.0]),
                             jnp.array([[0.3, 0.25, 0.22], [0.28, 0.24, 0.21],
                                        [0.27, 0.23, 0.2]]))
    prob = hh.PricingProblem(hh.VanillaOption(jnp.array([90.0, 110.0]), EXPIRY_1Y,
                                              hh.American(), hh.Put(), hh.Spot()),
                             hh.BlackScholesInputs(REF, 0.04, 100.0, surf))
    want = np.asarray(hh.solve(prob, hh.CoxRossRubinsteinMethod(120)).price)
    got = ht.solve(ht.from_reference(prob), _crr(120)).price.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_crr_converges_to_bs_and_american_dominates():
    payoff = ht.VanillaOption(1.1, GOLD_EXPIRY, ht.European(), ht.Put(), ht.Spot())
    market = ht.from_reference(GOLD_MARKET)
    prob = ht.PricingProblem(payoff, market)
    bs = float(ht.solve(prob, ht.BlackScholesAnalytic(device=CPU)).price)
    assert float(ht.solve(prob, _crr(100)).price) == pytest.approx(bs, abs=1e-3)
    amer = ht.PricingProblem(dataclasses.replace(payoff, exercise_style=ht.American()), market)
    assert float(ht.solve(amer, _crr(200)).price) >= float(ht.solve(prob, _crr(200)).price) - 1e-12


def test_crr_guards():
    heston = ht.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    put = ht.VanillaOption(100.0, EXPIRY_1Y, ht.American(), ht.Put(), ht.Spot())
    with pytest.raises(TypeError, match="Black-Scholes"):
        ht.solve(ht.PricingProblem(put, heston), _crr(10))
    # a barrier carries across and prices on the barrier lattices, which
    # monitor the spot only
    barrier = ht.from_reference(hh.PricingProblem(
        hh.BarrierOption(100.0, EXPIRY_1Y, 80.0, hh.American(), underlying=hh.Forward()),
        hh.BlackScholesInputs(REF, 0.03, 100.0, 0.2)))
    with pytest.raises(TypeError, match="monitors the spot"):
        ht.solve(barrier, _crr(10))


# -- Bermudan masks ----------------------------------------------------------------

BERM_REF, BERM_EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)
QUARTERS = (dt.date(2024, 4, 1), dt.date(2024, 7, 1), dt.date(2024, 10, 1))


@pytest.mark.parametrize("nsteps", [12, 48, 1000])
def test_bermudan_step_mask_matches_reference(nsteps):
    market = hh.BlackScholesInputs(BERM_REF, 0.05, 100.0, 0.25)
    style = hh.Bermudan(QUARTERS)
    want = np.asarray(hh.core.payoffs.bermudan_step_mask(style, market, BERM_EXPIRY, nsteps))
    got = ht.core.payoffs.bermudan_step_mask(ht.from_reference(style), ht.from_reference(market),
                                             ht.to_ticks(BERM_EXPIRY), nsteps)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    amer = ht.core.payoffs.bermudan_step_mask(ht.American(), ht.from_reference(market),
                                              ht.to_ticks(BERM_EXPIRY), nsteps)
    assert bool(amer.all())


# -- (d) (g) grids and per-path values ---------------------------------------------

BS_PROB = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY_1Y, hh.American(), hh.Put(), hh.Spot()),
                            hh.BlackScholesInputs(REF, 0.05, 100.0, 0.2))
HESTON_MARKET = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
HESTON_PROB = hh.PricingProblem(hh.VanillaOption(105.0, EXPIRY_1Y, hh.American(), hh.Put(),
                                                 hh.Spot()), HESTON_MARKET)
QMC = hh.SimulationConfig(512, 16, hh.Antithetic(), 3, True)


def _close(got, want, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dyn, strat, prob", [
    (hh.LognormalDynamics(), hh.EulerMaruyama(), BS_PROB),
    (hh.LognormalDynamics(), hh.BlackScholesExact(), BS_PROB),
    (hh.HestonDynamics(), hh.EulerMaruyama(), HESTON_PROB),
    (hh.HestonDynamics(), hh.HestonQE(), HESTON_PROB),
    (hh.HestonDynamics(), hh.HestonQE(conditional=True), HESTON_PROB),
], ids=["gbm_euler", "gbm_exact", "heston_euler", "heston_qe", "heston_conditional"])
def test_price_grids_match_reference(dyn, strat, prob):
    method = hh.MonteCarlo(dyn, strat, QMC)
    want = hh.simulate_price_grid(prob, method)
    got = ht.simulate_price_grid(ht.from_reference(prob), _cpu_mc(method))
    assert tuple(got.shape) == tuple(want.shape) == (2, 17, 512)
    _close(got, want)


@pytest.mark.parametrize("anti", [True, False], ids=["antithetic", "plain"])
def test_conditional_grid_matches_reference(anti):
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    cfg = hh.SimulationConfig(256, 12, vr, 5, True)
    s_want, v_want = jmc.simulate_conditional_grid(HESTON_PROB, cfg, point_offset=32)
    s_got, v_got = pmc.simulate_conditional_grid(ht.from_reference(HESTON_PROB),
                                                 ht.from_reference(cfg), point_offset=32,
                                                 device=CPU)
    _close(s_got, s_want)
    _close(v_got, v_want, atol=1e-15)


def test_gbm_euler_terminal_matches_reference():
    cfg = hh.SimulationConfig(1000, 7, hh.Antithetic(), 9, True)
    method = hh.MonteCarlo(hh.LognormalDynamics(), hh.EulerMaruyama(), cfg)
    euro = dataclasses.replace(BS_PROB, payoff=dataclasses.replace(BS_PROB.payoff,
                                                                   exercise_style=hh.European()))
    want = hh.simulate_terminal_prices(euro, method)
    got = ht.simulate_terminal_prices(ht.from_reference(euro), _cpu_mc(method))
    _close(got, want)
    grid = ht.simulate_price_grid(ht.from_reference(euro), _cpu_mc(method))
    assert torch.equal(grid[:, -1], got)


@pytest.mark.parametrize("dyn, strat, steps", [
    (hh.LognormalDynamics(), hh.BlackScholesExact(), 1),
    (hh.LognormalDynamics(), hh.EulerMaruyama(), 8),
    (hh.HestonDynamics(), hh.EulerMaruyama(), 8),
    (hh.HestonDynamics(), hh.HestonQE(), 8),
    (hh.HestonDynamics(), hh.HestonQE(conditional=True), 8),
    (hh.HestonDynamics(), hh.HestonExactMixing(), 2),
], ids=["gbm_exact", "gbm_euler", "heston_euler", "heston_qe", "qe_mixing", "exact_mixing"])
@pytest.mark.parametrize("grid", [False, True], ids=["scalar", "strikes"])
def test_mc_path_values_match_reference(dyn, strat, steps, grid):
    market = BS_PROB.market_inputs if isinstance(dyn, hh.LognormalDynamics) else HESTON_MARKET
    strike = jnp.array([90.0, 100.0, 110.0]) if grid else 100.0
    prob = hh.PricingProblem(hh.VanillaOption(strike, EXPIRY_1Y, hh.European(), hh.Call(),
                                              hh.Spot()), market)
    method = hh.MonteCarlo(dyn, strat, hh.SimulationConfig(512, steps, hh.Antithetic(), 2, True))
    want = jmc.mc_path_values(prob, method, point_offset=16)
    got = ht.mc_path_values(ht.from_reference(prob), _cpu_mc(method), point_offset=16)
    assert tuple(got.shape) == tuple(want.shape) == ((3, 512) if grid else (512,))
    _close(got, want, rtol=1e-11, atol=1e-12)


def test_grid_guards():
    prob = ht.from_reference(HESTON_PROB)
    bad = ht.MonteCarlo(ht.LognormalDynamics(), ht.HestonQE(conditional=True),
                        ht.from_reference(QMC), device=CPU)
    with pytest.raises(TypeError, match="HestonDynamics"):
        ht.simulate_price_grid(prob, bad)
    rb = ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(), ht.from_reference(QMC),
                       device=CPU)
    with pytest.raises(TypeError, match="unsupported grid"):
        ht.simulate_price_grid(prob, rb)


# -- (h) the backward induction on a shared grid ---------------------------------------


def _numpy_grid(paths=3000, steps=20, seed=7):
    rng = np.random.default_rng(seed)
    dt_ = 1.0 / steps
    z = rng.standard_normal((steps, paths))
    x = np.log(100.0) + np.cumsum((0.05 - 0.02) * dt_ + 0.2 * np.sqrt(dt_) * z, axis=0)
    spots = np.concatenate([np.full((1, paths), 100.0), np.exp(x)])
    vols = np.concatenate([np.full((1, paths), 0.04),
                           0.04 * np.exp(0.3 * np.cumsum(rng.standard_normal((steps, paths)), 0)
                                         * np.sqrt(dt_))])
    return spots, vols


@pytest.mark.parametrize("joint", [False, True], ids=["spot_basis", "joint_basis"])
@pytest.mark.parametrize("bermudan", [False, True], ids=["american", "bermudan"])
def test_backward_induction_on_a_shared_grid(joint, bermudan):
    spots, vols = _numpy_grid()
    payoff = hh.VanillaOption(105.0, EXPIRY_1Y, hh.American(), hh.Put(), hh.Spot())
    log_disc = np.log(np.exp(-0.05 / 20))
    mask = np.zeros(20, dtype=bool)
    mask[[5, 10, 15]] = True
    degree = 3 if joint else 5
    tau_j, val_j, beta_j = jlsm.lsm_backward_induction(
        jnp.asarray(spots), payoff, log_disc, degree, jnp.asarray(105.0),
        vols=jnp.asarray(vols) if joint else None,
        exercise_mask=jnp.asarray(mask) if bermudan else None, collect_betas=True)
    tau_p, val_p, beta_p = plsm.lsm_backward_induction(
        torch.tensor(spots), ht.from_reference(payoff), torch.tensor(log_disc), degree,
        torch.tensor(105.0), vols=torch.tensor(vols) if joint else None,
        exercise_mask=torch.tensor(mask) if bermudan else None, collect_betas=True)
    np.testing.assert_array_equal(tau_p.numpy(), np.asarray(tau_j))
    _close(val_p, val_j, rtol=1e-10)
    price_j = float(jnp.mean(jnp.exp(tau_j * log_disc) * val_j))
    price_p = float(torch.mean(torch.exp(tau_p * log_disc) * val_p))
    assert price_p == pytest.approx(price_j, rel=1e-10)
    assert tuple(beta_p.shape) == tuple(beta_j.shape)


# -- (i) LSM solve against JAX's -------------------------------------------------------


@pytest.mark.parametrize("case", ["gbm_exact", "gbm_euler_bermudan", "heston_conditional",
                                  "heston_conditional_plain_terminal", "heston_qe"])
def test_lsm_solve_matches_reference(case):
    cfg = hh.SimulationConfig(2048, 24, hh.Antithetic(), 1, True)
    if case.startswith("gbm"):
        strat = hh.BlackScholesExact() if case == "gbm_exact" else hh.EulerMaruyama()
        prob = BS_PROB
        if case == "gbm_euler_bermudan":
            prob = dataclasses.replace(prob, payoff=dataclasses.replace(
                prob.payoff, exercise_style=hh.Bermudan(QUARTERS_2020)))
        method = hh.LSM(hh.MonteCarlo(hh.LognormalDynamics(), strat, cfg), 5)
    else:
        strat = hh.HestonQE(conditional=case != "heston_qe")
        method = hh.LSM(hh.MonteCarlo(hh.HestonDynamics(), strat, cfg), 3,
                        rao_blackwell=case != "heston_conditional_plain_terminal")
        prob = HESTON_PROB
    want = hh.solve(prob, method)
    got = ht.solve(ht.from_reference(prob), _cpu_lsm(method))
    assert isinstance(got, ht.LSMSolution)
    assert float(got.price) == pytest.approx(float(want.price), rel=1e-10)
    np.testing.assert_array_equal(got.stopping_info[0].numpy(), np.asarray(want.stopping_info[0]))
    _close(got.spot_paths, want.spot_paths)


def test_rb_terminal_value_matches_reference():
    cfg = hh.SimulationConfig(512, 16, hh.Antithetic(), 0, True)
    s_j, v_j = jmc.simulate_conditional_grid(HESTON_PROB, cfg)
    spots, vols = jlsm._flatten_grid(s_j), jlsm._flatten_grid(v_j)
    want = jlsm.rb_terminal_value(HESTON_PROB, spots, vols)
    got = plsm.rb_terminal_value(ht.from_reference(HESTON_PROB), torch.tensor(np.asarray(spots)),
                                 torch.tensor(np.asarray(vols)))
    _close(got, want, rtol=1e-11, atol=1e-13)


# -- interop and the entry points' default device ------------------------------------------


def test_from_reference_carries_the_new_classes():
    method = hh.LSM(hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), QMC), 3,
                    rao_blackwell=False)
    port = ht.from_reference(method)
    assert isinstance(port, ht.LSM) and port.degree == 3 and not port.rao_blackwell
    assert isinstance(ht.from_reference(hh.CoxRossRubinsteinMethod(77)),
                      ht.CoxRossRubinsteinMethod)
    style = ht.from_reference(hh.Bermudan(QUARTERS))
    assert isinstance(style, ht.Bermudan) and style.exercise_dates == hh.Bermudan(
        QUARTERS).exercise_dates


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    prob = ht.from_reference(BS_PROB)
    mc = ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), ht.SimulationConfig(64, 4))
    calls = [
        lambda: ht.solve(prob, ht.CoxRossRubinsteinMethod(10)),
        lambda: ht.solve(prob, ht.LSM(mc)),
        lambda: ht.lsm_dual_bound(prob, ht.LSM(mc), 16, 4),
        lambda: ht.simulate_price_grid(prob, mc),
        lambda: ht.mc_path_values(dataclasses.replace(prob, payoff=dataclasses.replace(
            prob.payoff, exercise_style=ht.European())), mc),
        lambda: pmc.simulate_conditional_grid(ht.from_reference(HESTON_PROB),
                                              ht.SimulationConfig(64, 4)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
