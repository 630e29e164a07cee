"""The barrier and knock-in LSM estimators against the JAX package on the
CPU.

``lsm_backward_induction``'s barrier branches on one shared numpy grid with
the same survival factors (knock-outs: rebate legs, first-passage exercise,
Bermudan masks, the joint basis; knock-ins: the barrier-localized fit):
the stopping steps equal, values and the knock-in's barrier values to rtol
1e-10; with the guards.  The solves against JAX's are in
tests/test_torch_barrier_lsm_solves.py, the statistical cases of the JAX
agreement suite in tests/test_torch_barrier_lsm_agreement.py."""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import lsm as jlsm
from hedgehog_tpu_torch.methods import lsm as plsm

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs six workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=1e-13)


# -- the induction on a shared grid ---------------------------------------------------------


def _shared_grid(paths=1000, steps=16, seed=11):
    """A GBM grid, a variance grid and the bridge survival factors of a
    down barrier at 85, in numpy."""
    rng = np.random.default_rng(seed)
    dt_ = 1.0 / steps
    z = rng.standard_normal((steps, paths))
    x = np.log(100.0) + np.cumsum((0.05 - 0.5 * 0.0625) * dt_ + 0.25 * np.sqrt(dt_) * z, axis=0)
    spots = np.concatenate([np.full((1, paths), 100.0), np.exp(x)])
    vols = np.concatenate([np.full((1, paths), 0.0625),
                           0.0625 * np.exp(0.3 * np.cumsum(rng.standard_normal((steps, paths)),
                                                           0) * np.sqrt(dt_))])
    lg = np.log(spots)
    d0, d1 = lg[:-1] - np.log(85.0), lg[1:] - np.log(85.0)
    inside = (d0 > 0) & (d1 > 0)
    surv = np.where(inside, -np.expm1(np.where(inside, -2 * d0 * d1 / (0.0625 * dt_), 0.0)), 0.0)
    return spots, vols, surv, np.log(np.exp(-0.05 * dt_))


KO_CASES = {
    "rebate at expiry": dict(rebate=(2.0, False)),
    "rebate at hit, first passage": dict(rebate=(2.0, True), hit=True),
    "first passage, no rebate": dict(rebate=(0.0, False), hit=True),
    "bermudan, rebate at hit": dict(rebate=(1.0, True), bermudan=True),
    "joint basis, first passage": dict(rebate=(0.5, False), hit=True, joint=True),
}


@pytest.mark.parametrize("name", sorted(KO_CASES))
def test_knock_out_induction_on_a_shared_grid(name):
    case = KO_CASES[name]
    spots, vols, surv, log_disc = _shared_grid()
    payoff = hh.BarrierOption(110.0, EXPIRY, 85.0, hh.American(), hh.Put())
    mask = np.zeros(16, dtype=bool)
    mask[[4, 8, 12]] = True
    degree = 2 if case.get("joint") else 4
    hit = payoff(jnp.asarray(85.0)) if case.get("hit") else None
    out_j = jlsm.lsm_backward_induction(
        jnp.asarray(spots), payoff, log_disc, degree, jnp.asarray(110.0),
        vols=jnp.asarray(vols) if case.get("joint") else None, surv_factors=jnp.asarray(surv),
        rebate_spec=case["rebate"], exercise_mask=jnp.asarray(mask) if case.get("bermudan")
        else None, hit_exercise_value=hit)
    out_p = plsm.lsm_backward_induction(
        torch.tensor(spots), ht.from_reference(payoff), torch.tensor(log_disc), degree,
        torch.tensor(110.0), vols=torch.tensor(vols) if case.get("joint") else None,
        surv_factors=torch.tensor(surv), rebate_spec=case["rebate"],
        exercise_mask=torch.tensor(mask) if case.get("bermudan") else None,
        hit_exercise_value=None if hit is None else torch.tensor(float(hit)))
    assert len(out_p) == len(out_j) == 4
    np.testing.assert_array_equal(out_p[0].numpy(), np.asarray(out_j[0]))
    for got, want in zip(out_p[1:], out_j[1:]):  # value, fsurv, rleg
        _close(got, want, 1e-10)


@pytest.mark.parametrize("joint", [False, True], ids=["spot_basis", "joint_basis"])
@pytest.mark.parametrize("bermudan", [False, True], ids=["american", "bermudan"])
def test_knock_in_induction_on_a_shared_grid(joint, bermudan):
    spots, vols, _, log_disc = _shared_grid()
    payoff = hh.BarrierOption(110.0, EXPIRY, 85.0, hh.American(), hh.Put(), knock=hh.KnockIn())
    mask = np.zeros(16, dtype=bool)
    mask[[4, 8, 12]] = True
    degree = 2 if joint else 4
    h_scaled, intrinsic_h = 85.0 / 110.0, 25.0
    tau_j, val_j, ys_j = jlsm.lsm_backward_induction(
        jnp.asarray(spots), payoff, log_disc, degree, jnp.asarray(110.0),
        vols=jnp.asarray(vols) if joint else None,
        exercise_mask=jnp.asarray(mask) if bermudan else None,
        barrier_eval=(jnp.asarray(h_scaled), jnp.asarray(intrinsic_h)))
    tau_p, val_p, ys_p = plsm.lsm_backward_induction(
        torch.tensor(spots), ht.from_reference(payoff), torch.tensor(log_disc), degree,
        torch.tensor(110.0), vols=torch.tensor(vols) if joint else None,
        exercise_mask=torch.tensor(mask) if bermudan else None,
        barrier_eval=(torch.tensor(h_scaled), torch.tensor(intrinsic_h)))
    np.testing.assert_array_equal(tau_p.numpy(), np.asarray(tau_j))
    _close(val_p, val_j, 1e-10)
    assert tuple(ys_p.shape) == tuple(ys_j.shape) == ((15, 1000) if joint else (15,))
    _close(ys_p, ys_j, 1e-10)


def test_induction_guards():
    spots, _, surv, log_disc = _shared_grid(paths=64, steps=4)
    payoff = ht.BarrierOption(110.0, EXPIRY, 85.0, ht.American(), ht.Put())
    args = (torch.tensor(spots), payoff, torch.tensor(log_disc), 2, torch.tensor(110.0))
    with pytest.raises(TypeError, match="barrier_eval is for knock-ins"):
        plsm.lsm_backward_induction(*args, surv_factors=torch.tensor(surv),
                                    barrier_eval=(torch.tensor(0.8), torch.tensor(25.0)))
    with pytest.raises(TypeError, match="plain vanilla grids only"):
        plsm.lsm_backward_induction(*args, surv_factors=torch.tensor(surv), collect_betas=True)


def _mc(market=None, steps=32, paths=1 << 12, heston=False, qmc=True):
    cfg = ht.SimulationConfig(paths, steps, ht.Antithetic(), 0, qmc)
    if heston:
        return ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True), cfg, device=CPU)
    return ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(), cfg, device=CPU)


def _bs():
    return ht.BlackScholesInputs(REF, 0.05, 100.0, 0.25)


def _solve(payoff, market, method) -> float:
    return float(ht.solve(ht.PricingProblem(payoff, market), method).price)


def _amer_ko(**kw):
    kw.setdefault("strike", 110.0)
    kw.setdefault("direction", ht.Down())
    kw.setdefault("call_put", ht.Put())
    return ht.BarrierOption(expiry=EXPIRY, exercise_style=ht.American(), knock=ht.KnockOut(),
                            **kw)


# -- guards ---------------------------------------------------------------------------------


def test_guards():
    mc = _mc(steps=8, paths=256)
    with pytest.raises(TypeError, match="monitors the spot"):
        _solve(_amer_ko(barrier=80.0, underlying=ht.Forward()), _bs(), ht.LSM(mc, 2))
    with pytest.raises(TypeError, match=r"one \(strike, barrier\) pair"):
        _solve(_amer_ko(barrier=np.array([80.0, 85.0])), _bs(), ht.LSM(mc, 2))
    with pytest.raises(TypeError, match="running-average"):
        _solve(ht.AsianOption(100.0, EXPIRY, 8, exercise_style=ht.American()), _bs(),
               ht.LSM(mc, 2))
    with pytest.raises(TypeError, match="single-barrier survival state"):
        _solve(ht.DoubleBarrierOption(100.0, EXPIRY, 80.0, 120.0, ht.American()), _bs(),
               ht.LSM(mc, 2))
    heston_euler = ht.MonteCarlo(ht.HestonDynamics(), ht.EulerMaruyama(),
                                 ht.SimulationConfig(256, 8, seed=0), device=CPU)
    hm = ht.HestonInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    with pytest.raises(TypeError, match="barrier grids need"):
        _solve(_amer_ko(barrier=80.0), hm, ht.LSM(heston_euler, 2))
    with pytest.raises(TypeError):
        ht.lsm_dual_bound(ht.PricingProblem(_amer_ko(barrier=80.0), _bs()), ht.LSM(mc, 2),
                          n_outer=16, n_inner=4)
