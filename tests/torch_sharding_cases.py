"""The sharded pricers' cases for tests/test_torch_sharding.py, and the
checks its ranks run.

The cases are built from a package namespace (``hedgehog_tpu`` or
``hedgehog_tpu_torch``: both export the same names), so the test's parent
process builds the JAX counterparts of exactly what the ranks price.  This
module imports neither package itself: the ranks, spawned processes that
import it by name, never import JAX.
"""

import datetime as dt

import numpy as np

REF, EXPIRY = dt.date(2020, 1, 1), dt.date(2021, 1, 1)
HESTON = (0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)  # r, spot, V0, kappa, theta, sigma, rho
BS = (0.05, 100.0, 0.20)  # r, spot, sigma
GRID = np.array([90.0, 100.0, 110.0])
EXPIRIES = [dt.date(2020, 7, 1), EXPIRY]
N_RANKS = 4

#: name → (market, strike, dynamics, strategy, SimulationConfig arguments):
#: the QMC cases whose sharded price equals the single-device solve
#: (tests/unit/test_review_fixes.py:167, tests/agreement/test_exact_mixing.py:186,
#: test_conditional_mc.py:115 and :195)
QMC_CASES = {
    "bs exact": ("bs", 100.0, "LognormalDynamics", ("BlackScholesExact",), (32_768, 1, False, 3)),
    "exact mixing": ("heston", 100.0, "HestonDynamics", ("HestonExactMixing",),
                     (16_384, 2, True, 7)),
    "qe mixing": ("heston", 100.0, "HestonDynamics", ("HestonQE", True), (16_384, 8, True, 7)),
    "qe mixing strike grid": ("heston", GRID, "HestonDynamics", ("HestonQE", True),
                              (16_384, 8, True, 7)),
}


def market(ns, kind: str, rate=None, spot=None, sigma=None):
    if kind == "bs":
        r, s, v = BS
        return ns.BlackScholesInputs(REF, r if rate is None else rate, s if spot is None else spot,
                                     v if sigma is None else sigma)
    return ns.HestonInputs(REF, *HESTON)


def problem(ns, kind: str, strike=100.0, **market_kw):
    payoff = ns.VanillaOption(strike, EXPIRY, ns.European(), ns.Call(), ns.Spot())
    return ns.PricingProblem(payoff, market(ns, kind, **market_kw))


def config(ns, trajectories, steps, antithetic, seed, qmc=True):
    vr = ns.Antithetic() if antithetic else ns.NoVarianceReduction()
    return ns.SimulationConfig(trajectories=trajectories, steps=steps, variance_reduction=vr,
                               seed=seed, qmc=qmc)


def method(ns, dynamics, strategy, cfg, **device):
    name, *args = strategy
    return ns.MonteCarlo(getattr(ns, dynamics)(), getattr(ns, name)(*args), cfg, **device)


def qmc_case(ns, name: str, **device):
    kind, strike, dynamics, strategy, cfg = QMC_CASES[name]
    return problem(ns, kind, strike), method(ns, dynamics, strategy, config(ns, *cfg), **device)


def bs_prng(ns, trajectories=80_000, **device):
    """tests/unit/test_sharding.py:43: 80k exact lognormal paths, PRNG."""
    return problem(ns, "bs"), method(ns, "LognormalDynamics", ("BlackScholesExact",),
                                     config(ns, trajectories, 1, False, 0, qmc=False), **device)


def heston_euler_prng(ns, trajectories=40_000, steps=50, seed=1, **device):
    """tests/unit/test_sharding.py:55: Heston Euler, PRNG, antithetic."""
    return problem(ns, "heston"), method(ns, "HestonDynamics", ("EulerMaruyama",),
                                         config(ns, trajectories, steps, True, seed, qmc=False),
                                         **device)


def american_put(ns, kind: str, barrier=None):
    if barrier is not None:
        payoff = ns.BarrierOption(100.0, EXPIRY, barrier, ns.American(), ns.Call(), ns.Spot(),
                                  ns.Up(), ns.KnockOut())
    else:
        payoff = ns.VanillaOption(100.0, EXPIRY, ns.American(), ns.Put(), ns.Spot())
    return ns.PricingProblem(payoff, market(ns, kind))


def bs_lsm(ns, **device):
    """tests/unit/test_sharding.py:102: LSM degree 4 on 16k antithetic
    exact lognormal paths of 50 steps."""
    return ns.LSM(method(ns, "LognormalDynamics", ("BlackScholesExact",),
                         config(ns, 16_000, 50, True, 0, qmc=False), **device), 4)


def conditional_lsm(ns, seed=0, **device):
    """tests/agreement/test_conditional_lsm.py:77: the conditional Heston
    grid, 8k pairs of 16 steps, degree 3."""
    return ns.LSM(method(ns, "HestonDynamics", ("HestonQE", True),
                         config(ns, 8 * 1024, 16, True, seed, qmc=False), **device), 3)


def family_cases(ns, **device):
    """tests/unit/test_sharding.py:122-162: (name, problem, method) of the
    model families that shard through ``mc_path_values``."""
    ref, exp = dt.date(2024, 1, 1), dt.date(2024, 12, 31)
    opt = ns.VanillaOption(100.0, exp, ns.European(), ns.Call(), ns.Spot())

    def mc(dyn, strat, paths, steps):
        return ns.MonteCarlo(dyn, strat, config(ns, paths, steps, True, 0, qmc=False), **device)

    return [(name, ns.PricingProblem(opt, mkt), m) for name, mkt, m in [
        ("merton", ns.MertonInputs(ref, 0.03, 100.0, 0.2, 0.5, -0.1, 0.15),
         mc(ns.MertonJumpDynamics(), ns.MertonExact(), 1 << 13, 1)),
        ("sabr", ns.SABRInputs(ref, 0.03, 100.0, 0.2, 0.7, -0.3, 0.4),
         mc(ns.SABRDynamics(), ns.EulerMaruyama(), 1 << 12, 16)),
        ("bachelier", ns.BachelierInputs(ref, 0.03, 100.0, 20.0),
         mc(ns.NormalDynamics(), ns.BachelierExact(), 1 << 13, 1)),
        ("rough bergomi", ns.RoughBergomiInputs(ref, 0.03, 100.0, 0.04, 1.5, 0.1, -0.7),
         mc(ns.RoughBergomiDynamics(), ns.RoughBergomiMixing(), 1 << 12, 16)),
        ("heston hull white", ns.HestonHullWhiteInputs(ref, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3,
                                                       -0.6, 0.1, 0.012, -0.3),
         mc(ns.HestonHullWhiteDynamics(), ns.HestonQE(conditional=True), 1 << 12, 12)),
    ]]


def bs_greek_leaves(torch):
    """(rate, spot, sigma) float64 leaves that require grad."""
    return tuple(torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in BS)


def surface_cases(ns, **device):
    """(name, method, strikes): tests/agreement/test_conditional_mc.py:295
    (QE) and test_exact_mixing.py:249 (exact)."""
    return [
        ("qe", method(ns, "HestonDynamics", ("HestonQE", True), config(ns, 16_384, 12, True, 3),
                      **device), GRID),
        ("exact", method(ns, "HestonDynamics", ("HestonExactMixing",),
                         config(ns, 8192, 4, True, 9), **device), np.array([95.0, 105.0])),
    ]


def _refused(fn, exc_type) -> str:
    """The message of the ``exc_type`` that ``fn()`` raises, or '' when it
    returns."""
    try:
        fn()
    except exc_type as exc:
        return str(exc)
    return ""


def rank_checks() -> dict:
    """Every sharded call of the test, on this rank of a 4-rank gloo group
    on the CPU; returns plain numbers and messages for the parent to hold
    against its single-device references."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.parallel import (
        make_multislice_mesh,
        make_paths_mesh,
        sharded_lsm_price,
        sharded_lsm_price_fn,
        sharded_mc_price,
        sharded_mc_price_fn,
        sharded_mc_price_multislice_fn,
        sharded_surface_fn,
    )

    cpu = dict(device="cpu")
    mesh, mesh2d = make_paths_mesh(), make_multislice_mesh(2)
    out = {"mesh2d": dict(zip(mesh2d.mesh_dim_names, mesh2d.shape))}
    for name in QMC_CASES:
        prob, m = qmc_case(ht, name, **cpu)
        out[f"qmc {name}"] = sharded_mc_price(prob, m, mesh).tolist()
    prob, m = qmc_case(ht, "exact mixing", **cpu)
    out["qmc exact mixing multislice"] = float(sharded_mc_price_multislice_fn(m, mesh2d)(prob))

    # the 3-leaf gradient: spot and sigma through the paths, the rate through
    # the drift and the discount taken after the sum
    for label, fn in (("1-D", sharded_mc_price_fn), ("multislice", sharded_mc_price_multislice_fn)):
        for qmc in (True, False):
            cfg = config(ht, 8 * 1024, 1, False, 0, qmc=qmc)
            m = method(ht, "LognormalDynamics", ("BlackScholesExact",), cfg, **cpu)
            leaves = bs_greek_leaves(torch)
            rate, spot, sigma = leaves
            price = fn(m, mesh if label == "1-D" else mesh2d)(
                problem(ht, "bs", rate=rate, spot=spot, sigma=sigma))
            out[f"grad {label} qmc={qmc}"] = [float(g) for g in torch.autograd.grad(price, leaves)]

    prob, m = bs_prng(ht, **cpu)
    out["prng bs"] = [float(sharded_mc_price(prob, m, mesh)) for _ in range(2)]
    prob, m = heston_euler_prng(ht, **cpu)
    out["prng heston euler"] = float(sharded_mc_price(prob, m, mesh))
    prob, m = heston_euler_prng(ht, 4 * 512, 4, 7, **cpu)
    out["prng euler 1-D"] = float(sharded_mc_price(prob, m, mesh))
    out["prng euler multislice"] = float(sharded_mc_price_multislice_fn(m, mesh2d)(prob))

    prob, lsm = american_put(ht, "bs"), bs_lsm(ht, **cpu)
    out["lsm"] = [float(sharded_lsm_price(prob, lsm, mesh)) for _ in range(2)]
    out["conditional lsm"] = float(sharded_lsm_price_fn(conditional_lsm(ht, **cpu), mesh)(
        american_put(ht, "heston")))
    out["refused barrier"] = _refused(
        lambda: sharded_lsm_price(american_put(ht, "bs", barrier=120.0), lsm, mesh), TypeError)
    prob, m = bs_prng(ht, 1001, **cpu)
    out["refused uneven"] = _refused(lambda: sharded_mc_price(prob, m, mesh), ValueError)
    out["refused slices"] = _refused(lambda: make_multislice_mesh(3), ValueError)

    out["families"] = {name: float(sharded_mc_price(prob, m, mesh))
                       for name, prob, m in family_cases(ht, **cpu)}
    out["surfaces"] = {name: sharded_surface_fn(m, mesh)(market(ht, "heston"), EXPIRIES,
                                                         torch.as_tensor(strikes)).tolist()
                       for name, m, strikes in surface_cases(ht, **cpu)}
    return out


def one_over_rank() -> float:
    """1 / rank: rank 0 raises ZeroDivisionError."""
    import torch.distributed as dist

    return 1 / dist.get_rank()
