"""Path sharding over torch.distributed (hedgehog_tpu_torch.parallel) on 4
gloo ranks on the CPU, against the single-device port and the JAX package's
single-device ``solve``.

One module fixture spawns the 4 ranks once (``run_ranks``: a file://
rendezvous in a temporary directory, a 300 s limit on each collective and
on the whole call, every rank terminated when one fails or the limit
passes); they run every
sharded call of ``torch_sharding_cases.rank_checks`` and return numbers.
No ``shard_map`` of JAX runs here: under QMC the JAX package's own contract
is that its sharded price equals its single-device ``solve``
(tests/unit/test_review_fixes.py:167, rel 1e-12), so the port's sharded
prices are held against that ``solve``.

Tolerances: sharded and single-device sums add the same float64 values in
another order, rel 1e-12 for prices (1e-10 for surfaces and gradients,
whose terms cancel more); the port against JAX rel 1e-10 (prices; the
float64 estimators agree to ~1e-13 on the same points) and 1e-8 (the
gradient, as test_torch_greeks.py); PRNG runs within 4 standard errors of
the closed form or Carr-Madan (the JAX tests' statistical checks)."""

import math

import jax
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
import torch_sharding_cases as cases
from hedgehog_tpu_torch.parallel import make_multislice_mesh, make_paths_mesh
from hedgehog_tpu_torch.parallel.dryrun import dryrun_multichip, lsm_replay, run_ranks

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results; the replicated ones must agree across ranks."""
    return run_ranks(cases.N_RANKS, cases.rank_checks, backend="gloo", timeout=300.0)


@pytest.fixture(scope="module")
def rank0(ranks):
    return ranks[0]


def _same_on_every_rank(ranks, key):
    for r, out in enumerate(ranks[1:], start=1):
        assert out[key] == ranks[0][key], (key, r)
    return ranks[0][key]


def _rel(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol, atol=0.0)


def _se(prob, method) -> float:
    """The standard error of ``method``'s price at its size, from one
    single-device run of the same estimator."""
    from hedgehog_tpu_torch.methods.montecarlo import reduce_payoffs

    pay = reduce_payoffs(ht.solve(prob, method).ensemble, prob.payoff)
    return float(torch.std(pay)) / math.sqrt(pay.numel()) * _discount(prob)


def _discount(prob) -> float:
    from hedgehog_tpu_torch.market.rate_curve import df

    return float(df(prob.market_inputs.rate, prob.payoff.expiry))


@pytest.mark.parametrize("name", list(cases.QMC_CASES))
def test_qmc_sharded_price_equals_the_single_device_solve(ranks, name):
    got = _same_on_every_rank(ranks, f"qmc {name}")
    _rel(got, ht.solve(*cases.qmc_case(ht, name, **CPU)).price, 1e-12)


@pytest.mark.parametrize("name", list(cases.QMC_CASES))
def test_qmc_sharded_price_equals_the_jax_solve(rank0, name):
    _rel(rank0[f"qmc {name}"], hh.solve(*cases.qmc_case(hh, name)).price, 1e-10)


def test_multislice_qmc_price_equals_the_solve(ranks):
    got = _same_on_every_rank(ranks, "qmc exact mixing multislice")
    _rel(got, ht.solve(*cases.qmc_case(ht, "exact mixing", **CPU)).price, 1e-12)
    _rel(got, ranks[0]["qmc exact mixing"], 1e-12)


@pytest.mark.parametrize("name", ["qe", "exact"])
def test_sharded_surface_equals_the_single_device_surface(ranks, name):
    method, strikes = next((m, k) for n, m, k in cases.surface_cases(ht, **CPU) if n == name)
    want = ht.heston_surface_mc(cases.market(ht, "heston"), cases.EXPIRIES, strikes,
                                method.config, strategy=method.strategy, **CPU)
    for out in ranks:
        _rel(out["surfaces"][name], want, 1e-10)


def test_sharded_gradient_equals_the_single_device_gradient(ranks):
    """(d/dr, delta, vega) of the QMC lognormal price: the sharded gradient
    on every rank equals the single-device one; a backward that also summed
    the cotangent over the ranks would give 4x, and a discount whose rate
    gradient were summed over the ranks would add 3x its d/dr term."""
    leaves = cases.bs_greek_leaves(torch)
    rate, spot, sigma = leaves
    cfg = cases.config(ht, 8 * 1024, 1, False, 0, qmc=True)
    m = cases.method(ht, "LognormalDynamics", ("BlackScholesExact",), cfg, **CPU)
    price = ht.solve(cases.problem(ht, "bs", rate=rate, spot=spot, sigma=sigma), m).price
    want = [float(g) for g in torch.autograd.grad(price, leaves)]
    got = _same_on_every_rank(ranks, "grad 1-D qmc=True")
    _rel(got, want, 1e-10)

    jm = cases.method(hh, "LognormalDynamics", ("BlackScholesExact",),
                      cases.config(hh, 8 * 1024, 1, False, 0, qmc=True))
    jax_grad = jax.grad(lambda r, s, v: hh.solve(cases.problem(hh, "bs", rate=r, spot=s, sigma=v),
                                                 jm).price, argnums=(0, 1, 2))(*cases.BS)
    _rel(got, [float(g) for g in jax_grad], 1e-8)


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_multislice_gradient_equals_the_1d_gradient(ranks, qmc):
    """tests/unit/test_sharding.py:202-216: the gradient through both sums."""
    got = _same_on_every_rank(ranks, f"grad multislice qmc={qmc}")
    _rel(got, ranks[0][f"grad 1-D qmc={qmc}"], 1e-10)


def test_multislice_mesh_and_price(ranks):
    """tests/unit/test_sharding.py:165-199: the 2 x 2 mesh; global-index
    streams make the multi-slice price the 1-D one; against the unsharded
    PRNG solve the agreement is statistical."""
    assert ranks[0]["mesh2d"] == {"slice": 2, "paths": 2}
    got = _same_on_every_rank(ranks, "prng euler multislice")
    _rel(got, ranks[0]["prng euler 1-D"], 1e-12)
    prob, m = cases.heston_euler_prng(ht, 4 * 512, 4, 7, **CPU)
    assert got == pytest.approx(float(ht.solve(prob, m).price), rel=4e-2)


def test_prng_prices_within_four_standard_errors(ranks):
    """tests/unit/test_sharding.py:43-66: the sharded PRNG prices against the
    Black-Scholes formula and Carr-Madan, and the same on a second call."""
    first, second = _same_on_every_rank(ranks, "prng bs")
    assert first == second
    prob, m = cases.bs_prng(ht, **CPU)
    bs = float(ht.solve(prob, ht.BlackScholesAnalytic(**CPU)).price)
    assert abs(first - bs) <= 4 * _se(prob, m)
    got = _same_on_every_rank(ranks, "prng heston euler")
    prob, m = cases.heston_euler_prng(ht, **CPU)
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, 32.0, ht.HestonDynamics(), **CPU)).price)
    # 50 Euler steps: the scheme's bias beside 4 SE (test_sharding.py allows 5%)
    assert abs(got - cm) <= 4 * _se(prob, m) + 5e-3 * cm


def test_per_rank_philox_streams_are_uncorrelated():
    """tests/unit/test_sharding.py:83-91: the normals of device_id 0-7 (a
    rank's key is (seed, device_id))."""
    from hedgehog_tpu_torch.ops.gbm_kernel import gbm_normals

    blocks = [gbm_normals(20_000, 0, i, "cpu", torch.float64) for i in range(8)]
    corr = torch.corrcoef(torch.stack(blocks))
    off = corr[~torch.eye(8, dtype=torch.bool)]
    assert float(off.abs().max()) < 0.03


def test_sharded_lsm_equals_its_replay_and_the_lattice(ranks):
    """tests/unit/test_sharding.py:102-119 and the dry run's phase 3: the
    global regression over the ranks' grids is the regression over their
    concatenation on one device."""
    first, second = _same_on_every_rank(ranks, "lsm")
    assert first == second
    prob, lsm = cases.american_put(ht, "bs"), cases.bs_lsm(ht, **CPU)
    _rel(first, lsm_replay(prob, lsm, cases.N_RANKS, "cpu"), 1e-8)
    crr = float(ht.solve(prob, ht.CoxRossRubinsteinMethod(500, **CPU)).price)
    assert first == pytest.approx(crr, rel=2.5e-2)


def test_sharded_conditional_lsm_matches_the_unsharded_scale(ranks):
    """tests/agreement/test_conditional_lsm.py:77: other streams, so 3%."""
    got = _same_on_every_rank(ranks, "conditional lsm")
    single = float(ht.solve(cases.american_put(ht, "heston"),
                            cases.conditional_lsm(ht, seed=7, **CPU)).price)
    assert got == pytest.approx(single, rel=3e-2)


@pytest.mark.parametrize("key,match", [("refused barrier", "barrier survival state"),
                                       ("refused uneven", "divide evenly"),
                                       ("refused slices", "do not divide into 3 slices")])
def test_sharded_refusals(rank0, key, match):
    """tests/agreement/test_american_barrier.py:166 and test_sharding.py:94-99
    and :219-223, raised in the ranks."""
    assert match in rank0[key]


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_paths_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_multislice_mesh(2)


@pytest.mark.parametrize("name", ["merton", "sabr", "bachelier", "rough bergomi",
                                  "heston hull white"])
def test_model_families_shard(rank0, name):
    """tests/unit/test_sharding.py:122-162: independent per-rank streams, so
    statistical agreement with the single-device solve."""
    prob, m = next((p, m) for n, p, m in cases.family_cases(ht, **CPU) if n == name)
    assert rank0["families"][name] == pytest.approx(float(ht.solve(prob, m).price), rel=4e-2)


def test_dryrun_multichip_on_cpu(capsys):
    """The five phases of the dry run on 4 gloo ranks; each checks itself
    against its replay or the solve and prints one line."""
    out = dryrun_multichip(cases.N_RANKS, device="cpu", timeout=300.0)
    assert list(out) == [f"phase {k}" for k in range(1, 6)]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "dryrun_multichip(4)" in ln]
    assert len(lines) == 5 and all("ok" in ln for ln in lines)


@pytest.mark.parametrize("kernel", ["K2", "K7"])
def test_plain_twins_compose_over_disjoint_slices(kernel):
    """tests/unit/test_sharding.py:248-273 and
    test_qe_kernel_qmc.py::test_qmc_kernel_sharded_offsets_disjoint: 4
    disjoint point_offset slices of one Sobol' sequence, concatenated, are
    the full-range call bit for bit (the twins here, the kernels on the
    card in tests/test_torch_cuda.py)."""
    from hedgehog_tpu_torch.ops.heston_exact_kernel import heston_exact_mixing_values
    from hedgehog_tpu_torch.ops.heston_qe_kernel import heston_qe_mixing_values

    args = (math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7)
    if kernel == "K2":
        fn, args, kw = heston_exact_mixing_values, (*args, 1.0 / 2, 100.0, 1.0), dict(segments=2)
    else:
        fn, args, kw = heston_qe_mixing_values, (*args, 1.0 / 11, 100.0, 1.0), dict(steps=11)
    per = 2048
    kw.update(seed=5, antithetic=True, qmc=True, device="cpu")
    full = fn(*args, n_paths=4 * per, **kw)
    parts = [fn(*args, n_paths=per, point_offset=i * per, **kw) for i in range(4)]
    assert torch.equal(torch.cat(parts, dim=-1), full)


def test_rank_failure_fails_the_call():
    """A rank that raises fails ``run_ranks`` with its traceback; the
    others are terminated, none is left running."""
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        run_ranks(2, cases.one_over_rank, backend="gloo", timeout=60.0)
