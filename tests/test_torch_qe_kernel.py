"""The QE mixing kernels' plain twins (K7 values, K8 price, K10 price + 7
greeks, K11 the values VJP) against the Pallas kernels run in interpret mode
on the CPU, on the in-kernel Sobol' stream (the Pallas PRNG stream has no
CPU form); and the twins against each other on both streams.

Each JAX kernel is called once, at one 32768-pair tile and 5 steps (an odd
count: the PRNG layout's single-step tail), in a module-scoped fixture;
interpret mode costs 4-14 s per call here.

Interpret mode evaluates ``pl.reciprocal(x, approx=True)`` as the float32
reciprocal of ``x`` rounded to bfloat16, so the reference's ``_rcp`` carries
~1.5e-5 relative error after its Newton polish; the port's twin (like the
CUDA kernel) is fp32-accurate.  The per-path K7 comparison gives the twin
the interpret-mode estimate; the aggregate comparisons use the shipped twin
and the JAX package's own interpret-test tolerances
(tests/agreement/test_kernel_greeks.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu_torch as ht
from hedgehog_tpu.ops import heston_qe_greeks_kernel as jg
from hedgehog_tpu.ops import heston_qe_kernel as jq
from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as pg
from hedgehog_tpu_torch.ops import heston_qe_kernel as pq
from hedgehog_tpu_torch.ops import hh_device

T = 366 / 365
STEPS, SEED, PAIRS = 5, 5, 32768
MKT = (math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7)
ARGS = (*MKT, T / STEPS, 100.0, 1.0)  # + strike, cp
D = math.exp(-0.03 * T)
PRICE_KW = dict(n_blocks=1, n_batches=1, steps=STEPS, seed=SEED, qmc=True)


def _interpret_rcp(x):
    """The interpret-mode ``_rcp``: bfloat16-rounded input, float32
    reciprocal, one Newton polish."""
    r = torch.reciprocal(x.to(torch.bfloat16).to(torch.float32))
    return r * (2.0 - x * r)


def _cotangent(n_groups, n):
    """The smooth per-path cotangent of the JAX package's VJP test."""
    return 0.5 + 0.5 * np.sin(np.arange(n_groups * n, dtype=np.float64).reshape(n_groups, n))


@pytest.fixture(scope="module")
def jax_values():
    return np.asarray(jq.heston_qe_mixing_values(
        *ARGS, n_paths=PAIRS, steps=STEPS, seed=SEED, antithetic=True, qmc=True, interpret=True))


@pytest.fixture(scope="module")
def jax_price():
    return float(jq.heston_qe_mixing_vanilla_price(*MKT, T / STEPS, 100.0, D, **PRICE_KW,
                                                   interpret=True))


@pytest.fixture(scope="module")
def jax_greeks():
    price, greeks = jg.heston_qe_mixing_price_and_greeks(*MKT, T / STEPS, 120.0, D, **PRICE_KW,
                                                         interpret=True)
    return float(price), np.asarray(greeks)


@pytest.fixture(scope="module")
def jax_vjp():
    grads = jg._mixing_values_vjp(*ARGS, jnp.asarray(_cotangent(2, PAIRS)), n_paths=PAIRS,
                                  steps=STEPS, seed=SEED, antithetic=True, qmc=True,
                                  interpret=True)
    return np.array([float(g) for g in grads])


def test_parameter_vector_and_tangent_table_match_reference():
    want = np.asarray(jq._mix_params(*MKT, T / STEPS, STEPS, 100.0, 1.0))
    got = pq._mix_params(*MKT, T / STEPS, STEPS, 100.0, 1.0)
    assert got.dtype == np.float32 and got.shape == want.shape == (16,)
    assert np.max(np.abs(got.view(np.int32) - want.view(np.int32))) <= 1  # ≤ 1 ulp
    for n_dirs in (4, 5):
        want = np.asarray(jg._greek_table(0.04, 2.0, 0.04, 0.3, T / STEPS, STEPS, n_dirs))
        got = pg._greek_table(0.04, 2.0, 0.04, 0.3, T / STEPS, STEPS, n_dirs)
        assert got.dtype == np.float32 and got.shape == want.shape == (n_dirs, 8)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_values_twin_per_path_matches_interpret_kernel(jax_values, monkeypatch):
    """fp32 on both sides with the same Sobol' bits, ndtri approximation and
    reciprocal estimate: ≥ 99.9% of paths within 1e-4 relative (values below
    1e-3 compared absolutely; 30 of 65,536 beyond) and the means within 1e-6.
    The rest differ by an ulp in XLA's and torch's float32 exp/log/sqrt,
    which a deep out-of-the-money path amplifies."""
    for mod in (hh_device, pg):
        monkeypatch.setattr(mod, "rcp", _interpret_rcp)
    got = pq.heston_qe_mixing_values(*ARGS, n_paths=PAIRS, steps=STEPS, seed=SEED,
                                     antithetic=True, qmc=True, device="cpu").numpy()
    assert got.shape == jax_values.shape == (2, PAIRS)
    rel = np.abs(got - jax_values) / np.maximum(np.abs(jax_values), 1e-3)
    assert np.sum(rel > 1e-4) <= 1e-3 * rel.size
    assert got.astype(np.float64).mean() == pytest.approx(jax_values.astype(np.float64).mean(),
                                                          rel=1e-6)


def test_values_twin_mean_matches_interpret_kernel(jax_values):
    """The shipped twin (fp32-accurate reciprocal): the means differ by the
    reference's bf16-estimate reciprocal error, measured 8.7e-6 relative here
    (under 0.1 bp); 2e-5 bounds it."""
    got = pq.heston_qe_mixing_values(*ARGS, n_paths=PAIRS, steps=STEPS, seed=SEED,
                                     antithetic=True, qmc=True, device="cpu").numpy()
    assert got.astype(np.float64).mean() == pytest.approx(
        jax_values.astype(np.float64).mean(), rel=2e-5)


def test_price_twin_matches_interpret_kernel(jax_price):
    """K8 over the same 32768 Sobol' pairs: rtol 3e-4, the JAX package's
    interpret-test tolerance (measured 8.7e-6, the reciprocal again)."""
    got = float(pq.heston_qe_mixing_vanilla_price(*MKT, T / STEPS, 100.0, D, **PRICE_KW, device="cpu"))
    assert got == pytest.approx(jax_price, rel=3e-4)


def test_greeks_twin_matches_interpret_kernel(jax_greeks):
    """K10 at strike 120: price within 2e-4 and each greek within
    max(5e-3·|g|, 1e-3·max|g|), the tolerances of
    tests/agreement/test_kernel_greeks.py:109-117 (fp32 sums; a greek near
    zero is all cancellation)."""
    price, greeks = pg.heston_qe_mixing_price_and_greeks(*MKT, T / STEPS, 120.0, D, **PRICE_KW, device="cpu")
    want_price, want = jax_greeks
    assert float(price) == pytest.approx(want_price, rel=2e-4)
    got = greeks.numpy()
    assert got.shape == want.shape == (7,)
    scale = np.abs(want).max()
    assert (np.abs(got - want) <= np.maximum(5e-3 * np.abs(want), 1e-3 * scale)).all(), (got, want)


def test_vjp_twin_matches_interpret_kernel(jax_vjp):
    """K11's nine gradients under a smooth cotangent: rel 2e-2 or abs 5e-2,
    the tolerance of tests/agreement/test_kernel_greeks.py:255-259 (the ρ sum
    is a small difference of large fp32 terms; measured 2.5e-3 for ρ, ≤ 3e-4
    for the rest)."""
    got = pg._mixing_values_vjp(*ARGS, torch.as_tensor(_cotangent(2, PAIRS)), n_paths=PAIRS,
                                steps=STEPS, seed=SEED, antithetic=True, qmc=True)
    assert len(got) == 9
    for name, g, w in zip(("log_s0", "V0", "r", "kappa", "theta", "sigma", "rho", "dt", "strike"),
                          got, jax_vjp):
        assert float(g) == pytest.approx(float(w), rel=2e-2, abs=5e-2), name


@pytest.mark.parametrize("steps", [4, 5])
@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_price_twins_agree_with_the_values_twin(qmc, steps):
    """On one stream and shape: K8's twin equals the discounted mean of K7's
    twin over the same pairs to rel 1e-6 (another summation order), and
    K10's twin price equals K8's exactly (the same float32 operations and
    sums)."""
    kw = dict(n_blocks=1, n_batches=2, steps=steps, seed=11, qmc=qmc)
    vals = pq.heston_qe_mixing_values(*MKT, T / steps, 100.0, 1.0, n_paths=2 * PAIRS, steps=steps,
                                      seed=11, antithetic=True, qmc=qmc, device="cpu")
    price = float(pq.heston_qe_mixing_vanilla_price(*MKT, T / steps, 100.0, D, **kw, device="cpu"))
    assert price == pytest.approx(D * float(vals.double().mean()), rel=1e-6)
    greek_price, greeks = pg.heston_qe_mixing_price_and_greeks(*MKT, T / steps, 100.0, D, **kw, device="cpu")
    assert float(greek_price) == price
    assert bool(torch.isfinite(greeks).all())


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_autograd_through_the_values_twin_matches_the_greeks_twin(qmc):
    """The differentiable view (K7 forward, K11 backward) of D·mean(values)
    against K10 on the same pairs: the same fp32 tangents summed in another
    order, so each greek agrees within 1e-5·max|g| + 1e-5·|g|.  The view's
    gradients are in (log S0, V0, r, κ, θ, σ, ρ); spot = ∂/∂log S0 / S0 and
    the rate greek adds the discount term."""
    n, steps = PAIRS, 5
    params = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in MKT]
    log_s0, v0, r, kappa, theta, sigma, rho = params
    vals = pg.heston_qe_mixing_values_diff(log_s0, v0, r, kappa, theta, sigma, rho, T / steps,
                                           100.0, 1.0, n_paths=n, steps=steps, seed=3,
                                           antithetic=True, qmc=qmc, device="cpu")
    assert vals.shape == (2, n) and vals.dtype == torch.float32
    price = torch.exp(-r * T) * vals.double().mean()
    grads = torch.autograd.grad(price, params)
    got = np.array([float(grads[0]) / 100.0, *(float(g) for g in grads[1:])])
    got = got[[0, 1, 3, 4, 5, 6, 2]]  # GREEK_ORDER
    k_price, want = pg.heston_qe_mixing_price_and_greeks(*MKT, T / steps, 100.0, D, n_blocks=1,
                                                         n_batches=1, steps=steps, seed=3,
                                                         qmc=qmc, device="cpu")
    want = want.numpy()
    assert float(price.detach()) == pytest.approx(float(k_price), rel=1e-6)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want).max() + 1e-5 * np.abs(want)).all(), (got, want)


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_autograd_backward_keeps_the_standalone_vjps_bits(qmc):
    """The differentiable view's backward runs K11 on the forward's inputs
    (kept on the autograd context, the tangent table in the parameters'
    copy) and brings its sums to the scalars' device in one copy; its nine
    gradients equal, to the bit, those of ``_mixing_values_vjp``, which
    builds every input anew from the scalars as the backward once did,
    under the same cotangent."""
    n = 4096
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in ARGS[:9]]
    vals = pg.heston_qe_mixing_values_diff(*leaves, ARGS[9], n_paths=n, steps=STEPS, seed=3,
                                           antithetic=True, qmc=qmc, device="cpu")
    ct = torch.as_tensor(_cotangent(2, n), dtype=torch.float32)
    got = torch.autograd.grad(vals, leaves, grad_outputs=ct)
    want = pg._mixing_values_vjp(*ARGS, ct, n_paths=n, steps=STEPS, seed=3, antithetic=True,
                                 qmc=qmc)
    assert [g.dtype for g in got] == [torch.float64] * 9
    assert [float(g).hex() for g in got] == [float(w).hex() for w in want]


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    kernels = (pq.QE_VALUES_KERNEL, pq.QE_PRICE_KERNEL, pg.QE_GREEKS_KERNEL, pg.QE_VJP_KERNEL)
    before = [k.launches for k in kernels]
    pq.heston_qe_mixing_values(*ARGS, n_paths=64, steps=3, seed=0, device="cpu")
    pq.heston_qe_mixing_vanilla_price(*MKT, T / 3, 100.0, 1.0, n_blocks=1, n_batches=1, steps=1,
                                      seed=0, device="cpu")
    pg.heston_qe_mixing_price_and_greeks(*MKT, T / 1, 100.0, 1.0, n_blocks=1, n_batches=1,
                                         steps=1, seed=0, device="cpu")
    pg._mixing_values_vjp(*ARGS, torch.ones(1, 64), n_paths=64, steps=3, seed=0, antithetic=False)
    assert [k.launches for k in kernels] == before


def test_guards():
    with pytest.raises(ValueError, match="antithetic-only"):
        pg._mixing_values_vjp(*ARGS, torch.ones(1, 64), n_paths=64, steps=STEPS, seed=0,
                              antithetic=False, qmc=True)
    with pytest.raises(ValueError, match="period"):
        pq.heston_qe_mixing_values(*ARGS, n_paths=PAIRS, steps=STEPS, seed=0, antithetic=True,
                                   qmc=True, point_offset=2**30 - 1, device="cpu")
    with pytest.raises(ValueError, match="period"):
        pq.heston_qe_mixing_vanilla_price(*MKT, T / STEPS, 100.0, 1.0, n_blocks=2**15,
                                          n_batches=1, steps=STEPS, seed=0, qmc=True,
                                          point_offset=1, device="cpu")
    with pytest.raises(ValueError, match="period"):
        pg.heston_qe_mixing_price_and_greeks(*MKT, T / STEPS, 100.0, 1.0, n_blocks=2**15,
                                             n_batches=2, steps=STEPS, seed=0, qmc=True, device="cpu")
    params = torch.as_tensor(pq._mix_params(*MKT, T / STEPS, STEPS, 100.0, 1.0))
    with pytest.raises(TypeError, match="float32"):
        pq._qe_values(params.double(), None, 8, STEPS, True, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pq._qe_values(params[:-1], None, 8, STEPS, True, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pq._qe_values(params, torch.zeros((4, 31), dtype=torch.int32), 8, STEPS, True, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pg._vjp_sums(params, torch.zeros((5, 8)), None, torch.ones(2, 8), 8, STEPS, False, 0, 0,
                     0)


def test_values_twin_past_128_qmc_steps_matches_the_float64_estimator():
    """200 QMC steps, past the 128 the kernels once refused (the JAX kernels
    check only the Sobol' period): the twin's values against the JAX
    package's float64 estimator on the same Sobol' points (the unsplit base
    key; exact ndtri there, fp32 and the approximate ndtri here), 4096
    pairs: ≥ 99.9% of paths within 1e-3 relative (values below 1e-3
    compared absolutely; measured 99.95%), all within 1e-2, and the means
    within 1e-5 (measured 2e-6)."""
    import datetime as dt

    import hedgehog_tpu as hh
    from hedgehog_tpu.methods.montecarlo import _heston_qe_mixing_values

    steps, n = 200, 4096
    mkt = hh.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, dt.date(2025, 1, 1), hh.European(),
                                              hh.Call(), hh.Spot()), mkt)
    cfg = hh.SimulationConfig(trajectories=n, steps=steps, variance_reduction=hh.Antithetic(),
                              seed=SEED, qmc=True)
    want = np.asarray(_heston_qe_mixing_values(prob, cfg, None))
    got = pq.heston_qe_mixing_values(*MKT, T / steps, 100.0, 1.0, n_paths=n, steps=steps,
                                     seed=SEED, antithetic=True, qmc=True, device="cpu").numpy()
    assert got.shape == want.shape == (2, n)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert np.mean(rel <= 1e-3) >= 0.999 and rel.max() <= 1e-2, rel.max()
    assert got.astype(np.float64).mean() == pytest.approx(want.mean(), rel=1e-5)


def test_kernel_strategy_solve_on_cpu_runs_the_twins():
    """``HestonQE(conditional=True, use_kernel=True)`` on the CPU prices with
    the K7 twin: the same values as calling the twin directly."""
    import datetime as dt

    prob = ht.PricingProblem(
        ht.VanillaOption(100.0, dt.date(2025, 1, 1)),
        ht.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7))
    cfg = ht.SimulationConfig(4096, STEPS, ht.Antithetic(), SEED, True)
    sol = ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(use_kernel=True,
                                                                        conditional=True), cfg,
                                       device="cpu"))
    want = pq.heston_qe_mixing_values(*ARGS, n_paths=4096, steps=STEPS, seed=SEED,
                                      antithetic=True, qmc=True, device="cpu")
    assert sol.ensemble.dtype == torch.float64
    torch.testing.assert_close(sol.ensemble, want.double(), rtol=0.0, atol=0.0)


@pytest.mark.parametrize("bad", [0, -3, True, 2.0], ids=["zero", "negative", "bool", "float"])
def test_greek_kernel_grid_is_checked(bad):
    """``grid=`` of K10's sums (the digest runs them at the grid before its
    redesign) takes a positive int or None, on any device."""
    params, _ = pq.mix_inputs(*ARGS, STEPS, 0, False, "cpu")
    dtab = torch.as_tensor(pg._greek_table(0.04, 2.0, 0.04, 0.3, T / STEPS, STEPS, 4))
    with pytest.raises(ValueError, match="grid"):
        pg._greek_sums(params, dtab, None, 8, STEPS, 0, 0, 0, grid=bad)


@pytest.mark.parametrize("bad", [0, -3, True, 2.0], ids=["zero", "negative", "bool", "float"])
def test_price_kernel_grid_is_checked(bad):
    """``grid=`` of K8's sum (the digest and the card tests run it at its
    grid before the per-stream build) takes a positive int or None, on any
    device."""
    params, _ = pq.mix_inputs(*ARGS, STEPS, 0, False, "cpu")
    with pytest.raises(ValueError, match="grid"):
        pq._qe_price_sum(params, None, 8, STEPS, 0, 0, 0, grid=bad)


def test_price_sum_twin_ignores_the_grid():
    """On the CPU K8's sum is its twin's whatever ``grid`` names (the grid
    orders the card's sums only)."""
    params, table = pq.mix_inputs(*ARGS, STEPS, 0, True, "cpu")
    want = pq._qe_price_sum(params, table, 64, STEPS, 0, 0, 0)
    assert torch.equal(pq._qe_price_sum(params, table, 64, STEPS, 0, 0, 0, grid=7), want)


def test_greek_assembly_keeps_each_formula():
    """``_assemble_grad7`` in five launches gives each greek the float64
    bits of its own formula: discount·w̄/S0, discount·chain, discount·ρ̄,
    discount·w̄·T − T·price."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        tot = torch.as_tensor(rng.normal(size=7) * 10.0 ** rng.integers(-8, 3, size=7))
        log_s0, T_, disc = rng.normal(4.6, 0.3), rng.uniform(0.1, 3.0), rng.uniform(0.8, 1.0)
        price = disc * tot[0]
        got = pg._assemble_grad7(tot, log_s0, 0.03, T_, disc, price)
        want = torch.stack([disc * tot[5] / float(np.exp(log_s0)), disc * tot[1], disc * tot[2],
                            disc * tot[3], disc * tot[4], disc * tot[6],
                            disc * tot[5] * T_ - T_ * price])
        assert torch.equal(got, want)

