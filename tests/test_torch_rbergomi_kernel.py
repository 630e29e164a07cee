"""The rough-Bergomi kernels' plain twins (K14 values, K15 price, K16 price
+ 6 greeks, K17 the values VJP) against the Pallas kernels run in interpret
mode on the CPU, on the in-kernel Sobol' stream (the Pallas PRNG stream has
no CPU form): the same points through the same approximate ndtri.  Then the
twins against each other on both streams, the differentiable view, the
adapter and the guards.

Each JAX kernel is called once, in a module-scoped fixture, at the JAX
package's test market (tests/unit/test_rbergomi_kernel.py) and 8 steps:
K14 and K15 at 4096 pairs, K16 at 2 × 2048 pairs, K17 and the gradient
through JAX's differentiable view at 2048 pairs; interpret mode costs 7-12 s
a call here.

Interpret mode evaluates ``pl.reciprocal(x, approx=True)`` as the float32
reciprocal of ``x`` rounded to bfloat16 (tests/test_torch_surface_kernel.py),
so the reference's ``_rcp`` carries ~1.5e-5 relative error after its Newton
polish, in the mirror group's variance and in the close; the twins' (and the
kernels') reciprocal is fp32-accurate.  The per-path comparison gives the
twin the interpret-mode estimate."""

import datetime as dt
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.ops import rbergomi_kernel as jr
from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as pg
from hedgehog_tpu_torch.ops import hh_device
from hedgehog_tpu_torch.ops import rbergomi_kernel as pr

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
STEPS, SEED, PAIRS = 8, 3, 4096
T = 366 / 365
P0 = (100.0, 0.04, 1.5, 0.1, -0.7, 0.03, T, 95.0)  # spot, xi0, eta, hurst, rho, r0, T, strike
NAMES8 = ("spot", "xi0", "eta", "hurst", "rho", "r0", "T", "strike")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops on tensors of 2^11-2^13 elements: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interpret_rcp(x):
    """The interpret-mode ``_rcp``: bfloat16-rounded input, float32
    reciprocal, one Newton polish."""
    r = torch.reciprocal(x.to(torch.bfloat16).to(torch.float32))
    return r * (2.0 - x * r)


def _problem(strike=100.0):
    mkt = hh.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.5, 0.1, -0.7)
    return hh.PricingProblem(hh.VanillaOption(strike, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                             mkt)


def _config(paths=PAIRS, steps=STEPS, qmc=True, seed=SEED):
    return hh.SimulationConfig(trajectories=paths, steps=steps, variance_reduction=hh.Antithetic(),
                               seed=seed, qmc=qmc)


def _cotangent(n_groups, n):
    """The smooth per-path cotangent of the JAX package's VJP test."""
    return 0.5 + 0.5 * np.sin(np.arange(n_groups * n, dtype=np.float64).reshape(n_groups, n))


def _port_inputs(steps=STEPS):
    """The price inputs from the port's own host code (float64 factor)."""
    prob, cfg = ht.from_reference(_problem()), ht.from_reference(_config(steps=steps))
    return pr._rb_trace_inputs(prob, cfg, 64)


@pytest.fixture(scope="module")
def jax_inputs():
    return jr._rb_trace_inputs(_problem(), _config(), 64)


@pytest.fixture(scope="module")
def jax_values(jax_inputs):
    return np.asarray(jr.rbergomi_mixing_values(
        *jax_inputs[:9], n_paths=PAIRS, steps=STEPS, seed=SEED, antithetic=True, qmc=True,
        interpret=True))


@pytest.fixture(scope="module")
def jax_price(jax_inputs):
    return float(jr.rbergomi_mixing_vanilla_price(
        *jax_inputs[:10], n_blocks=1, n_batches=2, steps=STEPS, seed=SEED, qmc=True,
        interpret=True))


@pytest.fixture(scope="module")
def jax_greeks():
    price, greeks = jr.rbergomi_kernel_price_and_greeks(_problem(), _config(), n_blocks=2,
                                                        n_batches=1, interpret=True)
    return float(price), np.array([float(greeks[k]) for k in ht.GREEK_ORDER_RB])


@pytest.fixture(scope="module")
def jax_vjp():
    grads = jr._rb_values_vjp(*P0, 1.0, jnp.asarray(_cotangent(2, 2048)), n_paths=2048,
                              steps=STEPS, seed=5, antithetic=True, qmc=True, interpret=True)
    return np.array([float(g) for g in grads])


@pytest.fixture(scope="module")
def jax_view_grad():
    """``jax.grad`` of a weighted sum through JAX's differentiable view (its
    custom VJP is the interpret-mode K17)."""
    ct = jnp.asarray(_cotangent(2, 2048)) / 4096.0

    def loss(p):
        vals = jr.rbergomi_mixing_values_diff(*p, 1.0, n_paths=2048, steps=STEPS, seed=5,
                                              antithetic=True, qmc=True, interpret=True)
        return jnp.sum(ct * vals)

    return np.asarray(jax.grad(loss)(jnp.asarray(P0)))


def test_parameter_vector_and_inputs_match_reference(jax_inputs):
    """The float32 factor and coefficients the kernels read are the TPU
    wrapper's casts of the same float64 quantities (within 1 ulp), the close
    constants likewise."""
    got = pr.rb_inputs_from_trace(_port_inputs(), seed=SEED, qmc=True, device="cpu")
    want_p, want_c, want_l = (np.asarray(a) for a in jr._rb_inputs(*jax_inputs[:9], n=STEPS,
                                                                    m_pad=128))
    np.testing.assert_allclose(got.chol.numpy(), want_l[:16, :16], rtol=2e-7, atol=1e-12)
    np.testing.assert_allclose(got.coef[:, :2].numpy(), want_c[:STEPS, :2], rtol=2e-7)
    names = ("eta", "dt", "f_base", "log_f_over_k", "strike", "cp", "rho", "rho2_half", "rho_bar2")
    mine = dict(zip(pr.RB_NAMES, got.params.numpy()))
    np.testing.assert_allclose([mine[k] for k in names], want_p, rtol=2e-7)
    assert got.table.shape == (2 * STEPS, 31)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(jr._sobol_table(SEED, 2 * STEPS)))


def test_values_twin_per_path_matches_interpret_kernel(jax_values, monkeypatch):
    """fp32 on both sides, the same Sobol' bits, ndtri approximation and
    reciprocal estimate: ≥ 99.9% of paths within 1e-4 relative (values below
    1e-3 absolutely), the means within 2e-6.  The rest differ by the order
    of the Volterra product's 2n terms (the MXU's and torch's) and an ulp in
    exp/sqrt, which a path near the money in the close amplifies."""
    monkeypatch.setattr(hh_device, "rcp", _interpret_rcp)
    monkeypatch.setattr(pr, "rcp", _interpret_rcp)
    got = pr.rbergomi_mixing_values(*_port_inputs().values_args(), n_paths=PAIRS, steps=STEPS, seed=SEED,
                                    antithetic=True, qmc=True, device="cpu").numpy()
    assert got.shape == jax_values.shape == (2, PAIRS) and got.dtype == np.float32
    rel = np.abs(got - jax_values) / np.maximum(np.abs(jax_values), 1e-3)
    assert np.sum(rel > 1e-4) <= 1e-3 * rel.size, np.sort(rel.ravel())[-10:]
    assert got.astype(np.float64).mean() == pytest.approx(jax_values.astype(np.float64).mean(),
                                                          rel=2e-6)


def test_values_twin_mean_matches_interpret_kernel(jax_values):
    """The shipped twin (fp32-accurate reciprocal): the means differ by the
    reference's bf16-estimate reciprocal, under 3e-5 relative (0.3 bp)."""
    got = pr.rbergomi_mixing_values(*_port_inputs().values_args(), n_paths=PAIRS, steps=STEPS, seed=SEED,
                                    antithetic=True, qmc=True, device="cpu").numpy()
    assert got.astype(np.float64).mean() == pytest.approx(jax_values.astype(np.float64).mean(),
                                                          rel=3e-5)


def test_price_twin_matches_interpret_kernel_and_values(jax_price):
    """K15 over the same 4096 Sobol' pairs: within 3e-5 of the interpret
    kernel (the reciprocal, as above) and within 1e-6 of the discounted mean
    of K14's twin over those pairs (another summation order)."""
    ins = _port_inputs()
    got = float(pr.rbergomi_mixing_vanilla_price(*ins.price_args(), n_blocks=1, n_batches=2, steps=STEPS,
                                                 seed=SEED, qmc=True, device="cpu"))
    assert got == pytest.approx(jax_price, rel=3e-5)
    vals = pr.rbergomi_mixing_values(*ins.values_args(), n_paths=PAIRS, steps=STEPS, seed=SEED,
                                     antithetic=True, qmc=True, device="cpu")
    assert got == pytest.approx(ins.discount * float(vals.double().mean()), rel=1e-6)


def test_point_offset_slices_one_sequence():
    """Pairs 2048.. at offset 0 are pairs 0.. at offset 2048, bit for bit:
    the disjoint slicing sharded devices rely on."""
    ins = _port_inputs().values_args()
    kw = dict(steps=STEPS, seed=SEED, antithetic=True, qmc=True, device="cpu")
    whole = pr.rbergomi_mixing_values(*ins, n_paths=PAIRS, **kw)
    second = pr.rbergomi_mixing_values(*ins, n_paths=2048, point_offset=2048, **kw)
    torch.testing.assert_close(whole[:, 2048:], second, rtol=0, atol=0)


def test_greeks_twin_matches_interpret_kernel(jax_greeks):
    """K16 at 2 × 2048 pairs: the price within 3e-5 (the reciprocal) and
    each greek within 5e-3 relative or 1e-3 of the largest (fp32 tangent
    sums in other orders; ρ and H are sums of large terms of both signs,
    the tolerances of tests/agreement/test_kernel_greeks.py)."""
    price, greeks = pr.rbergomi_kernel_price_and_greeks(
        ht.from_reference(_problem()), ht.from_reference(_config()), n_blocks=2, n_batches=1,
        device="cpu")
    want_price, want = jax_greeks
    assert list(greeks) == list(ht.GREEK_ORDER_RB)
    assert float(price) == pytest.approx(want_price, rel=3e-5)
    got = np.array([float(g) for g in greeks.values()])
    scale = np.abs(want).max()
    assert (np.abs(got - want) <= np.maximum(5e-3 * np.abs(want), 1e-3 * scale)).all(), (got, want)


def test_vjp_twin_matches_interpret_kernel(jax_vjp):
    """K17's eight gradients under a smooth cotangent at 2048 pairs: rel 5e-3
    or abs 5e-3 (fp32 tangent sums of many terms; the JAX package's own bound
    against its float64 oracle is rel 2e-2 or abs 5e-2)."""
    got = pr._rb_values_vjp(*P0, 1.0, torch.as_tensor(_cotangent(2, 2048)), n_paths=2048,
                            steps=STEPS, seed=5, antithetic=True, qmc=True)
    assert len(got) == 8
    for name, g, w in zip(NAMES8, got, jax_vjp):
        assert float(g) == pytest.approx(float(w), rel=5e-3, abs=5e-3), name


def test_autograd_through_the_view_matches_jax_grad(jax_view_grad):
    """``torch.autograd.grad`` through the differentiable view (K14 forward,
    K17 backward, their twins here) against ``jax.grad`` through JAX's view:
    rel 5e-3 or abs 1e-4 in all eight scalars, T and the strike included."""
    ct = torch.as_tensor(_cotangent(2, 2048)) / 4096.0
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in P0]
    vals = pr.rbergomi_mixing_values_diff(*leaves, 1.0, n_paths=2048, steps=STEPS, seed=5,
                                          antithetic=True, qmc=True, device="cpu")
    assert vals.shape == (2, 2048) and vals.dtype == torch.float32
    grads = torch.autograd.grad((ct * vals.double()).sum(), leaves)
    for name, g, w in zip(NAMES8, grads, jax_view_grad):
        assert float(g) == pytest.approx(float(w), rel=5e-3, abs=1e-4), name


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_price_twins_agree_with_the_values_twin(qmc):
    """On one stream: K15's twin equals the discounted mean of K14's twin
    over the same pairs to rel 1e-6 (another summation order), and K16's
    twin price equals K15's exactly (the same float32 operations and sums)."""
    ins = _port_inputs()
    kw = dict(n_blocks=1, n_batches=2, steps=STEPS, seed=11, qmc=qmc, device="cpu")
    price = float(pr.rbergomi_mixing_vanilla_price(*ins.price_args(), **kw))
    vals = pr.rbergomi_mixing_values(*ins.values_args(), n_paths=PAIRS, steps=STEPS, seed=11,
                                     antithetic=True, qmc=qmc, device="cpu")
    assert price == pytest.approx(ins.discount * float(vals.double().mean()), rel=1e-6)
    g_ins = pr._rb_greek_trace_inputs(ht.from_reference(_problem()),
                                      ht.from_reference(_config()), 64)
    g_price, greeks = pr.rbergomi_mixing_price_and_greeks(*g_ins, **kw)
    assert float(g_price) == price
    assert bool(torch.isfinite(greeks).all())


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_autograd_through_the_view_matches_the_greeks_twin(qmc):
    """The view of disc·mean(values) against K16 on the same pairs: the same
    fp32 tangents summed in another order, each greek within 1e-5 of the
    largest plus 1e-5 of its own.  The view's gradients are in (spot, xi0,
    eta, hurst, rho, r0); the rate greek adds the discount term."""
    T1 = float(ht.yearfrac(REF, EXPIRY))
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (100.0, 0.04, 1.5, 0.1, -0.7, 0.03)]
    spot, xi0, eta, hurst, rho, r = leaves
    vals = pr.rbergomi_mixing_values_diff(spot, xi0, eta, hurst, rho, r, T1, 100.0, 1.0,
                                          n_paths=PAIRS, steps=STEPS, seed=7, antithetic=True,
                                          qmc=qmc, device="cpu")
    price = torch.exp(-r * T1) * vals.double().mean()
    g = torch.autograd.grad(price, leaves)
    got = np.array([float(x) for x in (g[0], g[1], g[2], g[4], g[3], g[5])])  # GREEK_ORDER_RB
    cfg = ht.from_reference(_config(seed=7, qmc=qmc))
    k_price, want = pr.rbergomi_kernel_price_and_greeks(ht.from_reference(_problem()), cfg,
                                                        n_blocks=1, n_batches=2, device="cpu")
    want = np.array([float(x) for x in want.values()])
    assert float(price.detach()) == pytest.approx(float(k_price), rel=1e-6)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want).max() + 1e-5 * np.abs(want)).all(), (got, want)


def test_kernel_strategy_solve_on_cpu_runs_the_twins():
    """``RoughBergomiMixing(use_kernel=True)`` on the CPU prices with the K14
    twin: the same values as calling the twin directly; it prices within
    2e-5 of the float64 estimator on the same QMC points."""
    prob, cfg = ht.from_reference(_problem()), ht.from_reference(_config())
    sol = ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(),
                                       ht.RoughBergomiMixing(use_kernel=True), cfg, device="cpu"))
    want = pr.rbergomi_mixing_values(*_port_inputs().values_args(), n_paths=PAIRS, steps=STEPS, seed=SEED,
                                     antithetic=True, qmc=True, device="cpu")
    assert sol.ensemble.dtype == torch.float64
    torch.testing.assert_close(sol.ensemble, want.double(), rtol=0.0, atol=1e-6)
    p64 = ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(), cfg,
                                       device="cpu")).price
    assert float(sol.price) == pytest.approx(float(p64), rel=2e-5)


@pytest.mark.parametrize("steps", [STEPS, 64])
def test_kernel_route_per_path_matches_the_float64_estimator(steps):
    """On the same QMC points the kernel route's values (fp32, the
    approximate ndtri) and the float64 estimator's (exact ndtri): ≥ 99.9% of
    paths within 1e-2 relative (values below 1e-3 absolutely) and the means
    within 1e-5, a tenth of a basis point: a scheme difference of that size
    shows here, where the 4-SE check of two price estimates cannot see it.
    chip_smoke.py holds the kernel to the same limits at 2^20 pairs."""
    prob = ht.from_reference(_problem())
    cfg = ht.SimulationConfig(1024, steps, ht.Antithetic(), SEED, True)
    ens = [ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(),
                                        ht.RoughBergomiMixing(use_kernel=k), cfg,
                                        device="cpu")).ensemble for k in (True, False)]
    got, want = (e.detach().double() for e in ens)
    rel = (got - want).abs() / want.abs().clamp(min=1e-3)
    assert float((rel <= 1e-2).double().mean()) >= 0.999, rel.max()
    assert float(got.mean()) == pytest.approx(float(want.mean()), rel=1e-5)


def test_kernel_route_past_256_steps_matches_the_jax_float64_estimator():
    """300 steps, past the 256 the kernels once refused (the JAX kernels
    check only steps >= 2 and the Sobol' period): the kernel route's values
    (its twins here: fp32, the approximate ndtri) against the JAX package's
    float64 estimator (``_rbergomi_mixing_values``, exact ndtri) on the same
    QMC points, 1024 pairs: ≥ 99.9% of paths within 1e-3 relative (values
    below 1e-3 compared absolutely; measured 100%), all within 1e-2, and the
    means within 1e-5 (measured 5.5e-8)."""
    from hedgehog_tpu.methods.montecarlo import _rbergomi_mixing_values

    steps, n = 300, 1024
    cfg = _config(paths=n, steps=steps)
    want = np.asarray(_rbergomi_mixing_values(_problem(), cfg, None))
    sol = ht.solve(ht.from_reference(_problem()),
                   ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(use_kernel=True),
                                 ht.from_reference(cfg), device="cpu"))
    got = sol.ensemble.detach().double().numpy()
    assert got.shape == want.shape == (2, n)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert np.mean(rel <= 1e-3) >= 0.999 and rel.max() <= 1e-2, rel.max()
    assert got.mean() == pytest.approx(want.mean(), rel=1e-5)


def test_curve_and_one_step_routes_are_primal_only():
    """Under a ForwardVarianceCurve the adapter runs K14 forward and K18
    backward: ``torch.autograd.grad`` gives finite, positive bucket vegas of
    an at-the-money call.  At one step the values are primal only and a
    gradient request raises, naming why."""
    xi = torch.tensor([0.04, 0.05], dtype=torch.float64, requires_grad=True)
    mkt = ht.RoughBergomiInputs(REF, 0.03, 100.0, ht.ForwardVarianceCurve([0.5, 1.0], xi), 1.5, 0.1,
                                -0.7)
    prob = ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY), mkt)
    for steps in (STEPS, 1):
        cfg = ht.SimulationConfig(256, steps, ht.Antithetic(), 0, True)
        sol = ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(),
                                           ht.RoughBergomiMixing(use_kernel=True), cfg,
                                           device="cpu"))
        assert sol.ensemble.shape == (2, 256) and bool(torch.isfinite(sol.ensemble).all())
        if steps >= 2:
            (vegas,) = torch.autograd.grad(sol.price, xi)
            assert vegas.shape == (2,) and bool(torch.isfinite(vegas).all())
            assert bool((vegas > 0).all()), vegas
        else:
            with pytest.raises(NotImplementedError, match="steps >= 2"):
                torch.autograd.grad(sol.price, xi)


def _unit_hits(seed: int, n_dims: int, n_points: int) -> list:
    """The (point, dim) pairs among the first ``n_points`` points of
    ``sobol_table(seed, n_dims)`` whose float32 uniform rounds to 1.0
    (integer ≥ 2^30 − 32), sorted.  The integer is linear over GF(2) in the
    index bits, so each dimension is searched by meeting the low 15 index
    bits' terms against the high bits' in the top 25 integer bits."""
    bits = hh_device.SOBOL_BITS
    table = hh_device.sobol_table(seed, n_dims).astype(np.int64)
    lo, top = 15, (1 << (bits - 5)) - 1
    low = np.arange(1 << lo, dtype=np.int64)
    highs = np.arange(((n_points - 1) >> lo) + 1, dtype=np.int64)
    hits = []
    for d in range(n_dims):
        g = np.zeros_like(low)
        for b in range(lo):
            g ^= np.where((low >> b) & 1, table[d, b], 0)
        f = np.full_like(highs, table[d, bits])
        for b in range(lo, bits):
            f ^= np.where((highs >> (b - lo)) & 1, table[d, b], 0)
        order = np.argsort(g >> 5, kind="stable")
        keys = (g >> 5)[order]
        want = (f >> 5) ^ top
        first, last = np.searchsorted(keys, want, "left"), np.searchsorted(keys, want, "right")
        for h, i0, i1 in zip(highs, first, last):
            hits += [(int(p), d) for p in (h << lo) + order[i0:i1] if p < n_points]
    return sorted(hits)


#: the Sobol' dims each scheme draws as normals (the rest are uniforms):
#: exact mixing 4 a segment (the normals at 4s + 1, 4s + 3), QE mixing 2 a
#: step (z at 2s), QE-M 3 a step (z_v, z_x; u at 3s + 2), rough Bergomi all
_NORMAL_DIMS = {"exact": lambda d: d % 4 in (1, 3), "QE": lambda d: d % 2 == 0,
                "QE-M": lambda d: d % 3 != 2, "rBergomi": lambda d: True}


@pytest.mark.parametrize("scheme, seed, dims, points, normals, uniforms", [
    ("exact", 5, 8, 2**20, 0, 1),  # K2/K3 against their twins (chip_smoke.py phase 2)
    ("exact", 0, 8, 2**22, 0, 2),  # K2 under solve
    ("QE", 5, 22, 2**20, 1, 0),  # K7/K8/K10/K11 against their twins, 11 steps
    ("QE", 0, 22, 2**22, 2, 0),  # K7 under solve
    ("QE-M", 5, 30, 2**20, 0, 1),  # K5 against its twin, 10 steps
    ("QE-M", 0, 30, 2**23, 5, 1),  # K5 under solve
    ("QE", 5, 64, 2**20, 3, 1),  # K9/K12 against their twins, 32 steps
    ("QE", 0, 64, 2**26, 64, 64),  # K9 behind the surface adapter
    ("exact", 5, 20, 2**20, 0, 1),  # K4 against its twin, 5 segments
    ("exact", 0, 20, 2**26, 20, 20),  # K4 behind the surface adapter
    ("rBergomi", 5, 127, 2**20, 4, 0),  # K14-K19 against their twins, 64 steps
    ("rBergomi", 0, 127, 2**20, 3, 0),  # K14 under solve on the float64 estimator's points
    ("rBergomi", 0, 127, 2**22, 18, 0),  # K14 and K18 under solve
], ids=["K2-twin", "K2-solve", "K7-twin", "K7-solve", "K5-twin", "K5-solve", "K9-twin",
        "K9-adapter", "K4-twin", "K4-adapter", "rB-twin", "rB-f64-points", "rB-solve"])
def test_sobol_unit_cells_of_the_qmc_calls(scheme, seed, dims, points, normals, uniforms):
    """The Sobol' cells whose fp32 uniform rounds to 1.0 among the points
    of each QMC kernel call of chip_smoke.py, split into normal and uniform
    draws: the Heston kernels keep the TPU kernels' arithmetic there (an
    11.46-sigma normal; a uniform the QE draw clamps to 1 − 1e-7), the
    rough-Bergomi stream repairs its normals.  2^26 points put exactly two
    in each dimension's 32 top cells."""
    hits = _unit_hits(seed, dims, points)
    got = sum(_NORMAL_DIMS[scheme](d) for _, d in hits)
    assert (got, len(hits) - got) == (normals, uniforms)
    table = torch.as_tensor(hh_device.sobol_table(seed, dims))
    for point, d in hits[:4]:
        a = int(hh_device.sobol_bits(hh_device.sobol_masks(torch.tensor([point])), table, d))
        assert a >= 2**30 - 32, (point, d, a)


def test_sobol_unit_cells_draw_the_tail_normal():
    """A Sobol' integer a ≥ 2^30 − 32 rounds to u = 1.0 in float32, where the
    TPU kernels' ndtri returns 11.46; the rough-Bergomi stream draws
    Φ⁻¹((a + ½)·2^-30) there.  At seed 0 and 64 steps (128 dimensions) the
    first 2^20 points hit three such cells.  At point 410584, ξ row 94 (a Z
    row) lies within 1e-3 of the float64 Φ⁻¹, every other row keeps the TPU
    arithmetic's bits, and the K14 twin's values there agree with the
    float64 estimator's (exact ndtri) within chip_smoke.py's RB_F64_TOL, rel
    1e-2 (values below 1e-3 absolutely)."""
    from hedgehog_tpu_torch.methods.rough_bergomi_mixing import rbergomi_mixing_values

    assert _unit_hits(0, 128, 2**20) == [(410584, 94), (747354, 60), (894640, 0)]
    offset = 410584
    table = torch.as_tensor(hh_device.sobol_table(0, 128))
    pair = torch.zeros(1, dtype=torch.int64)
    xi = pr.rb_xi(pair, 128, table, 0, 0, offset)[:, 0]
    masks = hh_device.sobol_masks(pair + offset)
    tpu = torch.stack([hh_device.ndtri_approx(u)
                       for u in hh_device.sobol_uniforms_tile(masks, table, range(128))])[:, 0]
    a = int(hh_device.sobol_bits(masks, table, 94))
    exact = float(torch.special.ndtri(torch.tensor((a + 0.5) * 2.0**-30, dtype=torch.float64)))
    assert a >= 2**30 - 32 and float(tpu[94]) == pytest.approx(11.464, abs=1e-3)
    assert abs(float(xi[94]) - exact) <= 1e-3, (float(xi[94]), exact)
    keep = torch.arange(128) != 94
    torch.testing.assert_close(xi[keep], tpu[keep], rtol=0, atol=0)

    mkt = ht.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.9, 0.08, -0.9)
    prob = ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2024, 12, 31)), mkt)
    cfg = ht.SimulationConfig(1, 64, ht.Antithetic(), 0, True)
    got = pr.rbergomi_mixing_values(*pr._rb_trace_inputs(prob, cfg, 64).values_args(), n_paths=1,
                                    steps=64, seed=0, antithetic=True, qmc=True,
                                    point_offset=offset, device="cpu")
    want = rbergomi_mixing_values(prob, cfg, point_offset=offset, device="cpu")
    rel = (got.double() - want).abs() / want.abs().clamp(min=1e-3)
    assert float(rel.max()) <= 1e-2, (got, want)


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    kernels = (pr.RB_VALUES_KERNEL, pr.RB_PRICE_KERNEL, pr.RB_GREEKS_KERNEL, pr.RB_VJP_KERNEL,
               pr.RB_VJP_CURVE_KERNEL, pr.RB_SMILE_KERNEL)
    before = [k.launches for k in kernels]
    ins = _port_inputs(steps=3)
    pr.rbergomi_mixing_values(*ins.values_args(), n_paths=64, steps=3, seed=0, device="cpu")
    pr.rbergomi_mixing_vanilla_price(*ins.price_args(), n_blocks=1, n_batches=1, steps=3, seed=0,
                                     device="cpu")
    pr._rb_values_vjp(*P0, 1.0, torch.ones(1, 64), n_paths=64, steps=3, seed=0, antithetic=False)
    pr._rb_values_vjp_curve(P0[0], [0.04, 0.05], [0.5, 1.0], *P0[2:], 1.0, torch.ones(1, 64),
                            n_paths=64, steps=3, seed=0, antithetic=False)
    pr.rbergomi_mixing_smile_price(*ins.price_args()[:5], [90.0, 110.0], *ins.price_args()[7:],
                                   n_blocks=1, n_batches=1, steps=3, seed=0, device="cpu")
    assert [k.launches for k in kernels] == before


def test_guards():
    ins = _port_inputs()
    with pytest.raises(ValueError, match="period"):
        pr.rbergomi_mixing_values(*ins.values_args(), n_paths=PAIRS, steps=STEPS, seed=0, antithetic=True,
                                  qmc=True, point_offset=2**30 - 1, device="cpu")
    with pytest.raises(ValueError, match="period"):
        pr.rbergomi_mixing_vanilla_price(*ins.price_args(), n_blocks=2**19, n_batches=1, steps=STEPS,
                                         seed=0, qmc=True, point_offset=1, device="cpu")
    with pytest.raises(ValueError, match="steps >= 1"):
        pr.rb_inputs(np.eye(2), np.ones(0), *ins[2:9], steps=0, seed=0, qmc=False, device="cpu")
    g_ins = pr._rb_greek_trace_inputs(ht.from_reference(_problem()),
                                      ht.from_reference(_config()), 64)
    with pytest.raises(ValueError, match="steps >= 2"):
        pr.rbergomi_mixing_price_and_greeks(*g_ins, n_blocks=1, n_batches=1, steps=1, seed=0,
                                            device="cpu")
    with pytest.raises(ValueError, match="steps >= 2"):
        pr._rb_values_vjp(*P0, 1.0, torch.ones(2, 8), n_paths=8, steps=1, seed=0, antithetic=True)
    curve = ht.RoughBergomiInputs(REF, 0.03, 100.0, ht.ForwardVarianceCurve([0.5, 1.0],
                                                                           [0.04, 0.05]),
                                  1.5, 0.1, -0.7)
    with pytest.raises(TypeError, match="scalar xi0"):
        pr.rbergomi_kernel_price_and_greeks(ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY),
                                                              curve),
                                            ht.from_reference(_config()), n_blocks=1, n_batches=1,
                                            device="cpu")
    inp = pr.rb_inputs_from_trace(ins, seed=0, qmc=False, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        pr._rb_values(inp._replace(params=inp.params.double()), 8, True, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pr._rb_values(inp._replace(coef=inp.coef[:-1]), 8, True, 0, 0, 0)
    with pytest.raises(ValueError, match="H derivative"):
        pr._rb_greek_sums(inp, 8, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pr._rb_vjp_sums(pr.rb_inputs_from_trace(g_ins, seed=0, qmc=False, device="cpu"),
                        torch.ones(1, 8), 8, True, 0, 0, 0)
    with pytest.raises(ValueError, match="greek trace"):
        pr.rb_inputs_from_trace(ins, seed=0, qmc=False, device="cpu", hurst=0.1)


def test_inputs_from_the_two_traces_agree():
    """The price and greek traces share their fields; the device inputs built
    from either carry the same factor and parameters, the greek trace's add
    dL/dH, and with ``hurst`` the VJP's Hη and 1/T."""
    prob, cfg = ht.from_reference(_problem()), ht.from_reference(_config())
    t, g = pr._rb_trace_inputs(prob, cfg, 64), pr._rb_greek_trace_inputs(prob, cfg, 64)
    assert len(t.values_args()) == 9 and t.values_args()[0] is t.chol
    assert len(t.price_args()) == 10 and t.price_args()[9] == t.discount
    for name in ("eta", "dt", "f_base", "log_f_over_k", "strike", "cp", "rho", "discount"):
        assert getattr(g, name) == getattr(t, name), name
    assert g.horizon == t.T and g.xi0 == 0.04 and g.spot == 100.0
    a = pr.rb_inputs_from_trace(t, seed=SEED, qmc=True, device="cpu")
    b = pr.rb_inputs_from_trace(g, seed=SEED, qmc=True, device="cpu")
    v = pr.rb_inputs_from_trace(g, seed=SEED, qmc=True, device="cpu", hurst=0.1)
    assert a.dpack is None and b.dpack is not None and b.steps == a.steps == STEPS
    for x, y in ((a.chol, b.chol), (a.lpack, b.lpack), (a.table, b.table), (a.params[:9],
                                                                           b.params[:9])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    p = dict(zip(pr.RB_NAMES, v.params.tolist()))
    assert p["inv_xi0"] == pytest.approx(25.0, rel=1e-7)
    assert p["h_eta"] == pytest.approx(0.1 * 1.5, rel=1e-7)
    assert p["inv_t"] == pytest.approx(1.0 / t.T, rel=1e-7)


def test_greek_closure_matches_the_qe_partials():
    """K16 and K17 close with the QE greek kernels' conditional BS partials
    (one helper, csrc/heston_qe.cuh cond_bs_partials): w = ∂y/∂log F, and y
    equal to hh_device.cond_bs_value to the bit."""
    c = dict(zip(pr.RB_NAMES, torch.as_tensor(pr._rb_params(1.5, 0.1, 103.0, math.log(1.03),
                                                            100.0, 1.0, -0.7)).unbind()))
    iv = torch.linspace(0.01, 0.09, 9)
    j = torch.linspace(-0.2, 0.2, 9)
    y, _, _, _, w, _ = pg.cond_bs_partials(iv, j, c)
    torch.testing.assert_close(y, hh_device.cond_bs_value(iv, j, c), rtol=0, atol=0)
    h = 1e-3
    up = dict(c, f_base=c["f_base"] * math.exp(h), log_f_over_k=c["log_f_over_k"] + h)
    dn = dict(c, f_base=c["f_base"] * math.exp(-h), log_f_over_k=c["log_f_over_k"] - h)
    fd = (hh_device.cond_bs_value(iv, j, up) - hh_device.cond_bs_value(iv, j, dn)) / (2 * h)
    torch.testing.assert_close(w, fd, rtol=2e-3, atol=2e-3)


CHUNK_ROWS = 32  # Z rows of a chunk of K15's and K19's product (csrc/rbergomi.cu kChunkRows)


@pytest.mark.parametrize("qmc", [False, True], ids=["PRNG", "QMC"])
@pytest.mark.parametrize("steps", [1, 64, 256])
def test_curve_vjp_shared_memory_fits(steps, qmc):
    """K18's layout on the chunked product (csrc/rbergomi.cu rb_curve_smem:
    64 pairs' ξ columns of 2·steps rows padded to whole tiles, two 32-row
    chunks, the Sobol' table) counted by hand, under the H100's 227 KB a
    block up to STAGED_STEPS."""
    zcols = 8 * -(-(steps - 1) // 8)
    want = 4 * 64 * (steps + zcols + 64) + (4 * 2 * steps * 31 if qmc else 0)
    got = pr.curve_smem_bytes(steps, qmc)
    assert got == want <= pr.SMEM_PER_BLOCK
    if steps == pr.STAGED_STEPS and qmc:
        assert got == 206 * 1024  # the largest: 128 KB of ξ, 16 KB of chunks, 62 KB of table


# an H100 SM's shared memory, what the runtime reserves a block, and the
# price kernels' static float64 reduction (csrc/rbergomi.cu red[64])
SM_SMEM, BLOCK_RESERVED, RED_BYTES = 228 * 1024, 1024, 8 * 64


@pytest.mark.parametrize("qmc", [False, True], ids=["PRNG", "QMC"])
@pytest.mark.parametrize("steps", [2, 3, 33, 64, 256])
def test_greek_kernel_shared_memory_is_the_price_kernels(steps, qmc):
    """K16's layout on the tangent chunk product (csrc/rbergomi.cu
    rb_greeks_smem: 64 pairs' ξ columns of 2·steps rows padded to whole
    tiles, two 16-row chunks for Z and its H tangent, the Sobol' table)
    counted by hand is K15's (one 32-row chunk), under 227 KB a block up to
    STAGED_STEPS; so by shared memory an H100 SM holds as many K16 blocks as
    K15 blocks: 5 on Philox and 4 under QMC at 64 steps, K15's grid one
    wave of both."""
    zcols = 8 * -(-(steps - 1) // 8)
    table = 4 * 2 * steps * 31 if qmc else 0
    k15 = 4 * 64 * (steps + zcols + CHUNK_ROWS) + table
    got = pr.greeks_smem_bytes(steps, qmc)
    assert got == 4 * 64 * (steps + zcols + 2 * (CHUNK_ROWS // 2)) + table == k15
    assert got <= pr.SMEM_PER_BLOCK
    blocks = SM_SMEM // (got + RED_BYTES + BLOCK_RESERVED)
    assert blocks == SM_SMEM // (k15 + RED_BYTES + BLOCK_RESERVED) >= 1
    if steps == 64:
        assert blocks == (4 if qmc else 5)


def test_pack_as_the_chunked_product_reads_it():
    """For every step count 1..STAGED_STEPS, a factor with the Volterra
    structure (random entries) packs to (tiles, zcols, 2·TILE); read as the
    chunked product reads it (the chunk's warp w takes tile 4·chunk + w, a
    lane's rows 4h..4h+3 from float4 quarter h of (tile, column c) for the
    increments and 2 + h for Z, columns 0..row in order), the pack gives L's
    entries at every consumed row and column and zero past a row's last
    column and in the padding rows; the chunks cover the n − 1 consumed rows."""
    rng = np.random.default_rng(7)
    for n in range(1, pr.STAGED_STEPS + 1):
        m = np.zeros((2 * n, 2 * n), dtype=np.float32)
        m[np.arange(n), np.arange(n)] = rng.uniform(0.5, 1.0, n)
        for j in range(n - 1):
            m[n + j, : j + 1] = rng.uniform(-1.0, 1.0, j + 1)
            m[n + j, n: n + j + 1] = rng.uniform(-1.0, 1.0, j + 1)
        pack = pr._pack(m, n, "chol")
        tiles, cols = -(-(n - 1) // pr.TILE), pr.zcols(n)
        assert pack.shape == (tiles, cols, 2 * pr.TILE) and cols == tiles * pr.TILE
        chunks = -(-(n - 1) // CHUNK_ROWS)
        assert chunks * CHUNK_ROWS >= n - 1 and (chunks - 1) * CHUNK_ROWS < max(n - 1, 1)
        # float4 (tile, c, quarter) -> row tile·TILE + 4·h + i, column c
        quads = pack.reshape(tiles, cols, 4, 4)
        got_inc, got_z = (quads[:, :, q: q + 2, :].transpose(0, 2, 3, 1).reshape(tiles * pr.TILE, cols)
                          for q in (0, 2))
        want_inc, want_z = (np.zeros((tiles * pr.TILE, cols), np.float32) for _ in range(2))
        want_inc[: n - 1, : n - 1] = np.tril(m[n: 2 * n - 1, : n - 1])
        want_z[: n - 1, : n - 1] = np.tril(m[n: 2 * n - 1, n: 2 * n - 1])
        np.testing.assert_array_equal(got_inc, want_inc)
        np.testing.assert_array_equal(got_z, want_z)


@pytest.mark.parametrize("qmc", [False, True], ids=["PRNG", "QMC"])
@pytest.mark.parametrize("steps", [1, 2, 3, 33, 64, 256])
def test_values_and_vjp_shared_memory_are_the_chunk_kernels(steps, qmc):
    """K14's layout (csrc/rbergomi.cu rb_chunk_smem: 64 pairs' ξ columns of
    2·steps rows padded to whole tiles, one 32-row chunk of Z, the Sobol'
    table) counted by hand is K15's, and K17's (rb_greeks_smem: two 16-row
    chunks for Z and its H tangent) is K16's, the same bytes; under the
    H100's 227 KB a block up to STAGED_STEPS, and by shared memory 5 blocks an
    SM on Philox and 4 under QMC at 64 steps, as K15 and K16."""
    zcols = 8 * -(-(steps - 1) // 8)
    table = 4 * 2 * steps * 31 if qmc else 0
    k15 = 4 * 64 * (steps + zcols + CHUNK_ROWS) + table
    values, vjp = pr.values_smem_bytes(steps, qmc), pr.vjp_smem_bytes(steps, qmc)
    assert values == k15
    assert vjp == 4 * 64 * (steps + zcols + 2 * (CHUNK_ROWS // 2)) + table
    assert vjp == pr.greeks_smem_bytes(steps, qmc) == values
    assert values <= pr.SMEM_PER_BLOCK
    for got in (values, vjp):
        blocks = SM_SMEM // (got + RED_BYTES + BLOCK_RESERVED)
        assert blocks >= 1
        if steps == 64:
            assert blocks == (4 if qmc else 5)
    if steps == pr.STAGED_STEPS and qmc:
        assert values == 198 * 1024  # 128 KB of ξ, 8 KB of chunk, 62 KB of table


def _values_trip_writes(n_paths: int, wave: int, antithetic: bool) -> np.ndarray:
    """The output indices K14 writes, by its trip mapping (csrc/rbergomi.cu
    rb_values_kernel): grid min(wave, ceil(n / 64)) blocks; block b's trip r
    takes pairs base + t, base = 64·b + 64·grid·r, t < 64, while base < n;
    of slot t, thread 2t writes out[pair] and, under antithetic, thread
    2t + 1 out[n + pair]; a pair >= n is masked."""
    grid = min(wave, -(-n_paths // pr.BLOCK_PAIRS))
    trips = -(-n_paths // (grid * pr.BLOCK_PAIRS))
    b, r, t = np.meshgrid(np.arange(grid), np.arange(trips), np.arange(pr.BLOCK_PAIRS),
                          indexing="ij")
    base = pr.BLOCK_PAIRS * b + pr.BLOCK_PAIRS * grid * r
    pair = (base + t)[(base < n_paths) & (base + t < n_paths)]
    return np.concatenate([pair, n_paths + pair]) if antithetic else pair


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "one-group"])
@pytest.mark.parametrize("wave", [1, 7, 528, 660])
@pytest.mark.parametrize("n_paths", [1, 63, 64, 65, 4097, 3 * 2**14 + 5, 2**20 + 5])
def test_values_trip_mapping_writes_each_value_once(n_paths, wave, antithetic):
    """K14's trips on a resident wave (ragged n, grids from one block to an
    H100's 5 a SM) write every output value of the (1 or 2, n) array exactly
    once and nothing past it."""
    writes = _values_trip_writes(n_paths, wave, antithetic)
    size = (2 if antithetic else 1) * n_paths
    assert writes.min() >= 0 and writes.max() < size
    np.testing.assert_array_equal(np.bincount(writes, minlength=size), np.ones(size, np.int64))
