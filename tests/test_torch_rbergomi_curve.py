"""The rest of the rough-Bergomi kernels' plain twins: K18 (the values' VJP
under a piecewise-linear forward-variance curve, one row per step) and K19
(one path set closing a strike grid), against the Pallas kernels run in
interpret mode on the CPU on the in-kernel Sobol' stream (the Pallas PRNG
stream has no CPU form); then the twins against K17 and K15 on both
streams, and the kernel route's curve gradients against the float64
estimator's.

Each JAX kernel is called once, in a module-scoped fixture, at the JAX
package's test market (tests/unit/test_rbergomi_kernel.py) and 8 steps: K18
and ``jax.grad`` through JAX's curve view at 2048 pairs, K19 at 2 × 2048
pairs for a call and for a put.  Interpret mode's reciprocal is
bfloat16-accurate before its Newton polish (tests/test_torch_rbergomi_kernel.py),
so sums agree to ~1e-5 relative, not to the bit."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.ops import rbergomi_kernel as jr
from hedgehog_tpu_torch.ops import rbergomi_kernel as pr

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
STEPS, SEED, VJP_PAIRS = 8, 3, 2048
T = 366 / 365
XI, TENORS = (0.04, 0.05, 0.035), (0.1, 0.5, 1.0)
# spot, xi, tenors, eta, hurst, rho, r0, T, strike
P9 = (100.0, XI, TENORS, 1.5, 0.1, -0.7, 0.03, T, 95.0)
NAMES9 = ("spot", "xi", "tenors", "eta", "hurst", "rho", "r0", "T", "strike")
SMILE_STRIKES = (85.0, 100.0, 125.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops on tensors of 2^11-2^13 elements: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cotangent(n_groups, n):
    """The smooth per-path cotangent of the JAX package's VJP tests."""
    return 0.5 + 0.5 * np.sin(np.arange(n_groups * n, dtype=np.float64).reshape(n_groups, n))


def _problem(cp="call", strike=100.0, xi0=0.04, eta=1.5, hurst=0.1, rho=-0.7):
    mkt = hh.RoughBergomiInputs(REF, 0.03, 100.0, xi0, eta, hurst, rho)
    side = hh.Call() if cp == "call" else hh.Put()
    return hh.PricingProblem(hh.VanillaOption(strike, EXPIRY, hh.European(), side, hh.Spot()), mkt)


def _config(paths=4096, steps=STEPS, qmc=True, seed=SEED):
    return hh.SimulationConfig(trajectories=paths, steps=steps, variance_reduction=hh.Antithetic(),
                               seed=seed, qmc=qmc)


def _jax_args():
    return (P9[0], jnp.asarray(XI), jnp.asarray(TENORS), *P9[3:])


@pytest.fixture(scope="module")
def jax_vjp_curve():
    grads = jr._rb_values_vjp_curve(*_jax_args(), 1.0, jnp.asarray(_cotangent(2, VJP_PAIRS)),
                                    n_paths=VJP_PAIRS, steps=STEPS, seed=5, antithetic=True,
                                    qmc=True, interpret=True)
    return [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def jax_curve_grad():
    """``jax.grad`` of a weighted sum through JAX's curve view (its custom
    VJP is the interpret-mode K18), in all nine arguments."""
    ct = jnp.asarray(_cotangent(2, VJP_PAIRS)) / (2 * VJP_PAIRS)

    def loss(*args):
        vals = jr.rbergomi_mixing_values_diff_curve(*args, 1.0, n_paths=VJP_PAIRS, steps=STEPS,
                                                    seed=5, antithetic=True, qmc=True,
                                                    interpret=True)
        return jnp.sum(ct * vals)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(9)))(*_jax_args())]


@pytest.fixture(scope="module", params=["call", "put"])
def jax_smile(request):
    cp = request.param
    prices = jr.rbergomi_kernel_smile(_problem(cp), _config(), list(SMILE_STRIKES), n_blocks=2,
                                      n_batches=1, interpret=True)
    return cp, np.asarray(prices)


def test_vjp_curve_twin_matches_interpret_kernel(jax_vjp_curve):
    """K18's nine gradients (the bucket vegas and the tenor sensitivities
    per spine point) under a smooth cotangent at 2048 pairs: rel 5e-3 or abs
    5e-3, the tolerance of K17's test (fp32 tangent sums of many terms)."""
    got = pr._rb_values_vjp_curve(*P9, 1.0, torch.as_tensor(_cotangent(2, VJP_PAIRS)),
                                  n_paths=VJP_PAIRS, steps=STEPS, seed=5, antithetic=True,
                                  qmc=True)
    assert len(got) == 9
    assert got[1].shape == got[2].shape == (3,)
    for name, g, w in zip(NAMES9, got, jax_vjp_curve):
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-3, atol=5e-3, err_msg=name)


def test_autograd_through_the_curve_view_matches_jax_grad(jax_curve_grad):
    """``torch.autograd.grad`` through the port's curve view (K14 forward,
    K18 backward, their twins here) against ``jax.grad`` through JAX's:
    rel 5e-3 or abs 1e-4 in all nine arguments, the bucket vegas, the
    tenors, T and the strike included."""
    ct = torch.as_tensor(_cotangent(2, VJP_PAIRS)) / (2 * VJP_PAIRS)
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in P9]
    spot, xi, tenors, *rest = leaves
    vals = pr.rbergomi_mixing_values_diff(spot, ht.ForwardVarianceCurve(tenors, xi), *rest, 1.0,
                                          n_paths=VJP_PAIRS, steps=STEPS, seed=5, antithetic=True,
                                          qmc=True, device="cpu")
    assert vals.shape == (2, VJP_PAIRS) and vals.dtype == torch.float32
    grads = torch.autograd.grad((ct * vals.double()).sum(), leaves)
    for name, g, w in zip(NAMES9, grads, jax_curve_grad):
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-3, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_flat_curve_vegas_sum_to_the_scalar_gradient(qmc):
    """Every level 0.04: the interpolation's weights sum to one, so the
    bucket vegas sum to K17's xi0 gradient on the same stream and cotangent
    (the per-step rows summed against K17's one row: rel 1e-6), the tenor
    sensitivities are exactly 0, and the seven other gradients equal K17's
    to the bit (the same coefficients and fp32 rows)."""
    ct = torch.as_tensor(_cotangent(2, 1024))
    kw = dict(n_paths=1024, steps=STEPS, seed=5, antithetic=True, qmc=qmc)
    rest = (1.5, 0.1, -0.7, 0.03, T, 95.0, 1.0, ct)
    curve = pr._rb_values_vjp_curve(100.0, [0.04] * 3, TENORS, *rest, **kw)
    flat = pr._rb_values_vjp(100.0, 0.04, *rest, **kw)
    assert float(curve[1].sum()) == pytest.approx(float(flat[1]), rel=1e-6)
    assert curve[2].tolist() == [0.0, 0.0, 0.0]
    for a, b in zip((curve[0], *curve[3:]), (flat[0], *flat[2:])):
        assert float(a) == float(b)


def test_smile_twin_matches_interpret_kernel(jax_smile):
    """K19 at 2 × 2048 pairs for a call and a put at strikes 85, 100, 125:
    each price within 3e-5 of the interpret kernel's (its bf16-estimate
    reciprocal, as K15's test); calls fall and puts rise in the strike."""
    cp, want = jax_smile
    got = pr.rbergomi_kernel_smile(ht.from_reference(_problem(cp)), ht.from_reference(_config()),
                                   SMILE_STRIKES, n_blocks=2, n_batches=1, device="cpu")
    assert got.shape == (3,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5)
    steps = np.diff(got.numpy())
    assert (steps < 0).all() if cp == "call" else (steps > 0).all()


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_smile_twin_equals_the_price_twin_per_strike(qmc):
    """Each strike of K19's twin is K15's twin at that strike to the bit:
    the same pairs, (IV, J) and close, log(f/K) cast once from float64."""
    cfg = ht.from_reference(_config(qmc=qmc, seed=11))
    kw = dict(n_blocks=1, n_batches=2, seed=11, device="cpu")
    smile = pr.rbergomi_kernel_smile(ht.from_reference(_problem()), cfg, SMILE_STRIKES, **kw)
    for k, strike in enumerate(SMILE_STRIKES):
        ins = pr._rb_trace_inputs(ht.from_reference(_problem(strike=strike)), cfg, 64)
        price = pr.rbergomi_mixing_vanilla_price(*ins.price_args(), steps=STEPS, qmc=qmc, **kw)
        assert float(smile[k]) == float(price), strike


def test_smile_past_64_strikes_matches_the_jax_estimator_and_the_price_twin():
    """81 strikes, past the 64 one launch of K19 takes (the kernel is
    launched a chunk of MAX_STRIKES strikes at a time; the JAX kernel checks
    only steps >= 2 and the Sobol' period): the twin's smile against the
    JAX package's float64 estimator with the strike vector on the same QMC
    points, 4096 pairs: each strike within 2e-5 relative (measured 5.6e-6);
    and each strike at the chunk edge (the 64th and 65th) and at both ends
    equal to K15's twin at that strike to the bit."""
    strikes = np.linspace(60.0, 140.0, 81)
    assert len(strikes) > pr.MAX_STRIKES
    cfg = _config()
    vec = hh.PricingProblem(hh.VanillaOption(strikes, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                            _problem().market_inputs)
    want = np.asarray(hh.solve(vec, hh.MonteCarlo(hh.RoughBergomiDynamics(),
                                                  hh.RoughBergomiMixing(), cfg)).price)
    kw = dict(n_blocks=1, n_batches=2, seed=SEED, device="cpu")
    smile = pr.rbergomi_kernel_smile(ht.from_reference(_problem()), ht.from_reference(cfg),
                                     strikes, **kw)
    assert smile.shape == (81,)
    np.testing.assert_allclose(smile.numpy(), want, rtol=2e-5, atol=0)
    for k in (0, pr.MAX_STRIKES - 1, pr.MAX_STRIKES, 80):
        ins = pr._rb_trace_inputs(ht.from_reference(_problem(strike=float(strikes[k]))),
                                  ht.from_reference(cfg), 64)
        price = pr.rbergomi_mixing_vanilla_price(*ins.price_args(), steps=STEPS, qmc=True, **kw)
        assert float(smile[k]) == float(price), k


def test_smile_guards():
    ins = pr._rb_trace_inputs(ht.from_reference(_problem()), ht.from_reference(_config()), 64)
    args = (ins.chol, ins.coefs, ins.eta, ins.dt, ins.f_base)
    tail = (ins.cp, ins.rho, ins.discount)
    with pytest.raises(ValueError, match="at least one strike"):
        pr.rbergomi_mixing_smile_price(*args, [], *tail, n_blocks=1, n_batches=1, steps=STEPS,
                                       seed=0, device="cpu")
    with pytest.raises(ValueError, match="steps >= 2"):
        pr.rbergomi_mixing_smile_price(*args, [100.0], *tail, n_blocks=1, n_batches=1, steps=1,
                                       seed=0, device="cpu")
    with pytest.raises(ValueError, match="period"):
        pr.rbergomi_mixing_smile_price(*args, [100.0], *tail, n_blocks=2**19, n_batches=1,
                                       steps=STEPS, seed=0, qmc=True, point_offset=1,
                                       device="cpu")
    with pytest.raises(ValueError, match="steps >= 2"):
        pr.rbergomi_mixing_values_diff(P9[0], ht.ForwardVarianceCurve(TENORS, XI), *P9[3:], 1.0,
                                       n_paths=8, steps=1, seed=0, device="cpu")


# ---- the kernel route under a curve against the float64 estimator -----------------

#: chip_smoke.py's curve (tenors 0.25, 0.5, 1.0; levels 0.035, 0.04, 0.045) at
#: its rough-Bergomi market (eta 1.9, H 0.08, rho -0.9) and 64 steps
CHIP_TENORS, CHIP_LEVELS = (0.25, 0.5, 1.0), (0.035, 0.04, 0.045)
#: fp32 and the approximate ndtri against float64 and the exact one: the
#: largest gap of the eight gradients below, over (|own| + the largest),
#: was 2.1e-7 at 2048 pairs, 3.0e-6 at 8192 and 5.9e-7 at 65,536 (the twin on
#: this test's market); chip_smoke.py holds the card to the same bound at
#: 2^20 pairs
CURVE_GRAD_RTOL = 1e-4


def _curve_solve_grads(use_kernel, pairs, steps=64):
    xi = torch.tensor(CHIP_LEVELS, dtype=torch.float64, requires_grad=True)
    scalars = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in (100.0, 1.9, 0.08, -0.9, 0.03)]
    spot, eta, hurst, rho, r = scalars
    mkt = ht.RoughBergomiInputs(REF, r, spot, ht.ForwardVarianceCurve(CHIP_TENORS, xi), eta, hurst,
                                rho)
    prob = ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2024, 12, 31)), mkt)
    cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 0, True)
    sol = ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(),
                                       ht.RoughBergomiMixing(use_kernel=use_kernel), cfg,
                                       device="cpu"))
    grads = torch.autograd.grad(sol.price, [xi, *scalars])
    return float(sol.price.detach()), torch.cat([g.reshape(-1) for g in grads])


def test_curve_solve_gradients_match_the_float64_estimator():
    """``RoughBergomiMixing(use_kernel=True)`` under a sloped curve, its
    gradients from K18's twin (three bucket vegas, spot, eta, H, rho, the
    rate) against ``torch.autograd.grad`` of the float64 estimator on the
    same 2048 QMC pairs at 64 steps: each within ``CURVE_GRAD_RTOL`` of
    itself plus ``CURVE_GRAD_RTOL`` of the largest, the prices within 1e-5."""
    k_price, got = _curve_solve_grads(True, 2048)
    f_price, want = _curve_solve_grads(False, 2048)
    assert k_price == pytest.approx(f_price, rel=1e-5)
    bound = CURVE_GRAD_RTOL * (want.abs() + want.abs().max())
    assert bool(((got - want).abs() <= bound).all()), (got, want)
