"""The rough-Bergomi float64 port against the JAX package: the Volterra
covariance, its Cholesky factor and that factor's H derivative, the
kernels' host-side inputs, the mixing estimator per path, its gradients,
the η = 0 corner, the ξ streams, the dispatch guards and ``from_reference``.

Inputs are built in JAX and carried across by ``from_reference``; the
market is the JAX package's test market (tests/unit/test_rbergomi_kernel.py)
at 4096 pairs and 8-16 steps."""

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
from hedgehog_tpu.methods.montecarlo import _rbergomi_mixing_values
from hedgehog_tpu.models import rough_bergomi as jrb
from hedgehog_tpu.ops import rbergomi_kernel as jr
from hedgehog_tpu_torch.methods.rough_bergomi_mixing import rbergomi_mixing_values, rbergomi_xi
from hedgehog_tpu_torch.models import rough_bergomi as prb
from hedgehog_tpu_torch.models.dynamics import terminal_log_cf
from hedgehog_tpu_torch.ops import hh_device
from hedgehog_tpu_torch.ops import rbergomi_kernel as pr

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
PAIRS = 4096


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_problem(strike=100.0, xi0=0.04, eta=1.5, hurst=0.1, rho=-0.7, rate=0.03, spot=100.0,
                 call_put=None):
    mkt = hh.RoughBergomiInputs(REF, rate, spot, xi0, eta, hurst, rho)
    opt = hh.VanillaOption(strike, EXPIRY, hh.European(), call_put or hh.Call(), hh.Spot())
    return hh.PricingProblem(opt, mkt)


def _jax_config(steps=16, qmc=True, seed=3, paths=PAIRS):
    return hh.SimulationConfig(trajectories=paths, steps=steps, variance_reduction=hh.Antithetic(),
                               seed=seed, qmc=qmc)


def _method(cfg, **strategy):
    return ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(**strategy),
                         ht.from_reference(cfg), device="cpu")


@pytest.mark.parametrize("hurst", [0.05, 0.1, 0.3])
def test_covariance_and_factor_match_reference(hurst):
    """float64 on both sides from the same formulas: rel 1e-12 of the
    largest entry."""
    t = (np.arange(1, 9) / 8) * 1.3
    want = np.asarray(jrb.volterra_cov(hurst, jnp.asarray(t)))
    got = prb.volterra_cov(hurst, torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    want = np.asarray(jrb.volterra_chol(hurst, 1.3, 8))
    got = prb.volterra_chol(hurst, 1.3, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("hurst,T,n", [(0.1, 1.0, 8), (0.08, 366 / 365, 16), (0.3, 0.5, 4)])
def test_factor_derivative_matches_jacfwd(hurst, T, n):
    """dL/dH in closed form after one forward-mode tangent against
    ``jax.jacfwd`` of the factor: rel 1e-9 of the largest entry (two
    triangular solves against JAX's; the factor's conditioning amplifies
    float64 rounding to ~1e-12)."""
    want = np.asarray(jax.jacfwd(lambda h: jrb.volterra_chol(h, T, n))(hurst))
    got = prb.volterra_chol_dh(hurst, T, n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_the_factor_has_the_structure_the_kernels_read():
    """The ΔW block of L and dL/dH is diagonal and a Z row weighs no later
    increment, exactly: the packing drops only zeros, and raises for a
    matrix with weight outside the structure."""
    n = 8
    for m in (prb.volterra_chol(0.1, 1.0, n), prb.volterra_chol_dh(0.1, 1.0, n)):
        m = m.numpy()
        assert (m[:n, :n] == np.diag(np.diag(m[:n, :n]))).all()
        assert all((m[n + j, j + 1:n] == 0.0).all() for j in range(n))
        pr._pack(m, n, "m")
    with pytest.raises(ValueError, match="structure"):
        pr._pack(np.tril(np.ones((2 * n, 2 * n))), n, "dense")


def test_trace_inputs_match_reference():
    """The kernels' host inputs from a problem: the factor, the variance
    coefficients, dL/dH and the (ae, bh) columns within 1e-12 (1e-9 for
    dL/dH, as above); the close constants to float64 rounding."""
    prob, cfg = _jax_problem(), _jax_config(steps=8)
    want = jr._rb_trace_inputs(prob, cfg, 64)
    got = pr._rb_trace_inputs(ht.from_reference(prob), ht.from_reference(cfg), 64)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64), np.asarray(w), rtol=1e-12,
                                   atol=1e-14)
    want = jr._rb_greek_trace_inputs(prob, cfg, 64)
    got = pr._rb_greek_trace_inputs(ht.from_reference(prob), ht.from_reference(cfg), 64)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(want[1])).max())
    for w, g in zip(want[3], got[3]):  # ae, bh
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-15)
    T = float(want[-1])
    w = jr._rb_diff_coeffs(0.04, 1.5, 0.1, T, 8, 64)
    g = pr._rb_diff_coeffs(0.04, 1.5, 0.1, T, 8, 64)
    for i in (0, 2, 3, 4):
        np.testing.assert_allclose(g[i].numpy(), np.asarray(w[i]), rtol=1e-12, atol=1e-14)


def test_curve_coefficients_follow_the_interpolated_level():
    """Under a ForwardVarianceCurve the coefficients are ξ₀(t_k)·e^{−½η²t^{2H}}
    at the left points (``jnp.interp``, flat outside the spine)."""
    curve = hh.ForwardVarianceCurve(jnp.asarray([0.25, 0.5, 1.0]), jnp.asarray([0.03, 0.04, 0.05]))
    prob, cfg = _jax_problem(xi0=curve), _jax_config(steps=8)
    want = np.asarray(jr._rb_trace_inputs(prob, cfg, 64)[1])
    got = pr._rb_trace_inputs(ht.from_reference(prob), ht.from_reference(cfg), 64)[1].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    t = np.array([0.0, 0.1, 0.25, 0.3, 0.75, 1.0, 1.5])
    np.testing.assert_allclose(ht.from_reference(curve)(t).numpy(),
                               np.asarray(curve(jnp.asarray(t))), rtol=1e-15)


@pytest.mark.parametrize("steps", [8, 16])
def test_float64_estimator_matches_reference_per_path(steps):
    """QMC: JAX's points bit for bit, the exact ndtri, the same factor and
    float64 arithmetic: every path within rel 1e-10."""
    prob, cfg = _jax_problem(), _jax_config(steps=steps)
    want = np.asarray(_rbergomi_mixing_values(prob, cfg, jax.random.PRNGKey(3), quad_nodes=64))
    got = rbergomi_mixing_values(ht.from_reference(prob), ht.from_reference(cfg),
                                 device="cpu").numpy()
    assert got.shape == want.shape == (2, PAIRS)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_fp32_estimator_matches_reference_per_path():
    """``fp32=True``: float32 product and sums on both sides, each with its
    own float32 matrix product (XLA's and torch's sum the 2n terms in other
    orders): every path within rel 1e-5 (values below 1 absolutely), the
    means within 1e-6."""
    prob, cfg = _jax_problem(), _jax_config(steps=16)
    want = np.asarray(_rbergomi_mixing_values(prob, cfg, jax.random.PRNGKey(3), quad_nodes=64,
                                              fp32=True))
    got = rbergomi_mixing_values(ht.from_reference(prob), ht.from_reference(cfg), fp32=True,
                                 device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.mean() == pytest.approx(want.mean(), rel=1e-6)


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_solve_gradients_match_jax_grad(qmc):
    """``torch.autograd.grad`` of the float64 ``solve`` in (spot, xi0, eta,
    hurst, rho, rate) against ``jax.grad`` of the JAX solve on the same QMC
    points (rel 1e-8: float64 on both sides, the H chain through two
    Cholesky derivatives); PRNG draws another stream, so there the port's
    gradients are checked against its own central differences (rel 1e-5)."""
    names = ("spot", "xi0", "eta", "hurst", "rho", "rate")
    x0 = (100.0, 0.04, 1.5, 0.1, -0.7, 0.03)
    cfg = _jax_config(steps=8, qmc=qmc, paths=1024)
    method = _method(cfg)

    def port_price(*p):
        spot, xi0, eta, hurst, rho, rate = p
        mkt = ht.RoughBergomiInputs(REF, rate, spot, xi0, eta, hurst, rho)
        opt = ht.VanillaOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
        return ht.solve(ht.PricingProblem(opt, mkt), method).price

    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in x0]
    got = [float(g) for g in torch.autograd.grad(port_price(*leaves), leaves)]
    if qmc:
        def jax_price(p):
            spot, xi0, eta, hurst, rho, rate = p
            return hh.solve(_jax_problem(100.0, xi0, eta, hurst, rho, rate, spot),
                            hh.MonteCarlo(hh.RoughBergomiDynamics(), hh.RoughBergomiMixing(),
                                          cfg)).price

        want = np.asarray(jax.grad(jax_price)(jnp.asarray(x0)))
        for name, g, w in zip(names, got, want):
            assert g == pytest.approx(float(w), rel=1e-8, abs=1e-10), name
        return
    for i, (name, g) in enumerate(zip(names, got)):
        h = 1e-5 * max(abs(x0[i]), 1e-2)
        up, dn = list(x0), list(x0)
        up[i] += h
        dn[i] -= h
        fd = (float(port_price(*up)) - float(port_price(*dn))) / (2 * h)
        assert g == pytest.approx(fd, rel=1e-5, abs=1e-7), name


def test_eta_zero_is_black_scholes():
    """η = 0, ρ = 0: deterministic variance ξ₀ on every path, so the mixing
    close is the Black-Scholes price path by path (rel 1e-12, the JAX
    package's bound, tests/unit/test_rough_bergomi.py:69)."""
    mkt = ht.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 0.0, 0.1, 0.0)
    opt = ht.VanillaOption(100.0, dt.date(2024, 12, 31), ht.European(), ht.Call(), ht.Spot())
    cfg = ht.SimulationConfig(64, 8, ht.Antithetic(), 0)
    p = ht.solve(ht.PricingProblem(opt, mkt),
                 ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(), cfg,
                               device="cpu")).price
    p_bs = ht.solve(ht.PricingProblem(opt, ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2)),
                    ht.BlackScholesAnalytic(device="cpu")).price
    assert float(p) == pytest.approx(float(p_bs), rel=1e-12)


def test_strike_grid_and_flat_curve():
    """One variance-path set prices a strike grid (identical to scalar
    solves), and a flat ForwardVarianceCurve prices as its scalar level;
    under a sloped curve the bucketed vegas flow through autograd."""
    cfg = ht.SimulationConfig(1024, 8, ht.Antithetic(), 4)
    method = ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(), cfg, device="cpu")
    mkt = ht.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.5, 0.1, -0.7)
    ks = torch.tensor([80.0, 100.0, 120.0], dtype=torch.float64)
    grid = ht.solve(ht.PricingProblem(ht.VanillaOption(ks, EXPIRY), mkt), method).price
    singles = [float(ht.solve(ht.PricingProblem(ht.VanillaOption(float(k), EXPIRY), mkt),
                              method).price) for k in ks]
    np.testing.assert_allclose(grid.numpy(), singles, rtol=1e-12)
    flat = dataclasses.replace(mkt, xi0=ht.ForwardVarianceCurve([0.25, 1.0], [0.04, 0.04]))
    opt = ht.VanillaOption(100.0, EXPIRY)
    assert float(ht.solve(ht.PricingProblem(opt, flat), method).price) == singles[1]
    xi = torch.tensor([0.03, 0.06], dtype=torch.float64, requires_grad=True)
    sloped = dataclasses.replace(mkt, xi0=ht.ForwardVarianceCurve([0.0, 1.0], xi))
    (g,) = torch.autograd.grad(ht.solve(ht.PricingProblem(opt, sloped), method).price, xi)
    assert bool(torch.isfinite(g).all()) and float(g[1]) > 0.0


def test_dispatch_guards():
    """The JAX package's guards (tests/unit/test_rbergomi_kernel.py:120,
    tests/unit/test_rough_bergomi.py:296): a mismatched pairing, terminal
    samples of a conditional strategy, a characteristic function that does
    not exist, and strike grids on the kernel strategy all raise TypeError."""
    mkt = ht.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.5, 0.1, -0.7)
    prob = ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY), mkt)
    cfg = ht.SimulationConfig(64, 4, ht.Antithetic(), 0)
    with pytest.raises(TypeError, match="rough Bergomi"):
        ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.RoughBergomiMixing(), cfg,
                                     device="cpu"))
    with pytest.raises(TypeError, match="rough Bergomi"):
        ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.HestonQE(conditional=True),
                                     cfg, device="cpu"))
    with pytest.raises(TypeError, match="RoughBergomiDynamics"):
        ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.RoughBergomiDynamics(), device="cpu"))
    with pytest.raises(TypeError, match="no terminal law"):
        terminal_log_cf(prob, ht.RoughBergomiDynamics())
    with pytest.raises(TypeError, match="never materializes"):
        ht.simulate_terminal_prices(prob, _method(_jax_config(steps=4)))
    grid = ht.PricingProblem(ht.VanillaOption(torch.tensor([90.0, 100.0]), EXPIRY), mkt)
    kernel = ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(use_kernel=True), cfg,
                           device="cpu")
    with pytest.raises(TypeError, match="use_kernel"):
        ht.solve(grid, kernel)
    american = ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY, ht.American()), mkt)
    with pytest.raises(TypeError, match="European"):
        ht.solve(american, kernel)


def test_prng_stream_layout():
    """PRNG ξ: Philox block b of pair i, words (0, 1) → rows 4b, 4b+1 and
    (2, 3) → rows 4b+2, 4b+3 by Box–Muller with the radius uniform centred
    in its 2^-23 cell (a zero word gives |z| = 5.77, not the 13.2 of a
    FLT_MIN floor); the float64 estimator and the kernels' float32 twin
    draw the same uniforms; an explicit key reseeds the stream."""
    cfg = ht.SimulationConfig(256, 4, ht.Antithetic(), 11)
    xi = rbergomi_xi(cfg, 7, device="cpu")
    assert xi.shape == (7, 256) and xi.dtype == torch.float64
    pair = torch.arange(256)
    for b in range(2):
        w = hh_device.philox_block(pair, b, 11, 0)
        for q, (lo, hi) in enumerate(((0, 1), (2, 3))):
            z = hh_device.box_muller_open(w[lo], w[hi], dtype=torch.float64)
            for s in range(2):
                if 4 * b + 2 * q + s < 7:
                    torch.testing.assert_close(xi[4 * b + 2 * q + s], z[s], rtol=0, atol=0)
    zero = torch.zeros(1, dtype=torch.int64)
    r = torch.hypot(*hh_device.box_muller_open(zero, zero, dtype=torch.float64))
    assert float(r) == pytest.approx(math.sqrt(-2.0 * math.log(2.0**-24)), rel=1e-12)
    # the Heston draws' box_muller takes the same cell's centre (the TPU
    # kernels floor a zero word at FLT_MIN: 13.2 sigma)
    assert float(torch.hypot(*hh_device.box_muller(zero, zero))) == pytest.approx(float(r),
                                                                                  rel=1e-6)
    xi32 = pr.rb_xi(pair, 7, None, 11, 0, 0)
    torch.testing.assert_close(xi32.double(), xi, rtol=1e-5, atol=1e-5)
    other = rbergomi_xi(cfg, 7, key=np.array([0, 12], dtype=np.uint32), device="cpu")
    assert not torch.equal(other, xi)
    prob = ht.from_reference(_jax_problem())
    vals = rbergomi_mixing_values(prob, ht.from_reference(_jax_config(steps=4, qmc=False, paths=64)),
                                  device="cpu")
    assert vals.shape == (2, 64) and bool(torch.isfinite(vals).all())


def test_from_reference_carries_the_rough_bergomi_classes():
    """Every new class crosses by name and field; a field the port lacks
    (holding a value other than the reference's default) raises."""
    curve = hh.ForwardVarianceCurve(jnp.asarray([0.5, 1.0]), jnp.asarray([0.04, 0.05]))
    jm = hh.MonteCarlo(hh.RoughBergomiDynamics(), hh.RoughBergomiMixing(quad_nodes=32, fp32=True,
                                                                         use_kernel=True),
                       _jax_config())
    method = ht.from_reference(jm)
    assert isinstance(method.dynamics, ht.RoughBergomiDynamics)
    assert method.strategy == ht.RoughBergomiMixing(quad_nodes=32, fp32=True, use_kernel=True)
    market = ht.from_reference(hh.RoughBergomiInputs(REF, 0.03, 100.0, curve, 1.9, 0.08, -0.9))
    assert isinstance(market, ht.RoughBergomiInputs) and isinstance(market.xi0,
                                                                    ht.ForwardVarianceCurve)
    assert (market.eta, market.hurst, market.rho) == (1.9, 0.08, -0.9)
    np.testing.assert_array_equal(market.xi0.xi, [0.04, 0.05])

    @dataclasses.dataclass(frozen=True)
    class RoughBergomiMixing:  # the reference's class with a field the port lacks
        quad_nodes: int = 64
        antithetic_draws: int = 0

    ht.from_reference(RoughBergomiMixing())
    with pytest.raises(TypeError, match="antithetic_draws"):
        ht.from_reference(RoughBergomiMixing(antithetic_draws=2))
