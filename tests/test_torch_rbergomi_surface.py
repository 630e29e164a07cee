"""``rbergomi_surface_mc``, the one-simulation rough-Bergomi (expiry ×
strike) surface, against the JAX package's: under QMC the same points
(float64 to rel 1e-10, the float32 bulk at a float32 tolerance) and the same
gradients in H, η, ρ and the curve's levels; under PRNG (the port's Philox
stream, not JAX's) against standalone float64 solves, as the JAX package's
own test does; and the expiry guards.  2-3 expiries, 16 steps, 2048 pairs,
except the PRNG test (30,000 pairs at 48 steps, the JAX test's shape)."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu_torch.methods.rough_bergomi_surface import surface_times

REF = dt.date(2024, 1, 1)
EXPIRIES = (dt.date(2024, 4, 1), dt.date(2024, 7, 1), dt.date(2025, 1, 1))
STRIKES = (85.0, 100.0, 115.0)
TENORS, LEVELS = (0.25, 0.5, 1.0), (0.035, 0.04, 0.045)
ROUGH = dict(eta=1.9, hurst=0.08, rho=-0.8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_market(xi0=0.04, eta=1.5, hurst=0.1, rho=-0.7):
    return hh.RoughBergomiInputs(REF, 0.03, 100.0, xi0, eta, hurst, rho)


def _config(pairs=2048, steps=16, qmc=True, seed=3):
    return hh.SimulationConfig(trajectories=pairs, steps=steps, variance_reduction=hh.Antithetic(),
                               seed=seed, qmc=qmc)


@pytest.mark.parametrize("fp32", [False, True], ids=["float64", "fp32"])
def test_qmc_surface_matches_reference(fp32):
    """The same Sobol' points through the same non-uniform grid: float64 to
    rel 1e-10; the float32 bulk (draws, product, cumulative sums) to rel
    2e-5, where the two frameworks' float32 products and sums round in
    other orders."""
    mkt = _jax_market(**ROUGH)
    want = np.asarray(hh.rbergomi_surface_mc(mkt, list(EXPIRIES), jnp.asarray(STRIKES), _config(),
                                             fp32=fp32))
    got = ht.rbergomi_surface_mc(ht.from_reference(mkt), EXPIRIES, STRIKES,
                                 ht.from_reference(_config()), fp32=fp32, device="cpu")
    assert got.shape == (3, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5 if fp32 else 1e-10)


def test_surface_puts_and_grid():
    """Puts through ``cp``, the grid's expiry indices on the expiries, and
    put-call parity on the same paths: C − P + DF·K is one number per expiry
    (DF times the paths' mean conditional forward; float64 rounding across
    strikes), within 1e-2 of the spot (the mean's QMC error)."""
    mkt = _jax_market(**ROUGH)
    cfg = ht.from_reference(_config())
    times, idx = surface_times([float(ht.yearfrac(REF, e)) for e in EXPIRIES], cfg.steps)
    assert len(times) == cfg.steps and [times[i] for i in idx] == [
        float(ht.yearfrac(REF, e)) for e in EXPIRIES]
    kw = dict(device="cpu")
    calls = ht.rbergomi_surface_mc(ht.from_reference(mkt), EXPIRIES, STRIKES, cfg, **kw)
    puts = ht.rbergomi_surface_mc(ht.from_reference(mkt), EXPIRIES, STRIKES, cfg, cp=-1.0, **kw)
    want = np.asarray(hh.rbergomi_surface_mc(mkt, list(EXPIRIES), jnp.asarray(STRIKES), _config(),
                                             cp=-1.0))
    np.testing.assert_allclose(puts.numpy(), want, rtol=1e-10)
    for i, e in enumerate(EXPIRIES):
        T = float(ht.yearfrac(REF, e))
        forward = (calls[i] - puts[i]).numpy() + np.exp(-0.03 * T) * np.asarray(STRIKES)
        np.testing.assert_allclose(forward, forward[0], rtol=1e-12)
        assert forward[0] == pytest.approx(100.0, rel=1e-2)


def test_surface_gradients_match_jax_grad():
    """``torch.autograd.grad`` of the surface's sum against ``jax.grad`` in
    H, η, ρ and the forward-variance curve's three levels, QMC points:
    float64 on both sides, rel 1e-8."""

    def jax_sum(hurst, eta, rho, xi):
        mkt = hh.RoughBergomiInputs(REF, 0.03, 100.0,
                                    hh.ForwardVarianceCurve(jnp.asarray(TENORS), xi), eta, hurst,
                                    rho)
        return jnp.sum(hh.rbergomi_surface_mc(mkt, list(EXPIRIES), jnp.asarray(STRIKES),
                                              _config()))

    want = jax.grad(jax_sum, argnums=(0, 1, 2, 3))(0.08, 1.9, -0.8, jnp.asarray(LEVELS))
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (0.08, 1.9, -0.8, LEVELS)]
    hurst, eta, rho, xi = leaves
    mkt = ht.RoughBergomiInputs(REF, 0.03, 100.0, ht.ForwardVarianceCurve(TENORS, xi), eta, hurst,
                                rho)
    surf = ht.rbergomi_surface_mc(mkt, EXPIRIES, STRIKES, ht.from_reference(_config()),
                                  device="cpu")
    got = torch.autograd.grad(surf.sum(), leaves)
    for name, g, w in zip(("hurst", "eta", "rho", "xi"), got, want):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, err_msg=name)


def test_prng_surface_matches_standalone_solves():
    """PRNG (the port's Philox stream): each row within rel 3e-2 of an
    independent one-expiry float64 mixing solve at that expiry, and
    ∂Σsurface/∂H finite (tests/unit/test_rough_bergomi.py:306-325)."""
    mkt = ht.from_reference(_jax_market(xi0=0.04, **ROUGH))
    exps = (dt.date(2024, 7, 1), dt.date(2024, 12, 31))
    ks = (90.0, 100.0, 110.0)
    surf = ht.rbergomi_surface_mc(mkt, exps, ks, ht.SimulationConfig(30_000, 48, ht.Antithetic(), 0,
                                                                     False), device="cpu")
    assert surf.shape == (2, 3)
    for i, e in enumerate(exps):
        prob = ht.PricingProblem(ht.VanillaOption(torch.tensor(ks, dtype=torch.float64), e), mkt)
        cfg = ht.SimulationConfig(30_000, 24, ht.Antithetic(), 5, False)
        p = ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(), cfg,
                                         device="cpu")).price
        np.testing.assert_allclose(surf[i].numpy(), p.detach().numpy(), rtol=3e-2)
    hurst = torch.tensor(0.08, dtype=torch.float64, requires_grad=True)
    small = ht.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.9, hurst, -0.8)
    total = ht.rbergomi_surface_mc(small, exps, ks, ht.SimulationConfig(2_000, 16, seed=1),
                                   device="cpu").sum()
    (g,) = torch.autograd.grad(total, hurst)
    assert bool(torch.isfinite(g))


def test_surface_expiry_guards():
    mkt = ht.from_reference(_jax_market())
    cfg = ht.from_reference(_config())
    for bad in ([], [dt.date(2024, 7, 1), dt.date(2024, 4, 1)], [REF]):
        with pytest.raises(ValueError, match="expir"):
            ht.rbergomi_surface_mc(mkt, bad, STRIKES, cfg, device="cpu")
