"""The grids of the path-dependent payoffs against the JAX package on the
CPU: the exact-transition Heston grid (S, V, ∫V) and the rough-Bergomi
log-Euler grid, per path on the same Sobol' points to 1e-9 relative, and the
routes that reach them through ``simulate_price_grid`` and
``simulate_terminal_prices``.  Under PRNG the exact grid's V and ∫V are the
exact-mixing estimator's draws bit for bit; on both streams the
rough-Bergomi draw's first 2n rows keep their bits when the Euler grid asks
for 3n."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import heston_exact_mixing as pexact
from hedgehog_tpu_torch.methods import montecarlo as pmc
from hedgehog_tpu_torch.methods import rough_bergomi_mixing as prb

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CPU = "cpu"
PAIRS = 1 << 10
HESTON = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.5, -0.7)
RBERGOMI = hh.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.9, 0.1, -0.9)
VANILLA = hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())


def _close(got, want, rtol=1e-9, atol=0.0):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _cfg(steps, qmc=True, anti=True, seed=5, pairs=PAIRS):
    vr = hh.Antithetic() if anti else hh.NoVarianceReduction()
    return hh.SimulationConfig(pairs, steps, vr, seed, qmc)


@pytest.mark.parametrize("steps,anti", [(1, True), (4, True), (4, False)])
def test_exact_grid_matches_reference_per_path(steps, anti):
    prob = hh.PricingProblem(VANILLA, HESTON)
    cfg = _cfg(steps, anti=anti)
    want = jmc.simulate_exact_conditional_grid(prob, cfg)
    got = pmc.simulate_exact_conditional_grid(ht.from_reference(prob), ht.from_reference(cfg),
                                              device=CPU)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_exact_grid_prng_keeps_the_exact_mixing_draws():
    """Under PRNG the grid's V_T and Σ∫V are the exact-mixing estimator's bit
    for bit, so the conditional close of them is its values; the z⊥ stream
    is a tagged block of its own."""
    prob = ht.from_reference(hh.PricingProblem(VANILLA, HESTON))
    cfg = ht.from_reference(_cfg(4, qmc=False))
    s, v, iv = pmc.simulate_exact_conditional_grid(prob, cfg, device=CPU)
    market, T, r0 = pmc.sim_params(prob)
    vals, _ = pexact.heston_exact_mixing_values(prob, cfg, device=CPU, with_score=True)
    ivs = torch.sum(iv, dim=1)
    j = (v[:, -1] - market.V0 - market.kappa * market.theta * T + market.kappa * ivs) / market.sigma
    assert torch.equal(pexact._conditional_bs_close(prob, market, T, r0, ivs, j), vals)
    assert bool(torch.all(s > 0)) and bool(torch.all(iv > 0))
    # the log-price's orthogonal normals: mirrored across the pair, not the Z_gam stream
    x = torch.log(s)
    assert not torch.allclose(x[0], x[1])


@pytest.mark.parametrize("steps,anti", [(4, True), (7, False)])
def test_rbergomi_euler_grid_matches_reference_per_path(steps, anti):
    """JAX's ``_rbergomi_euler_paths`` and its terminal prices are this grid
    and its last column."""
    prob = hh.PricingProblem(VANILLA, RBERGOMI)
    cfg = _cfg(steps, anti=anti)
    want_s, want_v = jmc._rbergomi_grid_with_variance(prob, cfg, None)
    pprob, pcfg = ht.from_reference(prob), ht.from_reference(cfg)
    got_s, got_v = prb.rbergomi_grid_with_variance(pprob, pcfg, device=CPU)
    _close(got_s, want_s)
    _close(got_v, want_v)
    method = ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.EulerMaruyama(), pcfg, device=CPU)
    _close(ht.simulate_price_grid(pprob, method), want_s)
    _close(ht.simulate_terminal_prices(pprob, method), want_s[:, -1])


def test_rbergomi_euler_vanilla_solve_matches_reference():
    prob = hh.PricingProblem(VANILLA, RBERGOMI)
    jmethod = hh.MonteCarlo(hh.RoughBergomiDynamics(), hh.EulerMaruyama(), _cfg(4))
    method = dataclasses.replace(ht.from_reference(jmethod), device=CPU)
    _close(ht.solve(ht.from_reference(prob), method).price, hh.solve(prob, jmethod).price,
           rtol=1e-10)


@pytest.mark.parametrize("qmc", [False, True])
def test_rbergomi_extra_rows_keep_the_mixing_rows(qmc):
    """Philox rows depend on their index only; a Sobol' dimension's
    direction numbers and digital-shift word on its index only (the
    partitionable threefry), so the mixing estimator's 2n rows keep their
    bits when the Euler grid draws 3n."""
    cfg = ht.from_reference(_cfg(6, qmc=qmc))
    two = prb.rbergomi_xi(cfg, 12, device=CPU)
    three = prb.rbergomi_xi(cfg, 18, device=CPU)
    assert tuple(three.shape) == (18, PAIRS)
    assert torch.equal(three[:12], two)
    assert bool(torch.isfinite(three).all())


def test_rbergomi_euler_refusals_match_reference():
    prob = ht.from_reference(hh.PricingProblem(VANILLA, RBERGOMI))
    for cfg, err in ((_cfg(4, qmc=False), TypeError), (_cfg(4, qmc=True), ValueError)):
        method = ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.EulerMaruyama(use_kernel=True),
                               ht.from_reference(cfg), device=CPU)
        with pytest.raises(err):
            ht.simulate_terminal_prices(prob, method)
        with pytest.raises(err):
            hh.simulate_terminal_prices(
                hh.PricingProblem(VANILLA, RBERGOMI),
                hh.MonteCarlo(hh.RoughBergomiDynamics(), hh.EulerMaruyama(use_kernel=True), cfg))


def test_grids_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    prob = ht.from_reference(hh.PricingProblem(VANILLA, HESTON))
    with pytest.raises(RuntimeError, match="cuda"):
        pmc.simulate_exact_conditional_grid(prob, ht.from_reference(_cfg(2)))
    method = ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.EulerMaruyama(),
                           ht.from_reference(_cfg(2)))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.simulate_price_grid(ht.from_reference(hh.PricingProblem(VANILLA, RBERGOMI)), method)
