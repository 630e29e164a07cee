"""The QE-M terminal sampler in float64 (models/heston_qe.py ``qe_step`` and
methods/heston_qe_paths.py, behind ``MonteCarlo(HestonDynamics(),
HestonQE())``) against the JAX package: the step to rel 1e-12, the QMC
terminals path by path, autograd through ``solve`` against ``jax.grad``,
and the PRNG price against Carr–Madan.  Inputs come from a numpy seed;
problems and methods are built in JAX and carried across by
``from_reference``."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.models import heston_qe as jm
from hedgehog_tpu_torch.models import heston_qe as pm
from hedgehog_tpu_torch.ops import heston_qe_kernel as pq

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
H = (0.04, 2.0, 0.04, 0.3, -0.7)
MARKET = hh.HestonInputs(REF, 0.03, 100.0, *H)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module's tests: they run thousands of small
    tensor operations, and under pytest-xdist the workers' intra-op thread
    pools contend for the same cores (a 1 s test here took 467 s in a
    six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(strike=100.0, cp=hh.Call(), market=MARKET):
    return hh.PricingProblem(hh.VanillaOption(strike, EXPIRY, hh.European(), cp, hh.Spot()),
                             market)


def _method(trajectories=2048, steps=6, seed=3, qmc=True, mcorr=True, use_kernel=False):
    cfg = hh.SimulationConfig(trajectories=trajectories, steps=steps,
                              variance_reduction=hh.Antithetic(), seed=seed, qmc=qmc)
    return hh.MonteCarlo(hh.HestonDynamics(),
                         hh.HestonQE(martingale_correction=mcorr, use_kernel=use_kernel), cfg)


def _cpu(method):
    """The port's counterpart of a JAX method, run on the CPU."""
    return dataclasses.replace(ht.from_reference(method), device="cpu")


def _step_inputs():
    """States and draws over both ψ branches (small and large V against θ),
    the u ≤ p plateau (u near 0), and a Feller-violating parameter set."""
    rng = np.random.default_rng(20261016)
    v = np.concatenate([rng.uniform(0.0, 0.2, 96), rng.uniform(0.0, 1e-4, 62), [0.0, 1e-12]])
    x = rng.normal(np.log(100.0), 0.2, v.size)
    z_v, z_x = rng.standard_normal(v.size), rng.standard_normal(v.size)
    u = np.concatenate([rng.uniform(0.0, 1.0, 120), rng.uniform(0.0, 0.05, v.size - 120)])
    base = jm.qe_constants(2.0, 0.04, 0.3, -0.7, 0.03, 0.1)
    wild = jm.qe_constants(6.21, 0.019, 0.61, -0.7, 0.03, 0.5)
    matched = jm.qe_constants(2.0, 0.04, 0.3, -0.7, 0.03, 0.1, match_gammas=True)
    return (x, v, z_v, z_x, u), (base, wild, matched)


@pytest.mark.parametrize("mcorr", [True, False], ids=["qe_m", "plain_k0"])
def test_qe_step_matches_reference(mcorr):
    """(log S', V') to rel 1e-12 (float64 on both sides, the same operation
    order and guards), over both QE branches."""
    arrays, consts = _step_inputs()
    branches = set()
    for c in consts:
        pc = {k: torch.tensor(np.asarray(x), dtype=torch.float64) for k, x in c.items()}
        jc = {k: jnp.asarray(x) for k, x in c.items()}
        want = jm.qe_step(*(jnp.asarray(a) for a in arrays), jc, martingale_correction=mcorr)
        got = pm.qe_step(*(torch.as_tensor(a) for a in arrays), pc, martingale_correction=mcorr)
        for name, g, w in zip(("x", "v"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-300,
                                       err_msg=name)
        _, use_quad, *_ = pm._qe_v_draw(torch.as_tensor(arrays[1]), torch.as_tensor(arrays[2]),
                                        torch.as_tensor(arrays[4]), pc)
        branches |= set(use_quad.tolist())
    assert branches == {True, False}


@pytest.mark.parametrize("mcorr", [True, False], ids=["qe_m", "plain_k0"])
@pytest.mark.parametrize("steps,offset", [(6, 0), (5, 4096)])
def test_qmc_terminals_match_reference_per_path(steps, offset, mcorr):
    """qmc=True: the Sobol' shift from ``split(PRNGKey(seed))[0]``, 3 dims
    per step, exact float64 ``ndtri``: the same points as the JAX sampler,
    so every terminal price agrees to rel 1e-12."""
    prob, method = _problem(), _method(steps=steps, mcorr=mcorr)
    want = np.asarray(hh.simulate_terminal_prices(prob, method, point_offset=offset))
    got = ht.simulate_terminal_prices(ht.from_reference(prob), _cpu(method), point_offset=offset)
    assert got.dtype == torch.float64 and got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("strike,cp", [(100.0, hh.Call()), (90.0, hh.Put()),
                                       (np.array([90.0, 100.0, 110.0]), hh.Call())],
                         ids=["atm_call", "otm_put", "strike_grid"])
def test_solve_matches_reference(strike, cp):
    """The price through ``solve``: rel 1e-12 (same terminals, same
    reduction)."""
    prob, method = _problem(strike, cp), _method()
    want = np.asarray(hh.solve(prob, method).price)
    got = ht.solve(ht.from_reference(prob), _cpu(method)).price
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_autograd_through_solve_matches_jax_grad():
    """Spot, V0, κ, θ, σ, ρ and the rate given as 0-dim float64 tensors: the
    QMC price's gradient by ``torch.autograd.grad`` against ``jax.grad``
    through the JAX ``solve`` on the same points, to rel 1e-9 (atol 1e-12
    for a gradient near zero)."""
    vals = (100.0, *H, 0.03)
    method = _method(trajectories=1024, steps=4)

    def jax_price(p):
        spot, v0, kappa, theta, sigma, rho, r = p
        return hh.solve(_problem(market=hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma,
                                                        rho)), method).price

    want = np.asarray(jax.grad(jax_price)(jnp.asarray(vals)))
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in vals]
    spot, v0, kappa, theta, sigma, rho, r = leaves
    market = ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
    payoff = ht.VanillaOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    price = ht.solve(ht.PricingProblem(payoff, market), _cpu(method)).price
    got = np.array([float(g) for g in torch.autograd.grad(price, leaves)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("market,oracle", [
    (MARKET, hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())),
    (hh.HestonInputs(REF, 0.0319, 100.0, 0.010201, 6.21, 0.019, 0.61, -0.7),
     hh.CarrMadan(1.5, 64.0, hh.HestonDynamics(), nodes=512)),
], ids=["easy", "feller_violating"])
def test_prng_price_against_carr_madan(market, oracle):
    """PRNG stream, 4 seeds × 150,000 pairs × 16 steps, the budget and
    oracles of tests/agreement/test_heston_qe.py:43-58.  That test's rel 1e-3
    (10 bp) is about one standard error of the Feller-violating set at this
    budget (8.6 bp), so a statistically sound bound on another stream is 4
    standard errors of the per-pair payoffs plus 10 bp for the QE-M-16 bias."""
    prob = ht.from_reference(_problem(market=market))
    cm = float(ht.solve(prob, _cpu(oracle)).price)
    sols = [ht.solve(prob, _cpu(_method(150_000, 16, seed=i, qmc=False))) for i in range(4)]
    disc = float(ht.df(prob.market_inputs.rate, prob.payoff.expiry))
    pay = disc * torch.cat([ht.reduce_payoffs(s.ensemble, prob.payoff) for s in sols])
    price, se = float(pay.mean()), float(pay.std()) / np.sqrt(pay.numel())
    assert price == pytest.approx(np.mean([float(s.price) for s in sols]), rel=1e-12)
    assert abs(price - cm) <= 4 * se + 1e-3 * cm


def test_kernel_strategy_on_cpu_runs_the_twin():
    """``HestonQE(use_kernel=True)`` on the CPU gives the K5 twin's terminals
    (fp32, in-kernel Sobol' stream), in float64; the QMC stream is accepted
    with the kernel strategy, as in the JAX package."""
    prob = ht.from_reference(_problem())
    method = _cpu(_method(4096, 5, seed=7, use_kernel=True))
    samples = ht.simulate_terminal_prices(prob, method)
    T = float(ht.yearfrac(REF, EXPIRY))
    want = pq.heston_qe_terminal(np.log(100.0), *H[:1], 0.03, *H[1:], T / 5, n_paths=4096,
                                 steps=5, seed=7, antithetic=True, qmc=True, device="cpu")
    assert samples.dtype == torch.float64
    torch.testing.assert_close(samples, want.double(), rtol=0.0, atol=0.0)
    sol = ht.solve(prob, method)
    assert torch.equal(sol.ensemble, samples)
