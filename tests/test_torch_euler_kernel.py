"""The Euler kernel's plain twin (K1): its step formula against a numpy loop
fed the same normals, and its price against Carr-Madan and against the JAX
package's pure Euler stepper.  The Pallas Euler kernel draws from the TPU's
hardware PRNG, which has no CPU form, so price agreement is statistical;
under QMC the port's float64 stepper matches the JAX one path by path."""

import datetime as dt
import math

import jax
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods.montecarlo import _heston_euler_paths as jax_euler_paths
from hedgehog_tpu.ops.heston_kernel import seed_from_key as jax_seed_from_key
from hedgehog_tpu_torch.methods.heston_euler import heston_euler_paths
from hedgehog_tpu_torch.ops import heston_kernel as pk
from hedgehog_tpu_torch.ops.hh_device import box_muller, philox_block

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
MARKET = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
PROB = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
                         MARKET)
T = 366 / 365


def _numpy_euler(z1, z2, steps, dt_):
    """Full-truncation log-Euler in float64 numpy from given normals
    (steps, paths)."""
    x = np.full(z1.shape[1], math.log(100.0))
    v = np.full(z1.shape[1], 0.04)
    rho_bar = math.sqrt(1.0 - 0.49)
    for s in range(steps):
        vp = np.maximum(v, 0.0)
        sq = np.sqrt(vp * dt_)
        x, v = (x + (0.03 - 0.5 * vp) * dt_ + sq * z1[s],
                v + 2.0 * (0.04 - vp) * dt_ + 0.3 * sq * (-0.7 * z1[s] + rho_bar * z2[s]))
    return np.exp(x)


def test_twin_step_formula_matches_numpy_loop():
    """The twin's float32 steps against float64 numpy on the same Philox
    normals: agreement to float32 accumulation over 25 steps (rel 2e-5)."""
    n, steps, seed = 4096, 25, 9
    dt_ = T / steps
    params = torch.as_tensor(pk._euler_params(math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7,
                                              dt_))
    got = pk.heston_euler_terminal_plain(params, n, steps, seed, True, 0).double().numpy()
    pair = torch.arange(n, dtype=torch.int64)
    z1, z2 = [], []
    for s in range(steps):
        w = philox_block(pair, s // 2, seed, 0)
        a, b = box_muller(w[2 * (s % 2)], w[2 * (s % 2) + 1], dtype=torch.float64)
        z1.append(a.numpy())
        z2.append(b.numpy())
    z1, z2 = np.array(z1), np.array(z2)
    np.testing.assert_allclose(got[0], _numpy_euler(z1, z2, steps, dt_), rtol=2e-5)
    np.testing.assert_allclose(got[1], _numpy_euler(-z1, -z2, steps, dt_), rtol=2e-5)


def test_twin_matches_float64_stepper_per_path():
    """EulerMaruyama(use_kernel=True) on CPU tensors (the fp32 twin) and the
    port's float64 stepper share the Philox layout: per path within 1e-4."""
    prob = ht.from_reference(PROB)
    cfg = ht.SimulationConfig(2048, 50, ht.Antithetic(), 4)
    twin = ht.simulate_terminal_prices(prob, ht.MonteCarlo(ht.HestonDynamics(),
                                                           ht.EulerMaruyama(True), cfg,
                                                           device="cpu"))
    f64 = heston_euler_paths(prob, cfg, device="cpu")
    assert twin.dtype == f64.dtype == torch.float64 and twin.shape == (2, 2048)
    np.testing.assert_allclose(twin.numpy(), f64.numpy(), rtol=1e-4)


def _price_and_se(samples, payoff, disc):
    per_pair = np.asarray(payoff(samples)).mean(axis=0)
    return disc * per_pair.mean(), disc * per_pair.std() / math.sqrt(per_pair.size)


def test_twin_price_against_carr_madan_and_jax_stepper():
    """32768 pairs × 50 steps: the twin's price agrees with Carr-Madan and
    with the JAX package's Euler stepper (another stream) within 4 combined
    standard errors plus 10 bp of O(Δt) scheme bias for the oracle."""
    steps, pairs = 50, 32768
    disc = math.exp(-0.03 * T)
    cm = float(hh.solve(PROB, hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price)
    cfg_j = hh.SimulationConfig(trajectories=pairs, steps=steps,
                                variance_reduction=hh.Antithetic(), seed=1)
    s_j = np.asarray(jax_euler_paths(PROB, cfg_j, jax.random.PRNGKey(1), return_grid=False))
    p_j, se_j = _price_and_se(s_j, PROB.payoff, disc)
    prob = ht.from_reference(PROB)
    sol = ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.EulerMaruyama(use_kernel=True),
                                       ht.from_reference(cfg_j), device="cpu"))
    p_t, se_t = _price_and_se(sol.ensemble.numpy(), PROB.payoff, disc)
    assert float(sol.price) == pytest.approx(p_t, rel=1e-12)
    assert abs(p_t - cm) <= 4 * se_t + 1e-3 * cm
    assert abs(p_t - p_j) <= 4 * math.hypot(se_t, se_j)


def test_euler_kernel_guards():
    prob = ht.from_reference(PROB)
    cfg = ht.SimulationConfig(64, 4, ht.Antithetic(), 0, True)
    with pytest.raises(ValueError, match="qmc"):
        ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.EulerMaruyama(True), cfg,
                                     device="cpu"))
    params = torch.as_tensor(pk._euler_params(4.6, 0.04, 0.03, 2.0, 0.04, 0.3, -0.7, 0.01))
    with pytest.raises(ValueError, match="steps"):
        pk._euler_terminal(params, 8, 0, 0, True, 0)
    with pytest.raises(TypeError, match="float32"):
        pk._euler_terminal(params.double(), 8, 4, 0, True, 0)
    before = pk.EULER_KERNEL.launches
    pk._euler_terminal(params, 8, 4, 0, False, 0)
    assert pk.EULER_KERNEL.launches == before  # CPU tensors take the twin


def test_seed_from_key_contract():
    """No key: the config's seed; an explicit key mixes its words into an
    int32 (the JAX package's contract), so distinct keys differ."""
    cfg = ht.SimulationConfig(seed=17)
    assert pk.seed_from_key(cfg, None) == 17
    k1 = np.asarray(jax.random.key_data(jax.random.PRNGKey(1)))
    k2 = np.asarray(jax.random.key_data(jax.random.PRNGKey(2)))
    s1, s2 = pk.seed_from_key(cfg, k1), pk.seed_from_key(cfg, k2)
    assert s1 != s2 and -(2**31) <= s1 < 2**31
    assert s1 == int(jax_seed_from_key(cfg, jax.random.PRNGKey(1)))


@pytest.mark.parametrize("steps,offset", [(8, 0), (13, 100)])
def test_float64_stepper_under_qmc_matches_reference_per_path(steps, offset):
    """qmc=True: bridge-ordered Sobol' normals on both sides, so the float64
    Euler steppers agree per path to near f64 rounding (rel 1e-10)."""
    cfg = hh.SimulationConfig(trajectories=1024, steps=steps, variance_reduction=hh.Antithetic(),
                              seed=6, qmc=True)
    want = np.asarray(jax_euler_paths(PROB, cfg, jax.random.PRNGKey(6), return_grid=False,
                                      point_offset=offset))
    got = ht.simulate_terminal_prices(ht.from_reference(PROB), ht.MonteCarlo(
        ht.HestonDynamics(), ht.EulerMaruyama(), ht.from_reference(cfg), device="cpu"),
        point_offset=offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
