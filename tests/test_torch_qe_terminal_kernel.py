"""The QE-M terminal kernels' plain twins (K5 terminal prices, K6 serving call
price) against the Pallas kernel run in interpret mode on the CPU, on the
in-kernel Sobol' stream (the Pallas PRNG stream has no CPU form), and
against each other.

The JAX kernel is called once, at 32768 pairs and 4 steps, in a
module-scoped fixture.  Interpret mode evaluates ``pl.reciprocal(x,
approx=True)`` as the float32 reciprocal of ``x`` rounded to bfloat16, so
the per-path comparison gives the twin that estimate (the ``_rcp``
emulation of tests/test_torch_exact_kernel.py); the comparison of means also
checks the twin as it ships, with its fp32-accurate reciprocal."""

import datetime as dt
import math

import numpy as np
import pytest
import torch

from hedgehog_tpu.models.heston_qe import qe_constants as jax_qe_constants
from hedgehog_tpu.ops import heston_qe_kernel as jk
from hedgehog_tpu_torch.ops import heston_qe_kernel as pq
from hedgehog_tpu_torch.ops import hh_device

T = (dt.date(2025, 1, 1) - dt.date(2024, 1, 1)).days / 365.0
STEPS, SEED, PAIRS = 4, 3, 32768
MKT = (math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7)
ARGS = (*MKT, T / STEPS)


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


def _interpret_rcp(x):
    """The interpret-mode ``_rcp``: bfloat16-rounded input, float32
    reciprocal, one Newton polish."""
    r = torch.reciprocal(x.to(torch.bfloat16).to(torch.float32))
    return r * (2.0 - x * r)


@pytest.fixture(scope="module")
def jax_terminals():
    return np.asarray(jk.heston_qe_terminal(
        *ARGS, n_paths=PAIRS, steps=STEPS, seed=SEED, antithetic=True, qmc=True,
        interpret=True))


def _twin(n_paths=PAIRS, **kw):
    kw = dict(dict(steps=STEPS, seed=SEED, antithetic=True, qmc=True, device="cpu"), **kw)
    return pq.heston_qe_terminal(*ARGS, n_paths=n_paths, **kw)


def test_parameter_vector_matches_reference():
    """The 14 (+ strike) entries in the order of the JAX wrappers
    (heston_qe_kernel.py:368-385, :490-495), each one float64 value cast to
    float32 once."""
    c = jax_qe_constants(*MKT[3:], MKT[2], T / STEPS, 0.6, 0.4)
    want = [MKT[0], MKT[1], MKT[4]] + [c[k] for k in ("e", "c_s2_v", "c_s2_c", "K1", "K2", "K3",
                                                      "K4", "A", "r_dt")]
    want = np.array(want + [c["K1"] + 0.5 * c["K3"], c["K0"], 105.0], dtype=np.float32)
    got = pq._qem_params(*ARGS, 0.6, 0.4, strike=105.0)
    assert got.dtype == np.float32 and got.shape == (len(hh_device.QEM_NAMES) + 1,)
    assert np.max(np.abs(got.view(np.int32) - want.view(np.int32))) <= 1  # ≤ 1 ulp
    default = pq._qem_params(*ARGS)  # K5's vector: γ1 = γ2 = ½, no strike
    assert default.shape == (len(hh_device.QEM_NAMES),)
    np.testing.assert_array_equal(default, pq._qem_params(*ARGS, 0.5, 0.5))


def test_terminal_twin_per_path_matches_interpret_kernel(jax_terminals, monkeypatch):
    """fp32 on both sides with the same Sobol' bits, ndtri approximation and
    reciprocal estimate: ≥ 99.9% of terminal prices within 1e-5 relative and
    the means within 1e-6.  The rest differ by an ulp of XLA's and torch's
    float32 exp/log/sqrt, carried through 4 steps."""
    monkeypatch.setattr(hh_device, "rcp", _interpret_rcp)
    got = _twin().numpy()
    assert got.shape == jax_terminals.shape == (2, PAIRS)
    rel = np.abs(got - jax_terminals) / np.abs(jax_terminals)
    outside = int(np.sum(rel > 1e-5))
    print(f"paths beyond 1e-5: {outside} of {rel.size}; max rel {rel.max():.3e}; mean diff "
          f"{got.astype(np.float64).mean() - jax_terminals.astype(np.float64).mean():.3e}")
    assert outside <= 1e-3 * rel.size
    assert got.astype(np.float64).mean() == pytest.approx(
        jax_terminals.astype(np.float64).mean(), rel=1e-6)


def test_terminal_twin_mean_matches_interpret_kernel(jax_terminals):
    """The twin as it ships (fp32-accurate reciprocal, as on the card):
    the mean terminal price within 1e-6 of the reference's.  The
    reference's bf16-estimate reciprocal moves each path by ~1e-6 relative,
    without bias."""
    got = _twin().numpy()
    assert got.astype(np.float64).mean() == pytest.approx(
        jax_terminals.astype(np.float64).mean(), rel=1e-6)


@pytest.mark.parametrize("steps,strike", [(4, 105.0), (3, 90.0)])
def test_call_price_twin_is_the_mean_of_the_terminal_twin_payoffs(steps, strike):
    """K6's twin walks K5's PRNG pairs [0, n_blocks·n_batches·32768) on K5's
    stream: its price is the discounted mean of the K5 twin's call payoffs
    over those pairs, to rel 1e-12 (the same fp32 payoffs, both summed in
    float64)."""
    disc = math.exp(-0.03 * T)
    n = pq.PAIRS_PER_BLOCK
    s = pq.heston_qe_terminal(*MKT, T / steps, n_paths=n, steps=steps, seed=11, antithetic=True,
                              device="cpu")
    pay = torch.clamp(s - strike, min=0.0)
    want = disc * float((pay[0] + pay[1]).double().sum()) / (2 * n)
    got = float(pq.heston_qe_call_price(*MKT, T / steps, strike, disc, n_blocks=1, n_batches=1,
                                        steps=steps, seed=11, device="cpu"))
    assert got == pytest.approx(want, rel=1e-12)


def test_martingale_correction_keeps_the_forward():
    """Without the correction the same draws give other terminals; with it
    the mean discounted terminal is the spot within 4 standard errors
    (E[S_T] = S_0 e^{rT} holds step by step)."""
    n = 16384
    on = pq.heston_qe_terminal(*ARGS, n_paths=n, steps=STEPS, seed=2, antithetic=True,
                               device="cpu").double()
    off = pq.heston_qe_terminal(*ARGS, n_paths=n, steps=STEPS, seed=2, antithetic=True,
                                martingale_correction=False, device="cpu").double()
    assert not torch.equal(on, off)
    fwd = 100.0 * math.exp(0.03 * T)
    pair_means = on.mean(dim=0)
    se = float(pair_means.std()) / math.sqrt(n)
    assert abs(float(pair_means.mean()) - fwd) <= 4 * se


def test_sharded_offsets_are_disjoint_slices_of_one_sequence():
    """Mirrors tests/unit/test_qe_kernel_qmc.py:115-160: two halves at
    point offsets 0 and n are the one run of 2n points, path by path."""
    n = 4096
    full = _twin(2 * n, antithetic=False)
    halves = torch.cat([_twin(n, antithetic=False), _twin(n, antithetic=False, point_offset=n)],
                       dim=1)
    assert torch.equal(halves, full)
    assert not torch.equal(full[:, :n], full[:, n:])


def test_guards():
    with pytest.raises(ValueError, match="period"):
        _twin(PAIRS, point_offset=2**30 - 1000)
    _twin(8, point_offset=2**30 - PAIRS)  # the last padded tile is fine
    with pytest.raises(ValueError, match="n_paths"):
        _twin(0)
    params, table = pq.qem_inputs(*ARGS, STEPS, 0, True, "cpu")
    with pytest.raises(TypeError, match="float32"):
        pq._qem_terminal(params.double(), table, 8, STEPS, True, True, 0, 0, 0)
    with pytest.raises(ValueError, match="sobol table"):
        pq._qem_terminal(params, table[:-1], 8, STEPS, True, True, 0, 0, 0)
    with pytest.raises(ValueError, match="params"):
        pq._qem_price_sum(params, 8, STEPS, 0, 0)  # no strike


@pytest.mark.parametrize("bad", [0, -3, True, 2.0], ids=["zero", "negative", "bool", "float"])
def test_call_price_kernel_grid_is_checked(bad):
    """``grid=`` of K6's sum (the digest and the card tests run it at the
    one-pair-a-thread kernel's grid) takes a positive int or None, on any
    device."""
    params = torch.as_tensor(pq._qem_params(*ARGS, strike=100.0))
    with pytest.raises(ValueError, match="grid"):
        pq._qem_price_sum(params, 8, STEPS, 0, 0, grid=bad)


def test_call_price_sum_twin_ignores_the_grid():
    """On the CPU K6's sum is its twin's whatever ``grid`` names."""
    params = torch.as_tensor(pq._qem_params(*ARGS, strike=100.0))
    want = pq._qem_price_sum(params, 64, STEPS, 0, 0)
    assert torch.equal(pq._qem_price_sum(params, 64, STEPS, 0, 0, grid=7), want)


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    kernels = (pq.QEM_TERMINAL_KERNEL, pq.QEM_PRICE_KERNEL)
    before = [k.launches for k in kernels]
    _twin(64)
    _twin(64, qmc=False)
    pq.heston_qe_call_price(*ARGS, 100.0, 1.0, n_blocks=1, n_batches=1, steps=1, seed=0,
                            device="cpu")
    assert [k.launches for k in kernels] == before


def test_terminal_twin_past_128_qmc_steps_matches_the_jax_scheme():
    """200 QMC steps, past the 128 the kernels once refused: the twin's
    terminal prices against the JAX package's float64 QE-M step
    (models/heston_qe.py ``qe_step``, martingale-corrected, γ1 = γ2 = ½) on
    the kernel's Sobol' points (``_qmc_normals_and_uniforms`` of the unsplit
    key, exact ndtri), 4096 pairs: every path within 2e-4 relative (prices
    below 1e-3 compared absolutely; measured 7.9e-5) and the means within
    3e-5 (measured 1.3e-5: fp32 and the approximate ndtri over 200 steps)."""
    import jax
    import jax.numpy as jnp

    from hedgehog_tpu.methods.montecarlo import _qmc_normals_and_uniforms
    from hedgehog_tpu.models.heston_qe import qe_constants, qe_step

    steps, n = 200, 4096
    c = qe_constants(*MKT[3:], MKT[2], T / steps)
    z, u = _qmc_normals_and_uniforms(jax.random.PRNGKey(SEED), steps, 2, n)
    x, v = jnp.full((2, n), MKT[0]), jnp.full((2, n), MKT[1])
    for s in range(steps):
        zs = jnp.stack([z[s], -z[s]])
        x, v = qe_step(x, v, zs[:, 0], zs[:, 1], jnp.stack([u[s], 1.0 - u[s]]), c)
    want = np.asarray(jnp.exp(x))
    got = pq.heston_qe_terminal(*MKT, T / steps, n_paths=n, steps=steps, seed=SEED,
                                antithetic=True, qmc=True, device="cpu").numpy()
    assert got.shape == want.shape == (2, n)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert rel.max() <= 2e-4, rel.max()
    assert got.astype(np.float64).mean() == pytest.approx(want.mean(), rel=3e-5)
