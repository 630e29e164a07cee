"""The exact-mixing kernels' plain twins (K2 values, K3 price) against the
Pallas kernel run in interpret mode on the CPU, on the in-kernel Sobol'
stream (the Pallas PRNG stream has no CPU form).

The JAX kernel is called once, at 32768 pairs and 2 segments, in a
module-scoped fixture: interpret mode costs about 17 s per 32768-pair tile.

Interpret mode evaluates ``pl.reciprocal(x, approx=True)`` as the float32
reciprocal of ``x`` rounded to bfloat16 (jax/_src/pallas/primitives.py), so
the reference's ``_rcp`` carries ~1.5e-5 relative error after its Newton
polish.  The port's twin (like the CUDA kernel, whose estimate is
``rcp.approx.f32``) is fp32-accurate.  The per-path comparison therefore
gives the twin the interpret-mode estimate; the comparison of means also
checks the twin as it ships."""

import datetime as dt
import math

import numpy as np
import pytest
import torch

from hedgehog_tpu.ops import heston_exact_kernel as jk
from hedgehog_tpu_torch.models.heston_exact import poisson_kmax
from hedgehog_tpu_torch.ops import heston_exact_kernel as pk
from hedgehog_tpu_torch.ops import hh_device

T = (dt.date(2025, 1, 1) - dt.date(2024, 1, 1)).days / 365.0
SEGMENTS, SEED, PAIRS = 2, 3, 32768
MKT = (math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7)
ARGS = (*MKT, T / SEGMENTS, 100.0, 1.0)  # + strike, cp


def _interpret_rcp(x):
    """The interpret-mode ``_rcp``: bfloat16-rounded input, float32
    reciprocal, one Newton polish."""
    r = torch.reciprocal(x.to(torch.bfloat16).to(torch.float32))
    return r * (2.0 - x * r)


@pytest.fixture(scope="module")
def jax_values():
    return np.asarray(jk.heston_exact_mixing_values(
        *ARGS, n_paths=PAIRS, segments=SEGMENTS, seed=SEED, antithetic=True, qmc=True,
        interpret=True))


def _twin_values():
    return pk.heston_exact_mixing_values(*ARGS, n_paths=PAIRS, segments=SEGMENTS, seed=SEED,
                                         antithetic=True, qmc=True, device="cpu").numpy()


def test_parameter_vector_matches_reference():
    want = np.asarray(jk._exact_params(*MKT, T / SEGMENTS, SEGMENTS, 100.0, 1.0))
    got = pk._exact_params(*MKT, T / SEGMENTS, SEGMENTS, 100.0, 1.0)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(pk._P_NAMES),)
    assert np.max(np.abs(got.view(np.int32) - want.view(np.int32))) <= 1  # ≤ 1 ulp


def test_kernel_trip_count_matches_reference():
    assert poisson_kmax(*MKT[3:6], T / SEGMENTS, MKT[1]) == jk._kernel_kmax(
        *MKT[3:6], T / SEGMENTS, MKT[1])


def test_values_twin_per_path_matches_interpret_kernel(jax_values, monkeypatch):
    """fp32 on both sides with the same Sobol' bits, ndtri approximation,
    reciprocal estimate and trip counts: ≥ 99.9% of paths within 1e-4
    relative (values below 1e-3 compared absolutely) and the means within
    1e-6.  The rest differ by an ulp in XLA's and torch's float32 exp/log,
    which a rare path carries across an fp32 threshold (a Poisson count)."""
    monkeypatch.setattr(hh_device, "rcp", _interpret_rcp)
    monkeypatch.setattr(pk, "rcp", _interpret_rcp)
    got = _twin_values()
    assert got.shape == jax_values.shape == (2, PAIRS)
    rel = np.abs(got - jax_values) / np.maximum(np.abs(jax_values), 1e-3)
    outside = int(np.sum(rel > 1e-4))
    print(f"paths beyond 1e-4: {outside} of {rel.size}; max rel {rel.max():.3e}")
    assert outside <= 1e-3 * rel.size
    mean_j, mean_p = jax_values.astype(np.float64).mean(), got.astype(np.float64).mean()
    assert mean_p == pytest.approx(mean_j, rel=1e-6)


def test_values_twin_mean_matches_interpret_kernel(jax_values):
    """The shipped twin (fp32-accurate reciprocal): the means differ by the
    reference's bf16-estimate reciprocal error, measured 7.6e-6 relative here
    (under 0.1 bp); 2e-5 bounds it."""
    got = _twin_values()
    assert got.astype(np.float64).mean() == pytest.approx(
        jax_values.astype(np.float64).mean(), rel=2e-5)


@pytest.mark.parametrize("qmc", [True, False])
def test_price_twin_matches_values_twin_mean(qmc):
    """K3's twin over n_blocks·n_batches·32768 pairs equals the discounted
    mean of K2's twin over the same points (another summation order)."""
    disc = math.exp(-0.03 * T)
    vals = pk.heston_exact_mixing_values(*ARGS, n_paths=2 * PAIRS, segments=SEGMENTS, seed=11,
                                         antithetic=True, qmc=qmc, device="cpu")
    want = disc * float(vals.double().mean())
    got = float(pk.heston_exact_mixing_vanilla_price(
        *MKT, T / SEGMENTS, 100.0, disc, n_blocks=1, n_batches=2, segments=SEGMENTS, seed=11,
        qmc=qmc, device="cpu"))
    assert got == pytest.approx(want, rel=1e-6)


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    before = (pk.EXACT_VALUES_KERNEL.launches, pk.EXACT_PRICE_KERNEL.launches)
    pk.heston_exact_mixing_values(*ARGS, n_paths=64, segments=SEGMENTS, seed=0, device="cpu")
    pk.heston_exact_mixing_vanilla_price(*MKT, T / SEGMENTS, 100.0, 1.0, n_blocks=1,
                                         n_batches=1, segments=1, seed=0, device="cpu")
    assert (pk.EXACT_VALUES_KERNEL.launches, pk.EXACT_PRICE_KERNEL.launches) == before


def test_values_twin_past_16_qmc_segments_matches_the_float64_estimator():
    """32 QMC segments of a five-year call, past the 16 the kernels once
    refused (nothing in them needed the cap; at this market's vol-of-vol a
    segment of a one-year call would need more Poisson trips than the exact
    scheme takes, in the JAX package too): the twin's values against the
    JAX package's float64 estimator on the same Sobol' points (exact ndtri
    there, fp32 and the approximate ndtri here), 4096 pairs: ≥ 99.9% of
    paths within 1e-3 relative (values below 1e-3 compared absolutely;
    measured 99.96%), all within 1e-2, the means within 1e-5 (measured
    3e-8)."""
    import hedgehog_tpu as hh
    from hedgehog_tpu.methods.montecarlo import _heston_exact_mixing_values

    segments, n, expiry = 32, 4096, dt.date(2029, 1, 1)
    t5 = (expiry - dt.date(2024, 1, 1)).days / 365.0
    mkt = hh.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, expiry, hh.European(), hh.Call(),
                                              hh.Spot()), mkt)
    cfg = hh.SimulationConfig(trajectories=n, steps=segments, variance_reduction=hh.Antithetic(),
                              seed=5, qmc=True)
    want = np.asarray(_heston_exact_mixing_values(prob, cfg, None))
    got = pk.heston_exact_mixing_values(*MKT, t5 / segments, 100.0, 1.0, n_paths=n,
                                        segments=segments, seed=5, antithetic=True, qmc=True,
                                        device="cpu").numpy()
    assert got.shape == want.shape == (2, n)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert np.mean(rel <= 1e-3) >= 0.999 and rel.max() <= 1e-2, rel.max()
    assert got.astype(np.float64).mean() == pytest.approx(want.mean(), rel=1e-5)


def test_guards():
    with pytest.raises(ValueError, match="antithetic-only"):
        pk.heston_exact_mixing_values(*ARGS, n_paths=64, segments=SEGMENTS, seed=0,
                                      antithetic=False, qmc=True, device="cpu")
    with pytest.raises(ValueError, match="period"):
        pk.heston_exact_mixing_values(*ARGS, n_paths=PAIRS, segments=SEGMENTS, seed=0,
                                      antithetic=True, qmc=True, point_offset=2**30 - 1, device="cpu")
    with pytest.raises(ValueError, match="period"):
        pk.heston_exact_mixing_vanilla_price(*MKT, T / SEGMENTS, 100.0, 1.0, n_blocks=2**15,
                                             n_batches=1, segments=SEGMENTS, seed=0, qmc=True,
                                             point_offset=1, device="cpu")
    params = torch.as_tensor(pk._exact_params(*MKT, T / SEGMENTS, SEGMENTS, 100.0, 1.0))
    with pytest.raises(TypeError, match="float32"):
        pk._exact_values(params.double(), None, 8, SEGMENTS, True, 20, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pk._exact_values(params[:-1], None, 8, SEGMENTS, True, 20, 0, 0, 0)
    with pytest.raises(ValueError, match="trip count"):
        pk._exact_values(params, None, 8, SEGMENTS, True, 99, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pk._exact_values(params, torch.zeros((4, 31), dtype=torch.int32), 8, SEGMENTS, True, 20,
                         0, 0, 0)


@pytest.mark.parametrize("bad", [0, -3, True, 2.0], ids=["zero", "negative", "bool", "float"])
def test_price_kernel_grid_is_checked(bad):
    """``grid=`` of K3's sum (the digest runs it at the one-pair-a-thread
    kernel's grid) takes a positive int or None, on any device."""
    params = torch.as_tensor(pk._exact_params(*MKT, T / SEGMENTS, SEGMENTS, 100.0, 1.0))
    with pytest.raises(ValueError, match="grid"):
        pk._exact_price_sum(params, None, 8, SEGMENTS, 20, 0, 0, 0, grid=bad)
