"""The port's complex log I_ν(z) (hedgehog_tpu_torch/math/besseli.py) against
the JAX package's and against ``scipy.special.iv``, the cases of
tests/unit/test_besseli.py.

Tolerances: against JAX, 1e-12 relative wherever the reference's own error
estimate for the lane (the least of its three branches' estimates) is at
most 1e-10, and within that estimate elsewhere: there a branch sums with
cancellation C (log C = Re[η(ν,|z|) − η(ν,z)]), both implementations round
to ~C·eps, and XLA's fused complex arithmetic cannot be matched bit for bit.
Against scipy, JAX's contract of 3e-10; on the positive real axis 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

import hedgehog_tpu.math.besseli as jb
from hedgehog_tpu_torch.math.besseli import log_besseli_complex

NUS = [-0.5, 0.5, 3.0, 17.0, 40.0]
RTOL = 1e-12
EST_LIMIT = 1e-10


def _grid(n, seed, windings=1):
    rng = np.random.default_rng(seed)
    absz = np.exp(rng.uniform(np.log(0.05), np.log(500.0), n))
    th = rng.uniform(-np.pi * windings, np.pi * windings, n)
    return absz, th


def _wedge(nu, n, seed):
    """|z| near ν and θ near ±π/2 (the turning points z = ±iν), where the
    recurrence branch takes over."""
    rng = np.random.default_rng(seed)
    absz = max(nu, 0.5) * rng.uniform(0.8, 1.2, n)
    th = rng.choice([-1.0, 1.0], n) * (0.5 * np.pi + rng.uniform(-0.3, 0.3, n))
    return absz, th


def _reference_estimate(nu, absz, th):
    """The JAX function's own relative-error estimate of the branch it
    picks, per lane (its fold of θ to [0, π/2] included)."""
    th_p = th - 2.0 * np.pi * np.round(th / (2.0 * np.pi))
    b = np.abs(th_p)
    b_up = np.where(b > 0.5 * np.pi, np.pi - b, b)
    z = jnp.asarray(absz) * jnp.exp(1j * jnp.asarray(b_up))
    errs = [np.asarray(jb._log_iv_series(nu, z, 96)[1]), np.asarray(jb._log_iv_uniform(nu, z)[1]),
            np.asarray(jb._log_iv_recurrence(nu, z)[1])]
    return np.exp(np.minimum(np.minimum(errs[0], errs[1]), errs[2]))


def _rel(got, want):
    return np.abs(np.exp(got - want) - 1.0)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("case", ["principal", "wound", "wedge"])
def test_matches_reference(nu, case):
    seed = int(10 * abs(nu)) + 7
    if case == "principal":
        absz, th = _grid(1500, seed)
    elif case == "wound":
        absz, th = _grid(1000, seed + 1, windings=5)
    else:
        absz, th = _wedge(nu, 500, seed + 2)
    got = log_besseli_complex(nu, torch.from_numpy(absz), torch.from_numpy(th)).numpy()
    want = np.asarray(jb.log_besseli_complex(nu, jnp.asarray(absz), jnp.asarray(th)))
    rel = _rel(got, want)
    est = _reference_estimate(nu, absz, th)
    sharp = est <= EST_LIMIT
    if case != "wedge":  # the recurrence's estimates there are ~1e-9
        assert sharp.mean() > 0.9
    assert np.max(rel[sharp], initial=0.0) < RTOL
    assert np.all(rel[~sharp] <= est[~sharp])


@pytest.mark.parametrize("nu", [-0.9, -0.5, 0.0, 0.5, 3.0, 15.0, 39.0, 89.0, 200.0])
def test_vs_scipy_principal_branch(nu):
    """JAX's contract, 3e-10 relative, the Airy wedge included."""
    absz, th = _grid(1500, seed=int(10 * abs(nu)) + 3)
    ref = sp.iv(nu, absz * np.exp(1j * th))
    got = log_besseli_complex(nu, torch.from_numpy(absz), torch.from_numpy(th)).numpy()
    with np.errstate(all="ignore"):
        rel = np.abs(np.exp(got - np.log(ref)) - 1.0)
    ok = np.isfinite(ref) & (np.abs(ref) > 1e-280)
    assert np.nanmax(rel[ok]) < 3e-10


def test_unwrapped_angle_continuation():
    """I_ν(z·e^{2πik}) = e^{2πikν}·I_ν(z) through the unwrapped angle
    (heston.jl:220-238)."""
    absz = torch.tensor([0.5, 5.0, 50.0, 200.0], dtype=torch.float64)
    th = torch.tensor([0.7, -1.2, 2.9, 0.1], dtype=torch.float64)
    for nu in (-0.5, 0.5, 3.3, 39.0):
        a = log_besseli_complex(nu, absz, th).numpy()
        for k in (1, -2):
            b = log_besseli_complex(nu, absz, th + 2 * np.pi * k).numpy()
            np.testing.assert_allclose(b - a, 1j * nu * 2 * np.pi * k, atol=1e-10)


def test_real_axis_positive():
    """On the positive real axis log I_ν is real and matches scipy's ive."""
    x = np.array([0.1, 1.0, 7.0, 40.0, 120.0, 400.0])
    for nu in (0.0, 2.5, 15.0):
        got = log_besseli_complex(nu, torch.from_numpy(x), torch.zeros(6, dtype=torch.float64))
        ref = np.log(sp.ive(nu, x)) + x
        np.testing.assert_allclose(got.real.numpy(), ref, rtol=1e-9)
        np.testing.assert_allclose(got.imag.numpy(), 0.0, atol=1e-9)


def test_large_order_moderate_argument():
    """|z| ≪ ν (deep monotonic region): no cancellation, 1e-8 at large orders."""
    for nu in (39.0, 89.0, 200.0):
        absz = np.linspace(0.1, 0.6 * nu, 40)
        th = np.linspace(-np.pi, np.pi, 40, endpoint=False)
        ref = sp.iv(nu, absz * np.exp(1j * th))
        got = log_besseli_complex(nu, torch.from_numpy(absz), torch.from_numpy(th)).numpy()
        ok = np.abs(ref) > 1e-280
        with np.errstate(all="ignore"):
            rel = np.abs(np.exp(got - np.log(ref)) - 1.0)
        assert np.nanmax(rel[ok]) < 1e-8


def test_order_as_tensor_and_dtype():
    """A 0-dim tensor order gives the number's values; the result is
    complex128 on the arguments' device, float32 arguments included."""
    absz, th = _grid(64, 11)
    a = log_besseli_complex(3.0, torch.from_numpy(absz), torch.from_numpy(th))
    b = log_besseli_complex(torch.tensor(3.0, dtype=torch.float64), torch.from_numpy(absz),
                            torch.from_numpy(th))
    assert a.dtype == torch.complex128 and a.device.type == "cpu"
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13)
    c = log_besseli_complex(3.0, torch.from_numpy(absz).float(), torch.from_numpy(th).float())
    assert c.dtype == torch.complex128
