"""The port's random streams against their definitions and the JAX package:
Philox-4x32-10 known answers, the threefry Sobol' shift against
``jax.random.bits``, the key split against ``jax.random.split``, and Sobol'
points bit-identical to ``hedgehog_tpu.math.sobol``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedgehog_tpu.math.sobol import sobol_uniforms as jax_sobol_uniforms
from hedgehog_tpu.ops.heston_qe_kernel import _sobol_table as jax_sobol_table
from hedgehog_tpu_torch.math.counter_rng import (
    philox4x32,
    prng_key,
    random_bits,
    split,
    uniform_from_bits,
)
from hedgehog_tpu_torch.math.sobol import sobol_uniforms
from hedgehog_tpu_torch.ops.hh_device import box_muller, philox_block, sobol_table

# Random123's published known-answer vectors for Philox-4x32-10.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = philox4x32([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w[0]) for w in got) == want


def test_philox_block_layout():
    """Counter (pair lo, pair hi, draw block, 0), key (seed, device id): the
    layout csrc/hh_device.cuh documents."""
    pair = torch.tensor([0, 5, 2**32 + 7], dtype=torch.int64)
    got = philox_block(pair, 3, 11, 2)
    for i, p in enumerate(pair.tolist()):
        want = philox4x32([torch.tensor([p & 0xFFFFFFFF]), torch.tensor([p >> 32]),
                           torch.tensor([3]), torch.tensor([0])], (11, 2))
        assert [int(w[i]) for w in got] == [int(w[0]) for w in want]


@pytest.mark.parametrize("seed", [0, 3, 11, 2**33 + 5])
@pytest.mark.parametrize("dims", [1, 8, 13])
def test_threefry_bits_match_jax(seed, dims):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (dims,), dtype=jnp.uint32))
    np.testing.assert_array_equal(random_bits(prng_key(seed), dims), want)


@pytest.mark.parametrize("seed", [0, 3, 11, 2**33 + 5, 2**40 + 12345])
@pytest.mark.parametrize("num", [2, 3])
def test_split_matches_jax(seed, num):
    """Bit-exact: subkey i is both words of threefry2x32(key, (0, i))."""
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = split(prng_key(seed), num)
    assert got.dtype == np.uint32 and got.shape == (num, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(split(got[0]), np.asarray(jax.random.split(want[0])))


@pytest.mark.parametrize("n,dims,skip,seed", [(1000, 8, 0, 0), (777, 5, 12345, 7),
                                              (64, 3, 2**29, 2**33 + 5)])
def test_sobol_uniforms_bit_identical(n, dims, skip, seed):
    want = np.asarray(jax_sobol_uniforms(jax.random.PRNGKey(seed), n, dims, skip=skip))
    got = sobol_uniforms(prng_key(seed), n, dims, skip=skip, device="cpu").numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_sobol_period_guard():
    with pytest.raises(ValueError, match="period"):
        sobol_uniforms(prng_key(0), 16, 2, skip=2**30 - 8, device="cpu")
    sobol_uniforms(prng_key(0), 8, 2, skip=2**30 - 8, device="cpu")  # the last points are fine


@pytest.mark.parametrize("seed,dims", [(3, 8), (11, 16), (0, 4)])
def test_sobol_kernel_table_matches_jax(seed, dims):
    np.testing.assert_array_equal(sobol_table(seed, dims), np.asarray(jax_sobol_table(seed, dims)))


def test_uniform_from_bits_mantissa_trick():
    bits = np.array([0, 1 << 9, 0x7FFFFFFF, 0xFFFFFFFF, 0x80000000], dtype=np.int64)
    got = uniform_from_bits(torch.as_tensor(bits)).numpy()
    want = ((bits >> 9) / 2.0**23).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.max() < 1.0


def test_box_muller_formula():
    b0 = torch.tensor([1 << 20, 0x40000000, 0xFFFFFE00], dtype=torch.int64)
    b1 = torch.tensor([0x12345600, 0x80000000, 7 << 9], dtype=torch.int64)
    z0, z1 = box_muller(b0, b1, dtype=torch.float64)
    u1 = np.maximum((b0.numpy() >> 9) / 2.0**23, 1.1754944e-38)
    u2 = (b1.numpy() >> 9) / 2.0**23
    r = np.sqrt(-2.0 * np.log(u1))
    np.testing.assert_allclose(z0.numpy(), r * np.cos(2 * np.pi * u2), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(z1.numpy(), r * np.sin(2 * np.pi * u2), rtol=1e-12, atol=1e-12)
