"""Counter-based random streams shared by the estimators and the kernels.

Two generators, each a pure function of (key, counter):

- **Threefry-2x32** (20 rounds) in numpy, only to reproduce the JAX package's
  Sobol' digital shift ``jax.random.bits(PRNGKey(seed), (dims,), uint32)``
  and the key split ``jax.random.split`` that the QE-M estimator draws its
  shift key from, without importing jax.  With ``jax_threefry_partitionable``
  on (the default of current jax), word ``i`` of the bits is ``x0 ^ x1`` of
  ``threefry2x32(key, (0, i))`` and subkey ``i`` of a split is ``(x0, x1)``,
  with key ``(seed >> 32, seed & 0xffffffff)``.
- **Philox-4x32-10** in torch (int64 tensors holding uint32 values), the
  stream of every PRNG (non-QMC) path of the port.  ``csrc/hh_device.cuh``
  implements the same function, so a CUDA kernel and its plain twin draw
  identical bits.  Layout: key ``(seed, device_id)``; counter
  ``(pair & 0xffffffff, pair >> 32, draw_block, 0)`` where ``pair`` is the
  global antithetic-pair index and ``draw_block`` numbers the 4-word blocks
  a path consumes (one per Euler step pair, one per exact segment).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "prng_key",
    "threefry2x32",
    "random_bits",
    "split",
    "philox4x32",
    "uniform_from_bits",
]

_MASK32 = 0xFFFFFFFF


def prng_key(seed: int) -> np.ndarray:
    """Two uint32 key words of a seed: the layout of ``jax.random.PRNGKey``."""
    seed = int(seed)
    return np.array([(seed >> 32) & _MASK32, seed & _MASK32], dtype=np.uint32)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, c0, c1):
    """Threefry-2x32, 20 rounds, on uint32 numpy arrays ``c0``, ``c1``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = np.asarray(c0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(c1, dtype=np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)`` under partitionable threefry."""
    i = np.arange(n, dtype=np.uint32)
    x0, x1 = threefry2x32(key, np.zeros_like(i), i)
    return x0 ^ x1


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` under partitionable threefry: a
    (num, 2) uint32 array whose row ``i`` is both words of
    ``threefry2x32(key, (0, i))``."""
    i = np.arange(num, dtype=np.uint32)
    x0, x1 = threefry2x32(key, np.zeros_like(i), i)
    return np.stack([x0, x1], axis=1)


_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) words of the 64-bit product m·a, with every intermediate
    below 2^50 so that int64 never overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    p_lo = a_lo * m  # < 2^48
    p_hi = a_hi * m  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(counter, key):
    """Philox-4x32-10 (Random123).  ``counter`` is four int64 tensors (or
    ints) holding uint32 values, ``key`` two ints; returns four int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word → Uniform[0, 1) float32 by the mantissa trick: the top 23
    bits under an exponent of 1 give [1, 2), minus one (exact)."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0
