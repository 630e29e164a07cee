"""Randomized quasi-Monte Carlo: digitally shifted Sobol' points.

Port of ``hedgehog_tpu/math/sobol.py``, bit for bit: Joe–Kuo direction
numbers (30 bits) from ``scipy.stats.qmc``, point ``n`` in dimension ``d`` is
``⊕_{bits b of n} V[d, b]``, XOR a digital shift drawn from the key, centred
in its cell.  The shift reproduces ``jax.random.bits`` (math/counter_rng.py),
so the same seed gives the same points as the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .counter_rng import random_bits

__all__ = ["sobol_uniforms", "sobol_shift"]

_BITS = 30
_SCALE = 2.0**-_BITS


@functools.lru_cache(maxsize=None)
def _direction_numbers(dims: int) -> np.ndarray:
    from scipy.stats import qmc

    sob = qmc.Sobol(d=dims, scramble=False)
    return np.asarray(sob._sv, dtype=np.uint32)  # (dims, 30)


def sobol_shift(key, dims: int) -> np.ndarray:
    """(dims,) uint32 digital shift of a key: ``bits(key) >> 2``."""
    return random_bits(key, dims) >> np.uint32(32 - _BITS)


def sobol_uniforms(key, n_points: int, dims: int, skip: int = 0, *,
                   device) -> torch.Tensor:
    """(n_points, dims) float64 Sobol' uniforms in (0, 1) on ``device``.

    ``skip`` offsets the sequence index (devices take disjoint slices of one
    sequence); ``key`` (two uint32 words) drives the digital shift."""
    if skip + n_points > 2**_BITS:
        raise ValueError(
            f"Sobol' sequence period is 2^{_BITS} points; skip+n_points = "
            f"{skip + n_points} would wrap and duplicate points"
        )
    V = torch.as_tensor(_direction_numbers(dims).astype(np.int64), device=device)
    n = torch.arange(skip, skip + n_points, dtype=torch.int64, device=device)[:, None]
    acc = torch.zeros((n_points, dims), dtype=torch.int64, device=device)
    for b in range(_BITS):
        bit_set = ((n >> b) & 1).bool()
        acc = torch.where(bit_set, acc ^ V[None, :, b], acc)
    shift = torch.as_tensor(sobol_shift(key, dims).astype(np.int64), device=device)
    acc = acc ^ shift[None, :]
    return (acc.to(torch.float64) + 0.5) * _SCALE
