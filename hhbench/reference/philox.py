"""Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11) on int64 tensors holding uint32 words, and the two
transforms the Heston mixing stream applies to its words.

Written from the published algorithm, not from the program: a counter of
four words (pair index low, pair index high, draw block, tag 0) under the
key (seed, device id) gives four words; a word w gives the uniform
(w >> 9)·2^-23 in [0, 1); two words give two normals by Box–Muller, the
radius uniform's zero cell taken at 2^-24.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
# the Random123 multipliers and Weyl key increments
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mul_hi_lo(m: int, x: torch.Tensor):
    """(high word, low word) of m·x for a uint32 constant m and uint32
    words x, without an int64 overflow (each partial product < 2^48)."""
    lo16, hi16 = x & 0xFFFF, x >> 16
    a = lo16 * m
    b = hi16 * m
    mid = a + ((b & 0xFFFF) << 16)
    return ((b >> 16) + (mid >> 32)) & MASK32, mid & MASK32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox-4x32 rounds of the counter (c0, c1, c2, c3) under the key
    (k0, k1); every word an int64 tensor (or int) in [0, 2^32)."""
    k0, k1 = k0 & MASK32, k1 & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mul_hi_lo(M0, c0)
        hi1, lo1 = _mul_hi_lo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def block_words(pair: torch.Tensor, block: int, seed: int, device_id: int = 0):
    """The four words of draw block ``block`` of each pair index in ``pair``
    (int64)."""
    zero = torch.zeros_like(pair)
    return philox(pair & MASK32, pair >> 32, zero + block, zero, seed, device_id)


def uniform(word: torch.Tensor, dtype) -> torch.Tensor:
    """The uniform (word >> 9)·2^-23 in [0, 1), exact in float32 and wider."""
    return ((word >> 9).to(torch.float64) * 2.0**-23).to(dtype)


def box_muller(w0: torch.Tensor, w1: torch.Tensor, dtype):
    """Two N(0, 1) draws from two words: radius uniform floored at 2^-24,
    angle uniform times 2π; arithmetic in ``dtype``."""
    u1 = torch.clamp(uniform(w0, torch.float64), min=2.0**-24).to(dtype)
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = (2.0 * math.pi) * uniform(w1, dtype)
    return radius * torch.cos(angle), radius * torch.sin(angle)


def mixing_draws(pair: torch.Tensor, steps: int, seed: int, dtype):
    """(z, u) of each step of the QE mixing stream for the pairs ``pair``:
    block s // 2 serves steps s and s + 1, its first two words giving the
    two normals (cos to the even step, sin to the odd) and its last two the
    QE uniforms."""
    out = []
    for s in range(steps):
        if s % 2 == 0:
            w = block_words(pair, s // 2, seed)
            normals = box_muller(w[0], w[1], dtype)
        out.append((normals[s % 2], uniform(w[2 + s % 2], dtype)))
    return out
