"""Operation counts of the building blocks of the Monte Carlo kernels, per
call: (fp32 FLOPs, MUFU operations), an FMA counted as two FLOPs.

A frozen copy of the hand counts in chip_smoke.py (``work``/``int_ops``),
counted from the kernels' sources once: MUFU is rcp.approx, the ex2 of
expf and the rsqrt of sqrtf; logf and sincosf are fp32 polynomials.  Where
a lane takes one of two branches the cheaper side is counted (the QE
draw: the exponential branch with u ≤ p), so a bound from these counts is
a lower bound on the time these inputs need.

A Philox-4x32-10 block is ten rounds of two 32×32→64-bit products (one
IMAD.WIDE each, on the FMA pipe) and two three-input XORs (one LOP3 each,
on the integer ALU); its round keys depend on the seed alone.
"""

from __future__ import annotations

PHILOX_ALU, PHILOX_IMAD = 10 * 2, 10 * 2


def ops(*terms):
    """Sum of (flops, mufu) terms, each a pair or (count, pair)."""
    f = m = 0.0
    for t in terms:
        k, (a, b) = (t if isinstance(t[1], tuple) else (1, t))
        f, m = f + k * a, m + k * b
    return f, m


RCP, SQRT, EXP = (3, 1), (4, 1), (8, 1)
LOG, SINCOS = (14, 0), (20, 0)
BOX_MULLER = ops((7, 0), LOG, SQRT, SINCOS)  # two normals
QE_DRAW = ops((21, 0), (2, RCP))
MIX_STEP = ops(QE_DRAW, (8, 0))
NCDF = ops((18, 0), RCP, EXP)
CLOSE = ops((16, 0), EXP, SQRT, RCP, (2, NCDF))
# CLOSE split at the strike: the strike-free part once per path and
# expiry, the rest per strike
CLOSE_GROUP, CLOSE_POINT = ops((6, 0), EXP, SQRT, RCP), ops((10, 0), (2, NCDF))
# QE tangents: a step's draw coefficients and the (V, IV) tangents of 4
# directions (5 with T); the close's partials past the value
QE_TAN_STEP4, QE_TAN_STEP5, SURF_TAN_STEP = (35, 0), (43, 0), (43, 0)
PARTIALS = (17, 0)
