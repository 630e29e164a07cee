"""The work of the Heston QE mixing requests over the Philox stream: the
counts of chip_smoke.py's ``work``/``int_ops`` for K7, K10, K11 and K12,
frozen and keyed by the work a request asks for, so that a kernel that is
rewritten, fused or renamed is read against the same work.

Per antithetic pair: one Philox block per two steps (two normals by
Box–Muller and two QE uniforms), two QE mixing steps a step, and at each
expiry two conditional Black–Scholes closes per strike.
"""

from __future__ import annotations

from .primitives import (
    BOX_MULLER,
    CLOSE,
    CLOSE_GROUP,
    CLOSE_POINT,
    MIX_STEP,
    PARTIALS,
    PHILOX_ALU,
    PHILOX_IMAD,
    QE_TAN_STEP4,
    QE_TAN_STEP5,
    SURF_TAN_STEP,
    ops,
)


def count(kind: str, pairs: int, steps: int, points: int = 1, expiries: int = 1) -> dict:
    """(flops, mufu, alu, imad, bytes) of one call of ``kind`` on ``pairs``
    antithetic pairs and ``steps`` steps (for a surface, the steps of all
    its segments, ``expiries`` expiries and ``points`` (expiry, strike)
    points).  Bytes count each output written once and, for the values'
    backward, the cotangent read once."""
    draw = ops((0.5, BOX_MULLER), (2, 0))
    mix = ops((steps, ops(draw, (2, MIX_STEP))), (2, CLOSE))
    surf_close = ops((2 * expiries, CLOSE_GROUP), (points, ops((2, CLOSE_POINT), (1, 0))))
    per_pair, out_bytes = {
        # K10: price and the 7-greek vector
        "price_and_greeks": (ops(mix, (2, 0), (2 * steps, QE_TAN_STEP4),
                                 (2, ops(PARTIALS, (64, 0)))), 0),
        # K7: the per-path values
        "values": (mix, 8),
        # K11: the values' vector-Jacobian product
        "values_vjp": (ops(mix, (2 * steps, QE_TAN_STEP5), (2, ops(PARTIALS, (90, 0)))), 8),
        # K12: the surface and its 7-column Jacobian
        "surface_price_and_jacobian": (
            ops((steps, ops(draw, (2, MIX_STEP))), surf_close, (2 * steps, SURF_TAN_STEP),
                (2 * points, ops(PARTIALS, (21, 0)))), 0),
    }[kind]
    blocks = -(-steps // 2)
    nbytes = 56 * points if kind == "surface_price_and_jacobian" else out_bytes * pairs
    return dict(flops=per_pair[0] * pairs, mufu=per_pair[1] * pairs,
                alu=pairs * blocks * PHILOX_ALU, imad=pairs * blocks * PHILOX_IMAD,
                bytes=nbytes)
