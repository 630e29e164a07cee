"""Window arithmetic: rates, tails and unions of intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q ≤ 100) of all ``values``:
    the smallest value with at least q% of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def rate(total: float, seconds: float) -> float:
    """``total`` over the whole of ``seconds``."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return total / seconds


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def clip(intervals, lo: float, hi: float):
    """The parts of (start, end, ...) intervals inside [lo, hi] as (start, end)."""
    out = []
    for iv in intervals:
        a, b = max(iv[0], lo), min(iv[1], hi)
        if b > a:
            out.append((a, b))
    return out
