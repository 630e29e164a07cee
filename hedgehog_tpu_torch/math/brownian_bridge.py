"""Brownian-bridge path construction for quasi-Monte Carlo.

Port of ``hedgehog_tpu/math/brownian_bridge.py``: the first (best
distributed) Sobol' dimension drives the terminal value W(T), later ones
fill midpoints by bisection, so most of a path's variance sits in the first
few dimensions and the QMC rate survives long paths (Moskowitz-Caflisch).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["brownian_bridge_increments"]


@functools.lru_cache(maxsize=None)
def _bb_schedule(steps: int):
    """Bisection fill order for times {0, 1, …, steps}·dt: arrays (left, mid,
    right, weight, conditional std / √dt), one row per interior point, in
    the order their Sobol' dimension is consumed."""
    sched = []
    queue = [(0, steps)]
    while queue:
        lo, hi = queue.pop(0)
        if hi - lo < 2:
            continue
        mid = (lo + hi) // 2
        sched.append((lo, mid, hi))
        queue.append((lo, mid))
        queue.append((mid, hi))
    left = np.array([s[0] for s in sched], dtype=np.int64)
    mid = np.array([s[1] for s in sched], dtype=np.int64)
    right = np.array([s[2] for s in sched], dtype=np.int64)
    # conditional N(a·W_l + (1−a)·W_r, (m−l)(r−m)/(r−l)·dt)
    a = (right - mid) / (right - left)
    std = np.sqrt((mid - left) * (right - mid) / (right - left))
    return left, mid, right, a, std


def brownian_bridge_increments(z: torch.Tensor, dt: float, steps: int) -> torch.Tensor:
    """Map (…, steps) normals to Brownian increments ΔW_k ~ N(0, dt) of the
    same shape by bridge ordering (dim 0 drives W(T)); the joint law is the
    exact Brownian one, only the assignment of input dimensions changes."""
    sqrt_dt = math.sqrt(dt)
    W = torch.zeros(z.shape[:-1] + (steps + 1,), dtype=z.dtype, device=z.device)
    W[..., steps] = math.sqrt(steps * dt) * z[..., 0]
    left, mid, right, a, std = _bb_schedule(steps)
    for k in range(len(mid)):
        W[..., int(mid[k])] = (float(a[k]) * W[..., int(left[k])]
                               + float(1.0 - a[k]) * W[..., int(right[k])]
                               + float(std[k]) * sqrt_dt * z[..., k + 1])
    return torch.diff(W, dim=-1)
