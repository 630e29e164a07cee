"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes from the same inputs."""

from __future__ import annotations

import numpy as np


def gap(program, reference) -> float:
    """The worst |program − reference| over a group of outputs, each
    measured against the larger of its own |reference| and the group's
    median |reference| (so that an output near zero is read against the
    group's scale).  NaN where either side is not finite."""
    p = np.asarray(program, dtype=np.float64).ravel()
    r = np.asarray(reference, dtype=np.float64).ravel()
    if not (np.all(np.isfinite(p)) and np.all(np.isfinite(r))):
        return float("nan")
    scale = np.maximum(np.abs(r), np.median(np.abs(r)))
    return float(np.max(np.abs(p - r) / scale))


def worst(values) -> float:
    """The largest of ``values``; NaN if any is NaN."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)


def all_finite(calls) -> bool:
    """Every output array of every (inputs, outputs) call is finite."""
    return all(np.all(np.isfinite(np.asarray(v, dtype=np.float64)))
               for _, out in calls for v in out.values())
