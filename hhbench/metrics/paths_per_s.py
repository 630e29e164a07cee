"""Simulated paths of all requests completed in the window (2 × antithetic
pairs; a fit counts every iteration's) over the window's whole time."""

from ..stats import rate


def read(run):
    if not run.done:
        return None
    return rate(sum(r.paths for r in run.done), run.window[1] - run.window[0])
