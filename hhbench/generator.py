"""The one request generator: request specs from a traffic mix's
``draw`` parameters and the run's seed.

Request i of a run with seed s takes its own stream,
``SeedSequence([s mod 2^64, i])``: its program seed (31 bits) and each
field of ``draw``, in the order the mix lists them, so the same (seed,
index) always gives the same request.  A field is drawn by one of

- ``{"choice": [...]}``: one of the values, uniformly;
- ``{"uniform": [lo, hi], "size": n}``: n uniforms in [lo, hi) (a float
  when ``size`` is absent).
"""

from __future__ import annotations

import numpy as np

_MOD = 2**64


def _stream(seed: int, *words: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % _MOD, *words])


def request_spec(seed: int, index: int, draw: dict) -> dict:
    """The spec of request ``index``: ``index``, ``seed`` and the drawn
    fields."""
    ss = _stream(seed, index)
    spec = {"index": index, "seed": int(ss.generate_state(1)[0]) & 0x7FFFFFFF}
    rng = np.random.Generator(np.random.PCG64(ss))
    for name, rule in draw.items():
        if "choice" in rule:
            values = rule["choice"]
            spec[name] = values[int(rng.integers(len(values)))]
        elif "uniform" in rule:
            lo, hi = rule["uniform"]
            size = rule.get("size")
            x = rng.uniform(lo, hi, size=size)
            spec[name] = float(x) if size is None else [float(v) for v in x]
        else:
            raise ValueError(f"draw rule of {name!r}: expected 'choice' or 'uniform', got {rule}")
    return spec


def sample(seed: int, population: list, k: int, salt: int) -> list:
    """``k`` members of ``population`` (all when it is smaller) drawn
    without replacement from (seed, salt), in population order."""
    if k >= len(population):
        return list(population)
    rng = np.random.Generator(np.random.PCG64(_stream(seed, 2**63 + salt)))
    picks = sorted(rng.choice(len(population), size=k, replace=False).tolist())
    return [population[i] for i in picks]
