"""Problem container and the solution types the ported methods return.

Port of ``hedgehog_tpu/core/problems.py`` (reference
src/pricing_methods/pricing_methods.jl:19-22, src/calibration/basket.jl and
src/solutions/pricing_solutions.jl), for the methods the port has.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

__all__ = [
    "PricingProblem",
    "BasketPricingProblem",
    "AnalyticSolution",
    "CRRSolution",
    "LSMSolution",
    "MonteCarloSolution",
    "CarrMadanSolution",
    "BasketPricingSolution",
]

_frozen = dataclasses.dataclass(frozen=True)


@_frozen
class PricingProblem:
    """Payoff + market inputs: the unit of work for every pricing method."""

    payoff: Any
    market_inputs: Any


@_frozen
class BasketPricingProblem:
    """Many payoffs priced under one market scenario (basket.jl:10-13);
    ``payoffs`` is a tuple."""

    payoffs: Tuple[Any, ...]
    market_inputs: Any

    def __post_init__(self):
        object.__setattr__(self, "payoffs", tuple(self.payoffs))


@_frozen
class AnalyticSolution:
    problem: Any
    method: Any
    price: Any


@_frozen
class CRRSolution:
    problem: Any
    method: Any
    price: Any


@_frozen
class LSMSolution:
    """LSM price, the stopping rule ``stopping_info`` = (stop step per path
    as float64, stop value per path) and the simulated spot grid
    (steps + 1, paths)."""

    problem: Any
    method: Any
    price: Any
    stopping_info: Any
    spot_paths: Any


@_frozen
class MonteCarloSolution:
    """Price plus the per-path ensemble: terminal prices (g, paths) for
    terminal-sample strategies, undiscounted conditional values for the
    mixing strategies."""

    problem: Any
    method: Any
    price: Any
    ensemble: Any


@_frozen
class CarrMadanSolution:
    problem: Any
    method: Any
    price: Any
    integral_solution: Any


@_frozen
class BasketPricingSolution:
    problem: Any
    solutions: Tuple[Any, ...]

    def __post_init__(self):
        object.__setattr__(self, "solutions", tuple(self.solutions))
