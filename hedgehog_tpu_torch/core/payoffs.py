"""Vanilla payoffs: contract terms, exercise/underlying taxonomy, intrinsic
value.

Port of the vanilla subset of ``hedgehog_tpu/core/payoffs.py`` (reference
src/payoffs/payoffs.jl): zero-size frozen marker dataclasses for the
taxonomy, and ``VanillaOption`` whose call broadcasts the intrinsic value
over a tensor of terminal prices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .dates import to_ticks

__all__ = [
    "ExerciseStyle",
    "European",
    "American",
    "CallPut",
    "Call",
    "Put",
    "Underlying",
    "Spot",
    "Forward",
    "VanillaOption",
    "parity_transform",
    "require_european",
]

_frozen = dataclasses.dataclass(frozen=True)


class ExerciseStyle:
    """Marker base: exercise style (European/American)."""


@_frozen
class European(ExerciseStyle):
    pass


@_frozen
class American(ExerciseStyle):
    pass


class CallPut:
    """Marker base: call/put. Instances are callable and return the ±1 indicator."""


@_frozen
class Call(CallPut):
    def __call__(self) -> float:
        return 1.0


@_frozen
class Put(CallPut):
    def __call__(self) -> float:
        return -1.0


class Underlying:
    """Marker base: whether the contract quotes against spot or forward."""


@_frozen
class Spot(Underlying):
    pass


@_frozen
class Forward(Underlying):
    pass


@_frozen
class VanillaOption:
    """A vanilla option: ``max(cp * (S - K), 0)`` at exercise.

    ``expiry`` is stored in ticks (ms since 0000-01-01); a
    ``datetime.date``/``datetime.datetime`` is converted by ``to_ticks``.
    ``strike`` may be a number or a 1-D array (a strike grid).
    """

    strike: Any
    expiry: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, spot: torch.Tensor) -> torch.Tensor:
        """Intrinsic value, broadcasting over a tensor of spot prices."""
        strike = torch.as_tensor(self.strike, dtype=spot.dtype, device=spot.device)
        return torch.clamp(self.call_put() * (spot - strike), min=0.0)


def require_european(payoff: VanillaOption, method_name: str, spot_only: bool = False):
    """Dispatch guard shared by the European-only pricers."""
    if not isinstance(payoff.exercise_style, European):
        raise TypeError(f"{method_name} prices European options only.")
    if spot_only and not isinstance(payoff.underlying, Spot):
        raise TypeError(f"{method_name} prices options on Spot only.")


def parity_transform(call_price, opt: VanillaOption, spot, rate_curve):
    """Put-call parity: ``put = call - S + K·df(T)``; calls pass through."""
    if isinstance(opt.call_put, Call):
        return call_price
    from ..market.rate_curve import df

    dev = call_price.device
    strike = torch.as_tensor(opt.strike, dtype=torch.float64, device=dev)
    return call_price - spot + strike * df(rate_curve, opt.expiry).to(dev)
