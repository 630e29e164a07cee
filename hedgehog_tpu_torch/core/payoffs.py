"""Vanilla payoffs: contract terms, exercise/underlying taxonomy, intrinsic
value.

Port of the vanilla subset of ``hedgehog_tpu/core/payoffs.py`` (reference
src/payoffs/payoffs.jl): zero-size frozen marker dataclasses for the
taxonomy (European, American and Bermudan exercise), and ``VanillaOption``
whose call broadcasts the intrinsic value over a tensor of prices, and the
Bermudan exercise mask of the backward inductions.
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
    "Bermudan",
    "CallPut",
    "Call",
    "Put",
    "Underlying",
    "Spot",
    "Forward",
    "VanillaOption",
    "bermudan_step_mask",
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


@_frozen
class Bermudan(ExerciseStyle):
    """Exercise on ``exercise_dates`` only (plus expiry), stored as a tuple
    of int ticks.  CRR and LSM snap each date to the nearest lattice or grid
    time: ``Bermudan(())`` is European, ``Bermudan(every grid date)``
    American."""

    exercise_dates: Any = ()

    def __post_init__(self):
        object.__setattr__(self, "exercise_dates",
                           tuple(int(to_ticks(d)) for d in self.exercise_dates))


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


def bermudan_step_mask(style: ExerciseStyle, market, expiry, nsteps: int,
                       device="cpu") -> torch.Tensor:
    """The (nsteps,) bool exercise mask of the backward inductions (CRR
    nodes, LSM grid) on ``device``: slot t gates exercise at t·T/nsteps for
    t = 1..nsteps − 1 (slot 0 is never set; expiry is always exercisable
    through the terminal payoff).  American: all True; Bermudan: True at
    the nearest grid step of each date, a date outside 1..nsteps − 1
    raising ValueError rather than being dropped."""
    import numpy as np

    from ..market.inputs import market_yearfrac

    if isinstance(style, American):
        return torch.ones((nsteps,), dtype=torch.bool, device=device)
    if not isinstance(style, Bermudan):
        raise TypeError(f"no exercise mask for {type(style).__name__}")
    T = float(market_yearfrac(market, expiry))
    mask = np.zeros((nsteps,), dtype=bool)
    for d in style.exercise_dates:
        t = float(market_yearfrac(market, d))
        idx = int(round(t / T * nsteps))
        if not 1 <= idx <= nsteps - 1:
            raise ValueError(
                f"Bermudan exercise date at t={t:.6f}y maps to grid step "
                f"{idx} outside 1..{nsteps - 1} (T={T:.6f}y, {nsteps} "
                f"steps); dates at expiry are implicit, dates before the "
                f"first step need more steps"
            )
        mask[idx] = True
    return torch.as_tensor(mask, device=device)


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
