"""Payoffs: contract terms, exercise/underlying taxonomy, intrinsic value.

Port of the single-asset payoffs of ``hedgehog_tpu/core/payoffs.py``
(reference src/payoffs/payoffs.jl): zero-size frozen marker dataclasses for
the taxonomy (European, American and Bermudan exercise, barrier direction
and knock, averaging, lookback strike style), ``VanillaOption`` whose call
broadcasts the intrinsic value over a tensor of prices, the exotic
contracts the JAX package grew beyond the reference (digital, single and
double barrier, Asian, lookback, forward start, compound, chooser, cliquet,
autocallable, variance swap), the multi-asset payoffs (spread, basket,
rainbow), the interest-rate family (zero-coupon bond, bond option, caplet,
cap/floor, swaption), and the Bermudan exercise mask of the backward
inductions.
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
    "DigitalOption",
    "BarrierOption",
    "BarrierDirection",
    "Up",
    "Down",
    "BarrierKnock",
    "KnockIn",
    "KnockOut",
    "DoubleBarrierOption",
    "AsianOption",
    "LookbackOption",
    "StrikeStyle",
    "FloatingStrike",
    "FixedStrike",
    "VarianceSwap",
    "ForwardStartOption",
    "Cliquet",
    "Autocallable",
    "CompoundOption",
    "ChooserOption",
    "Averaging",
    "ArithmeticAverage",
    "GeometricAverage",
    "SpreadOption",
    "BasketOption",
    "RainbowOption",
    "ZeroCouponBond",
    "BondOption",
    "Caplet",
    "CapFloor",
    "Swaption",
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


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


@_frozen
class DigitalOption:
    """A cash-or-nothing digital: pays ``cash`` at exercise iff
    ``cp·(S − K) > 0``.  Same field layout as :class:`VanillaOption`."""

    strike: Any
    expiry: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()
    cash: Any = 1.0

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, spot: torch.Tensor) -> torch.Tensor:
        """Exercise value, broadcasting over a tensor of spot prices."""
        hit = self.call_put() * (spot - _as(self.strike, spot)) > 0.0
        return torch.where(hit, _as(self.cash, spot), 0.0)


class BarrierDirection:
    """Marker base: which side the barrier sits on (Up/Down)."""


@_frozen
class Up(BarrierDirection):
    pass


@_frozen
class Down(BarrierDirection):
    pass


class BarrierKnock:
    """Marker base: knock-in vs knock-out."""


@_frozen
class KnockIn(BarrierKnock):
    pass


@_frozen
class KnockOut(BarrierKnock):
    pass


@_frozen
class BarrierOption:
    """A continuously-monitored single-barrier option on a vanilla payoff.

    ``KnockOut`` pays the vanilla intrinsic at expiry iff the path never
    touches ``barrier`` (``Up``: max < H, ``Down``: min > H); ``KnockIn``
    iff it does.  ``__call__`` is the unconditional terminal intrinsic: the
    pricers apply the knock probability (the closed form, or per-segment
    Brownian-bridge no-cross products on Monte Carlo grids).

    ``rebate`` R ≥ 0: a knock-out pays R when the barrier is touched, at
    the hit time if ``rebate_at_hit`` else at expiry; a knock-in pays R at
    expiry iff the barrier is never touched (``rebate_at_hit`` is refused
    for knock-ins).  KI(R) + KO(R, at expiry) = vanilla + R·D(T)."""

    strike: Any
    expiry: Any
    barrier: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()
    direction: BarrierDirection = Down()
    knock: BarrierKnock = KnockOut()
    rebate: Any = 0.0
    rebate_at_hit: bool = False

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        if self.rebate_at_hit and isinstance(self.knock, KnockIn):
            raise ValueError(
                "rebate_at_hit applies to knock-outs only (a knock-in's "
                "rebate pays at expiry iff the barrier is never touched)"
            )

    def __call__(self, spot: torch.Tensor) -> torch.Tensor:
        """Unconditional terminal intrinsic."""
        return torch.clamp(self.call_put() * (spot - _as(self.strike, spot)), min=0.0)


@_frozen
class DoubleBarrierOption:
    """A continuously-monitored double-barrier option on a vanilla payoff:
    ``KnockOut`` pays the vanilla intrinsic iff the path never leaves the
    corridor (``lower``, ``upper``), ``KnockIn`` iff it does.
    ``__call__`` is the unconditional terminal intrinsic.  ``rebate`` as
    for :class:`BarrierOption` (the double one-touch, ``rebate_at_hit``,
    prices by the bridge Monte Carlo only)."""

    strike: Any
    expiry: Any
    lower: Any
    upper: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()
    knock: BarrierKnock = KnockOut()
    rebate: Any = 0.0
    rebate_at_hit: bool = False

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        if self.rebate_at_hit and isinstance(self.knock, KnockIn):
            raise ValueError(
                "rebate_at_hit applies to knock-outs only (a knock-in's "
                "rebate pays at expiry iff the corridor is never left)"
            )

    def __call__(self, spot: torch.Tensor) -> torch.Tensor:
        """Unconditional terminal intrinsic."""
        return torch.clamp(self.call_put() * (spot - _as(self.strike, spot)), min=0.0)


class Averaging:
    """Marker base: Asian averaging type."""


@_frozen
class ArithmeticAverage(Averaging):
    pass


@_frozen
class GeometricAverage(Averaging):
    pass


@_frozen
class AsianOption:
    """A fixed-strike Asian option on the discrete average of
    ``observations`` equally spaced fixings t_i = i·T/n, i = 1…n.  The
    geometric average has a Black-Scholes closed form; either prices by grid
    Monte Carlo with ``config.steps == observations``.  ``__call__`` maps
    the realized average to the vanilla intrinsic."""

    strike: Any
    expiry: Any
    observations: int = 12
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()
    averaging: Averaging = ArithmeticAverage()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, average: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.call_put() * (average - _as(self.strike, average)), min=0.0)


class StrikeStyle:
    """Marker base: lookback strike convention (floating vs fixed)."""


@_frozen
class FloatingStrike(StrikeStyle):
    pass


@_frozen
class FixedStrike(StrikeStyle):
    pass


@_frozen
class LookbackOption:
    """A continuously-monitored lookback option.

    ``FloatingStrike``: a call pays S_T − m_T (m the running minimum), a
    put M_T − S_T (M the running maximum); ``strike`` is ignored.
    ``FixedStrike``: a call pays max(M_T − K, 0), a put max(K − m_T, 0).
    ``running_extremum`` seeds a monitoring window already running (None
    starts it at the spot); the pricers clamp it against the spot."""

    expiry: Any
    strike: Any = 0.0
    strike_style: StrikeStyle = FloatingStrike()
    call_put: CallPut = Call()
    exercise_style: ExerciseStyle = European()
    underlying: Underlying = Spot()
    running_extremum: Any = None

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    @property
    def uses_maximum(self) -> bool:
        """True when the contract monitors the running maximum (fixed-strike
        call, floating-strike put); False for the running minimum."""
        if isinstance(self.strike_style, FixedStrike):
            return isinstance(self.call_put, Call)
        return isinstance(self.call_put, Put)

    def __call__(self, spot: torch.Tensor, extremum: torch.Tensor) -> torch.Tensor:
        """Payout from the terminal spot and the realized extremum (the one
        :attr:`uses_maximum` names), broadcasting."""
        cp = self.call_put()
        if isinstance(self.strike_style, FixedStrike):
            return torch.clamp(cp * (extremum - _as(self.strike, extremum)), min=0.0)
        # floating: cp·(S_T − extremum) ≥ 0 by construction (min ≤ S_T ≤ max)
        return cp * (spot - extremum)


@_frozen
class ForwardStartOption:
    """A forward-start option: at ``expiry`` it pays
    max(cp·(S_T − k·S_{t_start}), 0), the strike set at ``start`` as the
    fraction ``strike_fraction`` (k) of the then-spot.  ``__call__`` maps
    (S_fix, S_T) to the payout."""

    strike_fraction: Any
    expiry: Any
    start: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        object.__setattr__(self, "start", to_ticks(self.start))

    def __call__(self, s_fix: torch.Tensor, s_terminal: torch.Tensor) -> torch.Tensor:
        k = _as(self.strike_fraction, s_terminal)
        return torch.clamp(self.call_put() * (s_terminal - k * s_fix), min=0.0)


@_frozen
class CompoundOption:
    """An option on an option (Geske 1979): at ``decision_date`` the holder
    may pay ``strike`` for the inner European vanilla (``inner_call_put``,
    ``inner_strike``, ``expiry``).  The pricers close over the inner value
    and pay :meth:`decision_value`."""

    strike: Any
    decision_date: Any
    inner_strike: Any
    expiry: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    inner_call_put: CallPut = Call()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        object.__setattr__(self, "decision_date", to_ticks(self.decision_date))
        if self.decision_date >= self.expiry:
            raise ValueError("compound decision_date must precede the inner expiry")

    def decision_value(self, inner_value: torch.Tensor) -> torch.Tensor:
        """max(w₁·(inner − K₁), 0) at the decision date."""
        strike = _as(self.strike, inner_value)
        return torch.clamp(self.call_put() * (inner_value - strike), min=0.0)


@_frozen
class ChooserOption:
    """A simple chooser: at ``choose_date`` the holder takes either the call
    or the put with the same ``strike`` and ``expiry``."""

    strike: Any
    expiry: Any
    choose_date: Any
    exercise_style: ExerciseStyle = European()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        object.__setattr__(self, "choose_date", to_ticks(self.choose_date))
        if self.choose_date >= self.expiry:
            raise ValueError("chooser choose_date must precede expiry")


@_frozen
class Cliquet:
    """A locally capped and floored cliquet: at ``expiry`` it pays

        notional · Σ_{i=1..n} clip(S_{t_i}/S_{t_{i-1}} − 1, local_floor, local_cap)

    over ``observations`` equally spaced reset periods.  ``__call__`` maps
    the period-return tensor (periods on the last axis) to the payout."""

    expiry: Any
    observations: int = 12
    local_floor: Any = 0.0
    local_cap: Any = 0.08
    notional: Any = 1.0
    exercise_style: ExerciseStyle = European()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, period_returns: torch.Tensor) -> torch.Tensor:
        lo, hi = _as(self.local_floor, period_returns), _as(self.local_cap, period_returns)
        clipped = torch.minimum(torch.maximum(period_returns, lo), hi)
        return self.notional * torch.sum(clipped, dim=-1)


@_frozen
class Autocallable:
    """An autocallable note on one underlying: ``periods`` equally spaced
    observation dates t_i = i·T/n, levels as fractions of the initial spot
    S₀.  At the first t_i with S_{t_i} ≥ ``autocall_barrier``·S₀ the note
    redeems early.  Snowball (``coupon_barrier=None``): redemption pays
    notional·(1 + i·coupon); never called, notional·(1 + n·coupon) at
    expiry without a knock-in, else notional·min(S_T/S₀, 1).  Phoenix
    (``coupon_barrier`` set): a coupon with memory at every observation at
    or above ``coupon_barrier``·S₀ while alive; redemption and maturity pay
    principal (or the knock-in leg).  ``ki_monitoring``: ``"observations"``
    checks the knock-in on the n dates, ``"continuous"`` applies
    Brownian-bridge crossing probabilities on the grid, ``"auto"``
    continuous where the grid carries bridge factors."""

    expiry: Any
    periods: int = 4
    autocall_barrier: Any = 1.0
    coupon: Any = 0.05
    knock_in_barrier: Any = 0.7
    coupon_barrier: Any = None
    notional: Any = 1.0
    ki_monitoring: str = "auto"
    exercise_style: ExerciseStyle = European()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        if self.ki_monitoring not in ("auto", "continuous", "observations"):
            raise ValueError(
                f"ki_monitoring must be 'auto', 'continuous' or "
                f"'observations', got {self.ki_monitoring!r}"
            )


@_frozen
class VarianceSwap:
    """A discretely sampled variance swap: at ``expiry`` it pays
    notional · (RV − strike_var), RV = (1/T)·Σ ln(S_{t_i}/S_{t_{i-1}})² over
    ``observations`` equally spaced fixings (``strike_var`` in variance
    units).  ``__call__`` maps the realized variance to the payout."""

    strike_var: Any
    expiry: Any
    observations: int = 252
    notional: Any = 1.0
    exercise_style: ExerciseStyle = European()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, realized_var: torch.Tensor) -> torch.Tensor:
        return self.notional * (realized_var - _as(self.strike_var, realized_var))


@_frozen
class SpreadOption:
    """A two-asset spread option: pays max(cp·(S¹_T − S²_T − K), 0) at
    ``expiry`` on a multi-asset market's first two assets.  K = 0 is the
    exchange option (Margrabe's exact closed form); K ≠ 0 prices by Kirk's
    approximation or correlated terminal Monte Carlo."""

    strike: Any
    expiry: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.call_put() * (s1 - s2 - _as(self.strike, s1)), min=0.0)


@_frozen
class BasketOption:
    """A weighted basket option: pays max(cp·(B_T − K), 0) with B the
    ``weights``-weighted arithmetic average (``geometric=False``, Monte
    Carlo only) or the geometric average Π S_i^{w_i} (``geometric=True``,
    exactly lognormal under correlated GBM: the closed-form oracle).
    ``__call__`` maps the asset tensor (..., n_assets) to the intrinsic."""

    strike: Any
    expiry: Any
    weights: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()
    geometric: bool = False

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, spots: torch.Tensor) -> torch.Tensor:
        w = _as(self.weights, spots)
        if self.geometric:
            basket = torch.exp(torch.sum(w * torch.log(spots), dim=-1))
        else:
            basket = torch.sum(w * spots, dim=-1)
        return torch.clamp(self.call_put() * (basket - _as(self.strike, basket)), min=0.0)


@_frozen
class RainbowOption:
    """A best-of (``best=True``) or worst-of option on two or more assets:
    pays max(cp·(ext_i S^i_T − K), 0) at ``expiry``, ext the maximum or the
    minimum over the assets.  Two assets price in closed form (Stulz 1982);
    any number by correlated terminal Monte Carlo.  ``__call__`` maps the
    asset tensor (..., n_assets) to the intrinsic."""

    strike: Any
    expiry: Any
    best: bool = True
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    underlying: Underlying = Spot()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))

    def __call__(self, spots: torch.Tensor) -> torch.Tensor:
        ext = torch.amax(spots, dim=-1) if self.best else torch.amin(spots, dim=-1)
        return torch.clamp(self.call_put() * (ext - _as(self.strike, ext)), min=0.0)


@_frozen
class ZeroCouponBond:
    """A unit zero-coupon bond paying 1 at ``maturity``: under a curve-fitted
    short-rate model its price is the curve's discount factor."""

    maturity: Any

    def __post_init__(self):
        object.__setattr__(self, "maturity", to_ticks(self.maturity))

    @property
    def expiry(self):
        return self.maturity


@_frozen
class BondOption:
    """European option, exercising at ``expiry``, on a unit zero-coupon bond
    maturing at ``bond_maturity`` (> expiry): pays max(cp·(P(T_E, T_B) − K), 0)
    at T_E."""

    strike: Any
    expiry: Any
    bond_maturity: Any
    call_put: CallPut = Call()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        object.__setattr__(self, "bond_maturity", to_ticks(self.bond_maturity))
        if self.bond_maturity <= self.expiry:
            raise ValueError("bond_maturity must exceed the option expiry")


@_frozen
class Caplet:
    """A caplet (``Call()``) or floorlet (``Put()``) on the simple forward
    rate L(start, end): pays notional·τ·max(cp·(L − strike_rate), 0) at
    ``end``, τ = yearfrac(start, end); equivalently notional·(1 + X·τ) bond
    puts (calls) struck at 1/(1 + X·τ) exercising at ``start``."""

    strike_rate: Any
    start: Any
    end: Any
    notional: Any = 1.0
    call_put: CallPut = Call()

    def __post_init__(self):
        object.__setattr__(self, "start", to_ticks(self.start))
        object.__setattr__(self, "end", to_ticks(self.end))
        if self.end <= self.start:
            raise ValueError("caplet end must exceed start")

    @property
    def expiry(self):  # the rate fixes at start
        return self.start


@_frozen
class CapFloor:
    """A cap (``Call()``) or floor (``Put()``): the strip of caplets on
    consecutive ``dates`` pairs, priced as the sum of its caplets.  The first
    period fixes at dates[0] (a spot-start cap includes today's known
    fixing)."""

    strike_rate: Any
    dates: Any
    notional: Any = 1.0
    call_put: CallPut = Call()

    def __post_init__(self):
        d = tuple(to_ticks(x) for x in self.dates)
        if len(d) < 2:
            raise ValueError("CapFloor needs at least two dates (one period)")
        if any(b <= a for a, b in zip(d, d[1:])):
            raise ValueError("CapFloor dates must be strictly increasing")
        object.__setattr__(self, "dates", d)

    @property
    def expiry(self):  # the last payment
        return self.dates[-1]

    def caplets(self):
        """The equivalent Caplet strip."""
        return tuple(Caplet(self.strike_rate, a, b, self.notional, self.call_put)
                     for a, b in zip(self.dates, self.dates[1:]))


@_frozen
class Swaption:
    """A payer (``payer=True``: pay fixed X, receive float) or receiver
    swaption on a unit-notional swap with fixed payments at
    ``payment_dates`` (strictly increasing, the first after ``expiry``;
    accruals from consecutive gaps starting at ``expiry``).  At T_E the
    fixed+principal leg is Σ c_i·P(T_E, t_i), c_i = X·τ_i (+1 at t_n), and
    the payer pays max(1 − Σ c_i P, 0).  ``Bermudan(dates)`` adds exercise
    on reset dates (payment dates but the last; co-terminal), ``expiry``
    always the first exercise date."""

    strike_rate: Any
    expiry: Any
    payment_dates: Any
    payer: bool = True
    notional: Any = 1.0
    exercise_style: ExerciseStyle = European()

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))
        dates = tuple(to_ticks(d) for d in self.payment_dates)
        if len(dates) == 0:
            raise ValueError("swaption needs at least one payment date")
        if any(b <= a for a, b in zip(dates, dates[1:])) or dates[0] <= self.expiry:
            raise ValueError("payment_dates must be strictly increasing and after expiry")
        object.__setattr__(self, "payment_dates", dates)
        if isinstance(self.exercise_style, Bermudan):
            extra = tuple(to_ticks(d) for d in self.exercise_style.exercise_dates)
            if any(d not in dates[:-1] for d in extra):
                raise ValueError(
                    "Bermudan swaption exercise dates must be reset dates: "
                    "payment dates except the last (co-terminal convention)"
                )
        elif not isinstance(self.exercise_style, European):
            raise TypeError("Swaption exercise_style must be European or Bermudan(dates)")

    def exercise_ticks(self):
        """Sorted exercise dates in ticks: expiry, then any Bermudan reset
        dates."""
        extra = (tuple(to_ticks(d) for d in self.exercise_style.exercise_dates)
                 if isinstance(self.exercise_style, Bermudan) else ())
        return tuple(sorted({self.expiry, *extra}))


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
    """Put-call parity: ``put = call - S + K·df(T)`` for vanillas, the cash
    parity ``put = cash·df(T) − call`` for digitals; calls pass through."""
    if isinstance(opt.call_put, Call):
        return call_price
    from ..market.rate_curve import df

    dev = call_price.device
    if isinstance(opt, DigitalOption):
        cash = torch.as_tensor(opt.cash, dtype=torch.float64, device=dev)
        return cash * df(rate_curve, opt.expiry).to(dev) - call_price
    strike = torch.as_tensor(opt.strike, dtype=torch.float64, device=dev)
    return call_price - spot + strike * df(rate_curve, opt.expiry).to(dev)
