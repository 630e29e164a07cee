"""Market vol quotes: bid/mid/ask price⇄IV resolution with validation policies.

Port of ``hedgehog_tpu/market/vol_quotes.py`` (reference
src/market_data/vol_quotes.jl).  Prices are truth, IVs are cached views,
NaN marks a missing value (:49-61).  Policies, ``"throw" | "warn" |
"ignore"``, govern price/IV consistency, missing mids and bid ≤ mid ≤ ask
monotonicity (:107-233); "warn" goes through ``warnings.warn``.  Futures
quotes are treated as forwards (no convexity adjustment, :17-21).

Devices: the conversions and the batch resolve on the device of their
pricing method (``iv_model``, ``BlackScholesAnalytic()`` by default): the
GPU unless the caller asks for the CPU.  ``resolve_quotes_batch`` resolves
a whole surface there in one batched Black-Scholes inversion and one pricing
pass; the scalar ``VolQuote.build`` stores its resolved values as floats.
The policies read their violation counts on the host.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import torch

from ..calibration.calibration import CalibrationProblem, RootFinderAlgo
from ..calibration.implied import implied_vol_bs, iv_to_price_bs
from ..core.dates import ACT365F, Act365Fixed, _LinearDayCount, to_ticks, yearfrac
from ..core.lenses import FieldLens
from ..core.problems import BasketPricingProblem, PricingProblem
from ..core.solve import solve
from ..market.inputs import BlackScholesInputs
from ..market.rate_curve import FlatRateCurve, df
from ..methods.black_scholes import BlackScholesAnalytic
from ..utils import f64, resolve_device

__all__ = [
    "SpotObs",
    "ForwardObs",
    "FuturesObs",
    "underlying_spot",
    "underlying_forward",
    "VolQuote",
    "VolQuoteConfig",
    "iv_to_price",
    "price_to_iv",
    "ResolvedQuotes",
    "resolve_quotes_batch",
]

ABS_TOL_P = 1e-10
REL_TOL_P = 5e-7

_POLICIES_3 = ("throw", "warn", "ignore")
_POLICIES_2 = ("throw", "warn")

_frozen = dataclasses.dataclass(frozen=True)


class UnderlyingObs:
    pass


@_frozen
class SpotObs(UnderlyingObs):
    S: Any = 0.0


@_frozen
class ForwardObs(UnderlyingObs):
    F: Any = 0.0


@_frozen
class FuturesObs(UnderlyingObs):
    G: Any = 0.0


def _obs_value(und: UnderlyingObs):
    return und.S if isinstance(und, SpotObs) else und.F if isinstance(und, ForwardObs) else und.G


def _spot_from_obs(und: UnderlyingObs, D):
    if isinstance(und, SpotObs):
        return und.S
    return _obs_value(und) * D  # futures as forwards; no convexity adjustment


def _forward_from_obs(und: UnderlyingObs, D):
    if isinstance(und, SpotObs):
        return und.S / D
    return _obs_value(und)


def underlying_spot(und: UnderlyingObs, r, ref, expiry, daycount=None):
    """Spot-equivalent S* of an observation (vol_quotes.jl:6-21)."""
    D = df(FlatRateCurve(to_ticks(ref), r, daycount or ACT365F), to_ticks(expiry))
    return _spot_from_obs(und, D)


def underlying_forward(und: UnderlyingObs, r, ref, expiry, daycount=None):
    """Forward F of an observation (vol_quotes.jl:23-35)."""
    D = df(FlatRateCurve(to_ticks(ref), r, daycount or ACT365F), to_ticks(expiry))
    return _forward_from_obs(und, D)


# ---------------------------------------------------------------- policies


def _handle(policy: str, msg: str, valid=_POLICIES_3):
    if policy not in valid:
        raise ValueError(f"invalid policy {policy!r}; expected one of {valid}")
    if policy == "throw":
        raise ValueError(msg)
    if policy == "warn":
        warnings.warn(msg, stacklevel=3)


@_frozen
class VolQuoteConfig:
    """Construction and validation policies (vol_quotes.jl:287-364).
    ``iv_model`` prices and inverts the quotes, on its own device;
    ``daycount`` sets the quotes' τ (discounting and IV resolution)."""

    iv_model: Any = BlackScholesAnalytic()
    iv_guess: float = 0.5
    abs_tol_p: float = ABS_TOL_P
    rel_tol_p: float = REL_TOL_P
    vol_price_inconsistency_handling: str = "warn"  # throw | warn | ignore
    missing_mid_handling: str = "throw"  # throw | warn
    price_monotonicity_handling: str = "warn"  # throw | warn
    iv_monotonicity_handling: str = "warn"  # throw | warn
    normalized_input: bool = False
    daycount: Any = ACT365F

    def __post_init__(self):
        checks = [
            (self.vol_price_inconsistency_handling, _POLICIES_3, "vol_price_inconsistency_handling"),
            (self.missing_mid_handling, _POLICIES_2, "missing_mid_handling"),
            (self.price_monotonicity_handling, _POLICIES_2, "price_monotonicity_handling"),
            (self.iv_monotonicity_handling, _POLICIES_2, "iv_monotonicity_handling"),
        ]
        for value, valid, name in checks:
            if value not in valid:
                raise ValueError(f"{name} must be one of {valid}, got {value!r}")


def _method_device(method) -> torch.device:
    return resolve_device(getattr(method, "device", "cuda"))


# ---------------------------------------------------------------- conversions


def iv_to_price(payoff, underlying_price, interest_rate, iv, reference_date, method=None, *,
                daycount=None):
    """Price from an IV under ``method`` (default Black-Scholes analytic, on
    the GPU), vol_quotes.jl:495-507; ``daycount`` sets τ for discounting and
    the vol leg (default ACT/365F)."""
    method = method or BlackScholesAnalytic()
    dc = daycount or ACT365F
    curve = FlatRateCurve(to_ticks(reference_date), interest_rate, dc)
    market = BlackScholesInputs(to_ticks(reference_date), curve, underlying_price, iv, daycount=dc)
    return solve(PricingProblem(payoff, market), method).price


def price_to_iv(payoff, underlying_price, interest_rate, price, reference_date, method=None, *,
                iv_guess: float = 0.5, normalized_input: bool = False, bracket=(0.01, 2.0),
                daycount=None):
    """Implied vol under ``method`` by root finding (vol_quotes.jl:520-551),
    on the method's device.

    With ``normalized_input=True`` the ``price`` is price/F, denormalized
    with F = S*/DF.  Black-Scholes inverts in closed-form residuals on the
    reference's (1e-6, 5.0); any other method through ``CalibrationProblem``
    and ``RootFinderAlgo`` on ``bracket`` with the lens
    ``market_inputs.sigma.sigma`` (Carr-Madan: ``bound="auto"`` holds its
    accuracy down to low σ√T)."""
    method = method or BlackScholesAnalytic()
    dev = _method_device(method)
    dc = daycount or ACT365F
    ref_ticks = to_ticks(reference_date)
    curve = FlatRateCurve(ref_ticks, interest_rate, dc)
    DF = df(curve, payoff.expiry)
    F = underlying_price / DF
    target = price * F if normalized_input else price
    if isinstance(method, BlackScholesAnalytic):
        T = yearfrac(ref_ticks, payoff.expiry, dc)
        return implied_vol_bs(f64(target, device=dev), payoff.strike, f64(T, device=dev),
                              f64(underlying_price, device=dev), f64(interest_rate, device=dev),
                              payoff.call_put())
    market = BlackScholesInputs(ref_ticks, curve, underlying_price, iv_guess, daycount=dc)
    calib = CalibrationProblem(
        BasketPricingProblem([payoff], market),
        f64(target, device=dev).reshape(1),
        f64([iv_guess], device=dev),
        method,
        (FieldLens("market_inputs.sigma.sigma"),),
    )
    return solve(calib, RootFinderAlgo(lo=bracket[0], hi=bracket[1])).u


# ------------------------------------------------------ batched resolution


class ResolvedQuotes:
    """Structure-of-arrays result of :func:`resolve_quotes_batch`: consistent
    (price, iv) tensors per level, NaN where the input level was missing."""

    def __init__(self, bid_price, mid_price, ask_price, bid_iv, mid_iv, ask_iv):
        self.bid_price, self.mid_price, self.ask_price = bid_price, mid_price, ask_price
        self.bid_iv, self.mid_iv, self.ask_iv = bid_iv, mid_iv, ask_iv


def _resolve_level_batch(price, iv, K, T, S, r, cp, config):
    """Branchless batched price/IV resolution of one level: (price, iv,
    inconsistent mask)."""
    has_p, has_iv = ~torch.isnan(price), ~torch.isnan(iv)
    p_safe = torch.where(has_p, price, torch.ones_like(price))
    iv_safe = torch.where(has_iv, iv, torch.full_like(iv, 0.2))
    iv_from_p = implied_vol_bs(p_safe, K, T, S, r, cp)
    p_from_iv = iv_to_price_bs(iv_safe, K, T, S, r, cp)
    nan = torch.full_like(price, math.nan)
    out_p = torch.where(has_p, price, torch.where(has_iv, p_from_iv, nan))
    out_iv = torch.where(has_iv, iv, torch.where(has_p, iv_from_p, nan))
    bad = (has_p & has_iv
           & (torch.abs(price - p_from_iv) > config.abs_tol_p + config.rel_tol_p * torch.abs(price)))
    return out_p, out_iv, bad


def resolve_quotes_batch(strikes, expiries, underlying: UnderlyingObs, interest_rate,
                         reference_date, *, bid_price=None, mid_price=None, ask_price=None,
                         bid_iv=None, mid_iv=None, ask_iv=None, call_put=1.0,
                         config: Optional[VolQuoteConfig] = None) -> ResolvedQuotes:
    """Resolve a whole surface of bid/mid/ask quotes in one batched program
    on the device of ``config.iv_model`` (the GPU unless it asks for the
    CPU): every level of every quote is a lane of one Black-Scholes
    inversion and one closed-form pricing pass (the reference resolves each
    quote with up to three scalar root finds, vol_quotes.jl:420-493).  NaN
    marks missing entries, as in :meth:`VolQuote.build`.

    - ``strikes`` and ``expiries`` broadcast to the quote grid; expiries are
      ticks or dates (converted element-wise when not an array);
    - ``underlying`` holds a scalar or per-quote observation;
    - the policies run after the solve on the violation counts;
    - the batch supports the Black-Scholes ``iv_model`` only.
    """
    config = config or VolQuoteConfig()
    if not isinstance(config.iv_model, BlackScholesAnalytic):
        raise TypeError("resolve_quotes_batch supports BlackScholesAnalytic iv_model only")
    dev = _method_device(config.iv_model)
    ref_ticks = to_ticks(reference_date)
    dc = config.daycount
    if hasattr(expiries, "__iter__") and not hasattr(expiries, "dtype"):
        expiry_list = list(expiries)
        expiries = f64([to_ticks(e) for e in expiry_list], device=dev)
    else:
        expiry_list = None
        expiries = f64(expiries, device=dev)
    if dc is None or isinstance(dc, (Act365Fixed, _LinearDayCount)):
        T = yearfrac(ref_ticks, expiries, dc)
    else:
        # calendar conventions (30E/360, ACT/ACT ISDA) are staircase functions
        # of concrete dates: evaluated per expiry on the host, then broadcast
        src = expiry_list if expiry_list is not None else expiries.reshape(-1).tolist()
        T = f64([yearfrac(ref_ticks, e, dc) for e in src], device=dev).reshape(expiries.shape)
    strikes = f64(strikes, device=dev)
    r = f64(interest_rate, device=dev)
    cp = f64(call_put, device=dev)

    D = torch.exp(-r * T)
    obs = type(underlying)(f64(_obs_value(underlying), device=dev))
    S, F = _spot_from_obs(obs, D), _forward_from_obs(obs, D)

    # the caller's inputs, checked as VolQuote.build checks them
    # (vol_quotes.jl:211-233)
    if bool(torch.any(T <= 0.0)):
        raise ValueError("all expiries must be after reference_date; got year-fractions "
                         f"min={float(torch.min(T))}")
    if bool(torch.any(S <= 0.0)):
        raise ValueError("underlying price must be positive")

    shape = torch.broadcast_shapes(strikes.shape, T.shape, S.shape, cp.shape, r.shape)
    nanfull = torch.full(shape, math.nan, dtype=torch.float64, device=dev)

    def as_grid(x):
        return nanfull if x is None else torch.broadcast_to(f64(x, device=dev), shape)

    levels, bad_counts = {}, {}
    for name, p_in, iv_in in (("bid", bid_price, bid_iv), ("mid", mid_price, mid_iv),
                              ("ask", ask_price, ask_iv)):
        p = as_grid(p_in)
        if config.normalized_input:
            p = p * F  # forward-normalized prices (vol_quotes.jl:79-95)
        p_out, iv_out, bad = _resolve_level_batch(p, as_grid(iv_in), strikes, T, S, r, cp, config)
        levels[name] = (p_out, iv_out)
        bad_counts[name] = bad
    counts = dict(zip(bad_counts, torch.stack([torch.sum(b) for b in bad_counts.values()]).tolist()))
    total_bad = sum(counts.values())
    if total_bad:
        _handle(config.vol_price_inconsistency_handling,
                f"Inconsistent price/IV in {total_bad} quote level(s): "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v))

    (bid_p, bid_v), (mid_p, mid_v), (ask_p, ask_v) = levels["bid"], levels["mid"], levels["ask"]
    all_p = ~(torch.isnan(bid_p) | torch.isnan(mid_p) | torch.isnan(ask_p))
    all_v = ~(torch.isnan(bid_v) | torch.isnan(mid_v) | torch.isnan(ask_v))
    n_missing, n_bad_p, n_bad_v = torch.stack([
        torch.sum(torch.isnan(mid_p) & torch.isnan(mid_v)),
        torch.sum(all_p & ~((bid_p <= mid_p) & (mid_p <= ask_p))),
        torch.sum(all_v & ~((bid_v <= mid_v) & (mid_v <= ask_v))),
    ]).tolist()
    if n_missing:
        _handle(config.missing_mid_handling,
                "resolve_quotes_batch: quotes with neither mid_price nor mid_iv", _POLICIES_2)
    if n_bad_p:
        _handle(config.price_monotonicity_handling,
                f"Price monotonicity violated in {n_bad_p} quote(s)", _POLICIES_2)
    if n_bad_v:
        _handle(config.iv_monotonicity_handling,
                f"IV monotonicity violated in {n_bad_v} quote(s)", _POLICIES_2)
    return ResolvedQuotes(bid_p, mid_p, ask_p, bid_v, mid_v, ask_v)


# ---------------------------------------------------------------- VolQuote


def _isnan(x) -> bool:
    try:
        return math.isnan(float(x))
    except (TypeError, ValueError):
        return False


def _denormalize(bid, mid, ask, F, normalized: bool):
    if not normalized:
        return bid, mid, ask
    return tuple(x if _isnan(x) else x * F for x in (bid, mid, ask))


def _resolve_pair(price, iv, price_from_iv, iv_from_price, config: VolQuoteConfig):
    """A consistent (price, iv) pair from a price and/or an IV
    (vol_quotes.jl:107-151)."""
    if _isnan(price) and _isnan(iv):
        return float("nan"), float("nan")
    if not _isnan(price) and _isnan(iv):
        return price, float(iv_from_price(price))
    if _isnan(price) and not _isnan(iv):
        return float(price_from_iv(iv)), iv
    price_check = float(price_from_iv(iv))
    consistent = abs(price - price_check) <= config.abs_tol_p + config.rel_tol_p * abs(price)
    if not consistent:
        _handle(config.vol_price_inconsistency_handling,
                f"Inconsistent price/IV: price={price}, price_from_iv={price_check}")
    return price, iv


def _validate_monotonicity(bid, mid, ask, label: str, policy: str):
    if _isnan(bid) or _isnan(mid) or _isnan(ask):
        return
    if not (bid <= mid <= ask):
        _handle(policy, f"{label} monotonicity violated: bid={bid} mid={mid} ask={ask}",
                _POLICIES_2)


@_frozen
class VolQuote:
    """A resolved market option quote: payoff, observation and consistent
    bid/mid/ask prices and IVs (vol_quotes.jl:49-61).  Build it with
    :meth:`VolQuote.build`, the validating constructor (vol_quotes.jl:420-493)."""

    payoff: Any
    underlying: UnderlyingObs
    interest_rate: float
    mid_price: float
    bid_price: float
    ask_price: float
    mid_iv: float
    bid_iv: float
    ask_iv: float
    reference_date: int
    iv_model: Any = BlackScholesAnalytic()
    daycount: Any = ACT365F

    @classmethod
    def build(cls, payoff, underlying: UnderlyingObs, interest_rate: float, *,
              mid_price: float = float("nan"), mid_iv: float = float("nan"),
              bid_price: float = float("nan"), bid_iv: float = float("nan"),
              ask_price: float = float("nan"), ask_iv: float = float("nan"),
              reference_date, config: Optional[VolQuoteConfig] = None) -> "VolQuote":
        config = config or VolQuoteConfig()
        ref_ticks = to_ticks(reference_date)

        # input validation (vol_quotes.jl:211-233)
        if float(payoff.expiry) <= ref_ticks:
            raise ValueError(f"Expiry ({payoff.expiry}) must be after reference_date ({ref_ticks})")
        S_obs = _obs_value(underlying)
        if float(S_obs) <= 0:
            raise ValueError(f"Underlying price must be positive, got {S_obs}")
        if abs(interest_rate) > 1.0:
            warnings.warn(f"Interest rate seems unrealistic: {interest_rate}", stacklevel=2)
        if _isnan(mid_price) and _isnan(mid_iv):
            _handle(config.missing_mid_handling,
                    "VolQuote requires at least one of mid_price or mid_iv", _POLICIES_2)

        dc = config.daycount
        D = df(FlatRateCurve(ref_ticks, interest_rate, dc), payoff.expiry)
        S_spot = _spot_from_obs(underlying, D)
        F = _forward_from_obs(underlying, D)
        bid_price, mid_price, ask_price = _denormalize(bid_price, mid_price, ask_price, float(F),
                                                       config.normalized_input)

        def price_from_iv(iv):
            return iv_to_price(payoff, S_spot, interest_rate, iv, ref_ticks, config.iv_model,
                               daycount=dc)

        def iv_from_price(p):
            return price_to_iv(payoff, S_spot, interest_rate, p, ref_ticks, config.iv_model,
                               iv_guess=config.iv_guess, daycount=dc)

        bid_price, bid_iv = _resolve_pair(bid_price, bid_iv, price_from_iv, iv_from_price, config)
        mid_price, mid_iv = _resolve_pair(mid_price, mid_iv, price_from_iv, iv_from_price, config)
        ask_price, ask_iv = _resolve_pair(ask_price, ask_iv, price_from_iv, iv_from_price, config)
        _validate_monotonicity(bid_price, mid_price, ask_price, "Price",
                               config.price_monotonicity_handling)
        _validate_monotonicity(bid_iv, mid_iv, ask_iv, "IV", config.iv_monotonicity_handling)
        return cls(payoff, underlying, interest_rate, mid_price, bid_price, ask_price, mid_iv,
                   bid_iv, ask_iv, ref_ticks, config.iv_model, dc)

    # ---- quote-level conversion helpers (vol_quotes.jl:554-622) ----

    def price_to_iv(self, price, *, iv_guess: float = 0.5, normalized_input: bool = False):
        S_spot = underlying_spot(self.underlying, self.interest_rate, self.reference_date,
                                 self.payoff.expiry, self.daycount)
        return price_to_iv(self.payoff, S_spot, self.interest_rate, price, self.reference_date,
                           self.iv_model, iv_guess=iv_guess, normalized_input=normalized_input,
                           daycount=self.daycount)

    def iv_to_price(self, iv, *, normalize: bool = True):
        S_spot = underlying_spot(self.underlying, self.interest_rate, self.reference_date,
                                 self.payoff.expiry, self.daycount)
        price_abs = iv_to_price(self.payoff, S_spot, self.interest_rate, iv, self.reference_date,
                                self.iv_model, daycount=self.daycount)
        if normalize:
            F = underlying_forward(self.underlying, self.interest_rate, self.reference_date,
                                   self.payoff.expiry, self.daycount)
            return price_abs / f64(F, device=price_abs.device)
        return price_abs
