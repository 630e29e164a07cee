"""Closed-form Black-Scholes: European vanillas and the exotic closed forms.

Port of ``hedgehog_tpu/methods/black_scholes.py`` (reference
black_scholes.jl): ``bs_price`` and ``bs_geometry``, and the closed forms
the JAX package grew beyond the reference: the cash-or-nothing digital,
Reiner–Rubinstein single barriers with rebates, the reflection series of
the double barrier, the discrete geometric Asian, Goldman–Sosin–Gatto and
Conze–Viswanathan lookbacks, Geske's compound option and the simple
chooser, the cliquet, the forward start (Rubinstein) and the variance swap.
``BlackScholesAnalytic.device`` names where the price is computed, the GPU
unless the caller asks for the CPU; the ``bs_*`` functions compute on the
device of the tensors they are given.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.dates import yearfrac
from ..core.payoffs import (
    AsianOption,
    BarrierOption,
    BasketOption,
    ChooserOption,
    Cliquet,
    CompoundOption,
    DigitalOption,
    DoubleBarrierOption,
    FixedStrike,
    ForwardStartOption,
    GeometricAverage,
    KnockIn,
    LookbackOption,
    RainbowOption,
    SpreadOption,
    Up,
    VanillaOption,
    VarianceSwap,
    require_european,
)
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import carry_yield, forward_spot, market_yearfrac
from ..market.rate_curve import df
from ..market.vol_surface import FlatVolSurface, get_vol
from ..utils import device_of, f64, resolve_device

__all__ = [
    "BlackScholesAnalytic",
    "bs_price",
    "bs_digital_price",
    "bs_barrier_price",
    "bs_double_barrier_price",
    "bs_geometric_asian_price",
    "bs_lookback_price",
    "bs_geometry",
]

@dataclasses.dataclass(frozen=True)
class BlackScholesAnalytic(AbstractPricingMethod):
    """Closed-form Black-Scholes for European vanilla options, computed on
    ``device``."""

    device: str = "cuda"


def _ncdf(x: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr(x)


def _npdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _tensors(*xs):
    """``xs`` as float64 tensors on the device of the first one off the CPU."""
    dev = device_of(*xs)
    return tuple(f64(x, device=dev) for x in xs)


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi) for tensor or number bounds."""
    x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    return torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def bs_price(forward, strike, vol, T, discount, cp) -> torch.Tensor:
    """Black formula on the T-forward, branchless:
    price = D·cp·(F·N(cp·d1) − K·N(cp·d2)); σ == 0 or T == 0 gives the
    discounted intrinsic value."""
    dev = device_of(forward, strike, vol, T, discount, cp)
    forward, strike, vol, T, discount, cp = (
        f64(x, device=dev) for x in (forward, strike, vol, T, discount, cp))
    sqrtT = torch.sqrt(T)
    sigma_safe = torch.where(vol > 0, vol, 1.0)
    d1 = (torch.log(forward / strike) + 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    d2 = d1 - sigma_safe * sqrtT
    bs = discount * cp * (forward * _ncdf(cp * d1) - strike * _ncdf(cp * d2))
    intrinsic = discount * torch.clamp(cp * (forward - strike), min=0.0)
    return torch.where((vol > 0) & (T > 0), bs, intrinsic)


def bs_geometry(prob: PricingProblem, device=None):
    """(T, K, σ, D, F, √T, d1, d2) on ``device`` (by default the device of
    the spot and strike): the one place the pricer and the analytic greeks
    read the market, the vol looked up from the surface's own reference
    date as the pricer does."""
    payoff = prob.payoff
    market = prob.market_inputs
    if device is None:
        device = device_of(market.spot, payoff.strike)
    K = f64(payoff.strike, device=device)
    sigma = f64(get_vol(market.sigma, payoff.expiry, payoff.strike), device=device)
    T = f64(market_yearfrac(market, payoff.expiry), device=device)
    D = f64(df(market.rate, payoff.expiry), device=device)
    F = forward_spot(market, T, device=device) / D  # carry-adjusted T-forward
    sqrtT = torch.sqrt(T)
    sigma_safe = torch.where(sigma > 0, sigma, 1.0)
    d1 = (torch.log(F / K) + 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    d2 = d1 - sigma_safe * sqrtT
    return T, K, sigma, D, F, sqrtT, d1, d2


def bs_digital_price(forward, strike, vol, T, discount, cp, cash=1.0) -> torch.Tensor:
    """Cash-or-nothing digital, branchless: D·cash·N(cp·d2); σ == 0 or
    T == 0 gives the discounted indicator."""
    forward, strike, vol, T, discount, cash = _tensors(forward, strike, vol, T, discount, cash)
    sqrtT = torch.sqrt(T)
    sigma_safe = torch.where(vol > 0, vol, 1.0)
    d2 = (torch.log(forward / strike) - 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    bs = discount * cash * _ncdf(cp * d2)
    intrinsic = discount * cash * (cp * (forward - strike) > 0.0).double()
    return torch.where((vol > 0) & (T > 0), bs, intrinsic)


def bs_barrier_price(spot, strike, barrier, vol, T, discount, cp, up: bool, knock_in: bool,
                     rebate=0.0, rebate_at_hit: bool = False, carry=0.0) -> torch.Tensor:
    """Reiner–Rubinstein single barrier with cost of carry b = r − q (the
    flat rate r = −ln(D)/T, ``carry`` the yield q): the knock-in from the
    A/B/C/D blocks, the knock-out by in-out parity; a barrier already
    touched at inception makes the knock-in vanilla and the knock-out
    worthless.  ``rebate``: a knock-in's pays at expiry iff never touched
    (the E block), a knock-out's at the hit time if ``rebate_at_hit`` (the
    F block) else at expiry.  σ == 0 or T == 0: the deterministic path."""
    S, K, H, vol, T, discount, rebate, carry = _tensors(spot, strike, barrier, vol, T, discount,
                                                        rebate, carry)
    r = -torch.log(discount) / torch.clamp(T, min=1e-30)
    b = r - carry  # cost of carry
    qf = torch.exp(-carry * T)  # e^{(b−r)T}: weights every S leg
    sigma_safe = torch.where(vol > 0, vol, 1.0)
    v = sigma_safe * torch.sqrt(T)
    mu = b / sigma_safe**2 - 0.5
    eta = -1.0 if up else 1.0

    def vanilla_block(lnarg):
        x = lnarg / v + (1.0 + mu) * v
        return cp * (S * qf * _ncdf(cp * x) - K * discount * _ncdf(cp * (x - v)))

    hs2mu = (H / S) ** (2.0 * mu)
    hs2mu2 = hs2mu * (H / S) ** 2

    def reflected_block(lnarg):
        y = lnarg / v + (1.0 + mu) * v
        return cp * (hs2mu2 * S * qf * _ncdf(eta * y)
                     - hs2mu * K * discount * _ncdf(eta * (y - v)))

    A = vanilla_block(torch.log(S / K))
    B = vanilla_block(torch.log(S / H))
    C = reflected_block(torch.log(H * H / (S * K)))
    Dd = reflected_block(torch.log(H / S))

    k_ge_h = K >= H
    if cp > 0:  # call
        in_price = (torch.where(k_ge_h, A, B - C + Dd) if up
                    else torch.where(k_ge_h, C, A - B + Dd))
    else:  # put
        in_price = (torch.where(k_ge_h, A - B + Dd, C) if up
                    else torch.where(k_ge_h, B - C + Dd, A))

    vanilla = bs_price(S * qf / discount, K, vol, T, discount, cp)
    touched = (S >= H) if up else (S <= H)
    in_price = torch.where(touched, vanilla, torch.clamp(in_price, min=0.0))
    # clip roundoff: an exactly worthless knock-out can land at −1e-17
    price = in_price if knock_in else torch.clamp(vanilla - in_price, min=0.0)

    # rebate legs per unit rebate: E = D·P(no touch), F = E[e^{−rτ}·1(τ ≤ T)]
    x2 = torch.log(S / H) / v + (1.0 + mu) * v
    y2 = torch.log(H / S) / v + (1.0 + mu) * v
    e_pu = discount * (_ncdf(eta * (x2 - v)) - hs2mu * _ncdf(eta * (y2 - v)))
    e_pu = torch.where(touched, 0.0, _clip(e_pu, 0.0, discount))
    if knock_in:
        price = price + rebate * e_pu
    elif rebate_at_hit:
        lam_h = torch.sqrt(mu * mu + 2.0 * r / sigma_safe**2)
        # double where: beyond the barrier the powers can overflow and would
        # poison the masked gradient
        hsl = torch.where(touched, 1.0, H / S)
        z = torch.log(hsl) / v + lam_h * v
        f_pu = (hsl ** (mu + lam_h) * _ncdf(eta * z)
                + hsl ** (mu - lam_h) * _ncdf(eta * (z - 2.0 * lam_h * v)))
        f_pu = torch.where(touched, 1.0, _clip(f_pu, 0.0, 1.0))
        price = price + rebate * f_pu
    else:
        price = price + rebate * (discount - e_pu)

    # σ == 0 or T == 0: the forward path S·e^{bt} is monotone, so it touches
    # H iff an endpoint is beyond H; the at-hit rebate discounts at the
    # known hit time ln(H/S)/b
    f_T = S * qf / discount
    det_touch = touched | ((f_T >= H) if up else (f_T <= H))
    det_pay = discount * torch.clamp(cp * (f_T - K), min=0.0)
    det_in = torch.where(det_touch, det_pay, 0.0)
    touch_w = det_touch.double()
    if knock_in:
        det = det_in + rebate * discount * (1.0 - touch_w)
    elif rebate_at_hit:
        b_safe = torch.where(torch.abs(b) < 1e-12, 1e-12, b)
        t_hit = _clip(torch.log(H / S) / b_safe, 0.0, T)
        det = (det_pay - det_in) + rebate * torch.exp(-r * t_hit) * touch_w
    else:
        det = (det_pay - det_in) + rebate * discount * touch_w
    return torch.where((vol > 0) & (T > 0), price, det)


def bs_geometric_asian_price(spot, strike, vol, T, discount, cp, n: int,
                             carry=0.0) -> torch.Tensor:
    """Discrete geometric-average Asian on fixings t_i = i·T/n: log A_G is
    Gaussian with mean ln S + (b − σ²/2)·T(n+1)/(2n) and variance
    σ²·T·(n+1)(2n+1)/(6n²), so the price is the Black formula at forward
    e^{m+s²/2} with total volatility s."""
    spot, strike, vol, T, discount, carry = _tensors(spot, strike, vol, T, discount, carry)
    r = -torch.log(discount) / torch.clamp(T, min=1e-30)
    m = torch.log(spot) + (r - carry - 0.5 * vol**2) * T * (n + 1) / (2.0 * n)
    s2 = vol**2 * T * (n + 1) * (2 * n + 1) / (6.0 * n * n)
    f_geo = torch.exp(m + 0.5 * s2)
    # only vol·√T enters the Black formula: pass (vol = s, T = 1)
    return bs_price(f_geo, strike, torch.sqrt(s2), 1.0, discount, cp)


def bs_double_barrier_price(spot, strike, lower, upper, vol, T, discount, cp,
                            knock_in: bool, rebate=0.0, rebate_at_hit: bool = False,
                            carry=0.0, n_images: int = 5) -> torch.Tensor:
    """Continuously monitored double barrier from the reflection image
    series with cost of carry b = r − q: with X = ln(S_T/S), α = (b −
    σ²/2)/σ², l = ln(L/S) < 0 < u = ln(U/S), c = u − l, the no-exit density
    is e^{αx − α²s²/2}·Σ_n [φ_s(x − 2nc) − φ_s(x − (2l − 2nc))], so the
    knock-out is a signed sum of lognormal partial expectations, each in log
    space (exp(exponent + log Φ)).  Knock-in by in-out parity; ``rebate``
    pays at expiry (the double one-touch, ``rebate_at_hit``, has no closed
    form here and raises).  A spot outside (L, U) makes the knock-out pure
    rebate and the knock-in vanilla."""
    if rebate_at_hit:
        raise TypeError(
            "the double one-touch (rebate_at_hit) has no closed form here; "
            "price it by the bridge MC estimator"
        )
    S, K, lower, upper, vol, T, discount, rebate, carry = _tensors(
        spot, strike, lower, upper, vol, T, discount, rebate, carry)
    log_ndtr = torch.special.log_ndtr
    r = -torch.log(discount) / torch.clamp(T, min=1e-30)
    b = r - carry
    qf = torch.exp(-carry * T)
    sig = torch.where(vol > 0, vol, 1.0)
    s = sig * torch.sqrt(T)
    s2 = sig**2 * T
    inside0 = (S > lower) & (S < upper)
    # a corridor safe on the dead branch keeps the series' masked gradients finite
    l = torch.log(torch.where(inside0, lower, 0.5 * S) / S)  # noqa: E741
    u = torch.log(torch.where(inside0, upper, 2.0 * S) / S)
    c = u - l
    alpha = (b - 0.5 * sig**2) / sig**2
    k = torch.log(K / S)
    call = cp > 0
    A = _clip(k, l, u) if call else l
    B = u if call else _clip(k, l, u)
    base = -0.5 * alpha**2 * s2

    def series(gamma, lo, hi):
        tot = 0.0
        for n in range(-n_images, n_images + 1):
            for m, sgn in ((2.0 * n * c, 1.0), (2.0 * l - 2.0 * n * c, -1.0)):
                e0 = base + gamma * m + 0.5 * gamma**2 * s2
                z_hi = (hi - m) / s - gamma * s
                z_lo = (lo - m) / s - gamma * s
                tot = tot + sgn * (torch.exp(e0 + log_ndtr(z_hi)) - torch.exp(e0 + log_ndtr(z_lo)))
        return tot

    ko = discount * cp * (S * series(alpha + 1.0, A, B) - K * series(alpha, A, B))
    p_stay = _clip(series(alpha, l, u), 0.0, 1.0)
    vanilla = bs_price(S * qf / discount, K, vol, T, discount, cp)
    if knock_in:
        price = (vanilla - ko) + rebate * discount * p_stay
        price = torch.where(inside0, price, vanilla)
    else:
        price = ko + rebate * discount * (1.0 - p_stay)
        price = torch.where(inside0, price, rebate * discount)
    # σ → 0 or T → 0: the deterministic path S·e^{bt} has its extremes at
    # the endpoints
    s_det = S * torch.exp(b * T)
    touched = (torch.maximum(S, s_det) >= upper) | (torch.minimum(S, s_det) <= lower)
    intrinsic = discount * torch.clamp(cp * (s_det - K), min=0.0)
    w_t = touched.double()
    if knock_in:
        det = intrinsic * w_t + rebate * discount * (1.0 - w_t)
    else:
        det = intrinsic * (1.0 - w_t) + rebate * discount * w_t
    return torch.where((vol > 0) & (T > 0), price, det)


def bs_lookback_price(spot, strike, extremum, vol, T, discount, cp, fixed: bool,
                      carry=0.0) -> torch.Tensor:
    """Continuously monitored lookbacks with cost of carry b = r − q
    (Goldman–Sosin–Gatto floating strike, Conze–Viswanathan fixed strike).
    With x the reflection level, d1 = (ln(S/x) + (b + σ²/2)T)/(σ√T),
    β = 2b/σ², D = e^{−rT}, E = e^{−qT}:

        A(x) = (σ²/2b)·[(S/x)^{−β}·Φ(−d1+2b√T/σ) − e^{bT}·Φ(−d1)]
        C(x) = (σ²/2b)·[e^{bT}·Φ(d1) − (S/x)^{−β}·Φ(d1−2b√T/σ)]
        floating call (x = m):       S·E·Φ(d1) − m·D·Φ(d2) + S·D·A(m)
        floating put  (x = M):       M·D·Φ(−d2) − S·E·Φ(−d1) + S·D·C(M)
        fixed call (x = max(K, M)):  D·(M−K)⁺ + S·E·Φ(d1) − x·D·Φ(d2) + S·D·C(x)
        fixed put  (x = min(K, m)):  D·(K−m)⁺ + x·D·Φ(−d2) − S·E·Φ(−d1) + S·D·A(x)

    with the exact b → 0 limits A₀ = σ√T·φ(d1) − (ln(S/x) + σ²T/2)·Φ(−d1),
    C₀ = σ√T·φ(d1) + (ln(S/x) + σ²T/2)·Φ(d1) behind a double where.
    ``extremum`` is the running max (fixed call, floating put) or min,
    clamped against the spot by the caller."""
    S, K, m, vol, T, discount, carry = _tensors(spot, strike, extremum, vol, T, discount, carry)
    log_ndtr = torch.special.log_ndtr
    r = -torch.log(discount) / torch.clamp(T, min=1e-30)
    b = r - carry
    E = torch.exp(-carry * T)
    sqrtT = torch.sqrt(T)
    sig = torch.where(vol > 0, vol, 1.0)
    v = sig * sqrtT
    call = cp > 0
    if fixed:
        x = torch.maximum(K, m) if call else torch.minimum(K, m)
        head = discount * torch.clamp(cp * (m - K), min=0.0)
    else:
        x = m
        head = 0.0
    d1 = (torch.log(S / x) + (b + 0.5 * sig**2) * T) / v
    d2 = d1 - v
    small = torch.abs(b) * T < 1e-7
    b_safe = torch.where(small, 1.0, b)
    beta = 2.0 * b_safe / sig**2
    shift = 2.0 * b_safe * sqrtT / sig
    lnSx = torch.log(S / x)
    half = 0.5 * sig**2 * T
    # (S/x)^{−β}·Φ(y) in log space: the power can overflow long before the
    # Φ tail underflows; the exponent is zeroed on the small-b branch
    expo = torch.where(small, 0.0, -beta * lnSx)
    if call == fixed:  # fixed call / floating put: C(x)
        gen = (sig**2 / (2.0 * b_safe)) * (
            torch.exp(b_safe * T) * _ncdf(d1) - torch.exp(expo + log_ndtr(d1 - shift)))
        lim = v * _npdf(d1) + (lnSx + half) * _ncdf(d1)
    else:  # floating call / fixed put: A(x)
        gen = (sig**2 / (2.0 * b_safe)) * (
            torch.exp(expo + log_ndtr(-d1 + shift)) - torch.exp(b_safe * T) * _ncdf(-d1))
        lim = v * _npdf(d1) - (lnSx + half) * _ncdf(-d1)
    strange = S * discount * torch.where(small, lim, gen)
    level = x if fixed else m
    body = cp * (S * E * _ncdf(cp * d1) - level * discount * _ncdf(cp * d2))
    price = head + body + strange
    # σ → 0 or T → 0: the deterministic path S·e^{bt}; its extremum joins
    # the running one
    s_det = S * torch.exp(b * T)
    if call == fixed:
        run_det = torch.maximum(m, torch.maximum(S, s_det))
    else:
        run_det = torch.minimum(m, torch.minimum(S, s_det))
    if fixed:
        det = discount * torch.clamp(cp * (run_det - K), min=0.0)
    else:
        det = discount * cp * (s_det - run_det)
    return torch.where((vol > 0) & (T > 0), price, det)


def _flat_sigma(market, what: str):
    if not isinstance(market.sigma, FlatVolSurface):
        raise TypeError(what)
    return market.sigma.sigma


def _solve_bs_two_date(prob: PricingProblem, method, device) -> AnalyticSolution:
    """Compound options (Geske 1979, the four variants through the bivariate
    normal with ρ = √(t₁/T₂) and the critical spot from an IFT-differentiable
    root) and simple choosers (the call plus a put on the t₁-forward, by
    parity at the choose date), under a flat vol."""
    from ..math.bvn import bvn_cdf
    from ..math.rootfind import implicit_root

    payoff = prob.payoff
    market = prob.market_inputs
    sigma = f64(_flat_sigma(market, (
        "compound/chooser closed forms need a flat vol (one σ spans "
        "both decision and expiry horizons); price surfaces by MC")), device=device)
    q = f64(carry_yield(market), device=device)
    is_compound = isinstance(payoff, CompoundOption)
    t1_ticks = payoff.decision_date if is_compound else payoff.choose_date
    t1 = f64(market_yearfrac(market, t1_ticks), device=device)
    T2 = f64(market_yearfrac(market, payoff.expiry), device=device)
    D1 = f64(df(market.rate, t1_ticks), device=device)
    D2 = f64(df(market.rate, payoff.expiry), device=device)
    D12 = D2 / D1
    spot = f64(market.spot, device=device)

    if not is_compound:
        # chooser = call(K, T₂) + put on S_{t₁}e^{−q(T₂−t₁)} struck at
        # K·D(t₁, T₂), expiring at t₁
        strike = f64(payoff.strike, device=device)
        leg1 = bs_price(spot * torch.exp(-q * T2) / D2, strike, sigma, T2, D2, 1.0)
        leg2 = bs_price(spot * torch.exp(-q * T2) / D1, strike * D12, sigma, t1, D1, -1.0)
        return AnalyticSolution(prob, method, leg1 + leg2)

    w1, w2 = payoff.call_put(), payoff.inner_call_put()
    K1, K2 = f64(payoff.strike, device=device), f64(payoff.inner_strike, device=device)
    tau = T2 - t1

    def inner_value(log_s):
        s = torch.exp(log_s)
        return bs_price(s * torch.exp(-q * tau) / D12, K2, sigma, tau, D12, w2)

    # Geske critical spot: inner(S*) = K₁, bisected in log-spot
    log_k2 = torch.log(K2)
    s_star = torch.exp(implicit_root(lambda x: inner_value(x) - K1,
                                     log_k2.detach() - 20.0, log_k2.detach() + 20.0))
    sq1, sq2 = sigma * torch.sqrt(t1), sigma * torch.sqrt(T2)
    a1 = (torch.log(spot * torch.exp(-q * t1) / (D1 * s_star)) + 0.5 * sigma**2 * t1) / sq1
    a2 = a1 - sq1
    b1 = (torch.log(spot * torch.exp(-q * T2) / (D2 * K2)) + 0.5 * sigma**2 * T2) / sq2
    b2 = b1 - sq2
    rho = torch.sqrt(t1 / T2)
    s12 = w1 * w2
    price = s12 * (
        spot * torch.exp(-q * T2) * bvn_cdf(s12 * a1, w2 * b1, w1 * rho)
        - K2 * D2 * bvn_cdf(s12 * a2, w2 * b2, w1 * rho)
    ) - w1 * K1 * D1 * _ncdf(s12 * a2)
    return AnalyticSolution(prob, method, price)


def _solve_bs_cliquet(prob, method, device) -> AnalyticSolution:
    """Each period's clipped return f + (R − (1+f))⁺ − (R − (1+c))⁺ is a
    bull spread on the forward return over τ = T/n; the periods are iid
    under flat-vol Black-Scholes, so the sum is n times one period,
    discounted once at expiry."""
    payoff, market = prob.payoff, prob.market_inputs
    sig = f64(_flat_sigma(market, (
        "the cliquet closed form needs a flat vol (the forward smile is "
        "model-dependent); price surfaces by MC under LocalVolDynamics/HestonDynamics")),
        device=device)
    T = f64(market_yearfrac(market, payoff.expiry), device=device)
    D = f64(df(market.rate, payoff.expiry), device=device)
    floor, cap, notional, q = (f64(x, device=device) for x in (
        payoff.local_floor, payoff.local_cap, payoff.notional, carry_yield(market)))
    n_per = payoff.observations
    tau = T / n_per
    d_per = D ** (1.0 / n_per)  # the per-period discount (flat rate, exact)
    f_per = torch.exp(-q * tau) / d_per  # E[R] = e^{(r−q)τ}
    call_f = bs_price(f_per, 1.0 + floor, sig, tau, 1.0, 1.0)
    call_c = bs_price(f_per, 1.0 + cap, sig, tau, 1.0, 1.0)
    price = D * notional * n_per * (floor + call_f - call_c)
    return AnalyticSolution(prob, method, price)


def _solve_bs_forward_start(prob, method, device) -> AnalyticSolution:
    """Rubinstein (1991): S_{t1}-homogeneity and the independent lognormal
    forward return give V = S0·e^{−q·t1}·Black(F = e^{(r−q)τ}, k, σ, τ)·D(t1, T),
    τ = T − t1, under a flat vol."""
    payoff, market = prob.payoff, prob.market_inputs
    sig = f64(_flat_sigma(market, (
        "forward-start closed form needs a flat vol (the forward smile is "
        "model-dependent); price surfaces by MC under LocalVolDynamics/HestonDynamics")),
        device=device)
    t1 = f64(yearfrac(market.reference_date, payoff.start, getattr(market, "daycount", None)),
             device=device)
    T = f64(market_yearfrac(market, payoff.expiry), device=device)
    tau = T - t1
    d_fwd = (f64(df(market.rate, payoff.expiry), device=device)
             / f64(df(market.rate, payoff.start), device=device))  # D(t1, T)
    q = f64(carry_yield(market), device=device)
    unit = bs_price(torch.exp(-q * tau) / d_fwd, f64(payoff.strike_fraction, device=device),
                    sig, tau, d_fwd, payoff.call_put())
    price = f64(market.spot, device=device) * torch.exp(-q * t1) * unit
    return AnalyticSolution(prob, method, price)


def _solve_bs_variance_swap(prob, method, device) -> AnalyticSolution:
    """The discrete fair strike under GBM, exact: each log return is
    N(μ·dt, σ²·dt) with μ = r − q − σ²/2, so E[RV] = σ² + μ²·T/n."""
    payoff, market = prob.payoff, prob.market_inputs
    sig = f64(_flat_sigma(market, (
        "variance swaps on a non-flat surface have no single-σ closed form "
        "here; use MonteCarlo(LocalVolDynamics(), EulerMaruyama(), cfg) to "
        "price off the smile")), device=device)
    T = f64(market_yearfrac(market, payoff.expiry), device=device)
    D = f64(df(market.rate, payoff.expiry), device=device)
    r = -torch.log(D) / torch.clamp(T, min=1e-30)
    mu = r - f64(carry_yield(market), device=device) - 0.5 * sig**2
    fair = sig**2 + mu**2 * T / payoff.observations
    price = D * f64(payoff.notional, device=device) * (
        fair - f64(payoff.strike_var, device=device))
    return AnalyticSolution(prob, method, price)


@register_solver(BlackScholesAnalytic)
def _solve_bs_analytic(prob: PricingProblem, method: BlackScholesAnalytic) -> AnalyticSolution:
    payoff = prob.payoff
    market = prob.market_inputs
    require_european(payoff, "BlackScholesAnalytic")
    if getattr(market, "dividends", None) is not None and not isinstance(
            payoff, (VanillaOption, DigitalOption)):
        raise TypeError(
            f"discrete cash dividends reach the closed forms through the "
            f"escrowed terminal law, which is exact for vanillas/digitals "
            f"only; price {type(payoff).__name__} on the PDE or grid-MC "
            f"engines (spot model) instead"
        )
    if isinstance(payoff, (SpreadOption, BasketOption, RainbowOption)):
        from .multi_asset import solve_multi_asset_analytic

        return solve_multi_asset_analytic(prob, method)
    device = resolve_device(method.device)
    if isinstance(payoff, (CompoundOption, ChooserOption)):
        return _solve_bs_two_date(prob, method, device)
    if isinstance(payoff, Cliquet):
        return _solve_bs_cliquet(prob, method, device)
    if isinstance(payoff, ForwardStartOption):
        return _solve_bs_forward_start(prob, method, device)
    if isinstance(payoff, VarianceSwap):
        return _solve_bs_variance_swap(prob, method, device)
    if not isinstance(payoff, (VanillaOption, DigitalOption, AsianOption, BarrierOption,
                               DoubleBarrierOption, LookbackOption)):
        raise TypeError(f"BlackScholesAnalytic has no closed form for {type(payoff).__name__}")

    T, K, sigma, D, F, _, _, _ = bs_geometry(prob, device)
    cp = payoff.call_put()
    spot = f64(market.spot, device=device)
    carry = f64(carry_yield(market), device=device)
    if isinstance(payoff, AsianOption):
        if not isinstance(payoff.averaging, GeometricAverage):
            raise TypeError(
                "the arithmetic average has no lognormal closed form; "
                "arithmetic Asians price by grid Monte Carlo "
                "(MonteCarlo with config.steps == observations)"
            )
        price = bs_geometric_asian_price(spot, K, sigma, T, D, cp, payoff.observations,
                                         carry=carry)
    elif isinstance(payoff, BarrierOption):
        price = bs_barrier_price(
            spot, K, f64(payoff.barrier, device=device), sigma, T, D, cp,
            up=isinstance(payoff.direction, Up), knock_in=isinstance(payoff.knock, KnockIn),
            rebate=f64(payoff.rebate, device=device), rebate_at_hit=payoff.rebate_at_hit,
            carry=carry)
    elif isinstance(payoff, DoubleBarrierOption):
        price = bs_double_barrier_price(
            spot, K, f64(payoff.lower, device=device), f64(payoff.upper, device=device), sigma,
            T, D, cp, knock_in=isinstance(payoff.knock, KnockIn),
            rebate=f64(payoff.rebate, device=device), rebate_at_hit=payoff.rebate_at_hit,
            carry=carry)
    elif isinstance(payoff, DigitalOption):
        price = bs_digital_price(F, K, sigma, T, D, cp, f64(payoff.cash, device=device))
    elif isinstance(payoff, LookbackOption):
        sig = f64(_flat_sigma(market, (
            "the lookback closed form needs a flat vol (the extremum law is "
            "whole-path, not one-strike); price surfaces by MC under "
            "LocalVolDynamics/HestonDynamics")), device=device)
        run = spot if payoff.running_extremum is None else f64(payoff.running_extremum,
                                                               device=device)
        ext = torch.maximum(run, spot) if payoff.uses_maximum else torch.minimum(run, spot)
        price = bs_lookback_price(spot, K, ext, sig, T, D, cp,
                                  fixed=isinstance(payoff.strike_style, FixedStrike),
                                  carry=carry)
    else:
        price = bs_price(F, K, sigma, T, D, cp)
    return AnalyticSolution(prob, method, price)
