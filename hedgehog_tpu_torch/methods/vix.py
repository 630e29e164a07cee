"""VIX futures and options under Heston and Bates.

Port of ``hedgehog_tpu/methods/vix.py``.  Under Heston the 30-day forward
variance at T is affine in the instantaneous variance,

    VIX_T² = a·V_T + b,   a = (1 − e^{−κτ})/(κτ),   b = θ·(1 − a),

and under Bates the jumps of S add 2λ(e^{μ_J+σ_J²/2} − 1 − μ_J) to b (the
log-contract strip's convexity term).  V_T given V₀ is a scaled noncentral
χ²: V_T = c̄·χ'²(d, λ), c̄ = σ²(1−e^{−κT})/(4κ), d = 4κθ/σ²,
λ = V₀e^{−κT}/c̄.  Every VIX payoff is a 1-D integral against that law, taken
in the survival form (no density, no v → 0 singularity when d < 2):

    E[(√(aV+b) − K)⁺] = (√(a·v_K+b) − K)·S(v_K)
                        + (a/2)·∫_{v_K}^{v_hi} S(v)/√(av+b) dv,

S = 1 − F of the ncx2 law (methods/cev.py::ncx2_cdf), v_K = max((K² − b)/a,
0), by fixed Gauss–Legendre nodes over the transition window (the flat
stretch below it in closed form).  The future is the K = 0 case; puts by
parity, E[(K − X)⁺] = E[(X − K)⁺] + K − E[X].  ``ncx2_cdf`` is
differentiable in the shape d, but as in the JAX package the survival is
linearised in d around a detached point with a central-difference slope, so
the greeks in the five Heston parameters equal JAX's.  Every function
computes on ``device``, else on the device of the market's tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..core.dates import to_ticks
from ..core.payoffs import Call, CallPut, European, ExerciseStyle
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import BatesInputs, HestonInputs, market_yearfrac
from ..market.rate_curve import df
from ..utils import device_of, f64, resolve_device
from .cev import ncx2_cdf

__all__ = [
    "VIXFuture",
    "VIXOption",
    "VIXAnalytic",
    "vix_params",
    "vix_future_price",
    "vix_option_price",
]

_frozen = dataclasses.dataclass(frozen=True)

#: CBOE convention: a 30-day window, ACT/365
_TAU_30D = 30.0 / 365.0


@_frozen
class VIXFuture:
    """A VIX future settling at ``expiry`` on the ``tau``-window forward
    volatility, quoted as ``scale``·√(a·V_T + b) (scale 100: vol points);
    ``solve`` returns the undiscounted futures price."""

    expiry: Any
    tau: Any = _TAU_30D
    scale: Any = 100.0

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))


@_frozen
class VIXOption:
    """A European option on the VIX at ``expiry``, ``strike`` in the index's
    ``scale`` units (vol points)."""

    strike: Any
    expiry: Any
    exercise_style: ExerciseStyle = European()
    call_put: CallPut = Call()
    tau: Any = _TAU_30D
    scale: Any = 100.0

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))


@_frozen
class VIXAnalytic(AbstractPricingMethod):
    """The survival-form quadrature over the exact CIR transition law, on
    ``device``: ``nodes`` Gauss–Legendre points over [v_K, mean +
    ``width``·std]; ``terms`` sizes the ncx2 series window."""

    nodes: int = 128
    width: float = 30.0
    terms: int = 2048
    device: str = "cuda"


def _market_device(market):
    return device_of(market.V0, market.kappa, market.theta, market.sigma)


def vix_params(market, T, tau, device=None):
    """(a, b, c̄, d, λ) of the affine VIX² map and the V_T transition law;
    a Bates market folds its jump convexity 2λ(e^{μ+σ²/2} − 1 − μ) into b."""
    dev = _market_device(market) if device is None else device
    kappa, theta, sigma, v0, T, tau = (f64(x, device=dev) for x in (
        market.kappa, market.theta, market.sigma, market.V0, T, tau))
    a = -torch.expm1(-kappa * tau) / (kappa * tau)
    b = theta * (1.0 - a)
    lam_j = getattr(market, "jump_intensity", None)
    if lam_j is not None:
        mu_j, s_j = f64(market.jump_mean, device=dev), f64(market.jump_std, device=dev)
        kbar = torch.expm1(mu_j + 0.5 * s_j**2)
        b = b + 2.0 * f64(lam_j, device=dev) * (kbar - mu_j)
    c_bar = sigma**2 * -torch.expm1(-kappa * T) / (4.0 * kappa)
    d = 4.0 * kappa * theta / sigma**2
    lam = v0 * torch.exp(-kappa * T) / c_bar
    return a, b, c_bar, d, lam


def _gauss_legendre(n: int, lo: torch.Tensor, hi: torch.Tensor):
    """(nodes, weights) of the n-point Gauss–Legendre rule on [lo, hi]."""
    x, w = np.polynomial.legendre.leggauss(n)
    half = 0.5 * (hi - lo)
    return lo + half * (f64(x, device=lo.device) + 1.0), half * f64(w, device=lo.device)


def _ncx2_survival(x, d, lam, terms: int) -> torch.Tensor:
    """1 − F of χ'²(d, λ) for every λ: the fixed-trip series while its
    mode-centred window covers λ (λ ≲ 2(terms/14)²), a one-term Edgeworth
    (skew-corrected normal) tail beyond, whose λ → ∞ (σ_v → 0) limit is
    exact.  Both branches stay finite (the series' λ is clipped), so the
    select is safe under autograd.  The series is linearised in d around a
    detached point with a central-difference slope, as the JAX package's is
    (its gammainc has no shape derivative)."""
    lam_max = 1.96 * (terms / 14.0) ** 2  # just inside the series window
    lam_safe = torch.clamp(lam, max=lam_max)
    d_sg = d.detach()
    h = 1e-4 * (1.0 + d_sg)
    s_mid = 1.0 - ncx2_cdf(x, d_sg, lam_safe, terms=terms)
    with torch.no_grad():
        slope = (ncx2_cdf(x, d_sg - h, lam_safe, terms=terms)
                 - ncx2_cdf(x, d_sg + h, lam_safe, terms=terms)) / (2.0 * h)
    series = s_mid + slope * (d - d_sg)
    mu = d + lam
    sig = torch.sqrt(2.0 * (d + 2.0 * lam))
    z = (x - mu) / sig
    gamma1 = 8.0 * (d + 3.0 * lam) / (2.0 * (d + 2.0 * lam)) ** 1.5
    phi = torch.exp(-0.5 * z**2) / math.sqrt(2.0 * math.pi)
    edge = torch.clamp((1.0 - torch.special.ndtr(z)) + gamma1 / 6.0 * (z**2 - 1.0) * phi,
                       0.0, 1.0)
    return torch.where(lam > lam_max, edge, series)


def _expected_vix_excess(market, T, tau, k_tilde, nodes, width, terms, device):
    """E[(√(a·V_T + b) − k̃)⁺] by the survival-form quadrature (k̃ = 0 gives
    E[√(a·V_T + b)])."""
    a, b, c_bar, d, lam = vix_params(market, T, tau, device)
    k_tilde = f64(k_tilde, device=device)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    mean_v = c_bar * (d + lam)
    std_v = c_bar * torch.sqrt(2.0 * (d + 2.0 * lam))
    v_k = torch.maximum((k_tilde**2 - b) / a, zero)
    v_hi = torch.maximum(mean_v + width * std_v, v_k * (1.0 + 1e-6) + 1e-12)
    # below mean − width·std the survival is 1 to ~e^{−width²/2}: that flat
    # stretch integrates in closed form and every node goes to the window
    v_lo = torch.minimum(torch.maximum(mean_v - width * std_v, v_k), v_hi)
    flat = torch.sqrt(a * v_lo + b) - torch.sqrt(a * v_k + b)
    x, w = _gauss_legendre(nodes, v_lo, v_hi)
    surv = _ncx2_survival(x / c_bar, d, lam, terms)
    integral = torch.sum(w * surv / torch.sqrt(a * x + b), dim=-1) * (a / 2.0)
    s0 = _ncx2_survival(v_k / c_bar, d, lam, terms)
    boundary = (torch.sqrt(a * v_k + b) - k_tilde) * s0
    return boundary + flat + integral


def vix_future_price(market, T, tau=_TAU_30D, scale=100.0, *, nodes=128, width=30.0,
                     terms=2048, device=None) -> torch.Tensor:
    """Futures price scale·E[√(a·V_T + b)] (undiscounted, as quoted)."""
    dev = _market_device(market) if device is None else device
    return f64(scale, device=dev) * _expected_vix_excess(market, T, tau, 0.0, nodes, width,
                                                         terms, dev)


def vix_option_price(market, T, strike, cp=1.0, tau=_TAU_30D, scale=100.0, *, nodes=128,
                     width=30.0, terms=2048, device=None) -> torch.Tensor:
    """Undiscounted E[(cp·(VIX_T − K))⁺]; puts by parity.  A number ``cp``
    (the solver's case) skips the futures quadrature for calls."""
    dev = _market_device(market) if device is None else device
    strike, scale = f64(strike, device=dev), f64(scale, device=dev)
    call = scale * _expected_vix_excess(market, T, tau, strike / scale, nodes, width, terms,
                                        dev)
    kw = dict(nodes=nodes, width=width, terms=terms, device=dev)
    if isinstance(cp, (bool, int, float)):
        if cp > 0:
            return call
        return call + strike - vix_future_price(market, T, tau, scale, **kw)
    fut = vix_future_price(market, T, tau, scale, **kw)
    return torch.where(f64(cp, device=dev) > 0, call, call + strike - fut)


@register_solver(VIXAnalytic)
def _solve_vix(prob: PricingProblem, method: VIXAnalytic) -> AnalyticSolution:
    """VIX derivatives on a Heston or Bates market (only the variance block
    enters): futures quoted undiscounted, options discounted on the curve."""
    payoff, market = prob.payoff, prob.market_inputs
    # an explicit whitelist: SLVInputs carries a (κ, θ, σ, V0) block too, but
    # its VIX is E[L²V] under a mixing-scaled vol of vol, not affine in V
    if not isinstance(market, (HestonInputs, BatesInputs)):
        raise TypeError(
            f"VIXAnalytic needs a CIR variance block with pure Heston/Bates "
            f"dynamics (HestonInputs/BatesInputs); got "
            f"{type(market).__name__}"
        )
    device = resolve_device(method.device)
    T = market_yearfrac(market, payoff.expiry)
    kw = dict(nodes=method.nodes, width=method.width, terms=method.terms, device=device)
    if isinstance(payoff, VIXFuture):
        return AnalyticSolution(prob, method, vix_future_price(market, T, payoff.tau,
                                                               payoff.scale, **kw))
    if isinstance(payoff, VIXOption):
        if not isinstance(payoff.exercise_style, European):
            raise TypeError("VIX options are European-exercise only")
        undisc = vix_option_price(market, T, payoff.strike, payoff.call_put(), payoff.tau,
                                  payoff.scale, **kw)
        return AnalyticSolution(prob, method, df(market.rate, payoff.expiry).to(device) * undisc)
    raise TypeError(
        f"VIXAnalytic prices VIXFuture/VIXOption payoffs, got "
        f"{type(payoff).__name__}"
    )
