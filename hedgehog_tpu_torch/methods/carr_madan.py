"""Carr–Madan Fourier pricing over the CF of log S_T — the port's oracle.

Port of ``hedgehog_tpu/methods/carr_madan.py`` (reference
src/pricing_methods/carr_madan.jl) with the two-scale panel quadrature and
the CF-decay-aware ``bound="auto"``, evaluated in native complex128:

    integrand(v) = e^{-α·logK}/(2π) · ψ(v) · e^{-i·v·logK}
    ψ(v)         = D(T)·φ(v − (α+1)i) / (α² + α − v² + i·v·(2α+1))

The call price is the real part of ∫_{-bound}^{bound}; puts follow by
parity.  Cash-or-nothing digitals invert the CF by Gil-Pelaez on the same
nodes (``_solve_carr_madan_digital``); the path-dependent payoffs raise.
The panel rule (``quadrature="panel"``) spends ``nodes`` Gauss–Legendre
points on the central peak [−c, c] and max(32, nodes//2) log-substituted
points on each tail, so its accuracy does not depend on the bound;
``quadrature="gl"`` is the single Gauss–Legendre rule over (−bound, bound)
of the reference's fixed truncation.  ``carr_madan_fft_smile`` prices a
whole smile in one complex128 FFT (Carr–Madan 1999 §3) and
``carr_madan_error_estimate`` reports a configuration's resolution and
truncation errors.  ``CarrMadan.device`` names where the nodes, the
strikes, the market scalars and the price live: the GPU unless the caller
asks for the CPU.  ``engine`` is "auto" or "complex", what the port always
computes; the JAX package's split real/imaginary "pair" engine exists for
the TPU, which has no complex128, and is refused.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from ..core.payoffs import (
    AsianOption,
    BarrierOption,
    DigitalOption,
    DoubleBarrierOption,
    LookbackOption,
    VanillaOption,
    parity_transform,
    require_european,
)
from ..core.problems import CarrMadanSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import forward_spot, market_yearfrac
from ..market.rate_curve import df
from ..market.vol_surface import get_vol
from ..models.dynamics import (
    BatesDynamics,
    HestonDynamics,
    KouJumpDynamics,
    LognormalDynamics,
    MertonJumpDynamics,
    VarianceGammaDynamics,
    terminal_log_cf,
)
from ..utils import f64, resolve_device

__all__ = ["CarrMadan", "carr_madan_error_estimate", "carr_madan_fft_smile"]


@dataclasses.dataclass(frozen=True)
class CarrMadan(AbstractPricingMethod):
    """Carr–Madan method: damping ``alpha``, integration ``bound`` (a float,
    or "auto" for the CF-decay-aware bound of :func:`_auto_bound`), model
    ``dynamics``, ``nodes`` Gauss–Legendre points, the ``quadrature``
    ("panel": the two-scale rule; "gl": one rule over (−bound, bound),
    which needs a fixed bound), computed on ``device`` in complex128
    (``engine`` "auto" or "complex"; "pair" raises TypeError)."""

    alpha: float = 1.0
    bound: Any = "auto"
    dynamics: Any = LognormalDynamics()
    nodes: int = 256
    engine: str = "auto"
    quadrature: str = "panel"
    device: str = "cuda"

    def __post_init__(self):
        if self.engine == "pair":
            raise TypeError(
                "CarrMadan(engine='pair') is the JAX package's split real/imaginary "
                "CF arithmetic for the TPU, which has no complex128; the port always "
                "evaluates in native complex128 (use engine='auto' or 'complex')"
            )


@functools.lru_cache(maxsize=None)
def _gauss_legendre(n: int):
    """The n-point Gauss–Legendre rule on [−1, 1] (read-only arrays): an
    n × n eigenproblem on the host, tens of ms at n = 256, so it is solved
    once per n rather than once per price."""
    nodes, weights = np.polynomial.legendre.leggauss(n)
    nodes.flags.writeable = weights.flags.writeable = False
    return nodes, weights


def _panel_nodes(bound, n: int, device):
    """n-point GL on [−c, c] plus max(32, n//2) log-substituted GL points on
    each tail [±c, ±bound], with c = min(8, bound/4)."""
    bound = f64(bound, device=device)
    c = torch.clamp(0.25 * bound, max=8.0)
    xc, wc = (f64(a.copy(), device=device) for a in _gauss_legendre(n))
    xt, wt = (f64(a.copy(), device=device) for a in _gauss_legendre(max(32, n // 2)))
    L = torch.log(bound / c)
    t = 0.5 * L * (xt + 1.0)
    v_t = c * torch.exp(t)
    w_t = 0.5 * L * wt * v_t  # dv = v dt
    return torch.cat([xc * c, v_t, -v_t]), torch.cat([wc * c, w_t, w_t])


def _gl_nodes(bound, n: int, device):
    """The n-point Gauss–Legendre rule scaled to (−bound, bound)."""
    x, w = (f64(a.copy(), device=device) for a in _gauss_legendre(n))
    bound = f64(bound, device=device)
    return x * bound, w * bound


def _auto_bound(prob: PricingProblem, dynamics, device) -> torch.Tensor:
    """CF-decay-aware truncation 16/(σ_eff·√T), floored at 64, a scalar
    (a strike grid on a vol surface takes its smallest σ): σ_eff²T is the
    lognormal total variance, Heston's mean integrated variance (plus the
    jump envelope λT(μ_J² + σ_J²) under Bates, with both the linear tail
    envelope 34/c_lin, capped at 1e7), Merton's σ²T + λT(μ_J² + σ_J²) or
    Kou's σ²T + λT·E[J²]; the variance-gamma CF decays polynomially, so its
    bound is where the envelope reaches 1e-12, √(2/(σ²ν))·(1e-12)^{−ν/(2T)}
    in [64, 1e7] (carr_madan.py:172-241)."""
    market = prob.market_inputs
    T = f64(market_yearfrac(market, prob.payoff.expiry), device=device)

    def field(name):
        return f64(getattr(market, name), device=device)

    if isinstance(dynamics, LognormalDynamics):
        sigma = f64(get_vol(market.sigma, prob.payoff.expiry, prob.payoff.strike), device=device)
        s2 = sigma**2 * T
    elif isinstance(dynamics, (HestonDynamics, BatesDynamics)):
        V0, kappa, theta, sigma, rho = (field(n) for n in ("V0", "kappa", "theta", "sigma", "rho"))
        s2 = theta * T + (V0 - theta) * (1.0 - torch.exp(-kappa * T)) / kappa
        if isinstance(dynamics, BatesDynamics):
            s2 = s2 + field("jump_intensity") * (field("jump_mean")**2 + field("jump_std")**2) * T
        # the Heston CF tail decays linearly in |u| at the rate
        # √(1−ρ²)(V0 + κθT)/σ: u* = 34/c_lin puts it below ~2e-15
        c_lin = torch.sqrt(torch.clamp(1.0 - rho**2, min=2.5e-3)) * (V0 + kappa * theta * T) / sigma
        u_lin = 34.0 / torch.clamp(c_lin, min=1e-8)
        s = torch.sqrt(torch.clamp(torch.min(s2), min=1e-16))
        return torch.clamp(torch.maximum(16.0 / s, u_lin), 64.0, 1e7)
    elif isinstance(dynamics, MertonJumpDynamics):
        s2 = (field("sigma")**2 + field("jump_intensity")
              * (field("jump_mean")**2 + field("jump_std")**2)) * T
    elif isinstance(dynamics, VarianceGammaDynamics):
        T_safe = torch.clamp(T, min=1e-6)
        nu = field("nu")
        u_star = torch.sqrt(2.0 / (field("sigma")**2 * nu)) * torch.exp(
            (nu / (2.0 * T_safe)) * math.log(1e12))
        return torch.clamp(u_star, 64.0, 1e7)
    elif isinstance(dynamics, KouJumpDynamics):
        p = field("p_up")
        ej2 = 2.0 * p / field("eta_up")**2 + 2.0 * (1.0 - p) / field("eta_down")**2
        s2 = (field("sigma")**2 + field("jump_intensity") * ej2) * T
    else:
        raise TypeError(
            f"no terminal law / CF decay envelope for dynamics "
            f"{type(dynamics).__name__}: bound='auto' supports "
            f"LognormalDynamics, HestonDynamics, BatesDynamics, "
            f"MertonJumpDynamics, VarianceGammaDynamics and KouJumpDynamics"
        )
    s = torch.sqrt(torch.clamp(torch.min(s2), min=1e-16))
    return torch.clamp(16.0 / s, min=64.0)


def _quad_nodes(prob: PricingProblem, method: CarrMadan, device):
    bound = method.bound
    if isinstance(bound, str):
        if bound != "auto":
            raise ValueError(
                f"string bound must be 'auto', got {bound!r} (pass a float "
                "for a fixed truncation)"
            )
        if method.quadrature == "gl":
            # the auto bound can reach ~1e9 for short-dated or low-vol
            # inputs; one Gauss–Legendre rule over the whole interval misses
            # the O(1)-wide α-peak: only the panel rule is bound-independent
            raise ValueError(
                "quadrature='gl' cannot resolve the bound='auto' interval "
                "(the α-peak is O(1) wide while the auto bound scales like "
                "16/(σ√T)); use quadrature='panel' or pass a fixed bound"
            )
        bound = _auto_bound(prob, method.dynamics, device)
    if method.quadrature == "panel":
        return _panel_nodes(bound, method.nodes, device)
    if method.quadrature == "gl":
        return _gl_nodes(bound, method.nodes, device)
    raise ValueError(f"unknown quadrature {method.quadrature!r} (use 'panel' or 'gl')")


def _solve_carr_madan_digital(prob: PricingProblem, method: CarrMadan,
                              device) -> CarrMadanSolution:
    """Cash-or-nothing digital by Gil-Pelaez inversion on the same nodes:
    P(S_T > K) = ½ + (1/π)∫₀^∞ Im[e^{−iu·lnK}φ(u)]/u du.  The integrand is
    even in u, so the symmetric node set integrates it with one ½·Σ w·g;
    digital puts follow from the cash parity."""
    payoff = prob.payoff
    market = prob.market_inputs
    if method.nodes % 2:
        raise ValueError(
            "digital Carr-Madan needs an even node count (an odd "
            "Gauss-Legendre rule places a node at u=0, where the Gil-Pelaez "
            "integrand's 1/u form is indeterminate)"
        )
    K = f64(payoff.strike, device=device)
    D = f64(df(market.rate, payoff.expiry), device=device)
    v, w = _quad_nodes(prob, method, device)
    logK_b = torch.log(K)[..., None]
    phi = terminal_log_cf(prob, method.dynamics)
    g = torch.imag(phi(v + 0.0j) * torch.exp(-1j * v * logK_b)) / v
    p_itm = 0.5 + (0.5 / torch.pi) * torch.sum(w * g, dim=-1)
    call_price = D * f64(payoff.cash, device=device) * p_itm
    price = parity_transform(call_price, payoff, f64(market.spot, device=device), market.rate)
    return CarrMadanSolution(prob, method, price, p_itm)


@register_solver(CarrMadan)
def _solve_carr_madan(prob: PricingProblem, method: CarrMadan) -> CarrMadanSolution:
    payoff = prob.payoff
    require_european(payoff, "CarrMadan", spot_only=True)
    market = prob.market_inputs
    device = resolve_device(method.device)
    if isinstance(payoff, (BarrierOption, AsianOption, DoubleBarrierOption, LookbackOption)):
        raise TypeError(
            f"CarrMadan prices path-independent payoffs (the CF of log S_T "
            f"carries no path law); {type(payoff).__name__} prices "
            f"analytically under Black-Scholes (where a closed form exists) "
            f"or via grid Monte Carlo"
        )
    if isinstance(payoff, DigitalOption):
        return _solve_carr_madan_digital(prob, method, device)
    if not isinstance(payoff, VanillaOption):
        raise TypeError(f"CarrMadan prices vanillas and digitals; got {type(payoff).__name__}")
    K = f64(payoff.strike, device=device)
    logK = torch.log(K)
    alpha = method.alpha
    D = f64(df(market.rate, payoff.expiry), device=device)

    v, w = _quad_nodes(prob, method, device)
    damp = torch.exp(-alpha * logK) / (2.0 * torch.pi)
    logK_b = logK[..., None]  # strike grids broadcast against the nodes

    phi = terminal_log_cf(prob, method.dynamics)
    numerator = D * phi(v - (alpha + 1.0) * 1j)
    denominator = alpha**2 + alpha - v**2 + 1j * v * (2.0 * alpha + 1.0)
    integrand = damp[..., None] * (numerator / denominator) * torch.exp(-1j * v * logK_b)
    integral = torch.sum(w * integrand, dim=-1)
    call_price = integral.real
    T = market_yearfrac(market, payoff.expiry)
    price = parity_transform(call_price, payoff, forward_spot(market, T, device=device),
                             market.rate)
    return CarrMadanSolution(prob, method, price, integral)


def carr_madan_fft_smile(prob: PricingProblem, dynamics=None, *, alpha: float = 1.5,
                         eta: float = 0.0125, n: int = 65536, k_window: float = 10.0,
                         device: str = "cuda"):
    """The whole call smile in one FFT (Carr–Madan 1999 §3):
    ``(strikes, call_prices)`` on the log-strike grid k_u = −b + u·2π/(nη),
    b = π/η, restricted to |k| ≤ ``k_window``, in complex128 on ``device``
    (``torch.fft.fft``).  Simpson-weighted trapezoid in the Fourier
    variable; the payoff's strike is not read (the market and expiry define
    the smile).  Interpolate in log-strike for quotes between grid points."""
    payoff = prob.payoff
    require_european(payoff, "carr_madan_fft_smile", spot_only=True)
    market = prob.market_inputs
    dev = resolve_device(device)
    D = f64(df(market.rate, payoff.expiry), device=dev)
    phi = terminal_log_cf(prob, dynamics)

    j = torch.arange(n, dtype=torch.float64, device=dev)
    v = j * eta
    psi = D * phi(v - (alpha + 1.0) * 1j) / (
        alpha**2 + alpha - v**2 + 1j * v * (2.0 * alpha + 1.0))
    lam = 2.0 * math.pi / (n * eta)
    b = 0.5 * n * lam
    # Simpson weights 1/3, 4/3, 2/3, … (Carr–Madan eq. 24 numbers j from 1)
    simpson = (3.0 - (-1.0) ** j - (j == 0).double()) / 3.0
    x = psi * torch.exp(1j * b * v) * (eta * simpson)
    # outside |k| ≤ k_window the damping e^{−αk} overflows on the deep left
    lo = int(np.ceil((-k_window + b) / lam))
    hi = int(np.floor((k_window + b) / lam)) + 1
    k = (-b + lam * j)[lo:hi]
    calls = torch.exp(-alpha * k) / math.pi * torch.fft.fft(x).real[lo:hi]
    return torch.exp(k), calls


def carr_madan_error_estimate(prob: PricingProblem, method: CarrMadan) -> dict:
    """Quadrature accuracy of a Carr–Madan configuration:
    ``{"price", "refinement", "tail", "total"}``, ``refinement`` the largest
    |Δprice| from doubling the nodes, ``tail`` the largest |Δprice| from
    doubling the bound at the doubled nodes, ``total`` their sum (floats;
    ``price`` keeps the strike's shape).  Three solves, for checking a
    configuration against an accuracy budget, not for the hot path."""
    p0 = _solve_carr_madan(prob, method).price
    fine = dataclasses.replace(method, nodes=2 * method.nodes)
    p1 = _solve_carr_madan(prob, fine).price
    if isinstance(method.bound, str):
        # auto: widen by re-deriving with half the effective decay rate
        wide_bound = float(2.0 * _auto_bound(prob, method.dynamics,
                                             resolve_device(method.device)))
    else:
        wide_bound = 2.0 * method.bound
    wide = dataclasses.replace(method, nodes=2 * method.nodes, bound=wide_bound)
    p2 = _solve_carr_madan(prob, wide).price
    refinement = float(torch.max(torch.abs(p1 - p0)))
    tail = float(torch.max(torch.abs(p2 - p1)))
    return {"price": p0, "refinement": refinement, "tail": tail, "total": refinement + tail}
