"""CEV (constant elasticity of variance) closed forms on the device.

Port of ``hedgehog_tpu/methods/cev.py``.  dS = (r − q)·S dt + σ·S^β dW,
β ∈ (0, 1), absorbing at zero.  The terminal law is noncentral χ² (Cox
1975, Schroder 1989); in Hull's parameterisation, with
ν = σ²·(e^{2μ̂(1−β)T} − 1)/(2μ̂(1−β)) (σ²T as μ̂ = r − q → 0):

    a = K^{2(1−β)} / ((1−β)²·ν),  c = S^{2(1−β)}·e^{2μ̂(1−β)T} / ((1−β)²·ν),
    b = 1/(1−β)
    call = S·e^{−qT}·[1 − F(a; b+2, c)] − K·e^{−rT}·F(c; b, a)

with F(x; k, λ) the noncentral-χ² CDF; P(S_T > K) = F(c; b, a) prices cash
digitals and the put follows by parity (discounted CEV is a true martingale
under absorption).  F is the Poisson mixture Σ_j pois(j; λ/2)·P(k/2 + j,
x/2) over one window of ``terms`` terms centred on the Poisson mode, with
log-space weights.

The regularised incomplete gamma P(a, x) goes through :class:`_GammaIncP`:
JAX's own algorithm (the power series below the diagonal x = a, Legendre's
continued fraction for Q above it), run trip for trip on the device, and
its derivative in ``a`` by the same recurrences differentiated alongside,
which torch does not give (``torch.special.gammainc`` has no derivative in
``a`` and is ~100 times less accurate near a ≈ x ≫ 1).  So autograd
reaches spot, σ, r, q and β (the skew greek through k = 1/(1−β)), as
``jax.grad`` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.payoffs import DigitalOption, European, VanillaOption
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df, zero_rate
from ..models.dynamics import CEVDynamics
from ..utils import f64, resolve_device
from .black_scholes import _tensors

__all__ = ["CEVAnalytic", "ncx2_cdf", "cev_call_price", "cev_survival"]

_EPS = float(torch.finfo(torch.float64).eps)
#: loop trips between two host reads of "is any element still iterating"
_CHECK_EVERY = 16


@dataclasses.dataclass(frozen=True)
class CEVAnalytic(AbstractPricingMethod):
    """Schroder noncentral-χ² closed form for CEV vanillas and digitals on
    ``device``; ``terms`` sizes the mode-centred window of the CDF series."""

    terms: int = 2048
    device: str = "cuda"

    @property
    def dynamics(self):
        return CEVDynamics()


def _while_any(enabled, body):
    """Run ``body`` (which returns the next ``enabled`` mask) until no
    element is enabled, reading the mask back every ``_CHECK_EVERY`` trips:
    trips past an element's end leave it unchanged, so the result is that
    of checking after every trip."""
    while bool(enabled.any()):
        for _ in range(_CHECK_EVERY):
            enabled = body(enabled)
    return enabled


def _igamma_series(ax, x, a, enabled, derivative: bool):
    """P(a, x) (or ∂P/∂a) by the power series, for x < a or x < 1: JAX's
    ``_igamma_series`` trip for trip, each element frozen after its last."""
    st = {"r": a, "c": torch.ones_like(a), "ans": torch.ones_like(a),
          "dc": torch.zeros_like(a), "dans": torch.zeros_like(a)}

    def body(on):
        r = st["r"] + 1.0
        dc = st["dc"] * (x / r) - (st["c"] * x) / (r * r)
        dans = st["dans"] + dc
        c = st["c"] * (x / r)
        ans = st["ans"] + c
        more = (torch.abs(dc / dans) if derivative else c / ans) > _EPS
        for k, v in (("r", r), ("c", c), ("ans", ans), ("dc", dc), ("dans", dans)):
            st[k] = torch.where(on, v, st[k])
        return on & more

    _while_any(enabled, body)
    if not derivative:
        return st["ans"] * ax / a
    dlogax = torch.log(x) - torch.digamma(a + 1.0)
    return ax * (st["ans"] * dlogax + st["dans"]) / a


def _igammac_cf(ax, x, a, enabled, derivative: bool):
    """Q(a, x) (or ∂Q/∂a) by the continued fraction, for x > a, x ≥ 1:
    JAX's ``_igammac_continued_fraction`` trip for trip (at most 2000)."""
    y = 1.0 - a
    z = x + y + 1.0
    pkm1, qkm1 = x + 1.0, z * x
    ans = pkm1 / qkm1
    zero = torch.zeros_like(x)
    st = {"ans": ans, "y": y, "z": z, "pkm1": pkm1, "qkm1": qkm1, "pkm2": torch.ones_like(x),
          "qkm2": x, "dpkm2": zero, "dqkm2": zero, "dpkm1": zero, "dqkm1": -x,
          "dans": (zero - ans * -x) / qkm1}
    trips = [0]

    def body(on):
        trips[0] += 1
        c = float(trips[0])
        if trips[0] > 2000:
            return on & False
        y = st["y"] + 1.0
        z = st["z"] + 2.0
        yc = y * c
        pk = st["pkm1"] * z - st["pkm2"] * yc
        qk = st["qkm1"] * z - st["qkm2"] * yc
        nz = qk != 0.0
        r = pk / qk
        t = torch.where(nz, torch.abs((st["ans"] - r) / r), 1.0)
        ans = torch.where(nz, r, st["ans"])
        dpk = st["dpkm1"] * z - st["pkm1"] - st["dpkm2"] * yc + st["pkm2"] * c
        dqk = st["dqkm1"] * z - st["qkm1"] - st["dqkm2"] * yc + st["qkm2"] * c
        dans = torch.where(nz, (dpk - ans * dqk) / qk, st["dans"])
        grad_t = torch.where(nz, torch.abs(dans - st["dans"]), 1.0)
        new = {"pkm2": st["pkm1"], "pkm1": pk, "qkm2": st["qkm1"], "qkm1": qk,
               "dpkm2": st["dpkm1"], "dqkm2": st["dqkm1"], "dpkm1": dpk, "dqkm1": dqk}
        rescale = torch.abs(pk) > 1.0 / _EPS
        for k in new:
            new[k] = torch.where(rescale, new[k] * _EPS, new[k])
        new.update(ans=ans, y=y, z=z, dans=dans)
        for k, v in new.items():
            st[k] = torch.where(on, v, st[k])
        return on & ((grad_t if derivative else t) > _EPS)

    _while_any(enabled, body)
    if not derivative:
        return st["ans"] * ax
    dlogax = torch.log(x) - torch.digamma(a)
    return ax * (st["ans"] * dlogax + st["dans"])


def _igamma(a: torch.Tensor, x: torch.Tensor, derivative: bool = False) -> torch.Tensor:
    """P(a, x), or ∂P/∂a with ``derivative``, for float64 tensors of one
    shape: JAX's ``igamma_impl`` / ``igamma_grad_a_impl`` (the series below
    the diagonal, the continued fraction above it), whose accuracy near
    a ≈ x ≫ 1 torch.special.gammainc does not reach (5e-11 against 4e-13
    at a = x = 1250)."""
    x_zero = x == 0.0
    nan = torch.isnan(a) | torch.isnan(x)
    if derivative:
        bad = (x < 0.0) | (a <= 0.0) | nan
    else:
        bad = (x < 0.0) | (a < 0.0) | ((a == 0.0) & x_zero) | nan
    x_inf = torch.isinf(x)
    upper = ((x > 1.0) if derivative else (x >= 1.0)) & (x > a)
    log_ax = a * torch.log(x) - x - torch.lgamma(a)
    ax = torch.exp(log_ax)
    enabled = ~(x_zero | bad | (log_ax < -math.log(torch.finfo(torch.float64).max)))
    if not derivative:
        enabled = enabled & ~x_inf
    cf = _igammac_cf(ax, x, a, enabled & upper, derivative)
    series = _igamma_series(ax, x, a, enabled & ~upper, derivative)
    out = torch.where(upper, -cf if derivative else 1.0 - cf, series)
    out = torch.where(x_zero, 0.0, out)
    if not derivative:
        out = torch.where(x_inf, 1.0, out)
    return torch.where(bad, float("nan"), out)


def _dgammainc_dx(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """∂P(a, x)/∂x = x^{a−1}·e^{−x}/Γ(a) (JAX's ``igamma_gradx``)."""
    return torch.exp((a - 1.0) * torch.log(x) - x - torch.lgamma(a))


class _GammaIncP(torch.autograd.Function):
    """The regularised lower incomplete gamma P(a, x) (x > 0, equal shapes),
    differentiable in both arguments, reverse and forward mode."""

    @staticmethod
    def forward(a, x):
        return _igamma(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, x = inputs
        ctx.save_for_backward(a, x)
        ctx.save_for_forward(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        ga = g * _igamma(a, x, derivative=True) if ctx.needs_input_grad[0] else None
        gx = g * _dgammainc_dx(a, x) if ctx.needs_input_grad[1] else None
        return ga, gx

    @staticmethod
    def jvp(ctx, ta, tx):
        a, x = ctx.saved_tensors
        out = torch.zeros_like(a)
        if ta is not None:
            out = out + ta * _igamma(a, x, derivative=True)
        if tx is not None:
            out = out + tx * _dgammainc_dx(a, x)
        return out


def gammainc(a, x) -> torch.Tensor:
    """P(a, x) with gradients in ``a`` and ``x`` (x > 0; broadcasts)."""
    a, x = torch.broadcast_tensors(a, x)
    return _GammaIncP.apply(a, x)


def ncx2_cdf(x, k, lam, terms: int = 2048) -> torch.Tensor:
    """Noncentral-χ² CDF P(χ'²_k(λ) ≤ x) as a fixed-trip Poisson-gamma
    series Σ_j e^{−λ/2}(λ/2)^j/j! · P(k/2 + j, x/2) over a ``terms``-wide
    window centred on the Poisson mode ⌊λ/2⌋ (truncation error the Poisson
    mass outside it: ≤ 1e-12 while √(λ/2) ≲ terms/14, which is checked on
    the host).  Broadcasts over x, k, λ; differentiable in all three."""
    x, k, lam = _tensors(x, k, lam)
    dev = x.device
    half = lam / 2.0
    h_max = float(torch.max(half.detach()))
    need = h_max**0.5 * 14.0
    if need > terms:
        raise ValueError(
            f"ncx2_cdf window of {terms} terms cannot cover "
            f"noncentrality/2 = {h_max:.3g} "
            f"(needs ~{int(need) + 1}); raise `terms` "
            "(CEVAnalytic(terms=...)) or move β toward Black-Scholes"
        )
    j0 = torch.clamp(torch.floor(half.detach()) - terms // 2, min=0.0)
    j = j0[..., None] + torch.arange(terms, dtype=torch.float64, device=dev)
    h = half[..., None]
    log_w = j * torch.log(torch.clamp(h, min=1e-300)) - h - torch.lgamma(j + 1.0)
    # λ = 0 is the central χ²: the j = 0 term with weight 1
    w = torch.where(h > 0.0, torch.exp(log_w), (j == 0.0).to(torch.float64))
    # double where: ∂P(a, 0)/∂x is infinite for a < 1, so the dead x ≤ 0
    # branch never sees x = 0
    x_pos = x > 0.0
    x_safe = torch.where(x_pos, x, 1.0)
    p = gammainc(k[..., None] / 2.0 + j, x_safe[..., None] / 2.0)
    out = torch.sum(w * p, dim=-1)
    return torch.where(x_pos, out, 0.0)


def _cev_abc(spot, strike, mu_hat, sigma, beta, T):
    one_b = 1.0 - beta
    e = torch.exp(2.0 * mu_hat * one_b * T)
    # ν = σ²(e − 1)/(2μ̂(1 − β)), its μ̂ → 0 limit σ²T through expm1
    live = torch.abs(mu_hat) > 1e-14
    mu_safe = torch.where(live, mu_hat, 1.0)
    nu = torch.where(live,
                     sigma**2 * torch.expm1(2.0 * mu_hat * one_b * T) / (2.0 * mu_safe * one_b),
                     sigma**2 * T)
    denom = one_b**2 * nu
    a = strike ** (2.0 * one_b) / denom
    c = spot ** (2.0 * one_b) * e / denom
    return a, 1.0 / one_b, c


def cev_survival(spot, strike, mu_hat, sigma, beta, T, terms: int = 2048) -> torch.Tensor:
    """Risk-neutral P(S_T > K) under CEV, absorption at zero included."""
    spot, strike, mu_hat, sigma, beta, T = _tensors(spot, strike, mu_hat, sigma, beta, T)
    a, b, c = _cev_abc(spot, strike, mu_hat, sigma, beta, T)
    return ncx2_cdf(c, b, a, terms)


def cev_call_price(spot, strike, r, q, sigma, beta, T, discount,
                   terms: int = 2048) -> torch.Tensor:
    """CEV call (Schroder 1989 through Hull's a, b, c): absorbing zero
    boundary, general carry."""
    spot, strike, r, q, sigma, beta, T, discount = _tensors(
        spot, strike, r, q, sigma, beta, T, discount)
    a, b, c = _cev_abc(spot, strike, r - q, sigma, beta, T)
    stock_leg = spot * torch.exp(-q * T) * (1.0 - ncx2_cdf(a, b + 2.0, c, terms))
    cash_leg = strike * discount * ncx2_cdf(c, b, a, terms)
    return stock_leg - cash_leg


@register_solver(CEVAnalytic)
def _solve_cev(prob: PricingProblem, method: CEVAnalytic) -> AnalyticSolution:
    from ..market.inputs import CEVInputs

    payoff = prob.payoff
    market = prob.market_inputs
    if not isinstance(market, CEVInputs):
        raise TypeError(f"CEVAnalytic prices CEVInputs markets; got {type(market).__name__}")
    if not isinstance(payoff, (VanillaOption, DigitalOption)):
        raise TypeError(
            f"CEVAnalytic prices European vanillas and digitals; "
            f"{type(payoff).__name__} has no CEV closed form here"
        )
    if not isinstance(payoff.exercise_style, European):
        raise TypeError(
            "CEVAnalytic is European-only (use LSM on the CEV Euler grid "
            "for early exercise)"
        )
    dev = resolve_device(method.device)
    T = f64(market_yearfrac(market, payoff.expiry), device=dev)
    D = f64(df(market.rate, payoff.expiry), device=dev)
    r = f64(zero_rate(market.rate, payoff.expiry), device=dev)
    q = f64(carry_yield(market), device=dev)
    spot, sigma, beta, K = (f64(v, device=dev) for v in (market.spot, market.sigma, market.beta,
                                                         payoff.strike))
    if isinstance(payoff, DigitalOption):
        # cash-or-nothing: D·P(S_T > K) for calls; a put pays on the
        # complement, which includes the mass absorbed at zero
        surv = cev_survival(spot, K, r - q, sigma, beta, T, method.terms)
        cash = f64(payoff.cash, device=dev)
        price = cash * D * (surv if payoff.call_put() > 0 else 1.0 - surv)
    else:
        call = cev_call_price(spot, K, r, q, sigma, beta, T, D, method.terms)
        # the put by parity: C − P = S e^{−qT} − K D holds exactly
        price = call if payoff.call_put() > 0 else call - (spot * torch.exp(-q * T) - K * D)
    return AnalyticSolution(prob, method, price)
