"""Sensitivities: lens-parameterised first- and second-order greeks by AD,
finite differences or closed form, and greek vectors in one backward pass.

Port of ``hedgehog_tpu/greeks/greeks.py`` (reference
src/greeks/greeks_problem.jl): "rewrite a parameter through a lens,
re-solve, differentiate" (greeks_problem.jl:249-262), differentiated by
torch:

- ``ForwardAD``: ``torch.func.jvp`` through the whole pricer, one tangent
  pass per lens (a batch too), nested for second order;
- ``ReverseAD``: ``torch.autograd.grad``; ``BatchGreekProblem`` takes the
  whole greek vector in one backward pass over the stacked parameters;
- ``FiniteDifference``: forward, backward or central with relative bumps
  ``x₀(1 ± ε)`` for first order (:279-303) and absolute stencils for second
  order (:395-422);
- ``AnalyticGreek``: the Black-Scholes closed forms with the
  tick-denominated theta (:437-530).

The closed forms compute on the pricing method's device, the card where
none is given.  The CUDA kernels bound what AD can take through a
``use_kernel=True`` pricer (ops/autograd_limits.py): those with a backward
(K11, the rough-Bergomi VJPs) refuse forward mode and second order with a
TypeError naming ``ReverseAD`` or ``use_kernel=False``, as the JAX
package's ``custom_vjp`` rules have neither.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..core.dates import MILLISECONDS_IN_YEAR_365
from ..core.lenses import FieldLens, Lens, SpotLens, VolLens
from ..core.solve import register_solver, solve
from ..market.rate_curve import zero_rate_yf
from ..utils import device_of, f64, resolve_device

__all__ = [
    "GreekProblem",
    "SecondOrderGreekProblem",
    "BatchGreekProblem",
    "GreekMethod",
    "GreekResult",
    "ForwardAD",
    "ReverseAD",
    "FiniteDifference",
    "AnalyticGreek",
    "FDForward",
    "FDBackward",
    "FDCentral",
]

_frozen = dataclasses.dataclass(frozen=True)


class GreekMethod:
    """Marker base for greek methods."""


class FDScheme:
    pass


@_frozen
class FDForward(FDScheme):
    pass


@_frozen
class FDBackward(FDScheme):
    pass


@_frozen
class FDCentral(FDScheme):
    pass


@_frozen
class ForwardAD(GreekMethod):
    """Forward-mode AD (``torch.func.jvp``): one tangent pass per lens."""


@_frozen
class ReverseAD(GreekMethod):
    """Reverse-mode AD (``torch.autograd.grad``): a whole greek vector in one
    backward pass."""


@_frozen
class FiniteDifference(GreekMethod):
    bump: Any = 1e-4
    scheme: FDScheme = FDCentral()


@_frozen
class AnalyticGreek(GreekMethod):
    """Closed-form Black-Scholes greeks."""


@_frozen
class GreekResult:
    greek: Any


@_frozen
class GreekProblem:
    pricing_problem: Any
    wrt: Lens = SpotLens()


@_frozen
class SecondOrderGreekProblem:
    pricing_problem: Any
    wrt1: Lens = SpotLens()
    wrt2: Lens = SpotLens()


@_frozen
class BatchGreekProblem:
    pricing_problem: Any
    lenses: Tuple[Lens, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "lenses", tuple(self.lenses))


def _price_fn(prob, lens, pricing_method):
    return lambda x: solve(lens.set(prob, x), pricing_method).price


def _price_fn2(prob, lens1, lens2, pricing_method):
    return lambda x, y: solve(lens2.set(lens1.set(prob, x), y), pricing_method).price


def _start(value, pricing_method) -> torch.Tensor:
    """A lens value as a float64 leaf, cut from any autograd history it had,
    on the pricing method's device (the value's own where the method names
    none)."""
    dev = getattr(pricing_method, "device", None)
    dev = device_of(value) if dev is None else resolve_device(dev)
    return f64(value, device=dev).detach()


def _jvp(f, x, tangent=None):
    tangent = torch.ones_like(x) if tangent is None else tangent
    return torch.func.jvp(f, (x,), (tangent,))[1]


def _grad(y, x, create_graph=False):
    (g,) = torch.autograd.grad(y, x, create_graph=create_graph, allow_unused=True)
    return torch.zeros_like(x) if g is None else g


# ------------------ AD ------------------


@register_solver(ForwardAD)
def _solve_forward_ad(gprob, method: ForwardAD, pricing_method):
    if isinstance(gprob, BatchGreekProblem):
        return _batch_greeks(gprob, method, pricing_method)
    prob = gprob.pricing_problem
    if isinstance(gprob, SecondOrderGreekProblem):
        lens1, lens2 = gprob.wrt1, gprob.wrt2
        x0 = _start(lens1.get(prob), pricing_method)
        y0 = _start(lens2.get(prob), pricing_method)
        f = _price_fn2(prob, lens1, lens2, pricing_method)
        if lens1 == lens2:
            # d²/dx² by nested jvp on the diagonal (greeks_problem.jl:372-373)
            deriv = _jvp(lambda x: _jvp(lambda z: f(x, z), x), x0)
        else:
            deriv = _jvp(lambda x: _jvp(lambda y: f(x, y), y0), x0)
        return GreekResult(deriv)
    x0 = _start(gprob.wrt.get(prob), pricing_method)
    return GreekResult(_jvp(_price_fn(prob, gprob.wrt, pricing_method), x0))


@register_solver(ReverseAD)
def _solve_reverse_ad(gprob, method: ReverseAD, pricing_method):
    if isinstance(gprob, BatchGreekProblem):
        return _batch_greeks(gprob, method, pricing_method)
    prob = gprob.pricing_problem
    if isinstance(gprob, SecondOrderGreekProblem):
        lens1, lens2 = gprob.wrt1, gprob.wrt2
        x = _start(lens1.get(prob), pricing_method).requires_grad_(True)
        if lens1 == lens2:
            # one underlying parameter: the second derivative of price(set x)
            g = _grad(_price_fn(prob, lens1, pricing_method)(x), x, create_graph=True)
            deriv = _grad(g, x) if g.requires_grad else torch.zeros_like(x)
        else:
            y = _start(lens2.get(prob), pricing_method).requires_grad_(True)
            g = _grad(_price_fn2(prob, lens1, lens2, pricing_method)(x, y), x, create_graph=True)
            deriv = _grad(g, y) if g.requires_grad else torch.zeros_like(y)
        return GreekResult(deriv.detach())
    x = _start(gprob.wrt.get(prob), pricing_method).requires_grad_(True)
    return GreekResult(_grad(_price_fn(prob, gprob.wrt, pricing_method)(x), x))


def _batch_greeks(gprob: BatchGreekProblem, method, pricing_method):
    """The whole greek vector: ReverseAD in one backward pass over the
    stacked parameter vector (< 2× a price); ForwardAD one tangent pass per
    lens (``jacfwd`` would vmap the kernels' autograd Functions, which have
    no batching rule)."""
    prob = gprob.pricing_problem
    lenses = gprob.lenses
    x0 = torch.stack([_start(lens.get(prob), pricing_method) for lens in lenses])

    def f(x):
        p = prob
        for i, lens in enumerate(lenses):
            p = lens.set(p, x[i])
        return solve(p, pricing_method).price

    if isinstance(method, ForwardAD):
        g = torch.stack([_jvp(f, x0, e) for e in torch.eye(len(lenses), dtype=x0.dtype,
                                                             device=x0.device)])
    else:
        x = x0.requires_grad_(True)
        g = _grad(f(x), x)
    return dict(zip(lenses, [g[i] for i in range(len(lenses))]))


# ------------------ Finite differences ------------------


@register_solver(FiniteDifference)
def _solve_fd(gprob, method: FiniteDifference, pricing_method):
    if isinstance(gprob, BatchGreekProblem):
        return {
            lens: solve(GreekProblem(gprob.pricing_problem, lens), method, pricing_method).greek
            for lens in gprob.lenses
        }
    prob = gprob.pricing_problem
    eps = method.bump
    if isinstance(gprob, SecondOrderGreekProblem):
        lens1, lens2 = gprob.wrt1, gprob.wrt2
        x0, y0 = lens1.get(prob), lens2.get(prob)
        f = _price_fn2(prob, lens1, lens2, pricing_method)
        if lens1 == lens2:
            deriv = (f(x0 + eps, y0 + eps) - 2.0 * f(x0, y0) + f(x0 - eps, y0 - eps)) / eps**2
        else:
            deriv = (f(x0 + eps, y0 + eps) - f(x0 + eps, y0 - eps) - f(x0 - eps, y0 + eps)
                     + f(x0 - eps, y0 - eps)) / (4.0 * eps**2)
        return GreekResult(deriv)
    lens = gprob.wrt
    x0 = f64(lens.get(prob), device=device_of(lens.get(prob)))
    f = _price_fn(prob, lens, pricing_method)
    # relative bump x0·(1 ± ε) as in the reference (greeks_problem.jl:279-303),
    # an absolute ε bump where x0 == 0 (the reference gives NaN there)
    scale = torch.where(torch.abs(x0) > 1e-12, x0, 1.0)
    scheme = method.scheme
    if isinstance(scheme, FDForward):
        deriv = (f(x0 + scale * eps) - f(x0)) / (scale * eps)
    elif isinstance(scheme, FDBackward):
        deriv = (f(x0) - f(x0 - scale * eps)) / (scale * eps)
    else:
        deriv = (f(x0 + scale * eps) - f(x0 - scale * eps)) / (2 * eps * scale)
    return GreekResult(deriv)


# ------------------ Analytic Black-Scholes greeks ------------------


def _is_spot_lens(lens) -> bool:
    return isinstance(lens, SpotLens) or (
        isinstance(lens, FieldLens) and lens.path == "market_inputs.spot")


def _is_expiry_lens(lens) -> bool:
    return isinstance(lens, FieldLens) and lens.path == "payoff.expiry"


def _is_vol_lens(lens) -> bool:
    return isinstance(lens, VolLens) or (
        isinstance(lens, FieldLens) and lens.path == "market_inputs.sigma.sigma")


def _npdf(x):
    return torch.exp(-0.5 * x * x) / torch.sqrt(torch.tensor(2.0 * torch.pi, dtype=x.dtype,
                                                             device=x.device))


@register_solver(AnalyticGreek)
def _solve_analytic_greek(gprob, method: AnalyticGreek, pricing_method=None):
    if isinstance(gprob, BatchGreekProblem):
        return {
            lens: _solve_analytic_greek(GreekProblem(gprob.pricing_problem, lens), method,
                                        pricing_method).greek
            for lens in gprob.lenses
        }
    from ..core.payoffs import VanillaOption
    from ..market.inputs import carry_yield
    from ..methods.black_scholes import bs_geometry

    prob = gprob.pricing_problem
    if not isinstance(prob.payoff, VanillaOption):
        raise TypeError(
            "AnalyticGreek implements the Black-Scholes VANILLA closed forms "
            f"(greeks_problem.jl:437-530); {type(prob.payoff).__name__} greeks "
            "are available via ForwardAD/ReverseAD/FiniteDifference"
        )
    device = resolve_device(getattr(pricing_method, "device", "cuda"))
    inputs, payoff = prob.market_inputs, prob.payoff
    T, K, sigma, D, F, sqrtT, d1, d2 = bs_geometry(prob, device)
    cp = payoff.call_put()
    q = f64(carry_yield(inputs), device=device)
    qf = torch.exp(-q * T)  # carry factor e^{−qT}
    ncdf = torch.special.ndtr

    if isinstance(gprob, SecondOrderGreekProblem):
        lens1, lens2 = gprob.wrt1, gprob.wrt2
        if _is_spot_lens(lens1) and _is_spot_lens(lens2):
            # gamma = e^{−qT}·φ(d1) / (S σ √T)
            greek = qf * _npdf(d1) / (f64(inputs.spot, device=device) * sigma * sqrtT)
        elif _is_vol_lens(lens1) and _is_vol_lens(lens2):
            vega = D * F * _npdf(d1) * sqrtT
            greek = vega * d1 * d2 / sigma
        else:
            raise ValueError("Unsupported second-order analytic Greek")
        return GreekResult(greek)

    lens = gprob.wrt
    if _is_spot_lens(lens):
        greek = qf * cp * ncdf(cp * d1)
    elif _is_vol_lens(lens):
        greek = D * F * _npdf(d1) * sqrtT  # F is carry-adjusted already
    elif _is_expiry_lens(lens):
        # dPrice/d(expiry ticks) at a flat rate, per tick (greeks_problem.jl:472-475);
        # with carry q the spot leg decays at q
        r = f64(zero_rate_yf(inputs.rate, T), device=device)
        greek = (r * K * D * ncdf(cp * d2) * cp - q * F * D * ncdf(cp * d1) * cp
                 + F * D * sigma * _npdf(d1) / (2.0 * sqrtT)) / MILLISECONDS_IN_YEAR_365
    else:
        raise ValueError("Unsupported lens for analytic Greek")
    return GreekResult(greek)
