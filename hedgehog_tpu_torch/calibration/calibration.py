"""Calibration: fit lens-selected parameters to quoted prices.

Port of ``hedgehog_tpu/calibration/calibration.py`` (reference
src/calibration/calibration.jl).  A ``CalibrationProblem`` is a basket, a
pricing method, one lens per parameter, the quotes and a first guess; it is
solved by

- ``OptimizerAlgo``: least squares by box-bounded L-BFGS
  (``math.optimize.minimize_lbfgs``), its gradient from
  ``torch.autograd.grad`` through the pricer (calibration.jl:74-98); the
  bounds are the keywords of ``solve(calib, OptimizerAlgo(), lb=, ub=)``;
- ``RootFinderAlgo``: a bracketed root on (1e-6, 5.0) for one instrument and
  one parameter (calibration.jl:126-145), with IFT gradients.

The unknowns, the bounds and the quotes live on the pricing method's device
(the GPU unless the method asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..core.problems import BasketPricingProblem, PricingProblem
from ..core.solve import _conditional_basket_fast_path, _traced, register_solver, solve
from ..math.optimize import minimize_lbfgs
from ..math.rootfind import implicit_root_full
from ..utils import f64, resolve_device

__all__ = ["CalibrationProblem", "OptimizerAlgo", "RootFinderAlgo", "CalibrationSolution"]

_frozen = dataclasses.dataclass(frozen=True)


@_frozen
class CalibrationProblem:
    """Basket + pricing method + lens per parameter + quotes + initial guess
    (calibration.jl:16-29)."""

    pricing_problem: BasketPricingProblem
    quotes: Any
    initial_guess: Any
    pricing_method: Any = None
    accessors: Tuple[Any, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "accessors", tuple(self.accessors))


class CalibrationAlgo:
    pass


@_frozen
class OptimizerAlgo(CalibrationAlgo):
    """Least-squares calibration by box-bounded L-BFGS (calibration.jl:46-58)."""

    max_iters: int = 200


@_frozen
class RootFinderAlgo(CalibrationAlgo):
    """Scalar bracketed root-finding calibration (calibration.jl:106-117),
    on the reference's bracket (1e-6, 5.0) (calibration.jl:143)."""

    lo: float = 1e-6
    hi: float = 5.0
    iters: int = 80


@_frozen
class CalibrationSolution:
    """Calibrated parameter vector ``u`` and the fit's diagnostics;
    ``evaluations`` counts the objective evaluations (each with its
    gradient under ``OptimizerAlgo``)."""

    problem: Any
    u: Any
    loss: Any = 0.0
    converged: Any = True
    iterations: Any = 0
    evaluations: Any = 0

    @property
    def price(self):
        return self.u


def _apply_lenses(basket: BasketPricingProblem, lenses, x):
    prob = basket
    for i, lens in enumerate(lenses):
        prob = lens.set(prob, x[i])
    return prob


def _homogeneous_payoffs(payoffs) -> bool:
    """True when all payoffs are vanillas with the same markers."""
    from ..core.payoffs import VanillaOption

    if not all(isinstance(p, VanillaOption) for p in payoffs):
        return False
    first = payoffs[0]
    return all(
        (type(p.exercise_style), type(p.call_put), type(p.underlying))
        == (type(first.exercise_style), type(first.call_put), type(first.underlying))
        for p in payoffs
    )


def _takes_strike_grid(method) -> bool:
    """Methods that price a 1-D strike tensor in one call."""
    from ..methods.black_scholes import BlackScholesAnalytic
    from ..methods.carr_madan import CarrMadan

    return isinstance(method, (CarrMadan, BlackScholesAnalytic))


def _basket_prices(basket: BasketPricingProblem, method) -> torch.Tensor:
    """The basket's prices, (len(payoffs),): the conditional Heston fast path
    (one simulation for the whole basket) first; then homogeneous vanillas as
    one strike-grid call per expiry where the method takes a grid (the JAX
    package vmaps them); else one ``solve`` per payoff."""
    fast = _conditional_basket_fast_path(basket, method)
    if fast is not None:
        return torch.stack([s.price for s in fast.solutions])
    payoffs = basket.payoffs
    market = basket.market_inputs
    if (len(payoffs) > 1 and _homogeneous_payoffs(payoffs) and _takes_strike_grid(method)
            and not any(_traced(p.expiry) for p in payoffs)):
        device = resolve_device(method.device)
        groups: dict = {}
        for idx, p in enumerate(payoffs):
            groups.setdefault(float(p.expiry), []).append(idx)
        prices = [None] * len(payoffs)
        for idxs in groups.values():
            strikes = torch.stack([f64(payoffs[i].strike, device=device) for i in idxs])
            grid = dataclasses.replace(payoffs[idxs[0]], strike=strikes)
            row = solve(PricingProblem(grid, market), method).price
            for pos, i in enumerate(idxs):
                prices[i] = row[pos]
        return torch.stack(prices)
    return torch.stack([torch.as_tensor(solve(PricingProblem(p, market), method).price)
                        for p in payoffs])


def _method_device(calib) -> torch.device:
    return resolve_device(getattr(calib.pricing_method, "device", "cuda"))


@register_solver(OptimizerAlgo)
def _solve_calibration_opt(calib: CalibrationProblem, algo: OptimizerAlgo, *, lb=None, ub=None):
    device = _method_device(calib)
    quotes = f64(calib.quotes, device=device)

    def objective(x):
        updated = _apply_lenses(calib.pricing_problem, calib.accessors, x)
        prices = _basket_prices(updated, calib.pricing_method).to(device)
        return torch.sum((prices - quotes) ** 2)

    x0 = f64(calib.initial_guess, device=device)
    lb = None if lb is None else f64(lb, device=device)
    ub = None if ub is None else f64(ub, device=device)
    res = minimize_lbfgs(objective, x0, lb=lb, ub=ub, max_iters=algo.max_iters)
    return CalibrationSolution(calib, res.x, loss=res.loss, converged=res.converged,
                               iterations=res.iterations, evaluations=res.evaluations)


@register_solver(RootFinderAlgo)
def _solve_calibration_root(calib: CalibrationProblem, algo: RootFinderAlgo):
    if len(calib.accessors) != 1:
        raise ValueError("Root-finding only supports calibration of a single parameter")
    device = _method_device(calib)
    lens = calib.accessors[0]
    quotes = f64(calib.quotes, device=device).reshape(-1)
    if len(calib.pricing_problem.payoffs) != 1 or quotes.shape[0] != 1:
        raise ValueError("Root-finding expects a single instrument and quote")
    prob = PricingProblem(calib.pricing_problem.payoffs[0], calib.pricing_problem.market_inputs)

    def f(x):
        return solve(lens.set(prob, x), calib.pricing_method).price - quotes[0]

    res = implicit_root_full(f, f64(algo.lo, device=device), f64(algo.hi, device=device),
                             iters=algo.iters)
    # the residual is f at the bisection root, already evaluated by the polish;
    # converged records whether the bracket held a sign change
    return CalibrationSolution(calib, res.root, loss=res.residual**2, converged=res.converged,
                               iterations=algo.iters, evaluations=algo.iters + 3)
