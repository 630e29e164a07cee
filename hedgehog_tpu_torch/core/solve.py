"""The ``solve(problem, method)`` facade: the single entry point.

Port of ``hedgehog_tpu/core/solve.py``: a registry keyed by method class
(with an MRO walk) in place of Julia's multiple dispatch.  A
``BasketPricingProblem`` under a pricing method maps the method over its
payoffs (basket.jl:35-38), or prices the whole basket from one simulation
where the conditional Heston fast path applies.  Greek and calibration
problems dispatch on their algorithm, which takes extra arguments (the
pricing method of a greek, the bounds of a calibration).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .problems import BasketPricingProblem, BasketPricingSolution, PricingProblem

__all__ = ["solve", "register_solver", "AbstractPricingMethod"]


class AbstractPricingMethod:
    """Base marker for pricing methods (pricing_methods.jl:6)."""


_SOLVERS: dict[type, Callable] = {}


def register_solver(method_cls: type):
    """Register fn(problem, method, *args, **kwargs) for a method class."""

    def deco(fn: Callable) -> Callable:
        _SOLVERS[method_cls] = fn
        return fn

    return deco


def _lookup(method: Any) -> Callable:
    for cls in type(method).__mro__:
        if cls in _SOLVERS:
            return _SOLVERS[cls]
    raise TypeError(f"no solver registered for method {type(method).__name__}")


def _traced(x) -> bool:
    """True for a tensor whose value a host read would cut from its
    derivatives: one that requires grad, carries a forward-mode tangent or
    is wrapped by a ``torch.func`` transform."""
    if not isinstance(x, torch.Tensor):
        return False
    return (x.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(x)
            or torch.autograd.forward_ad.unpack_dual(x).tangent is not None)


def _conditional_basket_fast_path(problem, method):
    """One-simulation basket pricing for conditional-MC Heston vanillas.

    When every payoff is a European × Spot vanilla with a scalar strike, the
    market is Heston and the method is ``MonteCarlo(HestonDynamics(),
    HestonQE(conditional=True))`` with ``use_kernel=False``, the whole
    basket prices from ONE variance-path simulation: payoffs group by
    expiry, the V path runs through the sorted expiry segments and every
    (strike, cp) closes with the conditional Black-Scholes formula
    (``methods.heston_surface._mixing_surface_rows``, float64 on
    ``method.device``).  Returns None (the per-payoff loop) wherever the
    basket does not qualify or an expiry is not a host number."""
    from ..core.payoffs import European, Spot, VanillaOption
    from ..market.inputs import HestonInputs, market_yearfrac
    from ..methods.heston_surface import _mixing_surface_rows
    from ..methods.montecarlo import HestonQE, MonteCarlo
    from ..models.dynamics import HestonDynamics
    from ..utils import f64, resolve_device
    from .problems import MonteCarloSolution

    market = problem.market_inputs
    if not (
        isinstance(method, MonteCarlo)
        and isinstance(method.dynamics, HestonDynamics)
        and isinstance(method.strategy, HestonQE)
        and method.strategy.conditional
        and not method.strategy.use_kernel
        and isinstance(market, HestonInputs)
    ):
        return None
    payoffs = problem.payoffs
    for p in payoffs:
        if not (
            isinstance(p, VanillaOption)
            and isinstance(p.exercise_style, European)
            and isinstance(p.underlying, Spot)
            and torch.as_tensor(p.strike).ndim == 0
        ):
            return None
    if not payoffs or any(_traced(p.expiry) for p in payoffs):
        return None
    T_all = [float(market_yearfrac(market, p.expiry)) for p in payoffs]
    if min(T_all) <= 0.0:
        return None

    device = resolve_device(method.device)
    T_sorted = sorted(set(T_all))
    groups = {t: [] for t in T_sorted}  # expiry → payoff indices
    for idx, t in enumerate(T_all):
        groups[t].append(idx)
    per_strikes = [torch.stack([f64(payoffs[i].strike, device=device) for i in groups[t]])
                   for t in T_sorted]
    per_cp = [f64([payoffs[i].call_put() for i in groups[t]], device=device) for t in T_sorted]

    rows = _mixing_surface_rows(market, T_sorted, per_strikes, per_cp, method.config,
                                device=device)
    prices = [None] * len(payoffs)
    for row, t in zip(rows, T_sorted):
        for pos, idx in enumerate(groups[t]):
            prices[idx] = row[pos]
    sols = tuple(MonteCarloSolution(PricingProblem(p, market), method, prices[i], None)
                 for i, p in enumerate(payoffs))
    return BasketPricingSolution(problem, sols)


def solve(problem: Any, method: Any, *args: Any, **kwargs: Any):
    """Solve a pricing, greek or calibration problem with ``method``."""
    if isinstance(problem, BasketPricingProblem) and isinstance(method, AbstractPricingMethod):
        if not args and not kwargs:
            fast = _conditional_basket_fast_path(problem, method)
            if fast is not None:
                return fast
        sols = tuple(
            solve(PricingProblem(payoff, problem.market_inputs), method, *args, **kwargs)
            for payoff in problem.payoffs
        )
        return BasketPricingSolution(problem, sols)
    return _lookup(method)(problem, method, *args, **kwargs)
