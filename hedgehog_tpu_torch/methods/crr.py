"""Cox-Ross-Rubinstein binomial tree: the backward induction on the device.

Port of the vanilla lattice of ``hedgehog_tpu/methods/crr.py`` (reference
src/pricing_methods/cox_ross_rubinstein.jl).  Forward-measure tree: up factor
``u = exp(σ√ΔT)``, down ``1/u``, up probability ``p = 1/(1+u)`` (the forward
is a martingale), per-step discount ``exp(−z(T)·ΔT)`` (crr.jl:113-130).
European, American and Bermudan exercise; Spot or Forward underlying (Spot
discounts the forward node values back with the curve, crr.jl:77-97); carry
through the market's dividend yield.

The shrinking tree is a fixed-width (steps + 1) vector on the device: each
contraction reads v[j] and v[j+1], and after k steps slot j depends only on
the payoff nodes j..j+k, so slot 0 holds the root price after ``steps``
contractions with no masking.  The loop over steps reads nothing back to the
host.  An array strike prices one tree per strike along a leading axis (the
node axis last), with per-strike vols from the market's surface.

Barrier and knock-in lattices wait for the path-dependent payoffs
(core/payoffs.py ``BarrierOption``), and discrete dividends for
``market/dividends.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.payoffs import American, Bermudan, Spot, VanillaOption, bermudan_step_mask
from ..core.problems import CRRSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import BlackScholesInputs, carry_yield, forward_spot, market_yearfrac
from ..market.rate_curve import df, zero_rate, zero_rate_yf
from ..market.vol_surface import get_vol
from ..utils import f64, resolve_device

__all__ = ["CoxRossRubinsteinMethod"]


@dataclasses.dataclass(frozen=True)
class CoxRossRubinsteinMethod(AbstractPricingMethod):
    """A ``steps``-step CRR lattice on ``device`` (the GPU unless the caller
    asks for the CPU)."""

    steps: int = 100
    device: str = "cuda"


@register_solver(CoxRossRubinsteinMethod)
def _solve_crr(prob: PricingProblem, method: CoxRossRubinsteinMethod) -> CRRSolution:
    payoff = prob.payoff
    market = prob.market_inputs
    steps = method.steps
    if not isinstance(payoff, VanillaOption):
        raise TypeError(
            f"the port's CRR lattice prices vanilla options; {type(payoff).__name__} "
            "(barrier and knock-in lattices) waits for the path-dependent payoffs of "
            "core/payoffs.py"
        )
    if not isinstance(market, BlackScholesInputs):
        raise TypeError(
            f"the CRR lattice is a Black-Scholes tree; got {type(market).__name__} "
            "(price Heston early exercise with LSM)"
        )
    if getattr(market, "dividends", None) is not None:
        raise TypeError("discrete dividends on the lattice wait for market/dividends.py")
    device = resolve_device(method.device)
    strike = f64(payoff.strike, device=device)
    if strike.ndim > 0:
        # strike grid: one tree per strike on a leading axis, the node axis last
        strike = strike[:, None]
    # the strike on the device: the intrinsic value then copies nothing to the card
    payoff = dataclasses.replace(payoff, strike=strike)
    sigma = f64(get_vol(market.sigma, payoff.expiry, strike), device=device)
    T = market_yearfrac(market, payoff.expiry)
    D_T = df(market.rate, payoff.expiry).to(device)
    q = f64(carry_yield(market), device=device)
    forward = forward_spot(market, T, device=device) / D_T  # carry-adjusted T-forward
    dT = T / steps
    u = torch.exp(sigma * dT**0.5)
    p = 1.0 / (1.0 + u)
    step_discount = torch.exp(-zero_rate(market.rate, payoff.expiry).to(device) * dT)

    is_bermudan = isinstance(payoff.exercise_style, Bermudan)
    can_exercise = is_bermudan or isinstance(payoff.exercise_style, American)
    ex_mask = (bermudan_step_mask(payoff.exercise_style, market, payoff.expiry, steps,
                                  device=device) if is_bermudan else None)
    j = torch.arange(steps + 1, dtype=torch.float64, device=device)
    value = payoff(forward * u ** (2.0 * j - steps))
    if can_exercise and isinstance(payoff.underlying, Spot):
        # forward nodes back to spot at node time i·ΔT (crr.jl:77-83), the
        # zero-rate lookup in year fractions; with carry q the no-arbitrage
        # relation is S_t = F_t·D(t, T)·e^{q(T − t)}
        i = torch.arange(steps, dtype=torch.float64, device=device)
        z_i = zero_rate_yf(market.rate, i * dT).to(device)
        to_spot = torch.exp((q - z_i) * (steps - i) * dT)
    for i in range(steps - 1, -1, -1):
        v_up = torch.roll(value, -1, dims=-1)  # v[j+1]; the last slot is never consumed
        continuation = step_discount * (p * v_up + (1.0 - p) * value)
        if not can_exercise:
            value = continuation
            continue
        nodes = forward * u ** (2.0 * j - i)
        if isinstance(payoff.underlying, Spot):
            nodes = to_spot[i] * nodes
        exercised = torch.maximum(continuation, payoff(nodes))
        # mask slot 0 is never set, so i = 0 stays pure continuation
        value = torch.where(ex_mask[i], exercised, continuation) if is_bermudan else exercised
    return CRRSolution(prob, method, value[..., 0])
