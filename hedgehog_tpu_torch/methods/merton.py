"""Merton (1976) jump-diffusion closed form: the Poisson-weighted
Black-Scholes series.

Port of ``hedgehog_tpu/methods/merton.py``.  Conditional on N = n jumps
log S_T is normal, so

    price = Σ_{n<n_terms} e^{−λT}(λT)^n/n! · Black(F_n, K, σ_n, T)

with F_n = S0·e^{−qT}·e^{(r − λκ̄)T + n(μ_J + σ_J²/2)}, σ_n²T = σ²T + nσ_J²
and the market discount; digitals take the digital closed form per term.
``_check_series_terms`` raises when the series would drop more than 1e-8
of the Poisson mass (λT read on the host when it is a number; a tensor
intensity skips the check, as a traced one does in the JAX package).  The
series runs on ``device`` (the GPU unless the caller asks for the CPU), and
every market tensor keeps its autograd history.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.payoffs import DigitalOption, European, VanillaOption
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import market_yearfrac
from ..market.rate_curve import df
from ..models.dynamics import MertonJumpDynamics, merton_terminal_params
from ..utils import f64, resolve_device
from .black_scholes import bs_digital_price, bs_price

__all__ = ["MertonAnalytic"]


@dataclasses.dataclass(frozen=True)
class MertonAnalytic(AbstractPricingMethod):
    """Poisson-weighted Black-Scholes series of ``n_terms`` terms for
    European vanillas and cash-or-nothing digitals under ``MertonInputs``,
    computed on ``device``."""

    n_terms: int = 30
    device: str = "cuda"

    @property
    def dynamics(self):
        return MertonJumpDynamics()


def _check_series_terms(rate, n_terms: int) -> None:
    """Raise when the Poisson mass beyond ``n_terms`` is 1e-8 or more (a
    fixed 30-term series at λT ≳ 15 misprices by percents).  A tensor rate
    skips the check."""
    if isinstance(rate, torch.Tensor):
        return
    r = float(rate)
    p = math.exp(-r)
    cdf = p
    for k in range(1, n_terms):
        p *= r / k
        cdf += p
    if cdf < 1.0 - 1e-8:
        raise ValueError(
            f"MertonAnalytic(n_terms={n_terms}) truncates {1.0 - cdf:.2e} of "
            f"the Poisson mass at λT ≈ {r:.1f}; raise n_terms (≈ λT + 10√(λT)"
            f" + 15) or price via CarrMadan(MertonJumpDynamics())"
        )


def _series_weights(lam_T: torch.Tensor, n_terms: int):
    """(n, Poisson weights) over the series axis; λT = 0 puts all the mass
    on n = 0."""
    n = torch.arange(n_terms, dtype=torch.float64, device=lam_T.device)
    log_w = (-lam_T + n * torch.log(torch.clamp(lam_T, min=1e-300))
             - torch.lgamma(n + 1.0))
    return n, torch.where(lam_T > 0, torch.exp(log_w), (n == 0).double())


@register_solver(MertonAnalytic)
def _solve_merton_analytic(prob: PricingProblem, method: MertonAnalytic) -> AnalyticSolution:
    payoff = prob.payoff
    if not isinstance(payoff, (VanillaOption, DigitalOption)):
        raise TypeError(
            f"MertonAnalytic prices European VanillaOption/DigitalOption; "
            f"got {type(payoff).__name__}"
        )
    if not isinstance(payoff.exercise_style, European):
        raise TypeError("MertonAnalytic is European-only (use LSM/CRR for early exercise)")
    market = prob.market_inputs
    dev = resolve_device(method.device)
    lam_raw = market.jump_intensity
    _check_series_terms(lam_raw if isinstance(lam_raw, torch.Tensor)
                        else float(lam_raw) * market_yearfrac(market, payoff.expiry),
                        method.n_terms)
    log_s0, r, T, sigma, lam, mu_j, s_j, kbar = (
        x if isinstance(x, float) else x.to(dev)
        for x in merton_terminal_params(market, payoff.expiry))
    discount = df(market.rate, payoff.expiry).to(dev)
    n, w = _series_weights(lam * T, method.n_terms)
    # the n-conditional lognormal law (the tower law over the jump count)
    sigma_n = torch.sqrt(sigma**2 + n * s_j**2 / T)
    fwd_n = torch.exp(log_s0 + (r - lam * kbar) * T + n * (mu_j + 0.5 * s_j**2))
    k = f64(payoff.strike, device=dev)[..., None]  # a strike grid over the series axis
    cp = payoff.call_put()
    if isinstance(payoff, DigitalOption):
        vals = bs_digital_price(fwd_n, k, sigma_n, T, 1.0, cp, payoff.cash)
    else:
        vals = bs_price(fwd_n, k, sigma_n, T, 1.0, cp)
    price = discount * torch.sum(w * vals, dim=-1)
    return AnalyticSolution(prob, method, price)
