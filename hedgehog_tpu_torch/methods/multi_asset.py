"""Multi-asset pricing: spread, basket and rainbow options on correlated
Black-Scholes and Heston markets.

Port of ``hedgehog_tpu/methods/multi_asset.py``: Margrabe's exchange option
(exact at K = 0) and Kirk's spread approximation (K ≠ 0), the geometric
basket (exact: the Monte Carlo oracle), Stulz's two-asset min/max options
and their puts, and the correlated terminal samplers every multi-asset
Monte Carlo route shares: exact correlated lognormal draws on
:class:`MultiAssetBSInputs`, correlated conditional-QE Heston marginals on
:class:`MultiAssetHestonInputs`.  All float64 torch on the method's device;
market fields that are tensors keep their autograd history (per-asset
deltas, the correlation greek).  The Cholesky factors are computed in the
graph (n is a handful of assets).

Draws.  Under QMC the JAX package's points from the unsplit base key, so
every path equals JAX's: Black-Scholes ``_qmc_normals(base, 1, n, paths,
skip=point_offset)`` (dim i → asset i), Heston ``sobol_uniforms(base, paths,
steps·3·n, skip=point_offset)`` laid out (paths, steps, 3, n): per step n
variance normals, n QE uniforms, n orthogonal normals.  Under PRNG, Philox
(key (seed, device_id), counter (pair & 0xffffffff, pair >> 32, block,
tag)): Black-Scholes under ``MA_BS_TAG``, block b giving the normals of
assets 2b, 2b + 1 (Box–Muller of words 0, 1); Heston under
``MA_HESTON_TAG``, block s·n + i for asset i at step s, Box–Muller of words
0, 1 → (z_v, z⊥) and word 2 → the QE uniform (w + ½)·2^-32.  The antithetic
twin negates the normals and mirrors the uniforms.  JAX draws
``jax.random`` there, which the port does not replay: the two agree in law.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.payoffs import BasketOption, RainbowOption, SpreadOption
from ..core.problems import AnalyticSolution, MonteCarloSolution, PricingProblem
from ..market.inputs import MultiAssetHestonInputs, market_yearfrac
from ..market.rate_curve import df
from ..math.bvn import bvn_cdf
from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..models.heston_qe import qe_constants, qe_v_step
from ..ops.heston_kernel import seed_from_key
from ..ops.hh_device import box_muller, philox_block
from ..utils import f64, resolve_device
from .black_scholes import _tensors, bs_price
from .jump_mc import _u32
from .montecarlo import Antithetic
from .normal_lv_mc import _draws

__all__ = [
    "margrabe_price",
    "kirk_spread_price",
    "geometric_basket_price",
    "stulz_min_call_price",
    "rainbow_prices",
    "multi_asset_terminal_prices",
    "multi_asset_heston_terminal_prices",
    "solve_multi_asset_analytic",
    "solve_multi_asset_mc",
]

_MASK32 = 0xFFFFFFFF
#: Philox counter tags (the counter's last word) of the multi-asset streams
MA_BS_TAG = 0x6D616273  # "mabs"
MA_HESTON_TAG = 0x6D616865  # "mahe"

_ncdf = torch.special.ndtr


def margrabe_price(s1, s2, sigma1, sigma2, rho, T, cp) -> torch.Tensor:
    """Margrabe (1978) exchange option max(cp·(S¹ − S²), 0), exact under
    correlated GBM (carry-discounted spots; the rate cancels), effective vol
    σ² = σ₁² + σ₂² − 2ρσ₁σ₂."""
    s1, s2, sigma1, sigma2, rho, T, cp = _tensors(s1, s2, sigma1, sigma2, rho, T, cp)
    sig = torch.sqrt(torch.clamp(sigma1**2 + sigma2**2 - 2.0 * rho * sigma1 * sigma2, min=1e-30))
    v = sig * torch.sqrt(T)
    d1 = (torch.log(s1 / s2) + 0.5 * v * v) / v
    d2 = d1 - v
    return cp * (s1 * _ncdf(cp * d1) - s2 * _ncdf(cp * d2))


def kirk_spread_price(s1, s2, strike, sigma1, sigma2, rho, T, discount, cp) -> torch.Tensor:
    """Kirk's (1995) approximation for max(cp·(S¹ − S² − K), 0): F² + K taken
    lognormal, the weight w = F²/(F² + K) shrinking σ₂; exact at K = 0."""
    s1, s2, strike, sigma1, sigma2, rho, T, discount, cp = _tensors(
        s1, s2, strike, sigma1, sigma2, rho, T, discount, cp)
    f1 = s1 / discount
    f2 = s2 / discount
    fk = f2 + strike
    w = f2 / fk
    sig = torch.sqrt(torch.clamp(
        sigma1**2 + (w * sigma2) ** 2 - 2.0 * rho * sigma1 * w * sigma2, min=1e-30))
    v = sig * torch.sqrt(T)
    d1 = (torch.log(f1 / fk) + 0.5 * v * v) / v
    d2 = d1 - v
    return discount * cp * (f1 * _ncdf(cp * d1) - fk * _ncdf(cp * d2))


def geometric_basket_price(spots, weights, sigmas, corr, strike, T, discount,
                           cp) -> torch.Tensor:
    """Exact closed form of the geometric basket Π S_i^{w_i}: its log is
    Gaussian with mean Σw(ln S + (r − σ²/2)T) and variance (wσ)ᵀC(wσ)T, so
    the price is Black's at the matched lognormal forward."""
    s, w, sig, corr, strike, T, discount, cp = _tensors(spots, weights, sigmas, corr, strike, T,
                                                  discount, cp)
    r = -torch.log(discount) / torch.clamp(T, min=1e-30)
    mean = torch.sum(w * (torch.log(s) + (r - 0.5 * sig**2) * T))
    ws = w * sig
    var = torch.einsum("i,ij,j->", ws, corr, ws) * T
    f_geo = torch.exp(mean + 0.5 * var)
    # only the total volatility enters: vol = √var at T = 1
    return bs_price(f_geo, strike, torch.sqrt(torch.clamp(var, min=1e-30)), 1.0, discount, cp)


def stulz_min_call_price(s1, s2, sigma1, sigma2, rho, strike, T, discount) -> torch.Tensor:
    """Call on the minimum of two assets (Stulz 1982); s1/s2 are the
    carry-discounted spots S_i·e^{−q_i T}, strike > 0."""
    s1, s2, sigma1, sigma2, rho, strike, T, discount = _tensors(
        s1, s2, sigma1, sigma2, rho, strike, T, discount)
    sq = torch.sqrt(T)
    sig_s = torch.sqrt(sigma1**2 + sigma2**2 - 2.0 * rho * sigma1 * sigma2)
    d = (torch.log(s1 / s2) + 0.5 * sig_s**2 * T) / (sig_s * sq)
    y1 = (torch.log(s1 / (discount * strike)) + 0.5 * sigma1**2 * T) / (sigma1 * sq)
    y2 = (torch.log(s2 / (discount * strike)) + 0.5 * sigma2**2 * T) / (sigma2 * sq)
    rho1 = (rho * sigma2 - sigma1) / sig_s
    rho2 = (rho * sigma1 - sigma2) / sig_s
    return (s1 * bvn_cdf(y1, -d, rho1) + s2 * bvn_cdf(y2, d - sig_s * sq, rho2)
            - strike * discount * bvn_cdf(y1 - sigma1 * sq, y2 - sigma2 * sq, rho))


def rainbow_prices(s1, s2, sigma1, sigma2, rho, strike, T, discount):
    """(c_min, c_max, p_min, p_max) of the two-asset rainbow options from the
    Stulz min-call: (max − K)⁺ = (S1 − K)⁺ + (S2 − K)⁺ − (min − K)⁺, and
    put-call parity per extremum with D·E[min] = s1·Φ(−d) + s2·Φ(d − σ_s√T)."""
    s1, s2, sigma1, sigma2, rho, strike, T, discount = _tensors(
        s1, s2, sigma1, sigma2, rho, strike, T, discount)
    sq = torch.sqrt(T)
    sig_s = torch.sqrt(sigma1**2 + sigma2**2 - 2.0 * rho * sigma1 * sigma2)
    d = (torch.log(s1 / s2) + 0.5 * sig_s**2 * T) / (sig_s * sq)
    c_min = stulz_min_call_price(s1, s2, sigma1, sigma2, rho, strike, T, discount)
    c1 = bs_price(s1 / discount, strike, sigma1, T, discount, 1.0)
    c2 = bs_price(s2 / discount, strike, sigma2, T, discount, 1.0)
    c_max = c1 + c2 - c_min
    min_fwd = s1 * _ncdf(-d) + s2 * _ncdf(d - sig_s * sq)  # D·E[min]
    max_fwd = s1 + s2 - min_fwd
    p_min = c_min + strike * discount - min_fwd
    p_max = c_max + strike * discount - max_fwd
    return c_min, c_max, p_min, p_max


def _terms(prob, device):
    """(market, T, D, r, q) on ``device``: the zero rate to expiry, so
    forwards reprice exactly, and the per-asset carry."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    discount = df(market.rate, prob.payoff.expiry).to(device)
    r = -torch.log(discount) / max(T, 1e-30)
    q = f64(getattr(market, "dividend_yields", 0.0), device=device)
    return market, T, discount, r, q


def _base(config, key):
    return prng_key(config.seed) if key is None else key


def multi_asset_terminal_prices(prob: PricingProblem, config, key=None, point_offset: int = 0,
                                device_id: int = 0, *, device) -> torch.Tensor:
    """Exact correlated lognormal terminal draws (n_groups, paths, n_assets),
    n_groups = 2 under antithetic pairing; correlation through the Cholesky
    factor of the market's matrix."""
    market, T, _, r, q = _terms(prob, device)
    s0 = f64(market.spots, device=device) * torch.exp(-q * T)
    sig = f64(market.sigmas, device=device)
    n, paths = s0.shape[0], config.trajectories
    chol = torch.linalg.cholesky(f64(market.correlation, device=device))
    # block b (Sobol' dims 2b, 2b + 1) gives assets 2b, 2b + 1
    z = _draws(dataclasses.replace(config, steps=(n + 1) // 2), key, device_id, point_offset,
               device, tag=MA_BS_TAG, comps=2)  # (2, g, blocks, P)
    z = z.permute(1, 3, 2, 0).reshape(z.shape[1], paths, -1)[..., :n]
    zc = z @ chol.T
    return torch.exp(torch.log(s0) + (r - 0.5 * sig**2) * T + sig * (T ** 0.5) * zc)


def _heston_draws(config, key, point_offset, device_id, n: int, device):
    """(z_v, z⊥, u), each (steps, n_groups, paths, n)."""
    steps, paths = config.steps, config.trajectories
    if config.qmc:
        u = sobol_uniforms(_base(config, key), paths, steps * 3 * n, skip=point_offset,
                           device=device)
        u = torch.movedim(u.reshape(paths, steps, 3, n), 0, 2)  # (steps, 3, paths, n)
        z_v, us, z_p = torch.special.ndtri(u[:, 0]), u[:, 1], torch.special.ndtri(u[:, 2])
    else:
        seed = seed_from_key(config, key) & _MASK32
        pair = torch.arange(paths, dtype=torch.int64, device=device)
        zv_rows, zp_rows, u_rows = [], [], []
        for s in range(steps):
            zv, zp, uu = [], [], []
            for i in range(n):
                w = philox_block(pair, s * n + i, seed, device_id & _MASK32, MA_HESTON_TAG)
                a, b = box_muller(w[0], w[1], dtype=torch.float64)
                zv.append(a)
                zp.append(b)
                uu.append(_u32(w[2]))
            zv_rows.append(torch.stack(zv, dim=-1))
            zp_rows.append(torch.stack(zp, dim=-1))
            u_rows.append(torch.stack(uu, dim=-1))
        z_v, z_p, us = torch.stack(zv_rows), torch.stack(zp_rows), torch.stack(u_rows)
    if isinstance(config.variance_reduction, Antithetic):
        return (torch.stack([z_v, -z_v], dim=1), torch.stack([z_p, -z_p], dim=1),
                torch.stack([us, 1.0 - us], dim=1))
    return z_v[:, None], z_p[:, None], us[:, None]


def multi_asset_heston_terminal_prices(prob: PricingProblem, config, key=None,
                                       point_offset: int = 0, device_id: int = 0, *,
                                       device) -> torch.Tensor:
    """Correlated multi-asset Heston terminal draws (n_groups, paths, n_assets).

    Each asset's variance is QE-simulated (independent across assets); given
    the V paths each log S_i takes the mixing update with its own (IV_i, J_i),
    and the orthogonal drivers are drawn jointly with correlation
    C⊥_ij = R_ij/(ρ̄_i ρ̄_j), which reproduces the spot-spot correlation R.
    Within a step the cross-asset covariance freezes √(IV_i)·√(IV_j), the
    single-asset trapezoid's O(Δt)."""
    market, T, _, r, q = _terms(prob, device)
    s0, v0, kappa, theta, sig_v, rho = (
        f64(x, device=device) for x in (market.spots, market.V0s, market.kappas, market.thetas,
                                        market.sigma_vs, market.rhos))
    n, steps, paths = s0.shape[0], config.steps, config.trajectories
    dt = T / steps
    rho_bar = torch.sqrt(torch.clamp(1.0 - rho**2, min=1e-12))
    eye = torch.eye(n, dtype=torch.float64, device=device)
    c_perp = f64(market.correlation, device=device) / torch.outer(rho_bar, rho_bar)
    c_perp = torch.where(eye.bool(), 1.0, c_perp)
    # the jitter covers the −1e-10 eigenvalue slack the inputs' check accepts:
    # without it a boundary-feasible correlation gives NaN here
    chol = torch.linalg.cholesky(c_perp + 1e-9 * eye)
    c = qe_constants(kappa, theta, sig_v, rho, r - q, dt)
    ktd = kappa * theta * dt
    z_v, z_p, us = _heston_draws(config, key, point_offset, device_id, n, device)
    g = z_v.shape[1]
    x = torch.log(s0).expand(g, paths, n)
    v = v0.expand(g, paths, n)
    for s in range(steps):
        v_new = qe_v_step(v, z_v[s], us[s], c)
        iv = 0.5 * dt * (v + v_new)
        j = (v_new - v - ktd + kappa * iv) / sig_v
        zc = z_p[s] @ chol.T
        x = x + (r - q) * dt - 0.5 * iv + rho * j + rho_bar * torch.sqrt(
            torch.clamp(iv, min=1e-18)) * zc
        v = v_new
    return torch.exp(x)


def solve_multi_asset_analytic(prob: PricingProblem, method) -> AnalyticSolution:
    """The ``BlackScholesAnalytic`` branch of the multi-asset payoffs, on the
    method's device."""
    payoff = prob.payoff
    device = resolve_device(method.device)
    market, T, D, _, q = _terms(prob, device)
    cp = payoff.call_put()
    # carry-adjusted spots: exact for functions of the terminal joint law
    s = f64(market.spots, device=device) * torch.exp(-q * T)
    sig = f64(market.sigmas, device=device)
    corr = f64(market.correlation, device=device)
    if isinstance(payoff, SpreadOption):
        exchange = margrabe_price(s[0], s[1], sig[0], sig[1], corr[0, 1], T, cp)
        kirk = kirk_spread_price(s[0], s[1], payoff.strike, sig[0], sig[1], corr[0, 1], T, D,
                                 cp)
        # K = 0 gives Margrabe bit for bit (Kirk reduces to it there too)
        price = torch.where(f64(payoff.strike, device=device) == 0.0, exchange, kirk)
        return AnalyticSolution(prob, method, price)
    if isinstance(payoff, BasketOption):
        if not payoff.geometric:
            raise TypeError(
                "the arithmetic basket has no lognormal closed form; price "
                "by MonteCarlo (the geometric=True basket is the analytic "
                "oracle)"
            )
        price = geometric_basket_price(s, payoff.weights, sig, corr, payoff.strike, T, D, cp)
        return AnalyticSolution(prob, method, price)
    if isinstance(payoff, RainbowOption):
        if s.shape[0] != 2:
            raise TypeError(
                "the rainbow closed form is two-asset (Stulz); price wider "
                "baskets by MonteCarlo"
            )
        c_min, c_max, p_min, p_max = rainbow_prices(s[0], s[1], sig[0], sig[1], corr[0, 1],
                                                    payoff.strike, T, D)
        call = c_max if payoff.best else c_min
        put = p_max if payoff.best else p_min
        return AnalyticSolution(prob, method, call if cp > 0 else put)
    raise TypeError(f"no multi-asset closed form for {type(payoff).__name__}")


def solve_multi_asset_mc(prob: PricingProblem, method) -> MonteCarloSolution:
    """The ``MonteCarlo`` branch of the multi-asset payoffs: exact lognormal
    draws on :class:`MultiAssetBSInputs`, correlated conditional-QE Heston
    draws on :class:`MultiAssetHestonInputs`; antithetic pairs averaged."""
    payoff, market = prob.payoff, prob.market_inputs
    device = resolve_device(method.device)
    if isinstance(market, MultiAssetHestonInputs):
        samples = multi_asset_heston_terminal_prices(prob, method.config, device=device)
    else:
        samples = multi_asset_terminal_prices(prob, method.config, device=device)
    if isinstance(payoff, SpreadOption):
        vals = payoff(samples[..., 0], samples[..., 1])
    else:
        vals = payoff(samples)
    discount = df(market.rate, payoff.expiry).to(device)
    return MonteCarloSolution(prob, method, discount * torch.mean(vals, dim=(0, -1)), vals)
