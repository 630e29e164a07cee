"""Broadie-Kaya exact Heston terminal sampling, batched, on the card.

Port of ``hedgehog_tpu/distributions/broadie_kaya.py`` (reference
src/distributions/heston.jl:76-300 and sample_from_cf.jl), the three steps:

  1. V_T ~ c·χ'²(d, λ) as the Poisson(λ/2)-mixed gamma 2c·Γ(d/2 + N)
     (heston.jl:125-133): the count by CDF inversion over a window of the
     Poisson law wide enough for any rate (:func:`poisson_window`), the
     gamma by the exact-mixing scheme's saddlepoint quantile with the
     small-shape boost (``models.heston_exact.boosted_gamma``), both in
     :func:`noncentral_chisq_from_draws`;
  2. ∫₀ᵀ V dt given (V0, V_T) by Fourier inversion of its conditional CF
     (heston.jl:150-212): the Bessel angle unwrap threads through the series
     as the CF's carry, the series' step comes from ∫V's exact conditional
     moments, and the CDF is inverted by a fixed-trip bisection
     (distributions/sample_from_cf.py);
  3. log S_T given (V_T, ∫V) conditionally Gaussian (heston.jl:278-300);
     antithetic pairs share V_T and ∫V and negate the normal (:296-297).

The JAX package runs this sampler on the host under a TPU (complex128 does
not lower there); the H100 runs complex128 and float64 natively, so every
step here runs on the card, in chunks of pairs that bound the memory of the
(terms × pairs) complex series.

Random numbers: Philox-4x32-10 keyed on (seed, device_id), counter (pair &
0xffffffff, pair >> 32, block, 0), as every PRNG path of the port
(math/counter_rng.py).  Block 0 is the exact-mixing segment block: words
0, 1 → Box-Muller (z_gam, z_x), word 2 → u_pois, word 3 → u_boost, so V_T
is drawn as ``HestonExactMixing`` draws its first segment's V; block 1,
word 0 → the inversion's uniform (w + ½)·2^-32.  A non-antithetic path i
draws pair i's blocks.  The draws cannot match JAX's (``jax.random.poisson``
and ``jax.random.gamma``), so agreement with JAX is in law.

Broadie-Kaya is a sampler and price oracle: the market is read as host
floats and a derivative through its draws raises (the JAX package's device
route gives none either).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import scipy.special
import torch

from ..market.inputs import forward_spot, market_yearfrac
from ..market.rate_curve import zero_rate
from ..math.besseli import log_besseli_complex
from ..math.counter_rng import uniform_from_bits
from ..models.heston_exact import boosted_gamma, cir_exact_constants, iv_cond_moments
from ..ops.autograd_limits import no_derivative
from ..ops.hh_device import box_muller, philox_block
from ..utils import device_of, f64, resolve_device
from .sample_from_cf import cdf_series_weights, invert_cdf_series, open_uniform

__all__ = [
    "BK_CHUNK_PAIRS",
    "BKPaths",
    "log_besseli_complex",
    "PoissonWindow",
    "poisson_window",
    "noncentral_chisq_from_draws",
    "sample_noncentral_chisq",
    "heston_integrated_variance_weights",
    "heston_integrated_variance_cf",
    "integrated_variance_moments",
    "broadie_kaya_draws",
    "broadie_kaya_paths",
    "bk_close",
    "broadie_kaya_terminal_prices",
]

_MASK32 = 0xFFFFFFFF

#: pairs per chunk: the (cf_terms × pairs) complex128 series of a chunk of
#: 2^17 pairs at 128 terms is 256 MB a tensor
BK_CHUNK_PAIRS = 2**17

#: half-width of the Poisson window in standard deviations, and its floor:
#: the mass outside [μ − 12√μ − 8, μ + 12√μ + 32] is below 1e-30 for any μ
_WINDOW_SD, _WINDOW_LO, _WINDOW_HI = 12.0, 8.0, 32.0

_GRAD_REASON = (
    "HestonBroadieKaya is a sampler and price oracle: its draws read the market as host "
    "floats and have no derivative (the JAX package gives none on its device route either); "
    "take greeks through HestonExactMixing or HestonQE")


class PoissonWindow(NamedTuple):
    """The Poisson(μ) CDF at k0, k0 + 1, …, k0 + trips, a float64 tensor,
    where [k0, k0 + trips] holds all but 1e-30 of the mass."""

    k0: int
    cdf: torch.Tensor

    def counts(self, u: torch.Tensor) -> torch.Tensor:
        """Counts N = min{k ≥ k0 : u ≤ F(k)} as float64 on the device of
        ``u`` (a search of the table: no trip cap)."""
        return self.k0 + torch.searchsorted(self.cdf, u.contiguous()).to(torch.float64)


def poisson_window(mu: float, device="cpu") -> PoissonWindow:
    """The :class:`PoissonWindow` of a host rate μ of any size, its table on
    ``device`` (k0 = 0 below μ ≈ 160).  The table starts from the exact
    lower tail Q(k0, μ) and the log pmf at k0, and accumulates p_{k+1} =
    p_k·(μ/(k+1)) as ``models.heston_exact.poisson_inv`` does, so from
    k0 = 0 its counts are that function's."""
    mu = float(mu)
    if not mu >= 0.0 or not math.isfinite(mu):
        raise ValueError(f"Poisson rate must be finite and nonnegative, got {mu}")
    sd = math.sqrt(mu)
    k0 = max(0, int(math.floor(mu - _WINDOW_SD * sd - _WINDOW_LO)))
    trips = int(math.ceil(2.0 * _WINDOW_SD * sd + _WINDOW_LO + _WINDOW_HI))
    if k0 == 0:
        p = float(torch.exp(-f64(mu)))
        below = 0.0
    else:
        p = math.exp(-mu + k0 * math.log(mu) - math.lgamma(k0 + 1.0))
        below = float(scipy.special.gammaincc(k0, mu))  # P(N < k0)
    cdf = np.empty(trips + 1, dtype=np.float64)
    acc = below + p
    cdf[0] = acc
    for i in range(1, trips + 1):
        p = p * (mu / (k0 + i))
        acc = acc + p
        cdf[i] = acc
    return PoissonWindow(k0, torch.as_tensor(cdf, device=resolve_device(device)))


def noncentral_chisq_from_draws(window: PoissonWindow, d_half, scale, dr) -> torch.Tensor:
    """Step 1 on a pair's draws: scale·χ'²(d, λ) = 2·scale·Γ(d/2 + N), N
    from ``window`` (the Poisson(λ/2) law) at ``dr.u_pois``, the gamma by
    ``boosted_gamma`` at (``dr.z_gam``, ``dr.u_boost``)."""
    return 2.0 * scale * boosted_gamma(d_half + window.counts(dr.u_pois), dr.z_gam, dr.u_boost)


class _Draws(NamedTuple):
    u_pois: torch.Tensor
    z_gam: torch.Tensor
    u_boost: torch.Tensor
    z_x: torch.Tensor
    u_inv: torch.Tensor


def broadie_kaya_draws(pair: torch.Tensor, seed: int, device_id: int = 0) -> _Draws:
    """The draws of each pair (int64 tensor of global pair indices):
    (u_pois, z_gam, u_boost, z_x, u_inv), float64, in the layout above."""
    w = philox_block(pair, 0, seed & _MASK32, device_id & _MASK32)
    z_gam, z_x = box_muller(w[0], w[1], dtype=torch.float64)
    u_pois = uniform_from_bits(w[2]).double()
    u_boost = uniform_from_bits(w[3]).double()
    u_inv = open_uniform(philox_block(pair, 1, seed & _MASK32, device_id & _MASK32)[0])
    return _Draws(u_pois, z_gam, u_boost, z_x, u_inv)


def sample_noncentral_chisq(key, d, lam, n: int, *, device_id: int = 0, device="cuda"):
    """``n`` draws of χ'²(d, λ) = 2·Γ(d/2 + N), N ~ Poisson(λ/2), float64 on
    ``device`` (replaces Distributions.NoncentralChisq, heston.jl:131):
    ``key`` is the integer seed, draw i takes pair i's block 0."""
    device = resolve_device(device)
    pair = torch.arange(n, dtype=torch.int64, device=device)
    return noncentral_chisq_from_draws(poisson_window(float(lam) / 2.0, device), float(d) / 2.0,
                                       1.0, broadie_kaya_draws(pair, int(key), device_id))


def heston_integrated_variance_cf(VT, V0, kappa, theta_lt, sigma, T):
    """The conditional CF of ∫₀ᵀ V dt given (V0, V_T) as a *stateful* CF
    ``cf(a, theta_prev) -> (φ(a), theta_unwrapped)`` (heston.jl:150-212),
    over the paths of ``VT``; the parameters are numbers.

    ``a`` is a frequency (a number, or one per path) or a (B, *batch) block
    of increasing frequencies; in a block the angle unwrap is a cumulative
    sum of the wrapped angle steps, chained off the carry.  Returns (cf,
    carry0), the carry the unwrapped Bessel angle."""
    VT = f64(VT, device=device_of(VT))
    d = 4.0 * kappa * theta_lt / sigma**2
    nu = 0.5 * d - 1.0
    em = -math.expm1(-kappa * T)  # 1 − e^{−κT}
    zeta_k = em / kappa
    eta_k = kappa * (1.0 + math.exp(-kappa * T)) / em
    nu_k = torch.sqrt(V0 * VT) * 4.0 * kappa * math.exp(-0.5 * kappa * T) / (sigma**2 * em)
    log_I_k = log_besseli_complex(nu, nu_k, torch.zeros_like(nu_k))

    def cf(a, theta_prev):
        a_c = torch.as_tensor(a, dtype=torch.complex128, device=VT.device)
        block = a_c.ndim > nu_k.ndim
        gamma = torch.sqrt(kappa**2 - 2.0 * sigma**2 * a_c * 1j)
        e_g = torch.exp(-gamma * T)
        zeta_g = (1.0 - e_g) / gamma
        eta_g = gamma * (1.0 + e_g) / (1.0 - e_g)
        nu_g = (torch.sqrt(V0 * VT) * 4.0 * gamma * torch.exp(-0.5 * gamma * T)
                / (sigma**2 * (1.0 - e_g)))
        first = torch.exp(-0.5 * (gamma - kappa) * T) * (zeta_k / zeta_g)
        second = torch.exp((V0 + VT) / sigma**2 * (eta_k - eta_g))
        theta = torch.angle(nu_g)
        if block:
            prev = torch.cat([torch.broadcast_to(theta_prev, theta[:1].shape), theta[:-1]], dim=0)
            delta = theta - prev
            delta = delta - 2.0 * math.pi * torch.round(delta / (2.0 * math.pi))
            theta_unwrapped = theta_prev + torch.cumsum(delta, dim=0)
            carry_out = theta_unwrapped[-1]
        else:
            delta = theta - theta_prev
            delta = delta - 2.0 * math.pi * torch.round(delta / (2.0 * math.pi))
            theta_unwrapped = theta_prev + delta
            carry_out = theta_unwrapped
        log_I_g = log_besseli_complex(nu, torch.abs(nu_g), theta_unwrapped)
        return first * second * torch.exp(log_I_g - log_I_k), carry_out

    carry0 = torch.angle(nu_k.to(torch.complex128))  # the real-axis start of the unwrap
    return cf, carry0


def integrated_variance_moments(VT, V0, kappa, theta_lt, sigma, T):
    """∫₀ᵀ V dt's conditional mean and std given (V0, V_T), in closed form:
    the first two derivatives of the Broadie-Kaya Laplace transform at 0
    through W = z·I_{ν+1}(z)/I_ν(z) + ν (``models.heston_exact.
    iv_cond_moments``), the Bessel ratio from :func:`log_besseli_complex`.

    They set the series' step h = π/(mean + 5·std) and the bisection's
    bracket.  The JAX package takes them from central differences of the CF
    at h0 = 1e-2 (sample_from_cf.jl:50-64), whose second difference divides
    the CF's rounding by h0²·var: ~1e-7 of the std at a year, and the whole
    signal at a week (∫V's mean 7.7e-4, σ = 0.1), where its std is noise, 3×
    too wide or clamped at 1e-6, 15× too narrow.  The
    closed form is exact at any expiry and well conditioned, so a pair's ∫V
    agrees between the card and the CPU to rounding (~1e-13 relative on an
    H100), where the central differences' noise moved it by 1e-8."""
    VT = f64(VT, device=device_of(VT))
    c = cir_exact_constants(kappa, theta_lt, sigma, T)
    nu = c["nu"]

    def ratio(z):
        zero = torch.zeros_like(z)
        return torch.exp(torch.real(log_besseli_complex(nu + 1.0, z, zero)
                                    - log_besseli_complex(nu, z, zero)))

    mean, var = iv_cond_moments(torch.full_like(VT, V0), VT, c, ratio=ratio)
    return mean, torch.sqrt(var)


def heston_integrated_variance_weights(VT, V0, kappa, theta_lt, sigma, T, n_terms: int,
                                       block_size=None, std_mult: float = 5.0):
    """Per-path CFSeries (mean, std, h, weights) of the ∫V CDF series, the
    generic ``cdf_series_weights`` over the Heston conditional CF:
    CDF(x) = h·x/π + Σ_{j=1..J} w_j·sin(h·j·x), w_j = (2/π)·Re φ(h·j)/j,
    h = π/(mean + std_mult·std) (sample_from_cf.jl:37, :75-96), the moments from
    :func:`integrated_variance_moments`.  By default the whole series is
    one block (one Bessel evaluation over (n_terms, paths)); any block size
    that divides ``n_terms`` gives the same weights."""
    cf, carry0 = heston_integrated_variance_cf(VT, V0, kappa, theta_lt, sigma, T)
    return cdf_series_weights(
        cf, n_terms, carry0=carry0, std_mult=std_mult,
        moments=integrated_variance_moments(VT, V0, kappa, theta_lt, sigma, T),
        block_size=n_terms if block_size is None else block_size)


class BKPaths(NamedTuple):
    """Per-pair draws of the sampler: V_T, ∫V, the close's normal z, and
    the terminal prices (n_groups, pairs)."""

    VT: torch.Tensor
    IV: torch.Tensor
    z: torch.Tensor
    ST: torch.Tensor


def _bk_params(prob):
    """The sampler's inputs as host floats, after the caller's input checks,
    and the market's tensors (their derivatives are refused)."""
    market = prob.market_inputs
    T = float(market_yearfrac(market, prob.payoff.expiry))
    if not T > 0.0:
        raise ValueError(f"Broadie-Kaya needs an expiry after the reference date (T = {T})")
    r = float(zero_rate(market.rate, prob.payoff.expiry))
    # dividend carry through the effective spot: exact for the terminal law
    S0 = float(forward_spot(market, T, device="cpu"))
    V0, kappa, theta, sigma, rho = (
        float(x.detach()) if isinstance(x, torch.Tensor) else float(x) for x in
        (market.V0, market.kappa, market.theta, market.sigma, market.rho))
    consumed = [x for x in (market.spot, market.V0, market.kappa, market.theta, market.sigma,
                            market.rho, getattr(market, "dividend_yield", None),
                            getattr(market.rate, "rate", None))
                if isinstance(x, torch.Tensor)]
    return (S0, V0, kappa, theta, sigma, rho, r, T), consumed


def bk_close(S0, V0, kappa, theta, sigma, rho, r, T, VT, IV, zs):
    """Step 3: S_T = exp(μ + sd·z) given (V_T, ∫V), μ = log S0 + rT − ∫V/2 +
    (ρ/σ)(V_T − V0 − κθT + κ∫V), sd² = (1 − ρ²)∫V (heston.jl:278-300)."""
    mu = (math.log(S0) + r * T - 0.5 * IV
          + (rho / sigma) * (VT - V0 - kappa * theta * T + kappa * IV))
    cond_std = torch.sqrt(torch.clamp((1.0 - rho**2) * IV, min=0.0))
    return torch.exp(mu + cond_std * zs)


def broadie_kaya_paths(prob, config, strat, key=None, device_id=0, *, device,
                       std_mult: float = 5.0, hi_mult: float = 11.0) -> BKPaths:
    """The sampler's per-pair (V_T, ∫V, z) and terminal prices on ``device``,
    (n_groups, trajectories) under antithetic pairing, in chunks of
    :data:`BK_CHUNK_PAIRS` pairs (per-pair values do not depend on the
    chunking).  ``std_mult`` and ``hi_mult`` set the series' window and the
    bisection's bracket as in ``sample_from_cf``."""
    from ..methods.montecarlo import Antithetic
    from ..ops.heston_kernel import seed_from_key

    (S0, V0, kappa, theta, sigma, rho, r, T), _ = _bk_params(prob)
    seed = seed_from_key(config, key)
    n = config.trajectories
    antithetic = isinstance(config.variance_reduction, Antithetic)
    c = cir_exact_constants(kappa, theta, sigma, T)
    window = poisson_window(V0 * c["lam_fac"], device)  # λ/2, the one rate of step 1
    out = []
    for start in range(0, n, BK_CHUNK_PAIRS):
        pair = torch.arange(start, min(n, start + BK_CHUNK_PAIRS), dtype=torch.int64,
                            device=device)
        dr = broadie_kaya_draws(pair, seed, device_id)
        # step 1: V_T, the exact CIR transition of HestonExactMixing's first segment
        VT = noncentral_chisq_from_draws(window, c["d_half"], c["cfac"], dr)
        # step 2: ∫V | V0, V_T by the CF series and its bisection
        series = heston_integrated_variance_weights(VT, V0, kappa, theta, sigma, T,
                                                    strat.cf_terms, std_mult=std_mult)
        IV = invert_cdf_series(dr.u_inv, series, iters=strat.inversion_iters, hi_mult=hi_mult)
        zs = torch.stack([dr.z_x, -dr.z_x]) if antithetic else dr.z_x[None]
        out.append((VT, IV, dr.z_x, bk_close(S0, V0, kappa, theta, sigma, rho, r, T, VT, IV, zs)))
    VT, IV, z, ST = zip(*out)
    return BKPaths(torch.cat(VT), torch.cat(IV), torch.cat(z), torch.cat(ST, dim=1))


def broadie_kaya_terminal_prices(prob, config, strat, key=None, device_id=0, *, device):
    """Terminal Heston prices (n_groups, trajectories) by exact Broadie-Kaya
    sampling on ``device``; a derivative through them raises
    NotImplementedError (a RuntimeError) naming the sampler."""
    _, consumed = _bk_params(prob)
    ST = broadie_kaya_paths(prob, config, strat, key, device_id, device=device).ST
    return no_derivative(ST, _GRAD_REASON, *consumed)
