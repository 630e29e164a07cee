"""Exact-transition segmented mixing scheme for Heston, in float64 torch.

Port of ``hedgehog_tpu/models/heston_exact.py``.  Per
segment of length Δ:

1. V_{t+Δ} | V_t — the exact CIR transition as a Poisson(λ/2)-mixed
   Gamma(d/2 + N, 2c): the count by fixed-trip CDF inversion from one
   uniform, the gamma by the corrected saddlepoint quantile
   :func:`gamma_qtl` from one normal with the small-shape boost
   Γ(α) = Γ(α+1)·U^{1/α}.
2. ∫V | endpoints — a gamma draw matched to the exact conditional mean and
   variance from the Broadie–Kaya Laplace transform, through the Bessel
   ratio I_{ν+1}(z)/I_ν(z).
3. J = ∫√V dW_v follows from the CIR identity, and the payoff closes with
   the conditional Black–Scholes formula (methods/heston_exact_mixing.py).

Path-independent constants are computed with numpy in float64 when the
parameters are numbers (the kernels' host coefficients), and as float64
tensors when any parameter is a tensor, so autograd and forward-mode
tangents reach κ, θ, σ, Δ and V0.  The Poisson count is frozen (no
derivative), and :func:`lam_of_eta` differentiates by the implicit function
theorem, as the JAX package's ``custom_jvp`` does; the greeks then add the
count's likelihood-ratio score (methods/heston_exact_mixing.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import device_of, f64

__all__ = [
    "POISSON_KMAX",
    "poisson_kmax",
    "cir_exact_constants",
    "cir_exact_shared_coeffs",
    "cir_exact_kernel_coeffs",
    "bessel_ratio",
    "poisson_inv",
    "lam_of_eta",
    "gamma_qtl",
    "cir_exact_step_score",
    "iv_cond_moments",
    "iv_gamma_draw",
]

#: fixed trip counts of the branchless loops (see the JAX module)
POISSON_KMAX = 32
POISSON_KMAX_CAP = 64
CF_ITERS = 24
CF_SWITCH = 24.0


def _lib(*xs):
    """(module, values): torch and float64 tensors on one device when any
    input is a tensor (their autograd history and tangents kept), numpy and
    floats otherwise."""
    if any(isinstance(x, torch.Tensor) for x in xs):
        dev = device_of(*xs)
        return torch, tuple(f64(x, device=dev) for x in xs)
    return np, tuple(float(x) for x in xs)


def _host(x) -> float:
    """A parameter's value as a float, read without its autograd history."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def poisson_kmax(kappa, theta, sigma, dt, v0) -> int:
    """Poisson trip count with a provable tail: the smallest k with
    P(N > k) < 1e-8 at the rate λ(v_b)/2, v_b = m + 6s from the worst
    deterministic level max(V0, θ) (+1 margin, floored at 16).

    Raises ValueError when even ``POISSON_KMAX_CAP`` trips cannot meet the
    tail (λ/2 ≳ 40, e.g. vol-of-vol σ ≲ 0.05 at κΔ ~ 1): a clamped count
    would price with a large hidden bias.  The count is static: tensor
    inputs are read on the host, their history untouched.  The JAX
    version's ``default`` (its count under tracing) has no counterpart:
    inputs here are concrete."""
    k_, th, s_, d_, v = (_host(x) for x in (kappa, theta, sigma, dt, v0))
    e = np.exp(-k_ * d_)
    em = -np.expm1(-k_ * d_)
    cfac = s_ * s_ * em / (4.0 * k_)
    vw = max(v, th)
    m = vw * e + th * em
    s2 = vw * s_ * s_ * e * em / k_ + th * s_ * s_ * em * em / (2.0 * k_)
    v_b = m + 6.0 * np.sqrt(max(s2, 0.0))
    lam_half = e / (2.0 * cfac) * v_b
    p = np.exp(-lam_half)
    cdf, k = p, 0
    while cdf < 1.0 - 1e-8 and k < POISSON_KMAX_CAP:
        k += 1
        p *= lam_half / k
        cdf += p
    if cdf < 1.0 - 1e-8:
        raise ValueError(
            f"exact CIR transition needs a Poisson trip count beyond "
            f"{POISSON_KMAX_CAP} (rate λ/2 ≈ {lam_half:.0f} at the 6σ "
            f"variance bound; vol-of-vol σ={s_} is too small for κΔ="
            f"{k_ * d_:.2f}) — use HestonQE(conditional=True) for this "
            f"market, or FEWER exact segments (λ grows as Δ shrinks)"
        )
    return int(max(k + 1, 16))


def cir_exact_constants(kappa, theta, sigma, dt) -> dict:
    """Per-segment path-independent constants of the transition sampler and
    the conditional ∫V moments: floats from numbers, float64 tensors when
    any input is a tensor."""
    xp, (kappa, theta, sigma, dt) = _lib(kappa, theta, sigma, dt)
    e = xp.exp(-kappa * dt)
    em = -xp.expm1(-kappa * dt)
    cfac = sigma**2 * em / (4.0 * kappa)  # noncentral-χ² scale / 2
    d_half = 2.0 * kappa * theta / sigma**2  # half the χ² dof
    t2 = kappa * dt / 2.0
    s = xp.sinh(t2)
    c1 = xp.cosh(t2) / s  # coth
    c2 = 1.0 / (s * s)  # csch²
    return dict(
        kappa=kappa, sigma=sigma, dt=dt,
        e=e, cfac=cfac, d_half=d_half, nu=d_half - 1.0,
        t2=t2, c1=c1, c2=c2,
        z_fac=2.0 * kappa / (sigma**2 * s),  # z = z_fac·√(xy)
        lam_fac=e / (2.0 * cfac),  # λ/2 = lam_fac·V
        q=(1.0 - t2 * c1) / kappa,
        p_c=-(dt / kappa) * c1 + (dt * dt / 4.0) * (c1 * c1 + c2),
        inv_sig2=1.0 / sigma**2,
    )


def cir_exact_shared_coeffs(kappa, theta, sigma) -> dict:
    """Δ-independent kernel coefficients: (d_half, nu, nu2, an1-3, ad1-3 of
    the Bessel asymptotic series, m1f, s2f, inv_kappa); tensors when any
    input is a tensor."""
    _, (kappa, theta, sigma) = _lib(kappa, theta, sigma)
    d_half = 2.0 * kappa * theta / sigma**2
    nu = d_half - 1.0

    def asym_coeffs(m):
        mu = 4.0 * m * m
        return (mu - 1.0, (mu - 1.0) * (mu - 9.0) / 2.0,
                (mu - 1.0) * (mu - 9.0) * (mu - 25.0) / 6.0)

    an, ad = asym_coeffs(nu + 1.0), asym_coeffs(nu)
    sig2_over_k = sigma**2 / kappa
    return dict(
        d_half=d_half, nu=nu, nu2=nu * nu,
        an1=an[0], an2=an[1], an3=an[2], ad1=ad[0], ad2=ad[1], ad3=ad[2],
        m1f=-sig2_over_k, s2f=sig2_over_k * sig2_over_k,
        inv_kappa=1.0 / kappa,
    )


def cir_exact_kernel_coeffs(kappa, theta, sigma, dt) -> dict:
    """Δ-dependent kernel coefficients: (lam_fac, two_cfac, z_fac) and the
    Laplace-moment linear forms
    l1 = l1c − (x+y)·l1x + W·q and
    l2 = l2c + (x+y)·l2x + (z² + ν² − W − W²)·q² + W·p_c."""
    c = cir_exact_constants(kappa, theta, sigma, dt)
    kappa, dt = c["kappa"], c["dt"]
    t2, c1, c2 = c["t2"], c["c1"], c["c2"]
    inv_sig2 = c["inv_sig2"]
    return dict(
        lam_fac=c["lam_fac"], two_cfac=2.0 * c["cfac"], z_fac=c["z_fac"],
        l1c=1.0 / kappa - (dt / 2.0) * c1,
        l1x=(c1 - t2 * c2) * inv_sig2,
        l2c=-1.0 / kappa**2 + (dt * dt / 4.0) * c2,
        l2x=(dt * c2 - kappa * (dt * dt / 2.0) * c2 * c1) * inv_sig2,
        q=c["q"], q2=c["q"] * c["q"], p_c=c["p_c"],
    )


def bessel_ratio(nu, z: torch.Tensor) -> torch.Tensor:
    """I_{ν+1}(z)/I_ν(z): fixed-trip backward Perron continued fraction for
    z < 24, ratio of 4-term asymptotic series above (≤ 7e-5 relative)."""
    zc = torch.clamp(z, max=CF_SWITCH)
    r = torch.zeros_like(z)
    for m in range(CF_ITERS, 0, -1):
        r = zc / (2.0 * (nu + m) + zc * r)
    za = torch.clamp(z, min=CF_SWITCH)

    def _series(mm, zz):
        mu = 4.0 * mm * mm
        t = 8.0 * zz
        return (1.0 - (mu - 1.0) / t
                + (mu - 1.0) * (mu - 9.0) / (2.0 * t * t)
                - (mu - 1.0) * (mu - 9.0) * (mu - 25.0) / (6.0 * t * t * t))

    asym = _series(nu + 1.0, za) / _series(nu, za)
    return torch.where(z < CF_SWITCH, r, asym)


def poisson_inv(mu: torch.Tensor, u: torch.Tensor, kmax: int = POISSON_KMAX) -> torch.Tensor:
    """Poisson(μ) count by CDF inversion from one uniform, ``kmax`` trips."""
    p = torch.exp(-mu)
    cdf = p
    n = torch.zeros_like(mu)
    for k in range(1, kmax + 1):
        n = torch.where(u > cdf, float(k), n)
        p = p * (mu / k)
        cdf = cdf + p
    return n


# -- corrected saddlepoint gamma quantile (see the JAX module for the fit) --
GQ_SC = 7.5
GQ_NEWTON = 3
GQ_NEWTON_E1 = 2
GQ_P2 = (-1.76222600e-02, -2.93765073e-02, 2.14155241e-01, -2.72541844e-01,
         -8.34309734e-01, 1.90338824e+00, 1.60407347e+00, -5.14361722e+00,
         -1.51201354e+00, 7.20404411e+00, 3.65575150e-01, -5.21675853e+00,
         4.56357262e-01, 1.55081017e+00, -2.78395827e-01)
GQ_P3 = (5.39443911e-03, -1.14541171e-02, -3.45087047e-02, 1.30529962e-01,
         4.88113067e-02, -4.25758711e-01, 6.65709220e-02, 5.57799053e-01,
         -1.97560263e-01, -2.55404255e-01, 1.14194771e-01)


def _gq_horner(coeffs, t: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _lam_of_eta_primal(eta: torch.Tensor, trips: int) -> torch.Tensor:
    lam_s = 1.0 + eta * (1.0 + eta * (1.0 / 3.0 + eta * (1.0 / 36.0
            + eta * (-1.0 / 270.0 + eta * (1.0 / 4320.0)))))
    cube = torch.clamp((1.0 + eta / 3.0) ** 3, min=1e-12)
    lam = torch.where(eta >= 0.0, cube,
                      torch.maximum(cube, torch.exp(-1.0 - 0.5 * eta * eta)))
    tgt = 0.5 * eta * eta
    for _ in range(trips):
        f = lam - 1.0 - torch.log(torch.clamp(lam, min=1e-30)) - tgt
        den = torch.where(torch.abs(lam - 1.0) < 1e-12, 1e-12, lam - 1.0)
        lam = torch.clamp(lam - f * lam / den, min=1e-30)
    return torch.where(torch.abs(eta) < 0.5, lam_s, lam)


def _lam_of_eta_slope(eta: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """dλ/dη = η·λ/(λ − 1) from (1 − 1/λ)·dλ = η·dη; the 0/0 at η → 0 is
    closed by the series branch's own derivative (the primal's |η| < 0.5
    switch)."""
    dser = 1.0 + eta * (2.0 / 3.0 + eta * (1.0 / 12.0
           + eta * (-2.0 / 135.0 + eta * (1.0 / 864.0))))
    den = torch.where(torch.abs(lam - 1.0) < 1e-12, 1e-12, lam - 1.0)
    return torch.where(torch.abs(eta) < 0.5, dser, eta * lam / den)


class _LamOfEta(torch.autograd.Function):
    """λ(η) with the implicit derivative in both modes: ``backward`` for
    autograd, ``jvp`` for ``torch.func.jvp`` and forward-mode AD (the JAX
    package's ``custom_jvp``), never a derivative of the Newton trips."""

    @staticmethod
    def forward(eta, trips):
        return _lam_of_eta_primal(eta, trips)

    @staticmethod
    def setup_context(ctx, inputs, output):
        eta, _ = inputs
        ctx.save_for_backward(eta, output)
        ctx.save_for_forward(eta, output)

    @staticmethod
    def backward(ctx, grad):
        eta, lam = ctx.saved_tensors
        return grad * _lam_of_eta_slope(eta, lam), None

    @staticmethod
    def jvp(ctx, eta_t, _):
        eta, lam = ctx.saved_tensors
        return _lam_of_eta_slope(eta, lam) * eta_t


def lam_of_eta(eta: torch.Tensor, trips: int = GQ_NEWTON) -> torch.Tensor:
    """Solve λ − 1 − ln λ = η²/2 with sign(η) = sign(λ−1): series for
    |η| < 0.5, fixed-trip Newton from a cube/exp-tail start otherwise.
    Differentiable in η by the implicit function theorem (exact for the
    equation; the trips are not differentiated)."""
    return _LamOfEta.apply(eta, trips)


def gamma_qtl(alpha: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gamma(α, 1) quantile at Φ(z) by the corrected saddlepoint inversion."""
    inv_a = 1.0 / alpha
    eta0 = z * torch.sqrt(inv_a)
    lam0 = lam_of_eta(eta0, GQ_NEWTON_E1)
    w = lam0 - 1.0
    safe = torch.abs(eta0) >= 0.1
    w_s = torch.where(safe, w, 1.0)
    eta_s = torch.where(safe, eta0, 1.0)
    e1 = torch.where(
        safe,
        torch.log(torch.clamp(eta_s / w_s, min=1e-30)) / eta_s,
        -1.0 / 3.0 + eta0 / 36.0 + eta0 * eta0 / 1620.0,
    )
    t = torch.clamp(eta0 * (1.0 / GQ_SC), -1.0, 1.0)
    q2 = _gq_horner(GQ_P2, t)
    q3 = _gq_horner(GQ_P3, t)
    eta = eta0 + inv_a * (e1 + inv_a * (q2 + inv_a * q3))
    return alpha * lam_of_eta(eta)


def cir_exact_step_score(x, u_pois, z_gam, u_boost, c: dict, kmax: int = POISSON_KMAX):
    """One exact CIR transition V_t = x → V_{t+Δ} plus the Poisson score
    ``N·log λ − λ`` of the drawn count N, which is frozen (no derivative):
    summed over segments, the per-path log-likelihood whose gradient is the
    likelihood-ratio term pathwise AD misses.  λ is floored at 1e-30 inside
    the log only."""
    lam = x * c["lam_fac"]
    n = poisson_inv(lam.detach(), u_pois, kmax)
    log_lik = n * torch.log(torch.clamp(lam, min=1e-30)) - lam
    alpha = c["d_half"] + n
    u_safe = torch.clamp(u_boost, min=1e-300)
    g = gamma_qtl(alpha + 1.0, z_gam) * u_safe ** (1.0 / alpha)
    return 2.0 * c["cfac"] * g, log_lik


def iv_cond_moments(x, y, c: dict):
    """Exact conditional (mean, variance) of ∫_t^{t+Δ} V ds given the
    endpoints V_t = x, V_{t+Δ} = y, through W = z·I_{ν+1}(z)/I_ν(z) + ν."""
    kappa, dt = c["kappa"], c["dt"]
    t2, c1, c2 = c["t2"], c["c1"], c["c2"]
    z = c["z_fac"] * torch.sqrt(torch.clamp(x * y, min=1e-30))
    W = z * bessel_ratio(c["nu"], z) + c["nu"]
    q, p = c["q"], c["p_c"]
    xy = (x + y) * c["inv_sig2"]
    l1 = 1.0 / kappa - (dt / 2.0) * c1 - xy * (c1 - t2 * c2) + W * q
    l2 = (-1.0 / (kappa * kappa) + (dt * dt / 4.0) * c2
          + xy * (dt * c2 - kappa * (dt * dt / 2.0) * c2 * c1)
          + (z * z + c["nu"] ** 2 - W - W * W) * q * q + W * p)
    sig2 = c["sigma"] ** 2
    m1 = -(sig2 / kappa) * l1
    s2 = (sig2 / kappa) * (sig2 / kappa) * (l2 - l1 / kappa)
    return torch.clamp(m1, min=1e-12), torch.clamp(s2, min=1e-18)


def iv_gamma_draw(m1, s2, z):
    """Moment-matched gamma draw of ∫V | endpoints from one normal."""
    shape = m1 * m1 / s2
    scale = s2 / m1
    return torch.clamp(scale * gamma_qtl(shape, z), min=1e-12)
