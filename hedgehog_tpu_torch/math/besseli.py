"""Complex-argument modified Bessel log I_ν(z), in complex128 torch.

Port of ``hedgehog_tpu/math/besseli.py`` (the reference's
SpecialFunctions.besseli at its Broadie-Kaya call sites,
src/distributions/heston.jl:174,207).  The argument comes in log-polar form
(|z|, θ) with θ an *unwrapped* (continuous) angle, the quantity the
reference's angle-unwrapping loop keeps (heston.jl:184-238).  Three regimes,
chosen per lane by computed error estimates:

1. the power series I_ν(z) = (z/2)^ν Σ_k (z²/4)^k/(k! Γ(ν+k+1)) by its
   multiplicative term recurrence, whose cancellation has the closed form
   log C = Re[η(ν,|z|) − η(ν,z)];
2. the uniform large-p expansion (p = √(ν²+z²)) with the Debye polynomials
   derived exactly at import time (DLMF 10.41.4) and the recessive
   exponential switched on across the Stokes line Im(2η) = νπ with Berry's
   error-function smoothing;
3. downward recurrence in the order, seeded by the uniform expansion at
   ν + 64, for the Airy wedge near the turning point z ≈ iν.

Accuracy: ≤ 3e-10 relative against ``scipy.special.iv`` over ν ∈ [−0.9,
200], |z| ∈ [0.05, 500], all angles (tests/test_torch_besseli.py).  The
function computes on the device of its tensor arguments; the H100 runs
complex128 natively, so the Broadie-Kaya sampler evaluates it on the card.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

from ..utils import device_of, f64

__all__ = ["log_besseli_complex"]

_N_UNIFORM = 12  # ũ_0..ũ_11


def _derive_debye_polys(nmax: int):
    """u_0 = 1;  u_{k+1}(t) = t²(1−t²)/2·u_k'(t) + (1/8)∫₀ᵗ(1−5s²)u_k(s)ds
    (DLMF 10.41.4), kept as exact rationals; returned as ũ_k coefficient
    lists in the variable x = t² (ũ_k(x) = u_k(t)/t^k)."""
    us = [{0: Fraction(1)}]
    for _ in range(nmax - 1):
        u = us[-1]
        du = {e - 1: c * e for e, c in u.items() if e > 0}
        new: dict = {}
        for e, c in du.items():  # t²(1−t²)/2 · u'
            new[e + 2] = new.get(e + 2, Fraction(0)) + c / 2
            new[e + 4] = new.get(e + 4, Fraction(0)) - c / 2
        for e, c in u.items():  # (1/8)∫(1−5s²)u ds
            new[e + 1] = new.get(e + 1, Fraction(0)) + c / Fraction(8 * (e + 1))
            new[e + 3] = new.get(e + 3, Fraction(0)) - 5 * c / Fraction(8 * (e + 3))
        us.append({e: c for e, c in new.items() if c != 0})
    # ũ_k(x): u_k powers are k, k+2, …, 3k → x-powers 0..k
    return [
        [float(u.get(k + 2 * m, Fraction(0))) for m in range(k + 1)]
        for k, u in enumerate(us)
    ]


_UTILDE = _derive_debye_polys(_N_UNIFORM)
# sum of |coeffs| of the first dropped term: the uniform branch's error scale
_UTILDE_NEXT_MAG = sum(abs(c) for c in _derive_debye_polys(_N_UNIFORM + 1)[-1])


def _ut(k: int, x: torch.Tensor) -> torch.Tensor:
    """ũ_k(x) by Horner (in place: the loops below run on (terms × paths)
    complex tensors, where a fresh tensor an operation costs the CPU more
    than the arithmetic)."""
    acc = torch.full_like(x, _UTILDE[k][-1])
    for c in reversed(_UTILDE[k][:-1]):
        acc.mul_(x).add_(c)
    return acc


def _eta(nu, z, p):
    return p + nu * torch.log(z / (nu + p))


_SERIES_ZMAX = 600.0  # |z| beyond which the term recurrence would overflow float64


def _log_iv_series(nu, z, n_terms: int):
    """Power series by the term recurrence u_{k+1} = u_k·(z²/4)/((k+1)(ν+k+1)),
    S = e^{−lnΓ(ν+1)}·Σu_k.  Returns (log I, log-relative-error estimate);
    lanes with |z| > 600 are clamped and flagged unusable (the other
    branches win there)."""
    za_true = torch.abs(z)
    clamped = za_true > _SERIES_ZMAX
    z = torch.where(clamped, z * (_SERIES_ZMAX / za_true), z)
    r = z * z / 4.0
    t = torch.ones_like(r)
    S = torch.ones_like(r)
    q = torch.empty_like(r)
    for k in range(n_terms - 1):
        torch.div(r, (k + 1.0) * (nu + k + 1.0), out=q)
        t.mul_(q)
        S.add_(t)
    log_S = torch.log(S) - torch.lgamma(f64(nu + 1.0, device=z.device))
    log_iv = nu * torch.log(z / 2.0) + log_S
    # the cancellation C = Σ|t_k|/|Σt_k| has the closed form
    # log C = Re[η(ν,|z|) − η(ν,z)]: never measured against the computed S
    za = torch.abs(z)
    pa = torch.sqrt(nu * nu + za * za)
    pz = torch.sqrt(nu * nu + z * z)
    log_cancel = torch.clamp(_eta(nu, za, pa) - torch.real(_eta(nu, z, pz)), min=0.0)
    log_trunc = torch.log(torch.abs(t) / torch.abs(S) + 1e-300)
    log_err = torch.maximum(log_cancel + math.log(3e-14), log_trunc)
    log_err = torch.where((log_cancel > 33.0) | clamped, math.inf, log_err)
    return log_iv, log_err


def _phase(nu):
    """i·e^{iπν}, a Python complex for a numeric order."""
    if isinstance(nu, torch.Tensor):
        return 1j * torch.exp(1j * math.pi * nu.to(torch.complex128))
    return 1j * complex(math.cos(math.pi * nu), math.sin(math.pi * nu))


def _log_iv_uniform(nu, z):
    """Uniform large-p expansion with the Berry-smoothed recessive
    exponential, for θ = arg z ∈ [0, π/2].  Returns (log I,
    log-relative-error estimate)."""
    p = torch.sqrt(nu * nu + z * z)
    x = (nu / p) ** 2
    eta = _eta(nu, z, p)
    p_inv = 1.0 / p
    pk = torch.ones_like(p)
    S1 = torch.zeros_like(p)
    S2 = torch.zeros_like(p)
    for k in range(_N_UNIFORM):
        term = _ut(k, x).mul_(pk)  # ũ_k(x)·p^-k
        S1.add_(term)
        S2.add_(term) if k % 2 == 0 else S2.sub_(term)
        pk.mul_(p_inv)
    # the Stokes line from the turning point z = iν sits at Im(2η) = νπ
    re2, im2 = 2.0 * torch.real(eta), 2.0 * torch.imag(eta)
    berry = (im2 - nu * math.pi) / torch.sqrt(2.0 * torch.abs(re2) + 1e-30)
    M = 0.5 * torch.special.erfc(-berry)
    # the recessive exponential exists only outside the monotonic region
    # (Re 2η ≳ 0); a stray small-M · huge-e^{−2η} product is spurious
    live = (M > 1e-14) & (re2 > -5.0)
    expo = torch.where(live, -2.0 * eta, torch.zeros_like(eta))
    rec = torch.where(live, M * torch.exp(expo), torch.zeros_like(eta))
    log_iv = (eta + torch.log(S1 + _phase(nu) * rec * S2)
              - 0.5 * math.log(2.0 * math.pi) - 0.5 * torch.log(p))
    log_p = torch.log(torch.abs(p) + 1e-300)
    log_err_trunc = math.log(_UTILDE_NEXT_MAG) - _N_UNIFORM * log_p
    # near the Stokes line the smoothed multiplier is uncertain by
    # ~½erfc(|berry|−1), a relative error ΔM·e^{−2Reη}; deep in the
    # monotonic region (re2 ≤ −5) the recessive is absent
    dM = 0.5 * torch.special.erfc(torch.abs(berry) - 1.0)
    log_err_stokes = torch.where(re2 > -5.0, torch.log(dM + 1e-300) - re2, -math.inf)
    return log_iv, torch.maximum(log_err_trunc, log_err_stokes)


_RECUR_SHIFT = 64  # order shift; the seeds have p' = √((ν+m)²+z²) ≥ m
_LOG_RESCALE = math.log(1e-120)
_RESCALE_EVERY = 8


def _log_iv_recurrence(nu, z, m: int = _RECUR_SHIFT):
    """Downward recurrence in the order, I_{k−1}(z) = (2k/z)·I_k(z) + I_{k+1}(z),
    seeded at orders ν+m, ν+m+1 by the uniform expansion (where p' is large
    even at ν's turning point).  I is the dominant solution as the order
    decreases, so the recurrence is stable.  Returns (log I_ν,
    log-relative-error estimate = seed error + roundoff)."""
    lo_a, err_a = _log_iv_uniform(nu + m + 1.0, z)  # I_{ν+m+1}
    lo_b, err_b = _log_iv_uniform(nu + m, z)  # I_{ν+m}
    s0 = torch.real(lo_b)
    a = torch.exp(lo_a - s0)  # higher order
    b = torch.exp(lo_b - s0)  # lower order
    shift = torch.zeros_like(s0)
    two_over_z = 2.0 / z
    new = torch.empty_like(b)
    tiny, one = torch.full_like(shift, 1e-120), torch.ones_like(shift)
    for i in range(m):  # a = I_{k+1}, b = I_k with k = ν+m−i
        k = nu + m - i
        torch.mul(two_over_z, k, out=new).mul_(b).add_(a)  # I_{k−1}
        a, b, new = b, new, a
        if i % _RESCALE_EVERY == _RESCALE_EVERY - 1 or i == m - 1:
            # rescale by 1e-120 where |I| passed 1e120, kept in the shift:
            # 8 steps grow |I| at most (2·(ν+m)/|z|)^8, far from overflow
            big = torch.abs(b) > 1e120
            scale = torch.where(big, tiny, one)
            a.mul_(scale)
            b.mul_(scale)
            shift = torch.where(big, shift - _LOG_RESCALE, shift)
    log_iv = torch.log(b) + shift + s0
    err = torch.maximum(err_a, err_b) + math.log(float(m))
    return log_iv, err


def _log_iv_upper(nu, z_abs, theta, n_terms: int):
    """log I_ν(|z|·e^{iθ}) for θ ∈ [0, π/2]: the branch of least estimated
    error."""
    z = torch.polar(z_abs, theta)
    lo_s, err_s = _log_iv_series(nu, z, n_terms)
    lo_u, err_u = _log_iv_uniform(nu, z)
    lo_r, err_r = _log_iv_recurrence(nu, z)
    best_su = torch.where(err_s <= err_u, lo_s, lo_u)
    err_su = torch.minimum(err_s, err_u)
    return torch.where(err_su <= err_r, best_su, lo_r)


def log_besseli_complex(nu, z_abs, theta, n_terms: int = 96) -> torch.Tensor:
    """log I_ν(z) for z = |z|·e^{iθ}, θ an *unwrapped* (continuous) angle,
    real order ν > −1; complex128 on the device of ``z_abs`` and ``theta``.

    Branch continuity: I_ν(z·e^{imπ}) = e^{imνπ}·I_ν(z), so the unwrapped
    angle is folded to the principal branch and the phase iν·(θ −
    θ_principal) re-applied, as the reference's ``log(besseli(ν, z)) +
    iν(θ_unwrapped − θ)`` (heston.jl:220-238).
    """
    dev = device_of(z_abs, theta, nu)
    if isinstance(nu, torch.Tensor):
        nu = f64(nu, device=dev)
    else:
        nu = float(nu)
    z_abs = torch.clamp(f64(z_abs, device=dev), min=1e-300)
    theta = f64(theta, device=dev)
    z_abs, theta = torch.broadcast_tensors(z_abs, theta)
    theta_p = theta - 2.0 * math.pi * torch.round(theta / (2.0 * math.pi))  # [−π, π]
    corr = 1j * nu * (theta - theta_p)

    neg = theta_p < 0.0
    b = torch.abs(theta_p)  # [0, π]
    refl = b > 0.5 * math.pi
    # θ ∈ (π/2, π]: z = z'·e^{iπ} with arg z' = b − π ∈ (−π/2, 0], so
    # I(z) = e^{iνπ}·I(z'), and z' folds by conjugation to the upper quadrant
    b_up = torch.where(refl, math.pi - b, b)  # [0, π/2]
    lo_up = _log_iv_upper(nu, z_abs, b_up, n_terms)
    lo_b = torch.where(refl, 1j * nu * math.pi + torch.conj(lo_up), lo_up)
    return corr + torch.where(neg, torch.conj(lo_b), lo_b)
