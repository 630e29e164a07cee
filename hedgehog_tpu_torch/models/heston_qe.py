"""Andersen Quadratic-Exponential (QE) variance step for Heston, float64.

Port of ``hedgehog_tpu/models/heston_qe.py``: the per-step constants, the
QE draw V → V' (quadratic branch for ψ ≤ 1.5, exponential branch above),
the same draw with its hand-derived tangent coefficients, and the QE(-M)
step of (log S, V).  The conditional (Romano–Touzi mixing) estimator
(methods/heston_qe_mixing.py), the forward-mode greeks
(methods/mixing_greeks.py) and the QE-M terminal sampler
(methods/heston_qe_paths.py) build on it.  The f64 guards are the JAX
package's, unchanged (1e-30, 1e-12, 1 − 1e-9, 1e-300, the double-``where``
square-root guards that keep reverse-mode gradients finite through the dead
branch); the fp32 kernels and their twins use their own set
(ops/hh_device.py).
"""

from __future__ import annotations

import torch

__all__ = ["PSI_CRIT", "qe_step", "qe_v_step", "qe_v_step_with_coeffs", "qe_constants",
           "matched_gammas"]

PSI_CRIT = 1.5


def matched_gammas(kappa, dt):
    """Moment-matched ∫V weights (γ1, γ2) of one QE step: γ2 = (1 − ā)/(1 − e),
    γ1 = ā − γ2·e with e = exp(−κΔ), ā = (1 − e)/(κΔ); the Taylor series
    below |κΔ| = 1e-4, where the ratio cancels."""
    kdt = torch.as_tensor(kappa, dtype=torch.float64) * dt
    small = torch.abs(kdt) < 1e-4
    kdt_safe = torch.where(small, torch.ones_like(kdt), kdt)
    e = torch.exp(-kdt)
    one_m_e = -torch.expm1(-kdt_safe)
    abar = one_m_e / kdt_safe
    gamma2_exact = (1.0 - abar) / one_m_e
    gamma1_exact = abar - gamma2_exact * e
    gamma1 = torch.where(small, 0.5 - kdt / 12.0, gamma1_exact)
    gamma2 = torch.where(small, 0.5 + kdt / 12.0, gamma2_exact)
    return gamma1, gamma2


def qe_constants(kappa, theta, sigma, rho, r, dt, gamma1=0.5, gamma2=0.5,
                 *, match_gammas: bool = False) -> dict:
    """Per-step constants of the QE scheme as float64 tensors on the inputs'
    devices (numbers go to the CPU; autograd flows through tensor inputs)."""
    kappa, theta, sigma, rho, r = (torch.as_tensor(x, dtype=torch.float64)
                                   for x in (kappa, theta, sigma, rho, r))
    if match_gammas:
        gamma1, gamma2 = matched_gammas(kappa, dt)
    e = torch.exp(-kappa * dt)  # m = theta + (V - theta)·e
    c_s2_v = sigma**2 * e * (1.0 - e) / kappa
    c_s2_c = theta * sigma**2 * (1.0 - e) ** 2 / (2.0 * kappa)
    k_over = kappa * rho / sigma - 0.5
    K0 = -rho * kappa * theta * dt / sigma
    K1 = gamma1 * dt * k_over - rho / sigma
    K2 = gamma2 * dt * k_over + rho / sigma
    K3 = gamma1 * dt * (1.0 - rho**2)
    K4 = gamma2 * dt * (1.0 - rho**2)
    A = K2 + 0.5 * K4
    return dict(e=e, c_s2_v=c_s2_v, c_s2_c=c_s2_c, K0=K0, K1=K1, K2=K2, K3=K3, K4=K4, A=A,
                r_dt=r * dt, theta=theta)


def _qe_v_draw(v, z, u, c):
    """Variance-only QE transition V → V' plus the intermediates the QE-M
    martingale correction needs: (v_new, use_quad, a, b2, p, beta).  Both
    branches are evaluated and selected."""
    theta = c["theta"]
    m = theta + (v - theta) * c["e"]
    s2 = v * c["c_s2_v"] + c["c_s2_c"]
    m_safe = torch.clamp(m, min=1e-30)
    psi = torch.clamp(s2 / (m_safe * m_safe), min=1e-12)

    # quadratic branch (ψ ≤ 1.5); where ψ ≥ 2, t1 = 0 and the square roots'
    # arguments are guarded so that their infinite slope at 0 cannot reach a
    # reverse-mode gradient through the unselected side
    two_over_psi = 2.0 / psi
    t1 = torch.clamp(two_over_psi - 1.0, min=0.0)
    quad_live = t1 > 0.0
    t1_safe = torch.where(quad_live, t1, torch.ones_like(t1))
    b2 = torch.where(quad_live, t1 + torch.sqrt(two_over_psi * t1_safe), torch.zeros_like(t1))
    a = m / (1.0 + b2)
    b = torch.where(quad_live, torch.sqrt(torch.where(quad_live, b2, torch.ones_like(b2))),
                    torch.zeros_like(b2))
    v_quad = a * (b + z) ** 2

    # exponential branch (ψ > 1.5)
    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-12)
    beta = (1.0 - p) / m_safe
    u_safe = torch.clamp(u, 1e-12, 1.0 - 1e-12)
    v_exp = torch.where(u_safe <= p, torch.zeros_like(p),
                        torch.log((1.0 - p) / torch.clamp(1.0 - u_safe, min=1e-300)) / beta)

    use_quad = psi <= PSI_CRIT
    return torch.where(use_quad, v_quad, v_exp), use_quad, a, b2, p, beta


def qe_v_step(v, z, u, c):
    """One variance-only QE step V → V' (normal z, uniform u, constants c):
    the building block of the conditional mixing estimator."""
    return _qe_v_draw(v, z, u, c)[0]


def qe_v_step_with_coeffs(v, z, u, c):
    """The QE step plus its tangent coefficients: ``(vn, cm, cs)`` with
    ∂vn/∂x = cm·∂m/∂x + cs·∂s2/∂x for any input x, m = θc + (v − θc)e and
    s2 = v·c1 + c2 the two moment channels.  The primal repeats
    :func:`_qe_v_draw` exactly (same division forms and guards); clamped
    lanes (ψ or m at a floor, p at its clip, u ≤ p) get zero slope."""
    theta, e = c["theta"], c["e"]
    m = theta + (v - theta) * e
    s2 = v * c["c_s2_v"] + c["c_s2_c"]
    m_safe = torch.clamp(m, min=1e-30)
    psi_raw = s2 / (m_safe * m_safe)
    psi = torch.clamp(psi_raw, min=1e-12)
    inv_m = 1.0 / m_safe
    one, zero = torch.ones_like(psi), torch.zeros_like(psi)

    two_over_psi = 2.0 / psi
    t1r = two_over_psi - 1.0
    t1 = torch.clamp(t1r, min=0.0)
    quad_live = t1r > 0.0
    t1_safe = torch.where(quad_live, t1, one)
    sqw = torch.sqrt(two_over_psi * t1_safe)
    b2 = torch.where(quad_live, t1 + sqw, zero)
    a = m / (1.0 + b2)
    b = torch.where(quad_live, torch.sqrt(torch.where(quad_live, b2, one)), zero)
    q = b + z
    v_quad = a * q**2

    rb = a * inv_m  # 1/(1 + b2) to an ulp
    t_psi = -two_over_psi / psi
    rcp_prod = 1.0 / torch.clamp(sqw * torch.clamp(b, min=1e-150), min=1e-300)
    rcp_sqw = torch.clamp(b, min=1e-150) * rcp_prod
    rcp_sqb = sqw * rcp_prod
    db2_dpsi = t_psi * (1.0 + 0.5 * rcp_sqw * (t1 + two_over_psi))
    q_m = q * q * rb
    q_psi = torch.where(quad_live, a * (q * rcp_sqb - q_m) * db2_dpsi, zero)

    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-12)
    one_m_p = 1.0 - p
    beta = one_m_p / m_safe
    u_safe = torch.clamp(u, 1e-12, 1.0 - 1e-12)
    lterm = torch.log(one_m_p / torch.clamp(1.0 - u_safe, min=1e-300))
    e_live = torch.where(u_safe > p, one, zero)
    v_exp = torch.where(u_safe <= p, zero, lterm / beta)

    r1mp = 1.0 / one_m_p
    inv_beta = m_safe * r1mp
    p_live = torch.where(p < 1.0 - 1e-12, one, zero)
    rp1 = 1.0 / (psi + 1.0)
    e_m = e_live * lterm * r1mp  # ∂(L/β)/∂m = L/(1 − p)
    e_psi = e_live * p_live * (2.0 * rp1 * rp1) * inv_beta * (lterm - 1.0) * r1mp

    use_quad = psi <= PSI_CRIT
    vn = torch.where(use_quad, v_quad, v_exp)
    coef_m = torch.where(use_quad, q_m, e_m)
    coef_psi = torch.where(use_quad, q_psi, e_psi)
    coef_psi = torch.where(psi_raw > 1e-12, coef_psi, zero)  # ψ-floor plateau
    coef_m = torch.where(m > 1e-30, coef_m, zero)  # m-floor plateau

    cm = coef_m - 2.0 * psi * inv_m * coef_psi
    cs = coef_psi * inv_m * inv_m
    return vn, cm, cs


def qe_step(x, v, z_v, z_x, u, c, *, martingale_correction: bool = True):
    """One QE(-M) step (log S, V) → (log S', V') given normals z_v, z_x and a
    uniform u; ``c`` is :func:`qe_constants`' dict.  With the martingale
    correction K0* = −log M − (K1 + K3/2)·V, M the exact exponential moment
    of the V' draw (Andersen 2008 §4.3), so E[S'] = S·e^{rΔ} per step."""
    v_new, use_quad, a, b2, p, beta = _qe_v_draw(v, z_v, u, c)
    K1, K2, K3, K4, A = c["K1"], c["K2"], c["K3"], c["K4"], c["A"]
    if martingale_correction:
        safe_quad = torch.clamp(2.0 * A * a, max=1.0 - 1e-9)
        log_m_quad = A * b2 * a / (1.0 - safe_quad) - 0.5 * torch.log1p(-safe_quad)
        denom = torch.clamp(beta - A, min=1e-30)
        log_m_exp = torch.log(torch.clamp(p + beta * (1.0 - p) / denom, min=1e-300))
        k0_star = -torch.where(use_quad, log_m_quad, log_m_exp) - (K1 + 0.5 * K3) * v
    else:
        k0_star = c["K0"]
    var_x = torch.clamp(K3 * v + K4 * v_new, min=0.0)
    x_new = x + c["r_dt"] + k0_star + K1 * v + K2 * v_new + torch.sqrt(var_x) * z_x
    return x_new, v_new
