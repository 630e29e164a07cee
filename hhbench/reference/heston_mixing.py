"""Plain PyTorch reference of the Heston QE mixing estimator.

The estimator (Andersen's QE step for the variance, Romano–Touzi mixing
for the price): each antithetic pair draws (z, u) per step from the
Philox stream (``philox.mixing_draws``); the first path takes (z, u), its
twin (−z, 1 − u).  A path carries V, the trapezoid ∫V dt and
J = ∫√V dW_V = (V_t − V_0 − κθt + κ∫V dt)/σ; at an expiry each strike
closes by Black–Scholes conditional on (∫V, J).  The price of a point is
its discount times the mean over all 2·pairs paths.

The QE step keeps the guards that define the estimator where a lane
would divide by zero or leave its branch's domain: m ≥ 1e-20, ψ ≥ 1e-6,
p ≤ 1 − 1e-6, 1/β = m(ψ + 1)/2 capped at m·1e6, u clamped to
[1e-7, 1 − 1e-7], 1 − u ≥ 1e-20.  Φ is the exact normal CDF.  Everything runs in
``dtype`` (float64 for the reference, a lower precision for the control)
from parameters given as float64 scalars; the sums over paths are
float64.  Derivatives are autograd's (reverse mode for one price, forward
mode for a surface's Jacobian): the exact pathwise derivatives of the
same estimator, with zero slope where a guard binds.

Imports nothing of the program: the constants are computed here from
(κ, θ, σ, dt).
"""

from __future__ import annotations

import math

import torch

from . import philox

PSI_CRIT = 1.5
#: the market parameters, in the order of every greek vector and Jacobian
PARAMS = ("spot", "V0", "kappa", "theta", "sigma", "rho", "rate")


def _phi(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.erfc(-x * (1.0 / math.sqrt(2.0)))


def qe_step(v, z, u, th, e, c_s2_v, c_s2_c):
    """V → V' by the QE scheme with its guards.  Each branch is evaluated
    on inputs that keep it finite where it is not taken, so that autograd's
    zero weight on the other branch never meets an infinity."""
    m = th + (v - th) * e
    s2 = v * c_s2_v + c_s2_c
    m_safe = torch.clamp(m, min=1e-20)
    psi = torch.clamp(s2 / (m_safe * m_safe), min=1e-6)
    quad = psi <= PSI_CRIT
    # quadratic branch: V' = a (√b² + z)²
    psi_q = torch.where(quad, psi, torch.ones_like(psi))
    top = 2.0 / psi_q
    b2 = top - 1.0 + torch.sqrt(top * (top - 1.0))
    a = m / (1.0 + b2)
    v_quad = a * (torch.sqrt(b2) + z) ** 2
    # exponential branch: V' = log((1 − p)/(1 − u)) / β where u > p, else 0
    psi_e = torch.where(quad, torch.full_like(psi, 2.0), psi)
    p = torch.clamp((psi_e - 1.0) / (psi_e + 1.0), 0.0, 1.0 - 1e-6)
    inv_beta = m_safe * torch.clamp(0.5 * (psi_e + 1.0), max=1e6)
    u_safe = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    live = u_safe > p
    u_live = torch.where(live, u_safe, torch.zeros_like(u_safe))
    p_live = torch.where(live, p, torch.zeros_like(p))
    v_exp = torch.where(live, torch.log((1.0 - p_live) / torch.clamp(1.0 - u_live, min=1e-20))
                        * inv_beta, torch.zeros_like(v))
    return torch.where(quad, v_quad, v_exp)


def close(iv, j, rho, f_base, strike):
    """The conditional Black–Scholes call value of each path given (∫V, J)."""
    e_arg = rho * j - 0.5 * rho * rho * iv
    f_eff = f_base * torch.exp(e_arg)
    var = torch.clamp((1.0 - rho * rho) * iv, min=1e-10)
    sd = torch.sqrt(var)
    d1 = (torch.log(f_base / strike) + e_arg + 0.5 * var) / sd
    d2 = d1 - sd
    return f_eff * _phi(d1) - strike * _phi(d2)


class Market:
    """The seven parameters as 0-dim tensors of ``dtype`` on ``device``
    (cast from float64 leaves, so autograd reaches the leaves)."""

    def __init__(self, p: torch.Tensor, dtype):
        q = p.to(dtype)
        self.spot, self.v0, self.kappa, self.theta, self.sigma, self.rho, self.rate = q.unbind()

    def step_constants(self, dt: float):
        k, th, sig = self.kappa, self.theta, self.sigma
        e = torch.exp(-k * dt)
        c_s2_v = sig * sig * e * (1.0 - e) / k
        c_s2_c = th * sig * sig * (1.0 - e) ** 2 / (2.0 * k)
        return e, c_s2_v, c_s2_c


def _walk(mk: Market, draws, seg_dts, seg_steps, closes):
    """Walk each pair's two paths through the segments; at each segment's
    end call ``closes(i, iv, j)`` for each.  Returns the list of what
    ``closes`` returned, per segment and path of the pair."""
    shape = draws[0][0].shape
    groups = 2
    v = [mk.v0.expand(shape)] * groups
    iv = [torch.zeros(shape, dtype=mk.v0.dtype, device=mk.v0.device)] * groups
    j = list(iv)
    out = []
    step = 0
    for i, (dt, n) in enumerate(zip(seg_dts, seg_steps)):
        e, c_s2_v, c_s2_c = mk.step_constants(dt)
        inv_sigma = 1.0 / mk.sigma
        k_over_sigma = mk.kappa / mk.sigma
        ktd_over_sigma = mk.kappa * mk.theta * dt / mk.sigma
        for _ in range(n):
            z, u = draws[step]
            step += 1
            for g in range(groups):
                zg, ug = (z, u) if g == 0 else (-z, 1.0 - u)
                vn = qe_step(v[g], zg, ug, mk.theta, e, c_s2_v, c_s2_c)
                iv_step = (0.5 * dt) * (v[g] + vn)
                j[g] = j[g] + (vn - v[g]) * inv_sigma + iv_step * k_over_sigma - ktd_over_sigma
                iv[g] = iv[g] + iv_step
                v[g] = vn
        out.append([closes(i, iv[g], j[g]) for g in range(groups)])
    return out


def _chunks(total: int, chunk: int, device):
    for start in range(0, total, chunk):
        yield torch.arange(start, min(start + chunk, total), dtype=torch.int64, device=device)


def price_and_greeks(params, T: float, steps: int, strike: float, pairs: int, seed: int, *,
                     dtype=torch.float64, device="cpu", chunk: int = 2**21):
    """(price, greeks (7,)) of the European call: discount e^{−rT} times
    the mean over the 2·``pairs`` antithetic paths, and its gradient in
    ``PARAMS``, float64 on the host.  ``params`` is the 7 parameters in
    ``PARAMS`` order."""
    leaves = torch.tensor([float(x) for x in params], dtype=torch.float64, device=device,
                          requires_grad=True)
    price = torch.zeros((), dtype=torch.float64, device=device)
    grad = torch.zeros(7, dtype=torch.float64, device=device)
    dt = T / steps
    for pair in _chunks(pairs, chunk, device):
        mk = Market(leaves, dtype)
        draws = philox.mixing_draws(pair, steps, seed, dtype)
        f_base = mk.spot * torch.exp(mk.rate * T)
        vals = _walk(mk, draws, [dt], [steps],
                     lambda i, iv, j: close(iv, j, mk.rho, f_base, strike))[0]
        total = sum(x.to(torch.float64).sum() for x in vals)
        disc = torch.exp(-leaves[6] * T)
        part = disc * total / (2 * pairs)
        g, = torch.autograd.grad(part, leaves)
        price = price + part.detach()
        grad = grad + g
    return price.cpu(), grad.cpu()


def surface_and_jacobian(params, T_exp, seg_steps, strikes, pairs: int, seed: int, *,
                         dtype=torch.float64, device="cpu", chunk: int = 2**19):
    """(surface (n_exp, m), jacobian (n_exp, m, 7)) of the discounted
    call prices at the expiries ``T_exp`` (year fractions, increasing)
    and ``strikes``: one path per pair through the expiry segments
    (``seg_steps`` steps each, the step index running across them), every
    strike closed at each expiry; the Jacobian in ``PARAMS`` by forward
    mode.  float64 on the host."""
    bounds = [0.0, *T_exp]
    seg_dts = [(bounds[i + 1] - bounds[i]) / n for i, n in enumerate(seg_steps)]
    n_exp, m = len(T_exp), len(strikes)
    p0 = torch.tensor([float(x) for x in params], dtype=torch.float64, device=device)
    K = torch.tensor([float(k) for k in strikes], dtype=torch.float64, device=device)
    surface = torch.zeros(n_exp, m, dtype=torch.float64, device=device)
    jac = torch.zeros(n_exp, m, 7, dtype=torch.float64, device=device)
    for pair in _chunks(pairs, chunk, device):
        draws = philox.mixing_draws(pair, sum(seg_steps), seed, dtype)

        def sums(p):
            mk = Market(p, dtype)
            Kd = K.to(dtype)[:, None]

            def closes(i, iv, j):
                f_base = mk.spot * torch.exp(mk.rate * T_exp[i])
                y = close(iv[None, :], j[None, :], mk.rho, f_base, Kd)
                return y.to(torch.float64).sum(dim=1)

            rows = _walk(mk, draws, seg_dts, seg_steps, closes)
            disc = torch.exp(-p[6] * torch.tensor(T_exp, dtype=torch.float64, device=device))
            out = torch.stack([g0 + g1 for g0, g1 in rows]) * disc[:, None] / (2 * pairs)
            return out, out

        j_chunk, s_chunk = torch.func.jacfwd(sums, has_aux=True)(p0)
        surface += s_chunk
        jac += j_chunk
    return surface.cpu(), jac.cpu()

