"""Batched, differentiable bracketed root finding.

Port of ``hedgehog_tpu/math/rootfind.py`` (the reference's Brent on a fixed
bracket, calibration.jl:143-144, and the Newton→bisection chain of
sample_from_cf.jl:105-135):

- the primal is a fixed-trip-count bisection, branchless and vectorised
  over any batch of brackets, run without a tape;
- the gradient comes from the implicit function theorem as in the JAX
  package: one Newton polish ``x* − f(x*)/f'(x*)`` on top of the stopped
  bisection root, whose derivative in any parameter θ captured in ``f`` is
  ``−f_θ/f_x`` at the root.  ``f(x*)`` and ``f'(x*)`` come from one
  ``torch.func.jvp`` and keep their autograd history in θ; the polish step
  itself is ``_NewtonPolish``, whose backward is that IFT gradient.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import device_of, f64

__all__ = ["bisect_root", "implicit_root", "implicit_root_full", "RootResult"]


class RootResult(NamedTuple):
    """Root plus the diagnostics the solve produced for free."""

    root: torch.Tensor
    converged: torch.Tensor  # a sign change existed on the initial bracket
    residual: torch.Tensor  # f at the bisection root (before the polish)


def _bisect_root_impl(f: Callable, lo, hi, iters: int):
    """Bisection core, off the tape: (root, bracketed mask)."""
    with torch.no_grad():
        dev = device_of(lo, hi)
        lo, hi = f64(lo, device=dev), f64(hi, device=dev)
        f_lo0 = f(lo)
        f_hi0 = f(hi)
        lo, hi = lo.to(f_lo0.device), hi.to(f_lo0.device)
        lo_c, hi_c, f_lo = lo, hi, f_lo0
        for _ in range(iters):
            mid = 0.5 * (lo_c + hi_c)
            f_mid = f(mid)
            go_left = torch.sign(f_mid) == torch.sign(f_lo)
            lo_c, f_lo, hi_c = (torch.where(go_left, mid, lo_c), torch.where(go_left, f_mid, f_lo),
                                torch.where(go_left, hi_c, mid))
        x = 0.5 * (lo_c + hi_c)
        # without a sign change: the endpoint with the smaller |f|
        bracketed = torch.sign(f_lo0) != torch.sign(f_hi0)
        better_endpoint = torch.where(torch.abs(f_lo0) < torch.abs(f_hi0), lo, hi)
        return torch.where(bracketed, x, better_endpoint), bracketed


def bisect_root(f: Callable, lo, hi, iters: int = 80):
    """Root of a scalar-monotone, vectorised ``f`` on [lo, hi] by bisection
    (primal only); ``lo``/``hi`` may be tensors (batched brackets).  80
    halvings shrink the bracket by 2^-80, past float64.  Without a sign
    change the endpoint with the smaller |f| comes back (the reference's
    clamp-with-warn, sample_from_cf.jl:124-127)."""
    return _bisect_root_impl(f, lo, hi, iters)[0]


class _NewtonPolish(torch.autograd.Function):
    """``x* − f/f'`` where the bracket held a sign change, ``x*`` elsewhere:
    the value stays at the root (f ≈ 0) and the backward carries the IFT
    gradient into ``f`` and ``f'`` (``x*`` is a constant)."""

    @staticmethod
    def forward(ctx, x_star, fx, f_prime, bracketed):
        safe = torch.where(torch.abs(f_prime) > 1e-300, f_prime, torch.ones_like(f_prime))
        ctx.save_for_backward(fx, safe, bracketed)
        return torch.where(bracketed, x_star - fx / safe, x_star)

    @staticmethod
    def backward(ctx, g):
        fx, safe, bracketed = ctx.saved_tensors
        g = torch.where(bracketed, g, torch.zeros_like(g))
        return None, -g / safe, g * fx / (safe * safe), None


def implicit_root(f: Callable, lo, hi, iters: int = 80):
    """Differentiable bracketed root: bisection primal, IFT gradients."""
    return implicit_root_full(f, lo, hi, iters).root


def implicit_root_full(f: Callable, lo, hi, iters: int = 80) -> RootResult:
    """:func:`implicit_root` plus the diagnostics that cost no extra ``f``
    evaluation: ``converged`` (a sign change existed on the bracket; without
    one the root is the clamp endpoint, calibration.jl:126-145) and
    ``residual`` (f at the bisection root, from the polish)."""
    root, bracketed = _bisect_root_impl(f, lo, hi, iters)
    fx, f_prime = torch.func.jvp(f, (root,), (torch.ones_like(root),))
    polished = _NewtonPolish.apply(root, fx, f_prime, bracketed)
    return RootResult(root=polished, converged=bracketed, residual=fx.detach())
