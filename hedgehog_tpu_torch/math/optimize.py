"""Box-bounded L-BFGS for calibration, and the IFT view of a solved optimum.

Port of ``hedgehog_tpu/math/optimize.py`` (the reference's Optimization.jl
L-BFGS behind calibration.jl:74-98).  Bounds go through the smooth sigmoid
reparameterisation ``x = lb + (ub − lb)·σ(y)``, so the inner optimiser runs
unconstrained.  The inner optimiser is the one ``optax.lbfgs()`` runs, step
for step: the two-loop L-BFGS direction over a memory of 10 pairs with the
scaled-identity start (the capped reciprocal gradient norm at the first
step), and the strong-Wolfe zoom line search of Nocedal and Wright
(Algorithms 3.5, 3.6) with the initial step 1, at most 20 steps, the
Hager–Zhang approximate decrease test and the safe-step fallback.  Values
and gradients come from ``torch.autograd.grad`` through the pricer, and the
value and gradient at an accepted step are reused by the next iteration.

The iterate, its gradient and the L-BFGS memory stay on the device of
``x0``; the line search's scalars are host float64 numbers, read once per
objective evaluation.  The loop is not differentiable; :func:`argmin_ift`
reattaches gradients to a solved optimum through the implicit function
theorem.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import device_of, f64

__all__ = ["minimize_lbfgs", "LBFGSResult", "argmin_ift"]

_MEMORY = 10
_LS_STEPS = 20
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL, _INTERVAL_THRESHOLD = 1e-4, 0.9, 1e-6, 1e-5
_LOGIT_CLIP = 1e-8


class _ArgminIFT(torch.autograd.Function):
    """Identity on ``x_star``; the backward solves the first-order
    condition ∇ₓf(x*, a) = 0 for dx*/da."""

    @staticmethod
    def forward(ctx, x_star, fun, *args):
        ctx.fun = fun
        ctx.save_for_backward(x_star, *args)
        return x_star.clone()

    @staticmethod
    def backward(ctx, g):
        x_star, *args = ctx.saved_tensors
        fun = ctx.fun
        n = x_star.numel()
        H = torch.func.hessian(fun, argnums=0)(x_star, *args).reshape(n, n)
        # SPD at an interior optimum; symmetrise, and a ridge guards the
        # nearly-converged case
        Hs = 0.5 * (H + H.T)
        Hs = Hs + 1e-12 * torch.eye(n, dtype=Hs.dtype, device=Hs.device) * torch.trace(Hs)
        L = torch.linalg.cholesky(Hs)
        w = torch.cholesky_solve(g.reshape(n, 1), L).reshape(x_star.shape)
        _, vjp_args = torch.func.vjp(
            lambda *a: torch.func.grad(fun, argnums=0)(x_star, *a), *args)
        return (torch.zeros_like(x_star), None, *vjp_args(-w))


def argmin_ift(fun: Callable, x_star, args):
    """Differentiable view of a solved optimum, by the implicit function
    theorem: with ``x_star ≈ argmin_x fun(x, args)`` from any optimiser,
    returns ``x_star`` (the same values) attached to the graph of ``args``
    through dx*/dargs = −H⁻¹·∂²f/∂x∂args, H = ∇²ₓf(x*, args): one dense
    Hessian and a Cholesky solve in the backward.  ``args`` is a tensor or a
    tuple of tensors.  The gradients are as good as the optimiser's
    residual ‖∇ₓf(x*)‖, and valid while the optimum is interior."""
    args = tuple(args) if isinstance(args, (tuple, list)) else (args,)
    return _ArgminIFT.apply(x_star.detach(), fun, *args)


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    loss: torch.Tensor
    iterations: int
    converged: bool
    evaluations: int = 0  # objective evaluations, each with its gradient


def _to_unconstrained(x, lb, ub):
    t = torch.clamp((x - lb) / (ub - lb), _LOGIT_CLIP, 1.0 - _LOGIT_CLIP)
    return torch.log(t) - torch.log1p(-t)


def _to_constrained(y, lb, ub):
    return lb + (ub - lb) * torch.sigmoid(y)


_f = np.float64


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where it has none (optax's ``_cubicmin``)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc**2 * v0 + (-(db**2)) * v1) / denom
    B = ((-(dc**3)) * v0 + db**3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = np.maximum(slope - (2 * _SLOPE_RTOL - 1.0) * slope_init,
                        value - value_init - _APPROX_DEC_RTOL * abs(value_init))
    err = np.maximum(np.minimum(approx, err), 0.0)
    return _f(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(abs(slope) - _CURV_RTOL * abs(slope_init), 0.0)
    return _f(np.inf) if np.isnan(err) else err


class _Ls:
    """The zoom line search's state (optax ``ZoomLinesearchState``)."""

    def __init__(self, value, grad, slope):
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = _f(0.0), value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = _f(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = _f(0.0), value, slope
        self.high, self.value_high, self.slope_high = _f(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = _f(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = _f(0.0), value, grad


def _zoom_linesearch(value_and_grad, params, updates, value, grad):
    """Step size along ``updates`` from ``params`` satisfying the strong
    Wolfe conditions (optax ``zoom_linesearch`` with its
    ``scale_by_zoom_linesearch`` defaults): (stepsize, value, grad) there."""
    s = _Ls(value, grad, _f(torch.dot(updates, grad).item()))

    def on_line(stepsize):
        v, g = value_and_grad(params + float(stepsize) * updates)
        return v, g, _f(torch.dot(g, updates).item())

    while not (s.done or s.failed):
        if not s.interval_found:
            # interval search, Algorithm 3.5
            new = _f(1.0) if s.count == 0 else 2.0 * s.stepsize
            v, g, sl = on_line(new)
            dec = _decrease_error(new, v, sl, s.value_init, s.slope_init)
            curv = _curvature_error(sl, s.slope_init)
            err = max(dec, curv)
            if dec <= 0.0:
                s.safe_stepsize, s.safe_value, s.safe_grad = new, v, g
            set_high = (dec > 0.0) or (v >= s.value and s.count > 0)
            set_low = (sl >= 0.0) and not set_high
            if set_low:
                s.low, s.value_low, s.slope_low = new, v, sl
                s.high, s.value_high, s.slope_high = s.stepsize, s.value, s.slope
            else:
                s.low, s.value_low, s.slope_low = s.stepsize, s.value, s.slope
                s.high, s.value_high, s.slope_high = new, v, sl
            s.interval_found = set_high or set_low or err <= 0.0
            s.done = bool(err <= 0.0)
            s.failed = (s.count + 1 >= _LS_STEPS) and not s.done
            s.cubic_ref, s.value_cubic_ref = s.low, s.value_low
        else:
            # zoom, Algorithm 3.6
            delta = abs(s.high - s.low)
            left, right = min(s.high, s.low), max(s.high, s.low)
            with np.errstate(all="ignore"):
                cubic = _cubicmin(s.low, s.value_low, s.slope_low, s.high, s.value_high,
                                  s.cubic_ref, s.value_cubic_ref)
                quad = _quadmin(s.low, s.value_low, s.slope_low, s.high, s.value_high)
            if left + 0.2 * delta < cubic < right - 0.2 * delta:
                new = cubic
            elif left + 0.1 * delta < quad < right - 0.1 * delta:
                new = quad
            else:
                new = (s.low + s.high) / 2.0
            v, g, sl = on_line(new)
            dec = _decrease_error(new, v, sl, s.value_init, s.slope_init)
            curv = _curvature_error(sl, s.slope_init)
            err = max(dec, curv)
            if dec <= 0.0 and v < s.safe_value:
                s.safe_stepsize, s.safe_value, s.safe_grad = new, v, g
            s.done = bool(err <= 0.0)
            set_high_mid = (dec > 0.0) or (v >= s.value_low)
            set_high_low = (sl * (s.high - s.low) >= 0.0) and not set_high_mid
            if set_high_mid or set_high_low:
                s.cubic_ref, s.value_cubic_ref = s.high, s.value_high
            else:
                s.cubic_ref, s.value_cubic_ref = s.low, s.value_low
            if set_high_mid:
                s.high, s.value_high, s.slope_high = new, v, sl
            elif set_high_low:
                s.high, s.value_high, s.slope_high = s.low, s.value_low, s.slope_low
            if not set_high_mid:
                s.low, s.value_low, s.slope_low = new, v, sl
            s.failed = (s.count + 1 >= _LS_STEPS
                        or (delta <= _INTERVAL_THRESHOLD and s.safe_stepsize > 0.0)) and not s.done
        s.count += 1
        s.stepsize, s.value, s.grad, s.slope = new, v, g, sl
        s.decrease_error, s.curvature_error = dec, curv
        if s.failed and (s.safe_stepsize > 0.0 or np.isinf(s.decrease_error)):
            s.stepsize, s.value, s.grad = s.safe_stepsize, s.safe_value, s.safe_grad
    return s.stepsize, s.value, s.grad


def _lbfgs_direction(grad, mem_dw, mem_du, rhos, count, identity_scale):
    """P_k·grad by the two-loop recursion over the memory ring (optax
    ``_precondition_by_lbfgs``; an empty slot has weight 0)."""
    idx = [(count % _MEMORY + k) % _MEMORY for k in range(_MEMORY)]
    vec = grad
    alphas = {}
    for i in reversed(idx):
        alphas[i] = rhos[i] * torch.dot(mem_dw[i], vec)
        vec = vec - alphas[i] * mem_du[i]
    vec = identity_scale * vec
    for i in idx:
        beta = rhos[i] * torch.dot(mem_du[i], vec)
        vec = vec + (alphas[i] - beta) * mem_dw[i]
    return vec


def minimize_lbfgs(fun: Callable, x0, lb=None, ub=None, *, max_iters: int = 200,
                   grad_tol: float = 1e-8, f_rel_tol: float = 1e-12) -> LBFGSResult:
    """Minimise ``fun(x)`` under optional elementwise box bounds.

    ``converged`` is True when an exit test fired before ``max_iters``: the
    gradient inf-norm below ``grad_tol``, or the objective's change between
    iterations at most ``f_rel_tol``·max(1, |f|); ``iterations`` counts the
    L-BFGS steps taken and ``evaluations`` the objective evaluations.
    Returns the best iterate seen, in the original (bounded) space."""
    dev = device_of(x0, lb, ub)
    x0 = f64(x0, device=dev).detach()
    shape = x0.shape
    x0 = x0.reshape(-1)
    bounded = lb is not None or ub is not None
    if bounded:
        lb = torch.broadcast_to(f64(-1e6 if lb is None else lb, device=dev), shape).reshape(-1)
        ub = torch.broadcast_to(f64(1e6 if ub is None else ub, device=dev), shape).reshape(-1)

        def obj(y):
            return fun(_to_constrained(y, lb, ub).reshape(shape))

        y = _to_unconstrained(x0, lb, ub)
    else:

        def obj(y):
            return fun(y.reshape(shape))

        y = x0
    evaluations = 0

    def value_and_grad(point):
        nonlocal evaluations
        evaluations += 1
        point = point.detach().requires_grad_(True)
        with torch.enable_grad():
            v = obj(point)
            (g,) = torch.autograd.grad(v, point)
        return _f(v.item()), g.detach()

    def value_only(point):
        nonlocal evaluations
        evaluations += 1
        with torch.no_grad():
            return _f(obj(point).item())

    n = y.numel()
    mem_dw = torch.zeros((_MEMORY, n), dtype=torch.float64, device=dev)
    mem_du = torch.zeros_like(mem_dw)
    rhos = torch.zeros(_MEMORY, dtype=torch.float64, device=dev)
    prev_params, prev_grad, count = torch.zeros_like(y), torch.zeros_like(y), 0
    ls_value, ls_grad = _f(np.inf), torch.zeros_like(y)

    best_y, best_val = y, value_only(y)
    prev_val, it, done = _f(np.inf), 0, False
    while not done and it < max_iters:
        if np.isfinite(ls_value):
            value, grad = ls_value, ls_grad
        else:
            value, grad = value_and_grad(y)
        # L-BFGS memory: the newest (Δparams, Δgrad) pair and its weight
        if count > 0:
            dw, du = y - prev_params, grad - prev_grad
            vdot = torch.dot(du, dw)
            slot = (count - 1) % _MEMORY
            mem_dw[slot], mem_du[slot] = dw, du
            rhos[slot] = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            denom = torch.dot(du, du)
            scale = torch.where(denom > 0.0, vdot / denom, torch.ones_like(vdot))
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        direction = -_lbfgs_direction(grad, mem_dw, mem_du, rhos, count, scale)
        prev_params, prev_grad, count = y, grad, count + 1
        step, ls_value, ls_grad = _zoom_linesearch(value_and_grad, y, direction, value, grad)
        y_new = y + float(step) * direction
        if value < best_val:
            best_y, best_val = y, value
        g_small = torch.max(torch.abs(grad)).item() < grad_tol
        f_stalled = abs(prev_val - value) <= f_rel_tol * max(1.0, abs(value))
        done = bool(g_small or f_stalled)
        y, prev_val, it = y_new, value, it + 1
    final_val = value_only(y)
    if not final_val <= best_val:
        y, final_val = best_y, best_val
    x_out = (_to_constrained(y, lb, ub) if bounded else y).reshape(shape)
    return LBFGSResult(x=x_out, loss=f64(final_val, device=dev), iterations=it, converged=done,
                       evaluations=evaluations)
