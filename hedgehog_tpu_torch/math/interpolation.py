"""1-D and nested 2-D interpolation with constant (clamped) extrapolation.

Port of ``hedgehog_tpu/math/interpolation.py`` (reference
src/market_inputs/rate_curve.jl:76, vol_surface.jl:37-46: LinearInterpolation
/ CubicSpline with ExtrapolationType.Constant).  Interpolants are functions
of the knot data: the cubic coefficients are recomputed at every evaluation,
so autograd (reverse and forward mode) flows from the knot values to the
output, which is what makes a lens-bumped curve or surface differentiable.
Results live on :func:`~hedgehog_tpu_torch.utils.device_of` the inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import device_of, f64
from .linalg import tridiag_solve

__all__ = ["interp1d", "interp2d_nested", "INTERP_KINDS"]

INTERP_KINDS = ("linear", "quadratic", "cubic")


def _natural_cubic_second_derivs(xs, ys):
    """Second derivatives M_i of the natural cubic spline through (xs, ys);
    ``ys`` may carry leading batch axes (one spline per row)."""
    h = xs[1:] - xs[:-1]
    zero = torch.zeros(ys.shape[:-1] + (1,), dtype=ys.dtype, device=ys.device)
    one = torch.ones_like(zero)
    batch = ys.shape[:-1]
    dl = torch.cat([zero, h[:-1].expand(batch + h[:-1].shape), zero], dim=-1)
    d = torch.cat([one, (2.0 * (h[:-1] + h[1:])).expand(batch + h[:-1].shape), one], dim=-1)
    du = torch.cat([zero, h[1:].expand(batch + h[1:].shape), zero], dim=-1)
    slope = (ys[..., 1:] - ys[..., :-1]) / h
    rhs = torch.cat([zero, 6.0 * (slope[..., 1:] - slope[..., :-1]), zero], dim=-1)
    return tridiag_solve(dl, d, du, rhs)


def _linear(xq, xs, ys):
    """``jnp.interp`` on queries already clamped to [xs0, xsN] (the same
    interval choice, so the same gradients at the knots)."""
    i = torch.clamp(torch.searchsorted(xs, xq.detach().contiguous(), right=True), 1,
                    xs.shape[0] - 1)
    df = ys[..., i] - ys[..., i - 1]
    dx = xs[i] - xs[i - 1]
    delta = xq - xs[i - 1]
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    return torch.where(dx0, ys[..., i - 1],
                       ys[..., i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)


def interp1d(x, xs, ys, kind: str = "linear"):
    """Evaluate a 1-D interpolant of (xs, ys) at x, clamping outside
    [xs0, xsN]: ``'linear'`` (LinearInterpolation), ``'quadratic'``
    (Lagrange through the three knots around the query interval) or
    ``'cubic'`` (natural CubicSpline).  ``x`` may be a scalar or any-shaped
    tensor; ``ys`` may carry leading axes, one interpolant per row, and the
    result then has shape ``ys.shape[:-1] + x.shape``.  A single knot
    returns ys[..., 0]."""
    dev = device_of(x, xs, ys)
    xs, ys, x = f64(xs, device=dev), f64(ys, device=dev), f64(x, device=dev)
    out_shape = ys.shape[:-1] + x.shape
    if xs.shape[0] == 1:
        return torch.broadcast_to(ys[..., 0].reshape(ys.shape[:-1] + (1,) * x.ndim), out_shape)
    xq = torch.clamp(x, xs[0], xs[-1]).reshape(-1)
    if kind == "linear" or (kind == "quadratic" and xs.shape[0] == 2):
        return _linear(xq, xs, ys).reshape(out_shape)
    if kind == "quadratic":
        i = torch.clamp(torch.searchsorted(xs, xq.detach().contiguous(), right=True) - 1, 1,
                        xs.shape[0] - 2)
        x0, x1, x2 = xs[i - 1], xs[i], xs[i + 1]
        l0 = (xq - x1) * (xq - x2) / ((x0 - x1) * (x0 - x2))
        l1 = (xq - x0) * (xq - x2) / ((x1 - x0) * (x1 - x2))
        l2 = (xq - x0) * (xq - x1) / ((x2 - x0) * (x2 - x1))
        return (ys[..., i - 1] * l0 + ys[..., i] * l1 + ys[..., i + 1] * l2).reshape(out_shape)
    if kind == "cubic":
        M = _natural_cubic_second_derivs(xs, ys)
        return _cubic_eval(xq, xs, ys, M).reshape(out_shape)
    raise ValueError(f"unknown interpolation kind {kind!r}; expected one of {INTERP_KINDS}")


def _cubic_eval(xq, xs, ys, M):
    """A natural cubic spline from its second derivatives M at clamped
    queries; ``ys``/``M`` may carry leading batch axes."""
    i = torch.clamp(torch.searchsorted(xs, xq.detach().contiguous(), right=True) - 1, 0,
                    xs.shape[0] - 2)
    x0, x1 = xs[i], xs[i + 1]
    h = x1 - x0
    t0 = (x1 - xq) / h
    t1 = (xq - x0) / h
    return (t0 * ys[..., i] + t1 * ys[..., i + 1]
            + ((t0**3 - t0) * M[..., i] + (t1**3 - t1) * M[..., i + 1]) * (h**2) / 6.0)


def interp2d_nested(x, y, x_vals, y_vals, values, kind_x: str = "linear", kind_y: str = "linear"):
    """Nested 1-D interpolation on a rectangular grid, clamped on both axes
    (reference Interpolator2D, vol_surface.jl:12-57): each x-row is
    interpolated along y first, then the resulting column along x.
    ``values`` has shape (len(x_vals), len(y_vals)); x/y broadcast.  Every
    query takes one batched pass per axis: the rows along y at all queries,
    then, since an interpolant is linear in its knot values, the column
    weighted by the x-interpolant of the unit rows at each query's x."""
    dev = device_of(x, y, x_vals, y_vals, values)
    x_vals = f64(x_vals, device=dev)
    xb, yb = torch.broadcast_tensors(f64(x, device=dev), f64(y, device=dev))
    rows = interp1d(yb.reshape(-1), y_vals, f64(values, device=dev), kind=kind_y)
    unit = torch.eye(x_vals.shape[0], dtype=torch.float64, device=dev)
    weights = interp1d(xb.reshape(-1), x_vals, unit, kind=kind_x)
    return torch.sum(weights * rows, dim=0).reshape(xb.shape)
