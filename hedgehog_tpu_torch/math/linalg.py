"""Small direct linear solvers in plain tensor arithmetic.

Port of ``hedgehog_tpu/math/linalg.py``:

- ``cholesky_solve_small``: Cholesky unrolled by column for the small SPD
  systems of the LSM normal equations ((degree + 1)² or the joint basis's,
  n ≤ ~15), with no host synchronisation on the card (a library Cholesky
  checks its factor on the host);
- ``tridiag_solve``: the Thomas algorithm (natural cubic spline
  coefficients, math/interpolation.py);
- ``tridiag_solve_pcr``: parallel cyclic reduction, ⌈log₂ n⌉ vectorised
  elimination stages instead of an n-step sweep.

All are differentiable (plain torch operations).  Leading axes batch.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cholesky_solve_small", "tridiag_solve", "tridiag_solve_pcr"]


def cholesky_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``A x = b`` for n = A.shape[-1] (A (..., n, n), b (..., n)),
    unrolled by column so a solve is ~15·n small operations whatever the
    batch.  A must be symmetric positive definite (callers add a ridge); a
    pivot is floored at 1e-300 before its square root."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    cols = []  # the columns of L, zero above the diagonal
    for j in range(n):
        s = A[..., :, j]
        if j:
            L = torch.stack(cols, dim=-1)  # (..., n, j)
            s = s - (L @ L[..., j, :, None])[..., 0]
        ljj = torch.sqrt(torch.clamp(s[..., j:j + 1], min=1e-300))
        cols.append(torch.where(rows >= j, s / ljj, 0.0))
    L = torch.stack(cols, dim=-1)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    y = []  # forward substitution L y = b
    for i in range(n):
        s = b[..., i]
        if i:
            s = s - (L[..., i, :i] * torch.stack(y, dim=-1)).sum(-1)
        y.append(s / diag[..., i])
    x = [None] * n  # back substitution Lᵀ x = y
    for i in reversed(range(n)):
        s = y[i]
        if i < n - 1:
            s = s - (L[..., i + 1:, i] * torch.stack(x[i + 1:], dim=-1)).sum(-1)
        x[i] = s / diag[..., i]
    return torch.stack(x, dim=-1)


def tridiag_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Thomas algorithm over the last axis: ``dl``/``du`` are the sub/super-
    diagonals (length n, ``dl[..., 0]`` and ``du[..., -1]`` ignored), ``d``
    the diagonal, ``b`` the right-hand side; leading axes of ``b`` batch."""
    n = d.shape[-1]
    c_prev = torch.zeros_like(b[..., 0])
    y_prev = torch.zeros_like(b[..., 0])
    cs, ys = [], []
    for i in range(n):
        dl_i = dl[..., i] if i > 0 else torch.zeros_like(d[..., 0])
        du_i = du[..., i] if i < n - 1 else torch.zeros_like(d[..., 0])
        denom = d[..., i] - dl_i * c_prev
        c_prev = du_i / denom
        y_prev = (b[..., i] - dl_i * y_prev) / denom
        cs.append(c_prev)
        ys.append(y_prev)
    x_next = torch.zeros_like(b[..., 0])
    xs = [None] * n
    for i in reversed(range(n)):
        x_next = ys[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def tridiag_solve_pcr(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Tridiagonal solve by parallel cyclic reduction over the last axis
    (same diagonal convention as :func:`tridiag_solve`).  Each stage
    eliminates the distance-s neighbours of every row at once,

        row_i ← row_i − (dl_i/d_{i−s})·row_{i−s} − (du_i/d_{i+s})·row_{i+s},

    out-of-range neighbours reading identity rows (d = 1, dl = du = b = 0),
    so after ⌈log₂ n⌉ stages the system is diagonal and x = b/d.  Stable for
    diagonally dominant systems."""
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    n = d.shape[-1]
    stages = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    idx = torch.arange(n, device=d.device)
    dl = torch.where(idx == 0, torch.zeros_like(dl), dl)
    du = torch.where(idx == n - 1, torch.zeros_like(du), du)

    def shift(a, s, fill):
        # a[..., i − s] (s > 0) or a[..., i + s] (s < 0), ``fill`` out of range
        valid = (idx >= s) if s > 0 else (idx < n + s)
        return torch.where(valid, torch.roll(a, s, dims=-1), torch.full_like(a, fill))

    s = 1
    for _ in range(stages):
        d_m, dl_m, du_m, b_m = (shift(a, s, f) for a, f in
                                ((d, 1.0), (dl, 0.0), (du, 0.0), (b, 0.0)))
        d_p, dl_p, du_p, b_p = (shift(a, -s, f) for a, f in
                                ((d, 1.0), (dl, 0.0), (du, 0.0), (b, 0.0)))
        alpha = -dl / d_m
        gamma = -du / d_p
        d = d + alpha * du_m + gamma * dl_p
        b = b + alpha * b_m + gamma * b_p
        dl = alpha * dl_m
        du = gamma * du_p
        s *= 2
    return b / d
