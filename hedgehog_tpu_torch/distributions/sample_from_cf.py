"""Sample any nonnegative random variable from its characteristic function.

Port of ``hedgehog_tpu/distributions/sample_from_cf.py`` (reference
src/distributions/sample_from_cf.jl:27-135): the moment-matched frequency
step, the trapezoid Fourier CDF series with a fixed term count
(``truncation_error_estimate`` reports its tail), and the CDF inverted by a
fixed-trip bisection on [0, mean + hi_mult·std], batched over every draw.

The CF may be *stateful*, ``cf(a, carry) -> (φ(a), carry)``, with the carry
threaded through the evaluations in increasing-frequency order: the
Broadie-Kaya ∫V CF threads its Bessel angle unwrapping that way
(heston.jl:184-212).  Stateless CFs are wrapped.  The series hands the CF
a block of ``block_size`` consecutive frequencies a call, shape (B, *batch),
and the CF advances its carry a block at a time; any block size gives the
same series.

Everything assumes P(X ≥ 0) = 1 and φ(0) = 1, as the reference does.  The
functions compute on the device of the CF's values.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..math.counter_rng import philox4x32
from ..utils import f64

__all__ = [
    "CFSeries",
    "cdf_series_weights",
    "cdf_from_cf",
    "invert_cdf_series",
    "moments_from_cf",
    "open_uniform",
    "sample_from_cf",
    "truncation_error_estimate",
]

_MASK32 = 0xFFFFFFFF


class CFSeries(NamedTuple):
    """Precomputed Fourier-CDF series of a (batch of) nonnegative r.v.(s)."""

    mean: torch.Tensor
    std: torch.Tensor
    h: torch.Tensor  # frequency step, π/(mean + std_mult·std)
    weights: torch.Tensor  # (n_terms, *batch): (2/π)·Re φ(h·j)/j


def _as_stateful(cf: Callable, carry0: Optional[Any]):
    if carry0 is not None:
        return cf, carry0

    def wrapped(a, carry):
        return cf(a), carry

    return wrapped, 0.0


def _complex(phi) -> torch.Tensor:
    return torch.as_tensor(phi, dtype=torch.complex128)


def moments_from_cf(cf: Callable, carry0: Optional[Any] = None, h0: float = 1e-2):
    """(mean, std) by central differences of φ at ±h0
    (sample_from_cf.jl:50-64, with φ(0) = 1)."""
    cf, carry = _as_stateful(cf, carry0)
    phi_p, carry = cf(h0, carry)
    phi_m, _ = cf(-h0, carry)
    phi_p, phi_m = _complex(phi_p), _complex(phi_m)
    first = (phi_p - phi_m) / (2.0 * h0)
    second = (phi_p - 2.0 + phi_m) / h0**2
    mean = torch.real(-1j * first)
    var = torch.clamp(torch.real(-second - mean**2), min=1e-12)
    return mean, torch.sqrt(var)


def cdf_series_weights(
    cf: Callable,
    n_terms: int,
    carry0: Optional[Any] = None,
    std_mult: float = 5.0,
    h0: float = 1e-2,
    block_size: int = 1,
    moments=None,
) -> CFSeries:
    """The trapezoid Fourier-CDF series of a nonnegative r.v.

    ``cf`` is ``cf(a) -> φ(a)`` or, with ``carry0`` given,
    ``cf(a, carry) -> (φ(a), carry)`` (state threaded in series order).
    φ may be batched; mean, std, h and the weights then carry the batch
    shape; h = π/(mean + std_mult·std) (sample_from_cf.jl:37), the moments
    by :func:`moments_from_cf` at ``h0`` (the JAX function takes the keyword
    and differences at 1e-2 whatever it is given), or ``moments = (mean,
    std)`` where the caller knows them.
    The CF gets ``block_size`` increasing frequencies a call, shape
    (B, *batch); ``n_terms`` must divide by it.
    """
    cf_s, carry = _as_stateful(cf, carry0)
    mean, std = moments_from_cf(cf_s, carry, h0) if moments is None else moments
    h = math.pi / (mean + std_mult * std)
    if n_terms % block_size != 0:
        raise ValueError(f"n_terms ({n_terms}) must divide by block_size ({block_size})")
    js = torch.arange(1, n_terms + 1, dtype=torch.float64, device=h.device)
    blocks = []
    for j_blk in js.reshape(n_terms // block_size, block_size):
        # a block of frequencies h·j, h possibly batched: (B, *batch)
        a_blk = h * j_blk.reshape((block_size,) + (1,) * h.ndim)
        phi, carry = cf_s(a_blk, carry)
        phi = _complex(phi)
        blocks.append((2.0 / math.pi) * torch.real(phi)
                      / j_blk.reshape((block_size,) + (1,) * (phi.ndim - 1)))
    return CFSeries(mean, std, h, torch.cat(blocks, dim=0))


def cdf_from_cf(x, series: CFSeries) -> torch.Tensor:
    """CDF(x) = h·x/π + Σⱼ wⱼ·sin(h·j·x)  (sample_from_cf.jl:75-96).

    ``x`` may carry extra leading axes over the series' batch shape (a grid
    of abscissae per law); the weights broadcast accordingly."""
    w_all = series.weights
    x = f64(x, device=w_all.device)
    n_terms = w_all.shape[0]
    batch = w_all.shape[1:]
    js = torch.arange(1, n_terms + 1, dtype=torch.float64, device=w_all.device).reshape(
        (n_terms,) + (1,) * x.ndim)
    w = w_all.reshape((n_terms,) + (1,) * (x.ndim - len(batch)) + tuple(batch))
    sines = torch.sin(series.h * x * js)
    return series.h * x / math.pi + torch.sum(w * sines, dim=0)


def invert_cdf_series(u, series: CFSeries, iters: int = 64, hi_mult: float = 11.0):
    """Fixed-trip bisection of CDF(x) = u on [0, mean + hi_mult·std]
    (replaces the reference's Newton→bisection→clamp chain, :105-135)."""
    u = f64(u, device=series.weights.device)
    lo = torch.zeros_like(u)
    hi = torch.broadcast_to(series.mean + hi_mult * series.std, lo.shape).to(lo.dtype)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf_from_cf(mid, series) < u
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def truncation_error_estimate(series: CFSeries, tail: int = 4) -> torch.Tensor:
    """Per-batch estimate of the absolute CDF error of the fixed truncation:
    the mean magnitude of the last ``tail`` weights (each dropped term moves
    the CDF by at most |wⱼ|)."""
    return torch.mean(torch.abs(series.weights[-tail:]), dim=0)


def open_uniform(bits: torch.Tensor) -> torch.Tensor:
    """One 32-bit word → the float64 centre of its cell, (w + ½)·2^-32:
    never 0 or 1, within [1e-12, 1 − 1e-12] (the JAX sampler's range)."""
    return (bits.to(torch.float64) + 0.5) * 2.0**-32


def sample_from_cf(
    key,
    cf: Callable,
    n: int,
    carry0: Optional[Any] = None,
    n_terms: int = 128,
    iters: int = 64,
    std_mult: float = 5.0,
    hi_mult: float = 11.0,
    *,
    device_id: int = 0,
):
    """Draw ``n`` iid samples of the nonnegative r.v. with CF ``cf``: build
    the series once, then invert n uniforms in one batched bisection.

    ``key`` is the integer seed of the port's Philox stream: draw i is word
    0 of the block at counter (i, 0, 0, 0) under key (seed, ``device_id``),
    through :func:`open_uniform` (JAX draws ``jax.random.uniform``, so the
    samples match it in law, not draw by draw).  A batched CF (one law per
    lane) takes ``n`` equal to its batch size."""
    series = cdf_series_weights(cf, n_terms, carry0=carry0, std_mult=std_mult)
    i = torch.arange(n, dtype=torch.int64, device=series.weights.device)
    zero = torch.zeros_like(i)
    w0, _, _, _ = philox4x32((i & _MASK32, i >> 32, zero, zero),
                             (int(key) & _MASK32, int(device_id) & _MASK32))
    return invert_cdf_series(open_uniform(w0), series, iters=iters, hi_mult=hi_mult)
