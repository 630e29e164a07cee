"""Rough-Bergomi mixing kernels and their plain PyTorch twins: K14 values,
K15 the serving price, K16 the price + 6-greek vector, K17 the values VJP,
K18 its per-step variant under a forward-variance curve, K19 the
one-simulation smile; the differentiable view of the values (K14 forward,
K17 backward; under a ``ForwardVarianceCurve`` K18 backward) and the
adapter behind ``RoughBergomiMixing(use_kernel=True)``.

Port of ``hedgehog_tpu/ops/rbergomi_kernel.py``.  For tensors on a GPU the
work goes to ``csrc/rbergomi.cu``; for tensors on the CPU to the float32
twins below, which draw the same ξ and repeat the kernels' per-step
arithmetic (separately rounded products and sums, the polished reciprocal
of the mirror group).  The twins form the Volterra product with
``torch.matmul`` on the full factor; the kernels compute it themselves on
the entries the factor's structure leaves (models/rough_bergomi.py): the
diagonal of the ΔW rows, and for the Z row at t_{j+1} the increments'
columns 0..j and the Z columns 0..j, packed by ``_pack``.  All six take a
block of 64 pairs together a trip and form Z in register tiles of 4 pairs
× 4 rows over row chunks, with the same FMAs per pair in the same order,
so a pair's values have the same bits in every kernel.  The public
functions keep the JAX signatures, with ``device`` (default the GPU) in
place of ``interpret``;
``n_blocks·n_batches·2048`` antithetic pairs per price call, as the TPU's
tiles of 2048 paths.

Streams.  PRNG: pair i draws ξ rows 4b..4b+3 from Philox block b (words
0, 1 and 2, 3 through Box–Muller with the radius uniform in (0, 1),
``hh_device.box_muller_open``), key (seed, device_id); its antithetic
twin is −ξ, so its X is −X and its variance C_k·rcp(e^{ηZ}).  QMC: ξ row r
is Sobol' dim r of point ``point_offset + i`` of ``sobol_table(seed, 2n)``
through ``hh_device.sobol_normals_tile``: the TPU kernels' points, except
that the 32 top cells of a dimension, whose float32 uniform rounds to 1.0,
give Φ⁻¹((a + ½)·2^-30) (5.4 to 6.1) and not the TPU kernels' 11.46.  K15,
K16 and K19 walk the pairs ``[0, n_blocks·n_batches·2048)`` with one grid,
so K16's price and each of K19's strikes are K15's to the bit; K14 walks
the pairs ``[0, n_paths)`` on a grid of its own, and K17 and K18 replay
its stream one trip a block.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import f64, resolve_device
from .autograd_limits import (
    ForwardState,
    first_order_only,
    no_derivative,
    refuse_forward_mode,
)
from .cuda_lib import CudaKernel, check_tensor, launch_occupancy, require_cuda, resident_grid
from .heston_qe_greeks_kernel import cond_bs_partials
from .heston_qe_kernel import check_period, pair_chunks
from .hh_device import (
    SOBOL_BITS,
    box_muller_open,
    cond_bs_value,
    philox_block,
    rcp,
    sobol_masks,
    sobol_normals_tile,
    sobol_table,
)

__all__ = [
    "GREEK_ORDER_RB",
    "MAX_STRIKES",
    "RB_VALUES_KERNEL",
    "RB_PRICE_KERNEL",
    "RB_GREEKS_KERNEL",
    "RB_VJP_KERNEL",
    "RB_VJP_CURVE_KERNEL",
    "RB_SMILE_KERNEL",
    "RbGreekTrace",
    "RbTrace",
    "rb_inputs",
    "rb_vjp_inputs",
    "rb_inputs_from_trace",
    "rbergomi_mixing_values",
    "rbergomi_mixing_values_plain",
    "rbergomi_mixing_vanilla_price",
    "rbergomi_mixing_price_sum_plain",
    "rbergomi_mixing_price_and_greeks",
    "rbergomi_mixing_greek_sums_plain",
    "rbergomi_kernel_price_and_greeks",
    "rbergomi_mixing_vjp_sums_plain",
    "rbergomi_mixing_values_diff",
    "rbergomi_mixing_vjp_curve_sums_plain",
    "rbergomi_mixing_values_adapter",
    "rbergomi_mixing_smile_price",
    "rbergomi_mixing_smile_sums_plain",
    "rbergomi_kernel_smile",
]

GREEK_ORDER_RB = ("spot", "xi0", "eta", "rho", "hurst", "rate")
#: antithetic pairs per TPU program and batch: the unit of ``n_blocks``
PAIRS_PER_BLOCK = 2048
#: up to this many steps the kernels keep a pair's ξ column (2·steps rows,
#: padded to whole tiles) in shared memory, 64 pairs a block, beside the
#: 2·steps-row Sobol' table: 256 steps take 192 KB of the 227 KB a block may
#: use (each kernel adds an 8 KB chunk of Z rows, K18 two, K19 256 bytes a
#: strike).  Past it the kernels read the table from global memory and keep
#: the ξ columns in a slab of global scratch per block (csrc/rbergomi.cu
#: kStagedSteps, kWide)
STAGED_STEPS = 256
#: the pairs a block of the kernels holds, and the Z rows of one chunk of
#: the block-cooperative product (csrc/rbergomi.cu kThreads, kChunkRows;
#: K16's and K17's chunks are half as high, kHalfChunkRows)
BLOCK_PAIRS = 64
CHUNK_ROWS = 32
#: the shared memory a block may use on the H100
SMEM_PER_BLOCK = 227 * 1024
#: Z rows per register tile of the kernels' product (csrc/rbergomi.cu kTile)
TILE = 8
#: pairs per chunk of the summing twins (ξ is 0.5 GB a chunk at 64 steps)
PLAIN_CHUNK = 2**20
#: the kernels' parameter vector (csrc/rbergomi.cu RbParams): the middle
#: seven are hh_device's close constants
RB_NAMES = ("eta", "dt", "f_base", "strike", "rho", "rho2_half", "rho_bar2", "cp",
            "log_f_over_k", "inv_xi0", "h_eta", "inv_t")
#: per-step coefficient columns: C_k, √C_k, L[k, k], dL[k, k]/dH, ae_k, bh_k
COEF_COLS = 8
#: K19's strikes a launch: its per-thread sums live in shared memory, one
#: float a thread a strike (csrc/rbergomi.cu kMaxStrikes); a wider smile is
#: launched a chunk of MAX_STRIKES strikes at a time on the same pairs
MAX_STRIKES = 64
#: K18's rows after the n per-step ones: K17's without chain_xi0
CURVE_ROWS = ("eta", "hurst", "T", "w", "rho", "strike")
_MASK32 = 0xFFFFFFFF

_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
RB_VALUES_KERNEL = CudaKernel("hh_rb_values",
                              [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _U, _U, _LL, _P, _P])
RB_PRICE_KERNEL = CudaKernel("hh_rb_price",
                             [_P, _P, _P, _P, _P, _I, _LL, _I, _U, _U, _LL, _P, _P])
RB_GREEKS_KERNEL = CudaKernel("hh_rb_greeks",
                              [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _U, _U, _LL, _P, _P])
RB_VJP_KERNEL = CudaKernel("hh_rb_values_vjp",
                           [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _U, _U, _LL, _I, _P, _P])
RB_VJP_CURVE_KERNEL = CudaKernel("hh_rb_values_vjp_curve",
                                 [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _U, _U, _LL, _I, _P,
                                  _P])
RB_SMILE_KERNEL = CudaKernel("hh_rb_smile",
                             [_P, _P, _P, _P, _P, _I, _P, _I, _LL, _I, _U, _U, _LL, _P, _P])


def zcols(steps: int) -> int:
    """Columns of each packed product tile: the n − 1 consumed Z rows
    rounded up to whole tiles."""
    return -(-(steps - 1) // TILE) * TILE


class RbInputs(NamedTuple):
    """A kernel call's device inputs.  ``lpack``/``dpack``: the factor and
    its H derivative packed for the kernels' product; ``chol``/``cholh``:
    the same in full (2n, 2n) for the twins' ``torch.matmul``."""

    params: torch.Tensor
    coef: torch.Tensor
    lpack: torch.Tensor
    dpack: torch.Tensor | None
    chol: torch.Tensor
    cholh: torch.Tensor | None
    table: torch.Tensor | None
    steps: int


def _pack(m: np.ndarray, n: int, what: str) -> np.ndarray:
    """(tiles, zcols, 2·TILE) float32: for tile t and column c, the entries
    (m[n + j, c], then m[n + j, n + c]) of its TILE rows j = t·TILE + r;
    zero where c > j or j > n − 2.  Raises if ``m`` has weight outside the
    diagonal ΔW block and those two triangles (rows up to 2n − 2)."""
    cols = zcols(n)
    out = np.zeros((cols // TILE, cols, 2 * TILE), dtype=np.float32)
    keep = np.zeros((2 * n - 1, 2 * n), dtype=bool)
    keep[np.arange(n), np.arange(n)] = True
    for j in range(n - 1):
        t, r = divmod(j, TILE)
        out[t, : j + 1, r] = m[n + j, : j + 1]
        out[t, : j + 1, TILE + r] = m[n + j, n: n + j + 1]
        keep[n + j, : j + 1] = keep[n + j, n: n + j + 1] = True
    dropped = np.abs(m[: 2 * n - 1][~keep])
    if dropped.size and dropped.max() > 1e-9 * np.abs(m).max():
        raise ValueError(
            f"{what}: the kernels take the Volterra factor's structure (a diagonal ΔW block, "
            "no Z weight on later increments); this matrix has weight outside it")
    return out


def _rb_params(eta, dt, f_base, log_f_over_k, strike, cp, rho, inv_xi0=0.0, h_eta=0.0,
               inv_t=0.0) -> np.ndarray:
    """(12,) float32 parameter vector (layout ``RB_NAMES``): float64 host
    math, each entry cast once, as the TPU wrapper builds it."""
    eta, dt, f_base, log_f_over_k, strike, cp, rho = (
        float(x) for x in (eta, dt, f_base, log_f_over_k, strike, cp, rho))
    vals = dict(eta=eta, dt=dt, f_base=f_base, strike=strike, rho=rho, rho2_half=0.5 * rho**2,
                rho_bar2=1.0 - rho**2, cp=cp, log_f_over_k=log_f_over_k, inv_xi0=float(inv_xi0),
                h_eta=float(h_eta), inv_t=float(inv_t))
    return np.array([vals[k] for k in RB_NAMES], dtype=np.float64).astype(np.float32)


def _np64(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).astype(
        np.float64)


def rb_inputs(chol, coefs, eta, dt, f_base, log_f_over_k, strike, cp, rho, *, steps: int, seed,
              qmc: bool, device, chol_h=None, coefs_h=None, inv_xi0=0.0, h_eta=0.0,
              inv_t=0.0) -> RbInputs:
    """The device inputs of a kernel call from the host quantities: the
    factor (and for K16/K17 its H derivative and the (ae, bh) columns) cast
    to float32 once, as the TPU wrapper casts them."""
    n = int(steps)
    if n < 1:
        raise ValueError(f"the rough-Bergomi kernels need steps >= 1; got {n}")
    dev = resolve_device(device)
    L32 = _np64(chol).astype(np.float32)
    if L32.shape != (2 * n, 2 * n):
        raise ValueError(f"chol: expected shape {(2 * n, 2 * n)}, got {L32.shape}")
    c32 = _np64(coefs).astype(np.float32).reshape(n)
    coef = np.zeros((n, COEF_COLS), dtype=np.float32)
    coef[:, 0] = c32
    coef[:, 1] = np.sqrt(c32)
    coef[:, 2] = np.diagonal(L32)[:n]
    H32 = None
    if chol_h is not None:
        H32 = _np64(chol_h).astype(np.float32)
        coef[:, 3] = np.diagonal(H32)[:n]
        coef[:, 4] = _np64(coefs_h[0]).astype(np.float32)
        coef[:, 5] = _np64(coefs_h[1]).astype(np.float32)
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return RbInputs(
        params=as_dev(_rb_params(eta, dt, f_base, log_f_over_k, strike, cp, rho, inv_xi0, h_eta,
                                 inv_t)),
        coef=as_dev(coef), lpack=as_dev(_pack(L32, n, "chol")),
        dpack=None if H32 is None else as_dev(_pack(H32, n, "chol_h")),
        chol=as_dev(L32), cholh=None if H32 is None else as_dev(H32),
        table=as_dev(sobol_table(int(seed), 2 * n)) if qmc else None, steps=n)


# ---- the twins ----------------------------------------------------------------


def rb_xi(pair, rows: int, table, seed: int, device_id: int, point_offset: int) -> torch.Tensor:
    """(rows, len(pair)) float32 ξ of the pairs ``pair`` (int64 global
    indices) in the kernels' draw order: Sobol' dims 0..rows−1 through
    ``sobol_normals_tile`` when ``table`` is given, else Philox block b →
    rows 4b..4b+3."""
    if table is not None:
        return torch.stack(sobol_normals_tile(sobol_masks(pair + point_offset), table, range(rows)))
    out = []
    for b in range(-(-rows // 4)):
        w = philox_block(pair, b, seed & _MASK32, device_id & _MASK32)
        out += [*box_muller_open(w[0], w[1]), *box_muller_open(w[2], w[3])]
    return torch.stack(out[:rows])


def _products(inp: RbInputs, pair, seed, device_id, point_offset, tangent: bool):
    """(X, Ẋ or None, c, coef columns) of the pairs: X = L·ξ (and Ẋ = dL/dH·ξ)
    by ``torch.matmul`` in float32."""
    n = inp.steps
    xi = rb_xi(pair, 2 * n, inp.table, seed, device_id, point_offset)
    x = torch.matmul(inp.chol, xi)
    xd = torch.matmul(inp.cholh, xi) if tangent else None
    return x, xd, dict(zip(RB_NAMES, inp.params.unbind())), inp.coef.unbind(dim=1)


def _pair_factors(inp: RbInputs, pair, antithetic, seed, device_id, point_offset):
    """([(IV, J) of the + group, and of the mirror group when antithetic],
    the parameter dict): the left-point sums in the kernels' order and
    rounding."""
    n = inp.steps
    x, _, c, (C, sc, *_rest) = _products(inp, pair, seed, device_id, point_offset, False)
    ivp = jp = ivm = jm = torch.zeros_like(x[0])
    for k in range(1, n):
        ep = torch.exp(c["eta"] * x[n + k - 1])
        sep = torch.sqrt(ep)
        dw = x[k]
        ivp = ivp + C[k] * ep
        jp = jp + (sc[k] * sep) * dw
        if antithetic:
            ivm = ivm + C[k] * rcp(ep)
            jm = jm + (sc[k] * rcp(sep)) * dw
    s0dw0 = sc[0] * x[0]
    factors = [(c["dt"] * (C[0] + ivp), s0dw0 + jp)]
    if antithetic:
        factors.append((c["dt"] * (C[0] + ivm), -s0dw0 - jm))
    return factors, c


def _primal_pairs(inp: RbInputs, pair, antithetic, seed, device_id, point_offset):
    """(1 or 2, len(pair)) float32 values: the pairs' (IV, J), then the
    close."""
    factors, c = _pair_factors(inp, pair, antithetic, seed, device_id, point_offset)
    return torch.stack([cond_bs_value(iv, j, c) for iv, j in factors])


def rbergomi_mixing_values_plain(inp: RbInputs, n_paths: int, antithetic: bool, seed: int,
                                 device_id: int, point_offset: int) -> torch.Tensor:
    """Twin of K14: (1 or 2, n_paths) float32 undiscounted values."""
    pair = torch.arange(n_paths, dtype=torch.int64, device=inp.params.device)
    return _primal_pairs(inp, pair, antithetic, seed, device_id, point_offset)


def rbergomi_mixing_price_sum_plain(inp: RbInputs, total_pairs: int, seed: int, device_id: int,
                                    point_offset: int) -> torch.Tensor:
    """Twin of K15: the float64 sum over the pairs [0, total_pairs) of each
    pair's fp32 (value + antithetic value), in chunks of ``PLAIN_CHUNK``."""
    total = torch.zeros((), dtype=torch.float64, device=inp.params.device)
    for pair in pair_chunks(total_pairs, inp.params.device, PLAIN_CHUNK):
        vals = _primal_pairs(inp, pair, True, seed, device_id, point_offset)
        total = total + (vals[0] + vals[1]).to(torch.float64).sum()
    return total


def rbergomi_mixing_smile_sums_plain(inp: RbInputs, ks, total_pairs: int, seed: int,
                                     device_id: int, point_offset: int) -> torch.Tensor:
    """Twin of K19: (m,) float64 sums over the pairs [0, total_pairs) of each
    pair's fp32 (value + antithetic value) at each strike of ``ks`` ((m, 2)
    float32: log(f_base/K), K); each strike's sum is K15's twin's at that
    strike to the bit."""
    total = torch.zeros(ks.shape[0], dtype=torch.float64, device=inp.params.device)
    for pair in pair_chunks(total_pairs, inp.params.device, PLAIN_CHUNK):
        factors, c = _pair_factors(inp, pair, True, seed, device_id, point_offset)
        sums = []
        for log_f_over_k, strike in ks:
            ck = dict(c, log_f_over_k=log_f_over_k, strike=strike)
            plus, minus = (cond_bs_value(iv, j, ck) for iv, j in factors)
            sums.append((plus + minus).to(torch.float64).sum())
        total = total + torch.stack(sums)
    return total


def _group_rows(inp: RbInputs, x, xd, c, cols, sign: float, vjp: bool, per_step: bool = False):
    """One antithetic group's tangent rows, as the TPU kernels' ``group``:
    [y, chain_xi0, chain_eta, chain_H, w, y_rho] (greeks) or [chain_xi0,
    chain_eta, chain_H, chain_T, w, y_rho, y_K] (VJP), fp32; with
    ``per_step`` (the VJP under a curve, K18) the n rows d/d ln C_k =
    y_IV·dt·P_k + y_J/2·s_k·ΔW_k in place of chain_xi0.  The mirror group
    (``sign`` −1) takes rcp of the + group's exponentials, so its y is the
    price kernel's to the bit."""
    n = inp.steps
    C, sc, _d, _dd, ae, bh = cols[:6]
    zero = torch.zeros_like(x[0])
    iv_a = j_a = div_eta = dj_eta = div_h = djh_g = djh_s = zero
    step_terms = []
    for k in range(1, n):
        ep = torch.exp(c["eta"] * x[n + k - 1])
        sep = torch.sqrt(ep)
        ex, sex = (rcp(ep), rcp(sep)) if sign < 0 else (ep, sep)
        p = C[k] * ex
        s = sc[k] * sex
        sdw = s * (sign * x[k])
        iv_a = iv_a + p
        j_a = j_a + sdw
        a = sign * x[n + k - 1] + ae[k]
        g = bh[k] + c["eta"] * (sign * xd[n + k - 1])
        div_eta = div_eta + p * a
        dj_eta = dj_eta + a * sdw
        div_h = div_h + p * g
        djh_g = djh_g + g * sdw
        djh_s = djh_s + s * (sign * xd[k])
        if per_step:
            step_terms.append((p, sdw))
    iv = c["dt"] * (C[0] + iv_a)
    j = sc[0] * (sign * x[0]) + j_a
    div_eta, dj_eta, div_h = c["dt"] * div_eta, 0.5 * dj_eta, c["dt"] * div_h
    dj_h = 0.5 * djh_g + sc[0] * (sign * xd[0]) + djh_s
    y, y_iv, y_j, y_rho, w, phi2 = cond_bs_partials(iv, j, c)
    ch_xi0 = (y_iv * iv + y_j * 0.5 * j) * c["inv_xi0"]
    ch_eta = y_iv * div_eta + y_j * dj_eta
    ch_h = y_iv * div_h + y_j * dj_h
    if not vjp:
        return [y, ch_xi0, ch_eta, ch_h, w, y_rho]
    div_t = c["inv_t"] * (iv + c["h_eta"] * div_eta)
    dj_t = c["inv_t"] * (c["h_eta"] * dj_eta + 0.5 * j)
    rows = [ch_xi0, ch_eta, ch_h, y_iv * div_t + y_j * dj_t, w, y_rho, -c["cp"] * phi2]
    if not per_step:
        return rows
    ivw, jw = y_iv * c["dt"], y_j * 0.5
    s0dw0 = sc[0] * (sign * x[0])
    return [ivw * C[0] + jw * s0dw0] + [ivw * p + jw * sdw for p, sdw in step_terms] + rows[1:]


def rbergomi_mixing_greek_sums_plain(inp: RbInputs, total_pairs: int, seed: int, device_id: int,
                                     point_offset: int) -> torch.Tensor:
    """Twin of K16: float64 sums over the pairs [0, total_pairs) of
    [y, chain_xi0, chain_eta, chain_H, w, y_rho], each term the fp32 sum
    over a pair's two paths."""
    total = torch.zeros(6, dtype=torch.float64, device=inp.params.device)
    for pair in pair_chunks(total_pairs, inp.params.device, PLAIN_CHUNK):
        x, xd, c, cols = _products(inp, pair, seed, device_id, point_offset, True)
        plus = _group_rows(inp, x, xd, c, cols, 1.0, False)
        minus = _group_rows(inp, x, xd, c, cols, -1.0, False)
        total = total + torch.stack([(a + b).to(torch.float64).sum() for a, b in zip(plus, minus)])
    return total


def _weighted_sums_plain(inp: RbInputs, ct, n_paths, antithetic, seed, device_id, point_offset,
                         per_step: bool) -> torch.Tensor:
    total = torch.zeros(inp.steps + len(CURVE_ROWS) if per_step else 7, dtype=torch.float64,
                        device=inp.params.device)
    for pair in pair_chunks(n_paths, inp.params.device, PLAIN_CHUNK):
        x, xd, c, cols = _products(inp, pair, seed, device_id, point_offset, True)
        rows = [ct[0, pair] * r for r in _group_rows(inp, x, xd, c, cols, 1.0, True, per_step)]
        if antithetic:
            minus = _group_rows(inp, x, xd, c, cols, -1.0, True, per_step)
            rows = [a + ct[1, pair] * b for a, b in zip(rows, minus)]
        total = total + torch.stack([r.to(torch.float64).sum() for r in rows])
    return total


def rbergomi_mixing_vjp_sums_plain(inp: RbInputs, ct, n_paths: int, antithetic: bool, seed: int,
                                   device_id: int, point_offset: int) -> torch.Tensor:
    """Twin of K17: float64 sums over the paths of the cotangent-weighted
    [chain_xi0, chain_eta, chain_H, chain_T, w, y_rho, y_K]."""
    return _weighted_sums_plain(inp, ct, n_paths, antithetic, seed, device_id, point_offset, False)


def rbergomi_mixing_vjp_curve_sums_plain(inp: RbInputs, ct, n_paths: int, antithetic: bool,
                                         seed: int, device_id: int,
                                         point_offset: int) -> torch.Tensor:
    """Twin of K18: (n + 6,) float64 sums over the paths of the
    cotangent-weighted per-step rows d/d ln C_k (k = 0..n−1), then
    [chain_eta, chain_H, chain_T, w, y_rho, y_K] (``CURVE_ROWS``)."""
    return _weighted_sums_plain(inp, ct, n_paths, antithetic, seed, device_id, point_offset, True)


# ---- launch or twin -------------------------------------------------------------


def _check(inp: RbInputs, tangent: bool) -> None:
    n = inp.steps
    check_tensor(inp.params, "params", torch.float32, (len(RB_NAMES),))
    check_tensor(inp.coef, "coefficients", torch.float32, (n, COEF_COLS))
    packs = [("packed chol", inp.lpack)] + ([("packed chol_h", inp.dpack)] if tangent else [])
    for name, pack in packs:
        if pack is None:
            raise ValueError(f"{name}: the greek kernels need the factor's H derivative")
        check_tensor(pack, name, torch.float32, (zcols(n) // TILE, zcols(n), 2 * TILE))
    if inp.table is not None:
        check_tensor(inp.table, "sobol table", torch.int32, (2 * n, 31))
    for t in (inp.coef, inp.lpack, inp.table, inp.dpack if tangent else None):
        if t is not None and t.device != inp.params.device:
            raise ValueError("a kernel's inputs must be on one device")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _rb_values(inp: RbInputs, n_paths, antithetic, seed, device_id, point_offset) -> torch.Tensor:
    """Launch K14 for inputs on a GPU; the twin for inputs on the CPU."""
    _check(inp, False)
    if n_paths < 1:
        raise ValueError(f"need n_paths >= 1; got {n_paths}")
    if inp.params.device.type == "cpu":
        return rbergomi_mixing_values_plain(inp, n_paths, antithetic, seed, device_id, point_offset)
    require_cuda(inp.params)
    out = torch.empty((2 if antithetic else 1, n_paths), dtype=torch.float32,
                      device=inp.params.device)
    grid = values_grid(inp, n_paths)
    slab = _slab(inp, grid)
    RB_VALUES_KERNEL.launch(
        inp.params.device, inp.params.data_ptr(), inp.coef.data_ptr(), inp.lpack.data_ptr(),
        _ptr(inp.table), out.data_ptr(), grid, n_paths, inp.steps, int(antithetic),
        seed & _MASK32, device_id & _MASK32, point_offset, _ptr(slab))
    return out


def _slab(inp: RbInputs, grid: int):
    """Past ``STAGED_STEPS`` the global scratch of ``grid`` blocks' ξ
    columns, else None.  Where the allocator cannot hold it, raises
    ValueError naming the most steps that the free memory (the card's and
    the allocator's cached blocks) would fit."""
    if inp.steps <= STAGED_STEPS:
        return None
    dev = inp.params.device
    per_block = 4 * BLOCK_PAIRS * (inp.steps + zcols(inp.steps))
    try:
        return torch.empty(grid * per_block // 4, dtype=torch.float32, device=dev)
    except torch.cuda.OutOfMemoryError as err:
        free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        most = max(0, (free // (4 * BLOCK_PAIRS * grid) - TILE) // 2)
        raise ValueError(
            f"{inp.steps} steps need {grid * per_block / 2**30:.2f} GiB of scratch for the ξ "
            f"columns of {grid} blocks; {free / 2**30:.2f} GiB are free on {dev}, enough for "
            f"about {most} steps") from err


def values_grid(inp: RbInputs, n_paths: int) -> int:
    """K14's blocks: one resident wave of K14 (``hh_rb_values_grid``), or
    one a trip of 64 pairs where ``n_paths`` needs fewer.  A value does not
    depend on the grid."""
    wave = resident_grid("hh_rb_values_grid", inp.params.device, inp.steps,
                         int(inp.table is not None))
    return min(wave, -(-n_paths // BLOCK_PAIRS))


def price_grid(inp: RbInputs) -> int:
    """Blocks of K15, K16 and K19 (one resident wave of K15): all three walk
    the pairs with this grid, 64 a block a trip, so K16's price and K19's
    strikes equal K15's."""
    return resident_grid("hh_rb_price_grid", inp.params.device, inp.steps,
                         int(inp.table is not None))


def _smem_bytes(steps: int, qmc: bool, chunk_rows: int) -> int:
    """A chunk kernel's dynamic shared memory: the ξ columns of a block's
    pairs (2·steps rows padded to whole tiles), ``chunk_rows`` rows of chunk
    buffers, the Sobol' table under QMC; past ``STAGED_STEPS`` the chunk
    buffers alone."""
    if steps > STAGED_STEPS:
        return 4 * chunk_rows * BLOCK_PAIRS
    table = 2 * steps * (SOBOL_BITS + 1) if qmc else 0
    return 4 * ((steps + zcols(steps)) * BLOCK_PAIRS + chunk_rows * BLOCK_PAIRS + table)


def values_smem_bytes(steps: int, qmc: bool) -> int:
    """K14's dynamic shared memory (csrc/rbergomi.cu ``rb_chunk_smem``, K15's):
    the ξ columns, one chunk of Z rows, the Sobol' table."""
    return _smem_bytes(steps, qmc, CHUNK_ROWS)


def greeks_smem_bytes(steps: int, qmc: bool) -> int:
    """K16's dynamic shared memory (csrc/rbergomi.cu ``rb_greeks_smem``): the
    ξ columns of a block's pairs, two half-height chunks (Z and its H
    tangent, CHUNK_ROWS / 2 rows each), the Sobol' table; K15's bytes."""
    return _smem_bytes(steps, qmc, 2 * (CHUNK_ROWS // 2))


def vjp_smem_bytes(steps: int, qmc: bool) -> int:
    """K17's dynamic shared memory: K16's layout (``rb_greeks_smem``)."""
    return greeks_smem_bytes(steps, qmc)


def curve_smem_bytes(steps: int, qmc: bool) -> int:
    """K18's dynamic shared memory (csrc/rbergomi.cu ``rb_curve_smem``): the
    ξ columns of a block's pairs (2·steps rows padded to whole tiles), two
    chunks of Z rows (Z and its H tangent; the replay's rows R_k), the
    Sobol' table."""
    return _smem_bytes(steps, qmc, 2 * CHUNK_ROWS)


def vjp_curve_occupancy(inp: RbInputs) -> dict:
    """K18's occupancy at the inputs' steps and stream, from the CUDA
    runtime (``hh_rb_vjp_curve_occupancy``), as :func:`price_occupancy`."""
    return _occupancy("hh_rb_vjp_curve_occupancy", inp)


def values_occupancy(inp: RbInputs) -> dict:
    """K14's occupancy at the inputs' steps and stream, from the CUDA
    runtime (``hh_rb_values_occupancy``), as :func:`price_occupancy`."""
    return _occupancy("hh_rb_values_occupancy", inp)


def vjp_occupancy(inp: RbInputs) -> dict:
    """K17's occupancy at the inputs' steps and stream, from the CUDA
    runtime (``hh_rb_vjp_occupancy``), as :func:`price_occupancy`."""
    return _occupancy("hh_rb_vjp_occupancy", inp)


def greeks_occupancy(inp: RbInputs) -> dict:
    """K16's occupancy at the inputs' steps and stream, from the CUDA
    runtime (``hh_rb_greeks_occupancy``), as :func:`price_occupancy`."""
    return _occupancy("hh_rb_greeks_occupancy", inp)


def price_occupancy(inp: RbInputs) -> dict:
    """K15's occupancy at the inputs' steps and stream, from the CUDA
    runtime (``hh_rb_price_occupancy``): threads a block, resident blocks
    and warps per SM, shared bytes a block (dynamic and static), registers
    and local (spill) bytes a thread."""
    return _occupancy("hh_rb_price_occupancy", inp)


def _occupancy(symbol: str, inp: RbInputs) -> dict:
    """A chunk kernel's occupancy at the inputs' steps and stream from the
    library's ``symbol``."""
    require_cuda(inp.params)
    return launch_occupancy(symbol, inp.params.device, inp.steps, int(inp.table is not None))


def _rb_price_sum(inp: RbInputs, total_pairs, seed, device_id, point_offset) -> torch.Tensor:
    """Launch K15 for inputs on a GPU (the float64 sum of its per-block
    partials); the twin for inputs on the CPU."""
    _check(inp, False)
    if inp.params.device.type == "cpu":
        return rbergomi_mixing_price_sum_plain(inp, total_pairs, seed, device_id, point_offset)
    require_cuda(inp.params)
    grid = price_grid(inp)
    slab = _slab(inp, grid)
    partials = torch.empty((grid,), dtype=torch.float64, device=inp.params.device)
    RB_PRICE_KERNEL.launch(
        inp.params.device, inp.params.data_ptr(), inp.coef.data_ptr(), inp.lpack.data_ptr(),
        _ptr(inp.table), partials.data_ptr(), grid, total_pairs, inp.steps, seed & _MASK32,
        device_id & _MASK32, point_offset, _ptr(slab))
    return partials.sum()


def _rb_greek_sums(inp: RbInputs, total_pairs, seed, device_id, point_offset) -> torch.Tensor:
    """Launch K16 for inputs on a GPU (six float64 sums of its per-block
    partials); the twin for inputs on the CPU."""
    _check(inp, True)
    if inp.params.device.type == "cpu":
        return rbergomi_mixing_greek_sums_plain(inp, total_pairs, seed, device_id, point_offset)
    require_cuda(inp.params)
    grid = price_grid(inp)
    slab = _slab(inp, grid)
    partials = torch.empty((6, grid), dtype=torch.float64, device=inp.params.device)
    RB_GREEKS_KERNEL.launch(
        inp.params.device, inp.params.data_ptr(), inp.coef.data_ptr(), inp.lpack.data_ptr(),
        inp.dpack.data_ptr(), _ptr(inp.table), partials.data_ptr(), grid, total_pairs, inp.steps,
        seed & _MASK32, device_id & _MASK32, point_offset, _ptr(slab))
    # one sum per contiguous (grid,) row: the price row takes the reduction
    # K15's partials take, so the two prices are equal to the bit
    return torch.stack([row.sum() for row in partials])


def _rb_vjp_sums(inp: RbInputs, ct, n_paths, antithetic, seed, device_id, point_offset,
                 per_step: bool = False) -> torch.Tensor:
    """Launch K17 (seven float64 sums), or with ``per_step`` K18 (n + 6),
    for inputs on a GPU; the twin for inputs on the CPU.  A column of
    partials a trip of 64 pairs: one block a trip up to ``STAGED_STEPS``,
    past that one resident wave walking the trips."""
    _check(inp, True)
    check_tensor(ct, "cotangent", torch.float32, (2 if antithetic else 1, n_paths))
    if inp.params.device.type == "cpu":
        return _weighted_sums_plain(inp, ct, n_paths, antithetic, seed, device_id, point_offset,
                                    per_step)
    require_cuda(inp.params)
    trips = -(-n_paths // BLOCK_PAIRS)
    rows = inp.steps + len(CURVE_ROWS) if per_step else 7
    grid = trips
    if inp.steps > STAGED_STEPS:
        occ = (vjp_curve_occupancy if per_step else vjp_occupancy)(inp)
        sms = torch.cuda.get_device_properties(inp.params.device).multi_processor_count
        grid = min(trips, sms * max(occ["blocks_per_sm"], 1))
    slab = _slab(inp, grid)
    partials = torch.empty((rows, trips), dtype=torch.float64, device=inp.params.device)
    (RB_VJP_CURVE_KERNEL if per_step else RB_VJP_KERNEL).launch(
        inp.params.device, inp.params.data_ptr(), inp.coef.data_ptr(), inp.lpack.data_ptr(),
        inp.dpack.data_ptr(), _ptr(inp.table), ct.data_ptr(), partials.data_ptr(), n_paths,
        inp.steps, int(antithetic), seed & _MASK32, device_id & _MASK32, point_offset, grid,
        _ptr(slab))
    return partials.sum(dim=1)


def smile_strikes(f_base: float, strikes, device) -> torch.Tensor:
    """K19's (m, 2) float32 strike table: log(f_base/K) in float64 cast once
    (as the price trace casts it), then K."""
    ks = [float(k) for k in np.atleast_1d(_np64(strikes)).reshape(-1)]
    table = np.array([(math.log(float(f_base) / k), k) for k in ks], dtype=np.float64)
    return torch.as_tensor(table.astype(np.float32), device=resolve_device(device))


def _rb_smile_sums(inp: RbInputs, ks, total_pairs, seed, device_id, point_offset) -> torch.Tensor:
    """Launch K19 for inputs on a GPU ((m,) float64 sums of its per-block
    partials, each strike's row reduced as K15's partials are), once per
    chunk of at most ``MAX_STRIKES`` strikes on the same stream, pairs and
    grid, so each strike stays K15's price to the bit; the twin for inputs
    on the CPU."""
    _check(inp, False)
    m = ks.shape[0]
    if m < 1:
        raise ValueError("the smile kernel needs at least one strike")
    check_tensor(ks, "strikes", torch.float32, (m, 2))
    if ks.device != inp.params.device:
        raise ValueError("a kernel's inputs must be on one device")
    if inp.params.device.type == "cpu":
        return rbergomi_mixing_smile_sums_plain(inp, ks, total_pairs, seed, device_id, point_offset)
    require_cuda(inp.params)
    grid = price_grid(inp)
    slab = _slab(inp, grid)
    sums = []
    for k0 in range(0, m, MAX_STRIKES):
        chunk = ks[k0:k0 + MAX_STRIKES]
        width = chunk.shape[0]
        partials = torch.empty((width, grid), dtype=torch.float64, device=inp.params.device)
        RB_SMILE_KERNEL.launch(
            inp.params.device, inp.params.data_ptr(), inp.coef.data_ptr(), inp.lpack.data_ptr(),
            _ptr(inp.table), chunk.data_ptr(), width, partials.data_ptr(), grid, total_pairs,
            inp.steps, seed & _MASK32, device_id & _MASK32, point_offset, _ptr(slab))
        sums += [row.sum() for row in partials]
    return torch.stack(sums)


# ---- the public wrappers ----------------------------------------------------------


def rbergomi_mixing_values(
    chol, coefs, eta, dt, f_base, log_f_over_k, strike, cp, rho,
    *, n_paths: int, steps: int, seed, antithetic: bool = False, device_id=0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """Per-path UNDISCOUNTED conditional values, (n_groups, n_paths) float32.
    ``chol``: the (2n, 2n) Volterra factor (float64 upstream, cast here);
    ``coefs``: (n,) C_k = ξ₀(t_k)·exp(−½η²t_k^{2H}) at the left grid points.
    Under QMC ``device_id`` is unused (devices slice one sequence by
    ``point_offset``)."""
    check_period(qmc, point_offset, -(-n_paths // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK)
    inp = rb_inputs(chol, coefs, eta, dt, f_base, log_f_over_k, strike, cp, rho, steps=steps,
                    seed=seed, qmc=qmc, device=device)
    return _rb_values(inp, n_paths, antithetic, int(seed), int(device_id), point_offset)


def rbergomi_mixing_vanilla_price(
    chol, coefs, eta, dt, f_base, log_f_over_k, strike, cp, rho, discount,
    *, n_blocks: int, n_batches: int, steps: int, seed, device_id=0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """Discounted vanilla price over n_blocks·n_batches·2048 antithetic pairs
    in ONE launch, accumulated on the device: the serving configuration.
    Returns a float64 0-dim tensor."""
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    check_period(qmc, point_offset, total_pairs)
    inp = rb_inputs(chol, coefs, eta, dt, f_base, log_f_over_k, strike, cp, rho, steps=steps,
                    seed=seed, qmc=qmc, device=device)
    sums = _rb_price_sum(inp, total_pairs, int(seed), int(device_id), point_offset)
    return discount * sums / (2 * total_pairs)


def rbergomi_mixing_price_and_greeks(
    chol, chol_h, coefs, coefs_h, xi0, eta, dt, spot, f_base, log_f_over_k,
    strike, cp, rho, discount, horizon,
    *, n_blocks: int, n_batches: int, steps: int, seed, device_id=0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
):
    """Discounted price AND the 6-greek vector (``GREEK_ORDER_RB``: spot,
    xi0, eta, rho, hurst, flat rate) over n_blocks·n_batches·2048 antithetic
    pairs in ONE launch; ``chol_h`` = dL/dH and ``coefs_h`` = (ae, bh) from
    :func:`_rb_greek_trace_inputs`.  K15's stream, pairs and grid: the price
    equals K15's.  Returns (float64 0-dim, float64 (6,))."""
    if steps < 2:
        raise ValueError("the greeks kernel needs steps >= 2")
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    check_period(qmc, point_offset, total_pairs)
    inp = rb_inputs(chol, coefs, eta, dt, f_base, log_f_over_k, strike, cp, rho, steps=steps,
                    seed=seed, qmc=qmc, device=device, chol_h=chol_h, coefs_h=coefs_h,
                    inv_xi0=1.0 / float(xi0))
    tot = _rb_greek_sums(inp, total_pairs, int(seed), int(device_id), point_offset)
    tot = tot / (2 * total_pairs)
    price = discount * tot[0]
    grad = torch.stack([
        discount * tot[4] / float(spot),  # spot (w = dY/dlogF)
        discount * tot[1],  # xi0
        discount * tot[2],  # eta
        discount * tot[5],  # rho
        discount * tot[3],  # hurst
        discount * tot[4] * horizon - horizon * price,  # flat rate
    ])
    return price, grad


def rbergomi_mixing_smile_price(
    chol, coefs, eta, dt, f_base, strikes, cp, rho, discount,
    *, n_blocks: int, n_batches: int, steps: int, seed, device_id=0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """Discounted vanilla prices (m,) float64 for a whole strike grid from
    ONE launch over n_blocks·n_batches·2048 antithetic pairs: every strike
    closes the same variance paths.  K15's stream, pairs and grid: each
    strike's price equals :func:`rbergomi_mixing_vanilla_price` at that
    strike to the bit."""
    if steps < 2:
        raise ValueError("the smile kernel needs steps >= 2")
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    check_period(qmc, point_offset, total_pairs)
    inp = rb_inputs(chol, coefs, eta, dt, f_base, 0.0, 0.0, cp, rho, steps=steps, seed=seed,
                    qmc=qmc, device=device)
    ks = smile_strikes(f_base, strikes, inp.params.device)
    sums = _rb_smile_sums(inp, ks, total_pairs, int(seed), int(device_id), point_offset)
    return discount * sums / (2 * total_pairs)


# ---- host-side inputs from a problem or from the raw scalars ---------------------


class RbTrace(NamedTuple):
    """The price kernels' host inputs from a problem, in the order of the
    public wrappers' positional arguments, then the maturity."""

    chol: torch.Tensor
    coefs: torch.Tensor
    eta: float
    dt: float
    f_base: float
    log_f_over_k: float
    strike: float
    cp: float
    rho: float
    discount: float
    T: float

    def values_args(self) -> tuple:
        """The positional arguments of :func:`rbergomi_mixing_values`."""
        return tuple(self)[:9]

    def price_args(self) -> tuple:
        """The positional arguments of :func:`rbergomi_mixing_vanilla_price`."""
        return tuple(self)[:10]


class RbGreekTrace(NamedTuple):
    """The greek kernel's host inputs from a problem: the positional
    arguments of :func:`rbergomi_mixing_price_and_greeks`."""

    chol: torch.Tensor
    chol_h: torch.Tensor
    coefs: torch.Tensor
    coefs_h: tuple
    xi0: float
    eta: float
    dt: float
    spot: float
    f_base: float
    log_f_over_k: float
    strike: float
    cp: float
    rho: float
    discount: float
    horizon: float


def rb_inputs_from_trace(trace: RbTrace | RbGreekTrace, *, seed, qmc: bool, device,
                         hurst=None) -> RbInputs:
    """A kernel call's device inputs from :func:`_rb_trace_inputs` (K14,
    K15) or :func:`_rb_greek_trace_inputs` (K16; given ``hurst``, also K17's
    Hη and 1/T)."""
    t = trace
    args = (t.chol, t.coefs, t.eta, t.dt, t.f_base, t.log_f_over_k, t.strike, t.cp, t.rho)
    kw = dict(steps=len(t.coefs), seed=seed, qmc=qmc, device=device)
    if isinstance(t, RbTrace):
        if hurst is not None:
            raise ValueError("the VJP kernel's inputs come from the greek trace")
        return rb_inputs(*args, **kw)
    vjp = {} if hurst is None else dict(h_eta=float(hurst) * t.eta, inv_t=1.0 / t.horizon)
    return rb_inputs(*args, **kw, chol_h=t.chol_h, coefs_h=t.coefs_h, inv_xi0=1.0 / t.xi0, **vjp)


def _t_left(T, n: int) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float64) / n) * f64(T)


def _rb_trace_inputs(prob, config, quad_nodes: int) -> RbTrace:
    """(chol, coefs, eta, dt, f_base, log_f_over_k, strike, cp, rho, discount,
    T) for the kernels from a problem: the float64 factor and the close
    constants (float64 CPU tensors for the factor and coefficients,
    floats for the scalars)."""
    from ..market.rate_curve import df_yf
    from ..methods.montecarlo import sim_params
    from ..models.rough_bergomi import ForwardVarianceCurve, _pow, volterra_chol

    with torch.no_grad():
        market, T, r0 = sim_params(prob)
        n = config.steps
        chol = volterra_chol(f64(market.hurst).cpu(), T, n, quad_nodes=quad_nodes)
        t_left = _t_left(T, n)
        xi0 = market.xi0
        level = xi0(t_left) if isinstance(xi0, ForwardVarianceCurve) else f64(xi0).cpu()
        eta, hurst = f64(market.eta).cpu(), f64(market.hurst).cpu()
        coefs = level.cpu() * torch.exp(-0.5 * eta**2 * _pow(t_left, 2.0 * hurst))
        f_base = float(market.spot) * math.exp(float(r0) * T)
        strike = float(prob.payoff.strike)
        disc = float(df_yf(market.rate, T))
        return RbTrace(chol, coefs, float(eta), T / n, f_base, math.log(f_base / strike), strike,
                       float(prob.payoff.call_put()), float(market.rho), disc, T)


def _coef_columns(eta, hurst, T, n: int):
    """(t^{2H}, ae, bh) at the left grid points: ae = −η·t^{2H} = d ln C_k/dη
    less its Z part, bh = −η²·t^{2H}·ln t = d ln C_k/dH."""
    from ..models.rough_bergomi import _pow

    t_left = _t_left(T, n)
    pos = t_left > 0.0
    safe = torch.where(pos, t_left, torch.ones_like(t_left))
    t2h = torch.where(pos, _pow(safe, 2.0 * hurst), torch.zeros_like(t_left))
    return t2h, -eta * t2h, -(eta**2) * t2h * torch.log(safe)


def _rb_greek_trace_inputs(prob, config, quad_nodes: int) -> RbGreekTrace:
    """The greek kernel's inputs from a problem: the price inputs plus dL/dH
    and the (ae, bh) columns.  Scalar xi0 only."""
    from ..models.rough_bergomi import ForwardVarianceCurve, volterra_chol_dh

    market = prob.market_inputs
    if isinstance(market.xi0, ForwardVarianceCurve):
        raise TypeError(
            "the rough-Bergomi greeks kernel covers scalar xi0; bucketed ForwardVarianceCurve "
            "vegas come from torch.autograd through solve (the values kernel's K18 backward, "
            "or the float64 estimator)")
    t = _rb_trace_inputs(prob, config, quad_nodes)
    n = config.steps
    hurst = float(market.hurst)
    chol_h = volterra_chol_dh(hurst, t.T, n, quad_nodes=quad_nodes)
    _, ae, bh = _coef_columns(t.eta, hurst, t.T, n)
    return RbGreekTrace(t.chol, chol_h, t.coefs, (ae, bh), float(market.xi0), t.eta, t.dt,
                        float(market.spot), t.f_base, t.log_f_over_k, t.strike, t.cp, t.rho,
                        t.discount, t.T)


def rbergomi_kernel_price_and_greeks(prob, config, *, n_blocks: int, n_batches: int,
                                     quad_nodes: int = 64, seed=None, device_id=0,
                                     point_offset=0, device="cuda"):
    """(discounted price, {greek: value}) of a scalar-strike vanilla under
    rough Bergomi from K16 (keys ``GREEK_ORDER_RB``).  ``config.trajectories``
    is not read: the pairs are n_blocks·n_batches·2048."""
    from ..core.payoffs import VanillaOption

    if not isinstance(prob.payoff, VanillaOption) or torch.as_tensor(prob.payoff.strike).ndim > 0:
        raise TypeError("the rough-Bergomi greeks kernel closes scalar-strike vanillas only")
    ins = _rb_greek_trace_inputs(prob, config, quad_nodes)
    price, grad = rbergomi_mixing_price_and_greeks(
        *ins, n_blocks=n_blocks, n_batches=n_batches, steps=config.steps,
        seed=config.seed if seed is None else seed, device_id=device_id, qmc=config.qmc,
        point_offset=point_offset, device=device)
    return price, dict(zip(GREEK_ORDER_RB, grad))


def rbergomi_kernel_smile(prob, config, strikes, *, n_blocks: int, n_batches: int,
                          quad_nodes: int = 64, seed=None, device_id=0, point_offset=0,
                          device="cuda") -> torch.Tensor:
    """Discounted prices (m,) for ``strikes`` under the problem's
    rough-Bergomi market from K19: the payoff's expiry and call/put apply
    to every strike, its own strike is not read.  ``config.trajectories``
    is not read: the pairs are n_blocks·n_batches·2048."""
    t = _rb_trace_inputs(prob, config, quad_nodes)
    return rbergomi_mixing_smile_price(
        t.chol, t.coefs, t.eta, t.dt, t.f_base, strikes, t.cp, t.rho, t.discount,
        n_blocks=n_blocks, n_batches=n_batches, steps=config.steps,
        seed=config.seed if seed is None else seed, device_id=device_id, qmc=config.qmc,
        point_offset=point_offset, device=device)


def _rb_diff_coeffs(xi0, eta, hurst, T, steps: int, quad_nodes: int, tangent: bool = True):
    """(chol, chol_h or None, coefs, ae, bh) from the raw scalars: what
    :func:`_rb_greek_trace_inputs` derives from a problem.  ``xi0`` is a
    number, or under a piecewise-linear forward-variance curve the pair
    (tenors, xi) of float64 CPU tensors: C_k = ξ₀(t_k)·exp(−½η²t_k^{2H})."""
    from ..models.rough_bergomi import _interp, volterra_chol, volterra_chol_dh

    chol = volterra_chol(hurst, T, steps, quad_nodes=quad_nodes)
    chol_h = volterra_chol_dh(hurst, T, steps, quad_nodes=quad_nodes) if tangent else None
    t2h, ae, bh = _coef_columns(eta, hurst, T, steps)
    level = _interp(_t_left(T, steps), *xi0) if isinstance(xi0, tuple) else xi0
    return chol, chol_h, level * torch.exp(-0.5 * eta**2 * t2h), ae, bh


def _curve(tenors, xi) -> tuple:
    """(tenors, xi) as detached float64 CPU tensors."""
    return tuple(torch.as_tensor(v, dtype=torch.float64).detach().cpu() for v in (tenors, xi))


def rb_vjp_inputs(spot, xi0, eta, hurst, rho, r0, T, strike, cp, *, steps: int, seed, qmc: bool,
                  device, quad_nodes: int = 64) -> RbInputs:
    """K17's device inputs from the raw scalars, or K18's when ``xi0`` is a
    curve (tenors, xi): the factor, dL/dH, the C_k and (ae, bh) columns, Hη
    and 1/T, and 1/ξ₀ in the inv_xi0 slot (0 under a curve: per-step mode)."""
    spot, eta, hurst, rho, r0, T, strike = (float(x) for x in (spot, eta, hurst, rho, r0, T,
                                                                strike))
    curve = isinstance(xi0, tuple)
    xi0 = _curve(*xi0) if curve else float(xi0)
    chol, chol_h, coefs, ae, bh = _rb_diff_coeffs(xi0, eta, hurst, T, steps, quad_nodes)
    f_base = spot * math.exp(r0 * T)
    return rb_inputs(chol, coefs, eta, T / steps, f_base, math.log(f_base / strike), strike, cp,
                     rho, steps=steps, seed=seed, qmc=qmc, device=device, chol_h=chol_h,
                     coefs_h=(ae, bh), inv_xi0=0.0 if curve else 1.0 / xi0, h_eta=hurst * eta,
                     inv_t=1.0 / T)


# ---- the values' backward: K17, K18 under a curve, and the differentiable view ------


def _rb_values_vjp(
    spot, xi0, eta, hurst, rho, r0, T, strike, cp, ct,
    *, n_paths: int, steps: int, seed, antithetic: bool, device_id=0,
    qmc: bool = False, point_offset: int = 0, quad_nodes: int = 64,
):
    """Gradients of sum(ct·values) in the eight differentiable scalars
    (spot, xi0, eta, hurst, rho, r0, T, strike), float64 0-dim tensors on
    ``ct.device``, from one K17 launch replaying the values' stream.  The T
    chain by the covariance's self-similarity: dIV/dT = (IV + Hη·dIV/dη)/T,
    dJ/dT = (Hη·dJ/dη + J/2)/T."""
    if steps < 2:
        raise ValueError("the weighted VJP kernel needs steps >= 2")
    inp = rb_vjp_inputs(spot, xi0, eta, hurst, rho, r0, T, strike, cp, steps=steps, seed=seed,
                        qmc=qmc, device=ct.device, quad_nodes=quad_nodes)
    sums = _rb_vjp_sums(inp, ct.to(torch.float32).contiguous(), n_paths, antithetic, int(seed),
                        int(device_id), point_offset)
    ch_xi0, ch_eta, ch_h, ch_t, w_sum, rho_sum, k_sum = sums.unbind()
    spot, r0, T = float(spot), float(r0), float(T)
    return (w_sum / spot, ch_xi0, ch_eta, ch_h, rho_sum, w_sum * T, ch_t + w_sum * r0, k_sum)


def _rb_values_vjp_curve(
    spot, xi, tenors, eta, hurst, rho, r0, T, strike, cp, ct,
    *, n_paths: int, steps: int, seed, antithetic: bool, device_id=0,
    qmc: bool = False, point_offset: int = 0, quad_nodes: int = 64,
):
    """Gradients of sum(ct·values) under the curve (tenors, xi) in (spot,
    xi, tenors, eta, hurst, rho, r0, T, strike), from one K18 launch
    replaying the values' stream: its per-step rows R_k = ∂/∂ln C_k chain
    through ln ξ₀(t_k) into the bucket vegas, the tenor sensitivities and
    the curve part of the maturity chain (t_k = (k/n)·T slides along the
    spine) by ``torch.autograd.grad`` through the interpolation.  float64
    tensors on the CPU (``xi`` and ``tenors`` of their length)."""
    from ..models.rough_bergomi import _interp

    n = steps
    if n < 2:
        raise ValueError("the weighted VJP kernel needs steps >= 2")
    tenors, xi = _curve(tenors, xi)
    inp = rb_vjp_inputs(spot, (tenors, xi), eta, hurst, rho, r0, T, strike, cp, steps=n,
                        seed=seed, qmc=qmc, device=ct.device, quad_nodes=quad_nodes)
    sums = _rb_vjp_sums(inp, ct.to(torch.float32).contiguous(), n_paths, antithetic, int(seed),
                        int(device_id), point_offset, per_step=True).cpu()
    R = sums[:n]
    ch_eta, ch_h, ch_t, w_sum, rho_sum, k_sum = sums[n:].unbind()
    spot, r0, T = float(spot), float(r0), float(T)
    with torch.enable_grad():
        xi_, ten_ = xi.clone().requires_grad_(), tenors.clone().requires_grad_()
        T_ = torch.tensor(T, dtype=torch.float64, requires_grad=True)
        level = torch.log(_interp(_t_left(T, n), ten_, xi_))
        level_t = torch.log(_interp((torch.arange(n, dtype=torch.float64) / n) * T_, tenors, xi))
        g_xi, g_ten = torch.autograd.grad(level, (xi_, ten_), R, allow_unused=True)
        (g_t,) = torch.autograd.grad(level_t, (T_,), R, allow_unused=True)
    zero = lambda g, like: torch.zeros_like(like) if g is None else g  # noqa: E731
    return (w_sum / spot, zero(g_xi, xi), zero(g_ten, tenors), ch_eta, ch_h, rho_sum, w_sum * T,
            ch_t + w_sum * r0 + zero(g_t, T_.detach()), k_sum)


class _RbValues(torch.autograd.Function):
    """K14 forward over (spot, xi0, eta, hurst, rho, r0, T, strike); the
    backward K17, or K18 when the level is a curve (xi, tenors) in xi0's
    place.  No forward mode and no double backward (ops/autograd_limits.py)."""

    @staticmethod
    def forward(opts, spot, *rest):
        cp, quad_nodes, kw, fwd = opts
        head = len(rest) - 6  # 1: xi0; 2: (xi, tenors)
        level_in = tuple(v.detach().cpu() for v in rest[:head])
        args = tuple(float(x) for x in (spot, *rest[head:]))
        fwd.state = (level_in, args)
        spot, eta, hurst, rho, r0, T, strike = args
        level = level_in[::-1] if head == 2 else float(level_in[0])
        chol, _, coefs, _, _ = _rb_diff_coeffs(level, eta, hurst, T, kw["steps"], quad_nodes,
                                               tangent=False)
        f_base = spot * math.exp(r0 * T)
        return rbergomi_mixing_values(chol, coefs, eta, T / kw["steps"], f_base,
                                      math.log(f_base / strike), strike, cp, rho, **kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.metas = [(x.dtype, x.device) for x in inputs[1:]]
        ctx.save_for_backward(*inputs[1:])
        ctx.opts = inputs[0]
        ctx.head, ctx.args = ctx.opts[3].state

    @staticmethod
    def backward(ctx, ct):
        cp, quad_nodes, kw, _ = ctx.opts
        kw = {k: v for k, v in kw.items() if k != "device"}
        vjp = _rb_values_vjp_curve if len(ctx.head) == 2 else _rb_values_vjp
        grads = vjp(ctx.args[0], *ctx.head, *ctx.args[1:], cp, ct, quad_nodes=quad_nodes, **kw)
        grads = tuple(g.to(dtype=dtype, device=dev) for g, (dtype, dev) in zip(grads, ctx.metas))
        return (None, *first_order_only(grads, "K17/K18 (the rough-Bergomi values' VJPs)", ct,
                                        *ctx.saved_tensors))

    @staticmethod
    def jvp(ctx, *tangents):
        refuse_forward_mode("K14 (the rough-Bergomi values, K17/K18 their backward)")


def rbergomi_mixing_values_diff(
    spot, xi0, eta, hurst, rho, r0, T, strike, cp,
    *, n_paths: int, steps: int, seed, antithetic: bool = False, device_id=0,
    qmc: bool = False, point_offset: int = 0, quad_nodes: int = 64, device="cuda",
) -> torch.Tensor:
    """Differentiable view of :func:`rbergomi_mixing_values`: the factor and
    coefficients derived from the raw scalars, and a backward on the same
    stream, so ``torch.autograd.grad`` of any reduction of the values
    works.  The eight leading scalars (numbers or 0-dim tensors) are
    differentiable, the maturity ``T`` and ``strike`` included.  A scalar
    ``xi0`` takes K17 backward; a ``ForwardVarianceCurve`` (flat outside
    its spine) takes K18, whose gradients reach its ``xi`` (the bucket
    vegas) and ``tenors``."""
    from ..models.rough_bergomi import ForwardVarianceCurve

    if steps < 2:
        raise ValueError("the differentiable values kernel needs steps >= 2")
    head = (xi0.xi, xi0.tenors) if isinstance(xi0, ForwardVarianceCurve) else (xi0,)
    args = tuple(torch.as_tensor(x, dtype=torch.float64)
                 for x in (spot, *head, eta, hurst, rho, r0, T, strike))
    kw = dict(n_paths=n_paths, steps=steps, seed=seed, antithetic=antithetic,
              device_id=device_id, qmc=qmc, point_offset=point_offset, device=device)
    return _RbValues.apply((cp, quad_nodes, kw, ForwardState()), *args)


def rbergomi_mixing_values_adapter(prob, config, strat, key=None, device_id=0, point_offset=0,
                                   *, device) -> torch.Tensor:
    """``MonteCarlo(RoughBergomiDynamics(), RoughBergomiMixing(use_kernel=True))``:
    float64 per-path values (n_groups, trajectories) from K14 (the
    counterpart of the JAX ``rbergomi_mixing_values_pallas``).  At ``steps
    >= 2`` through a differentiable view: backward K17 with scalar xi0, K18
    under a ForwardVarianceCurve (bucket vegas); at one step the values are
    primal only.  Under QMC the seed is always ``config.seed``; under PRNG
    an explicit ``key`` reseeds the stream."""
    from ..methods.montecarlo import Antithetic, sim_params
    from ..models.rough_bergomi import ForwardVarianceCurve
    from .heston_kernel import seed_from_key

    market, T, r0 = sim_params(prob)
    kw = dict(n_paths=config.trajectories, steps=config.steps,
              seed=config.seed if config.qmc else seed_from_key(config, key),
              antithetic=isinstance(config.variance_reduction, Antithetic), device_id=device_id,
              qmc=config.qmc, point_offset=point_offset, device=device)
    if config.steps >= 2:
        out = rbergomi_mixing_values_diff(market.spot, market.xi0, market.eta, market.hurst,
                                          market.rho, r0, T, prob.payoff.strike,
                                          prob.payoff.call_put(), quad_nodes=strat.quad_nodes,
                                          **kw)
        return out.to(torch.float64)
    curve = isinstance(market.xi0, ForwardVarianceCurve)
    trace = _rb_trace_inputs(prob, config, strat.quad_nodes)
    out = rbergomi_mixing_values(*trace.values_args(), **kw)
    return no_derivative(out.to(torch.float64),
                         "the rough-Bergomi values kernel is differentiable at steps >= 2",
                         market.spot, market.eta, market.hurst, market.rho, market.rate.rate,
                         *((market.xi0.xi, market.xi0.tenors) if curve else (market.xi0,)))
