"""Exact-transition mixing kernels (K2 values, K3 serving price, K4 the
(expiry × strike) surface) and their plain PyTorch twins.

Port of ``hedgehog_tpu/ops/heston_exact_kernel.py``.  For tensors on a GPU
the work goes to ``csrc/heston_exact.cu``; for tensors on the CPU to the
float32 twins below, which repeat the kernels' arithmetic: the same Sobol'
or Philox bits, the same draws (``sobol_normals_tile``,
``sobol_uniforms_open_tile`` for u_boost and ``sobol_uniform_top`` for the
Poisson u_pois, which repair the Sobol' cells whose float32 uniform rounds
to 1.0; Box–Muller with its zero cell centred), the same polished
reciprocal and the same trip counts (16 continued-fraction trips, the
market's Poisson ``kmax``).  The public functions keep the JAX signatures,
with ``device`` in place of ``interpret``; ``n_blocks``/``n_batches`` keep
their meaning (``n_blocks·n_batches·32768`` antithetic pairs per price
call).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.heston_exact import (
    GQ_NEWTON,
    GQ_NEWTON_E1,
    GQ_P2,
    GQ_P3,
    GQ_SC,
    cir_exact_kernel_coeffs,
    cir_exact_shared_coeffs,
    poisson_kmax,
)
from ..math.counter_rng import uniform_from_bits
from ..utils import resolve_device
from .autograd_limits import host_float_kernel, no_derivative
from .cuda_lib import (
    CudaKernel,
    check_grid,
    check_tensor,
    launch_occupancy,
    require_cuda,
    resident_grid,
)
from .heston_qe_kernel import (
    check_surface,
    pair_chunks,
    segment_dts,
    staged_rows,
    strike_chunks,
    surface_args,
)
from .hh_device import (
    SOBOL_BITS,
    box_muller,
    cond_bs_value,
    philox_block,
    rcp,
    sobol_masks,
    sobol_normals_tile,
    sobol_table,
    sobol_uniform_top,
    sobol_uniforms_open_tile,
)

__all__ = [
    "EXACT_VALUES_KERNEL",
    "EXACT_PRICE_KERNEL",
    "heston_exact_mixing_values",
    "heston_exact_mixing_values_adapter",
    "heston_exact_mixing_values_plain",
    "heston_exact_mixing_price_sum_plain",
    "heston_exact_mixing_vanilla_price",
    "EXACT_SURFACE_KERNEL",
    "heston_exact_mixing_surface_price",
    "heston_exact_mixing_surface_sums_plain",
]

#: antithetic pairs per TPU program (256 × 128): the unit of ``n_blocks``
PAIRS_PER_BLOCK = 256 * 128
#: Bessel-ratio continued-fraction trips and switch point of the kernels
_CF_ITERS = 16
_CF_SWITCH = 24.0
#: the largest Poisson trip count the CUDA kernels take (poisson_kmax's cap + 1)
_KMAX_LIMIT = 65
_MASK32 = 0xFFFFFFFF

_P_NAMES = (
    # conditional-BS close (csrc/hh_device.cuh CloseParams)
    "f_base", "strike", "rho", "rho2_half", "rho_bar2", "cp", "log_f_over_k",
    # exact CIR transition
    "v0", "lam_fac", "d_half", "two_cfac",
    # Bessel ratio (ν, ν² and the asymptotic-series coefficients)
    "nu", "nu2", "z_fac", "an1", "an2", "an3", "ad1", "ad2", "ad3",
    # conditional ∫V moment assembly
    "l1c", "l1x", "l2c", "l2x", "q", "p_c", "q2", "m1f", "s2f", "inv_kappa",
    # J closure
    "c_j", "k_over_sigma", "inv_sigma",
)

_VALUES_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p,
]
_PRICE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p,
]
EXACT_VALUES_KERNEL = CudaKernel("hh_exact_values", _VALUES_ARGS)
EXACT_PRICE_KERNEL = CudaKernel("hh_exact_price", _PRICE_ARGS)


def _exact_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, segments, strike, cp) -> np.ndarray:
    """(33,) float32 parameter vector: float64 host math, cast once; the
    coefficient formulas are models/heston_exact.py's."""
    T = dt * segments
    f_base = float(np.exp(log_s0 + r * T))
    vals = dict(
        cir_exact_shared_coeffs(kappa, theta, sigma),
        **cir_exact_kernel_coeffs(kappa, theta, sigma, dt),
        f_base=f_base, strike=strike, rho=rho, rho2_half=0.5 * rho**2,
        rho_bar2=1.0 - rho**2, cp=cp,
        log_f_over_k=np.log(f_base) - np.log(strike),
        v0=v0,
        c_j=v0 + kappa * theta * T, k_over_sigma=kappa / sigma,
        inv_sigma=1.0 / sigma,
    )
    return np.array([float(vals[n]) for n in _P_NAMES], dtype=np.float64).astype(np.float32)


def _exact_c(params: torch.Tensor) -> dict:
    return dict(zip(_P_NAMES, params.unbind()))


# ---- the per-path twin ------------------------------------------------------


def _bessel_ratio_tile(z, c):
    """I_{ν+1}(z)/I_ν(z): backward Perron CF below z = 24, asymptotic above."""
    zc = torch.clamp(z, max=_CF_SWITCH)
    r = torch.zeros_like(z)
    for m in range(_CF_ITERS, 0, -1):
        r = zc * rcp(2.0 * (c["nu"] + m) + zc * r)
    za = torch.clamp(z, min=_CF_SWITCH)
    it = rcp(8.0 * za)
    num = 1.0 + it * (-c["an1"] + it * (c["an2"] - it * c["an3"]))
    den = 1.0 + it * (-c["ad1"] + it * (c["ad2"] - it * c["ad3"]))
    return torch.where(z < _CF_SWITCH, r, num * rcp(den))


def _lam_of_eta(eta, trips: int):
    """λ from λ − 1 − ln λ = η²/2: series below |η| = 0.5, Newton above."""
    lam_s = 1.0 + eta * (1.0 + eta * (1.0 / 3.0 + eta * (1.0 / 36.0
            + eta * (-1.0 / 270.0 + eta * (1.0 / 4320.0)))))
    cube = 1.0 + eta * (1.0 / 3.0)
    cube = torch.clamp(cube * cube * cube, min=1e-12)
    lam = torch.where(eta >= 0.0, cube,
                      torch.maximum(cube, torch.exp(-1.0 - 0.5 * eta * eta)))
    tgt = 0.5 * eta * eta
    tiny = torch.full_like(eta, 1e-12)
    for _ in range(trips):
        f = lam - 1.0 - torch.log(torch.clamp(lam, min=1e-30)) - tgt
        den = torch.where(torch.abs(lam - 1.0) < 1e-12, tiny, lam - 1.0)
        lam = torch.clamp(lam - f * lam * rcp(den), min=1e-30)
    return torch.where(torch.abs(eta) < 0.5, lam_s, lam)


def _gamma_qtl(alpha, z):
    """Gamma(α, 1) quantile at Φ(z), corrected saddlepoint inversion."""
    inv_a = rcp(alpha)
    eta0 = z * torch.sqrt(inv_a)
    lam0 = _lam_of_eta(eta0, GQ_NEWTON_E1)
    w = lam0 - 1.0
    safe = torch.abs(eta0) >= 0.1
    one = torch.ones_like(eta0)
    w_s = torch.where(safe, w, one)
    eta_s = torch.where(safe, eta0, one)
    e1 = torch.where(
        safe,
        torch.log(torch.clamp(eta_s * rcp(w_s), min=1e-30)) * rcp(eta_s),
        -1.0 / 3.0 + eta0 * (1.0 / 36.0) + eta0 * eta0 * (1.0 / 1620.0),
    )
    t = torch.clamp(eta0 * (1.0 / GQ_SC), -1.0, 1.0)
    q2 = torch.full_like(t, GQ_P2[-1])
    for cf in GQ_P2[-2::-1]:
        q2 = q2 * t + cf
    q3 = torch.full_like(t, GQ_P3[-1])
    for cf in GQ_P3[-2::-1]:
        q3 = q3 * t + cf
    eta = eta0 + inv_a * (e1 + inv_a * (q2 + inv_a * q3))
    return alpha * _lam_of_eta(eta, GQ_NEWTON)


_INV_K = [np.float32(0.0)] + [np.float32(1.0 / k) for k in range(1, _KMAX_LIMIT + 1)]


def _poisson_top_count(mu, w, kmax: int):
    """The Poisson(mu) count at u = 1 − w of a Sobol' top cell
    (csrc/heston_exact.cu ``poisson_top_count``): the smallest n ≤ kmax with
    P(N > n) ≤ w, the tail summed downward from kmax or from the first term
    past the mode below w·2^-24."""
    p = torch.exp(-mu)
    top = torch.zeros_like(mu)
    going = torch.ones_like(mu, dtype=torch.bool)
    for k in range(1, kmax + 1):
        q = p * mu * float(_INV_K[k])
        going = going & ~((k > mu) & (q < w * 2.0**-24))
        p = torch.where(going, q, p)
        top = torch.where(going, float(k), top)
    tail, n = torch.zeros_like(mu), top
    going = torch.ones_like(going)
    for k in range(kmax, 0, -1):
        live = going & (top >= k)
        tail = torch.where(live, tail + p, tail)
        going = going & ~(live & (tail > w))
        step = live & going
        n = torch.where(step, float(k - 1), n)
        p = torch.where(step, p * float(k) * rcp(mu), p)
    return n


def _exact_segment(v, iv, u_pois, z_gam, u_boost, z_iv, c, kmax: int):
    """One exact segment on float32 tensors: (V, ∫V) → (V', ∫V + draw); a
    negative ``u_pois`` is −w of a Sobol' top cell (``sobol_uniform_top``)."""
    mu = v * c["lam_fac"]
    p = torch.exp(-mu)
    cdf = p
    n = torch.zeros_like(v)
    for k in range(1, kmax + 1):
        n = torch.where(u_pois > cdf, float(k), n)
        p = p * mu * float(_INV_K[k])
        cdf = cdf + p
    top = u_pois < 0.0
    if bool(top.any()):
        n = torch.where(top, _poisson_top_count(mu, torch.where(top, -u_pois, 1.0), kmax), n)

    alpha = c["d_half"] + n
    u_safe = torch.clamp(u_boost, min=1e-30)
    g = _gamma_qtl(alpha + 1.0, z_gam) * torch.exp(torch.log(u_safe) * rcp(alpha))
    y = c["two_cfac"] * g

    z = c["z_fac"] * torch.sqrt(torch.clamp(v * y, min=1e-30))
    W = z * _bessel_ratio_tile(z, c) + c["nu"]
    xy = v + y
    l1 = c["l1c"] - xy * c["l1x"] + W * c["q"]
    l2 = (c["l2c"] + xy * c["l2x"]
          + (z * z + c["nu2"] - W - W * W) * c["q2"] + W * c["p_c"])
    m1 = torch.clamp(c["m1f"] * l1, min=1e-10)
    s2 = torch.clamp(c["s2f"] * (l2 - l1 * c["inv_kappa"]), min=1e-14)

    inv_s2 = rcp(s2)
    shape = m1 * m1 * inv_s2
    scale = s2 * rcp(m1)
    iv_seg = torch.clamp(scale * _gamma_qtl(shape, z_iv), min=1e-10)
    return y, iv + iv_seg


def _exact_close(v, iv, c):
    """Conditional BS close through J = (V_T − V_0 − κθT)/σ + (κ/σ)·IV."""
    j = (v - c["c_j"]) * c["inv_sigma"] + iv * c["k_over_sigma"]
    return cond_bs_value(iv, j, c)


def _exact_draws(pair, s, masks, table, seed, device_id):
    """(u_pois, z_gam, u_boost, z_iv) of segment ``s``: Sobol' dims 4s..4s+3
    (``masks`` of the point indices ``point_offset + pair``) when ``table``
    is given, else Philox draw block ``s`` of the pair (csrc/hh_device.cuh)."""
    if table is not None:
        u_pois = sobol_uniform_top(masks, table, 4 * s)
        (u_boost,) = sobol_uniforms_open_tile(masks, table, (4 * s + 2,))
        z_gam, z_iv = sobol_normals_tile(masks, table, (4 * s + 1, 4 * s + 3))
        return u_pois, z_gam, u_boost, z_iv
    w = philox_block(pair, s, seed & _MASK32, device_id & _MASK32)
    z_gam, z_iv = box_muller(w[0], w[1])
    return uniform_from_bits(w[2]), z_gam, uniform_from_bits(w[3]), z_iv


def _mirror_pois(u_pois):
    """The mirror's Poisson uniform: 1 − u, or w of a top cell's u_pois = −w."""
    return torch.where(u_pois < 0.0, -u_pois, 1.0 - u_pois)


def _exact_pairs_plain(params, table, pair, segments, antithetic, kmax, seed, device_id,
                       point_offset):
    c = _exact_c(params)
    v = c["v0"].expand(pair.shape)
    iv = torch.zeros_like(v)
    va, iva = v, iv
    masks = sobol_masks(pair + point_offset) if table is not None else None
    for s in range(segments):
        u_pois, z_gam, u_boost, z_iv = _exact_draws(pair, s, masks, table, seed, device_id)
        v, iv = _exact_segment(v, iv, u_pois, z_gam, u_boost, z_iv, c, kmax)
        if antithetic:
            va, iva = _exact_segment(va, iva, _mirror_pois(u_pois), -z_gam, 1.0 - u_boost, -z_iv,
                                     c, kmax)
    rows = [_exact_close(v, iv, c)]
    if antithetic:
        rows.append(_exact_close(va, iva, c))
    return torch.stack(rows)


def heston_exact_mixing_values_plain(params, table, n_paths: int, segments: int,
                                     antithetic: bool, kmax: int, seed: int, device_id: int,
                                     point_offset: int) -> torch.Tensor:
    """Twin of K2: (1 or 2, n_paths) float32 undiscounted values on
    ``params.device``; ``table`` is the Sobol' table (QMC) or None (Philox)."""
    pair = torch.arange(n_paths, dtype=torch.int64, device=params.device)
    return _exact_pairs_plain(params, table, pair, segments, antithetic, kmax, seed, device_id,
                              point_offset)


def heston_exact_mixing_price_sum_plain(params, table, total_pairs: int, segments: int,
                                        kmax: int, seed: int, device_id: int,
                                        point_offset: int) -> torch.Tensor:
    """Twin of K3: the float64 sum of (value + antithetic value) over the
    pairs ``[0, total_pairs)``, i.e. the points
    ``[point_offset, point_offset + total_pairs)``, in chunks of pairs."""
    total = torch.zeros((), dtype=torch.float64, device=params.device)
    for pair in pair_chunks(total_pairs, params.device):
        vals = _exact_pairs_plain(params, table, pair, segments, True, kmax, seed, device_id,
                                  point_offset)
        total = total + (vals[0] + vals[1]).to(torch.float64).sum()
    return total


# ---- launch or twin ---------------------------------------------------------


def _check_inputs(params, table, segments: int, kmax: int):
    check_tensor(params, "params", torch.float32, (len(_P_NAMES),))
    if segments < 1:
        raise ValueError(f"need segments >= 1; got {segments}")
    if not 1 <= kmax <= _KMAX_LIMIT:
        raise ValueError(f"Poisson trip count {kmax} outside [1, {_KMAX_LIMIT}]")
    if table is not None:
        check_tensor(table, "sobol table", torch.int32, (4 * segments, SOBOL_BITS + 1))
        if table.device != params.device:
            raise ValueError("params and the Sobol' table must be on one device")


def _exact_values(params, table, n_paths, segments, antithetic, kmax, seed, device_id,
                  point_offset) -> torch.Tensor:
    """Launch K2 for inputs on a GPU; the twin for inputs on the CPU."""
    _check_inputs(params, table, segments, kmax)
    if n_paths < 1:
        raise ValueError(f"need n_paths >= 1; got {n_paths}")
    if params.device.type == "cpu":
        return heston_exact_mixing_values_plain(params, table, n_paths, segments, antithetic,
                                                kmax, seed, device_id, point_offset)
    require_cuda(params)
    out = torch.empty((2 if antithetic else 1, n_paths), dtype=torch.float32, device=params.device)
    EXACT_VALUES_KERNEL.launch(
        params.device, params.data_ptr(), None if table is None else table.data_ptr(),
        out.data_ptr(), n_paths, segments, int(antithetic), kmax, seed & _MASK32,
        device_id & _MASK32, point_offset,
    )
    return out


def price_grid(device: torch.device) -> int:
    """K3's blocks: one resident wave of it on ``device`` (two threads a
    pair, 256 pairs a round of a block)."""
    return resident_grid("hh_exact_price_grid", device)


def price_occupancy(device) -> dict:
    """K3's occupancy on ``device`` (``cuda_lib.launch_occupancy``'s keys):
    the blocks and warps an SM behind :func:`price_grid`."""
    return launch_occupancy("hh_exact_price_occupancy", torch.device(device))


def _exact_price_sum(params, table, total_pairs, segments, kmax, seed, device_id,
                     point_offset, grid=None) -> torch.Tensor:
    """Launch K3 for inputs on a GPU (the float64 sum of its per-block
    partials); the twin for inputs on the CPU.  ``grid`` (blocks of 256
    pairs a round) defaults to :func:`price_grid`, at most one round; at
    the grid of the one-pair-a-thread kernel (2 blocks an SM) the sum keeps
    that kernel's bits."""
    _check_inputs(params, table, segments, kmax)
    check_grid(grid)
    if params.device.type == "cpu":
        return heston_exact_mixing_price_sum_plain(params, table, total_pairs, segments, kmax,
                                                   seed, device_id, point_offset)
    require_cuda(params)
    if grid is None:
        grid = min(price_grid(params.device), -(-total_pairs // 256))
    partials = torch.empty((grid,), dtype=torch.float64, device=params.device)
    EXACT_PRICE_KERNEL.launch(
        params.device, params.data_ptr(), None if table is None else table.data_ptr(),
        partials.data_ptr(), grid, total_pairs, segments, kmax, seed & _MASK32,
        device_id & _MASK32, point_offset,
    )
    return partials.sum()


def _inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp, segments, seed, qmc, device):
    dev = resolve_device(device)
    params = torch.as_tensor(
        _exact_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, segments, strike, cp), device=dev
    )
    table = torch.as_tensor(sobol_table(seed, 4 * segments), device=dev) if qmc else None
    return params, table, poisson_kmax(kappa, theta, sigma, dt, v0)


def heston_exact_mixing_values(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp,
    *, n_paths: int, segments: int, seed, antithetic: bool = False, device_id=0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """Per-path UNDISCOUNTED conditional vanilla values, (n_groups, n_paths)
    float32.  QMC is antithetic-only (the Sobol' stream is laid out in
    mirrored pairs) and guarded against the 2^30 Sobol' period."""
    if qmc and not antithetic:
        raise ValueError("kernel QMC path is antithetic-only")
    if qmc:
        padded = -(-n_paths // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK
        if point_offset + padded > 2**SOBOL_BITS:
            raise ValueError(
                f"Sobol' period is 2^{SOBOL_BITS} points; offset "
                f"{point_offset} + {padded} paths would wrap"
            )
    params, table, kmax = _inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp,
                                  segments, seed, qmc, device)
    return _exact_values(params, table, n_paths, segments, antithetic, kmax, int(seed),
                         int(device_id), point_offset)


def heston_exact_mixing_vanilla_price(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, discount,
    *, n_blocks: int, n_batches: int, segments: int, seed, device_id=0, cp=1.0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """Discounted European vanilla price over n_blocks·n_batches·32768
    antithetic exact-mixing pairs in ONE launch, accumulated on the device:
    the serving configuration.  Returns a float64 0-dim tensor."""
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    if qmc and point_offset + total_pairs > 2**SOBOL_BITS:
        raise ValueError(
            f"Sobol' period is 2^{SOBOL_BITS} points; offset {point_offset} + "
            f"{total_pairs} pairs would wrap"
        )
    params, table, kmax = _inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp,
                                  segments, seed, qmc, device)
    sums = _exact_price_sum(params, table, total_pairs, segments, kmax, int(seed),
                            int(device_id), point_offset)
    return discount * sums / (2 * total_pairs)


# ---- exact-transition surface: K4, a whole (expiry × strike) grid per launch ----

#: the surface kernel's parameter vector (the TPU kernels' ``_exact_surf_params``):
#: globals, the Δ-independent block, ``XS_PER_GAP`` per expiry gap, then f_base
#: and c_j = V0 + κθT_i per expiry, the m strikes and log(f_base_i / K_k)
XS_GLOBALS = ("v0", "rho", "rho2_half", "rho_bar2", "cp", "inv_sigma", "k_over_sigma")
XS_SHARED = ("d_half", "nu", "nu2", "an1", "an2", "an3", "ad1", "ad2", "ad3", "m1f", "s2f",
             "inv_kappa")
XS_PER_GAP = ("lam_fac", "two_cfac", "z_fac", "l1c", "l1x", "l2c", "l2x", "q", "q2", "p_c")
#: K4's pairs a round of a block (two threads a pair), its float64 rows of
#: sums (one a 32 consecutive pairs) and the points a round stages before
#: adding them (whole expiries; csrc/heston_exact.cu)
_XS_PAIRS = 256
_XS_ROWS = _XS_PAIRS // 32
_XS_STAGE = 48


def exact_surface_smem_bytes(n_exp: int, m: int, total_segs: int, qmc: bool) -> int:
    """K4's dynamic shared memory (csrc/heston_exact.cu ``xs_layout``): the
    float64 rows of sums per point, a round's fp32 pair values at the staged
    points (up to 48, or one expiry's ``m`` strikes where ``m`` is more), a
    33-float parameter struct, the segment count and the Poisson trip count
    per expiry, 28 bytes of close constants per point, the Sobol' table."""
    n_cols = n_exp * m
    cap = m if m > _XS_STAGE else min(n_cols, _XS_STAGE)
    return (8 * _XS_ROWS * n_cols + 4 * _XS_PAIRS * cap + (4 * len(_P_NAMES) + 8) * n_exp
            + 28 * n_cols + (4 * 4 * total_segs * (SOBOL_BITS + 1) if qmc else 0))


EXACT_SURFACE_KERNEL = CudaKernel("hh_exact_surface", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
    ctypes.c_uint, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
])


def exact_surface_staged(n_exp: int, total_segs: int, qmc: bool) -> bool:
    """Whether K4 stages the Sobol' table of ``total_segs`` segments in
    shared memory: the one staging decision of the exact surface kernel,
    made here for every launch and followed by csrc/heston_exact.cu (a
    one-strike launch with the table fits ``SURFACE_SMEM_LIMIT``)."""
    return staged_rows(4 * total_segs if qmc else 0, lambda w, rows: exact_surface_smem_bytes(
        n_exp, w, rows // 4, rows > 0)) > 0


def exact_surf_nparams(n_exp: int, m: int) -> int:
    return (len(XS_GLOBALS) + len(XS_SHARED) + len(XS_PER_GAP) * n_exp + 2 * n_exp + m
            + n_exp * m)


def _exact_surf_params(log_s0, v0, r, kappa, theta, sigma, rho, T_host, seg_steps, strikes,
                       cp) -> np.ndarray:
    """K4's parameter vector: float64 host math, each entry cast once; the
    coefficient formulas are models/heston_exact.py's, as ``_exact_params``'s."""
    log_s0, v0, r, kappa, theta, sigma, rho, cp = (
        float(x) for x in (log_s0, v0, r, kappa, theta, sigma, rho, cp))
    strikes = [float(k) for k in strikes]
    entries = [v0, rho, 0.5 * rho**2, 1.0 - rho**2, cp, 1.0 / sigma, kappa / sigma]
    shared = cir_exact_shared_coeffs(kappa, theta, sigma)
    entries += [shared[n] for n in XS_SHARED]
    for dt_i in segment_dts(T_host, seg_steps):
        gap = cir_exact_kernel_coeffs(kappa, theta, sigma, dt_i)
        entries += [gap[n] for n in XS_PER_GAP]
    f_bases = [float(np.exp(log_s0 + r * T_i)) for T_i in T_host]
    entries += f_bases + [v0 + kappa * theta * T_i for T_i in T_host] + strikes
    entries += [np.log(f) - np.log(k) for f in f_bases for k in strikes]
    return np.array([float(x) for x in entries], dtype=np.float64).astype(np.float32)


def exact_surf_c(params: torch.Tensor, n_exp: int, i: int) -> dict:
    """Gap i's constants in the layout ``_exact_segment`` reads (the TPU
    kernels' ``_exact_surf_c``)."""
    vals = params.unbind()
    c = dict(zip(XS_GLOBALS, vals))
    off = len(XS_GLOBALS)
    c.update(zip(XS_SHARED, vals[off:off + len(XS_SHARED)]))
    off += len(XS_SHARED) + len(XS_PER_GAP) * i
    c.update(zip(XS_PER_GAP, vals[off:off + len(XS_PER_GAP)]))
    return c


def _exact_surf_close(params, c, n_exp: int, m: int, i: int, k: int) -> dict:
    """Point (i, k)'s close constants over gap constants ``c`` (the TPU
    kernels' ``_exact_surf_fold``): c_j = V0 + κθT_i closes J by the
    full-horizon CIR identity."""
    f_off = len(XS_GLOBALS) + len(XS_SHARED) + len(XS_PER_GAP) * n_exp
    k_off = f_off + 2 * n_exp
    return dict(c, f_base=params[f_off + i], c_j=params[f_off + n_exp + i],
                strike=params[k_off + k], log_f_over_k=params[k_off + m + i * m + k])


def _exact_surface_pairs_plain(params, table, seg_steps, kmaxes, m, pair, seed, device_id,
                               point_offset):
    """(n_exp·m, len(pair)) fp32 values, each the sum of a pair's two paths,
    of every surface point."""
    n_exp = len(seg_steps)
    c = exact_surf_c(params, n_exp, 0)
    v = c["v0"].expand(pair.shape)
    iv = torch.zeros_like(v)
    va, iva = v, iv
    masks = sobol_masks(pair + point_offset) if table is not None else None
    rows, s = [], 0
    for i, steps_i in enumerate(seg_steps):
        c = exact_surf_c(params, n_exp, i)
        for _ in range(steps_i):
            u_pois, z_gam, u_boost, z_iv = _exact_draws(pair, s, masks, table, seed, device_id)
            v, iv = _exact_segment(v, iv, u_pois, z_gam, u_boost, z_iv, c, kmaxes[i])
            va, iva = _exact_segment(va, iva, _mirror_pois(u_pois), -z_gam, 1.0 - u_boost, -z_iv,
                                     c, kmaxes[i])
            s += 1
        for k in range(m):
            ck = _exact_surf_close(params, c, n_exp, m, i, k)
            rows.append(_exact_close(v, iv, ck) + _exact_close(va, iva, ck))
    return torch.stack(rows)


def heston_exact_mixing_surface_sums_plain(params, table, seg_steps, kmaxes, m: int,
                                           total_pairs: int, seed: int, device_id: int,
                                           point_offset: int) -> torch.Tensor:
    """Twin of K4: the float64 sum over the pairs [0, total_pairs) of each
    point's per-pair fp32 value, (n_exp·m,) point-major."""
    total = torch.zeros(len(seg_steps) * m, dtype=torch.float64, device=params.device)
    for pair in pair_chunks(total_pairs, params.device):
        vals = _exact_surface_pairs_plain(params, table, seg_steps, kmaxes, m, pair, seed,
                                          device_id, point_offset)
        total = total + vals.to(torch.float64).sum(dim=1)
    return total


def _exact_surface_sums(params, table, seg_steps, kmaxes, m, total_pairs, seed, device_id,
                        point_offset, grid=None) -> torch.Tensor:
    """Launch K4 for inputs on a GPU (per-point float64 sums); the twin for
    inputs on the CPU.  ``grid`` (blocks of 256 pairs a round) defaults to
    one resident wave; another grid sums the same pair values in another
    order (the earlier kernel's grid gives its bits)."""
    n_exp = len(seg_steps)
    check_surface(params, table, seg_steps, m, exact_surf_nparams(n_exp, m), 4)
    if len(kmaxes) != n_exp or not all(1 <= k <= _KMAX_LIMIT for k in kmaxes):
        raise ValueError(f"Poisson trip counts {kmaxes} outside [1, {_KMAX_LIMIT}]")
    check_grid(grid)
    if params.device.type == "cpu":
        return heston_exact_mixing_surface_sums_plain(params, table, seg_steps, kmaxes, m,
                                                      total_pairs, seed, device_id, point_offset)
    require_cuda(params)
    total_segs = sum(seg_steps)
    staged = exact_surface_staged(n_exp, total_segs, table is not None)
    if grid is None:
        grid = resident_grid("hh_exact_surface_grid", params.device, n_exp, m, total_segs,
                             int(table is not None), int(staged))
    ints = torch.tensor([*seg_steps, *kmaxes], dtype=torch.int32, device=params.device)
    partials = torch.empty((n_exp * m, grid), dtype=torch.float64, device=params.device)
    out = torch.empty((n_exp * m,), dtype=torch.float64, device=params.device)
    EXACT_SURFACE_KERNEL.launch(
        params.device, params.data_ptr(), ints.data_ptr(),
        None if table is None else table.data_ptr(), partials.data_ptr(), out.data_ptr(), grid,
        n_exp, m, total_segs, total_pairs, seed & _MASK32, device_id & _MASK32, point_offset,
        int(staged),
    )
    return out


def exact_surface_occupancy(n_exp: int, m: int, total_segs: int, qmc: bool,
                            device="cuda") -> dict:
    """K4's occupancy on ``device`` at one launch's shared memory (the
    table staged as :func:`exact_surface_staged` decides), from the CUDA
    runtime: threads a block, resident blocks and warps per SM, SMs, dynamic
    and static shared bytes, registers and local (spill) bytes a thread."""
    staged = exact_surface_staged(n_exp, total_segs, qmc)
    return launch_occupancy("hh_exact_surface_occupancy", torch.device(device), n_exp, m,
                            total_segs, int(qmc), int(staged))


def heston_exact_mixing_surface_price(
    log_s0, v0, r, kappa, theta, sigma, rho, T_host, strikes, discounts,
    *, seg_steps, n_strikes: int, n_blocks: int, n_batches: int, seed, cp=1.0,
    device_id=0, qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """(n_exp, n_strikes) DISCOUNTED exact-transition surface prices over
    n_blocks·n_batches·32768 antithetic pairs: per expiry gap
    ``seg_steps[i]`` exact segments (the segment index running across gaps)
    with that gap's Poisson trip count, every strike closed at each expiry.
    Returns float64 on the device."""
    T_host, seg_steps, strikes, disc, total_pairs, dev = surface_args(
        T_host, seg_steps, strikes, n_strikes, discounts, n_blocks, n_batches, qmc,
        point_offset, device)
    kmaxes = [poisson_kmax(kappa, theta, sigma, dt_i, v0) for dt_i in segment_dts(T_host, seg_steps)]
    table = torch.as_tensor(sobol_table(seed, 4 * sum(seg_steps)), device=dev) if qmc else None
    rows = []
    n_exp, total_segs = len(T_host), sum(seg_steps)
    staged = exact_surface_staged(n_exp, total_segs, qmc)
    for sl in strike_chunks(n_strikes, lambda w: exact_surface_smem_bytes(
            n_exp, w, total_segs if staged else 0, staged)):
        params = torch.as_tensor(_exact_surf_params(log_s0, v0, r, kappa, theta, sigma, rho,
                                                    T_host, seg_steps, strikes[sl], cp),
                                 device=dev)
        m = len(strikes[sl])
        rows.append(_exact_surface_sums(params, table, seg_steps, kmaxes, m, total_pairs,
                                        int(seed), int(device_id),
                                        point_offset).reshape(len(T_host), m))
    return disc[:, None] * (torch.cat(rows, dim=1) / (2 * total_pairs))


def heston_exact_mixing_values_adapter(prob, config, strat, key=None, device_id=0,
                                       point_offset=0, *, device):
    """``MonteCarlo(HestonDynamics(), HestonExactMixing(use_kernel=True))``:
    float64 per-path values (n_groups, trajectories) from the kernel, the
    counterpart of the JAX ``heston_exact_mixing_values_pallas``.  Under QMC
    the seed is always ``config.seed`` (devices slice one shared sequence by
    ``point_offset``); under PRNG an explicit ``key`` reseeds the stream."""
    from ..market.inputs import carry_yield, market_yearfrac
    from ..market.rate_curve import zero_rate_yf
    from ..methods.montecarlo import Antithetic
    from .heston_kernel import heston_scalars, seed_from_key

    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    rate, carry = zero_rate_yf(market.rate, 0.0), carry_yield(market)
    r0 = float(rate) - float(carry)
    out = heston_exact_mixing_values(
        np.log(float(market.spot)), float(market.V0), r0, float(market.kappa),
        float(market.theta), float(market.sigma), float(market.rho), T / config.steps,
        float(prob.payoff.strike), prob.payoff.call_put(),
        n_paths=config.trajectories, segments=config.steps,
        seed=config.seed if config.qmc else seed_from_key(config, key),
        antithetic=isinstance(config.variance_reduction, Antithetic), device_id=device_id,
        qmc=config.qmc, point_offset=point_offset, device=device,
    )
    return no_derivative(out.to(torch.float64), host_float_kernel("K2"), *heston_scalars(market),
                         rate, carry, prob.payoff.expiry, prob.payoff.strike)
