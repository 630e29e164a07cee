"""Plain PyTorch twins of the shared device helpers in ``csrc/hh_device.cuh``.

Port of the helpers the Pallas kernels share (ops/heston_kernel.py
``_uniform_from_bits``/``_box_muller``; ops/heston_qe_kernel.py
``_sobol_table``/``_sobol_masks``/``_sobol_uniforms_tile``/``_ndtri_approx``/
``_rcp``/``_norm_cdf``/``_cond_bs_value``, for the QE mixing kernels
``_mix_c``'s parameter layout, ``_qe_v_advance`` and ``_mix_advance``, and
for the QE-M terminal kernels their parameter layout and ``_qe_advance``;
the QE draw is written once, :func:`qe_v_draw`, as the header's
``qe_v_draw``).
Everything is float32 on
float32 tensors, with the constants and the operation order of the CUDA
header, so that a kernel and its twin agree to fp32 rounding.  The twins
evaluate both sides of every branch and select, as the TPU kernels do; the
CUDA helpers evaluate only the side a lane takes, which gives the same value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..math.counter_rng import philox4x32, prng_key, uniform_from_bits
from ..math.sobol import _BITS as SOBOL_BITS
from ..math.sobol import _direction_numbers, sobol_shift
from ..models.heston_qe import PSI_CRIT

__all__ = [
    "SOBOL_BITS",
    "box_muller",
    "box_muller_open",
    "philox_block",
    "rcp",
    "sobol_table",
    "sobol_masks",
    "sobol_bits",
    "sobol_uniforms_tile",
    "sobol_uniforms_open_tile",
    "sobol_uniform_top",
    "sobol_normals_tile",
    "ndtri_approx",
    "norm_cdf",
    "cond_bs_value",
    "MIX_NAMES",
    "mix_c",
    "qe_v_draw",
    "qe_v_advance",
    "mix_update",
    "mix_advance",
    "SURF_GLOBALS",
    "SURF_PER_SEG",
    "surf_c",
    "surf_close",
    "QEM_NAMES",
    "qem_c",
    "qem_advance",
]

_MASK32 = 0xFFFFFFFF
_SOBOL_SCALE = 2.0**-SOBOL_BITS
#: the centre of the Box–Muller radius uniform's zero cell
_BM_ZERO_CELL = 2.0**-24
#: the largest float32 below 1: a Sobol' uniform of the 32 top cells
_U_OPEN_MAX = 1.0 - 2.0**-24


def philox_block(pair: torch.Tensor, block: int, seed: int, device_id: int, tag: int = 0):
    """The four Philox words of draw block ``block`` of each antithetic pair
    (int64 tensor of global pair indices); layout in math/counter_rng.py.
    ``tag`` fills the counter's last word: 0 for the kernels' streams, a
    constant of its own for each stream drawn beside them."""
    ctr = (pair & _MASK32, pair >> 32, torch.full_like(pair, block), torch.full_like(pair, tag))
    return philox4x32(ctr, (seed, device_id))


def _polar(u1: torch.Tensor, b1: torch.Tensor, dtype):
    """Two normals from the radius uniform ``u1`` and the angle word ``b1``."""
    r = torch.sqrt(-2.0 * torch.log(u1.to(dtype)))
    theta = (2.0 * math.pi) * uniform_from_bits(b1).to(dtype)
    return r * torch.cos(theta), r * torch.sin(theta)


def box_muller(b0: torch.Tensor, b1: torch.Tensor, dtype=torch.float32):
    """Two iid N(0, 1) tensors from two words of random bits; the
    arithmetic runs in ``dtype`` from the (exact) float32 uniforms.  The
    radius uniform's zero cell is taken at its centre, 2^-24 (|z| ≤ 5.77);
    every other word keeps its uniform (the TPU kernels floor zero at
    FLT_MIN: a 13.2-sigma normal once in 2^23 draws)."""
    return _polar(torch.clamp(uniform_from_bits(b0), min=_BM_ZERO_CELL), b1, dtype)


def box_muller_open(b0: torch.Tensor, b1: torch.Tensor, dtype=torch.float32):
    """:func:`box_muller` with the radius uniform centred in its 2^-23 cell,
    in (0, 1), so |z| ≤ √(−2 ln 2^-24) = 5.77 (the rough-Bergomi stream: a
    13-sigma normal from a floored zero uniform explodes e^{ηZ})."""
    return _polar(((b0 >> 9).to(torch.float32) + 0.5) * 2.0**-23, b1, dtype)


def rcp(x: torch.Tensor) -> torch.Tensor:
    """Reciprocal estimate plus one Newton polish (the TPU kernels' ``_rcp``;
    the estimate is the exact reciprocal here and MUFU.RCP on the card)."""
    r = torch.reciprocal(x)
    return r * (2.0 - x * r)


def sobol_table(seed: int, n_dims: int) -> np.ndarray:
    """(n_dims, 31) int32 table: 30 Joe–Kuo direction numbers per dimension
    plus the digital shift, derived from ``seed`` only (never the device
    id: devices slice ONE shared sequence by point offset)."""
    V = _direction_numbers(n_dims).astype(np.int64)
    shift = sobol_shift(prng_key(seed), n_dims).astype(np.int64)
    return np.concatenate([V, shift[:, None]], axis=1).astype(np.int32)


def sobol_masks(idx: torch.Tensor):
    """The 30 per-bit masks of the point indices, computed once per path."""
    return [((idx >> b) & 1).bool() for b in range(SOBOL_BITS)]


def sobol_bits(masks, table: torch.Tensor, d: int) -> torch.Tensor:
    """The 30-bit Sobol' integers (int64) of dimension ``d``."""
    acc = torch.zeros(masks[0].shape, dtype=torch.int64, device=masks[0].device)
    for b in range(SOBOL_BITS):
        acc = torch.where(masks[b], acc ^ table[d, b], acc)
    return acc ^ table[d, SOBOL_BITS]


def _centred(a: torch.Tensor) -> torch.Tensor:
    """(a + 1/2)·2^-30 in float32: integers a ≥ 2^30 − 32 round to 1.0."""
    return (a.to(torch.float32) + 0.5) * _SOBOL_SCALE


def sobol_uniforms_tile(masks, table: torch.Tensor, dims):
    """float32 Sobol' uniforms in (0, 1] of the dimensions ``dims`` (1.0 in
    the 32 top cells of each, as the TPU kernels')."""
    return [_centred(sobol_bits(masks, table, d)) for d in dims]


def sobol_uniforms_open_tile(masks, table: torch.Tensor, dims):
    """:func:`sobol_uniforms_tile` in (0, 1) (the header's
    ``sobol_uniform_open``): 1 − 2^-24, the float32 in (0, 1) nearest
    (a + 1/2)·2^-30, in the 32 top cells, so their antithetic 1 − u is
    2^-24; every other cell keeps its bits."""
    return [torch.clamp(u, max=_U_OPEN_MAX) for u in sobol_uniforms_tile(masks, table, dims)]


def _sobol_complement(a: torch.Tensor) -> torch.Tensor:
    """1 − (a + 1/2)·2^-30 of a top cell, (2^30 − 1 − a + 1/2)·2^-30: exact in
    float32 (the header's ``sobol_complement``)."""
    return _centred((1 << SOBOL_BITS) - 1 - a)


def sobol_uniform_top(masks, table: torch.Tensor, dim: int):
    """The exact kernels' Poisson uniform of dimension ``dim`` (the header's
    ``sobol_uniform_top``): the float32 Sobol' uniform, except in the 32 top
    cells (1.0 in float32), which give −w, minus the exact complement w = 1 −
    (a + 1/2)·2^-30."""
    a = sobol_bits(masks, table, dim)
    u = _centred(a)
    return torch.where(u < 1.0, u, -_sobol_complement(a))


def sobol_normals_tile(masks, table: torch.Tensor, dims):
    """float32 normals of the dimensions ``dims`` (the header's
    ``sobol_normal``): ``ndtri_approx`` of the uniform, except where the
    uniform is 1.0, where the tail takes u_min from the integer,
    (2^30 − 1 − a + 1/2)·2^-30, instead of returning 11.46."""
    out = []
    for d in dims:
        a = sobol_bits(masks, table, d)
        u = _centred(a)
        top = _ndtri_tail(_sobol_complement(a))
        out.append(torch.where(u < 1.0, ndtri_approx(u), top))
    return out


_BSM_A = (2.50662823884, -18.61500062529, 41.39119773534, -25.44106049637)
_BSM_B = (-8.47351093090, 23.08336743743, -21.06224101826, 3.13082909833)
_BSM_C = (
    0.3374754822726147, 0.9761690190917186, 0.1607979714918209,
    0.0276438810333863, 0.0038405729373609, 0.0003951896511919,
    0.0000321767881768, 0.0000002888167364, 0.0000003960315187,
)


def _ndtri_tail(u_min: torch.Tensor) -> torch.Tensor:
    """The Beasley-Springer-Moro tail: |Φ⁻¹(u)| from u_min = min(u, 1 − u)."""
    s = torch.log(-torch.log(torch.clamp(u_min, min=1e-30)))
    x = torch.full_like(u_min, _BSM_C[-1])
    for c in reversed(_BSM_C[:-1]):
        x = x * s + c
    return x


def ndtri_approx(u: torch.Tensor) -> torch.Tensor:
    """Beasley-Springer-Moro Φ⁻¹(u), float32, for u in (0, 1) (at u = 1.0
    the tail sees u_min = 0 and returns +11.46)."""
    r = u - 0.5
    t = r * r
    num = r * (_BSM_A[0] + t * (_BSM_A[1] + t * (_BSM_A[2] + t * _BSM_A[3])))
    den = 1.0 + t * (_BSM_B[0] + t * (_BSM_B[1] + t * (_BSM_B[2] + t * _BSM_B[3])))
    x_central = num * rcp(den)
    x_tail = _ndtri_tail(torch.minimum(u, 1.0 - u))
    x_tail = torch.where(r > 0.0, x_tail, -x_tail)
    return torch.where(torch.abs(r) <= 0.42, x_central, x_tail)


_NCDF_P = 0.2316419
_NCDF_B = (0.319381530, -0.356563782, 1.781477937, -1.821255978, 1.330274429)
_INV_SQRT_2PI = 0.3989422804014327


def norm_cdf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 26.2.17 Φ(x), float32, |err| < 7.5e-8."""
    ax = torch.abs(x)
    t = rcp(1.0 + _NCDF_P * ax)
    poly = t * (_NCDF_B[0] + t * (_NCDF_B[1] + t * (
        _NCDF_B[2] + t * (_NCDF_B[3] + t * _NCDF_B[4]))))
    upper = 1.0 - _INV_SQRT_2PI * torch.exp(-0.5 * ax * ax) * poly
    return torch.where(x >= 0.0, upper, 1.0 - upper)


def cond_bs_value(iv: torch.Tensor, j: torch.Tensor, c: dict) -> torch.Tensor:
    """Undiscounted conditional Black-Scholes vanilla value given (IV, J);
    ``c`` maps the parameter names to float32 0-dim tensors."""
    e_arg = c["rho"] * j - c["rho2_half"] * iv
    f_eff = c["f_base"] * torch.exp(e_arg)
    var = torch.clamp(c["rho_bar2"] * iv, min=1e-10)
    sd = torch.sqrt(var)
    inv_sd = rcp(sd)
    d1 = (c["log_f_over_k"] + e_arg + 0.5 * var) * inv_sd
    d2 = d1 - sd
    cp = c["cp"]
    return cp * (f_eff * norm_cdf(cp * d1) - c["strike"] * norm_cdf(cp * d2))


# ---- QE mixing ----------------------------------------------------------------

#: the 16-entry parameter vector of the QE mixing kernels (csrc/hh_device.cuh
#: MixParams; the TPU kernels' ``_mix_c``); the last seven are the close's
MIX_NAMES = (
    "v0", "theta", "e", "c_s2_v", "c_s2_c", "half_dt", "inv_sigma", "k_over_sigma",
    "ktd_over_sigma", "f_base", "strike", "rho", "rho2_half", "rho_bar2", "cp", "log_f_over_k",
)


def mix_c(params: torch.Tensor) -> dict:
    """The parameter vector as a dict of float32 0-dim tensors."""
    return dict(zip(MIX_NAMES, params.unbind()))


def qe_v_draw(v, z, u, c):
    """V → V' by the QE scheme with the fp32 guards of the kernels (m ≥ 1e-20,
    ψ ≥ 1e-6, p ≤ 1 − 1e-6, 1/β = m·(ψ + 1)/2 capped at m·1e6, u clamped to
    [1e-7, 1 − 1e-7]).  Returns (vn, d): ``d`` holds the intermediates the
    tangent coefficients read (the header's ``QeDraw``).  Both branches are
    evaluated and selected; the dead side stays finite."""
    theta = c["theta"]
    m = theta + (v - theta) * c["e"]
    s2 = v * c["c_s2_v"] + c["c_s2_c"]
    m_safe = torch.clamp(m, min=1e-20)
    inv_m = rcp(m_safe)
    psi_raw = s2 * inv_m * inv_m
    psi = torch.clamp(psi_raw, min=1e-6)

    inv_psi = rcp(psi)
    top = 2.0 * inv_psi
    t1 = torch.clamp(top - 1.0, min=0.0)
    sqw = torch.sqrt(top * t1)
    b2 = t1 + sqw
    rb = rcp(1.0 + b2)
    a = m * rb
    sqb = torch.sqrt(b2)
    q = sqb + z

    p_raw = (psi - 1.0) * rcp(psi + 1.0)
    p = torch.clamp(p_raw, 0.0, 1.0 - 1e-6)
    capfac = torch.clamp((psi + 1.0) * 0.5, max=1e6)
    u_safe = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    lterm = torch.log((1.0 - p) * rcp(torch.clamp(1.0 - u_safe, min=1e-20)))
    e_live = u_safe > p
    quad = psi <= PSI_CRIT
    v_exp = torch.where(e_live, lterm * (m_safe * capfac), torch.zeros_like(p))
    vn = torch.where(quad, a * (q * q), v_exp)
    d = dict(m_safe=m_safe, inv_m=inv_m, psi_raw=psi_raw, psi=psi, quad=quad, inv_psi=inv_psi,
             top=top, t1=t1, sqw=sqw, b2=b2, rb=rb, a=a, sqb=sqb, q=q, p_raw=p_raw, p=p,
             capfac=capfac, lterm=lterm, e_live=e_live)
    return vn, d


def qe_v_advance(v, z, u, c):
    """V → V' by the QE scheme (:func:`qe_v_draw`'s draw)."""
    return qe_v_draw(v, z, u, c)[0]


def mix_update(v, iv, j, vn, c):
    """The mixing carries after a draw ``vn``: (V', IV', J') with the
    trapezoid IV and the exact-identity J."""
    iv_step = c["half_dt"] * (v + vn)
    j = j + (vn - v) * c["inv_sigma"] + iv_step * c["k_over_sigma"] - c["ktd_over_sigma"]
    return vn, iv + iv_step, j


def mix_advance(v, iv, j, z, u, c):
    """One mixing step: QE V-draw, trapezoid IV, J update."""
    return mix_update(v, iv, j, qe_v_advance(v, z, u, c), c)


# ---- QE mixing surfaces -----------------------------------------------------------

#: the surface kernels' parameter vector (the TPU kernels' ``_surf_params``):
#: these globals, then ``SURF_PER_SEG`` for each expiry segment, then one
#: f_base per expiry, the m strikes, and log(f_base_i / K_k) point-major
SURF_GLOBALS = ("v0", "theta", "inv_sigma", "k_over_sigma", "rho", "rho2_half", "rho_bar2", "cp")
SURF_PER_SEG = ("e", "c_s2_v", "c_s2_c", "half_dt", "ktd_over_sigma")


def surf_c(params: torch.Tensor, i: int) -> dict:
    """Segment i's step constants merged with the globals (the TPU kernels'
    ``_surf_c``; csrc/hh_device.cuh ``SurfSeg``)."""
    vals = params.unbind()
    base = len(SURF_GLOBALS) + len(SURF_PER_SEG) * i
    c = dict(zip(SURF_GLOBALS, vals))
    c.update(zip(SURF_PER_SEG, vals[base:base + len(SURF_PER_SEG)]))
    return c


def surf_close(params: torch.Tensor, c: dict, n_exp: int, m: int, i: int, k: int) -> dict:
    """Point (i, k)'s close constants over segment constants ``c``: f_base of
    expiry i, strike k, log(f_base_i / K_k) (csrc/hh_device.cuh
    ``CloseParams``)."""
    f_off = len(SURF_GLOBALS) + len(SURF_PER_SEG) * n_exp
    return dict(c, f_base=params[f_off + i], strike=params[f_off + n_exp + k],
                log_f_over_k=params[f_off + n_exp + m + i * m + k])


# ---- QE-M terminal sampler ------------------------------------------------------

#: the 14-entry parameter vector of the QE-M terminal kernels (csrc/hh_device.cuh
#: QemParams; the TPU's ``_heston_qe_terminal_impl`` layout); the call-price
#: kernel appends the strike
QEM_NAMES = (
    "log_s0", "v0", "theta", "e", "c_s2_v", "c_s2_c", "K1", "K2", "K3", "K4", "A", "r_dt",
    "K1_half_K3", "K0",
)


def qem_c(params: torch.Tensor) -> dict:
    """The first 14 entries of a parameter vector as a dict of float32 0-dim
    tensors."""
    return dict(zip(QEM_NAMES, params.unbind()))


def qem_advance(x, v, z_v, z_x, u, c, mcorr: bool):
    """One QE(-M) step of (x = log S, v): :func:`qe_v_draw`, then the
    log-price update with the martingale-corrected K0* under the kernels'
    fp32 guards (2·A·a ≤ 1 − 1e-6, ``log`` not ``log1p``, 1e-20 floors), or
    the plain K0 when ``mcorr`` is False.  Both branches are evaluated and
    selected."""
    vn, d = qe_v_draw(v, z_v, u, c)
    k0 = c["K0"]
    if mcorr:
        A = c["A"]
        two_aa = torch.clamp(2.0 * A * d["a"], max=1.0 - 1e-6)
        inv_1m2aa = rcp(1.0 - two_aa)
        log_m_quad = A * d["b2"] * d["a"] * inv_1m2aa - 0.5 * torch.log(1.0 - two_aa)
        one_m_p = 1.0 - d["p"]
        beta = one_m_p * d["inv_m"]
        denom = torch.clamp(beta - A, min=1e-20)
        log_m_exp = torch.log(torch.clamp(d["p"] + beta * one_m_p * rcp(denom), min=1e-20))
        k0 = -torch.where(d["quad"], log_m_quad, log_m_exp) - c["K1_half_K3"] * v
    var_x = torch.clamp(c["K3"] * v + c["K4"] * vn, min=0.0)
    x = x + c["r_dt"] + k0 + c["K1"] * v + c["K2"] * vn + torch.sqrt(var_x) * z_x
    return x, vn
