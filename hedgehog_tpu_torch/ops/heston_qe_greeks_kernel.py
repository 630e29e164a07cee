"""QE mixing greek kernels (K10 price + 7 greeks, K11 the values VJP, K12
the surface and its 7-parameter Jacobian), their plain PyTorch twins, and
the differentiable views of the values kernel and of the surface.

Port of the mixing part of ``hedgehog_tpu/ops/heston_qe_greeks_kernel.py``.
Both kernels replay the values/price kernels' stream (ops/heston_qe_kernel.py)
and push forward tangents through the QE scan: per step the draw's two
coefficients (∂vn = cm·∂m + cs·∂s2) are computed once and applied to every
direction (V0, κ, θ, σ, and T for K11); J's tangent closes at the end of the
path from (dV_T, dIV), and spot, ρ, rate (and the strike) close from the
conditional Black-Scholes partials.  For tensors on a GPU the work goes to
``csrc/heston_qe_greeks.cu`` (helpers in ``csrc/heston_qe.cuh``); for tensors
on the CPU to the float32 twins below.

:func:`heston_qe_mixing_values_diff` is K7 as a ``torch.autograd.Function``
whose backward is K11, so ``torch.autograd.grad`` of a kernel-backed
``solve`` price runs at kernel speed; :func:`heston_qe_mixing_surface_price_diff`
is the surface as one whose forward runs K12 when a gradient is wanted (K9
otherwise) and whose backward contracts K12's Jacobian.  K12 carries dIV
directly (the segments' dt differ), not K10's telescoped running sum.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_lib import (
    CudaKernel,
    check_grid,
    check_tensor,
    host_to_device,
    launch_occupancy,
    require_cuda,
)
from ..utils import f64, resolve_device
from .autograd_limits import ForwardState, first_order_only, refuse_forward_mode
from .heston_qe_kernel import (
    PAIRS_PER_BLOCK,
    SURF_JAC_COLS,
    _mix_params,
    _qe_values,
    _surf_params,
    check_inputs,
    check_period,
    check_surface,
    heston_qe_mixing_surface_price,
    mix_draws,
    pair_chunks,
    price_grid,
    segment_dts,
    surf_nparams,
    surface_args,
    surface_grid,
    surface_staged,
    surface_strike_chunks,
)
from .hh_device import (
    MIX_NAMES,
    mix_c,
    mix_update,
    norm_cdf,
    qe_v_draw,
    rcp,
    sobol_table,
    surf_c,
    surf_close,
)

__all__ = [
    "QE_GREEKS_KERNEL",
    "QE_VJP_KERNEL",
    "heston_qe_mixing_price_and_greeks",
    "heston_qe_mixing_greek_sums_plain",
    "heston_qe_mixing_vjp_sums_plain",
    "heston_qe_mixing_values_diff",
    "QE_SURFACE_JAC_KERNEL",
    "heston_qe_mixing_surface_price_and_jacobian",
    "heston_qe_mixing_surface_jac_sums_plain",
    "heston_qe_mixing_surface_price_diff",
]

#: columns of the tangent table: tangents of (θc, e, c_s2_v, c_s2_c,
#: half_dt relative) and (α, β, γ) of the J closure
N_COLS = 8
N_GREEK_DIRS = 4  # V0, κ, θ, σ
N_VJP_DIRS = 5  # V0, κ, θ, σ, T
_MASK32 = 0xFFFFFFFF

QE_GREEKS_KERNEL = CudaKernel("hh_qe_greeks", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
    ctypes.c_void_p,
])
QE_VJP_KERNEL = CudaKernel("hh_qe_values_vjp", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_longlong, ctypes.c_void_p,
])


# ---- the tangent helpers' twins (csrc/heston_qe.cuh) -----------------------------


def qe_v_coeffs(v, z, u, c):
    """The QE draw plus its tangent coefficients (vn, cm, cs), fp32: the
    primal is hh_device.qe_v_draw's, and the coefficients reuse its
    intermediates.  Both branches are evaluated and selected (a dead branch
    stays finite); clamped lanes (ψ at its floor, p at its clip, 1/β at its
    cap, u ≤ p) have zero slope."""
    vn, d = qe_v_draw(v, z, u, c)
    t_psi = -d["top"] * d["inv_psi"]
    rcp_prod = rcp(torch.clamp(d["sqw"] * d["sqb"], min=1e-30))
    rcp_sqw = d["sqb"] * rcp_prod
    rcp_sqb = d["sqw"] * rcp_prod
    db2_dpsi = t_psi * (1.0 + 0.5 * rcp_sqw * (d["t1"] + d["top"]))
    q = d["q"]
    q_m = q * q * d["rb"]
    q_psi = d["a"] * (q * rcp_sqb - q_m) * db2_dpsi

    e_live = d["e_live"].to(v.dtype)
    cap_live = (d["p_raw"] < 1.0 - 1e-6).to(v.dtype)
    e_m = e_live * d["lterm"] * d["capfac"]
    e_psi = e_live * cap_live * (0.5 * d["m_safe"]) * (d["lterm"] - 1.0)

    coef_m = torch.where(d["quad"], q_m, e_m)
    coef_psi = torch.where(d["quad"], q_psi, e_psi)
    coef_psi = torch.where(d["psi_raw"] > 1e-6, coef_psi, torch.zeros_like(coef_psi))  # ψ floor
    inv_m = d["inv_m"]
    cm = coef_m - 2.0 * d["psi"] * inv_m * coef_psi
    cs = coef_psi * inv_m * inv_m
    return vn, cm, cs


def tan_init(c, n_dirs: int, shape):
    """(v, iv, j, dv per direction, running sums S per direction)."""
    v = c["v0"].expand(shape)
    zero = torch.zeros_like(v)
    dvs = [torch.ones_like(v) if d == 0 else zero for d in range(n_dirs)]  # ∂V/∂V0 = 1
    return v, zero, zero, dvs, list(dvs)


def tan_step(state, z, u, c, dtab, n_dirs: int):
    """One mixing step with forward tangents; ``dtab`` is the (n_dirs, 8)
    tangent table, applied dense (the constants a direction does not move
    are exact zeros in it)."""
    v, iv, j, dvs, sums = state
    vn, cm, cs = qe_v_coeffs(v, z, u, c)
    a_coef = cm * c["e"] + cs * c["c_s2_v"]
    cols = (cm * (1.0 - c["e"]), cm * (v - c["theta"]), cs * v, cs)
    new_dvs = []
    for d in range(n_dirs):
        dvn = a_coef * dvs[d]
        for k, col in enumerate(cols):
            dvn = dvn + col * dtab[d, k]
        new_dvs.append(dvn)
    v, iv, j = mix_update(v, iv, j, vn, c)
    return v, iv, j, new_dvs, [s + dv for s, dv in zip(sums, new_dvs)]


def div_real(state, c, dtab, d: int):
    """dIV of direction d: half_dt·(2S − dV_0 − dV_T) + (dhalf_dt/half_dt)·IV
    (nonzero for the T direction only)."""
    _v, iv, _j, dvs, sums = state
    trap = 2.0 * sums[d] - dvs[d]
    if d == 0:
        trap = trap - 1.0
    return c["half_dt"] * trap + dtab[d, 4] * iv


def dj_terms(state, c, dtab, d: int, div_d):
    """dJ of direction d: dV_T/σ + (κ/σ)·dIV + α·IV + β + γ·J."""
    _v, iv, j, dvs, _sums = state
    return (c["inv_sigma"] * dvs[d] + c["k_over_sigma"] * div_d + dtab[d, 5] * iv + dtab[d, 6]
            + dtab[d, 7] * j)


def cond_bs_partials(iv, j, c):
    """fp32 conditional BS value and partials (y, y_iv, y_j, y_rho, w, Φ(cp·d2))
    with w = ∂Y/∂logS0; ∂Y/∂K = −cp·Φ(cp·d2)."""
    e_arg = c["rho"] * j - c["rho2_half"] * iv
    f_eff = c["f_base"] * torch.exp(e_arg)
    var = torch.clamp(c["rho_bar2"] * iv, min=1e-10)
    sd = torch.sqrt(var)
    inv_sd = rcp(sd)
    d1 = (c["log_f_over_k"] + e_arg + 0.5 * var) * inv_sd
    d2 = d1 - sd
    cp = c["cp"]
    phi1, phi2 = norm_cdf(cp * d1), norm_cdf(cp * d2)
    y = cp * (f_eff * phi1 - c["strike"] * phi2)
    w = cp * phi1 * f_eff
    vega_sd = f_eff * 0.3989422804014327 * torch.exp(-0.5 * d1 * d1)
    y_iv = w * (-c["rho2_half"]) + vega_sd * c["rho_bar2"] * 0.5 * inv_sd
    y_j = w * c["rho"]
    y_rho = w * (j - c["rho"] * iv) - vega_sd * c["rho"] * iv * inv_sd
    return y, y_iv, y_j, y_rho, w, phi2


def _tangent_paths(params, dtab, table, pair, steps, antithetic, seed, device_id,
                   point_offset, n_dirs):
    """The tangent states of the pairs ``pair`` (and their antithetic twins)."""
    c = mix_c(params)
    s = tan_init(c, n_dirs, pair.shape)
    sa = tan_init(c, n_dirs, pair.shape) if antithetic else None
    for z, u in mix_draws(pair, steps, table, seed, device_id, point_offset):
        s = tan_step(s, z, u, c, dtab, n_dirs)
        if antithetic:
            sa = tan_step(sa, -z, 1.0 - u, c, dtab, n_dirs)
    return c, [s] if sa is None else [s, sa]


def heston_qe_mixing_greek_sums_plain(params, dtab, table, total_pairs: int, steps: int,
                                      seed: int, device_id: int, point_offset: int):
    """Twin of K10: float64 sums over the pairs [0, total_pairs) of
    [y, chain_V0, chain_κ, chain_θ, chain_σ, w, y_ρ], each term the fp32
    sum over a pair and its antithetic twin."""
    total = torch.zeros(7, dtype=torch.float64, device=params.device)
    for pair in pair_chunks(total_pairs, params.device):
        c, (s, sa) = _tangent_paths(params, dtab, table, pair, steps, True, seed, device_id,
                                    point_offset, N_GREEK_DIRS)
        y, y_iv, y_j, y_rho, w, _ = cond_bs_partials(s[1], s[2], c)
        ya, ya_iv, ya_j, ya_rho, wa, _ = cond_bs_partials(sa[1], sa[2], c)
        cols = [y + ya]
        for d in range(N_GREEK_DIRS):
            div_d, diva_d = div_real(s, c, dtab, d), div_real(sa, c, dtab, d)
            cols.append(y_iv * div_d + y_j * dj_terms(s, c, dtab, d, div_d)
                        + ya_iv * diva_d + ya_j * dj_terms(sa, c, dtab, d, diva_d))
        cols += [w + wa, y_rho + ya_rho]
        total = total + torch.stack([x.to(torch.float64).sum() for x in cols])
    return total


def heston_qe_mixing_vjp_sums_plain(params, dtab, table, ct, n_paths: int, steps: int,
                                    antithetic: bool, seed: int, device_id: int,
                                    point_offset: int):
    """Twin of K11: float64 sums over the paths of the cotangent-weighted
    [chain_V0, chain_κ, chain_θ, chain_σ, chain_T, w, y_ρ, y_K]."""
    total = torch.zeros(8, dtype=torch.float64, device=params.device)
    for pair in pair_chunks(n_paths, params.device):
        c, states = _tangent_paths(params, dtab, table, pair, steps, antithetic, seed, device_id,
                                   point_offset, N_VJP_DIRS)
        cols = [0.0] * 8
        for st, ct_g in zip(states, ct[:, pair]):
            _y, y_iv, y_j, y_rho, w, phi2 = cond_bs_partials(st[1], st[2], c)
            for d in range(N_VJP_DIRS):
                div_d = div_real(st, c, dtab, d)
                cols[d] = cols[d] + ct_g * (y_iv * div_d + y_j * dj_terms(st, c, dtab, d, div_d))
            cols[5] = cols[5] + ct_g * w
            cols[6] = cols[6] + ct_g * y_rho
            cols[7] = cols[7] + ct_g * (-c["cp"] * phi2)
        total = total + torch.stack([x.to(torch.float64).sum() for x in cols])
    return total


# ---- host side ----------------------------------------------------------------------


def _greek_table(v0, kappa, theta, sigma, dt, steps: int, n_dirs: int) -> np.ndarray:
    """(n_dirs, 8) float32 tangent table of the directions (V0, κ, θ, σ[, T]):
    columns 0-4 the tangents of (θc, e, c_s2_v, c_s2_c, half_dt), column 4
    relative (dhalf_dt/half_dt); columns 5-7 (α, β, γ) of the J closure.
    Derived from methods/mixing_greeks.greek_tables, the float64 forward
    greeks' tables, so the two cannot drift."""
    from ..methods.mixing_greeks import greek_tables

    dc, djc = greek_tables(kappa, theta, sigma, dt * steps, steps)
    dc = dc.clone()
    dc[:, 4] = dc[:, 4] / (0.5 * dt)
    return torch.cat([dc, djc], dim=1)[:n_dirs].numpy().astype(np.float32)


def _assemble_grad7(tot, log_s0, r, T, discount, price):
    """The greek vector in GREEK_ORDER (spot, V0, κ, θ, σ, ρ, flat rate) from
    the per-path means tot = [ȳ, chain_V0, chain_κ, chain_θ, chain_σ, w̄, ρ̄];
    the rate greek assumes ``discount = e^{−rT}``.  Each element takes the
    operations of its own formula: spot discount·w̄/S0 (w = ∂Y/∂logS0), V0
    to ρ discount·chain, the flat rate discount·w̄·T − T·price (discount term
    included), in five launches on the tensor's device."""
    spot = float(np.exp(log_s0))
    out = discount * torch.cat([tot[5:6], tot[1:5], tot[6:7], tot[5:6]])
    return torch.cat([out[:1] / spot, out[1:6], out[6:] * T - T * price])


def greeks_occupancy(steps: int, qmc: bool, device) -> dict:
    """K10's occupancy on ``device`` at ``steps`` steps on one stream
    (``cuda_lib.launch_occupancy``'s keys): its blocks an SM against K8's
    grid, :func:`~hedgehog_tpu_torch.ops.heston_qe_kernel.price_grid`."""
    return launch_occupancy("hh_qe_greeks_occupancy", torch.device(device), steps, int(qmc))


def _greek_sums(params, dtab, table, total_pairs, steps, seed, device_id,
                point_offset, grid=None) -> torch.Tensor:
    """Launch K10 for inputs on a GPU (seven float64 sums of its per-block
    partials); the twin for inputs on the CPU.  ``grid`` defaults to K8's,
    :func:`~hedgehog_tpu_torch.ops.heston_qe_kernel.price_grid`: at one grid
    K10's price is K8's to the bit."""
    check_inputs(params, table, steps)
    check_tensor(dtab, "tangent table", torch.float32, (N_GREEK_DIRS, N_COLS))
    check_grid(grid)
    if params.device.type == "cpu":
        return heston_qe_mixing_greek_sums_plain(params, dtab, table, total_pairs, steps, seed,
                                                 device_id, point_offset)
    require_cuda(params)
    grid = price_grid(params.device, table) if grid is None else grid
    partials = torch.empty((7, grid), dtype=torch.float64, device=params.device)
    QE_GREEKS_KERNEL.launch(
        params.device, params.data_ptr(), dtab.data_ptr(),
        None if table is None else table.data_ptr(), partials.data_ptr(), grid, total_pairs,
        steps, seed & _MASK32, device_id & _MASK32, point_offset,
    )
    # each row reduced as K8's (grid,) partials are, so the two prices are
    # equal to the bit (the card tests hold them so)
    return partials.sum(dim=1)


def _vjp_sums(params, dtab, table, ct, n_paths, steps, antithetic, seed, device_id,
              point_offset) -> torch.Tensor:
    """Launch K11 for inputs on a GPU (eight float64 sums); the twin for
    inputs on the CPU."""
    check_inputs(params, table, steps)
    check_tensor(dtab, "tangent table", torch.float32, (N_VJP_DIRS, N_COLS))
    check_tensor(ct, "cotangent", torch.float32, (2 if antithetic else 1, n_paths))
    if params.device.type == "cpu":
        return heston_qe_mixing_vjp_sums_plain(params, dtab, table, ct, n_paths, steps,
                                               antithetic, seed, device_id, point_offset)
    require_cuda(params)
    blocks = -(-n_paths // 256)
    partials = torch.empty((8, blocks), dtype=torch.float64, device=params.device)
    QE_VJP_KERNEL.launch(
        params.device, params.data_ptr(), dtab.data_ptr(),
        None if table is None else table.data_ptr(), ct.data_ptr(), partials.data_ptr(),
        n_paths, steps, int(antithetic), seed & _MASK32, device_id & _MASK32, point_offset,
    )
    return partials.sum(dim=1)


def heston_qe_mixing_price_and_greeks(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, discount,
    *, n_blocks: int, n_batches: int, steps: int, seed, device_id=0, cp=1.0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
):
    """Discounted European vanilla price AND its 7-parameter greek vector
    (methods/mixing_greeks.GREEK_ORDER: spot, V0, κ, θ, σ, ρ, flat rate) over
    n_blocks·n_batches·32768 antithetic mixing pairs in ONE launch.  The
    stream and the pairs per thread are those of
    :func:`~hedgehog_tpu_torch.ops.heston_qe_kernel.heston_qe_mixing_vanilla_price`,
    so the price equals the price kernel's; the greeks are the exact pathwise
    derivatives of that estimator.  Returns (float64 0-dim, float64 (7,))."""
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    check_period(qmc, point_offset, total_pairs)
    dev = resolve_device(device)
    # the parameters and the tangent table in one copy
    n_params = len(MIX_NAMES)
    packed = host_to_device(np.concatenate([
        _mix_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, steps, strike, cp),
        _greek_table(v0, kappa, theta, sigma, dt, steps, N_GREEK_DIRS).ravel()]), dev)
    params, dtab = packed[:n_params], packed[n_params:].view(N_GREEK_DIRS, N_COLS)
    table = host_to_device(sobol_table(seed, 2 * steps), dev) if qmc else None
    sums = _greek_sums(params, dtab, table, total_pairs, steps, int(seed), int(device_id),
                       point_offset)
    total_paths = 2 * total_pairs
    price = discount * sums[0] / total_paths
    return price, _assemble_grad7(sums / total_paths, log_s0, r, dt * steps, discount, price)


def _values_inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp, steps, seed, qmc,
                   device, tangents: bool):
    """K7's parameters, under QMC the Sobol' table, and (``tangents``) K11's
    (5, 8) tangent table on ``device``: the parameters and the tangent table
    in one pinned asynchronous copy, the table in another
    (``cuda_lib.host_to_device``).  Returns (params, tangent table or None,
    Sobol' table or None)."""
    dev = resolve_device(device)
    rows = [_mix_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, steps, strike, cp)]
    if tangents:
        rows.append(_greek_table(v0, kappa, theta, sigma, dt, steps, N_VJP_DIRS).ravel())
    packed = host_to_device(np.concatenate(rows), dev)
    n_params = len(MIX_NAMES)
    params = packed[:n_params]
    dtab = packed[n_params:].view(N_VJP_DIRS, N_COLS) if tangents else None
    table = host_to_device(sobol_table(seed, 2 * steps), dev) if qmc else None
    return params, dtab, table


def _vjp_grads(sums, r, dt, steps):
    """The nine gradients of :func:`_mixing_values_vjp` from K11's eight
    sums, on the sums' device."""
    ch_v0, ch_k, ch_th, ch_sig, ch_T, w_sum, rho_sum, k_sum = sums.unbind()
    T = dt * steps
    # f_base = e^{logS0 + rT}; the values are undiscounted
    return (w_sum, ch_v0, w_sum * T, ch_k, ch_th, ch_sig, rho_sum, (ch_T + w_sum * r) * steps,
            k_sum)


def _mixing_values_vjp(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp, ct,
    *, n_paths: int, steps: int, seed, antithetic: bool, device_id=0,
    qmc: bool = False, point_offset: int = 0,
):
    """Gradients of sum(ct·values) in the nine differentiable scalars of
    :func:`heston_qe_mixing_values` (log_s0, v0, r, κ, θ, σ, ρ, dt, strike),
    float64 0-dim tensors on ``ct.device``, from one K11 launch replaying the
    values' stream.  QMC is antithetic-only here."""
    if qmc and not antithetic:
        raise ValueError("kernel QMC path is antithetic-only")
    params, dtab, table = _values_inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp,
                                         steps, seed, qmc, ct.device, True)
    sums = _vjp_sums(params, dtab, table, ct.to(torch.float32).contiguous(), n_paths, steps,
                     antithetic, int(seed), int(device_id), point_offset)
    return _vjp_grads(sums, r, dt, steps)


class _MixingValues(torch.autograd.Function):
    """K7 forward, K11 backward, over the nine differentiable scalars.  The
    forward builds the device inputs once: K7's parameters with, where a
    gradient may be asked, K11's tangent table in the same copy, and under
    QMC the Sobol' table; the backward launches K11 on them and brings its
    eight sums to the scalars' device in one copy.  No forward mode and no
    double backward (ops/autograd_limits.py)."""

    @staticmethod
    def forward(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, opts):
        cp, kw, fwd = opts
        args = tuple(float(x) for x in (log_s0, v0, r, kappa, theta, sigma, rho, dt, strike))
        check_period(kw["qmc"], kw["point_offset"],
                     -(-kw["n_paths"] // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK)
        params, dtab, table = _values_inputs(*args, cp, kw["steps"], kw["seed"], kw["qmc"],
                                             kw["device"], kw["tangents"])
        fwd.state = (args, (params, dtab, table))
        return _qe_values(params, table, kw["n_paths"], kw["steps"], kw["antithetic"],
                          int(kw["seed"]), int(kw["device_id"]), kw["point_offset"])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.metas = [(x.dtype, x.device) for x in inputs[:9]]
        ctx.save_for_backward(*inputs[:9])
        ctx.opts = inputs[9]
        ctx.args, ctx.device_inputs = ctx.opts[2].state

    @staticmethod
    def backward(ctx, ct):
        cp, kw, _ = ctx.opts
        if kw["qmc"] and not kw["antithetic"]:
            raise ValueError("kernel QMC path is antithetic-only")
        params, dtab, table = ctx.device_inputs
        sums = _vjp_sums(params, dtab, table, ct.to(torch.float32).contiguous(), kw["n_paths"],
                         kw["steps"], kw["antithetic"], int(kw["seed"]), int(kw["device_id"]),
                         kw["point_offset"])
        devices = {dev for _, dev in ctx.metas}
        if len(devices) == 1:  # the scalars' device: one copy, not one per gradient
            sums = sums.to(devices.pop())
        grads = _vjp_grads(sums, ctx.args[2], ctx.args[7], kw["steps"])
        grads = tuple(g.to(dtype=dtype, device=dev) for g, (dtype, dev) in zip(grads, ctx.metas))
        return (*first_order_only(grads, "K11 (the QE mixing values' VJP)", ct,
                                  *ctx.saved_tensors), None)

    @staticmethod
    def jvp(ctx, *tangents):
        refuse_forward_mode("K7 (the QE mixing values, K11 its backward)")


def heston_qe_mixing_values_diff(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp,
    *, n_paths: int, steps: int, seed, antithetic: bool = False, device_id=0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
):
    """Differentiable view of :func:`heston_qe_mixing_values`: the same
    values, and a backward that runs K11 on the same stream, so
    ``torch.autograd.grad`` of any reduction of the values works.  The nine
    leading scalars (numbers or 0-dim tensors) are differentiable, ``dt`` and
    ``strike`` included."""
    args = tuple(torch.as_tensor(x, dtype=torch.float64)
                 for x in (log_s0, v0, r, kappa, theta, sigma, rho, dt, strike))
    kw = dict(n_paths=n_paths, steps=steps, seed=seed, antithetic=antithetic,
              device_id=device_id, qmc=qmc, point_offset=point_offset, device=device,
              tangents=torch.is_grad_enabled() and any(a.requires_grad for a in args))
    return _MixingValues.apply(*args, (cp, kw, ForwardState()))


# ---- surface Jacobian: K12, the surface and its 7-parameter Jacobian ---------------

N_SURF_DIRS = 4  # V0, κ, θ, σ (spot, ρ, rate close analytically)
N_SURF_COLS = SURF_JAC_COLS  # per point: y, chain × 4, w, y_ρ
#: constant-tangent columns (θc, e, c_s2_v, c_s2_c) each direction moves
_SURF_SPARSITY = ((), (1, 2, 3), (0, 3), (2, 3))
QE_SURFACE_JAC_KERNEL = CudaKernel("hh_qe_surface_jacobian", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p,
])


def tan_init_surface(c, shape):
    """(v, iv, j, dV per direction, dIV per direction) at t = 0."""
    v = c["v0"].expand(shape)
    zero = torch.zeros_like(v)
    dvs = [torch.ones_like(v) if d == 0 else zero for d in range(N_SURF_DIRS)]  # ∂V/∂V0 = 1
    return v, zero, zero, dvs, [zero] * N_SURF_DIRS


def tan_step_surface(state, z, u, c, dct, row0: int):
    """One surface step with forward tangents.  dIV is carried directly
    (dIV += half_dt·(dV + dV')): the segments' dt differ, so K10's running
    sum does not telescope.  ``dct`` rows ``row0 .. row0 + 3`` hold the
    segment's constant tangents (θc, e, c_s2_v, c_s2_c)."""
    v, iv, j, dvs, divs = state
    vn, cm, cs = qe_v_coeffs(v, z, u, c)
    a_coef = cm * c["e"] + cs * c["c_s2_v"]
    cols = (cm * (1.0 - c["e"]), cm * (v - c["theta"]), cs * v, cs)
    half_dt = c["half_dt"]
    new_dvs, new_divs = [], []
    for d in range(N_SURF_DIRS):
        dvn = a_coef * dvs[d]
        for col in _SURF_SPARSITY[d]:
            dvn = dvn + cols[col] * dct[row0 + d, col]
        new_dvs.append(dvn)
        new_divs.append(divs[d] + half_dt * (dvs[d] + dvn))
    v, iv, j = mix_update(v, iv, j, vn, c)
    return v, iv, j, new_dvs, new_divs


def surf_dj(state, c, djt, i: int, d: int):
    """dJ at expiry i in direction d: dV/σ + (κ/σ)·dIV + α·IV + β + γ·J with
    expiry i's (α, β, γ) (the elapsed time enters β)."""
    _v, iv, j, dvs, divs = state
    r = i * N_SURF_DIRS + d
    return (c["inv_sigma"] * dvs[d] + c["k_over_sigma"] * divs[d] + djt[r, 0] * iv + djt[r, 1]
            + djt[r, 2] * j)


def _surface_jac_pairs_plain(params, dct, djt, table, seg_steps, m, pair, seed, device_id,
                             point_offset):
    """(n_exp·m·7, len(pair)) fp32 per-pair sums of each point's columns
    [y, chain_V0, chain_κ, chain_θ, chain_σ, w, y_ρ], point-major."""
    n_exp = len(seg_steps)
    c0 = surf_c(params, 0)
    s, sa = tan_init_surface(c0, pair.shape), tan_init_surface(c0, pair.shape)
    draws = mix_draws(pair, sum(seg_steps), table, seed, device_id, point_offset)
    rows = []
    for i, steps_i in enumerate(seg_steps):
        c = surf_c(params, i)
        for _ in range(steps_i):
            z, u = next(draws)
            s = tan_step_surface(s, z, u, c, dct, N_SURF_DIRS * i)
            sa = tan_step_surface(sa, -z, 1.0 - u, c, dct, N_SURF_DIRS * i)
        djs = [surf_dj(s, c, djt, i, d) for d in range(N_SURF_DIRS)]
        djsa = [surf_dj(sa, c, djt, i, d) for d in range(N_SURF_DIRS)]
        for k in range(m):
            ck = surf_close(params, c, n_exp, m, i, k)
            y, y_iv, y_j, y_rho, w, _ = cond_bs_partials(s[1], s[2], ck)
            ya, ya_iv, ya_j, ya_rho, wa, _ = cond_bs_partials(sa[1], sa[2], ck)
            rows.append(y + ya)
            for d in range(N_SURF_DIRS):
                rows.append(y_iv * s[4][d] + y_j * djs[d] + ya_iv * sa[4][d] + ya_j * djsa[d])
            rows += [w + wa, y_rho + ya_rho]
    return torch.stack(rows)


def heston_qe_mixing_surface_jac_sums_plain(params, dct, djt, table, seg_steps, m: int,
                                            total_pairs: int, seed: int, device_id: int,
                                            point_offset: int) -> torch.Tensor:
    """Twin of K12: float64 sums over the pairs [0, total_pairs) of each
    point's seven columns, (n_exp·m·7,)."""
    total = torch.zeros(len(seg_steps) * m * N_SURF_COLS, dtype=torch.float64,
                        device=params.device)
    for pair in pair_chunks(total_pairs, params.device):
        vals = _surface_jac_pairs_plain(params, dct, djt, table, seg_steps, m, pair, seed,
                                        device_id, point_offset)
        total = total + vals.to(torch.float64).sum(dim=1)
    return total


def _surface_greek_tables(kappa, theta, sigma, T_host, seg_steps):
    """Per-segment constant tangents (n_exp·4, 4) of (θc, e, c_s2_v, c_s2_c)
    and per-expiry J-closure rows (n_exp·4, 3) of (α, β, γ), directions
    (V0, κ, θ, σ), float64 numpy: the closed forms of
    methods/mixing_greeks.greek_tables at segment i's dt and at expiry T_i
    (the derivatives the JAX package takes with ``jax.jacfwd``)."""
    from ..methods.mixing_greeks import greek_tables

    dct, djt = [], []
    for T_i, dt_i in zip(T_host, segment_dts(T_host, seg_steps)):
        dc, _ = greek_tables(kappa, theta, sigma, dt_i, 1)
        _, djc = greek_tables(kappa, theta, sigma, T_i, 1)
        dct.append(dc[:N_SURF_DIRS, :4])
        djt.append(djc[:N_SURF_DIRS])
    return torch.cat(dct).numpy(), torch.cat(djt).numpy()


def _surface_jac_sums(params, dct, djt, table, seg_steps, m, total_pairs, seed, device_id,
                      point_offset, grid=None) -> torch.Tensor:
    """Launch K12 for inputs on a GPU (per-point float64 sums of the seven
    columns); the twin for inputs on the CPU.  ``grid`` as K9's
    (``heston_qe_kernel._qe_surface_sums``)."""
    n_exp = len(seg_steps)
    check_surface(params, table, seg_steps, m, surf_nparams(n_exp, m), 2)
    check_tensor(dct, "constant tangents", torch.float32, (N_SURF_DIRS * n_exp, 4))
    check_tensor(djt, "J-closure rows", torch.float32, (N_SURF_DIRS * n_exp, 3))
    check_grid(grid)
    if params.device.type == "cpu":
        return heston_qe_mixing_surface_jac_sums_plain(params, dct, djt, table, seg_steps, m,
                                                       total_pairs, seed, device_id,
                                                       point_offset)
    require_cuda(params)
    grid = surface_grid(params.device) if grid is None else grid
    steps = torch.tensor(seg_steps, dtype=torch.int32, device=params.device)
    n_cols = n_exp * m * N_SURF_COLS
    partials = torch.empty((n_cols, grid), dtype=torch.float64, device=params.device)
    out = torch.empty((n_cols,), dtype=torch.float64, device=params.device)
    staged = table is not None and surface_staged(n_exp, table.shape[0], jac=True)
    QE_SURFACE_JAC_KERNEL.launch(
        params.device, params.data_ptr(), steps.data_ptr(), dct.data_ptr(), djt.data_ptr(),
        None if table is None else table.data_ptr(), partials.data_ptr(), out.data_ptr(), grid,
        n_exp, m, sum(seg_steps), total_pairs, seed & _MASK32, device_id & _MASK32, point_offset,
        int(staged),
    )
    return out


def heston_qe_mixing_surface_price_and_jacobian(
    log_s0, v0, r, kappa, theta, sigma, rho, T_host, strikes, discounts,
    *, seg_steps, n_strikes: int, n_blocks: int, n_batches: int, seed, cp=1.0,
    device_id=0, qmc: bool = False, point_offset: int = 0, device="cuda",
):
    """(surface (n_exp, m), jacobian (n_exp, m, 7)): DISCOUNTED prices and
    their derivatives in (spot, V0, κ, θ, σ, ρ, flat rate) from ONE pass of
    forward tangents over the pairs, stream and grid of
    :func:`~hedgehog_tpu_torch.ops.heston_qe_kernel.heston_qe_mixing_surface_price`,
    so the surface equals that kernel's.  The rate
    column includes the discount term (``discounts`` must be e^{−r·T_i}).
    float64 on the device."""
    T_host, seg_steps, strikes, disc, total_pairs, dev = surface_args(
        T_host, seg_steps, strikes, n_strikes, discounts, n_blocks, n_batches, qmc,
        point_offset, device)
    n_exp = len(T_host)
    dct, djt = (torch.as_tensor(t.astype(np.float32), device=dev)
                for t in _surface_greek_tables(kappa, theta, sigma, T_host, seg_steps))
    table = torch.as_tensor(sobol_table(seed, 2 * sum(seg_steps)), device=dev) if qmc else None
    rows = []
    for sl in surface_strike_chunks(n_exp, n_strikes, 0 if table is None else table.shape[0],
                                    jac=True):
        params = torch.as_tensor(_surf_params(log_s0, v0, r, kappa, theta, sigma, rho, T_host,
                                              seg_steps, strikes[sl], cp), device=dev)
        m = len(strikes[sl])
        sums = _surface_jac_sums(params, dct, djt, table, seg_steps, m, total_pairs, int(seed),
                                 int(device_id), point_offset)
        rows.append(sums.reshape(n_exp, m, N_SURF_COLS))
    tot = torch.cat(rows, dim=1) / (2 * total_pairs)
    D = disc[:, None]
    T_arr = f64(T_host, device=dev)[:, None]
    surface = D * tot[:, :, 0]
    spot = float(np.exp(float(log_s0)))
    jac = torch.stack([
        D * tot[:, :, 5] / spot,  # spot (w = ∂Y/∂logS0)
        D * tot[:, :, 1],  # V0
        D * tot[:, :, 2],  # kappa
        D * tot[:, :, 3],  # theta
        D * tot[:, :, 4],  # sigma
        D * tot[:, :, 6],  # rho
        D * tot[:, :, 5] * T_arr - T_arr * surface,  # flat rate, discount term included
    ], dim=-1)
    return surface, jac


class _SurfacePrice(torch.autograd.Function):
    """The surface over (log S0, V0, r, κ, θ, σ, ρ): K9 forward, or K12
    when an input needs a gradient, whose Jacobian the backward contracts.
    No forward mode and no double backward (ops/autograd_limits.py)."""

    @staticmethod
    def forward(log_s0, v0, r, kappa, theta, sigma, rho, opts):
        log_s0, v0, r, kappa, theta, sigma, rho = (
            float(x) for x in (log_s0, v0, r, kappa, theta, sigma, rho))
        T_host, strikes, carry, kw, jacobian, fwd = opts
        discounts = [np.exp(-r * t) for t in T_host]
        args = (log_s0, v0, r - carry, kappa, theta, sigma, rho, T_host, strikes, discounts)
        if not jacobian:  # no input needs a gradient
            return heston_qe_mixing_surface_price(*args, **kw)
        surface, jac = heston_qe_mixing_surface_price_and_jacobian(*args, **kw)
        fwd.state = (jac, float(np.exp(log_s0)))
        return surface

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.metas = [(x.dtype, x.device) for x in inputs[:7]]
        fwd = inputs[7][-1]
        if fwd.state:
            jac, ctx.spot = fwd.state
            ctx.save_for_backward(jac, *inputs[:7])

    @staticmethod
    def backward(ctx, ct):
        jac, *inputs = ctx.saved_tensors
        g = torch.einsum("emp,em->p", jac, ct.to(jac))
        spot_g, v0_g, k_g, th_g, sig_g, rho_g, r_g = g.unbind()
        # the Jacobian's spot column is ∂/∂spot; the argument is log S0
        grads = (spot_g * ctx.spot, v0_g, r_g, k_g, th_g, sig_g, rho_g)
        grads = tuple(x.to(dtype=dtype, device=dev) for x, (dtype, dev) in zip(grads, ctx.metas))
        return (*first_order_only(grads, "K12 (the QE surface's Jacobian)", ct, *inputs), None)

    @staticmethod
    def jvp(ctx, *tangents):
        refuse_forward_mode("K9/K12 (the QE surface, K12's Jacobian its backward)")


def heston_qe_mixing_surface_price_diff(
    log_s0, v0, r, kappa, theta, sigma, rho, T_host, strikes,
    *, seg_steps, n_strikes: int, n_blocks: int, n_batches: int, seed, cp=1.0,
    device_id=0, carry=0.0, device="cuda",
) -> torch.Tensor:
    """Differentiable view of the PRNG surface kernel: the primal of
    :func:`~hedgehog_tpu_torch.ops.heston_qe_kernel.heston_qe_mixing_surface_price`
    and a backward that contracts K12's Jacobian, so ``torch.autograd.grad``
    of any surface loss runs at kernel speed.  Differentiable in the seven
    leading scalars (numbers or 0-dim tensors); expiries and strikes are
    fixed.  ``r`` is the flat short rate: the discounts are e^{−r·T_i} and
    the simulated drift r − ``carry`` (the dividend yield, fixed), so the
    rate gradient keeps both terms."""
    args = tuple(torch.as_tensor(x, dtype=torch.float64)
                 for x in (log_s0, v0, r, kappa, theta, sigma, rho))
    kw = dict(seg_steps=seg_steps, n_strikes=n_strikes, n_blocks=n_blocks, n_batches=n_batches,
              seed=seed, cp=cp, device_id=device_id, device=device)
    jacobian = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    opts = (tuple(float(t) for t in T_host), [float(k) for k in strikes], float(carry), kw,
            jacobian, ForwardState())
    return _SurfacePrice.apply(*args, opts)
