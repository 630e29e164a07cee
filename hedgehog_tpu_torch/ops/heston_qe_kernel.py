"""QE kernels and their plain PyTorch twins: mixing (K7 values, K8 serving
price), the QE-M terminal sampler (K5 terminal prices, K6 serving call
price) and the QE mixing surface (K9, with the surface adapter).

Port of ``hedgehog_tpu/ops/heston_qe_kernel.py``.  For tensors on a GPU the
work goes to ``csrc/heston_qe.cu``, ``csrc/heston_qe_terminal.cu`` and
``csrc/heston_surface.cu``; for tensors
on the CPU to the float32 twins below, which repeat the kernels' arithmetic:
the same Sobol' or Philox bits, the same draws (``sobol_normals_tile`` and
``sobol_uniforms_open_tile``, which repair the Sobol' cells whose float32
uniform rounds to 1.0; Box–Muller with its zero cell centred), the same
polished reciprocal, the same fp32 guards.  The public functions keep the JAX
signatures, with ``device`` (default the GPU) in place of ``interpret``;
``n_blocks`` and ``n_batches`` keep their meaning (``n_blocks·n_batches·32768``
antithetic pairs per price call).

Streams (csrc/hh_device.cuh): under QMC pair i is point ``point_offset + i``
of the table ``sobol_table(seed, 2·steps)`` (mixing: dims 2s (z) and 2s + 1
(u) at step s) or ``sobol_table(seed, 3·steps)`` (QE-M: dims 3s (z_v), 3s + 1
(z_x), 3s + 2 (u)); K8 covers exactly the points ``[point_offset,
point_offset + n_blocks·n_batches·32768)``.  Under PRNG a mixing pair draws
Philox block s // 2 at step s (words 0, 1 → Box–Muller, words 2, 3 → the
even and odd step's uniforms), a QE-M pair block s (words 0, 1 → Box–Muller
(z_v, z_x), word 2 → u); K6 walks K5's pairs ``[0, n_blocks·n_batches·32768)``.
A surface (K9, K12) counts its steps across all expiry segments and draws
step s as a mixing path draws its step s.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..math.counter_rng import uniform_from_bits
from ..utils import f64, resolve_device
from .autograd_limits import host_float_kernel, no_derivative
from .cuda_lib import (
    CudaKernel,
    check_grid,
    check_tensor,
    host_to_device,
    launch_occupancy,
    require_cuda,
    resident_grid,
)
from .hh_device import (
    MIX_NAMES,
    QEM_NAMES,
    SOBOL_BITS,
    SURF_GLOBALS,
    SURF_PER_SEG,
    box_muller,
    cond_bs_value,
    mix_advance,
    mix_c,
    philox_block,
    qem_advance,
    qem_c,
    sobol_masks,
    sobol_normals_tile,
    sobol_table,
    sobol_uniforms_open_tile,
    surf_c,
    surf_close,
)

__all__ = [
    "QE_VALUES_KERNEL",
    "QE_PRICE_KERNEL",
    "QEM_TERMINAL_KERNEL",
    "QEM_PRICE_KERNEL",
    "QE_SURFACE_KERNEL",
    "heston_qe_mixing_surface_price",
    "heston_qe_mixing_surface_sums_plain",
    "heston_surface_mc_adapter",
    "heston_qe_mixing_values",
    "heston_qe_mixing_values_adapter",
    "heston_qe_mixing_values_plain",
    "heston_qe_mixing_price_sum_plain",
    "heston_qe_mixing_vanilla_price",
    "heston_qe_terminal",
    "heston_qe_terminal_adapter",
    "heston_qe_terminal_plain",
    "heston_qe_call_price",
    "heston_qe_call_price_sum_plain",
]

#: antithetic pairs per TPU program (256 × 128): the unit of ``n_blocks``
PAIRS_PER_BLOCK = 256 * 128
_MASK32 = 0xFFFFFFFF
#: pairs per chunk of the summing twins
PLAIN_CHUNK = 2**18

_VALUES_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p,
]
_PRICE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p,
]
QE_VALUES_KERNEL = CudaKernel("hh_qe_values", _VALUES_ARGS)
QE_PRICE_KERNEL = CudaKernel("hh_qe_price", _PRICE_ARGS)


def _mix_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, steps, strike, cp) -> np.ndarray:
    """(16,) float32 parameter vector (layout ``MIX_NAMES``): float64 host
    math, cast once; the QE constants are models/heston_qe.py's."""
    from ..models.heston_qe import qe_constants

    c = qe_constants(kappa, theta, sigma, rho, r, dt)
    T = dt * steps
    f_base = np.exp(log_s0 + r * T)
    vals = dict(
        v0=v0, theta=theta, e=float(c["e"]), c_s2_v=float(c["c_s2_v"]),
        c_s2_c=float(c["c_s2_c"]), half_dt=0.5 * dt, inv_sigma=1.0 / sigma,
        k_over_sigma=kappa / sigma, ktd_over_sigma=kappa * theta * dt / sigma,
        f_base=f_base, strike=strike, rho=rho, rho2_half=0.5 * rho**2, rho_bar2=1.0 - rho**2,
        cp=cp, log_f_over_k=np.log(f_base) - np.log(strike),
    )
    return np.array([float(vals[n]) for n in MIX_NAMES], dtype=np.float64).astype(np.float32)


# ---- the twins ----------------------------------------------------------------


def pair_chunks(total: int, device, chunk: int = PLAIN_CHUNK):
    """The pairs [0, total) in chunks of ``chunk`` pairs (the summing twins'
    unit of work, so that serving sizes fit in memory)."""
    for start in range(0, total, chunk):
        yield torch.arange(start, min(start + chunk, total), dtype=torch.int64, device=device)


def mix_draws(pair, steps: int, table, seed: int, device_id: int, point_offset: int):
    """Yields (z, u) of each step for the pairs ``pair`` (int64 tensor of
    global pair indices), in the kernels' draw order: Sobol' dims (2s, 2s + 1)
    when ``table`` is given, else the QE mixing Philox layout."""
    if table is not None:
        masks = sobol_masks(pair + point_offset)
        for s in range(steps):
            (z,) = sobol_normals_tile(masks, table, (2 * s,))
            (u,) = sobol_uniforms_open_tile(masks, table, (2 * s + 1,))
            yield z, u
        return
    for s in range(steps):
        if s % 2 == 0:
            w = philox_block(pair, s // 2, seed & _MASK32, device_id & _MASK32)
            normals = box_muller(w[0], w[1])
        yield normals[s % 2], uniform_from_bits(w[2 + s % 2])


def _qe_pairs_plain(params, table, pair, steps, antithetic, seed, device_id, point_offset):
    c = mix_c(params)
    v = c["v0"].expand(pair.shape)
    iv = j = torch.zeros_like(v)
    va, iva, ja = v, iv, j
    for z, u in mix_draws(pair, steps, table, seed, device_id, point_offset):
        v, iv, j = mix_advance(v, iv, j, z, u, c)
        if antithetic:
            va, iva, ja = mix_advance(va, iva, ja, -z, 1.0 - u, c)
    rows = [cond_bs_value(iv, j, c)]
    if antithetic:
        rows.append(cond_bs_value(iva, ja, c))
    return torch.stack(rows)


def heston_qe_mixing_values_plain(params, table, n_paths: int, steps: int, antithetic: bool,
                                  seed: int, device_id: int, point_offset: int) -> torch.Tensor:
    """Twin of K7: (1 or 2, n_paths) float32 undiscounted values on
    ``params.device``; ``table`` is the Sobol' table (QMC) or None (Philox)."""
    pair = torch.arange(n_paths, dtype=torch.int64, device=params.device)
    return _qe_pairs_plain(params, table, pair, steps, antithetic, seed, device_id, point_offset)


def heston_qe_mixing_price_sum_plain(params, table, total_pairs: int, steps: int, seed: int,
                                     device_id: int, point_offset: int) -> torch.Tensor:
    """Twin of K8: the float64 sum of (value + antithetic value) over the
    pairs ``[0, total_pairs)``, in chunks of ``PLAIN_CHUNK`` pairs."""
    total = torch.zeros((), dtype=torch.float64, device=params.device)
    for pair in pair_chunks(total_pairs, params.device):
        vals = _qe_pairs_plain(params, table, pair, steps, True, seed, device_id, point_offset)
        total = total + (vals[0] + vals[1]).to(torch.float64).sum()
    return total


# ---- launch or twin -------------------------------------------------------------


def check_inputs(params, table, steps: int, n_params: int = len(MIX_NAMES),
                 dims_per_step: int = 2) -> None:
    """Raise on a parameter vector or Sobol' table the kernels do not take
    (mixing kernels: 16 parameters and 2 Sobol' dims per step; QE-M: 14 or
    15 and 3)."""
    check_tensor(params, "params", torch.float32, (n_params,))
    if steps < 1:
        raise ValueError(f"need steps >= 1; got {steps}")
    if table is not None:
        check_tensor(table, "sobol table", torch.int32, (dims_per_step * steps, SOBOL_BITS + 1))
        if table.device != params.device:
            raise ValueError("params and the Sobol' table must be on one device")


def _qe_values(params, table, n_paths, steps, antithetic, seed, device_id,
               point_offset) -> torch.Tensor:
    """Launch K7 for inputs on a GPU; the twin for inputs on the CPU."""
    check_inputs(params, table, steps)
    if n_paths < 1:
        raise ValueError(f"need n_paths >= 1; got {n_paths}")
    if params.device.type == "cpu":
        return heston_qe_mixing_values_plain(params, table, n_paths, steps, antithetic, seed,
                                             device_id, point_offset)
    require_cuda(params)
    out = torch.empty((2 if antithetic else 1, n_paths), dtype=torch.float32, device=params.device)
    QE_VALUES_KERNEL.launch(
        params.device, params.data_ptr(), None if table is None else table.data_ptr(),
        out.data_ptr(), n_paths, steps, int(antithetic), seed & _MASK32, device_id & _MASK32,
        point_offset,
    )
    return out


def price_grid(device: torch.device, table) -> int:
    """Blocks of the price kernels K8 and K10: 3 an SM (the one wave of both,
    and at the serving steps the grid of K8 before its per-stream build),
    fewer where K8's launch at the table's steps (its staged table and high
    words, or the global-table kernel) holds fewer.  Both walk the pairs
    with this grid, so K10's price equals K8's."""
    steps = 0 if table is None else table.shape[0] // 2
    return resident_grid("hh_qe_price_grid", device, steps, int(table is not None))


def price_occupancy(steps: int, qmc: bool, device) -> dict:
    """K8's occupancy on ``device`` at ``steps`` steps on one stream
    (``cuda_lib.launch_occupancy``'s keys): its blocks an SM against
    :func:`price_grid`."""
    return launch_occupancy("hh_qe_price_occupancy", torch.device(device), steps, int(qmc))


def _qe_price_sum(params, table, total_pairs, steps, seed, device_id, point_offset,
                  grid=None) -> torch.Tensor:
    """Launch K8 for inputs on a GPU (the float64 sum of its per-block
    partials); the twin for inputs on the CPU.  ``grid`` defaults to
    :func:`price_grid`; another grid sums the same pair values in another
    order."""
    check_inputs(params, table, steps)
    check_grid(grid)
    if params.device.type == "cpu":
        return heston_qe_mixing_price_sum_plain(params, table, total_pairs, steps, seed,
                                                device_id, point_offset)
    require_cuda(params)
    grid = price_grid(params.device, table) if grid is None else grid
    partials = torch.empty((grid,), dtype=torch.float64, device=params.device)
    QE_PRICE_KERNEL.launch(
        params.device, params.data_ptr(), None if table is None else table.data_ptr(),
        partials.data_ptr(), grid, total_pairs, steps, seed & _MASK32, device_id & _MASK32,
        point_offset,
    )
    return partials.sum()


def mix_inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp, steps, seed, qmc,
               device):
    """(params, Sobol' table or None) on ``device``, each in one pinned
    asynchronous copy (``cuda_lib.host_to_device``)."""
    dev = resolve_device(device)
    params = host_to_device(
        _mix_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, steps, strike, cp), dev)
    table = host_to_device(sobol_table(seed, 2 * steps), dev) if qmc else None
    return params, table


def check_period(qmc: bool, point_offset: int, n_points: int) -> None:
    """The Sobol' period guard: a QMC call may not reach past point 2^30."""
    if qmc and point_offset + n_points > 2**SOBOL_BITS:
        raise ValueError(
            f"Sobol' period is 2^{SOBOL_BITS} points; offset {point_offset} + "
            f"{n_points} points would wrap"
        )


def heston_qe_mixing_values(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp,
    *, n_paths: int, steps: int, seed, antithetic: bool = False, device_id=0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """Per-path UNDISCOUNTED conditional vanilla values, (n_groups, n_paths)
    float32, n_groups = 2 under antithetic pairing; ``cp`` is +1 for a call,
    −1 for a put.  Under QMC ``device_id`` is unused (devices slice one
    sequence by ``point_offset``)."""
    check_period(qmc, point_offset, -(-n_paths // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK)
    params, table = mix_inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp, steps,
                               seed, qmc, device)
    return _qe_values(params, table, n_paths, steps, antithetic, int(seed), int(device_id),
                      point_offset)


def heston_qe_mixing_vanilla_price(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, discount,
    *, n_blocks: int, n_batches: int, steps: int, seed, device_id=0, cp=1.0,
    qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """Discounted European vanilla price over n_blocks·n_batches·32768
    antithetic mixing pairs in ONE launch, accumulated on the device: the
    serving configuration.  Returns a float64 0-dim tensor."""
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    check_period(qmc, point_offset, total_pairs)
    params, table = mix_inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, cp, steps,
                               seed, qmc, device)
    sums = _qe_price_sum(params, table, total_pairs, steps, int(seed), int(device_id),
                         point_offset)
    return discount * sums / (2 * total_pairs)


# ---- QE mixing surface: K9, a whole (expiry × strike) grid per launch ------------

_SURFACE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
    ctypes.c_uint, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]
QE_SURFACE_KERNEL = CudaKernel("hh_qe_surface", _SURFACE_ARGS)
#: warps of a surface kernel's block: each keeps a float64 row of per-point sums
SURFACE_WARPS = 8
#: dynamic shared memory a surface launch may take; wider grids are split
#: into strike chunks, each a launch replaying the same pairs
SURFACE_SMEM_LIMIT = 200 * 1024
#: shared-memory bytes per expiry of K9: its SurfSeg (8 floats) and step count
SURF_EXP_BYTES = 36
#: K12's columns a point (y, the chain of 4 directions, w, y_ρ) and its
#: shared-memory bytes per expiry: K9's, the (4, 4) constant tangents and the
#: (4, 3) J-closure rows
SURF_JAC_COLS = 7
SURF_JAC_EXP_BYTES = SURF_EXP_BYTES + 4 * 4 * (4 + 3)


def segment_dts(T_host, seg_steps) -> list:
    """The step (segment) length of each expiry segment of a surface."""
    bounds = [0.0, *T_host]
    return [(bounds[i + 1] - bounds[i]) / steps_i for i, steps_i in enumerate(seg_steps)]


def surf_nparams(n_exp: int, m: int) -> int:
    return len(SURF_GLOBALS) + len(SURF_PER_SEG) * n_exp + n_exp + m + n_exp * m


def _surf_params(log_s0, v0, r, kappa, theta, sigma, rho, T_host, seg_steps, strikes,
                 cp) -> np.ndarray:
    """The surface kernels' parameter vector (layout ``SURF_GLOBALS``,
    ``SURF_PER_SEG`` per segment, f_base per expiry, strikes, log(F/K)
    point-major): float64 host math, each entry cast once, as the TPU
    wrapper builds it."""
    from ..models.heston_qe import qe_constants

    log_s0, v0, r, kappa, theta, sigma, rho, cp = (
        float(x) for x in (log_s0, v0, r, kappa, theta, sigma, rho, cp))
    strikes = [float(k) for k in strikes]
    entries = [v0, theta, 1.0 / sigma, kappa / sigma, rho, 0.5 * rho**2, 1.0 - rho**2, cp]
    for dt_i in segment_dts(T_host, seg_steps):
        c = qe_constants(kappa, theta, sigma, rho, r, dt_i)
        entries += [float(c["e"]), float(c["c_s2_v"]), float(c["c_s2_c"]), 0.5 * dt_i,
                    kappa * theta * dt_i / sigma]
    f_bases = [float(np.exp(log_s0 + r * T_i)) for T_i in T_host]
    entries += f_bases + strikes
    entries += [np.log(f) - np.log(k) for f in f_bases for k in strikes]
    return np.array(entries, dtype=np.float64).astype(np.float32)


def _qe_surface_pairs_plain(params, table, seg_steps, m, pair, seed, device_id, point_offset):
    """(n_exp·m, len(pair)) fp32 values, each the sum of a pair's two paths,
    of every surface point: one variance path per pair through the
    segments, every strike closed at each segment's end."""
    n_exp = len(seg_steps)
    c0 = surf_c(params, 0)
    v = c0["v0"].expand(pair.shape)
    iv = j = torch.zeros_like(v)
    va, iva, ja = v, iv, j
    draws = mix_draws(pair, sum(seg_steps), table, seed, device_id, point_offset)
    rows = []
    for i, steps_i in enumerate(seg_steps):
        c = surf_c(params, i)
        for _ in range(steps_i):
            z, u = next(draws)
            v, iv, j = mix_advance(v, iv, j, z, u, c)
            va, iva, ja = mix_advance(va, iva, ja, -z, 1.0 - u, c)
        for k in range(m):
            ck = surf_close(params, c, n_exp, m, i, k)
            rows.append(cond_bs_value(iv, j, ck) + cond_bs_value(iva, ja, ck))
    return torch.stack(rows)


def heston_qe_mixing_surface_sums_plain(params, table, seg_steps, m: int, total_pairs: int,
                                        seed: int, device_id: int,
                                        point_offset: int) -> torch.Tensor:
    """Twin of K9: the float64 sum over the pairs [0, total_pairs) of each
    point's per-pair fp32 value, (n_exp·m,) point-major."""
    total = torch.zeros(len(seg_steps) * m, dtype=torch.float64, device=params.device)
    for pair in pair_chunks(total_pairs, params.device):
        vals = _qe_surface_pairs_plain(params, table, seg_steps, m, pair, seed, device_id,
                                       point_offset)
        total = total + vals.to(torch.float64).sum(dim=1)
    return total


def surface_grid(device: torch.device) -> int:
    """Blocks of K9 and K12: both walk the pairs with this grid (a whole
    number of resident waves of each), so K12's surface equals K9's."""
    return resident_grid("hh_surface_grid", device)


def surface_occupancy(n_exp: int, m: int, total_steps: int, qmc: bool, device="cuda",
                      jac: bool = False) -> dict:
    """K9's (or with ``jac`` K12's) occupancy on ``device`` at one launch's
    shared memory (the table staged as :func:`surface_staged` decides),
    from the CUDA runtime: threads a block, resident blocks and warps per
    SM, shared bytes a block (dynamic and static), registers and local
    (spill) bytes a thread."""
    staged = surface_staged(n_exp, 2 * total_steps if qmc else 0, jac)
    return launch_occupancy("hh_surface_occupancy", torch.device(device), int(jac), n_exp, m,
                            total_steps, int(qmc), int(staged))


def surface_smem_bytes(n_exp: int, m: int, cols_per_point: int, table_rows: int,
                       per_exp_bytes: int, high: bool = False) -> int:
    """Dynamic shared memory of a K9 or K12 launch (the layout of
    csrc/heston_surface.cu): a float64 row of sums
    per warp, 28 bytes of close constants per point, ``per_exp_bytes`` per
    expiry (segment constants, step counts, tangent rows) and the Sobol'
    table, with alignment slack; with ``high`` each warp's high Sobol'
    words, two a table row (the kernels stage both where the table is in
    shared memory)."""
    return (8 * SURFACE_WARPS * n_exp * m * cols_per_point + 28 * n_exp * m
            + per_exp_bytes * n_exp + 4 * (SOBOL_BITS + 1) * table_rows
            + (4 * 2 * SURFACE_WARPS * table_rows if high else 0) + 64)


def staged_rows(table_rows: int, smem_bytes) -> int:
    """The Sobol' table rows a surface launch stages: all of them where a
    launch of one strike with them, ``smem_bytes(1, table_rows)``, fits
    ``SURFACE_SMEM_LIMIT``; else none (the kernel reads the table from
    global memory, and the strikes are chunked without it)."""
    return table_rows if smem_bytes(1, table_rows) <= SURFACE_SMEM_LIMIT else 0


def strike_chunks(m: int, smem_bytes) -> list:
    """Slices of the ``m`` strikes whose launches fit ``SURFACE_SMEM_LIMIT``,
    each as wide as fits; ``smem_bytes(width)`` is a launch's shared memory
    at ``width`` strikes, growing with the width (:func:`surface_smem_bytes`
    for K9 and K12, ``heston_exact_kernel.exact_surface_smem_bytes`` for K4)."""
    width = 0
    while width < m and smem_bytes(width + 1) <= SURFACE_SMEM_LIMIT:
        width += 1
    if width < 1:
        raise ValueError(f"a surface launch of one strike needs {smem_bytes(1)} bytes of shared "
                         f"memory, more than {SURFACE_SMEM_LIMIT}")
    return [slice(k, min(k + width, m)) for k in range(0, m, width)]


def surface_launch_bytes(n_exp: int, m: int, table_rows: int, jac: bool = False) -> int:
    """Dynamic shared memory of a K9 (with ``jac`` K12) launch of ``m``
    strikes that stages ``table_rows`` Sobol' rows."""
    if jac:
        return surface_smem_bytes(n_exp, m, SURF_JAC_COLS, table_rows, SURF_JAC_EXP_BYTES, True)
    return surface_smem_bytes(n_exp, m, 1, table_rows, SURF_EXP_BYTES, True)


def surface_staged(n_exp: int, table_rows: int, jac: bool = False) -> bool:
    """Whether K9 (with ``jac`` K12) stages a Sobol' table of
    ``table_rows`` rows in shared memory: the one staging decision of the
    QE surface kernels, made here for every launch and followed by
    csrc/heston_surface.cu (:func:`staged_rows`)."""
    return staged_rows(table_rows, lambda w, rows: surface_launch_bytes(n_exp, w, rows, jac)) > 0


def surface_strike_chunks(n_exp: int, m: int, table_rows: int, jac: bool = False) -> list:
    """The strike chunks of a K9 (K12) surface of ``m`` strikes: each
    launch fits ``SURFACE_SMEM_LIMIT`` with the table staged as
    :func:`surface_staged` decides."""
    staged = table_rows if surface_staged(n_exp, table_rows, jac) else 0
    return strike_chunks(m, lambda w: surface_launch_bytes(n_exp, w, staged, jac))


def check_surface(params, table, seg_steps, m: int, n_params: int, dims_per_step: int) -> None:
    """Raise on surface inputs the kernels do not take."""
    check_tensor(params, "params", torch.float32, (n_params,))
    if not seg_steps or min(seg_steps) < 1 or m < 1:
        raise ValueError(f"need >= 1 step per segment and >= 1 strike; got {seg_steps}, m={m}")
    if table is not None:
        total = sum(seg_steps)
        check_tensor(table, "sobol table", torch.int32, (dims_per_step * total, SOBOL_BITS + 1))
        if table.device != params.device:
            raise ValueError("params and the Sobol' table must be on one device")


def _qe_surface_sums(params, table, seg_steps, m, total_pairs, seed, device_id,
                     point_offset, grid=None) -> torch.Tensor:
    """Launch K9 for inputs on a GPU (per-point float64 sums, (n_exp·m,));
    the twin for inputs on the CPU.  ``grid`` (blocks) defaults to
    :func:`surface_grid`; another grid walks the same pairs in other rounds,
    so only the sums' last bits move (the check of an earlier grid's bits)."""
    n_exp = len(seg_steps)
    check_surface(params, table, seg_steps, m, surf_nparams(n_exp, m), 2)
    check_grid(grid)
    if params.device.type == "cpu":
        return heston_qe_mixing_surface_sums_plain(params, table, seg_steps, m, total_pairs, seed,
                                                   device_id, point_offset)
    require_cuda(params)
    grid = surface_grid(params.device) if grid is None else grid
    steps = torch.tensor(seg_steps, dtype=torch.int32, device=params.device)
    partials = torch.empty((n_exp * m, grid), dtype=torch.float64, device=params.device)
    out = torch.empty((n_exp * m,), dtype=torch.float64, device=params.device)
    staged = table is not None and surface_staged(n_exp, table.shape[0])
    QE_SURFACE_KERNEL.launch(
        params.device, params.data_ptr(), steps.data_ptr(),
        None if table is None else table.data_ptr(), partials.data_ptr(), out.data_ptr(), grid,
        n_exp, m, sum(seg_steps), total_pairs, seed & _MASK32, device_id & _MASK32, point_offset,
        int(staged),
    )
    return out


def surface_args(T_host, seg_steps, strikes, n_strikes: int, discounts, n_blocks: int,
                 n_batches: int, qmc: bool, point_offset: int, device):
    """Normalised surface arguments: (T_host, seg_steps, strikes as floats,
    discounts (n_exp,) float64 on the device, total pairs, device)."""
    T_host = tuple(float(t) for t in T_host)
    seg_steps = tuple(int(s) for s in seg_steps)
    strikes = [float(k) for k in strikes]
    if len(strikes) != n_strikes or len(seg_steps) != len(T_host):
        raise ValueError(f"{len(strikes)} strikes for n_strikes={n_strikes}; {len(seg_steps)} "
                         f"segment counts for {len(T_host)} expiries")
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    check_period(qmc, point_offset, total_pairs)
    dev = resolve_device(device)
    return T_host, seg_steps, strikes, f64(discounts, device=dev), total_pairs, dev


def heston_qe_mixing_surface_price(
    log_s0, v0, r, kappa, theta, sigma, rho, T_host, strikes, discounts,
    *, seg_steps, n_strikes: int, n_blocks: int, n_batches: int, seed, cp=1.0,
    device_id=0, qmc: bool = False, point_offset: int = 0, device="cuda",
) -> torch.Tensor:
    """(n_exp, n_strikes) DISCOUNTED surface prices over
    n_blocks·n_batches·32768 antithetic QE mixing pairs: one variance path per
    pair through the expiry segments (``seg_steps`` steps each, the step
    index running across segments), every strike closed at each expiry.
    ``T_host``: increasing expiry year fractions; ``discounts``: (n_exp,)
    discount factors.  Returns float64 on the device."""
    T_host, seg_steps, strikes, disc, total_pairs, dev = surface_args(
        T_host, seg_steps, strikes, n_strikes, discounts, n_blocks, n_batches, qmc,
        point_offset, device)
    table = torch.as_tensor(sobol_table(seed, 2 * sum(seg_steps)), device=dev) if qmc else None
    rows = []
    n_exp = len(T_host)
    for sl in surface_strike_chunks(n_exp, n_strikes, 0 if table is None else table.shape[0]):
        params = torch.as_tensor(_surf_params(log_s0, v0, r, kappa, theta, sigma, rho, T_host,
                                              seg_steps, strikes[sl], cp), device=dev)
        m = len(strikes[sl])
        rows.append(_qe_surface_sums(params, table, seg_steps, m, total_pairs, int(seed),
                                     int(device_id), point_offset).reshape(len(T_host), m))
    return disc[:, None] * (torch.cat(rows, dim=1) / (2 * total_pairs))


def heston_surface_mc_adapter(market, expiries, strikes, config, cp=1.0, seed=None,
                              strategy=None, *, device="cuda") -> torch.Tensor:
    """Kernel surface with the step allocation of the float64
    :func:`~hedgehog_tpu_torch.methods.heston_surface.heston_surface_mc`
    (the counterpart of the JAX ``heston_surface_mc_tpu``).  Antithetic runs
    go to the kernels: ``strategy=HestonExactMixing()`` to K4, PRNG QE to the
    differentiable view (K9 forward, K12 when a gradient is wanted), QMC QE
    to K9; runs without variance reduction to the float64 estimator.
    ``seed`` overrides ``config.seed``.  Returns (n_exp, m) float64."""
    import dataclasses

    from ..market.inputs import carry_yield
    from ..market.rate_curve import df_yf, zero_rate_yf
    from ..methods.heston_surface import (
        heston_surface_mc,
        surface_seg_steps,
        validate_surface_expiries,
    )
    from ..methods.montecarlo import Antithetic, HestonExactMixing

    T_host = validate_surface_expiries(market, expiries)
    if seed is not None:
        config = dataclasses.replace(config, seed=seed)
    dev = resolve_device(device)
    if not isinstance(config.variance_reduction, Antithetic):
        return heston_surface_mc(market, expiries, strikes, config, cp=cp, strategy=strategy,
                                 device=dev)
    exact = isinstance(strategy, HestonExactMixing)
    _, seg_steps = surface_seg_steps(T_host, config.steps, min_first=2 if exact else 1)
    q = f64(carry_yield(market))
    r0 = zero_rate_yf(market.rate, 0.0) - q
    n_blocks = max(1, -(-config.trajectories // (PAIRS_PER_BLOCK * 16)))
    n_batches = -(-config.trajectories // (PAIRS_PER_BLOCK * n_blocks))
    strikes = [float(k) for k in strikes]
    kw = dict(seg_steps=tuple(seg_steps), n_strikes=len(strikes), n_blocks=n_blocks,
              n_batches=n_batches, seed=config.seed, cp=cp, device=dev)
    log_s0 = torch.log(f64(market.spot))
    heston = (market.V0, r0, market.kappa, market.theta, market.sigma, market.rho)
    if exact or config.qmc:
        from .heston_exact_kernel import heston_exact_mixing_surface_price

        price = heston_exact_mixing_surface_price if exact else heston_qe_mixing_surface_price
        discounts = torch.stack([df_yf(market.rate, t) for t in T_host])
        v0, r0, kappa, theta, sigma, rho = (float(x) for x in heston)
        return price(float(log_s0), v0, r0, kappa, theta, sigma, rho, T_host, strikes,
                     discounts, qmc=config.qmc, **kw)
    # the view discounts at e^{-r T_i} and drifts at r - carry: give it the
    # rate and the carry, so the rate gradient keeps both terms
    from .heston_qe_greeks_kernel import heston_qe_mixing_surface_price_diff

    v0, r0, kappa, theta, sigma, rho = heston
    return heston_qe_mixing_surface_price_diff(log_s0, v0, r0 + q, kappa, theta, sigma, rho,
                                               T_host, strikes, carry=float(q), **kw)


def heston_qe_mixing_values_adapter(prob, config, strat, key=None, device_id=0,
                                    point_offset=0, *, device):
    """``MonteCarlo(HestonDynamics(), HestonQE(conditional=True,
    use_kernel=True))``: float64 per-path values (n_groups, trajectories)
    from K7, through the differentiable view whose backward is K11 (the
    counterpart of the JAX ``heston_qe_mixing_values_pallas``).  Under QMC
    the seed is always ``config.seed`` (every device, and the float64
    estimator, randomize one shared sequence); under PRNG an explicit ``key``
    reseeds the stream."""
    from ..methods.montecarlo import Antithetic, sim_params
    from .heston_kernel import seed_from_key
    from .heston_qe_greeks_kernel import heston_qe_mixing_values_diff

    market, T, r0 = sim_params(prob)
    out = heston_qe_mixing_values_diff(
        torch.log(f64(market.spot)), market.V0, r0, market.kappa, market.theta, market.sigma,
        market.rho, T / config.steps, prob.payoff.strike, prob.payoff.call_put(),
        n_paths=config.trajectories, steps=config.steps,
        seed=config.seed if config.qmc else seed_from_key(config, key),
        antithetic=isinstance(config.variance_reduction, Antithetic), device_id=device_id,
        qmc=config.qmc, point_offset=point_offset, device=device,
    )
    return out.to(torch.float64)


# ---- QE-M terminal sampler: K5 terminal prices, K6 serving call price ----------

_QEM_TERMINAL_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p,
]
_QEM_PRICE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
]
QEM_TERMINAL_KERNEL = CudaKernel("hh_qem_terminal", _QEM_TERMINAL_ARGS)
QEM_PRICE_KERNEL = CudaKernel("hh_qem_price", _QEM_PRICE_ARGS)


def _qem_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, gamma1=0.5, gamma2=0.5,
                strike=None) -> np.ndarray:
    """(14,) float32 parameter vector (layout ``QEM_NAMES``), (15,) with the
    call-price kernel's strike: float64 host math, each entry cast once, as
    the TPU wrappers build it."""
    from ..models.heston_qe import qe_constants

    c = {k: float(x) for k, x in qe_constants(kappa, theta, sigma, rho, r, dt, gamma1,
                                                gamma2).items()}
    vals = dict(c, log_s0=log_s0, v0=v0, theta=theta, K1_half_K3=c["K1"] + 0.5 * c["K3"])
    row = [float(vals[n]) for n in QEM_NAMES] + ([] if strike is None else [float(strike)])
    return np.array(row, dtype=np.float64).astype(np.float32)


def qem_draws(pair, steps: int, table, seed: int, device_id: int, point_offset: int,
              dtype=torch.float32):
    """Yields (z_v, z_x, u) of each step for the pairs ``pair`` (int64
    tensor of global pair indices), in the kernels' draw order: Sobol' dims
    (3s, 3s + 1, 3s + 2) when ``table`` is given, else Philox block s
    (words 0, 1 → Box–Muller, word 2 → u), whose arithmetic runs in
    ``dtype`` (the float64 estimator draws the same stream)."""
    if table is not None:
        masks = sobol_masks(pair + point_offset)
        for s in range(steps):
            z_v, z_x = sobol_normals_tile(masks, table, (3 * s, 3 * s + 1))
            (u,) = sobol_uniforms_open_tile(masks, table, (3 * s + 2,))
            yield z_v, z_x, u
        return
    for s in range(steps):
        w = philox_block(pair, s, seed & _MASK32, device_id & _MASK32)
        z_v, z_x = box_muller(w[0], w[1], dtype=dtype)
        yield z_v, z_x, uniform_from_bits(w[2]).to(dtype)


def _qem_pairs_plain(params, table, pair, steps, antithetic, mcorr, seed, device_id,
                     point_offset):
    c = qem_c(params)
    x, v = c["log_s0"].expand(pair.shape), c["v0"].expand(pair.shape)
    xa, va = x, v
    for z_v, z_x, u in qem_draws(pair, steps, table, seed, device_id, point_offset):
        x, v = qem_advance(x, v, z_v, z_x, u, c, mcorr)
        if antithetic:
            xa, va = qem_advance(xa, va, -z_v, -z_x, 1.0 - u, c, mcorr)
    return torch.stack([torch.exp(x), torch.exp(xa)] if antithetic else [torch.exp(x)])


def heston_qe_terminal_plain(params, table, n_paths: int, steps: int, antithetic: bool,
                             mcorr: bool, seed: int, device_id: int,
                             point_offset: int) -> torch.Tensor:
    """Twin of K5: (1 or 2, n_paths) float32 terminal prices on
    ``params.device``; ``table`` is the (3·steps, 31) Sobol' table (QMC) or
    None (Philox)."""
    pair = torch.arange(n_paths, dtype=torch.int64, device=params.device)
    return _qem_pairs_plain(params, table, pair, steps, antithetic, mcorr, seed, device_id,
                            point_offset)


def heston_qe_call_price_sum_plain(params, total_pairs: int, steps: int, seed: int,
                                   device_id: int) -> torch.Tensor:
    """Twin of K6: the float64 sum over the pairs ``[0, total_pairs)`` of
    each pair's two fp32 call payoffs (their fp32 sum, as the kernel adds
    them), in chunks of ``PLAIN_CHUNK`` pairs."""
    strike = params[len(QEM_NAMES)]
    total = torch.zeros((), dtype=torch.float64, device=params.device)
    for pair in pair_chunks(total_pairs, params.device):
        s = _qem_pairs_plain(params, None, pair, steps, True, True, seed, device_id, 0)
        pay = torch.clamp(s - strike, min=0.0)
        total = total + (pay[0] + pay[1]).to(torch.float64).sum()
    return total


def _qem_terminal(params, table, n_paths, steps, antithetic, mcorr, seed, device_id,
                  point_offset) -> torch.Tensor:
    """Launch K5 for inputs on a GPU; the twin for inputs on the CPU."""
    check_inputs(params, table, steps, len(QEM_NAMES), 3)
    if n_paths < 1:
        raise ValueError(f"need n_paths >= 1; got {n_paths}")
    if params.device.type == "cpu":
        return heston_qe_terminal_plain(params, table, n_paths, steps, antithetic, mcorr, seed,
                                        device_id, point_offset)
    require_cuda(params)
    out = torch.empty((2 if antithetic else 1, n_paths), dtype=torch.float32, device=params.device)
    QEM_TERMINAL_KERNEL.launch(
        params.device, params.data_ptr(), None if table is None else table.data_ptr(),
        out.data_ptr(), n_paths, steps, int(antithetic), int(mcorr), seed & _MASK32,
        device_id & _MASK32, point_offset,
    )
    return out


def qem_price_grid(device) -> int:
    """K6's blocks: one resident wave of it (5 blocks of 256 threads an SM;
    the kernel before it held 4)."""
    return resident_grid("hh_qem_price_grid", torch.device(device))


def qem_price_occupancy(device) -> dict:
    """K6's occupancy on ``device`` (``cuda_lib.launch_occupancy``'s keys),
    the blocks and warps an SM behind :func:`qem_price_grid`."""
    return launch_occupancy("hh_qem_price_occupancy", torch.device(device))


def _qem_price_sum(params, total_pairs, steps, seed, device_id, grid=None) -> torch.Tensor:
    """Launch K6 for inputs on a GPU (the float64 sum of its per-block
    partials); the twin for inputs on the CPU.  ``grid`` (blocks of 256
    pairs a round) defaults to :func:`qem_price_grid`; another grid sums
    the same payoffs in another order."""
    check_inputs(params, None, steps, len(QEM_NAMES) + 1)
    check_grid(grid)
    if params.device.type == "cpu":
        return heston_qe_call_price_sum_plain(params, total_pairs, steps, seed, device_id)
    require_cuda(params)
    grid = qem_price_grid(params.device) if grid is None else grid
    partials = torch.empty((grid,), dtype=torch.float64, device=params.device)
    QEM_PRICE_KERNEL.launch(params.device, params.data_ptr(), partials.data_ptr(), grid,
                            total_pairs, steps, seed & _MASK32, device_id & _MASK32)
    return partials.sum()


def qem_inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, steps, seed, qmc, device):
    """(params, Sobol' table or None) of K5 on ``device``, each in one
    pinned asynchronous copy."""
    dev = resolve_device(device)
    params = host_to_device(_qem_params(log_s0, v0, r, kappa, theta, sigma, rho, dt), dev)
    table = host_to_device(sobol_table(seed, 3 * steps), dev) if qmc else None
    return params, table


def heston_qe_terminal(
    log_s0, v0, r, kappa, theta, sigma, rho, dt,
    *, n_paths: int, steps: int, seed, antithetic: bool = False, device_id=0,
    martingale_correction: bool = True, qmc: bool = False, point_offset: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Terminal Heston prices by the QE(-M) scheme, (n_groups, n_paths)
    float32, n_groups = 2 under antithetic pairing.  ``qmc=True`` draws each
    (z_v, z_x, u) from the in-kernel Sobol' stream randomized by ``seed``
    (point ``point_offset`` + pair; ``device_id`` unused), guarded against the
    2^30 period over the TPU's padded tile count."""
    check_period(qmc, point_offset, -(-n_paths // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK)
    params, table = qem_inputs(log_s0, v0, r, kappa, theta, sigma, rho, dt, steps, seed, qmc,
                               device)
    return _qem_terminal(params, table, n_paths, steps, antithetic, martingale_correction,
                         int(seed), int(device_id), point_offset)


def heston_qe_call_price(
    log_s0, v0, r, kappa, theta, sigma, rho, dt, strike, discount,
    *, n_blocks: int, n_batches: int, steps: int, seed, device_id=0, gamma1=0.5, gamma2=0.5,
    device="cuda",
) -> torch.Tensor:
    """Discounted European call price over n_blocks·n_batches·32768
    antithetic QE-M pairs (PRNG, martingale corrected) in ONE launch, the
    payoffs accumulated on the device: K5's pairs ``[0, total)`` on K5's
    stream.  Returns a float64 0-dim tensor."""
    total_pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    params = host_to_device(
        _qem_params(log_s0, v0, r, kappa, theta, sigma, rho, dt, gamma1, gamma2, strike),
        resolve_device(device))
    sums = _qem_price_sum(params, total_pairs, steps, int(seed), int(device_id))
    return discount * sums / (2 * total_pairs)


def heston_qe_terminal_adapter(prob, config, strat, key=None, device_id=0, point_offset=0, *,
                               device):
    """``MonteCarlo(HestonDynamics(), HestonQE(use_kernel=True))``: float64
    terminal prices (n_groups, trajectories) from K5 (the counterpart of the
    JAX ``heston_qe_terminal_pallas``).  Under QMC the seed is always
    ``config.seed`` (one shared sequence, sliced by ``point_offset``); under
    PRNG an explicit ``key`` reseeds the stream."""
    from ..methods.montecarlo import Antithetic, sim_params
    from .heston_kernel import heston_scalars, seed_from_key

    market, T, r0 = sim_params(prob)
    out = heston_qe_terminal(
        np.log(float(market.spot)), float(market.V0), float(r0), float(market.kappa),
        float(market.theta), float(market.sigma), float(market.rho), T / config.steps,
        n_paths=config.trajectories, steps=config.steps,
        seed=config.seed if config.qmc else seed_from_key(config, key),
        antithetic=isinstance(config.variance_reduction, Antithetic), device_id=device_id,
        martingale_correction=strat.martingale_correction, qmc=config.qmc,
        point_offset=point_offset, device=device,
    )
    return no_derivative(out.to(torch.float64), host_float_kernel("K5"), *heston_scalars(market),
                         r0, prob.payoff.expiry)
