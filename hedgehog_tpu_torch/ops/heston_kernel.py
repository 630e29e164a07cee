"""Heston Euler terminal-price kernel (K1) and its plain PyTorch twin.

Port of ``hedgehog_tpu/ops/heston_kernel.py``: the TPU kernel's work, a
full-truncation log-Euler step per time step with Box-Muller normals in
fp32, goes to the CUDA kernel in ``csrc/heston_euler.cu`` for tensors on a
GPU and to :func:`heston_euler_terminal_plain` for tensors on the CPU.  The
twin draws the same Philox bits in the same layout and repeats the
kernel's fp32 arithmetic, so the two agree to fp32 rounding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import resolve_device
from .autograd_limits import host_float_kernel, no_derivative
from .cuda_lib import CudaKernel, check_tensor, require_cuda
from .hh_device import box_muller, philox_block

__all__ = [
    "EULER_KERNEL",
    "heston_euler_terminal",
    "heston_euler_terminal_adapter",
    "heston_euler_terminal_plain",
    "seed_from_key",
]

_MASK32 = 0xFFFFFFFF

EULER_KERNEL = CudaKernel(
    "hh_heston_euler_terminal",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p],
)


def seed_from_key(config, key) -> int:
    """Effective kernel seed: the config's seed, or — for an explicit key
    (its uint32 words, e.g. ``np.asarray(jax.random.key_data(k))``) — an
    int32 mixed from that key, so distinct keys give independent streams
    (the contract of the JAX package's ``seed_from_key``)."""
    if key is None:
        return config.seed
    data = np.asarray(key, dtype=np.uint32).ravel()
    mixed = (int(data[0]) ^ (int(data[-1]) * 2654435761)) & _MASK32  # Knuth multiplicative mix
    return mixed - (1 << 32) if mixed >= 1 << 31 else mixed


def _euler_params(log_s0, v0, r, kappa, theta, sigma, rho, dt) -> np.ndarray:
    return np.array([log_s0, v0, r, kappa, theta, sigma, rho, dt], dtype=np.float64).astype(np.float32)


def _euler_advance(x, v, z1, z2, c: dict):
    """One full-truncation log-Euler step on float32 tensors."""
    v_plus = torch.clamp(v, min=0.0)
    sqrt_vdt = torch.sqrt(v_plus * c["dt"])
    x2 = x + (c["drift_r"] - 0.5 * v_plus * c["dt"]) + sqrt_vdt * z1
    v2 = v + c["kappa"] * (c["theta"] - v_plus) * c["dt"] + c["sigma"] * sqrt_vdt * (
        c["rho"] * z1 + c["rho_bar"] * z2
    )
    return x2, v2


def heston_euler_terminal_plain(params: torch.Tensor, n_paths: int, steps: int, seed: int,
                                antithetic: bool, device_id: int) -> torch.Tensor:
    """Twin of the CUDA kernel: (1 or 2, n_paths) float32 terminal prices on
    ``params.device``.  Philox draw block ``s // 2`` of pair ``i`` feeds
    step ``s`` with words (0, 1) on even and (2, 3) on odd steps."""
    log_s0, v0, r, kappa, theta, sigma, rho, dt = params.unbind()
    c = dict(dt=dt, drift_r=r * dt, kappa=kappa, theta=theta, sigma=sigma, rho=rho,
             rho_bar=torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)))
    pair = torch.arange(n_paths, dtype=torch.int64, device=params.device)
    x, v = log_s0.expand(n_paths), v0.expand(n_paths)
    xa, va = x, v
    words = None
    for s in range(steps):
        if s % 2 == 0:
            words = philox_block(pair, s // 2, seed & _MASK32, device_id & _MASK32)
            b0, b1 = words[0], words[1]
        else:
            b0, b1 = words[2], words[3]
        z1, z2 = box_muller(b0, b1)
        x, v = _euler_advance(x, v, z1, z2, c)
        if antithetic:
            xa, va = _euler_advance(xa, va, -z1, -z2, c)
    rows = [torch.exp(x), torch.exp(xa)] if antithetic else [torch.exp(x)]
    return torch.stack(rows)


def _euler_terminal(params: torch.Tensor, n_paths: int, steps: int, seed: int,
                    antithetic: bool, device_id: int) -> torch.Tensor:
    """Launch K1 for a parameter vector on a GPU; the twin for one on the CPU."""
    check_tensor(params, "params", torch.float32, (8,))
    if n_paths < 1 or steps < 1:
        raise ValueError(f"need n_paths >= 1 and steps >= 1; got {n_paths}, {steps}")
    if params.device.type == "cpu":
        return heston_euler_terminal_plain(params, n_paths, steps, seed, antithetic, device_id)
    require_cuda(params)
    out = torch.empty((2 if antithetic else 1, n_paths), dtype=torch.float32, device=params.device)
    EULER_KERNEL.launch(
        params.device, params.data_ptr(), out.data_ptr(), n_paths, steps, int(antithetic),
        seed & _MASK32, device_id & _MASK32,
    )
    return out


def heston_euler_terminal(log_s0, v0, r, kappa, theta, sigma, rho, dt, *, n_paths: int,
                          steps: int, seed, antithetic: bool = False, device_id=0,
                          device="cuda") -> torch.Tensor:
    """Terminal Heston prices, (n_groups, n_paths) float32 with n_groups = 2
    under antithetic pairing (the JAX signature with ``device`` in place of
    ``interpret``)."""
    params = torch.as_tensor(
        _euler_params(log_s0, v0, r, kappa, theta, sigma, rho, dt), device=resolve_device(device)
    )
    return _euler_terminal(params, n_paths, steps, int(seed), antithetic, int(device_id))


def heston_scalars(market) -> tuple:
    """The Heston market's six model scalars (spot, V0, κ, θ, σ, ρ), which
    the kernels without a backward read as host floats."""
    return (market.spot, market.V0, market.kappa, market.theta, market.sigma, market.rho)


def heston_euler_terminal_adapter(prob, config, key=None, device_id=0, *, device):
    """``MonteCarlo(HestonDynamics(), EulerMaruyama(use_kernel=True))``:
    float64 terminal prices (n_groups, trajectories) from the kernel, the
    counterpart of the JAX ``heston_euler_terminal_pallas``.  An explicit
    ``key`` reseeds the stream (:func:`seed_from_key`)."""
    from ..market.inputs import carry_yield, market_yearfrac
    from ..market.rate_curve import zero_rate_yf
    from ..methods.montecarlo import Antithetic

    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    rate, carry = zero_rate_yf(market.rate, 0.0), carry_yield(market)
    r0 = float(rate) - float(carry)
    out = heston_euler_terminal(
        np.log(float(market.spot)), float(market.V0), r0, float(market.kappa),
        float(market.theta), float(market.sigma), float(market.rho), T / config.steps,
        n_paths=config.trajectories, steps=config.steps, seed=seed_from_key(config, key),
        antithetic=isinstance(config.variance_reduction, Antithetic), device_id=device_id,
        device=device,
    )
    return no_derivative(out.to(torch.float64), host_float_kernel("K1"), *heston_scalars(market),
                         rate, carry, prob.payoff.expiry)
