"""Exact lognormal terminal-price kernel (K13) and its plain PyTorch twin.

Port of ``hedgehog_tpu/ops/gbm_kernel.py``: S_T = exp(mean ± std·Z) in fp32,
one Box–Muller normal per antithetic pair.  For tensors on a GPU the work
goes to ``csrc/gbm.cu``; for tensors on the CPU to
:func:`gbm_exact_terminal_plain`, which draws the same Philox bits
(:func:`gbm_normals`: one block per four pairs, its two Box–Muller pairs in
order) and repeats the kernel's fp32 arithmetic.  The float64 sampler
(methods/gbm_exact.py) draws the same normals in float64.
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
    "GBM_KERNEL",
    "gbm_normals",
    "gbm_exact_terminal",
    "gbm_exact_terminal_adapter",
    "gbm_exact_terminal_plain",
]

_MASK32 = 0xFFFFFFFF

GBM_KERNEL = CudaKernel(
    "hh_gbm_terminal",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
     ctypes.c_uint, ctypes.c_void_p],
)


def gbm_normals(n_paths: int, seed: int, device_id: int, device, dtype=torch.float32):
    """(n_paths,) normals of pairs 0..n_paths − 1: Philox block 0 of counter
    g = pair // 4 gives, through Box–Muller of words (0, 1) and (2, 3), the
    normals of pairs 4g .. 4g + 3; the arithmetic runs in ``dtype``."""
    g = torch.arange(-(-n_paths // 4), dtype=torch.int64, device=device)
    w = philox_block(g, 0, seed & _MASK32, device_id & _MASK32)
    z0, z1 = box_muller(w[0], w[1], dtype=dtype)
    z2, z3 = box_muller(w[2], w[3], dtype=dtype)
    return torch.stack([z0, z1, z2, z3], dim=1).reshape(-1)[:n_paths]


def gbm_exact_terminal_plain(params: torch.Tensor, n_paths: int, antithetic: bool, seed: int,
                             device_id: int) -> torch.Tensor:
    """Twin of K13: (1 or 2, n_paths) float32 terminal prices on
    ``params.device``; ``params`` is (mean, std) of log S_T in float32."""
    mean, std = params.unbind()
    z = gbm_normals(n_paths, seed, device_id, params.device)
    rows = [torch.exp(mean + std * z)] + ([torch.exp(mean - std * z)] if antithetic else [])
    return torch.stack(rows)


def _gbm_terminal(params, n_paths, antithetic, seed, device_id) -> torch.Tensor:
    """Launch K13 for a parameter vector on a GPU; the twin for one on the CPU."""
    check_tensor(params, "params", torch.float32, (2,))
    if n_paths < 1:
        raise ValueError(f"need n_paths >= 1; got {n_paths}")
    if params.device.type == "cpu":
        return gbm_exact_terminal_plain(params, n_paths, antithetic, seed, device_id)
    require_cuda(params)
    out = torch.empty((2 if antithetic else 1, n_paths), dtype=torch.float32, device=params.device)
    GBM_KERNEL.launch(params.device, params.data_ptr(), out.data_ptr(), n_paths, int(antithetic),
                      seed & _MASK32, device_id & _MASK32)
    return out


def gbm_exact_terminal(mean, std, *, n_paths: int, seed, antithetic: bool = False, device_id=0,
                       device="cuda") -> torch.Tensor:
    """Terminal lognormal prices (n_groups, n_paths) float32, n_groups = 2
    under antithetic pairing (the JAX signature, with ``device``)."""
    params = torch.as_tensor(np.array([mean, std], dtype=np.float64).astype(np.float32),
                             device=resolve_device(device))
    return _gbm_terminal(params, n_paths, antithetic, int(seed), int(device_id))


def gbm_exact_terminal_adapter(prob, config, key=None, device_id=0, *, device):
    """``MonteCarlo(LognormalDynamics(), BlackScholesExact(use_kernel=True))``
    (and ``EulerMaruyama(use_kernel=True)``, whose log-Euler increments sum
    to the exact law): float64 terminal prices (n_groups, trajectories) from
    K13, the counterpart of the JAX ``gbm_exact_terminal_pallas``.  An
    explicit ``key`` reseeds the stream."""
    from ..methods.montecarlo import Antithetic
    from ..models.dynamics import lognormal_terminal_law
    from .heston_kernel import seed_from_key

    mean, std = lognormal_terminal_law(prob.market_inputs, prob.payoff.expiry)
    out = gbm_exact_terminal(
        float(mean), float(std), n_paths=config.trajectories, seed=seed_from_key(config, key),
        antithetic=isinstance(config.variance_reduction, Antithetic), device_id=device_id,
        device=device)
    return no_derivative(out.to(torch.float64), host_float_kernel("K13"), mean, std)
