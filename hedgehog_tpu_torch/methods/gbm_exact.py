"""The exact GBM terminal sampler in float64 torch: one lognormal draw per
path, S_T = exp(mean + std·Z).

Port of ``_gbm_exact_terminal`` from ``hedgehog_tpu/methods/montecarlo.py``
(behind ``MonteCarlo(LognormalDynamics(), BlackScholesExact())``, the
default ``MonteCarlo``).  The normals:

- QMC: Sobol' dim 0 through the exact inverse normal CDF, randomized by the
  unsplit base key (the caller's, or ``PRNGKey(config.seed)``): the JAX
  package's ``_qmc_normals(key, 1, 1, paths)``, bit-identical points;
- PRNG: the GBM kernel's Philox layout (ops/gbm_kernel.py ``gbm_normals``)
  in float64.

Antithetic pairs negate Z.  (mean, std) come from ``lognormal_terminal_law``,
so a spot, rate or vol given as a tensor keeps its autograd history.
"""

from __future__ import annotations

import torch

from ..math.counter_rng import prng_key
from ..math.sobol import sobol_uniforms
from ..models.dynamics import lognormal_terminal_law
from ..ops.gbm_kernel import gbm_normals
from ..ops.heston_kernel import seed_from_key
from .montecarlo import Antithetic

__all__ = ["gbm_exact_terminal"]


def gbm_exact_terminal(prob, config, key=None, device_id=0, point_offset=0, *,
                       device) -> torch.Tensor:
    """Terminal prices (n_groups, trajectories), float64."""
    paths = config.trajectories
    if config.qmc:
        base = prng_key(config.seed) if key is None else key
        z = torch.special.ndtri(sobol_uniforms(base, paths, 1, skip=point_offset,
                                               device=device)[:, 0])
    else:
        z = gbm_normals(paths, seed_from_key(config, key), device_id, device, torch.float64)
    z = torch.stack([z, -z]) if isinstance(config.variance_reduction, Antithetic) else z[None]
    mean, std = lognormal_terminal_law(prob.market_inputs, prob.payoff.expiry)
    return torch.exp(mean.to(device) + std.to(device) * z)
