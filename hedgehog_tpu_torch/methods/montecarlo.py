"""Monte Carlo pricing: dynamics × strategy × config, for European vanillas
under Black-Scholes, Heston and rough Bergomi.

Port of the slice of ``hedgehog_tpu/methods/montecarlo.py`` that prices a
European vanilla under Heston, Black-Scholes and rough Bergomi (reference
montecarlo.jl):
the configuration taxonomy, the two dispatchers and the solver.  The
estimators live beside it: ``gbm_exact.py`` (exact lognormal draw),
``heston_euler.py`` (full-truncation log-Euler), ``heston_qe_paths.py``
(the QE-M terminal sampler), ``heston_exact_mixing.py`` (exact-transition
mixing), ``heston_qe_mixing.py`` (QE variance path, conditional close) and
``rough_bergomi_mixing.py`` (exact Volterra draws, conditional close);
``use_kernel=True`` routes them through the CUDA kernels of
``hedgehog_tpu_torch.ops``.  ``simulate_price_grid`` and
``simulate_conditional_grid`` give the whole path grids the early-exercise
methods regress on (methods/lsm.py), and ``mc_path_values`` the per-path
value estimates of every strategy.

On the QE paths, the exact-mixing and rough-Bergomi mixing paths and the
GBM samplers, market fields that are 0-dim tensors stay tensors, so
``torch.autograd.grad`` of a ``solve`` price reaches them (on the QE and
rough-Bergomi mixing paths through the kernels' backward as well).

``MonteCarlo.device`` names where the paths are simulated, the GPU unless
the caller asks for the CPU.  A CUDA device without a GPU raises; on a CUDA
device ``use_kernel=True`` launches the kernels and never falls back to the
plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.payoffs import VanillaOption, require_european
from ..core.problems import MonteCarloSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df, zero_rate_yf
from ..models.dynamics import HestonDynamics, LognormalDynamics, RoughBergomiDynamics
from ..utils import f64, resolve_device

__all__ = [
    "SimulationConfig",
    "MonteCarlo",
    "EulerMaruyama",
    "HestonExactMixing",
    "HestonQE",
    "RoughBergomiMixing",
    "BlackScholesExact",
    "NoVarianceReduction",
    "Antithetic",
    "simulate_terminal_prices",
    "simulate_conditional_values",
    "simulate_price_grid",
    "simulate_conditional_grid",
    "mc_path_values",
    "reduce_payoffs",
]

_frozen = dataclasses.dataclass(frozen=True)


class VarianceReductionStrategy:
    pass


@_frozen
class NoVarianceReduction(VarianceReductionStrategy):
    pass


@_frozen
class Antithetic(VarianceReductionStrategy):
    """Antithetic pairs: negated normals, mirrored (1 − u) uniforms."""


class SimulationStrategy:
    pass


@_frozen
class EulerMaruyama(SimulationStrategy):
    """Full-truncation log-Euler stepping; ``use_kernel=True`` runs the
    CUDA kernel (ops/heston_kernel.py)."""

    use_kernel: bool = False


@_frozen
class HestonExactMixing(SimulationStrategy):
    """Exact-transition segmented mixing estimator (models/heston_exact.py):
    exact noncentral-χ² CIR transitions, gamma-matched exact conditional ∫V,
    conditional Black-Scholes close.  Sub-bp scheme bias at
    ``config.steps = 2`` segments.  It prices through ``solve`` only (no
    terminal samples); ``use_kernel=True`` runs the CUDA kernel
    (ops/heston_exact_kernel.py)."""

    use_kernel: bool = False


@_frozen
class HestonQE(SimulationStrategy):
    """Andersen Quadratic-Exponential discretization (models/heston_qe.py).

    By default the QE-M terminal sampler: per step two normals and a uniform
    move (log S, V), with the martingale correction that makes E[S'] =
    S·e^{rΔ} exactly (methods/heston_qe_paths.py; ``use_kernel=True`` runs
    the CUDA kernel K5, whose in-kernel Sobol' stream serves ``qmc=True``).
    ``conditional=True`` prices European vanillas by the Romano–Touzi
    conditional (mixing) estimator instead: only the variance path is
    simulated (one normal and one uniform per step) and each path closes
    with the conditional Black-Scholes formula; it prices through ``solve``
    only.  ``use_kernel=True`` then runs the mixing kernels
    (ops/heston_qe_kernel.py), whose backward is a kernel too
    (ops/heston_qe_greeks_kernel.py)."""

    martingale_correction: bool = True
    use_kernel: bool = False
    conditional: bool = False


@_frozen
class RoughBergomiMixing(SimulationStrategy):
    """Exact-Volterra mixing estimator for rough Bergomi (pair with
    RoughBergomiDynamics and RoughBergomiInputs; scheme in
    models/rough_bergomi.py): the joint Gaussian (ΔW1, Z) vector is drawn
    exactly from its covariance through one Cholesky factor, and each
    variance path closes with the conditional Black-Scholes formula.  The
    only discretization is the left-point sum for (∫V, ∫√V dW1);
    ``config.steps`` is the grid size n.  It prices through ``solve`` only.
    ``quad_nodes`` sizes the Gauss–Legendre panel behind the Z covariance;
    ``fp32=True`` runs the draws, the product and the sums in float32.
    ``use_kernel=True`` runs scalar-strike vanillas through the CUDA kernel
    K14 (ops/rbergomi_kernel.py), whose backward is the kernel K17."""

    quad_nodes: int = 64
    fp32: bool = False
    use_kernel: bool = False


@_frozen
class BlackScholesExact(SimulationStrategy):
    """Exact terminal lognormal draw (no path discretization error);
    ``use_kernel=True`` runs the CUDA kernel K13 (ops/gbm_kernel.py)."""

    use_kernel: bool = False


@_frozen
class SimulationConfig:
    """MC run configuration (montecarlo.jl:58-79): ``trajectories`` paths
    (antithetic pairs under :class:`Antithetic`), ``steps`` time steps (or
    exact segments), the base ``seed`` of the counter-based streams, and
    ``qmc=True`` for digitally shifted Sobol' points."""

    trajectories: int = 10_000
    steps: int = 1
    variance_reduction: VarianceReductionStrategy = NoVarianceReduction()
    seed: int = 0
    qmc: bool = False

    def __post_init__(self):
        if self.qmc and self.trajectories > 2**30:
            raise ValueError(
                f"Sobol' sequence period is 2^30 points; trajectories "
                f"({self.trajectories}) would wrap and duplicate points"
            )


@_frozen
class MonteCarlo(AbstractPricingMethod):
    """Monte Carlo pricing of ``dynamics`` by ``strategy`` under ``config``,
    simulated on ``device``: by default exact lognormal draws
    (LognormalDynamics, BlackScholesExact), as in the JAX package, on the
    GPU; the CPU only when asked for (``device="cpu"``)."""

    dynamics: Any = LognormalDynamics()
    strategy: Any = BlackScholesExact()
    config: SimulationConfig = SimulationConfig()
    device: str = "cuda"


def sim_params(prob: PricingProblem):
    """(market, T, r0): the drift r0 is the zero rate at time 0 less the
    carry (montecarlo.jl:176, :200), a float64 0-dim tensor that keeps the
    rate's autograd history."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    r0 = zero_rate_yf(market.rate, 0.0) - f64(carry_yield(market))
    return market, T, r0


def _is_conditional_strategy(strat) -> bool:
    """True for the strategies that price through the conditional (mixing)
    estimator and never materialize terminal samples."""
    return (isinstance(strat, HestonQE) and strat.conditional) or isinstance(
        strat, (HestonExactMixing, RoughBergomiMixing))


def simulate_conditional_values(prob: PricingProblem, method: MonteCarlo, key=None,
                                device_id=0, point_offset=0) -> torch.Tensor:
    """Per-path undiscounted conditional vanilla values (n_groups, paths),
    float64 on ``method.device``."""
    dyn, strat, config = method.dynamics, method.strategy, method.config
    if isinstance(dyn, RoughBergomiDynamics) or isinstance(strat, RoughBergomiMixing):
        return _rbergomi_conditional_values(prob, method, key, device_id, point_offset)
    if not (isinstance(strat, (HestonQE, HestonExactMixing)) and isinstance(dyn, HestonDynamics)):
        raise TypeError(
            "conditional Monte Carlo requires HestonDynamics with HestonQE or "
            f"HestonExactMixing; got ({type(dyn).__name__}, {type(strat).__name__})"
        )
    require_european(prob.payoff, "conditional MonteCarlo", spot_only=True)
    device = resolve_device(method.device)
    if strat.use_kernel:
        if torch.as_tensor(prob.payoff.strike).ndim > 0:
            raise TypeError(
                "strike grids with conditional MC are a pure-torch feature "
                "(one V-path set prices every strike); drop use_kernel=True"
            )
        if not isinstance(prob.payoff, VanillaOption):
            raise TypeError(
                "the fused mixing kernels close vanilla payoffs only; "
                f"{type(prob.payoff).__name__} needs the pure-torch estimator "
                "(drop use_kernel=True)"
            )
        if isinstance(strat, HestonExactMixing):
            from ..ops.heston_exact_kernel import heston_exact_mixing_values_adapter as adapter
        else:
            from ..ops.heston_qe_kernel import heston_qe_mixing_values_adapter as adapter
        return adapter(prob, config, strat, key=key, device_id=device_id,
                       point_offset=point_offset, device=device)
    if isinstance(strat, HestonExactMixing):
        from .heston_exact_mixing import heston_exact_mixing_values as values
    else:
        from .heston_qe_mixing import heston_qe_mixing_values as values
    return values(prob, config, key=key, device_id=device_id, point_offset=point_offset,
                  device=device)


def _rbergomi_conditional_values(prob, method, key, device_id, point_offset):
    """The rough-Bergomi branch of :func:`simulate_conditional_values`, with
    the JAX package's guards."""
    dyn, strat, config = method.dynamics, method.strategy, method.config
    if not (isinstance(dyn, RoughBergomiDynamics) and isinstance(strat, RoughBergomiMixing)):
        raise TypeError(
            "rough Bergomi conditional MC pairs RoughBergomiDynamics with RoughBergomiMixing; "
            f"got ({type(dyn).__name__}, {type(strat).__name__})"
        )
    require_european(prob.payoff, "conditional MonteCarlo", spot_only=True)
    device = resolve_device(method.device)
    kw = dict(key=key, device_id=device_id, point_offset=point_offset, device=device)
    if strat.use_kernel:
        if not isinstance(prob.payoff, VanillaOption) or torch.as_tensor(prob.payoff.strike).ndim > 0:
            raise TypeError(
                "the fused rough-Bergomi kernel closes scalar-strike vanillas only; other "
                "payoffs and strike grids price through the torch estimator (drop use_kernel=True)"
            )
        from ..ops.rbergomi_kernel import rbergomi_mixing_values_adapter

        return rbergomi_mixing_values_adapter(prob, config, strat, **kw)
    from .rough_bergomi_mixing import rbergomi_mixing_values

    return rbergomi_mixing_values(prob, config, quad_nodes=strat.quad_nodes, fp32=strat.fp32, **kw)


def simulate_terminal_prices(prob: PricingProblem, method: MonteCarlo, key=None,
                             device_id=0, point_offset=0) -> torch.Tensor:
    """Terminal asset prices (n_groups, trajectories), n_groups = 2 under
    antithetic pairing, float64 on ``method.device``.  Under QMC,
    ``point_offset`` selects a disjoint slice of one Sobol' sequence."""
    dyn, strat, config = method.dynamics, method.strategy, method.config
    if _is_conditional_strategy(strat):
        raise TypeError(
            f"{type(strat).__name__} is a conditional (mixing) strategy and "
            "never materializes terminal samples (logS_T is integrated out "
            "analytically); price through solve(...)"
        )
    route = None
    if isinstance(dyn, LognormalDynamics) and isinstance(strat, (EulerMaruyama, BlackScholesExact)):
        # log-Euler GBM increments sum exactly: EulerMaruyama(use_kernel=True)
        # runs the exact lognormal kernel, as in the JAX package
        route = ("gbm_euler" if isinstance(strat, EulerMaruyama) and not strat.use_kernel
                 else "gbm")
    elif isinstance(dyn, HestonDynamics) and isinstance(strat, (EulerMaruyama, HestonQE)):
        route = "euler" if isinstance(strat, EulerMaruyama) else "qe"
    if route is None:
        raise TypeError(
            f"unsupported (dynamics, strategy) = ({type(dyn).__name__}, {type(strat).__name__})"
        )
    if config.qmc and strat.use_kernel and route != "qe":
        # the GBM and Euler kernels draw their own PRNG streams: a silent
        # pseudo-random fallback would betray the accuracy the caller sized
        # for (the QE-M kernel has an in-kernel Sobol' stream)
        raise ValueError(
            "qmc=True is not supported with the GBM/Euler kernel strategies; use the "
            "float64 samplers or HestonQE(use_kernel=True)"
        )
    device = resolve_device(method.device)
    kw = dict(key=key, device_id=device_id, device=device)
    if route == "gbm_euler":
        from .gbm_euler import gbm_euler_paths

        return gbm_euler_paths(prob, config, point_offset=point_offset, return_grid=False, **kw)
    if route == "gbm":
        if strat.use_kernel:
            from ..ops.gbm_kernel import gbm_exact_terminal_adapter

            return gbm_exact_terminal_adapter(prob, config, **kw)
        from .gbm_exact import gbm_exact_terminal

        return gbm_exact_terminal(prob, config, point_offset=point_offset, **kw)
    if route == "qe":
        if strat.use_kernel:
            from ..ops.heston_qe_kernel import heston_qe_terminal_adapter as qe_paths
        else:
            from .heston_qe_paths import heston_qe_paths as qe_paths
        return qe_paths(prob, config, strat, point_offset=point_offset, **kw)
    if strat.use_kernel:
        from ..ops.heston_kernel import heston_euler_terminal_adapter

        return heston_euler_terminal_adapter(prob, config, **kw)
    from .heston_euler import heston_euler_paths

    return heston_euler_paths(prob, config, point_offset=point_offset, **kw)


def simulate_price_grid(prob: PricingProblem, method: MonteCarlo, key=None,
                        point_offset=0) -> torch.Tensor:
    """The price grid (n_groups, steps + 1, trajectories), float64 on
    ``method.device``, for the grid methods (LSM): lognormal dynamics step
    with the exact per-step lognormal transition (the log-Euler GBM paths,
    whatever the strategy), Heston Euler and QE(-M) with the terminal
    samplers' steppers and draws, and ``HestonQE(conditional=True)`` with
    the conditional bridge (its S grid; LSM takes the V grid too through
    :func:`simulate_conditional_grid`)."""
    dyn, strat, config = method.dynamics, method.strategy, method.config
    kw = dict(key=key, point_offset=point_offset)
    if isinstance(strat, HestonQE) and strat.conditional:
        if not isinstance(dyn, HestonDynamics):
            raise TypeError("HestonQE(conditional=True) requires HestonDynamics")
        return simulate_conditional_grid(prob, config, device=method.device, **kw)[0]
    device = resolve_device(method.device)
    if isinstance(dyn, LognormalDynamics):
        from .gbm_euler import gbm_euler_paths

        return gbm_euler_paths(prob, config, return_grid=True, device=device, **kw)
    if isinstance(dyn, HestonDynamics) and isinstance(strat, EulerMaruyama):
        from .heston_euler import heston_euler_paths

        return heston_euler_paths(prob, config, return_grid=True, device=device, **kw)
    if isinstance(dyn, HestonDynamics) and isinstance(strat, HestonQE):
        from .heston_qe_paths import heston_qe_paths

        return heston_qe_paths(prob, config, strat, return_grid=True, device=device, **kw)
    raise TypeError(
        f"unsupported grid simulation ({type(dyn).__name__}, {type(strat).__name__})"
    )


def simulate_conditional_grid(prob: PricingProblem, config: SimulationConfig, key=None,
                              point_offset=0, *, device="cuda"):
    """(S, V) grids, each (n_groups, steps + 1, trajectories) float64 on
    ``device``: the QE variance path plus the exact conditional lognormal
    bridge for S over each step, given the step's trapezoid ∫V proxy IV and
    the CIR identity J = (V' − V − κθΔ + κ·IV)/σ:

        logS' = logS + r0·Δ − IV/2 + ρ·J + √((1 − ρ²)·IV)·Z⊥,

    one extra normal per step.  The draws per step are (Z_V, Z⊥, U): under
    QMC Sobol' dims 3s, 3s + 1, 3s + 2 randomized by the unsplit base key
    (the JAX package's points), under PRNG the QE-M Philox layout."""
    from ..models.heston_qe import qe_constants, qe_v_step
    from .heston_qe_paths import qe_m_draws

    dev = resolve_device(device)
    market, T, r0 = sim_params(prob)
    dt = T / config.steps
    spot, v0, kappa, theta, sigma, rho, r0 = (
        f64(x, device=dev) for x in (market.spot, market.V0, market.kappa, market.theta,
                                     market.sigma, market.rho, r0))
    c = qe_constants(kappa, theta, sigma, rho, r0, dt)
    ktd = kappa * theta * dt
    rho_bar2 = 1.0 - rho**2
    z_v, z_perp, u = qe_m_draws(config, key, 0, point_offset, device=dev, split_key=False)
    zeros = torch.zeros(z_v.shape[1:], dtype=torch.float64, device=dev)
    x, v = torch.log(spot) + zeros, v0 + zeros
    xs, vs = [x], [v]
    for k in range(config.steps):
        v_new = qe_v_step(v, z_v[k], u[k], c)
        iv = 0.5 * dt * (v + v_new)
        j = (v_new - v - ktd + kappa * iv) / sigma
        x = x + r0 * dt - 0.5 * iv + rho * j + torch.sqrt(
            torch.clamp(rho_bar2 * iv, min=1e-18)) * z_perp[k]
        v = v_new
        xs.append(x)
        vs.append(v)
    return torch.exp(torch.stack(xs, dim=1)), torch.stack(vs, dim=1)


def mc_path_values(prob: PricingProblem, method: MonteCarlo, key=None, device_id=0,
                   point_offset=0) -> torch.Tensor:
    """Per-path undiscounted value estimates, antithetic groups averaged,
    for every strategy: the conditional values of the mixing strategies or
    the payoffs of the terminal samples.  Shape (paths,), or (m, paths) for
    a strike grid (the path axis last)."""
    if _is_conditional_strategy(method.strategy):
        values = simulate_conditional_values(prob, method, key=key, device_id=device_id,
                                             point_offset=point_offset)
        return torch.mean(values, dim=0)
    if not isinstance(prob.payoff, VanillaOption):
        raise TypeError(
            "mc_path_values covers single-asset terminal-sample payoffs; price "
            f"{type(prob.payoff).__name__} through solve(...)"
        )
    samples = simulate_terminal_prices(prob, method, key=key, device_id=device_id,
                                       point_offset=point_offset)
    return reduce_payoffs(samples, prob.payoff)


def reduce_payoffs(samples: torch.Tensor, payoff) -> torch.Tensor:
    """Per-path payoffs, antithetic groups averaged pairwise
    (montecarlo.jl:428-432); a strike grid gives (m, paths)."""
    if torch.as_tensor(payoff.strike).ndim > 0:
        strikes = torch.as_tensor(payoff.strike, dtype=samples.dtype, device=samples.device)
        payoff = dataclasses.replace(payoff, strike=strikes[:, None])
        return torch.mean(payoff(samples[:, None, :]), dim=0)
    return torch.mean(payoff(samples), dim=0)


@register_solver(MonteCarlo)
def _solve_montecarlo(prob: PricingProblem, method: MonteCarlo) -> MonteCarloSolution:
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    device = resolve_device(method.device)
    discount = df(prob.market_inputs.rate, payoff.expiry).to(device)
    if _is_conditional_strategy(method.strategy):
        values = simulate_conditional_values(prob, method)
        price = discount * torch.mean(values, dim=(0, -1))
        return MonteCarloSolution(prob, method, price, values)
    samples = simulate_terminal_prices(prob, method)
    payoffs = reduce_payoffs(samples, payoff)
    price = discount * torch.mean(payoffs, dim=-1)
    return MonteCarloSolution(prob, method, price, samples)
