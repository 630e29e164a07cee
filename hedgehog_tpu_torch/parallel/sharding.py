"""Path-sharded Monte Carlo over ``torch.distributed`` (port of
``hedgehog_tpu/parallel/sharding.py``).

The domain is embarrassingly parallel across paths.  Each rank of a
process group simulates its own slice of the paths on its own card: under
PRNG an independent Philox stream, keyed ``(seed, device_id = g)``; under
QMC a disjoint slice of ONE Sobol' sequence, ``point_offset = g·local``,
with ``g`` the rank's global index on the mesh and ``local`` its paths.  No
communication is needed to sample, and the one collective is the sum of
the payoffs, so a QMC sharded price equals the single-device ``solve`` to
summation order.  The LSM regression's (degree + 1)² normal equations are
the second, small, sum.

A :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialised default process group stands where the JAX package has a
``jax.sharding.Mesh``: the axis index is ``mesh.get_local_rank(axis)`` and a
``psum`` is an all-reduce over ``mesh.get_group(axis)``.  Start the group in
every rank first: ``torch.distributed.init_process_group(backend,
init_method=..., rank=..., world_size=...)`` with ``nccl`` when each rank
has a card of its own and ``gloo`` otherwise (the CPU, or ranks that share
one card); :func:`~hedgehog_tpu_torch.parallel.dryrun.run_ranks` starts
such ranks.  A rank's paths run on the method's device: ``cuda:<rank>``
when the host has a card for every rank, else ``cuda:0``, shared.

Everything is differentiable: ``torch.autograd.grad`` of a sharded price on
any rank equals the single-device gradient (``collectives.py`` says how).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.problems import PricingProblem
from ..market.rate_curve import df
from ..methods.montecarlo import MonteCarlo, mc_path_values
from ..utils import resolve_device
from .collectives import all_reduce_sum, replicate

__all__ = [
    "make_paths_mesh",
    "make_multislice_mesh",
    "sharded_mc_price",
    "sharded_mc_price_fn",
    "sharded_mc_price_multislice_fn",
    "sharded_lsm_price",
    "sharded_lsm_price_fn",
    "sharded_surface_fn",
]


def _mesh_ranks(devices) -> list:
    """The ranks a mesh spans: every rank of the default process group, in
    the order of ``devices`` (rank numbers) where given."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs the torch.distributed default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., rank=..., "
            "world_size=...) in every rank first (nccl with a card per rank, gloo on the CPU "
            "or for ranks that share a card), or start the ranks with "
            "hedgehog_tpu_torch.parallel.dryrun.run_ranks")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"a mesh spans each of the {world} ranks once; got {ranks}")
    return ranks


def _mesh(ranks, shape, axis_names) -> DeviceMesh:
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=axis_names)


def make_paths_mesh(devices=None, axis_name: str = "paths") -> DeviceMesh:
    """1-D mesh over all ranks of the process group (or the ranks
    ``devices`` lists, in that order) with a ``paths`` axis."""
    ranks = _mesh_ranks(devices)
    return _mesh(ranks, (len(ranks),), (axis_name,))


def make_multislice_mesh(n_slices: int, devices=None,
                         axis_names: tuple = ("slice", "paths")) -> DeviceMesh:
    """2-D (slice × paths) mesh: the leading axis spans slices (hosts, on
    real hardware), the trailing one the ranks within a slice, so payoff
    sums reduce within each slice first and then in ONE sum across slices."""
    ranks = _mesh_ranks(devices)
    if len(ranks) % n_slices != 0:
        raise ValueError(f"{len(ranks)} devices do not divide into {n_slices} slices")
    return _mesh(ranks, (n_slices, len(ranks) // n_slices), tuple(axis_names))


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def rank_device(device) -> torch.device:
    """The device of this rank's paths for a method on ``device``: a CUDA
    device with no index is ``cuda:<rank>`` when the host has a card for
    every rank of the process group, else ``cuda:0``, shared."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    world, rank = dist.get_world_size(), dist.get_rank()
    return torch.device("cuda", rank if torch.cuda.device_count() >= world else 0)


def _local_method(method: MonteCarlo, n_dev: int) -> MonteCarlo:
    """``method`` with one rank's share of the paths, on its rank's device."""
    cfg = method.config
    if cfg.trajectories % n_dev != 0:
        raise ValueError(
            f"trajectories ({cfg.trajectories}) must divide evenly over {n_dev} devices"
        )
    if cfg.qmc and cfg.trajectories > 2**30:
        raise ValueError(
            f"Sobol' sequence period is 2^30 points; total trajectories "
            f"({cfg.trajectories}) would wrap and duplicate points"
        )
    local_cfg = dataclasses.replace(cfg, trajectories=cfg.trajectories // n_dev)
    return dataclasses.replace(method, config=local_cfg, device=str(rank_device(method.device)))


def _rank_values(prob: PricingProblem, local: MonteCarlo, g: int, groups) -> torch.Tensor:
    """The per-path values of the rank with global index ``g`` (its stream
    and its slice of the sequence), the problem replicated over ``groups``."""
    return mc_path_values(replicate(prob, *groups), local, device_id=g,
                          point_offset=g * local.config.trajectories)


def _discounted_mean(prob: PricingProblem, total: torch.Tensor, paths: int) -> torch.Tensor:
    discount = df(prob.market_inputs.rate, prob.payoff.expiry).to(total.device)
    return discount * total / paths


def sharded_mc_price_fn(method: MonteCarlo, mesh: DeviceMesh, axis_name: str = "paths"):
    """Build ``price(prob) -> 0-dim tensor``, the same on every rank, with
    the path axis sharded over ``mesh``'s ``axis_name``.  Differentiable in
    every tensor leaf of ``prob`` that requires grad (spot, the Heston
    parameters, curve pillars ...): per-path values on the replicated
    problem, then one all-reduce of the payoff sums (the path axis last, so
    a strike grid keeps its axis)."""
    n_dev = _axis_size(mesh, axis_name)
    local = _local_method(method, n_dev)
    group = mesh.get_group(axis_name)

    def price(prob: PricingProblem):
        values = _rank_values(prob, local, mesh.get_local_rank(axis_name), (group,))
        total = all_reduce_sum(torch.sum(values, dim=-1), group)
        return _discounted_mean(prob, total, method.config.trajectories)

    return price


def sharded_mc_price(prob: PricingProblem, method: MonteCarlo,
                     mesh: Optional[DeviceMesh] = None):
    """Price a European option with paths sharded across all ranks."""
    return sharded_mc_price_fn(method, make_paths_mesh() if mesh is None else mesh)(prob)


def sharded_mc_price_multislice_fn(method: MonteCarlo, mesh: DeviceMesh,
                                   slice_axis: str = "slice", path_axis: str = "paths"):
    """Build ``price(prob) -> 0-dim tensor`` over a (slice × paths) mesh:
    payoff sums reduce over ``paths`` (the ranks within a slice), then the
    per-slice partials in ONE sum over ``slice``.  The streams take the
    global index g = slice·per_slice + path, the flat enumeration of the 1-D
    mesh, so the price equals the 1-D sharded price and, under QMC, the
    single-device ``solve`` to summation order.  Differentiable through both
    sums."""
    n_slices = _axis_size(mesh, slice_axis)
    n_per_slice = _axis_size(mesh, path_axis)
    local = _local_method(method, n_slices * n_per_slice)
    path_group, slice_group = mesh.get_group(path_axis), mesh.get_group(slice_axis)

    def price(prob: PricingProblem):
        g = mesh.get_local_rank(slice_axis) * n_per_slice + mesh.get_local_rank(path_axis)
        values = _rank_values(prob, local, g, (path_group, slice_group))
        slice_sum = all_reduce_sum(torch.sum(values, dim=-1), path_group)
        total = all_reduce_sum(slice_sum, slice_group)
        return _discounted_mean(prob, total, method.config.trajectories)

    return price


def sharded_surface_fn(method: MonteCarlo, mesh: DeviceMesh, axis_name: str = "paths"):
    """Build ``surface(market, expiries, strikes) -> (n_exp, m)`` with the
    path axis of :func:`~hedgehog_tpu_torch.heston_surface_mc` sharded over
    ``mesh``: each rank's surface of discounted prices over its paths (its
    stream, or its slice of the Sobol' sequence), then their mean over the
    ranks in one all-reduce.  ``method.strategy`` picks the QE or the exact
    variance path, as ``heston_surface_mc``'s ``strategy`` does."""
    from ..methods.heston_surface import heston_surface_mc

    n_dev = _axis_size(mesh, axis_name)
    local = _local_method(method, n_dev)
    group = mesh.get_group(axis_name)

    def surface(market, expiries, strikes):
        g = mesh.get_local_rank(axis_name)
        market_r, strikes_r = replicate((market, strikes), group)
        local_surf = heston_surface_mc(
            market_r, expiries, strikes_r, local.config,
            point_offset=g * local.config.trajectories, strategy=local.strategy,
            device_id=g, device=local.device)
        return all_reduce_sum(local_surf, group) / n_dev

    return surface


def sharded_lsm_price_fn(method, mesh: DeviceMesh, axis_name: str = "paths"):
    """Build a path-sharded LSM American (or Bermudan) pricer over ``mesh``:
    each rank simulates its own grid (its stream or Sobol' slice) and the
    continuation regression of every step runs globally, on normal
    equations summed over the ranks (``lsm_backward_induction``'s
    ``psum_group``); the discounted stopping values are summed once more.
    Barriers are refused: the sharded induction carries no survival state."""
    from ..core.payoffs import BarrierOption
    from ..methods.lsm import (
        LSM,
        _exercise_mask,
        _flatten_grid,
        _is_conditional,
        _lsm_setup,
        device_payoff,
        lsm_backward_induction,
        rb_terminal_value,
    )
    from ..methods.montecarlo import simulate_conditional_grid, simulate_price_grid

    if not isinstance(method, LSM):
        raise TypeError(f"sharded_lsm_price_fn takes an LSM method; got {type(method).__name__}")
    n_dev = _axis_size(mesh, axis_name)
    local_mc = _local_method(method.mc_method, n_dev)
    local = dataclasses.replace(method, mc_method=local_mc)
    conditional = _is_conditional(method.mc_method)
    group = mesh.get_group(axis_name)

    def price(prob: PricingProblem):
        if isinstance(prob.payoff, BarrierOption):
            # the sharded induction carries no survival state, so a knock-out
            # would price as the plain American vanilla
            raise TypeError(
                "sharded LSM does not carry the barrier survival state; "
                "price American knock-outs through solve(problem, LSM(...)) "
                "on a single device"
            )
        # the discount weighs each rank's own paths: it is taken from the
        # replicated problem, so its gradient sums over the ranks too
        prob_r = replicate(prob, group)
        log_disc, strike_scale = _lsm_setup(prob_r, local)
        ex_mask = _exercise_mask(prob, local)  # the Bermudan gate (None: American)
        g = mesh.get_local_rank(axis_name)
        kw = dict(point_offset=g * local_mc.config.trajectories, device_id=g)
        if conditional:
            s_grid, v_grid = simulate_conditional_grid(prob_r, local_mc.config,
                                                       device=local_mc.device, **kw)
            spots, vols = _flatten_grid(s_grid), _flatten_grid(v_grid)
            terminal = rb_terminal_value(prob_r, spots, vols) if method.rao_blackwell else None
        else:
            spots = _flatten_grid(simulate_price_grid(prob_r, local_mc, **kw))
            vols = terminal = None
        tau, value = lsm_backward_induction(
            spots, device_payoff(prob.payoff, spots.device), log_disc, method.degree,
            strike_scale, psum_group=group, vols=vols, terminal_value=terminal,
            exercise_mask=ex_mask)
        total = all_reduce_sum(torch.sum(torch.exp(tau * log_disc) * value), group)
        return total / (spots.shape[1] * n_dev)

    return price


def sharded_lsm_price(prob: PricingProblem, method, mesh: Optional[DeviceMesh] = None):
    """Price an American option by LSM with paths sharded across all ranks."""
    return sharded_lsm_price_fn(method, make_paths_mesh() if mesh is None else mesh)(prob)
