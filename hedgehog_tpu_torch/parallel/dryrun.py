"""The multi-rank dry run: one sharded calibration step and the sharded
flagship estimators, each held against a one-device replay (port of
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``).

:func:`run_ranks` starts ``n`` ranks with ``torch.multiprocessing``
(spawn), each joining one ``torch.distributed`` process group through a
``file://`` rendezvous in a temporary directory, and returns what each
rank's function returned.  A rank that raises, dies or outlives the time
limit fails the call: the parent terminates the other ranks and raises.

:func:`dryrun_multichip` runs :func:`dryrun_rank`'s five phases at the JAX
package's sizes on ``n`` ranks and prints one line a phase:

1. a Heston Euler calibration step on an instruments × paths mesh (strikes
   sharded over instruments, payoff sums over paths, the squared residuals
   over instruments), its price grid, loss and gradient against a replay
   of the same per-rank streams on one device (rel 1e-9);
2. the QE-mixing surface calibration step (``sharded_surface_fn``) against
   its replay (1e-9);
3. the sharded LSM American put against the global regression over the
   concatenated per-rank grids (1e-8);
4. the exact-mixing flagship under QMC against the single-device ``solve``
   (1e-9);
5. the 2 × (n/2) multi-slice price against phase 4 and the ``solve`` (1e-9).

Ranks on the CPU reduce over ``gloo``; on a host with a card for every rank
over ``nccl``; with fewer cards than ranks the ranks share ``cuda:0`` and
reduce over ``gloo`` (:func:`default_backend`).
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils import resolve_device

__all__ = ["run_ranks", "default_backend", "dryrun_rank", "dryrun_multichip"]

_REF = dt.date(2024, 1, 1)
_EXPIRY = dt.date(2025, 1, 1)
_RATE = 0.03
_PARAMS = (100.0, 0.04, 2.0, 0.04, 0.3, -0.7)  # spot, V0, kappa, theta, sigma, rho


def default_backend(n: int, device) -> str:
    """``nccl`` when the ranks run on cards and the host has one for each,
    else ``gloo`` (the CPU, or ranks that share one card)."""
    dev = resolve_device(device)
    return "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= n else "gloo"


def _rank_main(rank, n, backend, init_method, timeout, fn, args, results):
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n,
                                timeout=dt.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_ranks(n: int, fn, *args, backend: str = "gloo", timeout: float = 600.0) -> list:
    """``[fn(*args) on rank 0, ..., on rank n − 1]``, each rank a spawned
    process in one ``backend`` process group of ``n`` ranks (its collective
    timeout ``timeout`` seconds too).  ``fn`` and ``args`` are pickled, so
    ``fn`` is a module-level function, and so is each result.  Raises
    RuntimeError with the rank's traceback when a rank raises or exits
    without a result, and TimeoutError when the ranks take longer than
    ``timeout`` seconds; every rank still running is then terminated."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done = {}
    with tempfile.TemporaryDirectory(prefix="hh_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, n, backend, init_method, timeout, fn, args, results))
                 for rank in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(done) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(n)) - set(done))} of {n} gave "
                                       f"no result within {timeout:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    lost = [r for r, p in enumerate(procs) if r not in done and not p.is_alive()]
                    if lost and results.empty():
                        codes = [procs[r].exitcode for r in lost]
                        raise RuntimeError(f"ranks {lost} exited (codes {codes}) with no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
                done[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks exited with codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(n)]


def _check(got, want, rtol: float, atol: float, what: str) -> None:
    got, want = torch.as_tensor(got), torch.as_tensor(want).to(torch.as_tensor(got).device)
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: {got.tolist()} against {want.tolist()}")


def _problem(params, strike=100.0, style=None, cp=None):
    from .. import (Call, European, HestonInputs, PricingProblem, Spot, VanillaOption)

    payoff = VanillaOption(strike, _EXPIRY, style or European(), cp or Call(), Spot())
    return PricingProblem(payoff, HestonInputs(_REF, _RATE, *params))


def _leaves(device):
    return tuple(torch.tensor(x, dtype=torch.float64, device=device, requires_grad=True)
                 for x in _PARAMS)


def _payoff_sums(params, g: int, strikes, method):
    """Per-strike sums over rank ``g``'s paths of the antithetic-averaged
    call payoffs: the one function both the sharded step and its replay
    evaluate."""
    from ..methods.montecarlo import simulate_terminal_prices

    samples = simulate_terminal_prices(_problem(params), method, device_id=g)  # (groups, paths)
    payoffs = torch.clamp(samples[:, None, :] - strikes[:, None], min=0.0)
    return torch.sum(torch.mean(payoffs, dim=0), dim=-1)


def _phase_euler_step(n: int, device) -> dict:
    from .. import EulerMaruyama, HestonDynamics, MonteCarlo, SimulationConfig, yearfrac
    from .collectives import all_reduce_sum, replicate
    from .sharding import make_multislice_mesh

    n_inst = 2 if n % 2 == 0 and n > 1 else 1
    n_path = n // n_inst
    mesh = make_multislice_mesh(n_inst, axis_names=("instruments", "paths"))
    inst_group, path_group = mesh.get_group("instruments"), mesh.get_group("paths")
    per_shard, paths_per_device = 4, 512
    strikes = torch.linspace(80.0, 120.0, n_inst * per_shard, dtype=torch.float64, device=device)
    quotes = torch.full_like(strikes, 9.0)
    method = MonteCarlo(HestonDynamics(), EulerMaruyama(),
                        SimulationConfig(paths_per_device, 8, seed=0), device=str(device))
    total_paths = paths_per_device * n_path
    T = float(yearfrac(_REF, _EXPIRY))
    discount = torch.exp(torch.tensor(-_RATE * T, dtype=torch.float64, device=device))
    i, p = mesh.get_local_rank("instruments"), mesh.get_local_rank("paths")
    block = slice(i * per_shard, (i + 1) * per_shard)

    params = _leaves(device)
    sums = _payoff_sums(replicate(params, inst_group, path_group), i * n_path + p,
                        strikes[block], method)
    prices_local = discount * all_reduce_sum(sums, path_group) / total_paths
    loss = all_reduce_sum(torch.sum((prices_local - quotes[block]) ** 2), inst_group)
    grads = torch.autograd.grad(loss, params)
    new_params = [float(x.detach() - 1e-3 * g_) for x, g_ in zip(params, grads)]
    if not (torch.isfinite(loss) and all(map(torch.isfinite, grads))):
        raise AssertionError(f"sharded calibration step: loss {loss}, gradient {grads}")
    grid = torch.zeros_like(strikes)
    grid[block] = prices_local.detach()
    prices = all_reduce_sum(grid, inst_group)
    out = dict(mesh=f"{n_inst}x{n_path}", loss=float(loss.detach()), prices=prices.tolist(),
               grads=[float(x) for x in grads], new_params=new_params)
    if dist.get_rank() == 0:
        ref_params = _leaves(device)
        rows = []
        for ii in range(n_inst):
            acc = sum(_payoff_sums(ref_params, ii * n_path + pp,
                                   strikes[ii * per_shard:(ii + 1) * per_shard], method)
                      for pp in range(n_path))
            rows.append(discount * acc / total_paths)
        prices_ref = torch.cat(rows)
        loss_ref = torch.sum((prices_ref - quotes) ** 2)
        grads_ref = torch.autograd.grad(loss_ref, ref_params)
        _check(prices, prices_ref.detach(), 1e-9, 1e-12, "sharded price grid against its replay")
        _check(loss.detach(), loss_ref.detach(), 1e-9, 1e-12, "sharded loss against its replay")
        _check(torch.stack(grads), torch.stack(grads_ref), 1e-9, 1e-12,
               "sharded gradient against its replay")
        out["line"] = (f"phase 1 (Euler grad step): mesh={out['mesh']} loss={out['loss']:.6g} "
                       f"price-grid, loss and gradient replay match ok")
    return out


def _phase_surface_step(n: int, mesh, device) -> dict:
    from .. import (Antithetic, HestonDynamics, HestonInputs, HestonQE, MonteCarlo,
                    SimulationConfig, heston_surface_mc)
    from .sharding import sharded_surface_fn

    paths_per_dev = 256
    cfg = SimulationConfig(paths_per_dev * n, 6, Antithetic(), 3)
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg, device=str(device))
    expiries = [dt.date(2024, 7, 1), _EXPIRY]
    strikes = torch.tensor([90.0, 100.0, 110.0], dtype=torch.float64, device=device)
    target = torch.full((len(expiries), 3), 8.0, dtype=torch.float64, device=device)
    surf_fn = sharded_surface_fn(method, mesh)

    params = _leaves(device)
    surf = surf_fn(HestonInputs(_REF, _RATE, *params), expiries, strikes)
    loss = torch.sum((surf - target) ** 2)
    grads = torch.autograd.grad(loss, params)
    if not (torch.isfinite(loss) and all(map(torch.isfinite, grads))):
        raise AssertionError(f"sharded surface step: loss {loss}, gradient {grads}")
    out = dict(mesh=f"1x{n}", loss=float(loss.detach()), surface=surf.detach().tolist(),
               grads=[float(x) for x in grads])
    if dist.get_rank() == 0:
        ref_params = _leaves(device)
        local_cfg = dataclasses.replace(cfg, trajectories=paths_per_dev)
        surf_ref = sum(heston_surface_mc(HestonInputs(_REF, _RATE, *ref_params), expiries, strikes,
                                         local_cfg, point_offset=idx * paths_per_dev,
                                         strategy=method.strategy, device_id=idx, device=device)
                       for idx in range(n)) / n
        grads_ref = torch.autograd.grad(torch.sum((surf_ref - target) ** 2), ref_params)
        _check(surf.detach(), surf_ref.detach(), 1e-9, 1e-12,
               "sharded mixing surface against its replay")
        _check(torch.stack(grads), torch.stack(grads_ref), 1e-9, 1e-12,
               "sharded surface gradient against its replay")
        out["line"] = (f"phase 2 (mixing surface grad step): mesh={out['mesh']} "
                       f"loss={out['loss']:.6g} surface and gradient replay match ok")
    return out


def lsm_replay(prob, lsm, n: int, device) -> torch.Tensor:
    """The LSM price of ``n`` ranks' grids (rank g's stream and Sobol'
    slice) concatenated on one device, under ONE global regression: what
    ``sharded_lsm_price_fn`` computes with its sums over ranks."""
    from ..methods.lsm import _flatten_grid, _lsm_setup, device_payoff, lsm_backward_induction
    from ..methods.montecarlo import simulate_price_grid

    cfg = lsm.mc_method.config
    local_cfg = dataclasses.replace(cfg, trajectories=cfg.trajectories // n)
    local_mc = dataclasses.replace(lsm.mc_method, config=local_cfg, device=str(device))
    log_disc, strike_scale = _lsm_setup(prob, dataclasses.replace(lsm, mc_method=local_mc))
    spots = torch.cat([_flatten_grid(simulate_price_grid(
        prob, local_mc, point_offset=idx * local_cfg.trajectories, device_id=idx))
        for idx in range(n)], dim=1)
    tau, value = lsm_backward_induction(spots, device_payoff(prob.payoff, spots.device),
                                        log_disc, lsm.degree, strike_scale)
    return torch.mean(torch.exp(tau * log_disc) * value)


def _phase_lsm(n: int, mesh, device) -> dict:
    from .. import (LSM, American, Antithetic, HestonDynamics, HestonQE, MonteCarlo, Put,
                    SimulationConfig)
    from .sharding import sharded_lsm_price_fn

    cfg = SimulationConfig(256 * n, 6, Antithetic(), 4)
    lsm = LSM(MonteCarlo(HestonDynamics(), HestonQE(), cfg, device=str(device)), degree=3)
    prob = _problem(_PARAMS, style=American(), cp=Put())
    price = sharded_lsm_price_fn(lsm, mesh)(prob)
    out = dict(mesh=f"1x{n}", price=float(price))
    if dist.get_rank() == 0:
        _check(price, lsm_replay(prob, lsm, n, device), 1e-8, 1e-10,
               "sharded LSM price against the global-regression replay")
        out["line"] = (f"phase 3 (sharded LSM American): mesh={out['mesh']} "
                       f"price={out['price']:.6g} global-regression replay match ok")
    return out


def _phase_flagship(n: int, mesh, device) -> dict:
    from .. import (Antithetic, HestonDynamics, HestonExactMixing, MonteCarlo, SimulationConfig,
                    solve)
    from .sharding import make_multislice_mesh, sharded_mc_price, sharded_mc_price_multislice_fn

    cfg = SimulationConfig(256 * n, 2, Antithetic(), 5, qmc=True)
    method = MonteCarlo(HestonDynamics(), HestonExactMixing(), cfg, device=str(device))
    prob = _problem(_PARAMS)
    p4 = sharded_mc_price(prob, method, mesh)
    out = {"phase 4": dict(mesh=f"1x{n}", price=float(p4))}
    p5 = None
    if n % 2 == 0 and n > 1:
        p5 = sharded_mc_price_multislice_fn(method, make_multislice_mesh(2))(prob)
        out["phase 5"] = dict(mesh=f"2x{n // 2}", price=float(p5))
    if dist.get_rank() == 0:
        ref = solve(prob, method).price
        _check(p4, ref, 1e-9, 1e-12, "sharded exact-mixing price against the single-device solve")
        out["phase 4"]["line"] = (f"phase 4 (sharded exact-mixing flagship): mesh=1x{n} "
                                  f"price={float(p4):.6g} single-device solve match ok")
        if p5 is not None:
            _check(p5, ref, 1e-9, 1e-12, "multi-slice price against the single-device solve")
            _check(p5, p4, 1e-9, 1e-12, "multi-slice price against the 1-D sharded price")
            out["phase 5"]["line"] = (
                f"phase 5 (multi-slice two-level reduction): mesh=2x{n // 2} "
                f"price={float(p5):.6g} two-level sum matches single-device solve ok")
    return out


def dryrun_rank(device) -> dict:
    """The five phases of the dry run on this rank of an initialised process
    group (every rank calls it; rank 0 also runs the replays, checks them and
    writes each phase's ``line``).  Returns ``{"phase k": {...}}``."""
    from .sharding import make_paths_mesh, rank_device

    n = dist.get_world_size()
    dev = rank_device(device)
    mesh = make_paths_mesh()
    out = {"phase 1": _phase_euler_step(n, dev), "phase 2": _phase_surface_step(n, mesh, dev),
           "phase 3": _phase_lsm(n, mesh, dev)}
    out.update(_phase_flagship(n, mesh, dev))
    return out


def dryrun_multichip(n: int, device="cuda", timeout: float = 900.0) -> dict:
    """Run :func:`dryrun_rank` on ``n`` spawned ranks (:func:`run_ranks`,
    :func:`default_backend`), print one line a phase, and return rank 0's
    results.  Raises where a phase disagrees with its replay, a rank's
    replicated result differs from rank 0's, or a rank fails."""
    backend = default_backend(n, device)
    ranks = run_ranks(n, dryrun_rank, str(device), backend=backend, timeout=timeout)
    for phase, rec in ranks[0].items():
        for r, other in enumerate(ranks[1:], start=1):
            for key in ("loss", "price"):
                if key in rec and other[phase][key] != rec[key]:
                    raise AssertionError(f"{phase}: rank {r}'s {key} {other[phase][key]} differs "
                                         f"from rank 0's {rec[key]}")
        print(f"dryrun_multichip({n}) {rec['line']} [{backend}, {device}]", flush=True)
    return ranks[0]
