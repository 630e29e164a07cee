#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Heston Monte Carlo main path on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and ``nvcc``; without either it exits nonzero and prints no result.

Phases (any failure exits nonzero before the last line):

1. device: the card's name and power limit, then the build of the hand-written
   CUDA kernels from ``hedgehog_tpu_torch/csrc`` (timed);
2. each kernel against its plain PyTorch twin on the card, on identical
   Sobol' or Philox bits, with the tolerance and its reason printed, and each
   kernel's time beside its twin's (CUDA events);
3. the main path through ``solve`` on ``device="cuda"``: exact-transition
   mixing (QMC and PRNG) and full-truncation Euler, each against the port's
   Carr-Madan price within 4 standard errors plus the scheme's bias allowance;
4. the serving dispatch ``heston_exact_mixing_vanilla_price`` at 2^27
   antithetic pairs (268M paths) per call: paths/s and bp error.

The launch counters are reset just before phase 3 and read after phase 4; a
kernel of the path with no launch in that window fails the run.  The
second-to-last line is the ``{"kernels": [...]}`` JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import datetime as dt
import json
import math
import subprocess
import sys
import time

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
R, SPOT, STRIKE = 0.03, 100.0, 100.0
HESTON = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)
SEGMENTS = 2
EULER_STEPS = 100
CHECK_PAIRS = 2**20  # kernel-vs-twin shape: one main-path batch a twin can hold
SERVING_BLOCKS, SERVING_BATCHES = 256, 16  # 256·16·32768 = 2^27 pairs per call
SERVING_REPS = 6
BP_CONTRACT = 5.0

# fp32 kernel vs fp32 twin on the same bits: the card contracts a·b + c into
# FMAs and its expf/logf/sincosf differ from the CPU's by an ulp, so values
# agree to a few fp32 ulps through the chain; a rare path may cross an fp32
# threshold (a Poisson count, the |eta| < 0.5 series switch) and differ more.
VALUES_TOL = dict(rel=1e-4, floor=1e-3, share=0.999)
MEAN_RTOL = 1e-6  # the same ulp-level noise averaged over 2^21 values
PRICE_RTOL = 1e-6  # K3 sums the values K2 returns, in another order
EULER_ALLOWANCE_BP = 10.0  # O(dt) full-truncation bias at 100 steps: a few bp
EXACT_ALLOWANCE_BP = 1.0  # sub-bp scheme bias of 2 exact segments, plus fp32


class PhaseError(RuntimeError):
    pass


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def time_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, bracketed by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


MARKET_ARGS = (math.log(SPOT), HESTON["V0"], R, HESTON["kappa"], HESTON["theta"],
               HESTON["sigma"], HESTON["rho"])


def compare_values(name: str, got, want) -> float:
    """Per-path check of a kernel's values against its twin's; returns the
    largest absolute difference."""
    import torch

    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    diff = (got.double() - want.double()).abs()
    scale = want.double().abs().clamp(min=VALUES_TOL["floor"])
    share = float((diff / scale <= VALUES_TOL["rel"]).double().mean())
    mean_rel = abs(float(got.double().mean() / want.double().mean()) - 1.0)
    max_abs = float(diff.max())
    say(f"  {name}: {share:.6f} of {got.numel()} values within rel {VALUES_TOL['rel']:g} "
        f"(floor {VALUES_TOL['floor']:g}); mean rel diff {mean_rel:.3e}; max abs diff {max_abs:.3e}")
    check(share >= VALUES_TOL["share"], f"{name}: only {share:.6f} of values within tolerance")
    check(mean_rel <= MEAN_RTOL, f"{name}: mean differs by {mean_rel:.3e} > {MEAN_RTOL:g}")
    return max_abs


def phase_kernels(T: float, pairs: int, device: str) -> dict:
    """Each kernel against its plain twin on the card; returns the kernels'
    records (without launch counts).  Values come through the public
    wrappers; times compare the launch with the twin on the same prebuilt
    parameter tensors, so neither includes the host-side parameter set-up."""
    import torch

    from hedgehog_tpu_torch.models.heston_exact import poisson_kmax
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_kernel as hk

    say(f"phase 2: kernels against their plain twins at {pairs} antithetic pairs")
    say(f"  tolerance: >= {VALUES_TOL['share']} of values within rel {VALUES_TOL['rel']:g} and "
        f"means within rel {MEAN_RTOL:g} (fp32 on both sides; FMA contraction and ulp-level "
        "transcendentals on the card, rare fp32 threshold crossings); K3 against the mean of K2 "
        f"over the same points within rel {PRICE_RTOL:g} (another summation order)")
    dev = torch.device(device)
    mkt = MARKET_ARGS
    records = {}

    # K1: Euler terminal prices, PRNG.
    dt_e = T / EULER_STEPS
    pe = torch.as_tensor(hk._euler_params(*mkt, dt_e), device=dev)
    got = hk.heston_euler_terminal(*mkt, dt_e, n_paths=pairs, steps=EULER_STEPS, seed=7,
                                   antithetic=True, device=dev)
    torch.cuda.synchronize()
    want = hk.heston_euler_terminal_plain(pe, pairs, EULER_STEPS, 7, True, 0)
    err = compare_values("K1 heston_euler_terminal (PRNG)", got, want)
    records["heston_euler_terminal"] = dict(
        source="hedgehog_tpu_torch/csrc/heston_euler.cu",
        replaces="hedgehog_tpu/ops/heston_kernel.py:135", max_abs_err=err,
        ms=time_ms(lambda: hk._euler_terminal(pe, pairs, EULER_STEPS, 7, True, 0)),
        plain_ms=time_ms(lambda: hk.heston_euler_terminal_plain(pe, pairs, EULER_STEPS, 7,
                                                                True, 0)))

    # K2 and K3: exact mixing, both streams; K3 covers exactly K2's points.
    dt_x = T / SEGMENTS
    disc = math.exp(-R * T)
    kmax = poisson_kmax(HESTON["kappa"], HESTON["theta"], HESTON["sigma"], dt_x, HESTON["V0"])
    px = torch.as_tensor(ek._exact_params(*mkt, dt_x, SEGMENTS, STRIKE, 1.0), device=dev)
    n_blocks, n_batches = pairs // (4 * ek.PAIRS_PER_BLOCK), 4
    check(n_blocks * n_batches * ek.PAIRS_PER_BLOCK == pairs, "K3 shape must cover the K2 points")
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        table = torch.as_tensor(ek.sobol_table(5, 4 * SEGMENTS), device=dev) if qmc else None
        got = ek.heston_exact_mixing_values(*mkt, dt_x, STRIKE, 1.0, n_paths=pairs,
                                            segments=SEGMENTS, seed=5, antithetic=True,
                                            qmc=qmc, device=dev)
        torch.cuda.synchronize()
        want = ek.heston_exact_mixing_values_plain(px, table, pairs, SEGMENTS, True, kmax, 5, 0, 0)
        err2 = compare_values(f"K2 heston_exact_mixing_values ({stream})", got, want)
        ms2 = time_ms(lambda: ek._exact_values(px, table, pairs, SEGMENTS, True, kmax, 5, 0, 0))
        plain2 = time_ms(lambda: ek.heston_exact_mixing_values_plain(
            px, table, pairs, SEGMENTS, True, kmax, 5, 0, 0))
        say(f"  K2 ({stream}): kernel {ms2:.4f} ms, plain twin {plain2:.4f} ms")

        price = float(ek.heston_exact_mixing_vanilla_price(
            *mkt, dt_x, STRIKE, disc, n_blocks=n_blocks, n_batches=n_batches,
            segments=SEGMENTS, seed=5, qmc=qmc, device=dev))
        mean = disc * float(got.double().mean())
        err3 = abs(price - mean)
        say(f"  K3 heston_exact_mixing_vanilla_price ({stream}): {price:.10f} vs K2 mean "
            f"{mean:.10f}, rel {err3 / abs(mean):.3e}")
        check(math.isfinite(price) and err3 <= PRICE_RTOL * abs(mean),
              f"K3 ({stream}) disagrees with the K2 mean by {err3 / abs(mean):.3e}")
        ms3 = time_ms(lambda: ek._exact_price_sum(px, table, pairs, SEGMENTS, kmax, 5, 0, 0))
        plain3 = time_ms(lambda: ek.heston_exact_mixing_price_sum_plain(
            px, table, pairs, SEGMENTS, kmax, 5, 0, 0))
        say(f"  K3 ({stream}): kernel {ms3:.4f} ms, plain twin {plain3:.4f} ms")
        if not qmc:  # the JSON record carries the serving stream
            records["heston_exact_mixing_values"] = dict(
                source="hedgehog_tpu_torch/csrc/heston_exact.cu",
                replaces="hedgehog_tpu/ops/heston_exact_kernel.py:343",
                max_abs_err=err2, ms=ms2, plain_ms=plain2)
            records["heston_exact_mixing_vanilla_price"] = dict(
                source="hedgehog_tpu_torch/csrc/heston_exact.cu",
                replaces="hedgehog_tpu/ops/heston_exact_kernel.py:442",
                max_abs_err=err3, ms=ms3, plain_ms=plain3)
    for name, rec in records.items():
        say(f"  {name}: kernel {rec['ms']:.4f} ms, plain twin {rec['plain_ms']:.4f} ms")
    return records


def phase_main_path(prob, cm: float, trajectories_exact: int, trajectories_euler: int,
                    device: str) -> None:
    """The main path through solve on the device, against Carr-Madan."""
    import torch

    import hedgehog_tpu_torch as ht

    say(f"phase 3: solve on {device} against Carr-Madan {cm:.10f}")
    runs = [
        (f"HestonExactMixing(use_kernel=True) qmc=True {trajectories_exact} pairs",
         ht.HestonExactMixing(use_kernel=True),
         ht.SimulationConfig(trajectories_exact, SEGMENTS, ht.Antithetic(), 0, True),
         EXACT_ALLOWANCE_BP),
        (f"HestonExactMixing(use_kernel=True) qmc=False {trajectories_exact} pairs",
         ht.HestonExactMixing(use_kernel=True),
         ht.SimulationConfig(trajectories_exact, SEGMENTS, ht.Antithetic(), 0, False),
         EXACT_ALLOWANCE_BP),
        (f"EulerMaruyama(use_kernel=True) {EULER_STEPS} steps {trajectories_euler} pairs",
         ht.EulerMaruyama(use_kernel=True),
         ht.SimulationConfig(trajectories_euler, EULER_STEPS, ht.Antithetic(), 0, False),
         EULER_ALLOWANCE_BP),
    ]
    for label, strat, cfg, allowance_bp in runs:
        method = ht.MonteCarlo(ht.HestonDynamics(), strat, cfg, device=device)
        t0 = time.perf_counter()
        sol = ht.solve(prob, method)
        price = float(sol.price)
        seconds = time.perf_counter() - t0
        ens = sol.ensemble
        check(ens.shape == (2, cfg.trajectories), f"{label}: ensemble shape {tuple(ens.shape)}")
        check(bool(torch.isfinite(ens).all()), f"{label}: non-finite ensemble")
        per_pair = (ht.reduce_payoffs(ens, prob.payoff) if isinstance(strat, ht.EulerMaruyama)
                    else ens.mean(dim=0))
        disc = float(ht.df(prob.market_inputs.rate, prob.payoff.expiry))
        se = disc * float(per_pair.std()) / math.sqrt(cfg.trajectories)
        bound = 4.0 * se + allowance_bp * 1e-4 * cm
        err = price - cm
        say(f"  {label}: price {price:.10f}, err {err:+.3e} ({err / cm * 1e4:+.3f} bp), "
            f"4 SE + {allowance_bp:g} bp = {bound:.3e}, host {seconds:.3f} s")
        check(math.isfinite(price) and abs(err) <= bound, f"{label}: outside the statistical bound")


def phase_serving(T: float, cm: float, n_blocks: int, n_batches: int, device: str) -> dict:
    """The serving dispatch: one warm-up, then timed reps with CUDA events."""
    import torch

    from hedgehog_tpu_torch.ops.heston_exact_kernel import (
        PAIRS_PER_BLOCK,
        heston_exact_mixing_vanilla_price,
    )

    pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    say(f"phase 4: serving dispatch, {pairs} antithetic pairs ({2 * pairs} paths) per call")
    disc = math.exp(-R * T)

    def price(seed):
        return heston_exact_mixing_vanilla_price(
            *MARKET_ARGS, T / SEGMENTS, STRIKE, disc, n_blocks=n_blocks,
            n_batches=n_batches, segments=SEGMENTS, seed=seed, device=device)

    price(0)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    prices = [price(i + 1) for i in range(SERVING_REPS)]
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / SERVING_REPS
    values = [float(p) for p in prices]
    check(all(math.isfinite(v) for v in values), "serving: non-finite price")
    mc = sum(values) / len(values)
    err_bp = abs(mc - cm) / cm * 1e4
    paths_per_s = 2 * pairs / (ms * 1e-3)
    say(f"  {SERVING_REPS} reps: {ms:.3f} ms per call, {paths_per_s:.6e} paths/s, "
        f"price {mc:.10f} vs Carr-Madan {cm:.10f}: {err_bp:.4f} bp (contract < {BP_CONTRACT:g} bp)")
    check(err_bp < BP_CONTRACT, f"serving: {err_bp:.4f} bp is outside the {BP_CONTRACT:g} bp contract")
    return dict(ms=ms, paths_per_s=paths_per_s, err_bp=err_bp, price=mc)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs one CUDA card",
              file=sys.stderr)
        return 2
    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import cuda_lib
    from hedgehog_tpu_torch.ops.heston_exact_kernel import EXACT_PRICE_KERNEL, EXACT_VALUES_KERNEL
    from hedgehog_tpu_torch.ops.heston_kernel import EULER_KERNEL

    say("phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    say(f"  nvidia-smi: {smi[0]}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    lib, build_s = cuda_lib.build_library()
    cuda_lib.load_library()
    say(f"  kernels built in {build_s:.3f} s into {lib.parent}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    T = float(ht.yearfrac(REF, EXPIRY))
    market = ht.HestonInputs(REF, R, SPOT, *HESTON.values())
    payoff = ht.VanillaOption(STRIKE, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    prob = ht.PricingProblem(payoff, market)
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics())).price)

    records = phase_kernels(T, CHECK_PAIRS, "cuda")

    kernels = {"heston_euler_terminal": EULER_KERNEL,
               "heston_exact_mixing_values": EXACT_VALUES_KERNEL,
               "heston_exact_mixing_vanilla_price": EXACT_PRICE_KERNEL}
    for k in kernels.values():
        k.launches = 0
    phase_main_path(prob, cm, 2**22, 2**23, "cuda")
    serving = phase_serving(T, cm, SERVING_BLOCKS, SERVING_BATCHES, "cuda")
    launches = {name: k.launches for name, k in kernels.items()}
    say(f"launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    say(json.dumps({"serving": serving, "build_s": build_s, "nvidia_smi": smi[0]}))
    say(json.dumps({"kernels": [
        dict(name=name, route="cuda", launches=launches[name], **rec)
        for name, rec in records.items()
    ]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
