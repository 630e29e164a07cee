#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Monte Carlo main paths on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and ``nvcc``; without either it exits nonzero and prints no result.

Phases (any failure exits nonzero before the last line):

1. device: the card's name and power limit, then the build of the hand-written
   CUDA kernels from ``hedgehog_tpu_torch/csrc`` (timed; each kernel's ptxas
   registers and spill);
2. each kernel against its plain PyTorch twin on the card, on identical
   Sobol' or Philox bits, with the tolerance and its reason printed, and each
   kernel's time beside its twin's (CUDA events): K1-K3, then the QE mixing
   kernels K7 (values), K8 (price), K10 (price + 7 greeks; its price equal to
   K8's) and K11 (the values VJP), and autograd through K7 -> K11 against
   K10's greeks, then the terminal samplers K5 (QE-M terminal prices), K6
   (QE-M call price, against the mean of K5's payoffs) and K13 (exact
   lognormal draw); then every kernel again at the shape the main path gives
   it (``solve``'s pairs, and the serving grid of 2^27 pairs against the
   chunked summing twins), so the kernels' grid-stride trip counts and
   per-thread sums are checked where they run;
3. the main path through ``solve`` on ``device="cuda"``: exact-transition
   mixing, QE mixing (QMC and PRNG), full-truncation Euler and the QE-M
   terminal sampler (QMC and PRNG), each against the port's Carr-Madan price
   within 4 standard errors plus the scheme's bias allowance; the exact
   lognormal kernel and the all-defaults ``MonteCarlo`` against the
   Black-Scholes formula; the K2 and K7 routes at the Sobol' cells whose
   float32 uniform rounds to 1.0 against the float64 estimators;
   ``torch.autograd.grad`` through the QE mixing ``solve`` against K10's
   greeks;
4. the serving dispatches at 2^27 antithetic pairs (268M paths) per call:
   ``heston_exact_mixing_vanilla_price``, ``heston_qe_mixing_vanilla_price``
   and ``heston_qe_call_price`` (paths/s and bp error), and
   ``heston_qe_mixing_price_and_greeks`` (its time over the price's, the
   greek-vector / price ratio, and its greeks against central Carr-Madan
   differences).

The surface path (bench.py's 3 x 5 surface of calls at 2^26 pairs) has its
own phases: in phase 2 the surface kernels K9 (QE), K12 (QE + Jacobian; its
surface equal to K9's to the bit) and K4 (exact) against their twins at the
full-width grid on both streams, the one-expiry surfaces against K8 and K3,
K9 and K12 at the 3 x 17 calibration shape, and the three at 2^24 pairs of
the serving batches against their chunked twins; phase 3 drives
``heston_surface_mc_adapter`` on the card (QE-32 PRNG through the
differentiable view, QE-32 QMC, exact-4 on both streams) against Carr-Madan
per point, autograd of a least-squares surface loss against K12's jacᵀ·ct,
and a damped Gauss-Newton recovery driven by K12; phase 4 times 6 serving
dispatches of each surface kernel.

The rough-Bergomi path (bench.py's rbergomi_kernel market, 64 steps) has
its own phases too: in phase 2 K14 (values), K15 (serving price), K16
(price + 6 greeks; its price equal to K15's to the bit), K17 (the values
VJP), K18 (its per-step variant under a forward-variance curve; under a
flat curve its bucket vegas sum to K17's xi0 gradient) and K19 (the
17-strike smile) against their twins at 2^20 pairs on both streams,
autograd through K14 -> K17 against K16, K14's to K18's and K4's occupancy,
and K15/K16 and K19 (each strike equal to K15's to the bit) at the serving
2^24 pairs against the chunked twins; phase 3 drives ``solve`` with RoughBergomiMixing(use_kernel=True) at
2^22 pairs against the three checks that stand in for a closed form (eta =
0 against Black-Scholes, put-call parity, the float64 estimator on the
card) and autograd through it against K16, then under a sloped
forward-variance curve (autograd through K18 against the float64
estimator's), the K19 smile (parity, monotone, the float64 estimator's
strike grid) and the float64 ``rbergomi_surface_mc`` against K19 row by
row; phase 4 times 6 serving dispatches of K15, K16 and K19 (the
greek-vector / price and smile / price ratios), K18 beside K17, and holds
K16's spot, xi0 and rate greeks against central differences of K15.

The calibration path (phase 3, its own launch window for K7 and K11) runs
``solve(CalibrationProblem, OptimizerAlgo(), lb=, ub=)`` on the card: (a)
BASELINE.json config 5, 51 Carr-Madan quotes in complex128 and five Heston
parameters by bounded L-BFGS (recovered within rel 1e-1, converged, the
fitted prices within RMSE 1e-6 of the quotes); (b) the Monte Carlo basket of
tests/agreement/test_conditional_mc.py:380-413 through the kernels at 2^22
QMC pairs, 12 steps (each objective one K7 launch per payoff, each gradient
one K11 launch per payoff; V0 and sigma within rel 5e-2 of 0.04 and 0.30);
(c) the same basket through the float64 fast path (one simulation per
objective; its prices against the per-payoff float64 solves on the same
points, its fit against (b)'s); (d) the Black-Scholes goldens with their
delta and vega by ForwardAD, ReverseAD, FiniteDifference and AnalyticGreek,
and ``BatchGreekProblem(ReverseAD)`` of the 7-parameter Heston vector
through the kernels against K10, and the TypeError of forward-mode and
second-order AD through the kernels.  It prints each fit's wall,
iterations, objective evaluations and ms per evaluation, and one
evaluation's wall, device-busy ms and idle share (``torch.profiler``).

The launch counters are reset just before phase 3 and read after phase 4,
once for the main path, once for the surface path and once for the
rough-Bergomi path; a kernel of a path with no launch in its window fails
the run.  Each
kernel's record carries its bound: the least time the card could take for
the operations and bytes of the timed call (see ``work``), and where one
PyTorch call computes the same function (K13: ``Tensor.log_normal_``) that
call's time as ``library_ms``, else null.  The
second-to-last line is the ``{"kernels": [...]}`` JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import datetime as dt
import functools
import inspect
import json
import math
import re
import subprocess
import sys
import time

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
R, SPOT, STRIKE = 0.03, 100.0, 100.0
HESTON = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)
SEGMENTS = 2
EULER_STEPS = 100
CHECK_PAIRS = 2**20  # kernel-vs-twin shape of the timings (twins are slow)
SOLVE_PAIRS = 2**22  # solve's pairs for the mixing kernels, and autograd's
EULER_PAIRS = 2**23  # solve's pairs for the Euler kernel
SERVING_BLOCKS, SERVING_BATCHES = 256, 16  # 256·16·32768 = 2^27 pairs per call
SERVING_CHECK_SEED = 1  # the first timed serving seed
SERVING_REPS = 6
BP_CONTRACT = 5.0

# fp32 kernel vs fp32 twin on the same bits: the card contracts a·b + c into
# FMAs and its expf/logf/sincosf differ from the CPU's by an ulp, so values
# agree to a few fp32 ulps through the chain; a rare path may cross an fp32
# threshold (a Poisson count, the |eta| < 0.5 series switch) and differ more.
VALUES_TOL = dict(rel=1e-4, floor=1e-3, share=0.999)
MEAN_RTOL = 1e-6  # the same ulp-level noise averaged over 2^21 values
# rough Bergomi: the kernel sums a Z row's up to 2n = 128 terms with FMAs in
# its own order, the twin through cuBLAS: Z moves by ~1e-6, e^{eta Z} (eta =
# 1.9) and an out-of-the-money close amplify it to 1e-4 on a share of paths
# (0.84% beyond 1e-4 on the card at 2^17 pairs; at 2^20 pairs 0.999042 of
# the QMC values and 0.999243 of the PRNG values within 1e-3); the means
# within MEAN_RTOL
RB_VALUES_TOL = dict(rel=1e-3, floor=1e-3, share=0.998)
PRICE_RTOL = 1e-6  # K3 sums the values K2 returns, in another order
EULER_ALLOWANCE_BP = 10.0  # O(dt) full-truncation bias at 100 steps: a few bp
EXACT_ALLOWANCE_BP = 1.0  # sub-bp scheme bias of 2 exact segments, plus fp32
QE_STEPS = 11  # the QE mixing serving step count (bench.py MIX_STEPS); odd: the PRNG tail runs
QE_ALLOWANCE_BP = 5.0  # the QE-11 scheme bias, about +3.5 bp (bench.py:40), plus fp32
QEM_STEPS = 10  # the QE-M serving step count (bench.py QE_STEPS)
QEM_ALLOWANCE_BP = 5.0  # the QE-M-10 scheme bias, -3.4 bp on the TPU (bench.py:45), plus fp32
QEM_SOLVE_PAIRS = 2**23  # solve's pairs for the QE-M kernel
TPU_QEM_BIAS = "-3.4 +- 0.1 bp"  # bench.py:45, measured on a TPU
BS_SIGMA = 0.2
GBM_PAIRS = 2**24  # solve's pairs for the lognormal kernel
GBM_ALLOWANCE_BP = 0.1  # no scheme bias; fp32 exp and the float64 reduction
# K10/K11 sums against their twins: fp32 per thread over a few pairs, in
# another order than the twins' float64 sums of fp32 terms; a sum near zero
# is cancellation, so the bound scales with the largest sum
SUM_RTOL = 1e-5
AUTOGRAD_RTOL = 1e-5  # K7 -> K11 against K10: the same fp32 tangents, other sums
# greeks against central Carr-Madan differences: tests/agreement/test_flagship_greeks.py:62-66
FD_CHECKS = (("spot", 0, 0.5, dict(rel=3e-2)), ("sigma", 4, 1e-3, dict(rel=1.5e-1, abs=5e-2)),
             ("rate", 6, 1e-4, dict(rel=1e-2)))
GREEK_ORDER = ("spot", "V0", "kappa", "theta", "sigma", "rho", "rate")

# The surface path: bench.py's surface serving metric (bench.py:596-604;
# benchmarks/surface_kernel_bench.py:15-18), 3 expiries x 5 strikes of calls
SURF_EXPIRIES = (dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2026, 1, 1))
SURF_STRIKES = (85.0, 95.0, 100.0, 105.0, 120.0)
SURF_QE_STEPS = 32  # QE: K9 and K12
SURF_EXACT_STEPS = 4  # exact segments (K4): (2, 1, 2) with the first gap floored at 2
SURF_BLOCKS, SURF_BATCHES = 128, 16  # 128·16·32768 = 2^26 pairs (134M paths) per surface
# the twins at the serving size: 2^26 pairs would cost minutes of twin time,
# so the grid-stride walk is checked at 2^24 pairs (16 rounds of K9's grid)
SURF_FULL_CHECK_BLOCKS = 32  # x SURF_BATCHES x 32768 = 2^24 pairs
# the calibration shape (BASELINE config 5, bench.py:716-731): 3 x 17
CAL_EXPIRY_DAYS = (90, 180, 365)
CAL_STRIKES = tuple(60.0 + 5.0 * k for k in range(17))
# kernel vs twin per point: the same fp32 per-pair values (to FMA contraction
# and transcendental ulps), the kernel's per-warp fp32 sums in float64 rows
# against the twin's float64 sums.  At strikes far from the money the close
# runs in the tails of the fp32 normal CDF (1 - upper), where the card's and
# the host's roundings differ in one direction over many paths: 1.6e-7 at
# the 3 x 5 grid, up to 1.6e-6 at the 3 x 17 grid's 60 and 140 strikes; K12's
# Jacobian columns as K10's sums
SURF_RTOL = 1e-5
SURF_EXACT_ALLOWANCE_BP = 2.0  # sub-bp exact-4 scheme bias (TPU 0.65 bp, bench.py:590) + fp32
SURF_QE_ALLOWANCE_BP = 25.0  # QE-32 scheme bias: the TPU's worst point 19.9 bp (bench.py:592)
SE_SEEDS = 16  # seeds of 2^20 pairs whose spread gives each point's standard error
# Gauss-Newton recovery (examples/kernel_surface_calibration.py:30-83)
GN_TRUE = (0.04, 2.0, 0.045, 0.35, -0.65)  # V0, kappa, theta, sigma, rho
GN_START = (0.06, 1.0, 0.03, 0.5, -0.4)
GN_EXPIRIES = (dt.date(2024, 7, 1), dt.date(2025, 1, 1))
GN_STRIKES = (85.0, 95.0, 100.0, 105.0, 115.0)
GN_STEPS, GN_BLOCKS, GN_BATCHES, GN_ITERS = 16, 64, 4, 12

# The rough-Bergomi path: bench.py's serving metric rbergomi_kernel
# (bench.py:668-713): xi0 0.04, eta 1.9, H 0.08, rho -0.9, a call K = 100
# expiring 2024-12-31, 64 steps, 128 x 64 blocks of 2048 pairs = 2^24 pairs
# The calibration path: solve(CalibrationProblem, OptimizerAlgo()) on the card.
# (a) BASELINE.json config 5 (bench.py:716-774; tests/unit/test_calibration.py:79-113):
# 51 Carr-Madan quotes, five Heston parameters, bounded L-BFGS
CAL_REF = dt.date(2020, 1, 1)
CAL_TRUE = (0.010201, 6.21, 0.019, 0.61, -0.7)  # V0, kappa, theta, sigma, rho
CAL_R = 0.0319
CAL_GUESS = (0.02, 3.0, 0.03, 0.4, -0.3)
CAL_LB, CAL_UB = (1e-5, 1e-3, 1e-5, 1e-3, -0.99), (1.0, 20.0, 1.0, 5.0, 0.99)
CAL_RTOL = 1e-1
CAL_PRICE_RMSE = 1e-6  # the fit's prices against the 51 quotes (prices up to ~40)
# (b), (c) the Monte Carlo basket of tests/agreement/test_conditional_mc.py:380-413
MC_CAL_EXPIRY = dt.date(2021, 1, 1)
MC_CAL_MARKET = (0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)  # r, spot, V0, kappa, theta, sigma, rho
MC_CAL_STRIKES = (85.0, 95.0, 100.0, 105.0, 120.0)
MC_CAL_GUESS = (0.09, 0.6)  # V0, sigma
MC_CAL_LB, MC_CAL_UB = (1e-3, 0.05), (0.5, 1.5)
MC_CAL_STEPS = 12
MC_CAL_RTOL = 5e-2
FAST_PATH_RTOL = 1e-12  # the fast path and the per-payoff solve: the same float64 paths
BS_GOLDENS = (("Call", 90.0, 1.0, 16.6994), ("Put", 90.0, 1.0, 2.3101),
              ("Put", 110.0, dt.date(2024, 4, 1), 9.8237))  # tests/unit/test_black_scholes.py:52-57

RB_MARKET = dict(xi0=0.04, eta=1.9, hurst=0.08, rho=-0.9)
RB_SCALARS = (RB_MARKET["eta"], RB_MARKET["hurst"], RB_MARKET["rho"], R)  # eta, H, rho, r0
RB_EXPIRY = dt.date(2024, 12, 31)
RB_STEPS = 64
RB_BLOCKS, RB_BATCHES = 128, 64
RB_F64_PAIRS = 2**20  # the float64 estimator materialises (2, 128, pairs) doubles: 2 GB
# the kernel route against the float64 estimator on the same QMC points: fp32
# and the approximate ndtri against float64 and the exact one, amplified per
# path by e^{eta Z} (eta 1.9); the means within a tenth of a basis point
RB_F64_TOL = dict(rel=1e-2, floor=1e-3, share=0.999)
RB_F64_MEAN_RTOL = 1e-5
RB_ETA0_ALLOWANCE_BP = 0.1
# the serving greeks against central differences of K15 on the same stream
# (tests/unit/test_rbergomi_kernel.py:194-196)
RB_FD_CHECKS = (("spot", 0.2, 2e-3), ("xi0", 1e-4, 1e-4), ("rate", 1e-4, 1e-3))
TPU_RB_SERVING = "76 ms per 2^24-pair dispatch, 4.4e8 paths/s (SERVING_METRICS.json:77-83, TPU v5e)"
# one pair a thread through rb_walk, before the chunked product of K15/K19
# (PERF.md section 5, chip_smoke.py phase 4 on an H100 80GB HBM3, 700.00 W)
ONE_PAIR_A_THREAD_RB_SERVING = "K15 27.010 ms, K19 (17 strikes) 29.780 ms a 2^24-pair dispatch"
# the (point, Sobol' dim) cells of the float64 estimator's 2^20 QMC points
# (seed 0, 128 dims) whose fp32 uniform rounds to 1.0; before the repair the
# kernels drew 11.46 sigma there (tests/test_torch_rbergomi_kernel.py finds them)
RB_UNIT_CELLS = ((894640, 0), (747354, 60), (410584, 94))
# the Heston (kernel, point, Sobol' dim, draw) cells of seed 0 whose fp32
# uniform rounds to 1.0: the K2 and K7 QMC solve calls' (2^22 points; their
# dims 0 and 4 are K2's u_pois and K7's z) and K2's normal pinned in
# tests/test_torch_heston_draws.py; each held with CELL_WINDOW points around
# it against the float64 estimator (HESTON_PATH_TOL, the tests' PATH_TOL)
HESTON_CELLS = (("K2", 15512210, 1, "normal"), ("K2", 894640, 0, "u_pois"),
                ("K2", 3671734, 4, "u_pois"), ("K7", 894640, 0, "normal"),
                ("K7", 3671734, 4, "normal"))
CELL_WINDOW = 4096
HESTON_PATH_TOL = dict(rel=1e-2, share_rel=1e-3, share=0.999, floor=1e-3)
# the sloped forward-variance curve of the curve route (K18)
RB_CURVE_TENORS, RB_CURVE_LEVELS = (0.25, 0.5, 1.0), (0.035, 0.04, 0.045)
RB_CURVE = (RB_CURVE_TENORS, RB_CURVE_LEVELS)  # xi0's place in rb_vjp_inputs: K18's inputs
# the kernel's curve gradients against the float64 estimator's on the same
# QMC points (tests/test_torch_rbergomi_curve.py CURVE_GRAD_RTOL: 5.9e-7 at
# 65,536 pairs on the CPU), of each gradient plus of the largest
RB_CURVE_GRAD_RTOL = 1e-4
# K18's digests at the chunked product's edges (tests/test_torch_cuda.py):
# one step, the 8-row tiles, the 32-row chunks, 64/65 and the 256-step limit,
# over pairs whose last block holds 5
RB_EDGE_STEPS = (1, 2, 8, 9, 32, 33, 64, 65, 255, 256)
RB_EDGE_PAIRS = 3 * 2**14 + 5
RB_FLAT_RTOL = 1e-5  # K18's n per-step fp32 rows summed against K17's one row
# the rough-Bergomi surface on the 3 x 5 grid: 128 steps over two years
# split (32, 32, 64) over the gaps, so each expiry's grid has K19's step count
# at that expiry (32, 64, 128), uniform to 1% of a step
RB_SURF_STEPS = 128
RB_SURF_PAIRS, RB_SURF_SEEDS = 2**19, 8  # float64 surface: 8 seeds give each point's SE
RB_SURF_SMILE_BLOCKS = 1024  # K19 at each expiry: 1024 x 2048 = 2^21 pairs a seed
RB_ALLOWANCE_PAIRS = 2**12  # the CPU's coupled scheme gaps (rb_surface_allowance)


# Sizes past the port's old limits, which the JAX kernels take: a one-year
# QE price with daily steps under QMC (the kernels once took 128); the exact
# kernels under QMC at 32 segments of a five-year call and a 10 x 20 surface
# of semiannual expiries to five years, 4 segments a gap, 40 in all (once 16;
# at this market's vol-of-vol the exact scheme's Poisson trip count caps a
# segment at about 0.1 years, in the JAX package as here); a five-year QE-32
# calibration surface under QMC (160 steps); rough Bergomi over two years of
# daily steps (512; once 256) and a smile of 81 strikes (once 64).  Each
# kernel runs at full width, and against its twin on WIDE_TWIN_PAIRS pairs.
WIDE_QE_STEPS = 252
WIDE_EXACT_SEGMENTS, WIDE_EXACT_YEARS = 32, 5.0
WIDE_K4 = dict(expiries=10, strikes=20, segments=4, pairs=2**24)
WIDE_SURF_YEARS = 5
WIDE_RB_STEPS = 512
WIDE_RB_PAIRS = 2**22  # K14, K17, K18
WIDE_SMILE_STRIKES = tuple(60.0 + k for k in range(81))
WIDE_TWIN_PAIRS = 2**16
#: past the shared-memory staging limit, where the kernels read the Sobol'
#: table from global memory (their second instantiation, ``<false>``): QE
#: mixing at 1000 QMC steps (K7, K8, K10, K11: a 248 KB table), QE-M at 700
#: (K5: 260 KB), exact at 480 segments (K2, K3: 238 KB) and K4 on two
#: expiries of 240 (K9/K12/K4 stage a table only where a one-strike launch
#: with it fits SURFACE_SMEM_LIMIT), K9 and K12 on the 3 x 5 surface at 600
#: steps; against the twins on GLOBAL_TWIN_PAIRS pairs.  The exact cases run
#: a 20-year call under a vol-of-vol of 0.9: at the serving market's 0.3 a
#: segment that short needs more Poisson trips than the scheme takes
#: (``poisson_kmax``, a refusal the JAX kernels share)
GLOBAL_QE_STEPS, GLOBAL_QEM_STEPS, GLOBAL_EXACT_SEGMENTS = 1000, 700, 480
GLOBAL_EXACT_YEARS, GLOBAL_EXACT_SIGMA = 20.0, 0.9
GLOBAL_SURF_SEG = (200, 200, 200)
GLOBAL_TWIN_PAIRS = 2**14


def chain_tol(tol: dict, steps: int, base_steps: int) -> tuple:
    """(per-path tolerance, mean tolerance) of a kernel against its twin
    over a chain of ``steps`` steps, from the family's ``tol`` and
    ``MEAN_RTOL`` at ``base_steps``: the two differ by fp32 ulps a step (FMA
    contraction, the card's transcendentals), and the differences add up
    along the chain, so the relative limits scale with steps / base_steps;
    the share of paths stays the family's."""
    k = max(1.0, steps / base_steps)
    return dict(tol, rel=tol["rel"] * k), MEAN_RTOL * k


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
PARAMS7 = (SPOT, HESTON["V0"], HESTON["kappa"], HESTON["theta"], HESTON["sigma"], HESTON["rho"], R)


def compare_values(name: str, got, want, tol=None, mean_rtol: float = MEAN_RTOL) -> float:
    """Per-path check of a kernel's values against its twin's (``tol``:
    ``VALUES_TOL`` unless given), the means within ``mean_rtol``; returns the
    largest absolute difference."""
    import torch

    tol = tol or VALUES_TOL
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    diff = (got.double() - want.double()).abs()
    scale = want.double().abs().clamp(min=tol["floor"])
    share = float((diff / scale <= tol["rel"]).double().mean())
    mean_rel = abs(float(got.double().mean() / want.double().mean()) - 1.0)
    max_abs = float(diff.max())
    worst = int(diff.argmax())
    index = tuple(int(i) for i in torch.unravel_index(torch.tensor(worst), got.shape))
    say(f"  {name}: {share:.6f} of {got.numel()} values within rel {tol['rel']:g} "
        f"(floor {tol['floor']:g}); mean rel diff {mean_rel:.3e}; max abs diff {max_abs:.3e} "
        f"at index {index} (kernel {float(got.reshape(-1)[worst]):.8g}, twin "
        f"{float(want.reshape(-1)[worst]):.8g})")
    check(share >= tol["share"], f"{name}: only {share:.6f} of values within tolerance")
    check(mean_rel <= mean_rtol, f"{name}: mean differs by {mean_rel:.3e} > {mean_rtol:g}")
    return max_abs


def compare_vectors(name: str, got, want, rtol: float) -> float:
    """Element-wise check of a vector of sums or greeks within
    rtol·max|want| + rtol·|want|; returns the largest absolute difference."""
    import torch

    got, want = (torch.as_tensor(x).detach().double().cpu() for x in (got, want))
    diff = (got - want).abs()
    bound = rtol * float(want.abs().max()) + rtol * want.abs()
    say(f"  {name}: max abs diff {float(diff.max()):.3e}, max diff / bound "
        f"{float((diff / bound).max()):.3f} (rtol {rtol:g} of the largest and of each)")
    check(bool(torch.isfinite(got).all()) and bool((diff <= bound).all()),
          f"{name}: {got.tolist()} against {want.tolist()}")
    return float(diff.max())


# ---- bounds: the least time the card could take for a kernel's work ----------
#
# Operations per unit, counted by hand from csrc/ as (fp32 FLOPs, an FMA as
# two; MUFU operations).  MUFU: rcp.approx (hh::rcp), the ex2 of expf, the
# rsqrt of sqrtf; logf and sincosf are fp32 polynomials.  The streams'
# integer work (Philox, the Sobol' XOR walk) is counted apart (``int_ops``):
# its logic on the integer ALU, its multiplies on the FMA pipe beside the
# fp32 work.  Where a lane takes one of two
# branches, the cheaper side is counted, so the bound is a lower bound on
# what this run's data needs (the QE draw: the exponential branch with
# u <= p; the exact segment: no Poisson trip, the large-argument Bessel
# ratio, the short gamma-quantile series).  The greek kernels count their
# tangents too (K10-K12, K16-K18).  Peaks (NVIDIA H100 SXM data sheet): 67 TFLOP/s fp32, 16 MUFU
# operations per clock per SM on 132 SMs, 3.35 TB/s; the integer ALU 64
# lanes a clock an SM (NVIDIA H100 Tensor Core GPU Architecture white paper).
FP32_PEAK, MEM_PEAK, SMS, MUFU_PER_CLK, INT_PER_CLK = 67e12, 3.35e12, 132, 16, 64
# The streams' integer work, the least each needs: a Philox-4x32-10 block is
# ten rounds of hh::philox4x32, each two 32x32 -> 64-bit products (one
# IMAD.WIDE each, high and low word together, on the FMA pipe: counted as an
# FMA, two FLOPs) and two three-input XORs (one LOP3 each, on the ALU); its
# round keys depend on the seed alone, so a block needs no key additions.  A
# Sobol' integer split at bit 5 is hh::sobol_low's five masked XORs (one
# LOP3 each, the high word XORed in with the first); the masks depend on the
# point alone and the high words are staged once per 32 points, so neither
# is counted.  The 30-bit walk (hh::sobol_bits) is more than the work needs.
PHILOX_ALU, PHILOX_IMAD = 10 * 2, 10 * 2
SOBOL_ALU = 5


def _ops(*terms):
    """Sum of (flops, mufu) terms, each a pair or (count, pair)."""
    f = m = 0.0
    for t in terms:
        k, (a, b) = (t if isinstance(t[1], tuple) else (1, t))
        f, m = f + k * a, m + k * b
    return f, m


RCP, SQRT, EXP = (3, 1), (4, 1), (8, 1)
LOG, SINCOS = (14, 0), (20, 0)
BOX_MULLER = _ops((7, 0), LOG, SQRT, SINCOS)  # two normals
NDTRI = _ops((19, 0), RCP)  # central branch
SOBOL_U = (2, 0)
QE_DRAW = _ops((21, 0), (2, RCP))
MIX_STEP = _ops(QE_DRAW, (8, 0))
QEM_STEP = _ops(QE_DRAW, (24, 0), RCP, LOG, SQRT)
NCDF = _ops((18, 0), RCP, EXP)
CLOSE = _ops((16, 0), EXP, SQRT, RCP, (2, NCDF))
# CLOSE split at the strike: the strike-free part once per path and expiry,
# the rest per strike (hh::close_group, hh::close_value)
CLOSE_GROUP, CLOSE_POINT = _ops((6, 0), EXP, SQRT, RCP), _ops((10, 0), (2, NCDF))
EULER_STEP = _ops((19, 0), SQRT)
GAMMA_QTL = _ops((76, 0), RCP, SQRT)
EXACT_SEG = _ops((54, 0), (2, GAMMA_QTL), (2, EXP), LOG, SQRT, (5, RCP))
# QE tangents: a step's draw coefficients (the exponential branch) and the
# (V, S) or (V, IV) tangents of 4 directions (5 with T); the close's
# partials past the value (the vega's exponential is Phi(cp d1)'s) and per
# direction the dIV, dJ and chain terms
QE_TAN_STEP4, QE_TAN_STEP5, SURF_TAN_STEP = (35, 0), (43, 0), (43, 0)
PARTIALS = (17, 0)


def work(name: str, pairs: int, steps: int, qmc: bool = False, points: int = 1,
         expiries: int = 1):
    """(fp32 FLOPs, MUFU operations, bytes) of one call of kernel ``name``
    on ``pairs`` antithetic pairs and ``steps`` steps (segments for K2/K3;
    for the surfaces K4/K9/K12 the steps or segments of all expiry segments,
    ``expiries`` expiries and ``points`` (expiry, strike) points; for K19
    ``points`` strikes); bytes count each output written once (K11, K17,
    K18: the cotangent read once)."""
    mix_draw = _ops((2, SOBOL_U), NDTRI, (1, 0)) if qmc else _ops((0.5, BOX_MULLER), (2, 0))
    mix = _ops((steps, _ops(mix_draw, (2, MIX_STEP))), (2, CLOSE))
    qem_draw = _ops((3, SOBOL_U), (2, NDTRI), (1, 0)) if qmc else _ops(BOX_MULLER, (2, 0))
    qem = _ops((steps, _ops(qem_draw, (2, QEM_STEP))), (2, EXP))
    exact_draw = _ops((4, SOBOL_U), (2, NDTRI), (2, 0)) if qmc else _ops(BOX_MULLER, (4, 0))
    exact = _ops((steps, _ops(exact_draw, (2, EXACT_SEG))), (2, _ops((3, 0), CLOSE)))
    # the surfaces close each path once per expiry up to the strike
    # (close_group) and each point from there (d1, d2, two normal CDFs, the
    # value; K12 its partials too)
    surf_close = _ops((2 * expiries, CLOSE_GROUP), (points, _ops((2, CLOSE_POINT), (1, 0))))
    surf_qe = _ops((steps, _ops(mix_draw, (2, MIX_STEP))), surf_close)
    surf_jac = _ops(surf_qe, (2 * steps, SURF_TAN_STEP), (2 * points, _ops(PARTIALS, (21, 0))))
    greeks = _ops(mix, (2, 0), (2 * steps, QE_TAN_STEP4), (2, _ops(PARTIALS, (64, 0))))
    vjp = _ops(mix, (2 * steps, QE_TAN_STEP5), (2, _ops(PARTIALS, (90, 0))))
    surf_exact = _ops((steps, _ops(exact_draw, (2, EXACT_SEG))), (2 * expiries, (3, 0)),
                      surf_close)
    # rough Bergomi: the draws of 2n - 1 normals, the product's n(n - 1)
    # nonzero FMAs and n increments, per step and group exp/sqrt (+) or two
    # rcp (mirror) and the left-point sums, two closes; the greek kernels add
    # the second product, the tangent sums and the partials
    rb_draw = (_ops((2 * steps - 1, SOBOL_U), (2 * steps - 1, NDTRI)) if qmc
               else _ops((steps, BOX_MULLER)))
    rb_product = (2 * steps * (steps - 1) + steps, 0)
    rb_step = _ops((11, 0), EXP, SQRT, (2, RCP))
    rb = _ops(rb_draw, rb_product, (steps - 1, rb_step), (2, _ops((4, 0), CLOSE)))
    rb_tan = _ops(rb, rb_product, (steps - 1, (26, 0)), (2, _ops((24, 0), EXP)))
    # K18: K17's work, then the replayed product and steps and one row a step
    rb_curve = _ops(rb_tan, (28, 0), rb_product, (steps - 1, rb_step), (steps, (12, 0)))
    # K19: the primal sums, each group's strike-free close once, then per
    # point and group d1, d2, two normal CDFs and the value
    rb_smile = _ops(rb_draw, rb_product, (steps - 1, rb_step), (2, CLOSE_GROUP),
                    (points, _ops((2, CLOSE_POINT), (1, 0))))
    surfaces = {  # per pair; bytes: one float64 per point and column, written once
        "heston_qe_mixing_surface_price": (surf_qe, 8 * points),
        "heston_exact_mixing_surface_price": (surf_exact, 8 * points),
        "heston_qe_mixing_surface_price_and_jacobian": (surf_jac, 56 * points),
    }
    if name in surfaces:
        (f, m), nbytes = surfaces[name]
        return f * pairs, m * pairs, nbytes
    per_pair, out_bytes = {
        "heston_euler_terminal": (_ops((steps, _ops(BOX_MULLER, (2, EULER_STEP))), (2, EXP)), 8),
        "heston_exact_mixing_values": (exact, 8),
        "heston_exact_mixing_vanilla_price": (_ops(exact, (2, 0)), 0),
        "heston_qe_mixing_values": (mix, 8),
        "heston_qe_mixing_vanilla_price": (_ops(mix, (2, 0)), 0),
        "heston_qe_mixing_price_and_greeks": (greeks, 0),
        "_mixing_values_vjp": (vjp, 8),
        "heston_qe_terminal": (qem, 8),
        "heston_qe_call_price": (_ops(qem, (5, 0)), 0),
        "gbm_exact_terminal": (_ops((0.5, BOX_MULLER), (4, 0), (2, EXP)), 8),
        "rbergomi_mixing_values": (rb, 8),
        "rbergomi_mixing_vanilla_price": (_ops(rb, (2, 0)), 0),
        "rbergomi_mixing_price_and_greeks": (_ops(rb_tan, (12, 0)), 0),
        "_rb_values_vjp": (_ops(rb_tan, (28, 0)), 8),
        "_rb_values_vjp_curve": (rb_curve, 8),
        "rbergomi_mixing_smile_price": (rb_smile, 0),
    }[name]
    return per_pair[0] * pairs, per_pair[1] * pairs, out_bytes * pairs


def int_ops(name: str, pairs: int, steps: int, qmc: bool = False) -> tuple:
    """(ALU operations, IMAD.WIDE) of the stream of one call of kernel
    ``name`` (``work``'s arguments): each pair's Philox blocks (PRNG) or
    Sobol' integers (QMC) times ``PHILOX_ALU`` and ``PHILOX_IMAD`` or
    ``SOBOL_ALU``.  Per pair: Euler one block per two steps; QE mixing
    (K7-K12) one block per two steps or 2 integers a step; QE-M one block or
    3 integers a step; exact (K2-K4) one block or 4 integers a segment; the
    lognormal draw a block per four pairs; rough Bergomi a block per four of
    its 2n - 1 normals or an integer each."""
    if name.startswith(("rbergomi", "_rb")):
        blocks, ints = -(-(2 * steps - 1) // 4), 2 * steps - 1
    elif name.startswith("heston_exact"):
        blocks, ints = steps, 4 * steps
    elif name in ("heston_qe_terminal", "heston_qe_call_price"):
        blocks, ints = steps, 3 * steps
    elif name == "gbm_exact_terminal":
        blocks, ints = 0.25, 0
    else:  # Euler, and the QE mixing kernels and surfaces
        blocks, ints = -(-steps // 2), 2 * steps
    if qmc:
        return pairs * ints * SOBOL_ALU, 0.0
    return pairs * blocks * PHILOX_ALU, pairs * blocks * PHILOX_IMAD


def bound(name: str, pairs: int, steps: int, sm_clock_hz: float, qmc: bool = False,
          points: int = 1, expiries: int = 1) -> dict:
    """The bound of one call: the largest of fp32 FLOPs (with the stream's
    IMAD.WIDE, two each) over the fp32 peak, MUFU operations over the MUFU
    rate at ``sm_clock_hz``, the stream's ALU operations (``int_ops``) over
    the ALU rate and bytes over the memory rate; ``bound_by`` names the
    largest (fp32, MUFU and integer all count as operations).
    ``bound_fp_ms`` is the bound without the stream's integer work (the
    figure before it was counted)."""
    flops, mufu, nbytes = work(name, pairs, steps, qmc, points, expiries)
    alu, imad = int_ops(name, pairs, steps, qmc)
    t_mufu = mufu / (MUFU_PER_CLK * SMS * sm_clock_hz)
    t_fp = max(flops / FP32_PEAK, t_mufu)
    t_ops = max((flops + 2 * imad) / FP32_PEAK, t_mufu, alu / (INT_PER_CLK * SMS * sm_clock_hz))
    t_bytes = nbytes / MEM_PEAK
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_fp_ms=1e3 * max(t_fp, t_bytes), flops=flops, mufu=mufu, alu=alu,
                imad=imad, bytes=nbytes)


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


def phase_qe_kernels(T: float, pairs: int, device: str) -> dict:
    """The QE mixing kernels against their plain twins on the card, both
    streams, and autograd through K7 -> K11 against K10 (PRNG); returns the
    kernels' records (serving stream, without launch counts)."""
    import torch

    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    say(f"phase 2 (QE mixing): kernels against their plain twins at {pairs} antithetic pairs, "
        f"{QE_STEPS} steps")
    say(f"  tolerance: K7 per path as K1-K3; K8 against the mean of K7 over the same points "
        f"within rel {PRICE_RTOL:g}; K10's price equal to K8's (same stream, grid and "
        f"reduction); K10 and K11 sums against their twins within {SUM_RTOL:g} of the largest "
        f"sum plus {SUM_RTOL:g} of each (fp32 per-thread sums in another order); autograd "
        f"through K7 -> K11 against K10's greeks within {AUTOGRAD_RTOL:g} likewise")
    dev = torch.device(device)
    dt_q = T / QE_STEPS
    disc = math.exp(-R * T)
    args = (*MARKET_ARGS, dt_q, STRIKE, 1.0)
    n_blocks, n_batches = pairs // (4 * qk.PAIRS_PER_BLOCK), 4
    check(n_blocks * n_batches * qk.PAIRS_PER_BLOCK == pairs, "K8 shape must cover the K7 points")
    price_kw = dict(n_blocks=n_blocks, n_batches=n_batches, steps=QE_STEPS, seed=5, device=dev)
    tables = {n: torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                                 HESTON["sigma"], dt_q, QE_STEPS, n), device=dev)
              for n in (4, 5)}
    ct = (0.5 + 0.5 * torch.sin(torch.arange(2 * pairs, device=dev, dtype=torch.float32))).reshape(
        2, pairs)
    records = {}
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        params, table = qk.mix_inputs(*args, QE_STEPS, 5, qmc, dev)
        run = (params, table)

        got = qk.heston_qe_mixing_values(*args, n_paths=pairs, steps=QE_STEPS, seed=5,
                                         antithetic=True, qmc=qmc, device=dev)
        torch.cuda.synchronize()
        want = qk.heston_qe_mixing_values_plain(*run, pairs, QE_STEPS, True, 5, 0, 0)
        err7 = compare_values(f"K7 heston_qe_mixing_values ({stream})", got, want)
        ms7 = time_ms(lambda: qk._qe_values(*run, pairs, QE_STEPS, True, 5, 0, 0))
        plain7 = time_ms(lambda: qk.heston_qe_mixing_values_plain(*run, pairs, QE_STEPS, True, 5,
                                                                  0, 0))

        price = float(qk.heston_qe_mixing_vanilla_price(*MARKET_ARGS, dt_q, STRIKE, disc,
                                                        qmc=qmc, **price_kw))
        mean = disc * float(got.double().mean())
        err8 = abs(price - mean)
        say(f"  K8 heston_qe_mixing_vanilla_price ({stream}): {price:.10f} vs K7 mean "
            f"{mean:.10f}, rel {err8 / abs(mean):.3e}")
        check(math.isfinite(price) and err8 <= PRICE_RTOL * abs(mean),
              f"K8 ({stream}) disagrees with the K7 mean by {err8 / abs(mean):.3e}")
        ms8 = time_ms(lambda: qk._qe_price_sum(*run, pairs, QE_STEPS, 5, 0, 0))
        plain8 = time_ms(lambda: qk.heston_qe_mixing_price_sum_plain(*run, pairs, QE_STEPS, 5, 0,
                                                                     0))

        g_price, greeks = gk.heston_qe_mixing_price_and_greeks(*MARKET_ARGS, dt_q, STRIKE, disc,
                                                               qmc=qmc, **price_kw)
        say(f"  K10 price {float(g_price)!r} vs K8 price {price!r}: "
            f"{'bit-identical' if float(g_price) == price else 'DIFFERENT'}")
        check(float(g_price) == price, f"K10 ({stream}) price differs from K8's")
        sums = gk._greek_sums(params, tables[4], table, pairs, QE_STEPS, 5, 0, 0)
        want10 = gk.heston_qe_mixing_greek_sums_plain(params, tables[4], table, pairs, QE_STEPS,
                                                      5, 0, 0)
        compare_vectors(f"K10 sums against the twin ({stream})", sums, want10, SUM_RTOL)
        twin_greeks = gk._assemble_grad7(want10 / (2 * pairs), MARKET_ARGS[0], R, T, disc,
                                         disc * want10[0] / (2 * pairs))
        err10 = float((greeks.cpu() - twin_greeks.cpu()).abs().max())
        say(f"  K10 greeks {[round(float(g), 8) for g in greeks]} (twin max abs diff {err10:.3e})")
        ms10 = time_ms(lambda: gk._greek_sums(params, tables[4], table, pairs, QE_STEPS, 5, 0, 0))
        plain10 = time_ms(lambda: gk.heston_qe_mixing_greek_sums_plain(
            params, tables[4], table, pairs, QE_STEPS, 5, 0, 0), reps=2)

        sums11 = gk._vjp_sums(params, tables[5], table, ct, pairs, QE_STEPS, True, 5, 0, 0)
        want11 = gk.heston_qe_mixing_vjp_sums_plain(params, tables[5], table, ct, pairs, QE_STEPS,
                                                    True, 5, 0, 0)
        compare_vectors(f"K11 sums against the twin ({stream})", sums11, want11, SUM_RTOL)
        err11 = float(((sums11 - want11) / (2 * pairs)).abs().max())
        ms11 = time_ms(lambda: gk._vjp_sums(params, tables[5], table, ct, pairs, QE_STEPS, True,
                                            5, 0, 0))
        plain11 = time_ms(lambda: gk.heston_qe_mixing_vjp_sums_plain(
            params, tables[5], table, ct, pairs, QE_STEPS, True, 5, 0, 0), reps=2)
        for name, ms, plain in (("K7", ms7, plain7), ("K8", ms8, plain8), ("K10", ms10, plain10),
                                ("K11", ms11, plain11)):
            say(f"  {name} ({stream}): kernel {ms:.4f} ms, plain twin {plain:.4f} ms")
        if qmc:
            continue
        # autograd of D·mean(values) through the Function (K7 forward, K11
        # backward) on the PRNG stream, against K10's greeks on the same pairs
        leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in MARKET_ARGS]
        vals = gk.heston_qe_mixing_values_diff(*leaves, dt_q, STRIKE, 1.0, n_paths=pairs,
                                               steps=QE_STEPS, seed=5, antithetic=True, device=dev)
        disc_t = torch.exp(-leaves[2] * T).to(dev)
        g = torch.autograd.grad(disc_t * vals.double().mean(), leaves)
        ad = torch.stack([g[0] / SPOT, g[1], g[3], g[4], g[5], g[6], g[2]])
        compare_vectors("autograd K7 -> K11 against K10 greeks (PRNG)", ad, greeks,
                        AUTOGRAD_RTOL)
        src, src_g = "hedgehog_tpu_torch/csrc/heston_qe.cu", "hedgehog_tpu_torch/csrc/heston_qe_greeks.cu"
        records["heston_qe_mixing_values"] = dict(
            source=src, replaces="hedgehog_tpu/ops/heston_qe_kernel.py:715", max_abs_err=err7,
            ms=ms7, plain_ms=plain7)
        records["heston_qe_mixing_vanilla_price"] = dict(
            source=src, replaces="hedgehog_tpu/ops/heston_qe_kernel.py:880", max_abs_err=err8,
            ms=ms8, plain_ms=plain8)
        records["heston_qe_mixing_price_and_greeks"] = dict(
            source=src_g, replaces="hedgehog_tpu/ops/heston_qe_greeks_kernel.py:407",
            max_abs_err=err10, ms=ms10, plain_ms=plain10)
        records["_mixing_values_vjp"] = dict(
            source=src_g, replaces="hedgehog_tpu/ops/heston_qe_greeks_kernel.py:593",
            max_abs_err=err11, ms=ms11, plain_ms=plain11)
    return records


def lognormal_law(T: float):
    """(mean, std) of log S_T for the bench spot and rate at ``BS_SIGMA``."""
    return math.log(SPOT) + (R - 0.5 * BS_SIGMA**2) * T, BS_SIGMA * math.sqrt(T)


def phase_terminal_kernels(T: float, pairs: int, device: str) -> dict:
    """The terminal samplers against their plain twins on the card: K5 on
    both streams, K6 on exactly K5's PRNG pairs against the discounted mean
    of K5's call payoffs, and K13; returns the kernels' records (serving
    stream, without launch counts)."""
    import torch

    from hedgehog_tpu_torch.ops import gbm_kernel as gbk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    say(f"phase 2 (terminal samplers): kernels against their plain twins at {pairs} antithetic "
        f"pairs; QE-M at {QEM_STEPS} steps")
    say(f"  tolerance: K5 and K13 per path as K1-K3; K6 against the discounted mean of K5's call "
        f"payoffs over the same pairs within rel {PRICE_RTOL:g} (the same fp32 payoffs, summed "
        "in another order)")
    dev = torch.device(device)
    dt_m = T / QEM_STEPS
    disc = math.exp(-R * T)
    records = {}
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        params, table = qk.qem_inputs(*MARKET_ARGS, dt_m, QEM_STEPS, 5, qmc, dev)
        run = (params, table, pairs, QEM_STEPS, True, True, 5, 0, 0)
        got = qk.heston_qe_terminal(*MARKET_ARGS, dt_m, n_paths=pairs, steps=QEM_STEPS, seed=5,
                                    antithetic=True, qmc=qmc, device=dev)
        torch.cuda.synchronize()
        err5 = compare_values(f"K5 heston_qe_terminal ({stream})", got,
                              qk.heston_qe_terminal_plain(*run))
        ms5 = time_ms(lambda: qk._qem_terminal(*run))
        plain5 = time_ms(lambda: qk.heston_qe_terminal_plain(*run))
        say(f"  K5 ({stream}): kernel {ms5:.4f} ms, plain twin {plain5:.4f} ms")
    records["heston_qe_terminal"] = dict(
        source="hedgehog_tpu_torch/csrc/heston_qe_terminal.cu",
        replaces="hedgehog_tpu/ops/heston_qe_kernel.py:306", max_abs_err=err5, ms=ms5,
        plain_ms=plain5)

    n_blocks, n_batches = pairs // (4 * qk.PAIRS_PER_BLOCK), 4
    check(n_blocks * n_batches * qk.PAIRS_PER_BLOCK == pairs, "K6 shape must cover the K5 pairs")
    price = float(qk.heston_qe_call_price(*MARKET_ARGS, dt_m, STRIKE, disc, n_blocks=n_blocks,
                                          n_batches=n_batches, steps=QEM_STEPS, seed=5,
                                          device=dev))
    mean = disc * float(torch.clamp(got - STRIKE, min=0.0).double().sum()) / (2 * pairs)
    err6 = abs(price - mean)
    say(f"  K6 heston_qe_call_price (PRNG): {price:.10f} vs K5 payoff mean {mean:.10f}, "
        f"rel {err6 / mean:.3e}")
    check(math.isfinite(price) and err6 <= PRICE_RTOL * mean,
          f"K6 disagrees with the K5 payoff mean by {err6 / mean:.3e}")
    p15 = torch.as_tensor(qk._qem_params(*MARKET_ARGS, dt_m, strike=STRIKE), device=dev)
    ms6 = time_ms(lambda: qk._qem_price_sum(p15, pairs, QEM_STEPS, 5, 0))
    plain6 = time_ms(lambda: qk.heston_qe_call_price_sum_plain(p15, pairs, QEM_STEPS, 5, 0))
    say(f"  K6 (PRNG): kernel {ms6:.4f} ms, plain twin {plain6:.4f} ms")
    records["heston_qe_call_price"] = dict(
        source="hedgehog_tpu_torch/csrc/heston_qe_terminal.cu",
        replaces="hedgehog_tpu/ops/heston_qe_kernel.py:480", max_abs_err=err6, ms=ms6,
        plain_ms=plain6)

    mean_g, std_g = lognormal_law(T)
    pg = torch.tensor([mean_g, std_g], dtype=torch.float32, device=dev)
    got = gbk.gbm_exact_terminal(mean_g, std_g, n_paths=pairs, seed=7, antithetic=True,
                                 device=dev)
    torch.cuda.synchronize()
    err13 = compare_values("K13 gbm_exact_terminal (PRNG)", got,
                           gbk.gbm_exact_terminal_plain(pg, pairs, True, 7, 0))
    # timed at solve's pairs (phase_terminal_shapes): at this size a call
    # is a few microseconds of card time under the host's launch path
    records["gbm_exact_terminal"] = dict(
        source="hedgehog_tpu_torch/csrc/gbm.cu", replaces="hedgehog_tpu/ops/gbm_kernel.py:39",
        max_abs_err=err13)
    return records


def phase_terminal_shapes(T: float, solve_pairs: int, gbm_pairs: int, n_blocks: int,
                          n_batches: int, device: str):
    """The terminal samplers against their twins at the main path's shapes:
    K5 at solve's pairs on both streams and K13 at solve's pairs (seed 0, as
    ``solve`` draws them; timed there), K6 at the serving grid on the
    serving PRNG stream against its chunked summing twin.  Returns each
    kernel's largest absolute difference (K6: of the price) and K13's
    times."""
    import torch

    from hedgehog_tpu_torch.ops import gbm_kernel as gbk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    serve_pairs = n_blocks * n_batches * qk.PAIRS_PER_BLOCK
    seed = SERVING_CHECK_SEED
    say(f"phase 2 (terminal samplers at the main-path shapes): K5 at {solve_pairs} pairs x "
        f"{QEM_STEPS} steps; K13 at {gbm_pairs} pairs; K6 at {n_blocks} x {n_batches} blocks "
        f"({serve_pairs} pairs, PRNG seed {seed}) against the chunked twin")
    t0 = time.perf_counter()
    dev = torch.device(device)
    dt_m = T / QEM_STEPS
    errs, e5 = {}, []
    for qmc in (True, False):
        params, table = qk.qem_inputs(*MARKET_ARGS, dt_m, QEM_STEPS, 0, qmc, dev)
        got = qk.heston_qe_terminal(*MARKET_ARGS, dt_m, n_paths=solve_pairs, steps=QEM_STEPS,
                                    seed=0, antithetic=True, qmc=qmc, device=dev)
        want = qk.heston_qe_terminal_plain(params, table, solve_pairs, QEM_STEPS, True, True, 0,
                                           0, 0)
        e5.append(compare_values(f"K5 ({'QMC' if qmc else 'PRNG'}, {solve_pairs} pairs)", got,
                                 want))
    errs["heston_qe_terminal"] = max(e5)

    mean_g, std_g = lognormal_law(T)
    pg = torch.tensor([mean_g, std_g], dtype=torch.float32, device=dev)
    got = gbk.gbm_exact_terminal(mean_g, std_g, n_paths=gbm_pairs, seed=0, antithetic=True,
                                 device=dev)
    errs["gbm_exact_terminal"] = compare_values(
        f"K13 (PRNG, {gbm_pairs} pairs)", got,
        gbk.gbm_exact_terminal_plain(pg, gbm_pairs, True, 0, 0))
    ms13 = time_ms(lambda: gbk._gbm_terminal(pg, gbm_pairs, True, 0, 0))
    plain13 = time_ms(lambda: gbk.gbm_exact_terminal_plain(pg, gbm_pairs, True, 0, 0))
    # the library's one call for the same law: exp(N(mean, std)) into the same
    # (2, pairs) fp32 output, on its own Philox stream (the port never calls it)
    lib13 = time_ms(lambda: torch.empty(2, gbm_pairs, device=dev).log_normal_(mean_g, std_g))
    say(f"  K13 (PRNG, {gbm_pairs} pairs): kernel {ms13:.4f} ms, plain twin {plain13:.4f} ms, "
        f"library log_normal_ {lib13:.4f} ms")

    p15 = torch.as_tensor(qk._qem_params(*MARKET_ARGS, dt_m, strike=STRIKE), device=dev)
    got = float(qk._qem_price_sum(p15, serve_pairs, QEM_STEPS, seed, 0))
    want = float(qk.heston_qe_call_price_sum_plain(p15, serve_pairs, QEM_STEPS, seed, 0))
    rel = abs(got - want) / abs(want)
    say(f"  K6 sum ({serve_pairs} pairs): {got!r} vs twin {want!r}, rel {rel:.3e} "
        f"(limit {PRICE_RTOL:g})")
    check(math.isfinite(got) and rel <= PRICE_RTOL, f"K6 sum differs from its twin by {rel:.3e}")
    errs["heston_qe_call_price"] = math.exp(-R * T) * abs(got - want) / (2 * serve_pairs)
    say(f"  phase took {time.perf_counter() - t0:.1f} s")
    return errs, dict(ms=ms13, plain_ms=plain13, library_ms=lib13)


def phase_main_shapes(T: float, solve_pairs: int, euler_pairs: int, n_blocks: int,
                      n_batches: int, device: str) -> dict:
    """Each kernel against its plain twin at the shape the main path gives
    it, with the tolerances of the checks above: K1 at solve's Euler pairs;
    K2, K7 and K11 at solve's (and autograd's) pairs on both streams, seed 0
    as ``solve`` draws them; the serving kernels K3, K8 and K10 at
    n_blocks x n_batches blocks on the serving PRNG stream against their
    chunked summing twins.  Returns each kernel's largest absolute
    difference (values; or price, greeks and gradient means)."""
    import torch

    from hedgehog_tpu_torch.models.heston_exact import poisson_kmax
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_kernel as hk
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    serve_pairs = n_blocks * n_batches * qk.PAIRS_PER_BLOCK
    seed = SERVING_CHECK_SEED
    say(f"phase 2 (main-path shapes): K1 at {euler_pairs} pairs x {EULER_STEPS} steps; K2, K7 "
        f"and K11 at {solve_pairs} pairs; K3, K8 and K10 at {n_blocks} x {n_batches} blocks "
        f"({serve_pairs} pairs, PRNG seed {seed}) against the chunked twins")
    t0 = time.perf_counter()
    dev = torch.device(device)
    mkt = MARKET_ARGS
    disc = math.exp(-R * T)
    errs = {}

    def compare_sum(name, got, want) -> float:
        got, want = float(got), float(want)
        rel = abs(got - want) / abs(want)
        say(f"  {name}: {got!r} vs twin {want!r}, rel {rel:.3e} (limit {PRICE_RTOL:g})")
        check(math.isfinite(got) and rel <= PRICE_RTOL, f"{name}: differs from its twin by {rel:.3e}")
        return disc * abs(got - want) / (2 * serve_pairs)

    dt_e = T / EULER_STEPS
    pe = torch.as_tensor(hk._euler_params(*mkt, dt_e), device=dev)
    got = hk.heston_euler_terminal(*mkt, dt_e, n_paths=euler_pairs, steps=EULER_STEPS, seed=0,
                                   antithetic=True, device=dev)
    want = hk.heston_euler_terminal_plain(pe, euler_pairs, EULER_STEPS, 0, True, 0)
    errs["heston_euler_terminal"] = compare_values(f"K1 (PRNG, {euler_pairs} pairs)", got, want)

    dt_x = T / SEGMENTS
    kmax = poisson_kmax(HESTON["kappa"], HESTON["theta"], HESTON["sigma"], dt_x, HESTON["V0"])
    px = torch.as_tensor(ek._exact_params(*mkt, dt_x, SEGMENTS, STRIKE, 1.0), device=dev)
    dt_q = T / QE_STEPS
    args = (*mkt, dt_q, STRIKE, 1.0)
    tab4, tab5 = (torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                                  HESTON["sigma"], dt_q, QE_STEPS, n), device=dev)
                  for n in (4, 5))
    ct = (0.5 + 0.5 * torch.sin(torch.arange(2 * solve_pairs, device=dev, dtype=torch.float32))
          ).reshape(2, solve_pairs)
    e2, e7, e11 = [], [], []
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        table = torch.as_tensor(ek.sobol_table(0, 4 * SEGMENTS), device=dev) if qmc else None
        got = ek.heston_exact_mixing_values(*mkt, dt_x, STRIKE, 1.0, n_paths=solve_pairs,
                                            segments=SEGMENTS, seed=0, antithetic=True, qmc=qmc,
                                            device=dev)
        want = ek.heston_exact_mixing_values_plain(px, table, solve_pairs, SEGMENTS, True, kmax, 0,
                                                   0, 0)
        e2.append(compare_values(f"K2 ({stream}, {solve_pairs} pairs)", got, want))

        params, table = qk.mix_inputs(*args, QE_STEPS, 0, qmc, dev)
        got = qk.heston_qe_mixing_values(*args, n_paths=solve_pairs, steps=QE_STEPS, seed=0,
                                         antithetic=True, qmc=qmc, device=dev)
        want = qk.heston_qe_mixing_values_plain(params, table, solve_pairs, QE_STEPS, True, 0, 0, 0)
        e7.append(compare_values(f"K7 ({stream}, {solve_pairs} pairs)", got, want))
        sums = gk._vjp_sums(params, tab5, table, ct, solve_pairs, QE_STEPS, True, 0, 0, 0)
        want = gk.heston_qe_mixing_vjp_sums_plain(params, tab5, table, ct, solve_pairs, QE_STEPS,
                                                  True, 0, 0, 0)
        compare_vectors(f"K11 sums ({stream}, {solve_pairs} pairs)", sums, want, SUM_RTOL)
        e11.append(float(((sums - want) / (2 * solve_pairs)).abs().max()))
    errs["heston_exact_mixing_values"] = max(e2)
    errs["heston_qe_mixing_values"] = max(e7)
    errs["_mixing_values_vjp"] = max(e11)

    errs["heston_exact_mixing_vanilla_price"] = compare_sum(
        f"K3 sum ({serve_pairs} pairs)",
        ek._exact_price_sum(px, None, serve_pairs, SEGMENTS, kmax, seed, 0, 0),
        ek.heston_exact_mixing_price_sum_plain(px, None, serve_pairs, SEGMENTS, kmax, seed, 0, 0))
    params, _ = qk.mix_inputs(*args, QE_STEPS, seed, False, dev)
    errs["heston_qe_mixing_vanilla_price"] = compare_sum(
        f"K8 sum ({serve_pairs} pairs)",
        qk._qe_price_sum(params, None, serve_pairs, QE_STEPS, seed, 0, 0),
        qk.heston_qe_mixing_price_sum_plain(params, None, serve_pairs, QE_STEPS, seed, 0, 0))
    sums = gk._greek_sums(params, tab4, None, serve_pairs, QE_STEPS, seed, 0, 0)
    want = gk.heston_qe_mixing_greek_sums_plain(params, tab4, None, serve_pairs, QE_STEPS, seed, 0, 0)
    compare_vectors(f"K10 sums ({serve_pairs} pairs)", sums, want, SUM_RTOL)
    n = 2 * serve_pairs
    got, want = (torch.cat([disc * s[:1] / n, gk._assemble_grad7(s / n, mkt[0], R, T, disc,
                                                                 disc * s[0] / n)]).cpu()
                 for s in (sums, want))
    errs["heston_qe_mixing_price_and_greeks"] = float((got - want).abs().max())
    say(f"  price and greeks against the twin's: max abs diff "
        f"{errs['heston_qe_mixing_price_and_greeks']:.3e}; phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return errs


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
    ] + [
        (f"HestonQE(conditional=True, use_kernel=True) qmc={qmc} {QE_STEPS} steps "
         f"{trajectories_exact} pairs",
         ht.HestonQE(use_kernel=True, conditional=True),
         ht.SimulationConfig(trajectories_exact, QE_STEPS, ht.Antithetic(), 0, qmc),
         QE_ALLOWANCE_BP)
        for qmc in (True, False)
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


def phase_heston_cells(prob, device: str) -> dict:
    """The kernel route of ``solve`` (the K2 and K7 adapters) on the card at
    the Sobol' cells whose float32 uniform rounds to 1.0 (HESTON_CELLS:
    those of the QMC ``solve`` calls above, seed 0, and the CPU tests'
    pinned K2 normal), each over the CELL_WINDOW points around it, against
    the float64 estimator on the same points: per path within
    HESTON_PATH_TOL, the cell's path too.  Run outside the main path's
    launch window: these calls are checks, not the path."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.methods import heston_exact_mixing, heston_qe_mixing
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    say(f"phase 3: the Heston kernel routes at the repaired Sobol' cells against the float64 "
        f"estimators ({CELL_WINDOW} points around each, seed 0)")
    routes = {"K2": (SEGMENTS, ht.HestonExactMixing(use_kernel=True),
                     ek.heston_exact_mixing_values_adapter,
                     heston_exact_mixing.heston_exact_mixing_values),
              "K7": (QE_STEPS, ht.HestonQE(use_kernel=True, conditional=True),
                     qk.heston_qe_mixing_values_adapter, heston_qe_mixing.heston_qe_mixing_values)}
    tol = HESTON_PATH_TOL
    out = {}
    for name, point, dim, kind in HESTON_CELLS:
        steps, strat, route, f64 = routes[name]
        base = point - CELL_WINDOW // 2
        cfg = ht.SimulationConfig(CELL_WINDOW, steps, ht.Antithetic(), 0, True)
        got = route(prob, cfg, strat, point_offset=base, device=device).double()
        want = f64(prob, cfg, point_offset=base, device=device).double()
        rel = (got - want).abs() / want.abs().clamp(min=tol["floor"])
        share = float((rel <= tol["share_rel"]).double().mean())
        cell = rel[:, point - base]
        say(f"  {name} point {point} (Sobol' dim {dim}, {kind} at u = 1.0 in fp32): kernel "
            f"{got[:, point - base].tolist()} vs float64 {want[:, point - base].tolist()}, rel "
            f"{[f'{x:.3e}' for x in cell.tolist()]}; window: {share:.6f} within "
            f"{tol['share_rel']:g}, max rel {float(rel.max()):.3e}")
        check(share >= tol["share"] and float(rel.max()) <= tol["rel"],
              f"{name} around point {point}: window off the float64 estimator")
        check(float(cell.max()) <= tol["rel"], f"{name} point {point}: off the float64 estimator")
        out[f"{name} {point}"] = dict(dim=dim, kind=kind, rel=cell.tolist(), window_share=share)
    return out


def check_solve(label: str, sol, ref: float, allowance_bp: float, seconds: float) -> None:
    """A terminal-sampler ``solve``: finite (2, pairs) ensemble on the card,
    price within 4 standard errors of the per-pair payoffs plus
    ``allowance_bp`` of the reference price ``ref``."""
    import torch

    import hedgehog_tpu_torch as ht

    prob, cfg = sol.problem, sol.method.config
    ens = sol.ensemble
    check(ens.shape == (2, cfg.trajectories) and ens.device.type == "cuda",
          f"{label}: ensemble {tuple(ens.shape)} on {ens.device}")
    check(bool(torch.isfinite(ens).all()), f"{label}: non-finite ensemble")
    disc = float(ht.df(prob.market_inputs.rate, prob.payoff.expiry))
    se = disc * float(ht.reduce_payoffs(ens, prob.payoff).std()) / math.sqrt(cfg.trajectories)
    price = float(sol.price)
    bound = 4.0 * se + allowance_bp * 1e-4 * ref
    err = price - ref
    say(f"  {label}: price {price:.10f}, err {err:+.3e} ({err / ref * 1e4:+.4f} bp, SE "
        f"{se / ref * 1e4:.4f} bp), 4 SE + {allowance_bp:g} bp = {bound:.3e}, host {seconds:.3f} s")
    check(math.isfinite(price) and abs(err) <= bound, f"{label}: outside the statistical bound")


def phase_terminal_path(prob, cm: float, bs_prob, bs_price: float, device: str) -> None:
    """The terminal samplers through solve on the device: QE-M (K5, both
    streams) against Carr-Madan, the lognormal kernel (K13) and the
    all-defaults MonteCarlo against the Black-Scholes formula."""
    import hedgehog_tpu_torch as ht

    say(f"phase 3 (terminal samplers): solve on {device}; Carr-Madan {cm:.10f}, Black-Scholes "
        f"{bs_price:.10f}")
    for qmc in (True, False):
        cfg = ht.SimulationConfig(QEM_SOLVE_PAIRS, QEM_STEPS, ht.Antithetic(), 0, qmc)
        method = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(use_kernel=True), cfg,
                               device=device)
        t0 = time.perf_counter()
        sol = ht.solve(prob, method)
        float(sol.price)
        check_solve(f"HestonQE(use_kernel=True) qmc={qmc} {QEM_STEPS} steps {QEM_SOLVE_PAIRS} "
                    "pairs", sol, cm, QEM_ALLOWANCE_BP, time.perf_counter() - t0)
    cfg = ht.SimulationConfig(GBM_PAIRS, 1, ht.Antithetic(), 0)
    runs = [(f"BlackScholesExact(use_kernel=True) {GBM_PAIRS} pairs",
             ht.MonteCarlo(ht.LognormalDynamics(), ht.BlackScholesExact(use_kernel=True), cfg,
                           device=device)),
            (f"MonteCarlo(config=...) with every other default {GBM_PAIRS} pairs",
             ht.MonteCarlo(config=cfg))]
    for label, method in runs:
        t0 = time.perf_counter()
        sol = ht.solve(bs_prob, method)
        float(sol.price)
        check_solve(label, sol, bs_price, GBM_ALLOWANCE_BP, time.perf_counter() - t0)
    default = runs[1][1]
    say(f"  defaults: {type(default.dynamics).__name__}, {default.strategy}, device "
        f"{default.device!r}")
    check((type(default.dynamics), type(default.strategy), default.device)
          == (ht.LognormalDynamics, ht.BlackScholesExact, "cuda"),
          "MonteCarlo's defaults are not (LognormalDynamics, BlackScholesExact) on cuda")


def phase_qe_autograd(prob, pairs: int, device: str) -> None:
    """torch.autograd.grad through the kernel-backed QE mixing solve (K7
    forward, K11 backward) against K10's greeks over the same PRNG pairs."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops.heston_qe_greeks_kernel import heston_qe_mixing_price_and_greeks
    from hedgehog_tpu_torch.ops.heston_qe_kernel import PAIRS_PER_BLOCK

    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in PARAMS7]
    spot, v0, kappa, theta, sigma, rho, r = leaves
    market = ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
    cfg = ht.SimulationConfig(pairs, QE_STEPS, ht.Antithetic(), 0, False)
    method = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(use_kernel=True, conditional=True),
                           cfg, device=device)
    t0 = time.perf_counter()
    sol = ht.solve(ht.PricingProblem(prob.payoff, market), method)
    grads = torch.stack(torch.autograd.grad(sol.price, leaves))
    seconds = time.perf_counter() - t0
    T = float(ht.yearfrac(REF, EXPIRY))
    price, greeks = heston_qe_mixing_price_and_greeks(
        *MARKET_ARGS, T / QE_STEPS, STRIKE, math.exp(-R * T), n_blocks=pairs // (4 * PAIRS_PER_BLOCK),
        n_batches=4, steps=QE_STEPS, seed=0, device=device)
    say(f"  autograd through solve (QE mixing, {pairs} pairs, PRNG): price "
        f"{float(sol.price.detach()):.10f} (K10 {float(price):.10f}), greeks "
        f"{[round(float(g), 8) for g in grads]}, host {seconds:.3f} s")
    compare_vectors("autograd through solve against K10 greeks", grads, greeks, AUTOGRAD_RTOL)


def serving_dispatches(fn):
    """(ms per call, outputs) of ``fn(seed)``: one warm-up on seed 0, then
    ``SERVING_REPS`` back-to-back calls on seeds 1.. between two CUDA
    events."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [fn(i + 1) for i in range(SERVING_REPS)]
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / SERVING_REPS, outs


def phase_serving(T: float, cm: float, n_blocks: int, n_batches: int, device: str) -> dict:
    """The serving dispatch: one warm-up, then timed reps with CUDA events."""
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

    ms, prices = serving_dispatches(price)
    values = [float(p) for p in prices]
    check(all(math.isfinite(v) for v in values), "serving: non-finite price")
    mc = sum(values) / len(values)
    err_bp = abs(mc - cm) / cm * 1e4
    paths_per_s = 2 * pairs / (ms * 1e-3)
    say(f"  {SERVING_REPS} reps: {ms:.3f} ms per call, {paths_per_s:.6e} paths/s, "
        f"price {mc:.10f} vs Carr-Madan {cm:.10f}: {err_bp:.4f} bp (contract < {BP_CONTRACT:g} bp)")
    check(err_bp < BP_CONTRACT, f"serving: {err_bp:.4f} bp is outside the {BP_CONTRACT:g} bp contract")
    return dict(ms=ms, paths_per_s=paths_per_s, err_bp=err_bp, price=mc)


def phase_qe_serving(T: float, cm: float, prob, n_blocks: int, n_batches: int,
                     device: str) -> dict:
    """The QE mixing serving dispatch (K8) and the greek kernel (K10) at the
    same shape: ms, paths/s, bp error, the greek-vector / price time ratio,
    and K10's greeks against central Carr-Madan differences."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops.heston_qe_greeks_kernel import heston_qe_mixing_price_and_greeks
    from hedgehog_tpu_torch.ops.heston_qe_kernel import (
        PAIRS_PER_BLOCK,
        heston_qe_mixing_vanilla_price,
    )

    pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    say(f"phase 4 (QE mixing): serving dispatch, {pairs} antithetic pairs ({2 * pairs} paths), "
        f"{QE_STEPS} steps per call")
    disc = math.exp(-R * T)
    kw = dict(n_blocks=n_blocks, n_batches=n_batches, steps=QE_STEPS, device=device)
    args = (*MARKET_ARGS, T / QE_STEPS, STRIKE, disc)

    ms, prices = serving_dispatches(
        lambda seed: heston_qe_mixing_vanilla_price(*args, seed=seed, **kw))
    g_ms, outs = serving_dispatches(
        lambda seed: heston_qe_mixing_price_and_greeks(*args, seed=seed, **kw))
    values = [float(p) for p in prices]
    check(all(math.isfinite(v) for v in values), "QE serving: non-finite price")
    check([float(p) for p, _ in outs] == values, "QE serving: K10 prices differ from K8's")
    mc = sum(values) / len(values)
    err_bp = (mc - cm) / cm * 1e4
    paths_per_s = 2 * pairs / (ms * 1e-3)
    ratio = g_ms / ms
    say(f"  {SERVING_REPS} reps: {ms:.3f} ms per call, {paths_per_s:.6e} paths/s, price "
        f"{mc:.10f} vs Carr-Madan {cm:.10f}: {err_bp:+.4f} bp (contract < {BP_CONTRACT:g} bp)")
    say(f"  price + 7 greeks: {g_ms:.3f} ms per call; greek-vector / price time ratio "
        f"{ratio:.4f}; K10 prices equal K8's on all {SERVING_REPS} seeds")
    check(abs(err_bp) < BP_CONTRACT, f"QE serving: {err_bp:+.4f} bp is outside the contract")

    greeks = torch.stack([g.cpu() for _, g in outs]).mean(dim=0)
    say(f"  greeks (mean of {SERVING_REPS}): "
        + ", ".join(f"{k} {float(g):.8f}" for k, g in zip(GREEK_ORDER, greeks)))

    def cm_price(i, h):
        p = list(PARAMS7)
        p[i] += h
        spot, v0, kappa, theta, sigma, rho, r = p
        market = ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
        return float(ht.solve(ht.PricingProblem(prob.payoff, market),
                              ht.CarrMadan(1.0, 32.0, ht.HestonDynamics())).price)

    for name, i, h, tol in FD_CHECKS:
        fd = (cm_price(i, h) - cm_price(i, -h)) / (2 * h)
        got = float(greeks[GREEK_ORDER.index(name)])
        ok = abs(got - fd) <= max(tol.get("rel", 0.0) * abs(fd), tol.get("abs", 0.0))
        say(f"  {name}: K10 {got:.8f} vs Carr-Madan central difference (h={h:g}) {fd:.8f} ({tol})")
        check(ok, f"QE serving: {name} greek {got} against the Carr-Madan difference {fd}")
    for name in ("V0", "theta"):
        check(float(greeks[GREEK_ORDER.index(name)]) > 0, f"QE serving: {name} greek not positive")
    return dict(ms=ms, paths_per_s=paths_per_s, err_bp=err_bp, price=mc, greeks_ms=g_ms,
                greek_price_ratio=ratio, greeks=[float(g) for g in greeks])


def phase_qem_serving(T: float, cm: float, n_blocks: int, n_batches: int, device: str) -> dict:
    """The QE-M serving dispatch (K6): ms per call, paths/s, and the bp
    error of the mean price against Carr-Madan with its standard error over
    the timed seeds, beside the TPU's QE-M-10 bias."""
    from hedgehog_tpu_torch.ops.heston_qe_kernel import PAIRS_PER_BLOCK, heston_qe_call_price

    pairs = n_blocks * n_batches * PAIRS_PER_BLOCK
    say(f"phase 4 (QE-M): serving dispatch, {pairs} antithetic pairs ({2 * pairs} paths), "
        f"{QEM_STEPS} steps per call")
    disc = math.exp(-R * T)

    def price(seed):
        return heston_qe_call_price(*MARKET_ARGS, T / QEM_STEPS, STRIKE, disc, n_blocks=n_blocks,
                                    n_batches=n_batches, steps=QEM_STEPS, seed=seed,
                                    device=device)

    ms, prices = serving_dispatches(price)
    values = [float(p) for p in prices]
    check(all(math.isfinite(v) for v in values), "QE-M serving: non-finite price")
    mc = sum(values) / len(values)
    sd = math.sqrt(sum((v - mc) ** 2 for v in values) / (len(values) - 1))
    err_bp, se_bp = (mc - cm) / cm * 1e4, sd / math.sqrt(len(values)) / cm * 1e4
    paths_per_s = 2 * pairs / (ms * 1e-3)
    say(f"  {SERVING_REPS} reps: {ms:.3f} ms per call, {paths_per_s:.6e} paths/s, price "
        f"{mc:.10f} vs Carr-Madan {cm:.10f}: {err_bp:+.4f} +- {se_bp:.4f} bp (contract < "
        f"{BP_CONTRACT:g} bp)")
    say(f"  QE-M-{QEM_STEPS} bias on this card {err_bp:+.4f} +- {se_bp:.4f} bp; on the TPU "
        f"(bench.py:45) {TPU_QEM_BIAS}")
    check(abs(err_bp) < BP_CONTRACT, f"QE-M serving: {err_bp:+.4f} bp is outside the contract")
    return dict(ms=ms, paths_per_s=paths_per_s, err_bp=err_bp, se_bp=se_bp, price=mc,
                prices=values)


def surface_grid():
    """(T_host, discounts, QE steps per segment, exact segments per gap) of
    the full-width surface."""
    from hedgehog_tpu_torch.core.dates import yearfrac
    from hedgehog_tpu_torch.methods.heston_surface import surface_seg_steps

    T_host = [float(yearfrac(REF, e)) for e in SURF_EXPIRIES]
    return (T_host, [math.exp(-R * t) for t in T_host],
            tuple(surface_seg_steps(T_host, SURF_QE_STEPS)[1]),
            tuple(surface_seg_steps(T_host, SURF_EXACT_STEPS, min_first=2)[1]))


def surface_inputs(device):
    """The full-width surface kernels' inputs on ``device``: K9/K12's
    parameter vector and tangent rows, K4's parameter vector and its
    per-gap Poisson trip counts."""
    import torch

    from hedgehog_tpu_torch.models.heston_exact import poisson_kmax
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T_host, _, qe_seg, ex_seg = surface_grid()
    dct, djt = (torch.as_tensor(t, dtype=torch.float32, device=device)
                for t in gk._surface_greek_tables(*MARKET_ARGS[3:6], T_host, qe_seg))
    return dict(
        p9=torch.as_tensor(qk._surf_params(*MARKET_ARGS, T_host, qe_seg, SURF_STRIKES, 1.0),
                           device=device),
        p4=torch.as_tensor(ek._exact_surf_params(*MARKET_ARGS, T_host, ex_seg, SURF_STRIKES, 1.0),
                           device=device),
        dct=dct, djt=djt,
        kmaxes=[poisson_kmax(*MARKET_ARGS[3:6], d, MARKET_ARGS[1])
                for d in qk.segment_dts(T_host, ex_seg)])


def calibration_inputs(device, qmc: bool = False, seed: int = 5) -> dict:
    """The 3 x 17 calibration shape's surface-kernel arguments on ``device``
    before the pairs: ``price`` K9's (params, table, steps, m), ``jac``
    K12's (params, dct, djt, table, steps, m); ``steps`` the QE steps per
    segment."""
    import torch

    from hedgehog_tpu_torch.methods.heston_surface import surface_seg_steps
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    cal_T = [d / 365.0 for d in CAL_EXPIRY_DAYS]
    cal_seg = tuple(surface_seg_steps(cal_T, SURF_QE_STEPS)[1])
    pc = torch.as_tensor(qk._surf_params(*MARKET_ARGS, cal_T, cal_seg, CAL_STRIKES, 1.0),
                         device=device)
    cdct, cdjt = (torch.as_tensor(t, dtype=torch.float32, device=device)
                  for t in gk._surface_greek_tables(*MARKET_ARGS[3:6], cal_T, cal_seg))
    table = (torch.as_tensor(qk.sobol_table(seed, 2 * sum(cal_seg)), device=device) if qmc
             else None)
    m = len(CAL_STRIKES)
    return dict(T=cal_T, steps=cal_seg, price=(pc, table, cal_seg, m),
                jac=(pc, cdct, cdjt, table, cal_seg, m))


def carr_madan_surface(market, expiries, strikes):
    """(n_exp, m) float64 Carr-Madan call prices, one strike-vector solve
    per expiry on the card, brought to the host."""
    import torch

    import hedgehog_tpu_torch as ht

    method = ht.CarrMadan(1.0, "auto", ht.HestonDynamics())
    k = torch.tensor(strikes, dtype=torch.float64)
    return torch.stack([ht.solve(ht.PricingProblem(ht.VanillaOption(k, e, ht.European(), ht.Call(),
                                                                    ht.Spot()), market),
                                 method).price for e in expiries]).cpu()


def compare_points(name: str, got, want, pairs: int, discount: float,
                   rtol: float = SURF_RTOL) -> float:
    """Per-point check of a surface kernel's float64 sums against its
    twin's: the mean values (sums over 2·pairs paths) within ``rtol``
    relative, values below ``VALUES_TOL['floor']`` compared absolutely (a
    deep out-of-the-money point); returns the largest absolute difference
    of the discounted means."""
    import torch

    got, want = (x.double().cpu() / (2 * pairs) for x in (got, want))
    rels = (got - want).abs() / want.abs().clamp(min=VALUES_TOL["floor"])
    rel, worst = float(rels.max()), int(rels.argmax())
    say(f"  {name}: {got.numel()} points, max rel diff {rel:.3e} at point {worst} (mean value "
        f"{float(want[worst]):.6g}; limit {rtol:g}, floor {VALUES_TOL['floor']:g})")
    check(bool(torch.isfinite(got).all()) and rel <= rtol, f"{name}: max rel diff {rel:.3e}")
    return discount * float((got - want).abs().max())


def phase_surface_kernels(pairs: int, device: str) -> dict:
    """The surface kernels against their plain twins on the card at the
    full-width grid (both streams), K12's surface against K9's, the
    one-expiry surfaces against K8 and K3, and K9/K12 at the calibration
    shape; returns the kernels' records (serving stream, without launch
    counts)."""
    import torch

    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T_host, disc, qe_seg, ex_seg = surface_grid()
    m = len(SURF_STRIKES)
    say(f"phase 2 (surfaces): K9, K12 (QE, steps {qe_seg}) and K4 (exact, segments {ex_seg}) "
        f"against their plain twins at {pairs} antithetic pairs x {len(T_host)} expiries x {m} "
        "strikes")
    say(f"  tolerance: each point's mean within rel {SURF_RTOL:g} of the twin's (the same fp32 "
        "per-pair values to FMA and ulp-level transcendentals, summed per warp into float64 "
        f"rows against the twin's float64 sums); K12's columns within {SUM_RTOL:g} of the "
        f"largest plus {SUM_RTOL:g} of each (as K10); K12's surface equal to K9's to the bit; a "
        f"one-expiry one-strike K9 against K8 and K4 against K3 within rel {PRICE_RTOL:g} (the "
        "same per-path values; K8/K3 sum per thread in fp32 over their own grid)")
    dev = torch.device(device)
    kw = dict(n_strikes=m, n_blocks=pairs // qk.PAIRS_PER_BLOCK, n_batches=1, seed=5, device=dev)
    inp = surface_inputs(dev)
    p9, p4, dct, djt, kmaxes = (inp[k] for k in ("p9", "p4", "dct", "djt", "kmaxes"))
    scale = max(disc) / (2 * pairs)
    records = {}
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        t9 = torch.as_tensor(qk.sobol_table(5, 2 * sum(qe_seg)), device=dev) if qmc else None
        t4 = torch.as_tensor(qk.sobol_table(5, 4 * sum(ex_seg)), device=dev) if qmc else None
        run9 = (p9, t9, qe_seg, m, pairs, 5, 0, 0)
        run12 = (p9, dct, djt, t9, qe_seg, m, pairs, 5, 0, 0)
        run4 = (p4, t4, ex_seg, kmaxes, m, pairs, 5, 0, 0)

        s9 = qk.heston_qe_mixing_surface_price(*MARKET_ARGS, T_host, SURF_STRIKES, disc,
                                               seg_steps=qe_seg, qmc=qmc, **kw)
        s12, jac = gk.heston_qe_mixing_surface_price_and_jacobian(
            *MARKET_ARGS, T_host, SURF_STRIKES, disc, seg_steps=qe_seg, qmc=qmc, **kw)
        s4 = ek.heston_exact_mixing_surface_price(*MARKET_ARGS, T_host, SURF_STRIKES, disc,
                                                  seg_steps=ex_seg, qmc=qmc, **kw)
        torch.cuda.synchronize()
        check(tuple(s9.shape) == tuple(s4.shape) == (len(T_host), m) and tuple(jac.shape)
              == (len(T_host), m, 7), "surface shapes")
        say(f"  K12 surface against K9's ({stream}): "
            f"{'bit-identical' if torch.equal(s9, s12) else 'DIFFERENT'}")
        check(torch.equal(s9, s12), f"K12's surface differs from K9's ({stream})")
        err9 = compare_points(f"K9 sums ({stream})", qk._qe_surface_sums(*run9),
                              qk.heston_qe_mixing_surface_sums_plain(*run9), pairs, max(disc))
        sums12, want12 = gk._surface_jac_sums(*run12), gk.heston_qe_mixing_surface_jac_sums_plain(*run12)
        err12 = scale * compare_vectors(f"K12 sums ({stream})", sums12, want12, SUM_RTOL)
        err4 = compare_points(f"K4 sums ({stream})", ek._exact_surface_sums(*run4),
                              ek.heston_exact_mixing_surface_sums_plain(*run4), pairs, max(disc))
        times = {}
        for name, fn, plain in (("K9", qk._qe_surface_sums, qk.heston_qe_mixing_surface_sums_plain),
                                ("K12", gk._surface_jac_sums,
                                 gk.heston_qe_mixing_surface_jac_sums_plain),
                                ("K4", ek._exact_surface_sums,
                                 ek.heston_exact_mixing_surface_sums_plain)):
            run = {"K9": run9, "K12": run12, "K4": run4}[name]
            times[name] = (time_ms(lambda: fn(*run)), time_ms(lambda: plain(*run), reps=2))
            say(f"  {name} ({stream}): kernel {times[name][0]:.4f} ms, plain twin "
                f"{times[name][1]:.4f} ms")

        # one expiry, one strike: K9 against K8, K4 against K3
        T1, D1 = T_host[1], disc[1]
        one = dict(n_blocks=pairs // qk.PAIRS_PER_BLOCK, n_batches=1, seed=5, qmc=qmc, device=dev)
        for name, surf, price in (
                ("K9 against K8", qk.heston_qe_mixing_surface_price(
                    *MARKET_ARGS, [T1], [STRIKE], [D1], seg_steps=(QE_STEPS,), n_strikes=1, **one),
                 qk.heston_qe_mixing_vanilla_price(*MARKET_ARGS, T1 / QE_STEPS, STRIKE, D1,
                                                   steps=QE_STEPS, **one)),
                ("K4 against K3", ek.heston_exact_mixing_surface_price(
                    *MARKET_ARGS, [T1], [STRIKE], [D1], seg_steps=(SEGMENTS,), n_strikes=1, **one),
                 ek.heston_exact_mixing_vanilla_price(*MARKET_ARGS, T1 / SEGMENTS, STRIKE, D1,
                                                      segments=SEGMENTS, **one))):
            a, b = float(surf[0, 0]), float(price)
            rel = abs(a - b) / abs(b)
            say(f"  one-expiry {name} ({stream}): {a!r} vs {b!r}, rel {rel:.3e}"
                f"{' (bit-identical)' if a == b else ''}")
            check(math.isfinite(a) and rel <= PRICE_RTOL, f"one-expiry {name} ({stream}): {rel:.3e}")
        if qmc:
            continue
        src = "hedgehog_tpu_torch/csrc/heston_surface.cu"
        records["heston_qe_mixing_surface_price"] = dict(
            source=src, replaces="hedgehog_tpu/ops/heston_qe_kernel.py:1077", max_abs_err=err9,
            ms=times["K9"][0], plain_ms=times["K9"][1])
        records["heston_exact_mixing_surface_price"] = dict(
            source="hedgehog_tpu_torch/csrc/heston_exact.cu",
            replaces="hedgehog_tpu/ops/heston_exact_kernel.py:717", max_abs_err=err4,
            ms=times["K4"][0], plain_ms=times["K4"][1])
        records["heston_qe_mixing_surface_price_and_jacobian"] = dict(
            source=src, replaces="hedgehog_tpu/ops/heston_qe_greeks_kernel.py:960",
            max_abs_err=err12, ms=times["K12"][0], plain_ms=times["K12"][1])

    # the calibration shape: 3 expiries x 17 strikes (51 points; K12 357 columns)
    cal = calibration_inputs(dev)
    run9, run12 = (*cal["price"], pairs, 5, 0, 0), (*cal["jac"], pairs, 5, 0, 0)
    say(f"  calibration shape {len(cal['T'])} x {len(CAL_STRIKES)}, steps {cal['steps']} (PRNG):")
    cal9 = qk._qe_surface_sums(*run9)
    compare_points("K9 sums (3 x 17)", cal9, qk.heston_qe_mixing_surface_sums_plain(*run9), pairs,
                   max(disc))
    cal12 = gk._surface_jac_sums(*run12)
    compare_vectors("K12 sums (3 x 17)", cal12, gk.heston_qe_mixing_surface_jac_sums_plain(*run12),
                    SUM_RTOL)
    check(torch.equal(cal12.reshape(-1, 7)[:, 0], cal9), "K12's 3 x 17 surface differs from K9's")
    say(f"  K9 {time_ms(lambda: qk._qe_surface_sums(*run9)):.4f} ms, K12 "
        f"{time_ms(lambda: gk._surface_jac_sums(*run12)):.4f} ms at 3 x 17")
    q = calibration_inputs(dev, qmc=True)
    q9 = qk._qe_surface_sums(*q["price"], pairs, 5, 0, 0)
    q12 = gk._surface_jac_sums(*q["jac"], pairs, 5, 0, 0)
    same = torch.equal(q12.reshape(-1, 7)[:, 0], q9)
    say(f"  K12's 3 x 17 surface against K9's (QMC): {'bit-identical' if same else 'DIFFERENT'}")
    check(same, "K12's 3 x 17 surface differs from K9's (QMC)")
    return records


def phase_surface_shapes(device: str) -> dict:
    """K9, K12 and K4 against their chunked twins at the serving grid's
    batches, on the serving PRNG stream: the grid-stride walk where it runs
    (SURF_FULL_CHECK_BLOCKS x SURF_BATCHES blocks).  Returns each kernel's
    largest absolute difference in price units."""
    import torch

    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T_host, disc, qe_seg, ex_seg = surface_grid()
    m = len(SURF_STRIKES)
    pairs = SURF_FULL_CHECK_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK
    seed = SERVING_CHECK_SEED
    say(f"phase 2 (surfaces at the serving batches): K9, K12, K4 at {pairs} pairs (PRNG seed "
        f"{seed}) against the chunked twins")
    t0 = time.perf_counter()
    inp = surface_inputs(torch.device(device))
    p9, p4, dct, djt, kmaxes = (inp[k] for k in ("p9", "p4", "dct", "djt", "kmaxes"))
    scale = max(disc) / (2 * pairs)
    errs = {}
    run = (p9, None, qe_seg, m, pairs, seed, 0, 0)
    t1 = time.perf_counter()
    errs["heston_qe_mixing_surface_price"] = compare_points(
        f"K9 sums ({pairs} pairs)", qk._qe_surface_sums(*run),
        qk.heston_qe_mixing_surface_sums_plain(*run), pairs, max(disc))
    t2 = time.perf_counter()
    run = (p9, dct, djt, None, qe_seg, m, pairs, seed, 0, 0)
    errs["heston_qe_mixing_surface_price_and_jacobian"] = scale * compare_vectors(
        f"K12 sums ({pairs} pairs)", gk._surface_jac_sums(*run),
        gk.heston_qe_mixing_surface_jac_sums_plain(*run), SUM_RTOL)
    t3 = time.perf_counter()
    run = (p4, None, ex_seg, kmaxes, m, pairs, seed, 0, 0)
    errs["heston_exact_mixing_surface_price"] = compare_points(
        f"K4 sums ({pairs} pairs)", ek._exact_surface_sums(*run),
        ek.heston_exact_mixing_surface_sums_plain(*run), pairs, max(disc))
    t4 = time.perf_counter()
    say(f"  twin seconds: K9 {t2 - t1:.1f}, K12 {t3 - t2:.1f}, K4 {t4 - t3:.1f}; phase took "
        f"{t4 - t0:.1f} s")
    return errs


def phase_surface_path(cm_surf, device: str) -> dict:
    """The surface path through ``heston_surface_mc_adapter`` on the card at
    full width (QE-32 PRNG through the differentiable view, QE-32 QMC
    through K9, exact-4 through K4 on both streams), every point against
    Carr-Madan within 4 standard errors plus the scheme's allowance; then
    autograd of a least-squares surface loss through the view against
    jacᵀ·ct from K12.  Returns the per-point bias in bp of each run."""
    import dataclasses

    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    pairs = SURF_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK
    say(f"phase 3 (surfaces): heston_surface_mc_adapter on {device}, {len(SURF_EXPIRIES)} x "
        f"{len(SURF_STRIKES)} calls, {pairs} antithetic pairs, against Carr-Madan per point; "
        f"each point's standard error from the spread of {SE_SEEDS} seeds at 2^20 pairs, "
        "scaled to the run's pairs (QMC: an upper bound)")
    market = ht.HestonInputs(REF, R, SPOT, *HESTON.values())
    runs = [(f"QE-{SURF_QE_STEPS} {'QMC (K9)' if qmc else 'PRNG (differentiable view)'}", None,
             SURF_QE_STEPS, qmc, SURF_QE_ALLOWANCE_BP) for qmc in (False, True)]
    runs += [(f"exact-{SURF_EXACT_STEPS} {'QMC' if qmc else 'PRNG'} (K4)", ht.HestonExactMixing(),
              SURF_EXACT_STEPS, qmc, SURF_EXACT_ALLOWANCE_BP) for qmc in (False, True)]
    biases = {}
    for label, strat, steps, qmc, allowance_bp in runs:
        cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 0, qmc)
        t0 = time.perf_counter()
        surf = qk.heston_surface_mc_adapter(market, SURF_EXPIRIES, SURF_STRIKES, cfg,
                                            strategy=strat, device=device)
        float(surf.sum())
        seconds = time.perf_counter() - t0
        check(tuple(surf.shape) == tuple(cm_surf.shape) and surf.device.type == "cuda"
              and bool(torch.isfinite(surf).all()), f"{label}: surface {tuple(surf.shape)}")
        small = dataclasses.replace(cfg, trajectories=2**20)
        spread = torch.stack([qk.heston_surface_mc_adapter(market, SURF_EXPIRIES, SURF_STRIKES,
                                                           small, seed=100 + s, strategy=strat,
                                                           device=device)
                              for s in range(SE_SEEDS)]).cpu()
        se = spread.std(dim=0) * math.sqrt(2**20 / pairs)
        err = surf.cpu() - cm_surf
        bp = err / cm_surf * 1e4
        limit = 4.0 * se + allowance_bp * 1e-4 * cm_surf
        say(f"  {label}: host {seconds:.3f} s; bias bp per point (rows: expiries, columns: "
            f"strikes {SURF_STRIKES}), then 4 SE + {allowance_bp:g} bp in bp:")
        for i, e in enumerate(SURF_EXPIRIES):
            say(f"    {e}: " + " ".join(f"{float(x):+8.3f}" for x in bp[i])
                + "  | " + " ".join(f"{float(x):7.3f}" for x in (limit / cm_surf * 1e4)[i]))
        check(bool((err.abs() <= limit).all()), f"{label}: a point is outside 4 SE + {allowance_bp} bp")
        biases[label] = [[round(float(x), 4) for x in row] for row in bp]

    # autograd of a least-squares loss through the view (K12 forward) against
    # jacᵀ·ct from a direct K12 call on the same pairs
    T_host, disc, qe_seg, _ = surface_grid()
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in PARAMS7]
    spot, v0, kappa, theta, sigma, rho, r = leaves
    cfg = ht.SimulationConfig(pairs, SURF_QE_STEPS, ht.Antithetic(), 0, False)
    t0 = time.perf_counter()
    surf = qk.heston_surface_mc_adapter(ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho),
                                        SURF_EXPIRIES, SURF_STRIKES, cfg, device=device)
    loss = 0.5 * ((surf - cm_surf.to(surf.device)) ** 2).sum()
    grads = torch.stack(torch.autograd.grad(loss, leaves))
    seconds = time.perf_counter() - t0
    s12, jac = gk.heston_qe_mixing_surface_price_and_jacobian(
        *MARKET_ARGS, T_host, SURF_STRIKES, disc, seg_steps=qe_seg, n_strikes=len(SURF_STRIKES),
        n_blocks=SURF_BLOCKS, n_batches=SURF_BATCHES, seed=0, device=device)
    check(torch.equal(s12, surf.detach()), "the view's surface differs from K12's")
    want = torch.einsum("emp,em->p", jac, s12 - cm_surf.to(s12.device))
    say(f"  autograd of the least-squares loss through the view: {[float(g) for g in grads]} "
        f"(host {seconds:.3f} s)")
    compare_vectors("autograd through the view against jacᵀ·ct (GREEK_ORDER)", grads, want, 1e-6)
    return biases


def phase_surface_calibration(device: str) -> dict:
    """Damped Gauss-Newton recovery of (V0, κ, θ, σ, ρ) from a Carr-Madan
    quote surface with K12's surface and Jacobian per iteration (the
    example's 2 x 5 grid, 16 steps, 64 x 4 blocks, PRNG)."""
    import numpy as np

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.methods.heston_surface import surface_seg_steps
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T_host = [float(ht.yearfrac(REF, e)) for e in GN_EXPIRIES]
    disc = [math.exp(-R * t) for t in T_host]
    seg = tuple(surface_seg_steps(T_host, GN_STEPS)[1])
    quotes = carr_madan_surface(ht.HestonInputs(REF, R, SPOT, *GN_TRUE), GN_EXPIRIES,
                                GN_STRIKES).numpy()
    kw = dict(seg_steps=seg, n_strikes=len(GN_STRIKES), n_blocks=GN_BLOCKS, n_batches=GN_BATCHES,
              seed=0, device=device)
    say(f"phase 3 (calibration): damped Gauss-Newton with K12, {len(T_host)} x {len(GN_STRIKES)} "
        f"quotes from Carr-Madan at {GN_TRUE}, start {GN_START}, steps {seg}, "
        f"{GN_BLOCKS} x {GN_BATCHES} blocks")
    x = np.array(GN_START, dtype=np.float64)
    free, lam, rmses = [1, 2, 3, 4, 5], 1e-4, []
    t0 = time.perf_counter()
    for it in range(GN_ITERS):
        surf, jac = gk.heston_qe_mixing_surface_price_and_jacobian(
            math.log(SPOT), x[0], R, x[1], x[2], x[3], x[4], T_host, GN_STRIKES, disc, **kw)
        r_vec = (surf.cpu().numpy() - quotes).ravel()
        J = jac.cpu().numpy()[:, :, free].reshape(-1, len(free))
        step = np.linalg.solve(J.T @ J + lam * np.eye(len(free)), J.T @ r_vec)
        x = x - step
        x[0], x[2] = max(x[0], 1e-4), max(x[2], 1e-4)
        x[3], x[4] = min(max(x[3], 0.05), 1.5), min(max(x[4], -0.95), 0.0)
        rmses.append(float(np.sqrt(np.mean(r_vec**2))))
        say(f"  iter {it:2d}: rmse {rmses[-1]:.6f}, x {[round(float(v), 5) for v in x]}")
        if rmses[-1] < 5e-3 and np.linalg.norm(step) < 1e-4:
            break
    final = qk.heston_qe_mixing_surface_price(math.log(SPOT), x[0], R, x[1], x[2], x[3], x[4],
                                              T_host, GN_STRIKES, disc, **kw)
    rmse = float(np.sqrt(np.mean((final.cpu().numpy() - quotes) ** 2)))
    seconds = time.perf_counter() - t0
    names = ("V0", "kappa", "theta", "sigma", "rho")
    say(f"  recovered {dict(zip(names, (round(float(v), 5) for v in x)))} (true "
        f"{dict(zip(names, GN_TRUE))}); final rmse {rmse:.6f} against the first {rmses[0]:.6f} "
        f"(limits: 1/10 of the first and 0.02); {len(rmses)} iterations, {seconds:.3f} s")
    check(rmse <= rmses[0] / 10 and rmse <= 0.02, f"Gauss-Newton: final rmse {rmse} (first {rmses[0]})")
    return dict(x=[float(v) for v in x], rmse=rmse, first_rmse=rmses[0], iterations=len(rmses),
                seconds=seconds)


def eval_profile(objective_and_grad, device: str) -> dict:
    """One objective-and-gradient evaluation: its synchronised wall (the
    median of 3), and the busy ms of the device events (kernels and copies)
    that ``torch.profiler`` records for one more, with the idle share
    1 - busy / wall ("not measured" where the profiler records no device
    event).  Busy is the union of the events' intervals, so an overlap
    counts once; their plain sum and the profiled evaluation's own wall are
    kept beside it, and busy never exceeds that wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = device_sync(device)
    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        objective_and_grad()
        sync()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        objective_and_grad()
        sync()
        profiled_wall = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    device_ms = busy_us / 1e3
    check(device_ms <= profiled_wall,
          f"{device_ms} ms of device events in a {profiled_wall} ms evaluation")
    idle = 1.0 - device_ms / wall if device_ms > 0 else "not measured"
    return {"eval wall ms": wall, "eval device ms": device_ms,
            "eval device sum ms": sum(end - start for start, end in spans) / 1e3,
            "eval profiled wall ms": profiled_wall, "idle share": idle}


def device_sync(device: str):
    """A function that waits for ``device``'s queued work (a no-op off the
    card)."""
    import torch

    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


def phase_calibration_path(smi: str, device: str) -> dict:
    """``solve(CalibrationProblem, OptimizerAlgo(), lb=, ub=)`` on the card:
    (a) BASELINE config 5 over Carr-Madan in complex128; (b) the Monte Carlo
    basket through the kernels (each objective one K7 launch per payoff, each
    gradient one K11 launch per payoff); (c) the same basket through the
    float64 fast path (one simulation per objective); (d) the Black-Scholes
    goldens' greeks by AD, FD and closed form, and ``BatchGreekProblem
    (ReverseAD)`` of the 7-parameter Heston vector through the kernels
    against K10."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.calibration.calibration import _apply_lenses, _basket_prices
    from hedgehog_tpu_torch.ops.heston_qe_greeks_kernel import (
        QE_VJP_KERNEL,
        heston_qe_mixing_price_and_greeks,
    )
    from hedgehog_tpu_torch.ops.heston_qe_kernel import PAIRS_PER_BLOCK, QE_VALUES_KERNEL

    say(f"phase 3 (calibration path): solve(CalibrationProblem, OptimizerAlgo()) on {device}; "
        f"{smi}")
    out, sync, dev_type = {}, device_sync(device), torch.device(device).type

    def run(name, calib, lb, ub, max_iters):
        quotes = torch.as_tensor(calib.quotes)

        def objective_and_grad(x):
            prices = _basket_prices(_apply_lenses(calib.pricing_problem, calib.accessors, x),
                                    calib.pricing_method)
            loss = torch.sum((prices - quotes) ** 2)
            return torch.autograd.grad(loss, x)

        guess = torch.tensor(calib.initial_guess, dtype=torch.float64, device=device)
        objective_and_grad(guess.requires_grad_(True))  # warm-up: the host tables and caches
        sync()
        t0 = time.perf_counter()
        res = ht.solve(calib, ht.OptimizerAlgo(max_iters=max_iters), lb=lb, ub=ub)
        sync()
        wall = time.perf_counter() - t0
        u = [float(v) for v in res.u]
        check(res.u.device.type == dev_type and res.loss.device.type == dev_type,
              f"{name}: the L-BFGS state left the card ({res.u.device}, {res.loss.device})")
        rec = {"u": u, "loss": float(res.loss), "converged": bool(res.converged),
               "iterations": int(res.iterations), "evaluations": int(res.evaluations),
               "wall s": wall, "ms per evaluation": 1e3 * wall / max(1, res.evaluations)}
        x = torch.tensor(u, dtype=torch.float64, device=device).requires_grad_(True)
        rec.update(eval_profile(lambda: objective_and_grad(x), device))
        say(f"  ({name}) u {[round(v, 6) for v in u]}, loss {rec['loss']:.3e}, converged "
            f"{rec['converged']}, {rec['iterations']} iterations, {rec['evaluations']} "
            f"evaluations, wall {wall:.3f} s, {rec['ms per evaluation']:.3f} ms per evaluation; "
            f"one evaluation {rec['eval wall ms']:.3f} ms wall, {rec['eval device ms']:.3f} ms "
            f"on the device (events summed {rec['eval device sum ms']:.3f} ms, profiled wall "
            f"{rec['eval profiled wall ms']:.3f} ms), idle share {rec['idle share']}")
        return res, rec

    # (a) BASELINE config 5: 51 Carr-Madan quotes, complex128 on the card
    cm = ht.CarrMadan(1.0, 32.0, ht.HestonDynamics(), device=device)
    expiries = [CAL_REF + dt.timedelta(days=d) for d in CAL_EXPIRY_DAYS]
    payoffs = [ht.VanillaOption(k, e, ht.European(), ht.Call(), ht.Spot())
               for e in expiries for k in CAL_STRIKES]
    true_market = ht.HestonInputs(CAL_REF, CAL_R, SPOT, *CAL_TRUE)
    quote_sols = ht.solve(ht.BasketPricingProblem(payoffs, true_market), cm).solutions
    check(all(sol.price.device.type == dev_type and sol.integral_solution.device.type == dev_type
              and sol.integral_solution.dtype == torch.complex128 for sol in quote_sols),
          "(a): Carr-Madan priced off the card or not in complex128")
    quotes = torch.stack([sol.price for sol in quote_sols])
    lenses = tuple(ht.FieldLens(f"market_inputs.{n}")
                   for n in ("V0", "kappa", "theta", "sigma", "rho"))
    calib = ht.CalibrationProblem(
        ht.BasketPricingProblem(payoffs, ht.HestonInputs(CAL_REF, CAL_R, SPOT, *CAL_GUESS)),
        quotes, CAL_GUESS, cm, lenses)
    res, rec = run("a: Carr-Madan, BASELINE config 5", calib, CAL_LB, CAL_UB, 300)
    fitted = ht.solve(ht.BasketPricingProblem(payoffs, _apply_lenses(
        calib.pricing_problem, lenses, res.u).market_inputs), cm).solutions
    rec["price rmse"] = float(torch.sqrt(torch.mean(
        (torch.stack([s.price for s in fitted]) - quotes) ** 2)))
    say(f"  (a) recovered {[round(v, 6) for v in rec['u']]} against {CAL_TRUE} (rel "
        f"{CAL_RTOL:g}); price rmse {rec['price rmse']:.3e} (limit {CAL_PRICE_RMSE:g})")
    check(rec["price rmse"] <= CAL_PRICE_RMSE,
          f"(a) the fitted prices miss the quotes: rmse {rec['price rmse']}")
    check(rec["converged"] and 0 < rec["iterations"] <= 300, f"(a) did not converge: {rec}")
    check(all(abs(g - w) <= CAL_RTOL * abs(w) for g, w in zip(rec["u"], CAL_TRUE)),
          f"(a) recovered {rec['u']}, not {CAL_TRUE}")
    out["a"] = rec

    # (b) the Monte Carlo basket through K7 (objective) and K11 (gradient)
    r, spot, v0, kappa, theta, sigma, rho = MC_CAL_MARKET
    market = ht.HestonInputs(CAL_REF, r, spot, v0, kappa, theta, sigma, rho)
    mc_payoffs = tuple(ht.VanillaOption(k, MC_CAL_EXPIRY, ht.European(), ht.Call(), ht.Spot())
                       for k in MC_CAL_STRIKES)
    oracle = ht.CarrMadan(1.0, 64.0, ht.HestonDynamics(), nodes=1024, device=device)
    mc_quotes = torch.stack([s.price for s in ht.solve(ht.BasketPricingProblem(mc_payoffs, market),
                                                       oracle).solutions])
    cfg = ht.SimulationConfig(SOLVE_PAIRS, MC_CAL_STEPS, ht.Antithetic(), 0, True)
    guess_market = ht.HestonInputs(CAL_REF, r, spot, MC_CAL_GUESS[0], kappa, theta,
                                   MC_CAL_GUESS[1], rho)
    mc_lenses = (ht.FieldLens("market_inputs.V0"), ht.FieldLens("market_inputs.sigma"))

    def mc_calib(use_kernel):
        method = ht.MonteCarlo(ht.HestonDynamics(),
                               ht.HestonQE(conditional=True, use_kernel=use_kernel), cfg,
                               device=device)
        return ht.CalibrationProblem(ht.BasketPricingProblem(mc_payoffs, guess_market),
                                     mc_quotes, MC_CAL_GUESS, method, mc_lenses)

    want = (v0, sigma)
    for k in (QE_VALUES_KERNEL, QE_VJP_KERNEL):
        k.launches = 0
    res_b, rec_b = run(f"b: kernels K7 + K11, {SOLVE_PAIRS} QMC pairs x {MC_CAL_STEPS} steps",
                       mc_calib(True), MC_CAL_LB, MC_CAL_UB, 200)
    rec_b["launches"] = {"K7": QE_VALUES_KERNEL.launches, "K11": QE_VJP_KERNEL.launches}
    say(f"  (b) launches in the window {rec_b['launches']} ({len(MC_CAL_STRIKES)} payoffs)")
    check(QE_VALUES_KERNEL.launches > 0 and QE_VJP_KERNEL.launches > 0,
          f"(b): K7/K11 not launched in the calibration window: {rec_b['launches']}")
    check(all(abs(g - w) <= MC_CAL_RTOL * w for g, w in zip(rec_b["u"], want)),
          f"(b) recovered {rec_b['u']}, not {want} (rel {MC_CAL_RTOL})")
    out["b"] = rec_b

    # (c) the same basket through the float64 fast path, one simulation per objective
    fast = mc_calib(False)
    x = torch.tensor(rec_b["u"], dtype=torch.float64, device=device)
    basket = _apply_lenses(fast.pricing_problem, mc_lenses, x)
    fast_sol = ht.solve(basket, fast.pricing_method)
    per_payoff = torch.stack([ht.solve(ht.PricingProblem(p, basket.market_inputs),
                                       fast.pricing_method).price for p in mc_payoffs])
    fast_prices = torch.stack([s.price for s in fast_sol.solutions])
    check(fast_sol.solutions[0].ensemble is None, "(c): the basket did not take the fast path")
    compare_vectors("(c) fast-path basket against the per-payoff float64 solves", fast_prices,
                    per_payoff, FAST_PATH_RTOL)
    res_c, rec_c = run(f"c: float64 fast path, {SOLVE_PAIRS} QMC pairs x {MC_CAL_STEPS} steps",
                       fast, MC_CAL_LB, MC_CAL_UB, 200)
    check(all(abs(g - w) <= MC_CAL_RTOL * abs(w) for g, w in zip(rec_c["u"], rec_b["u"])),
          f"(c) fitted {rec_c['u']} against (b)'s {rec_b['u']} (rel {MC_CAL_RTOL})")
    out["c"] = rec_c

    # (d) greeks: the Black-Scholes goldens by AD, FD and closed form on the card
    bs_method = ht.BlackScholesAnalytic(device=device)
    for cp, strike, expiry, golden in BS_GOLDENS:
        expiry = ht.add_yearfrac(REF, expiry) if isinstance(expiry, float) else expiry
        prob = ht.PricingProblem(ht.VanillaOption(strike, expiry, ht.European(), getattr(ht, cp)(),
                                                  ht.Spot()),
                                 ht.BlackScholesInputs(REF, 0.05, 100.0, 0.2))
        price = ht.solve(prob, bs_method).price
        check(price.device.type == dev_type and abs(float(price) - golden) <= 1e-4,
              f"(d) BS {cp} {strike}: {float(price)} on {price.device}, golden {golden}")
        row = []
        for lens in (ht.SpotLens(), ht.VolLens()):
            gp = ht.GreekProblem(prob, lens)
            fwd, rev, fd, an = (float(ht.solve(gp, m, bs_method).greek) for m in (
                ht.ForwardAD(), ht.ReverseAD(), ht.FiniteDifference(1e-4), ht.AnalyticGreek()))
            check(abs(fwd - an) <= 1e-10 * abs(an) and abs(rev - an) <= 1e-10 * abs(an)
                  and abs(fd - an) <= 1e-6 * abs(an),
                  f"(d) BS {cp} {strike} {type(lens).__name__}: AD {fwd}/{rev}, FD {fd}, "
                  f"closed form {an}")
            row.append(an)
        say(f"  (d) BS {cp} K={strike}: price {float(price):.4f} (golden {golden}), delta "
            f"{row[0]:.8f}, vega {row[1]:.8f}: ForwardAD, ReverseAD within 1e-10 and FD within "
            "1e-6 of the closed forms")

    # (d) the 7-parameter Heston vector through the kernels, one backward, against K10
    heston = ht.HestonInputs(REF, R, SPOT, *HESTON.values())
    hprob = ht.PricingProblem(ht.VanillaOption(STRIKE, EXPIRY, ht.European(), ht.Call(), ht.Spot()),
                              heston)
    method = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True, use_kernel=True),
                           ht.SimulationConfig(SOLVE_PAIRS, QE_STEPS, ht.Antithetic(), 0, False),
                           device=device)
    lenses7 = (ht.SpotLens(), *(ht.FieldLens(f"market_inputs.{n}")
                                for n in ("V0", "kappa", "theta", "sigma", "rho")),
               ht.ZeroRateSpineLens(0))
    t0 = time.perf_counter()
    batch = ht.solve(ht.BatchGreekProblem(hprob, lenses7), ht.ReverseAD(), method)
    seconds = time.perf_counter() - t0
    T = float(ht.yearfrac(REF, EXPIRY))
    _, greeks = heston_qe_mixing_price_and_greeks(
        *MARKET_ARGS, T / QE_STEPS, STRIKE, math.exp(-R * T),
        n_blocks=SOLVE_PAIRS // (4 * PAIRS_PER_BLOCK), n_batches=4, steps=QE_STEPS, seed=0,
        device=device)
    got = torch.stack([batch[lens] for lens in lenses7])
    say(f"  (d) BatchGreekProblem(ReverseAD) through K7 -> K11, {SOLVE_PAIRS} PRNG pairs: "
        + ", ".join(f"{k} {float(g):.8f}" for k, g in zip(GREEK_ORDER, got)) + f"; {seconds:.3f} s")
    compare_vectors("(d) BatchGreekProblem(ReverseAD) against K10's greeks", got, greeks,
                    AUTOGRAD_RTOL)
    for gm, gprob in ((ht.ForwardAD(), ht.GreekProblem(hprob, ht.SpotLens())),
                      (ht.ReverseAD(), ht.SecondOrderGreekProblem(hprob))):
        try:
            ht.solve(gprob, gm, method)
        except TypeError as exc:
            check("ReverseAD" in str(exc) and "use_kernel=False" in str(exc), str(exc))
        else:
            check(False, f"(d) {type(gm).__name__} {type(gprob).__name__} through the kernels "
                         "returned a derivative")
    say("  (d) ForwardAD and second-order ReverseAD through use_kernel=True raise TypeError")
    out["launches"] = {"K7": QE_VALUES_KERNEL.launches, "K11": QE_VJP_KERNEL.launches}
    say(f"launches on the calibration path: {out['launches']}")
    check(all(n > 0 for n in out["launches"].values()),
          f"K7/K11 not launched on the calibration path: {out['launches']}")
    return out


def phase_surface_serving(cm_surf, device: str) -> dict:
    """6 timed dispatches each of K9 (QE-32), K4 (exact-4) and K12 at 2^26
    pairs (PRNG): ms per surface, paths/s, point-paths/s, max |bp| of the
    mean surface against Carr-Madan, and the K12/K9 time ratio."""
    import torch

    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T_host, disc, qe_seg, ex_seg = surface_grid()
    pairs = SURF_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK
    points = len(T_host) * len(SURF_STRIKES)
    say(f"phase 4 (surfaces): serving dispatches, {pairs} antithetic pairs ({2 * pairs} paths) x "
        f"{points} points per call")
    kw = dict(n_strikes=len(SURF_STRIKES), n_blocks=SURF_BLOCKS, n_batches=SURF_BATCHES,
              device=device)
    args = (*MARKET_ARGS, T_host, SURF_STRIKES, disc)
    runs = {
        f"K9 QE-{SURF_QE_STEPS}": lambda seed: qk.heston_qe_mixing_surface_price(
            *args, seg_steps=qe_seg, seed=seed, **kw),
        f"K4 exact-{SURF_EXACT_STEPS}": lambda seed: ek.heston_exact_mixing_surface_price(
            *args, seg_steps=ex_seg, seed=seed, **kw),
        f"K12 QE-{SURF_QE_STEPS} + Jacobian": lambda seed: gk.heston_qe_mixing_surface_price_and_jacobian(
            *args, seg_steps=qe_seg, seed=seed, **kw)[0],
    }
    out, surfaces = {}, {}
    for name, fn in runs.items():
        ms, surfs = serving_dispatches(fn)
        mean = torch.stack(surfs).mean(dim=0).cpu()
        check(bool(torch.isfinite(mean).all()), f"{name}: non-finite surface")
        bp = (mean - cm_surf) / cm_surf * 1e4
        paths_per_s = 2 * pairs / (ms * 1e-3)
        t0 = time.perf_counter()  # one more dispatch on the host clock: the idle share
        fn(SERVING_REPS + 1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        say(f"  {name}: {ms:.3f} ms per surface, {paths_per_s:.6e} paths/s, "
            f"{points * paths_per_s:.6e} point-paths/s, max |bp| {float(bp.abs().max()):.4f} "
            f"(mean of {SERVING_REPS} seeds); one synchronised dispatch {wall_ms:.3f} ms of host "
            f"time, idle share {1.0 - ms / wall_ms:.3f}")
        surfaces[name] = surfs
        out[name] = dict(ms=ms, paths_per_s=paths_per_s, point_paths_per_s=points * paths_per_s,
                         max_abs_bp=float(bp.abs().max()), wall_ms=wall_ms)
    k9, k4, k12 = runs
    check(all(torch.equal(a, b) for a, b in zip(surfaces[k9], surfaces[k12])),
          "surface serving: K12's surfaces differ from K9's")
    ratio = out[k12]["ms"] / out[k9]["ms"]
    say(f"  K12 / K9 time ratio {ratio:.4f} (each Gauss-Newton iteration pays it); K12 surfaces "
        f"equal K9's on all {SERVING_REPS} seeds")
    out["jacobian_price_ratio"] = ratio
    return out


def rb_problem(cp: str = "call", eta=None, rho=None):
    """The rough-Bergomi serving problem (bench.py:681-683), optionally at
    another eta or rho (floats or 0-dim tensors)."""
    import hedgehog_tpu_torch as ht

    m = dict(RB_MARKET, **{k: v for k, v in (("eta", eta), ("rho", rho)) if v is not None})
    market = ht.RoughBergomiInputs(REF, R, SPOT, m["xi0"], m["eta"], m["hurst"], m["rho"])
    payoff = ht.VanillaOption(STRIKE, RB_EXPIRY, ht.European(),
                              ht.Call() if cp == "call" else ht.Put(), ht.Spot())
    return ht.PricingProblem(payoff, market)


def rb_config(pairs: int, qmc: bool, seed: int = 0, steps: int = RB_STEPS):
    import hedgehog_tpu_torch as ht

    return ht.SimulationConfig(pairs, steps, ht.Antithetic(), seed, qmc)


def rb_device_inputs(pairs: int, qmc: bool, seed: int, device, tangent: bool, vjp: bool = False,
                     steps: int = RB_STEPS):
    """(host trace, RbInputs on the device) of the serving problem: the price
    trace, or with ``tangent`` the greek trace (dL/dH and the tangent
    parameters; the VJP's Hη and 1/T too when ``vjp``)."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    cfg = rb_config(pairs, qmc, seed, steps)
    trace = (rk._rb_greek_trace_inputs if tangent else rk._rb_trace_inputs)(rb_problem(), cfg, 64)
    return trace, rk.rb_inputs_from_trace(trace, seed=seed, qmc=qmc, device=device,
                                          hurst=RB_MARKET["hurst"] if vjp else None)


def phase_rb_kernels(pairs: int, device: str) -> dict:
    """K14-K19 against their plain twins on the card at ``pairs`` antithetic
    pairs x 64 steps, both streams: K14 per path, K15 against K14's mean,
    K16's price equal to K15's, K16 and K17 sums against their twins,
    autograd through K14 -> K17 against K16's greeks; K18's n + 6 sums under
    the sloped curve against its twin and, under a flat curve, its bucket
    vegas against K17's xi0 gradient; K19's 17 strike sums against its twin,
    its strike 100 equal to K15's.  Returns the kernels' records (PRNG
    stream, without launch counts)."""
    import torch

    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    say(f"phase 2 (rough Bergomi): K14-K17 against their plain twins at {pairs} antithetic pairs "
        f"x {RB_STEPS} steps")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the twins' Volterra product must run in full fp32 (allow_tf32 is set)")
    say("  torch.backends.cuda.matmul.allow_tf32 is False: the twins' torch.matmul runs in full "
        "fp32")
    say(f"  tolerance: K14 per path >= {RB_VALUES_TOL['share']} within rel {RB_VALUES_TOL['rel']:g} "
        f"and the means within rel {MEAN_RTOL:g} (the kernel sums a Z row's terms in its own "
        f"order with FMAs, the twin through cuBLAS; exp(eta Z) and the close amplify the "
        f"difference); K15 against the mean of K14 over the same points within rel {PRICE_RTOL:g}; "
        f"K16's price equal to K15's; K16 and K17 sums within {SUM_RTOL:g} of the largest plus "
        f"{SUM_RTOL:g} of each; autograd K14 -> K17 against K16 within {AUTOGRAD_RTOL:g} likewise")
    dev = torch.device(device)
    n_blocks, n_batches = pairs // rk.PAIRS_PER_BLOCK, 1
    check(n_blocks * n_batches * rk.PAIRS_PER_BLOCK == pairs, "K15 shape must cover the K14 points")
    price_kw = dict(n_blocks=n_blocks, n_batches=n_batches, steps=RB_STEPS, seed=5, device=dev)
    ct = (0.5 + 0.5 * torch.sin(torch.arange(2 * pairs, device=dev, dtype=torch.float32))).reshape(
        2, pairs)
    records = {}
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        ins, inp = rb_device_inputs(pairs, qmc, 5, dev, tangent=False)
        g_ins, g_inp = rb_device_inputs(pairs, qmc, 5, dev, tangent=True)
        _, v_inp = rb_device_inputs(pairs, qmc, 5, dev, tangent=True, vjp=True)
        disc = ins.discount

        got = rk.rbergomi_mixing_values(*ins.values_args(), n_paths=pairs, steps=RB_STEPS, seed=5,
                                        antithetic=True, qmc=qmc, device=dev)
        torch.cuda.synchronize()
        want = rk.rbergomi_mixing_values_plain(inp, pairs, True, 5, 0, 0)
        err14 = compare_values(f"K14 rbergomi_mixing_values ({stream})", got, want, RB_VALUES_TOL)
        ms14 = time_ms(lambda: rk._rb_values(inp, pairs, True, 5, 0, 0))
        plain14 = time_ms(lambda: rk.rbergomi_mixing_values_plain(inp, pairs, True, 5, 0, 0),
                          reps=2)

        price = float(rk.rbergomi_mixing_vanilla_price(*ins.price_args(), qmc=qmc, **price_kw))
        mean = disc * float(got.double().mean())
        err15 = abs(price - mean)
        say(f"  K15 rbergomi_mixing_vanilla_price ({stream}): {price:.10f} vs K14 mean {mean:.10f}, "
            f"rel {err15 / abs(mean):.3e}")
        check(math.isfinite(price) and err15 <= PRICE_RTOL * abs(mean),
              f"K15 ({stream}) disagrees with the K14 mean by {err15 / abs(mean):.3e}")
        ms15 = time_ms(lambda: rk._rb_price_sum(inp, pairs, 5, 0, 0))
        plain15 = time_ms(lambda: rk.rbergomi_mixing_price_sum_plain(inp, pairs, 5, 0, 0), reps=2)

        g_price, greeks = rk.rbergomi_mixing_price_and_greeks(*g_ins, qmc=qmc, **price_kw)
        say(f"  K16 price {float(g_price)!r} vs K15 price {price!r}: "
            f"{'bit-identical' if float(g_price) == price else 'DIFFERENT'}")
        check(float(g_price) == price, f"K16 ({stream}) price differs from K15's")
        sums = rk._rb_greek_sums(g_inp, pairs, 5, 0, 0)
        want16 = rk.rbergomi_mixing_greek_sums_plain(g_inp, pairs, 5, 0, 0)
        compare_vectors(f"K16 sums against the twin ({stream})", sums, want16, SUM_RTOL)
        err16 = disc * float(((sums - want16) / (2 * pairs)).abs().max())
        say(f"  K16 greeks {dict(zip(rk.GREEK_ORDER_RB, (round(float(x), 8) for x in greeks)))}")
        ms16 = time_ms(lambda: rk._rb_greek_sums(g_inp, pairs, 5, 0, 0))
        plain16 = time_ms(lambda: rk.rbergomi_mixing_greek_sums_plain(g_inp, pairs, 5, 0, 0),
                          reps=2)

        sums17 = rk._rb_vjp_sums(v_inp, ct, pairs, True, 5, 0, 0)
        want17 = rk.rbergomi_mixing_vjp_sums_plain(v_inp, ct, pairs, True, 5, 0, 0)
        compare_vectors(f"K17 sums against the twin ({stream})", sums17, want17, SUM_RTOL)
        err17 = float(((sums17 - want17) / (2 * pairs)).abs().max())
        ms17 = time_ms(lambda: rk._rb_vjp_sums(v_inp, ct, pairs, True, 5, 0, 0))
        plain17 = time_ms(lambda: rk.rbergomi_mixing_vjp_sums_plain(v_inp, ct, pairs, True, 5, 0,
                                                                     0), reps=2)

        # K18 under the sloped curve against its twin, then under a flat curve
        # against K17 on K17's stream and cotangent
        c_inp = rk.rb_vjp_inputs(SPOT, RB_CURVE, *RB_SCALARS, g_ins.horizon, STRIKE, 1.0,
                                 steps=RB_STEPS, seed=5, qmc=qmc, device=dev)
        sums18 = rk._rb_vjp_sums(c_inp, ct, pairs, True, 5, 0, 0, per_step=True)
        want18 = rk.rbergomi_mixing_vjp_curve_sums_plain(c_inp, ct, pairs, True, 5, 0, 0)
        compare_vectors(f"K18 sums against the twin ({stream}, {RB_STEPS} per-step rows + 6)",
                        sums18, want18, SUM_RTOL)
        err18 = float(((sums18 - want18) / (2 * pairs)).abs().max())
        ms18 = time_ms(lambda: rk._rb_vjp_sums(c_inp, ct, pairs, True, 5, 0, 0, per_step=True))
        plain18 = time_ms(lambda: rk.rbergomi_mixing_vjp_curve_sums_plain(c_inp, ct, pairs, True, 5,
                                                                           0, 0), reps=2)
        rest = (*RB_SCALARS, g_ins.horizon, STRIKE, 1.0, ct)
        kw = dict(n_paths=pairs, steps=RB_STEPS, seed=5, antithetic=True, qmc=qmc)
        flat18 = rk._rb_values_vjp_curve(SPOT, [RB_MARKET["xi0"]] * 3, RB_CURVE_TENORS, *rest, **kw)
        flat17 = rk._rb_values_vjp(SPOT, RB_MARKET["xi0"], *rest, **kw)
        vegas = float(flat18[1].sum())
        rel = abs(vegas / float(flat17[1]) - 1.0)
        say(f"  K18 under a flat curve ({stream}): bucket vegas {flat18[1].tolist()} sum to "
            f"{vegas!r}, K17's xi0 gradient {float(flat17[1])!r}: rel {rel:.3e} (limit "
            f"{RB_FLAT_RTOL:g}); tenor sensitivities {flat18[2].tolist()}")
        check(rel <= RB_FLAT_RTOL, f"K18 ({stream}): flat-curve vegas disagree with K17's xi0")
        check(flat18[2].tolist() == [0.0] * 3, f"K18 ({stream}): tenor sensitivities of a flat curve")

        # K19 on the 17-strike grid against its twin; its strike 100 against K15
        ks = rk.smile_strikes(ins.f_base, CAL_STRIKES, dev)
        sums19 = rk._rb_smile_sums(inp, ks, pairs, 5, 0, 0)
        want19 = rk.rbergomi_mixing_smile_sums_plain(inp, ks, pairs, 5, 0, 0)
        compare_vectors(f"K19 sums against the twin ({stream}, {len(CAL_STRIKES)} strikes)",
                        sums19, want19, SURF_RTOL)
        k15_sum = float(rk._rb_price_sum(inp, pairs, 5, 0, 0))
        at_k = CAL_STRIKES.index(STRIKE)
        check(float(sums19[at_k]) == k15_sum, f"K19 ({stream}) at K = {STRIKE:g} differs from K15")
        err19 = disc * float(((sums19 - want19) / (2 * pairs)).abs().max())
        ms19 = time_ms(lambda: rk._rb_smile_sums(inp, ks, pairs, 5, 0, 0))
        plain19 = time_ms(lambda: rk.rbergomi_mixing_smile_sums_plain(inp, ks, pairs, 5, 0, 0),
                          reps=2)
        for name, ms, plain in (("K14", ms14, plain14), ("K15", ms15, plain15),
                                ("K16", ms16, plain16), ("K17", ms17, plain17),
                                ("K18", ms18, plain18), ("K19", ms19, plain19)):
            say(f"  {name} ({stream}): kernel {ms:.4f} ms, plain twin {plain:.4f} ms")

        # autograd of D·mean(values) through the view (K14 forward, K17
        # backward) against K16's greeks on the same pairs
        T = g_ins.horizon
        leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
                  for x in (SPOT, RB_MARKET["xi0"], RB_MARKET["eta"], RB_MARKET["hurst"],
                            RB_MARKET["rho"], R)]
        spot, xi0, eta, hurst, rho, r = leaves
        vals = rk.rbergomi_mixing_values_diff(spot, xi0, eta, hurst, rho, r, T, STRIKE, 1.0,
                                              n_paths=pairs, steps=RB_STEPS, seed=5,
                                              antithetic=True, qmc=qmc, device=dev)
        g = torch.autograd.grad(torch.exp(-r * T).to(dev) * vals.double().mean(), leaves)
        ad = torch.stack([g[0], g[1], g[2], g[4], g[3], g[5]])  # GREEK_ORDER_RB
        compare_vectors(f"autograd K14 -> K17 against K16 greeks ({stream})", ad, greeks,
                        AUTOGRAD_RTOL)
        if qmc:
            continue
        src = "hedgehog_tpu_torch/csrc/rbergomi.cu"
        for name, line, err, ms, plain in (
                ("rbergomi_mixing_values", 235, err14, ms14, plain14),
                ("rbergomi_mixing_vanilla_price", 339, err15, ms15, plain15),
                ("rbergomi_mixing_price_and_greeks", 613, err16, ms16, plain16),
                ("_rb_values_vjp", 923, err17, ms17, plain17),
                ("_rb_values_vjp_curve", 1115, err18, ms18, plain18),
                ("rbergomi_mixing_smile_price", 1398, err19, ms19, plain19)):
            records[name] = dict(source=src, replaces=f"hedgehog_tpu/ops/rbergomi_kernel.py:{line}",
                                 max_abs_err=err, ms=ms, plain_ms=plain)
    return records


def phase_rb_shapes(device: str) -> dict:
    """Each kernel against its plain twin at the shape the rough-Bergomi path
    gives it, with the tolerances of phase_rb_kernels: K14 and K17 at
    solve's (and autograd's) pairs on both streams, seed 0 as ``solve`` draws
    them, K17 under the cotangent of solve's backward (discount / (2 pairs)
    on every value), K18 under the same cotangent and the sloped curve;
    K15 and K16 at the serving shape (2^24 pairs, the serving PRNG stream)
    against their chunked twins; K19 at the serving shape on both streams,
    each of its 17 strikes equal to K15's at that strike to the bit and its
    sums against the chunked twin, and at each expiry of the surface phase
    with its step count there (2^21 pairs, PRNG).  Returns each
    kernel's largest absolute difference (values; price; greek or gradient
    sums in price units)."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs = RB_BLOCKS * RB_BATCHES * rk.PAIRS_PER_BLOCK
    seed = SERVING_CHECK_SEED
    say(f"phase 2 (rough-Bergomi path shapes): K14, K17 and K18 at {SOLVE_PAIRS} pairs x "
        f"{RB_STEPS} steps (seed 0, both streams; K17 and K18 under solve's cotangent); K15, K16 "
        f"and K19 at {pairs} pairs (seed {seed}) against the chunked twins ({rk.PLAIN_CHUNK} "
        f"pairs a chunk); K19 at the surface's step counts {rb_surface_steps()}")
    t0 = time.perf_counter()
    dev = torch.device(device)
    e14, e17, e18 = [], [], []
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        ins, inp = rb_device_inputs(SOLVE_PAIRS, qmc, 0, dev, tangent=False)
        got = rk.rbergomi_mixing_values(*ins.values_args(), n_paths=SOLVE_PAIRS, steps=RB_STEPS,
                                        seed=0, antithetic=True, qmc=qmc, device=dev)
        want = rk.rbergomi_mixing_values_plain(inp, SOLVE_PAIRS, True, 0, 0, 0)
        e14.append(compare_values(f"K14 ({stream}, {SOLVE_PAIRS} pairs)", got, want,
                                  RB_VALUES_TOL))
        del got, want
        _, v_inp = rb_device_inputs(SOLVE_PAIRS, qmc, 0, dev, tangent=True, vjp=True)
        ct = torch.full((2, SOLVE_PAIRS), ins.discount / (2 * SOLVE_PAIRS), dtype=torch.float32,
                        device=dev)
        sums = rk._rb_vjp_sums(v_inp, ct, SOLVE_PAIRS, True, 0, 0, 0)
        want = rk.rbergomi_mixing_vjp_sums_plain(v_inp, ct, SOLVE_PAIRS, True, 0, 0, 0)
        e17.append(compare_vectors(f"K17 sums under solve's cotangent ({stream}, {SOLVE_PAIRS} "
                                   f"pairs)", sums, want, SUM_RTOL))
        c_inp = rk.rb_vjp_inputs(SPOT, RB_CURVE, *RB_SCALARS, ins.T, STRIKE, 1.0, steps=RB_STEPS,
                                 seed=0, qmc=qmc, device=dev)
        sums = rk._rb_vjp_sums(c_inp, ct, SOLVE_PAIRS, True, 0, 0, 0, per_step=True)
        want = rk.rbergomi_mixing_vjp_curve_sums_plain(c_inp, ct, SOLVE_PAIRS, True, 0, 0, 0)
        e18.append(compare_vectors(f"K18 sums under solve's cotangent and the sloped curve "
                                   f"({stream}, {SOLVE_PAIRS} pairs)", sums, want, SUM_RTOL))
        del sums, want
    t1 = time.perf_counter()
    ins, inp = rb_device_inputs(pairs, False, seed, dev, tangent=False)
    _, g_inp = rb_device_inputs(pairs, False, seed, dev, tangent=True)
    disc = ins.discount
    got, want = rk._rb_price_sum(inp, pairs, seed, 0, 0), rk.rbergomi_mixing_price_sum_plain(
        inp, pairs, seed, 0, 0)
    rel = abs(float(got) - float(want)) / abs(float(want))
    say(f"  K15 sum: {float(got)!r} vs twin {float(want)!r}, rel {rel:.3e} (limit {PRICE_RTOL:g})")
    check(math.isfinite(float(got)) and rel <= PRICE_RTOL, f"K15 at {pairs} pairs: rel {rel:.3e}")
    sums = rk._rb_greek_sums(g_inp, pairs, seed, 0, 0)
    check(float(sums[0]) == float(got), "K16's price sum differs from K15's at the serving shape")
    want16 = rk.rbergomi_mixing_greek_sums_plain(g_inp, pairs, seed, 0, 0)
    compare_vectors(f"K16 sums ({pairs} pairs)", sums, want16, SUM_RTOL)
    t2 = time.perf_counter()
    # K19 at the serving shape: each strike K15's to the bit, the sums
    # against the chunked twin
    e19 = []
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        s_ins, s_inp = rb_device_inputs(pairs, qmc, seed, dev, tangent=False)
        ks = rk.smile_strikes(s_ins.f_base, CAL_STRIKES, dev)
        smile = rk._rb_smile_sums(s_inp, ks, pairs, seed, 0, 0)
        k15 = [float(rk._rb_price_sum(rk.rb_inputs_from_trace(
            s_ins._replace(strike=k, log_f_over_k=math.log(s_ins.f_base / k)), seed=seed, qmc=qmc,
            device=dev), pairs, seed, 0, 0)) for k in CAL_STRIKES]
        equal = sum(float(a) == b for a, b in zip(smile, k15))
        say(f"  K19 ({stream}, {pairs} pairs, {len(CAL_STRIKES)} strikes): {equal} of "
            f"{len(CAL_STRIKES)} strike sums equal K15's at that strike to the bit")
        check(equal == len(CAL_STRIKES), f"K19 ({stream}) differs from K15 at the serving shape")
        want19 = rk.rbergomi_mixing_smile_sums_plain(s_inp, ks, pairs, seed, 0, 0)
        compare_vectors(f"K19 sums ({stream}, {pairs} pairs)", smile, want19, SURF_RTOL)
        e19.append(disc * float(((smile - want19) / (2 * pairs)).abs().max()))
    # K19 at the other step counts the surface phase gives it: each expiry of
    # the surface grid on the first seed of its PRNG smiles
    market = rb_problem().market_inputs
    surf_pairs = RB_SURF_SMILE_BLOCKS * rk.PAIRS_PER_BLOCK
    for expiry, n in zip(SURF_EXPIRIES, rb_surface_steps()):
        cfg = ht.SimulationConfig(surf_pairs, n, ht.Antithetic(), 200, False)
        s_ins = rk._rb_trace_inputs(ht.PricingProblem(ht.VanillaOption(STRIKE, expiry), market),
                                    cfg, 64)
        s_inp = rk.rb_inputs_from_trace(s_ins, seed=200, qmc=False, device=dev)
        ks = rk.smile_strikes(s_ins.f_base, SURF_STRIKES, dev)
        smile = rk._rb_smile_sums(s_inp, ks, surf_pairs, 200, 0, 0)
        want19 = rk.rbergomi_mixing_smile_sums_plain(s_inp, ks, surf_pairs, 200, 0, 0)
        compare_vectors(f"K19 sums (PRNG, {surf_pairs} pairs, {n} steps to {expiry}, "
                        f"{len(SURF_STRIKES)} strikes)", smile, want19, SURF_RTOL)
        e19.append(s_ins.discount * float(((smile - want19) / (2 * surf_pairs)).abs().max()))
    say(f"  phase took {time.perf_counter() - t0:.1f} s (K14, K17 and K18 {t1 - t0:.1f} s, K19 "
        f"{time.perf_counter() - t2:.1f} s)")
    return {"rbergomi_mixing_values": max(e14), "_rb_values_vjp": max(e17),
            "_rb_values_vjp_curve": max(e18),
            "rbergomi_mixing_vanilla_price": disc * abs(float(got) - float(want)) / (2 * pairs),
            "rbergomi_mixing_price_and_greeks": disc * float(((sums - want16) / (2 * pairs))
                                                             .abs().max()),
            "rbergomi_mixing_smile_price": max(e19)}


def phase_past_old_limits(T: float, device: str) -> dict:
    """Every kernel whose wrapper once refused a size the JAX kernels take,
    past that size at full width (finite, timed), and against its plain
    twin on ``WIDE_TWIN_PAIRS`` pairs at its family's tolerance: K5, K7,
    K8, K10, K11 and K6 at ``WIDE_QE_STEPS`` steps (QMC; K6 is Philox only),
    K2 and K3 at ``WIDE_EXACT_SEGMENTS`` QMC segments, K4 on ``WIDE_K4``,
    K9 and K12 on a ``WIDE_SURF_YEARS``-year QE-32 QMC surface, K14-K18 at
    ``WIDE_RB_STEPS`` steps on both streams, K19 at the 81 strikes of
    ``WIDE_SMILE_STRIKES`` (each strike K15's price to the bit).  Returns
    {kernel: (max abs error against the twin, full-width ms)}."""
    import torch

    from hedgehog_tpu_torch.methods.heston_surface import surface_seg_steps
    from hedgehog_tpu_torch.models.heston_exact import poisson_kmax
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    dev, tw, out = torch.device(device), WIDE_TWIN_PAIRS, {}
    serving = SERVING_BLOCKS * SERVING_BATCHES * qk.PAIRS_PER_BLOCK
    say(f"phase 2 (past the old limits): each kernel at full width and against its twin on {tw} "
        "pairs")

    def full(name, fn):
        res = fn()
        torch.cuda.synchronize()
        vals = res if isinstance(res, tuple) else (res,)
        check(all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in vals),
              f"{name}: non-finite output at full width")
        ms = time_ms(fn, reps=2)
        say(f"  {name} at full width: {ms:.3f} ms")
        return ms

    n = WIDE_QE_STEPS
    p_mix, t_mix = qk.mix_inputs(*MARKET_ARGS, T / n, STRIKE, 1.0, n, 5, True, dev)
    tol, mean_tol = chain_tol(VALUES_TOL, n, QE_STEPS)
    say(f"  per path: {tol['share']} of values within rel {tol['rel']:.3g} and the means within "
        f"{mean_tol:.3g} (VALUES_TOL and MEAN_RTOL at {QE_STEPS} steps scaled by the chain's "
        "length); sums within SUM_RTOL as at the old sizes")
    err = compare_values(f"K7 ({n} QMC steps)", qk._qe_values(p_mix, t_mix, tw, n, True, 5, 0, 0),
                         qk.heston_qe_mixing_values_plain(p_mix, t_mix, tw, n, True, 5, 0, 0), tol,
                         mean_tol)
    out["K7"] = (err, full(f"K7 ({n} QMC steps, {SOLVE_PAIRS} pairs)",
                           lambda: qk._qe_values(p_mix, t_mix, SOLVE_PAIRS, n, True, 5, 0, 0)))
    got8 = qk._qe_price_sum(p_mix, t_mix, tw, n, 5, 0, 0)
    err = compare_vectors(f"K8 sum ({n} QMC steps)", got8.reshape(1),
                          qk.heston_qe_mixing_price_sum_plain(p_mix, t_mix, tw, n, 5, 0, 0).reshape(1),
                          SUM_RTOL)
    out["K8"] = (err, full(f"K8 ({n} QMC steps, {serving} pairs)",
                           lambda: qk._qe_price_sum(p_mix, t_mix, serving, n, 5, 0, 0)))
    dtab = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                           HESTON["sigma"], T / n, n, 4), device=dev)
    got10 = gk._greek_sums(p_mix, dtab, t_mix, tw, n, 5, 0, 0)
    err = compare_vectors(f"K10 sums ({n} QMC steps)", got10,
                          gk.heston_qe_mixing_greek_sums_plain(p_mix, dtab, t_mix, tw, n, 5, 0, 0),
                          SUM_RTOL)
    check(float(got10[0]) == float(got8), "K10's price sum differs from K8's")
    out["K10"] = (err, full(f"K10 ({n} QMC steps, {serving} pairs)",
                            lambda: gk._greek_sums(p_mix, dtab, t_mix, serving, n, 5, 0, 0)))
    vtab = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                           HESTON["sigma"], T / n, n, 5), device=dev)
    ct = (0.5 + 0.5 * torch.sin(torch.arange(2 * tw, device=dev, dtype=torch.float32))).reshape(
        2, tw)
    err = compare_vectors(f"K11 sums ({n} QMC steps)",
                          gk._vjp_sums(p_mix, vtab, t_mix, ct, tw, n, True, 5, 0, 0),
                          gk.heston_qe_mixing_vjp_sums_plain(p_mix, vtab, t_mix, ct, tw, n, True,
                                                             5, 0, 0), SUM_RTOL)
    out["K11"] = (err, None)
    p_qem, t_qem = qk.qem_inputs(*MARKET_ARGS, T / n, n, 5, True, dev)
    tol, mean_tol = chain_tol(VALUES_TOL, n, QEM_STEPS)
    err = compare_values(f"K5 ({n} QMC steps)",
                         qk._qem_terminal(p_qem, t_qem, tw, n, True, True, 5, 0, 0),
                         qk.heston_qe_terminal_plain(p_qem, t_qem, tw, n, True, True, 5, 0, 0), tol,
                         mean_tol)
    out["K5"] = (err, full(f"K5 ({n} QMC steps, {QEM_SOLVE_PAIRS} pairs)",
                           lambda: qk._qem_terminal(p_qem, t_qem, QEM_SOLVE_PAIRS, n, True, True,
                                                    5, 0, 0)))
    p6, _ = qk.qem_inputs(*MARKET_ARGS, T / n, n, 5, False, dev)
    p6 = torch.cat([p6, torch.tensor([STRIKE], dtype=torch.float32, device=dev)])
    err = compare_vectors(f"K6 sum ({n} Philox steps)", qk._qem_price_sum(p6, tw, n, 5, 0).reshape(1),
                          qk.heston_qe_call_price_sum_plain(p6, tw, n, 5, 0).reshape(1), SUM_RTOL)
    out["K6"] = (err, full(f"K6 ({n} Philox steps, {serving} pairs)",
                           lambda: qk._qem_price_sum(p6, serving, n, 5, 0)))

    segs = WIDE_EXACT_SEGMENTS
    px, tx, kmax = ek._inputs(*MARKET_ARGS, WIDE_EXACT_YEARS / segs, STRIKE, 1.0, segs, 5, True,
                              dev)
    tol, mean_tol = chain_tol(VALUES_TOL, segs, SEGMENTS)
    err = compare_values(f"K2 ({segs} QMC segments)",
                         ek._exact_values(px, tx, tw, segs, True, kmax, 5, 0, 0),
                         ek.heston_exact_mixing_values_plain(px, tx, tw, segs, True, kmax, 5, 0, 0),
                         tol, mean_tol)
    out["K2"] = (err, full(f"K2 ({segs} QMC segments, {SOLVE_PAIRS} pairs)",
                           lambda: ek._exact_values(px, tx, SOLVE_PAIRS, segs, True, kmax, 5, 0, 0)))
    err = compare_vectors(f"K3 sum ({segs} QMC segments)",
                          ek._exact_price_sum(px, tx, tw, segs, kmax, 5, 0, 0).reshape(1),
                          ek.heston_exact_mixing_price_sum_plain(px, tx, tw, segs, kmax, 5, 0,
                                                                 0).reshape(1), SUM_RTOL)
    out["K3"] = (err, full(f"K3 ({segs} QMC segments, {serving} pairs)",
                           lambda: ek._exact_price_sum(px, tx, serving, segs, kmax, 5, 0, 0)))

    # K4: 10 semiannual expiries x 20 strikes, 4 segments a gap (40 under QMC)
    n_exp, m4 = WIDE_K4["expiries"], WIDE_K4["strikes"]
    T4 = [WIDE_EXACT_YEARS * (i + 1) / n_exp for i in range(n_exp)]
    k4 = [60.0 + 80.0 * k / (m4 - 1) for k in range(m4)]
    seg4 = (WIDE_K4["segments"],) * n_exp
    kmax4 = [poisson_kmax(*MARKET_ARGS[3:6], d, MARKET_ARGS[1]) for d in qk.segment_dts(T4, seg4)]
    t4 = torch.as_tensor(qk.sobol_table(5, 4 * sum(seg4)), device=dev)
    p4 = torch.as_tensor(ek._exact_surf_params(*MARKET_ARGS, T4, seg4, k4, 1.0), device=dev)
    run4 = (p4, t4, seg4, kmax4, m4, tw, 5, 0, 0)
    err = compare_points(f"K4 sums ({n_exp} x {m4}, {sum(seg4)} QMC segments)",
                         ek._exact_surface_sums(*run4),
                         ek.heston_exact_mixing_surface_sums_plain(*run4), tw, 1.0)
    out["K4"] = (err, full(
        f"K4 public wrapper ({n_exp} x {m4}, {sum(seg4)} QMC segments, {WIDE_K4['pairs']} pairs)",
        lambda: ek.heston_exact_mixing_surface_price(
            *MARKET_ARGS, T4, k4, [math.exp(-R * x) for x in T4], seg_steps=seg4, n_strikes=m4,
            n_blocks=WIDE_K4["pairs"] // qk.PAIRS_PER_BLOCK, n_batches=1, seed=5, qmc=True,
            device=dev)))

    # K9, K12: a five-year QE-32 surface, yearly expiries x the 5 strikes
    T9 = [float(y + 1) for y in range(WIDE_SURF_YEARS)]
    seg9 = tuple(surface_seg_steps(T9, SURF_QE_STEPS * WIDE_SURF_YEARS)[1])
    t9 = torch.as_tensor(qk.sobol_table(5, 2 * sum(seg9)), device=dev)
    p9 = torch.as_tensor(qk._surf_params(*MARKET_ARGS, T9, seg9, SURF_STRIKES, 1.0), device=dev)
    dct, djt = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in gk._surface_greek_tables(*MARKET_ARGS[3:6], T9, seg9))
    m9 = len(SURF_STRIKES)
    run9 = (p9, t9, seg9, m9, tw, 5, 0, 0)
    s9 = qk._qe_surface_sums(*run9)
    err = compare_points(f"K9 sums ({WIDE_SURF_YEARS}-year QE-32, {sum(seg9)} QMC steps)", s9,
                         qk.heston_qe_mixing_surface_sums_plain(*run9), tw, 1.0)
    run12 = (p9, dct, djt, t9, seg9, m9, tw, 5, 0, 0)
    s12 = gk._surface_jac_sums(*run12)
    err12 = compare_vectors(f"K12 sums ({WIDE_SURF_YEARS}-year QE-32, {sum(seg9)} QMC steps)",
                            s12, gk.heston_qe_mixing_surface_jac_sums_plain(*run12), SUM_RTOL)
    check(torch.equal(s12.reshape(-1, 7)[:, 0], s9), "K12's five-year surface differs from K9's")
    wide = dict(seg_steps=seg9, n_strikes=m9, n_blocks=SURF_BLOCKS, n_batches=SURF_BATCHES, seed=5,
                qmc=True, device=dev)
    discs9 = [math.exp(-R * x) for x in T9]
    out["K9"] = (err, full(f"K9 ({WIDE_SURF_YEARS}-year QE-32 QMC, 2^26 pairs)",
                           lambda: qk.heston_qe_mixing_surface_price(*MARKET_ARGS, T9, SURF_STRIKES,
                                                                     discs9, **wide)))
    out["K12"] = (err12, full(
        f"K12 ({WIDE_SURF_YEARS}-year QE-32 QMC, 2^26 pairs)",
        lambda: gk.heston_qe_mixing_surface_price_and_jacobian(*MARKET_ARGS, T9, SURF_STRIKES,
                                                               discs9, **wide)))
    check(torch.equal(qk.heston_qe_mixing_surface_price(*MARKET_ARGS, T9, SURF_STRIKES, discs9,
                                                        **wide),
                      gk.heston_qe_mixing_surface_price_and_jacobian(*MARKET_ARGS, T9, SURF_STRIKES,
                                                                     discs9, **wide)[0]),
          "K12's five-year 2^26-pair surface differs from K9's")

    # rough Bergomi at WIDE_RB_STEPS steps: K14, K17, K18 at WIDE_RB_PAIRS
    # pairs, K15 and K16 at the serving 2^24, each against its twin
    n = WIDE_RB_STEPS
    rb_serving = RB_BLOCKS * RB_BATCHES * rk.PAIRS_PER_BLOCK
    for qmc in (True, False):
        s = "QMC" if qmc else "PRNG"
        ins, inp = rb_device_inputs(tw, qmc, 5, dev, tangent=False, steps=n)
        g_ins, g_inp = rb_device_inputs(tw, qmc, 5, dev, tangent=True, steps=n)
        _, v_inp = rb_device_inputs(tw, qmc, 5, dev, tangent=True, vjp=True, steps=n)
        say(f"  rough Bergomi at {n} steps ({s}), the xi columns in the global slab: K15 "
            f"occupancy {rk.price_occupancy(inp)}")
        tol, mean_tol = chain_tol(RB_VALUES_TOL, n, RB_STEPS)
        e14 = compare_values(f"K14 ({n} steps, {s})", rk._rb_values(inp, tw, True, 5, 0, 0),
                             rk.rbergomi_mixing_values_plain(inp, tw, True, 5, 0, 0), tol, mean_tol)
        ms14 = full(f"K14 ({n} steps, {s}, {WIDE_RB_PAIRS} pairs)",
                    lambda: rk._rb_values(inp, WIDE_RB_PAIRS, True, 5, 0, 0))
        e15 = compare_vectors(f"K15 sum ({n} steps, {s})",
                              rk._rb_price_sum(inp, tw, 5, 0, 0).reshape(1),
                              rk.rbergomi_mixing_price_sum_plain(inp, tw, 5, 0, 0).reshape(1),
                              SUM_RTOL)
        ms15 = full(f"K15 ({n} steps, {s}, {rb_serving} pairs)",
                    lambda: rk._rb_price_sum(inp, rb_serving, 5, 0, 0))
        g16 = rk._rb_greek_sums(g_inp, tw, 5, 0, 0)
        e16 = compare_vectors(f"K16 sums ({n} steps, {s})", g16,
                              rk.rbergomi_mixing_greek_sums_plain(g_inp, tw, 5, 0, 0), SUM_RTOL)
        check(float(g16[0]) == float(rk._rb_price_sum(g_inp, tw, 5, 0, 0)),
              f"K16's price differs from K15's at {n} steps ({s})")
        ms16 = full(f"K16 ({n} steps, {s}, {rb_serving} pairs)",
                    lambda: rk._rb_greek_sums(g_inp, rb_serving, 5, 0, 0))
        ct_rb = (0.5 + 0.5 * torch.sin(torch.arange(2 * WIDE_RB_PAIRS, device=dev,
                                                    dtype=torch.float32))).reshape(2, -1)
        ct_tw = ct_rb[:, :tw].contiguous()
        e17 = compare_vectors(f"K17 sums ({n} steps, {s})",
                              rk._rb_vjp_sums(v_inp, ct_tw, tw, True, 5, 0, 0),
                              rk.rbergomi_mixing_vjp_sums_plain(v_inp, ct_tw, tw, True, 5, 0, 0),
                              SUM_RTOL)
        ms17 = full(f"K17 ({n} steps, {s}, {WIDE_RB_PAIRS} pairs)",
                    lambda: rk._rb_vjp_sums(v_inp, ct_rb, WIDE_RB_PAIRS, True, 5, 0, 0))
        c_inp = rk.rb_vjp_inputs(SPOT, RB_CURVE, *RB_SCALARS, g_ins.horizon, STRIKE, 1.0, steps=n,
                                 seed=5, qmc=qmc, device=dev)
        e18 = compare_vectors(f"K18 sums ({n} steps, {s})",
                              rk._rb_vjp_sums(c_inp, ct_tw, tw, True, 5, 0, 0, per_step=True),
                              rk.rbergomi_mixing_vjp_curve_sums_plain(c_inp, ct_tw, tw, True, 5, 0,
                                                                      0), SUM_RTOL)
        ms18 = full(f"K18 ({n} steps, {s}, {WIDE_RB_PAIRS} pairs)",
                    lambda: rk._rb_vjp_sums(c_inp, ct_rb, WIDE_RB_PAIRS, True, 5, 0, 0,
                                            per_step=True))
        if not qmc:
            out.update(K14=(e14, ms14), K15=(e15, ms15), K16=(e16, ms16), K17=(e17, ms17),
                       K18=(e18, ms18))

    # K19: 81 strikes (two launches) at 2^24 pairs x 64 steps, each strike K15's price
    for qmc in (True, False):
        s = "QMC" if qmc else "PRNG"
        ins, inp = rb_device_inputs(rb_serving, qmc, 5, dev, tangent=False)
        ks = rk.smile_strikes(ins.f_base, WIDE_SMILE_STRIKES, dev)
        smile = rk._rb_smile_sums(inp, ks, rb_serving, 5, 0, 0)
        k15 = [float(rk._rb_price_sum(rk.rb_inputs_from_trace(
            ins._replace(strike=k, log_f_over_k=math.log(ins.f_base / k)), seed=5, qmc=qmc,
            device=dev), rb_serving, 5, 0, 0)) for k in WIDE_SMILE_STRIKES]
        same = sum(float(a) == b for a, b in zip(smile, k15))
        say(f"  K19 at {len(ks)} strikes ({s}, {rb_serving} pairs): {same} of {len(ks)} strikes "
            "equal K15's price to the bit")
        check(same == len(ks), f"K19 at {len(ks)} strikes ({s}): a strike differs from K15's")
        e19 = compare_vectors(f"K19 sums ({len(ks)} strikes, {s})",
                              rk._rb_smile_sums(inp, ks, tw, 5, 0, 0),
                              rk.rbergomi_mixing_smile_sums_plain(inp, ks, tw, 5, 0, 0), SURF_RTOL)
        if not qmc:
            out["K19"] = (e19, full(f"K19 ({len(ks)} strikes, {s}, {rb_serving} pairs)",
                                    lambda: rk._rb_smile_sums(inp, ks, rb_serving, 5, 0, 0)))
    return out


def phase_global_tables(T: float, device: str) -> dict:
    """Every QMC kernel of the Heston families past the size at which its
    Sobol' table no longer fits a block's shared memory, so that it runs
    the instantiation that reads the table from global memory, against its
    twin on ``GLOBAL_TWIN_PAIRS`` pairs: K7, K8, K10, K11 at
    ``GLOBAL_QE_STEPS`` steps, K5 at ``GLOBAL_QEM_STEPS``, K2 and K3 at
    ``GLOBAL_EXACT_SEGMENTS`` segments, K4 on two expiries of half as many,
    K9 and K12 on the 3 x 5 surface at ``GLOBAL_SURF_SEG`` (K12's surface
    column equal to K9's to the bit).  Per path the family's tolerance
    scaled by the chain's length (``chain_tol``); sums within the larger of
    their usual limit and the chain's mean tolerance (a sum is the mean
    times the pairs).  Returns {kernel: max abs error against the twin}."""
    import torch

    from hedgehog_tpu_torch.models.heston_exact import poisson_kmax
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    dev, tw, out = torch.device(device), GLOBAL_TWIN_PAIRS, {}
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    227 * 1024)
    say(f"phase 2 (past the staging limit): the Sobol' table in global memory, each kernel "
        f"against its twin on {tw} pairs (a block opts into {optin} bytes at most)")

    def over(name, rows):
        table = 4 * (qk.SOBOL_BITS + 1) * rows
        say(f"  {name}: a {table}-byte table, more than a block's {optin}")
        check(table > optin, f"{name}: the table fits shared memory; the case is not past it")

    n = GLOBAL_QE_STEPS
    p_mix, t_mix = qk.mix_inputs(*MARKET_ARGS, T / n, STRIKE, 1.0, n, 5, True, dev)
    over(f"K7, K8, K10, K11 at {n} QMC steps", t_mix.shape[0])
    tol, mean_tol = chain_tol(VALUES_TOL, n, QE_STEPS)
    sum_tol = max(SUM_RTOL, mean_tol)
    out["K7"] = compare_values(f"K7 ({n} QMC steps)",
                               qk._qe_values(p_mix, t_mix, tw, n, True, 5, 0, 0),
                               qk.heston_qe_mixing_values_plain(p_mix, t_mix, tw, n, True, 5, 0, 0),
                               tol, mean_tol)
    got8 = qk._qe_price_sum(p_mix, t_mix, tw, n, 5, 0, 0)
    out["K8"] = compare_vectors(
        f"K8 sum ({n} QMC steps)", got8.reshape(1),
        qk.heston_qe_mixing_price_sum_plain(p_mix, t_mix, tw, n, 5, 0, 0).reshape(1), sum_tol)
    dtab = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                           HESTON["sigma"], T / n, n, 4), device=dev)
    got10 = gk._greek_sums(p_mix, dtab, t_mix, tw, n, 5, 0, 0)
    out["K10"] = compare_vectors(
        f"K10 sums ({n} QMC steps)", got10,
        gk.heston_qe_mixing_greek_sums_plain(p_mix, dtab, t_mix, tw, n, 5, 0, 0), sum_tol)
    check(float(got10[0]) == float(got8), f"K10's price sum differs from K8's at {n} steps")
    vtab = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                           HESTON["sigma"], T / n, n, 5), device=dev)
    ct = (0.5 + 0.5 * torch.sin(torch.arange(2 * tw, device=dev, dtype=torch.float32))).reshape(
        2, tw)
    out["K11"] = compare_vectors(
        f"K11 sums ({n} QMC steps)", gk._vjp_sums(p_mix, vtab, t_mix, ct, tw, n, True, 5, 0, 0),
        gk.heston_qe_mixing_vjp_sums_plain(p_mix, vtab, t_mix, ct, tw, n, True, 5, 0, 0), sum_tol)

    n = GLOBAL_QEM_STEPS
    p_qem, t_qem = qk.qem_inputs(*MARKET_ARGS, T / n, n, 5, True, dev)
    over(f"K5 at {n} QMC steps", t_qem.shape[0])
    tol, mean_tol = chain_tol(VALUES_TOL, n, QEM_STEPS)
    out["K5"] = compare_values(f"K5 ({n} QMC steps)",
                               qk._qem_terminal(p_qem, t_qem, tw, n, True, True, 5, 0, 0),
                               qk.heston_qe_terminal_plain(p_qem, t_qem, tw, n, True, True, 5, 0, 0),
                               tol, mean_tol)

    segs, years = GLOBAL_EXACT_SEGMENTS, GLOBAL_EXACT_YEARS
    market = (*MARKET_ARGS[:5], GLOBAL_EXACT_SIGMA, MARKET_ARGS[6])
    px, tx, kmax = ek._inputs(*market, years / segs, STRIKE, 1.0, segs, 5, True, dev)
    over(f"K2, K3 at {segs} QMC segments ({years:g} years, vol-of-vol {GLOBAL_EXACT_SIGMA}, "
         f"{kmax} Poisson trips)", tx.shape[0])
    tol, mean_tol = chain_tol(VALUES_TOL, segs, SEGMENTS)
    out["K2"] = compare_values(
        f"K2 ({segs} QMC segments)", ek._exact_values(px, tx, tw, segs, True, kmax, 5, 0, 0),
        ek.heston_exact_mixing_values_plain(px, tx, tw, segs, True, kmax, 5, 0, 0), tol, mean_tol)
    out["K3"] = compare_vectors(
        f"K3 sum ({segs} QMC segments)",
        ek._exact_price_sum(px, tx, tw, segs, kmax, 5, 0, 0).reshape(1),
        ek.heston_exact_mixing_price_sum_plain(px, tx, tw, segs, kmax, 5, 0, 0).reshape(1),
        max(SUM_RTOL, mean_tol))
    T4, seg4 = (years / 2, years), (segs // 2, segs // 2)
    check(not ek.exact_surface_staged(len(T4), sum(seg4), True),
          f"K4 at {sum(seg4)} QMC segments stages its table; the case is not past the limit")
    kmax4 = [poisson_kmax(*market[3:6], d, market[1]) for d in qk.segment_dts(T4, seg4)]
    t4 = torch.as_tensor(qk.sobol_table(5, 4 * sum(seg4)), device=dev)
    p4 = torch.as_tensor(ek._exact_surf_params(*market, T4, seg4, SURF_STRIKES, 1.0), device=dev)
    run4 = (p4, t4, seg4, kmax4, len(SURF_STRIKES), tw, 5, 0, 0)
    out["K4"] = compare_points(f"K4 sums (2 x {len(SURF_STRIKES)}, {sum(seg4)} QMC segments)",
                               ek._exact_surface_sums(*run4),
                               ek.heston_exact_mixing_surface_sums_plain(*run4), tw, 1.0,
                               max(SURF_RTOL, chain_tol(VALUES_TOL, segs, SURF_EXACT_STEPS)[1]))

    T_host, _, _, _ = surface_grid()
    seg9, m9 = GLOBAL_SURF_SEG, len(SURF_STRIKES)
    check(not (qk.surface_staged(len(T_host), 2 * sum(seg9))
               or qk.surface_staged(len(T_host), 2 * sum(seg9), jac=True)),
          f"K9/K12 at {sum(seg9)} QMC steps stage their table; the case is not past the limit")
    t9 = torch.as_tensor(qk.sobol_table(5, 2 * sum(seg9)), device=dev)
    p9 = torch.as_tensor(qk._surf_params(*MARKET_ARGS, T_host, seg9, SURF_STRIKES, 1.0), device=dev)
    dct, djt = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in gk._surface_greek_tables(*MARKET_ARGS[3:6], T_host, seg9))
    surf_tol = max(SURF_RTOL, chain_tol(VALUES_TOL, sum(seg9), SURF_QE_STEPS)[1])
    run9 = (p9, t9, seg9, m9, tw, 5, 0, 0)
    s9 = qk._qe_surface_sums(*run9)
    out["K9"] = compare_points(f"K9 sums (3 x {m9}, {sum(seg9)} QMC steps)", s9,
                               qk.heston_qe_mixing_surface_sums_plain(*run9), tw, 1.0, surf_tol)
    run12 = (p9, dct, djt, t9, seg9, m9, tw, 5, 0, 0)
    s12 = gk._surface_jac_sums(*run12)
    out["K12"] = compare_vectors(f"K12 sums (3 x {m9}, {sum(seg9)} QMC steps)", s12,
                                 gk.heston_qe_mixing_surface_jac_sums_plain(*run12), surf_tol)
    check(torch.equal(s12.reshape(-1, 7)[:, 0], s9),
          f"K12's surface at {sum(seg9)} QMC steps differs from K9's")
    say(f"  K12's surface at {sum(seg9)} QMC steps against K9's: bit-identical")
    return out


def say_occupancy(name: str, occ: dict) -> None:
    say(f"  {name}: {occ['blocks_per_sm']} blocks of {occ['threads']} threads per SM = "
        f"{occ['warps_per_sm']} warps of 64; {occ['smem_bytes'] / 1024:.1f} KB of shared memory "
        f"a block; {occ['registers']} registers a thread, {occ['local_bytes']} B local")


def phase_rb_occupancy(device: str) -> dict:
    """K15's occupancy on each stream from the CUDA runtime (the grid K15,
    K16 and K19 walk): resident blocks and warps per SM, the shared memory a
    block holds (the 64 pairs' ξ columns, the chunk of Z rows, the Sobol'
    table under QMC, the reduction's doubles), registers and spill; then
    K16's (which must hold at least K15's blocks an SM, so that K15's grid
    is one wave of it too), K14's (at least K15's blocks an SM: K15's bytes
    and trips), K17's, K18's (64 steps) and K4's (the full-width surface)
    likewise."""
    import torch

    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    dev = torch.device(device)
    _, _, _, ex_seg = surface_grid()
    out = {}
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        _, inp = rb_device_inputs(rk.PAIRS_PER_BLOCK, qmc, 0, dev, tangent=False)
        out[stream] = rk.price_occupancy(inp)
        say_occupancy(f"K15 occupancy ({stream}, {RB_STEPS} steps)", out[stream])
        _, g_inp = rb_device_inputs(rk.PAIRS_PER_BLOCK, qmc, 0, dev, tangent=True)
        out[f"K16 {stream}"] = rk.greeks_occupancy(g_inp)
        say_occupancy(f"K16 occupancy ({stream}, {RB_STEPS} steps)", out[f"K16 {stream}"])
        check(out[f"K16 {stream}"]["blocks_per_sm"] >= out[stream]["blocks_per_sm"],
              f"K16 holds fewer blocks an SM than K15 ({stream}): K15's grid is not one wave of it")
        out[f"K14 {stream}"] = rk.values_occupancy(inp)
        say_occupancy(f"K14 occupancy ({stream}, {RB_STEPS} steps)", out[f"K14 {stream}"])
        check(out[f"K14 {stream}"]["blocks_per_sm"] >= out[stream]["blocks_per_sm"],
              f"K14 holds fewer blocks an SM than K15 ({stream})")
        _, v_inp = rb_device_inputs(rk.PAIRS_PER_BLOCK, qmc, 0, dev, tangent=True, vjp=True)
        out[f"K17 {stream}"] = rk.vjp_occupancy(v_inp)
        say_occupancy(f"K17 occupancy ({stream}, {RB_STEPS} steps)", out[f"K17 {stream}"])
        _, c_inp = rb_device_inputs(rk.PAIRS_PER_BLOCK, qmc, 0, dev, tangent=True, vjp=True)
        out[f"K18 {stream}"] = rk.vjp_curve_occupancy(c_inp)
        say_occupancy(f"K18 occupancy ({stream}, {RB_STEPS} steps)", out[f"K18 {stream}"])
        out[f"K4 {stream}"] = ek.exact_surface_occupancy(
            len(SURF_EXPIRIES), len(SURF_STRIKES), sum(ex_seg), qmc, dev)
        say_occupancy(f"K4 occupancy ({stream}, {len(SURF_EXPIRIES)} x {len(SURF_STRIKES)}, "
                      f"{sum(ex_seg)} segments)", out[f"K4 {stream}"])
    return out


def rb_se(values, pairs: int, disc: float) -> float:
    """The standard error of a mixing price from its (2, pairs) ensemble."""
    return disc * float(values.mean(dim=0).std()) / math.sqrt(pairs)


def phase_rb_path(device: str) -> dict:
    """``solve`` with RoughBergomiMixing(use_kernel=True) on the card at
    2^22 pairs x 64 steps, QMC and PRNG, against the three checks that stand
    in for the missing closed form: eta = 0 against Black-Scholes at
    sigma = sqrt(xi0); put-call parity; the float64 estimator on the card
    (use_kernel=False, QMC, 2^20 pairs); then autograd through the
    kernel-backed solve against K16.  Returns the prices and errors."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs = SOLVE_PAIRS
    say(f"phase 3 (rough Bergomi): solve on {device}, RoughBergomiMixing(use_kernel=True), "
        f"{pairs} pairs x {RB_STEPS} steps; no closed form (benchmarks/rbergomi_bench.py:5-6)")
    kernel = ht.RoughBergomiMixing(use_kernel=True)
    disc = float(ht.df(rb_problem().market_inputs.rate, RB_EXPIRY))
    T = float(ht.yearfrac(REF, RB_EXPIRY))
    out = {}

    def solve(prob, strat, cfg):
        t0 = time.perf_counter()
        sol = ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(), strat, cfg, device=device))
        price = float(sol.price)
        ens = sol.ensemble
        check(ens.shape == (2, cfg.trajectories) and ens.device.type == torch.device(device).type
              and bool(torch.isfinite(ens).all()), f"rough Bergomi solve: ensemble {tuple(ens.shape)}")
        return price, ens, time.perf_counter() - t0

    sigma = math.sqrt(RB_MARKET["xi0"])
    bs = float(ht.solve(ht.PricingProblem(rb_problem().payoff, ht.BlackScholesInputs(REF, R, SPOT,
                                                                                      sigma)),
                        ht.BlackScholesAnalytic()).price)
    f64_price, f64_ens, f64_s = solve(rb_problem(), ht.RoughBergomiMixing(),
                                      rb_config(RB_F64_PAIRS, True))
    f64_se = rb_se(f64_ens, RB_F64_PAIRS, disc)
    say(f"  float64 estimator (use_kernel=False, QMC, {RB_F64_PAIRS} pairs): {f64_price:.10f} "
        f"+- {f64_se:.3e} (SE, {f64_se / f64_price * 1e4:.4f} bp), host {f64_s:.3f} s")
    # the kernel route on the same QMC points: per path and in the mean at an
    # fp32 tolerance, which sees a scheme difference far below the 4-SE checks
    same_price, same_ens, _ = solve(rb_problem(), kernel, rb_config(RB_F64_PAIRS, True))
    say(f"  kernel solve on the same points ({RB_F64_PAIRS} pairs, QMC): {same_price:.10f}, "
        f"{(same_price - f64_price) / f64_price * 1e4:+.5f} bp from the float64 estimator "
        f"(limit {RB_F64_MEAN_RTOL * 1e4:g} bp)")
    same_err = compare_values("kernel solve against the float64 estimator per path (QMC)",
                              same_ens, f64_ens, RB_F64_TOL, mean_rtol=RB_F64_MEAN_RTOL)
    for point, dim in RB_UNIT_CELLS:  # the cells whose fp32 uniform rounds to 1.0
        got, want = same_ens[:, point].double(), f64_ens[:, point].double()
        rel = float(((got - want).abs() / want.abs().clamp(min=RB_F64_TOL["floor"])).max())
        say(f"  point {point} (Sobol' dim {dim} at u = 1.0 in fp32): kernel {got.tolist()} vs "
            f"float64 {want.tolist()}, rel {rel:.3e} (limit {RB_F64_TOL['rel']:g})")
        check(rel <= RB_F64_TOL["rel"], f"rough Bergomi: point {point} off the float64 estimator")
    del f64_ens, same_ens
    out["float64"] = dict(price=f64_price, se=f64_se, pairs=RB_F64_PAIRS,
                          kernel_same_points_bp=(same_price - f64_price) / f64_price * 1e4,
                          kernel_same_points_max_abs=same_err)
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        cfg = rb_config(pairs, qmc)
        call, ens_c, sec = solve(rb_problem(), kernel, cfg)
        se = rb_se(ens_c, pairs, disc)
        diff = call - f64_price
        lim = 4.0 * math.hypot(se, f64_se)
        say(f"  {stream}: price {call:.10f} (SE {se / call * 1e4:.4f} bp), host {sec:.3f} s; "
            f"against the float64 estimator {diff:+.3e} ({diff / f64_price * 1e4:+.4f} bp), "
            f"4 combined SE = {lim:.3e}")
        check(abs(diff) <= lim, f"rough Bergomi {stream}: kernel and float64 estimator disagree")
        put, ens_p, _ = solve(rb_problem("put"), kernel, cfg)
        parity = disc * (SPOT / disc - STRIKE)
        pse = rb_se(ens_c - ens_p, pairs, disc)
        say(f"  {stream} put-call parity: C - P = {call - put:.10f} vs DF (F - K) = {parity:.10f}, "
            f"err {call - put - parity:+.3e}, 4 SE = {4 * pse:.3e}")
        check(abs(call - put - parity) <= 4 * pse, f"rough Bergomi {stream}: parity fails")
        eta0, ens0, _ = solve(rb_problem(eta=0.0), kernel, cfg)
        lim0 = 4 * rb_se(ens0, pairs, disc) + RB_ETA0_ALLOWANCE_BP * 1e-4 * bs
        say(f"  {stream} eta = 0: {eta0:.10f} vs Black-Scholes at sigma {sigma:g} {bs:.10f}, err "
            f"{eta0 - bs:+.3e} ({(eta0 - bs) / bs * 1e4:+.4f} bp), 4 SE + "
            f"{RB_ETA0_ALLOWANCE_BP:g} bp = {lim0:.3e}")
        check(abs(eta0 - bs) <= lim0, f"rough Bergomi {stream}: eta = 0 is not Black-Scholes")
        out[stream] = dict(price=call, se=se, vs_float64_bp=diff / f64_price * 1e4,
                           parity_err=call - put - parity, parity_se=pse,
                           eta0_err_bp=(eta0 - bs) / bs * 1e4)

    # autograd through the kernel-backed solve (K14 forward, K17 backward)
    # against K16 over the same PRNG pairs
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (SPOT, RB_MARKET["xi0"], RB_MARKET["eta"], RB_MARKET["hurst"],
                        RB_MARKET["rho"], R)]
    spot, xi0, eta, hurst, rho, r = leaves
    prob = ht.PricingProblem(rb_problem().payoff,
                             ht.RoughBergomiInputs(REF, r, spot, xi0, eta, hurst, rho))
    t0 = time.perf_counter()
    sol = ht.solve(prob, ht.MonteCarlo(ht.RoughBergomiDynamics(), kernel, rb_config(pairs, False),
                                       device=device))
    g = torch.autograd.grad(sol.price, leaves)
    seconds = time.perf_counter() - t0
    grads = torch.stack([g[0], g[1], g[2], g[4], g[3], g[5]])  # GREEK_ORDER_RB
    price, greeks = rk.rbergomi_kernel_price_and_greeks(
        rb_problem(), rb_config(pairs, False), n_blocks=pairs // rk.PAIRS_PER_BLOCK, n_batches=1,
        device=device)
    greeks = torch.stack(list(greeks.values()))
    say(f"  autograd through solve (PRNG, {pairs} pairs): price {float(sol.price.detach()):.10f} "
        f"(K16 {float(price):.10f}), greeks {[round(float(x), 8) for x in grads]}, host "
        f"{seconds:.3f} s")
    compare_vectors("autograd through solve against K16 greeks", grads, greeks, AUTOGRAD_RTOL)
    out["autograd_s"] = seconds
    return out


def phase_rb_curve(device: str) -> dict:
    """``solve`` with RoughBergomiMixing(use_kernel=True) under the sloped
    forward-variance curve: on the float64 estimator's 2^20 QMC points its
    autograd (K14 forward, K18 backward) against the float64 estimator's in
    the three bucket vegas, spot, eta, H, rho and the rate; at 2^22 pairs on
    both streams its price within 4 combined SE of the float64 estimator and
    finite gradients through K18."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    say(f"phase 3 (rough Bergomi, forward-variance curve): tenors {RB_CURVE_TENORS}, levels "
        f"{RB_CURVE_LEVELS}; gradients of the kernel solve (K14 -> K18) against the float64 "
        f"estimator's within {RB_CURVE_GRAD_RTOL:g} of each plus of the largest "
        "(tests/test_torch_rbergomi_curve.py)")
    disc = float(ht.df(rb_problem().market_inputs.rate, RB_EXPIRY))
    names = [f"xi@{t:g}" for t in RB_CURVE_TENORS] + ["spot", "eta", "hurst", "rho", "rate"]

    def run(strat, cfg):
        xi = torch.tensor(RB_CURVE_LEVELS, dtype=torch.float64, requires_grad=True)
        scalars = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
                   for x in (SPOT, *RB_SCALARS)]
        spot, eta, hurst, rho, r = scalars
        market = ht.RoughBergomiInputs(REF, r, spot, ht.ForwardVarianceCurve(RB_CURVE_TENORS, xi),
                                       eta, hurst, rho)
        t0 = time.perf_counter()
        sol = ht.solve(ht.PricingProblem(rb_problem().payoff, market),
                       ht.MonteCarlo(ht.RoughBergomiDynamics(), strat, cfg, device=device))
        grads = torch.autograd.grad(sol.price, [xi, *scalars])
        seconds = time.perf_counter() - t0
        ens = sol.ensemble.detach()
        check(bool(torch.isfinite(ens).all()), "curve solve: non-finite values")
        return (float(sol.price.detach()), rb_se(ens, cfg.trajectories, disc),
                torch.cat([g.reshape(-1) for g in grads]).cpu(), seconds)

    kernel = ht.RoughBergomiMixing(use_kernel=True)
    f64_price, f64_se, f64_grads, f64_s = run(ht.RoughBergomiMixing(), rb_config(RB_F64_PAIRS, True))
    say(f"  float64 estimator (QMC, {RB_F64_PAIRS} pairs): {f64_price:.10f} +- {f64_se:.3e}, "
        f"gradients {dict(zip(names, (round(float(g), 8) for g in f64_grads)))}, host "
        f"{f64_s:.3f} s (forward + backward)")
    before = rk.RB_VJP_CURVE_KERNEL.launches
    k_price, _, k_grads, k_s = run(kernel, rb_config(RB_F64_PAIRS, True))
    check(rk.RB_VJP_CURVE_KERNEL.launches == before + 1, "the curve solve's backward ran no K18")
    rel = abs(k_price / f64_price - 1.0)
    say(f"  kernel solve on the same points: {k_price:.10f} (rel {rel:.3e}, limit "
        f"{RB_F64_MEAN_RTOL:g}), host {k_s:.3f} s (forward + backward)")
    check(rel <= RB_F64_MEAN_RTOL, "curve solve: kernel and float64 prices on the same points")
    err = compare_vectors("curve gradients: K14 -> K18 against the float64 estimator's autograd",
                          k_grads, f64_grads, RB_CURVE_GRAD_RTOL)
    out = dict(float64=dict(price=f64_price, se=f64_se, grads=f64_grads.tolist()),
               same_points=dict(price=k_price, grads=k_grads.tolist(), max_abs=err))
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        price, se, grads, seconds = run(kernel, rb_config(SOLVE_PAIRS, qmc))
        diff = price - f64_price
        lim = 4.0 * math.hypot(se, f64_se)
        say(f"  {stream}, {SOLVE_PAIRS} pairs: {price:.10f} (SE {se:.3e}), against the float64 "
            f"estimator {diff:+.3e}, 4 combined SE {lim:.3e}; gradients "
            f"{dict(zip(names, (round(float(g), 8) for g in grads)))}, host {seconds:.3f} s")
        check(abs(diff) <= lim, f"curve solve ({stream}): kernel and float64 estimator disagree")
        check(bool(torch.isfinite(grads).all()), f"curve solve ({stream}): non-finite gradients")
        out[stream] = dict(price=price, se=se, grads=grads.tolist(), host_s=seconds)
    return out


def phase_rb_smile(rb_path: dict, device: str) -> dict:
    """``rbergomi_kernel_smile`` (K19) on the 17-strike grid: at 2^24 pairs on
    both streams, calls falling in the strike and put-call parity per strike
    within 4 SE (the forward's SE from solve's call - put ensemble, scaled to
    2^24 pairs); on the float64 estimator's 2^20 QMC points, against its
    strike-grid solve within RB_F64_MEAN_RTOL of each plus of the largest."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs = RB_BLOCKS * RB_BATCHES * rk.PAIRS_PER_BLOCK
    say(f"phase 3 (rough Bergomi, smile): rbergomi_kernel_smile at {pairs} pairs x {RB_STEPS} "
        f"steps, strikes {CAL_STRIKES[0]:g}-{CAL_STRIKES[-1]:g}")
    disc = float(ht.df(rb_problem().market_inputs.rate, RB_EXPIRY))
    strikes = torch.tensor(CAL_STRIKES, dtype=torch.float64)
    out = {}
    for qmc in (True, False):
        stream = "QMC" if qmc else "PRNG"
        kw = dict(n_blocks=RB_BLOCKS, n_batches=RB_BATCHES, device=device)
        calls = rk.rbergomi_kernel_smile(rb_problem(), rb_config(pairs, qmc), CAL_STRIKES, **kw)
        puts = rk.rbergomi_kernel_smile(rb_problem("put"), rb_config(pairs, qmc), CAL_STRIKES, **kw)
        calls, puts = calls.cpu(), puts.cpu()
        check(bool(torch.isfinite(calls).all() and torch.isfinite(puts).all()),
              f"smile ({stream}): non-finite prices")
        check(bool((calls[1:] < calls[:-1]).all()), f"smile ({stream}): calls not falling in K")
        parity_err = calls - puts - (SPOT - disc * strikes)
        se = rb_path[stream]["parity_se"] * math.sqrt(SOLVE_PAIRS / pairs)
        worst = float(parity_err.abs().max())
        say(f"  {stream}: calls {[round(float(c), 6) for c in calls]}; C - P - DF (F - K) within "
            f"{worst:.3e} over the strikes (4 SE = {4 * se:.3e})")
        check(worst <= 4 * se, f"smile ({stream}): put-call parity fails")
        out[stream] = dict(calls=calls.tolist(), parity_err=worst, parity_se=se)
    grid = ht.PricingProblem(ht.VanillaOption(strikes, RB_EXPIRY), rb_problem().market_inputs)
    f64 = ht.solve(grid, ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(),
                                       rb_config(RB_F64_PAIRS, True), device=device)).price
    same = rk.rbergomi_kernel_smile(rb_problem(), rb_config(RB_F64_PAIRS, True), CAL_STRIKES,
                                    n_blocks=RB_F64_PAIRS // rk.PAIRS_PER_BLOCK, n_batches=1,
                                    device=device)
    err = compare_vectors(f"K19 against the float64 estimator's strike grid ({RB_F64_PAIRS} QMC "
                          "pairs, the same points)", same, f64, RB_F64_MEAN_RTOL)
    out["float64_same_points_max_abs"] = err
    return out


def rb_surface_allowance(market) -> list:
    """Per expiry and strike, the scheme gap between the surface's grid up to
    that expiry and K19's uniform grid with as many steps, measured on the
    CPU on coupled paths: the float64 surface over the expiries up to it
    against the one-expiry surface with the same step count (the same
    Sobol' points feed the same roles, so the gap is the grids', not noise).
    The first expiry's grid is uniform already: its gap is 0."""
    import torch

    import hedgehog_tpu_torch as ht

    steps = rb_surface_steps()
    rows = [torch.zeros(len(SURF_STRIKES), dtype=torch.float64)]
    for i in range(1, len(SURF_EXPIRIES)):
        cfg = ht.SimulationConfig(RB_ALLOWANCE_PAIRS, steps[i], ht.Antithetic(), 0, True)
        multi = ht.rbergomi_surface_mc(market, SURF_EXPIRIES[: i + 1], SURF_STRIKES, cfg,
                                       device="cpu")[i]
        single = ht.rbergomi_surface_mc(market, SURF_EXPIRIES[i: i + 1], SURF_STRIKES, cfg,
                                        device="cpu")[0]
        rows.append((multi - single).abs())
    return rows


def rb_surface_steps() -> list:
    """The steps of the rough-Bergomi surface's grid up to each expiry: K19's
    step count at that expiry."""
    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.methods.rough_bergomi_surface import surface_times

    _, idx = surface_times([float(ht.yearfrac(REF, e)) for e in SURF_EXPIRIES], RB_SURF_STEPS)
    return [k + 1 for k in idx]


def phase_rb_surface(device: str) -> dict:
    """The float64 ``rbergomi_surface_mc`` on the card (PRNG, 8 seeds of 2^19
    pairs, 128 steps over the 3 x 5 surface grid) against K19 at each expiry
    with the surface's step count there (8 seeds of 2^21 pairs): each point
    within 4 combined SE plus the CPU's coupled scheme gap; then
    d(sum surface)/dH finite on the card."""
    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    market = rb_problem().market_inputs
    steps = rb_surface_steps()
    say(f"phase 3 (rough Bergomi, surface): rbergomi_surface_mc float64 on {device}, "
        f"{len(SURF_EXPIRIES)} x {len(SURF_STRIKES)} points, {RB_SURF_STEPS} steps (grid steps to "
        f"each expiry {steps}), {RB_SURF_SEEDS} PRNG seeds of {RB_SURF_PAIRS} pairs; K19 at each "
        f"expiry with those steps, {RB_SURF_SEEDS} seeds of "
        f"{RB_SURF_SMILE_BLOCKS * rk.PAIRS_PER_BLOCK} pairs")
    t0 = time.perf_counter()
    allowance = torch.stack(rb_surface_allowance(market))
    say(f"  scheme allowance (CPU, coupled QMC paths, {RB_ALLOWANCE_PAIRS} pairs; "
        f"{time.perf_counter() - t0:.1f} s): {[[float(f'{x:.3e}') for x in row] for row in allowance]}")
    t0 = time.perf_counter()
    surfs = torch.stack([ht.rbergomi_surface_mc(
        market, SURF_EXPIRIES, SURF_STRIKES,
        ht.SimulationConfig(RB_SURF_PAIRS, RB_SURF_STEPS, ht.Antithetic(), 100 + s, False),
        device=device).cpu() for s in range(RB_SURF_SEEDS)])
    torch.cuda.synchronize()
    surf_s = time.perf_counter() - t0
    smiles = torch.stack([torch.stack([rk.rbergomi_kernel_smile(
        ht.PricingProblem(ht.VanillaOption(STRIKE, e), market),
        ht.SimulationConfig(RB_SURF_SMILE_BLOCKS * rk.PAIRS_PER_BLOCK, n, ht.Antithetic(), 200 + s,
                            False), SURF_STRIKES,
        n_blocks=RB_SURF_SMILE_BLOCKS, n_batches=1, device=device).cpu()
        for e, n in zip(SURF_EXPIRIES, steps)]) for s in range(RB_SURF_SEEDS)])
    check(bool(torch.isfinite(surfs).all() and torch.isfinite(smiles).all()),
          "surface: non-finite prices")
    surf, smile = surfs.mean(dim=0), smiles.mean(dim=0)
    se = torch.hypot(surfs.std(dim=0), smiles.std(dim=0)) / math.sqrt(RB_SURF_SEEDS)
    diff = surf - smile
    ratio = diff.abs() / (4 * se + allowance)
    say(f"  surface ({surf_s:.2f} s for {RB_SURF_SEEDS} surfaces): "
        f"{[[round(float(x), 6) for x in row] for row in surf]}")
    bp = diff / smile * 1e4
    say(f"  surface - K19 in bp: {[[round(float(x), 3) for x in row] for row in bp]}; worst "
        f"|diff| / (4 combined SE + allowance) {float(ratio.max()):.3f}")
    check(bool((ratio <= 1.0).all()), "surface: a point off K19 beyond 4 SE + the scheme allowance")
    hurst = torch.tensor(RB_MARKET["hurst"], dtype=torch.float64, requires_grad=True)
    small = ht.RoughBergomiInputs(REF, R, SPOT, RB_MARKET["xi0"], RB_MARKET["eta"], hurst,
                                  RB_MARKET["rho"])
    total = ht.rbergomi_surface_mc(small, SURF_EXPIRIES, SURF_STRIKES,
                                   ht.SimulationConfig(2**16, RB_SURF_STEPS, ht.Antithetic(), 1,
                                                       False), device=device).sum()
    (g,) = torch.autograd.grad(total, hurst)
    say(f"  d(sum surface)/dH on {device} (2^16 pairs): {float(g):.6f}")
    check(bool(torch.isfinite(g)), "surface: non-finite dH")
    return dict(surface=surf.tolist(), vs_k19_bp=bp.tolist(),
                worst_ratio=float(ratio.max()), allowance=allowance.tolist(), surface_s=surf_s,
                d_sum_dH=float(g))


def phase_rb_serving(f64: dict, device: str) -> dict:
    """6 timed dispatches of K15 at 2^24 pairs x 64 steps (bench.py:692) and
    of K16 at the same shape: ms, paths/s, the price against the float64
    estimator, the greek-vector / price ratio, and K16's spot, xi0 and rate
    greeks against central differences of K15 on the same stream."""
    import torch

    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs = RB_BLOCKS * RB_BATCHES * rk.PAIRS_PER_BLOCK
    say(f"phase 4 (rough Bergomi): serving dispatch, {pairs} antithetic pairs ({2 * pairs} paths) "
        f"x {RB_STEPS} steps per call")
    cfg = rb_config(pairs, False)
    ins = rk._rb_trace_inputs(rb_problem(), cfg, 64)
    g_ins = rk._rb_greek_trace_inputs(rb_problem(), cfg, 64)
    kw = dict(n_blocks=RB_BLOCKS, n_batches=RB_BATCHES, steps=RB_STEPS, device=device)

    ms, prices = serving_dispatches(
        lambda seed: rk.rbergomi_mixing_vanilla_price(*ins.price_args(), seed=seed, **kw))
    g_ms, outs = serving_dispatches(
        lambda seed: rk.rbergomi_mixing_price_and_greeks(*g_ins, seed=seed, **kw))
    values = [float(p) for p in prices]
    check(all(math.isfinite(v) for v in values), "rough Bergomi serving: non-finite price")
    check([float(p) for p, _ in outs] == values, "rough Bergomi serving: K16 prices differ from K15's")
    mc = sum(values) / len(values)
    diff_bp = (mc - f64["price"]) / f64["price"] * 1e4
    paths_per_s = 2 * pairs / (ms * 1e-3)
    ratio = g_ms / ms
    t0 = time.perf_counter()  # one more dispatch on the host clock: the idle share
    rk.rbergomi_mixing_vanilla_price(*ins.price_args(), seed=SERVING_REPS + 1, **kw)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    say(f"  {SERVING_REPS} reps: {ms:.3f} ms per call, {paths_per_s:.6e} paths/s, price {mc:.10f} "
        f"vs the float64 estimator {f64['price']:.10f}: {diff_bp:+.4f} bp (its SE "
        f"{f64['se'] / f64['price'] * 1e4:.4f} bp); one synchronised dispatch {wall_ms:.3f} ms of "
        f"host time, idle share {1.0 - ms / wall_ms:.3f}")
    say(f"  for comparison only: {TPU_RB_SERVING}; one pair a thread (PERF.md): "
        f"{ONE_PAIR_A_THREAD_RB_SERVING}")
    check(abs(mc - f64["price"]) <= 4 * f64["se"] + 1e-7 * mc,
          "rough Bergomi serving: the price disagrees with the float64 estimator")
    say(f"  price + 6 greeks: {g_ms:.3f} ms per call; greek-vector / price time ratio {ratio:.4f}; "
        f"K16 prices equal K15's on all {SERVING_REPS} seeds")
    greeks = dict(zip(rk.GREEK_ORDER_RB, (float(x) for x in outs[0][1])))
    say(f"  greeks (seed 1): {greeks}")

    def price_at(name, h):
        spot, xi0, rate = SPOT, RB_MARKET["xi0"], R
        spot += h if name == "spot" else 0.0
        xi0 += h if name == "xi0" else 0.0
        rate += h if name == "rate" else 0.0
        import hedgehog_tpu_torch as ht

        market = ht.RoughBergomiInputs(REF, rate, spot, xi0, RB_MARKET["eta"], RB_MARKET["hurst"],
                                       RB_MARKET["rho"])
        p_ins = rk._rb_trace_inputs(ht.PricingProblem(rb_problem().payoff, market), cfg, 64)
        return float(rk.rbergomi_mixing_vanilla_price(*p_ins.price_args(), seed=1, **kw))

    for name, h, rtol in RB_FD_CHECKS:
        fd = (price_at(name, h) - price_at(name, -h)) / (2 * h)
        say(f"  {name}: K16 {greeks[name]:.8f} vs central difference of K15 (h={h:g}, same stream) "
            f"{fd:.8f} (rtol {rtol:g})")
        check(abs(greeks[name] - fd) <= rtol * abs(fd), f"rough Bergomi serving: {name} greek")

    # K19: the 17-strike smile from one dispatch of the same shape; its strike
    # 100 is K15's price on the same seed
    smile_args = (*ins.price_args()[:5], CAL_STRIKES, ins.cp, ins.rho, ins.discount)
    s_ms, smiles = serving_dispatches(
        lambda seed: rk.rbergomi_mixing_smile_price(*smile_args, seed=seed, **kw))
    at_k = CAL_STRIKES.index(STRIKE)
    check([float(s[at_k]) for s in smiles] == values,
          "rough Bergomi serving: K19's strike 100 differs from K15's price")
    check(all(bool(torch.isfinite(s).all()) for s in smiles), "rough Bergomi serving: K19 prices")
    s_ratio = s_ms / ms
    say(f"  smile, {len(CAL_STRIKES)} strikes: {s_ms:.3f} ms per call, {2 * pairs / (s_ms * 1e-3):.6e} "
        f"paths/s, {len(CAL_STRIKES) * 2 * pairs / (s_ms * 1e-3):.6e} point-paths/s; K19 / K15 time "
        f"ratio {s_ratio:.4f}; its K = {STRIKE:g} price equals K15's on all {SERVING_REPS} seeds")

    # K18 at solve's shape (the backward of a curve solve) beside K17 (of a
    # scalar-xi0 solve), under solve's cotangent
    disc = ins.discount
    ct = torch.full((2, SOLVE_PAIRS), disc / (2 * SOLVE_PAIRS), dtype=torch.float32,
                    device=device)
    c_inp = rk.rb_vjp_inputs(SPOT, RB_CURVE, *RB_SCALARS, ins.T, STRIKE, 1.0, steps=RB_STEPS,
                             seed=0, qmc=False, device=device)
    _, v_inp = rb_device_inputs(SOLVE_PAIRS, False, 0, device, tangent=True, vjp=True)
    ms18 = time_ms(lambda: rk._rb_vjp_sums(c_inp, ct, SOLVE_PAIRS, True, 0, 0, 0, per_step=True))
    ms17 = time_ms(lambda: rk._rb_vjp_sums(v_inp, ct, SOLVE_PAIRS, True, 0, 0, 0))
    say(f"  backward at solve's {SOLVE_PAIRS} pairs (PRNG): K18 (curve) {ms18:.4f} ms, K17 (scalar "
        f"xi0) {ms17:.4f} ms, K18 / K17 {ms18 / ms17:.4f}")
    return dict(ms=ms, paths_per_s=paths_per_s, price=mc, vs_float64_bp=diff_bp, greeks_ms=g_ms,
                greek_price_ratio=ratio, greeks=greeks, wall_ms=wall_ms, smile_ms=s_ms,
                smile_price_ratio=s_ratio, k18_solve_ms=ms18, k17_solve_ms=ms17)


def kernel_name(mangled: str) -> str:
    """The ``..._kernel`` identifier in a mangled entry name (a length
    prefix then the identifier), with its bool and int template arguments
    where it has them (``<true>``: the staged Sobol' table, or K14-K19 past
    the staged steps; K5's and K7's ``<staged, qmc>``), else
    the name itself."""
    for found in re.finditer(r"\d+", mangled):
        for i in range(found.start(), found.end()):
            n = int(mangled[i:found.end()])
            ident = mangled[found.end():found.end() + n]
            if len(ident) == n and ident.endswith("kernel"):
                m = re.match(r"I((?:L[bi]\d+E)+)E", mangled[found.end() + n:])
                args = [("false", "true")[int(v)] if k == "b" else v
                        for k, v in re.findall(r"L([bi])(\d+)E", m.group(1) if m else "")]
                return ident + (f"<{', '.join(args)}>" if args else "")
    return mangled[:60]


def output_digests(device: str) -> dict:
    """The sha256 of each kernel's output bytes at ``CHECK_PAIRS`` antithetic
    pairs, seed 5, on every stream the kernel draws: phase 2's calls through
    the same entry points, without the twins.  The kernels the imported
    package lacks are left out, so two trees compare on what both have.  K4
    runs at the grid of the one-pair-a-thread kernel (``K4 QMC``, to
    compare with trees before the two-threads-a-pair K4) and, where the
    package takes a grid, at its own resident grid (``K4 QMC resident``):
    the float64 sums of the 3 x 5 surface at 2^20 and 2^26 pairs.  K9 and
    K12 run through the public wrappers at the package's grid (``K9 QMC``,
    whose last bits move with the grid) and their float64 sums at
    ``K9_PARENT_BLOCKS`` an SM (``K9 QMC sums``, ``K12 QMC sums``...),
    comparable with every tree since K9's redesign.  K1 and K2 run also at
    ``solve``'s pairs (2^23, 2^22) and at ``EDGE_STEPS`` / ``EDGE_SEGMENTS``
    over ``EDGE_PAIRS``, both pairings (K2 from ``EDGE_OFFSET``), and K2
    and K3 at 160 and 252 of ``EXACT_BAND_SEGMENTS`` under QMC; K9's and
    K12's float64 sums also at ``ODD_SURF_STEPS``.  K14 and
    K17 run also at ``solve``'s 2^22 pairs and at ``RB_EDGE_STEPS`` over
    ``RB_EDGE_PAIRS`` (a ragged last trip), antithetic and one group (K17
    at 2 steps and more), through entry points every tree since their
    port has.  K7 and K5 run also at ``solve``'s pairs (2^22, 2^23), at
    ``EDGE_STEPS`` over ``EDGE_PAIRS`` from ``EDGE_OFFSET``, both pairings
    (K5 also without the martingale correction), and under QMC at
    ``QE_BAND_STEPS`` / ``QEM_BAND_STEPS`` and ``GLOBAL_QE_STEPS`` /
    ``GLOBAL_QEM_STEPS`` (``GLOBAL_TWIN_PAIRS`` + 7 pairs from
    ``EDGE_OFFSET``).  K11 runs also at ``solve``'s 2^22 pairs, at
    ``EDGE_STEPS`` over ``EDGE_PAIRS`` from ``EDGE_OFFSET`` (both pairings
    under PRNG, antithetic under QMC) and under QMC at ``QE_BAND_STEPS`` and
    ``GLOBAL_QE_STEPS`` (``GLOBAL_TWIN_PAIRS`` + 7 pairs from
    ``EDGE_OFFSET``), each under a smooth cotangent, and the gradients of
    ``torch.autograd.grad`` through the QE mixing ``solve`` (K7 forward, K11
    backward) at 2^22 pairs."""
    import hashlib

    import torch

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import gbm_kernel as gbk
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_kernel as hk
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    dev, pairs, seed, mkt = torch.device(device), CHECK_PAIRS, 5, MARKET_ARGS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}

    def put(key, *outputs):
        h = hashlib.sha256()
        for x in outputs:
            x = x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float64)
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        out[key] = h.hexdigest()

    T = float(ht.yearfrac(REF, EXPIRY))
    disc, dt_q, dt_m = math.exp(-R * T), T / QE_STEPS, T / QEM_STEPS
    blocks = pairs // (4 * qk.PAIRS_PER_BLOCK)  # x 4 batches
    T_host, discs, qe_seg, ex_seg = surface_grid()
    surf = surface_inputs(dev)
    vjp_table, greek_table = (
        torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                        HESTON["sigma"], dt_q, QE_STEPS, n), device=dev)
        for n in (5, 4))

    def at_grid(fn, blocks_per_sm):
        """``grid=`` at ``blocks_per_sm`` an SM where ``fn`` takes a grid (a
        tree before the redesign runs its own, which is that grid)."""
        return ({"grid": blocks_per_sm * sms} if "grid" in inspect.signature(fn).parameters
                else {})

    def smooth_ct(n):
        return (0.5 + 0.5 * torch.sin(torch.arange(2 * n, device=dev, dtype=torch.float32))
                ).reshape(2, n)

    def vjp_table_at(steps):
        return torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                               HESTON["sigma"], T / steps, steps, 5), device=dev)

    ct, ct22, ct_edge = smooth_ct(pairs), smooth_ct(SOLVE_PAIRS), smooth_ct(EDGE_PAIRS)
    ct_band = smooth_ct(GLOBAL_TWIN_PAIRS + 7)
    put("K1 PRNG", hk.heston_euler_terminal(*mkt, T / EULER_STEPS, n_paths=pairs, steps=EULER_STEPS,
                                            seed=seed, antithetic=True, device=dev))
    # K1 at solve's pairs, and at odd step counts over a ragged last block,
    # both pairings
    put("K1 PRNG 2^23", hk.heston_euler_terminal(*mkt, T / EULER_STEPS, n_paths=EULER_PAIRS,
                                                 steps=EULER_STEPS, seed=seed, antithetic=True,
                                                 device=dev))
    for steps in EDGE_STEPS:
        pe = torch.as_tensor(hk._euler_params(*mkt, T / steps), device=dev)
        for anti in (True, False):
            put(f"K1 PRNG {steps} steps{'' if anti else ' one group'}",
                hk._euler_terminal(pe, EDGE_PAIRS, steps, seed, anti, 0))
    put("K6 PRNG", qk.heston_qe_call_price(*mkt, dt_m, STRIKE, disc, n_blocks=blocks, n_batches=4,
                                           steps=QEM_STEPS, seed=seed, device=dev))
    # K6's float64 sums at the grid of the one-pair-a-thread K6
    # (K6_PARENT_BLOCKS an SM), the bits every tree since its port gives
    p15 = torch.as_tensor(qk._qem_params(*mkt, dt_m, strike=STRIKE), device=dev)
    for label, n in (("", pairs), (" 2^27", SERVING_PAIRS)):
        put(f"K6 PRNG{label} sums", qk._qem_price_sum(
            p15, n, QEM_STEPS, seed, 0, **at_grid(qk._qem_price_sum, K6_PARENT_BLOCKS)))
    put("K13 PRNG", gbk.gbm_exact_terminal(*lognormal_law(T), n_paths=pairs, seed=seed,
                                           antithetic=True, device=dev))
    for qmc in (True, False):
        s = "QMC" if qmc else "PRNG"
        kw = dict(seed=seed, qmc=qmc, device=dev)
        put(f"K2 {s}", ek.heston_exact_mixing_values(*mkt, T / SEGMENTS, STRIKE, 1.0, n_paths=pairs,
                                                     segments=SEGMENTS, antithetic=True, **kw))
        # K2 at solve's pairs, and at 1-3 segments over a ragged pair count
        # from a point offset off the 32-point cells, both pairings
        put(f"K2 {s} 2^22", ek.heston_exact_mixing_values(
            *mkt, T / SEGMENTS, STRIKE, 1.0, n_paths=SOLVE_PAIRS, segments=SEGMENTS,
            antithetic=True, **kw))
        for segs in EDGE_SEGMENTS:
            px, tx, kmax = ek._inputs(*mkt, T / segs, STRIKE, 1.0, segs, seed, qmc, dev)
            for anti in (True, False):
                put(f"K2 {s} {segs} segments{'' if anti else ' one group'}",
                    ek._exact_values(px, tx, EDGE_PAIRS, segs, anti, kmax, seed, 0, EDGE_OFFSET))
        # K2 and K3 past the staging decision, where the table (and, at 252
        # segments, the split draw's high words) once fitted a block
        # (K3's sums at its fixed grid)
        mkt_b = mkt[:5] + (GLOBAL_EXACT_SIGMA, mkt[6])
        for segs in EXACT_BAND_SEGMENTS[2:4] if qmc else ():
            px, tx, kmax = ek._inputs(*mkt_b, GLOBAL_EXACT_YEARS / GLOBAL_EXACT_SEGMENTS, STRIKE,
                                      1.0, segs, seed, True, dev)
            put(f"K2 QMC {segs} segments",
                ek._exact_values(px, tx, EDGE_PAIRS, segs, True, kmax, seed, 0, EDGE_OFFSET))
            put(f"K3 QMC {segs} segments sums",
                ek._exact_price_sum(px, tx, EDGE_PAIRS, segs, kmax, seed, 0, EDGE_OFFSET))
        put(f"K3 {s}", ek.heston_exact_mixing_vanilla_price(*mkt, T / SEGMENTS, STRIKE, disc,
                                                            n_blocks=blocks, n_batches=4,
                                                            segments=SEGMENTS, **kw))
        put(f"K5 {s}", qk.heston_qe_terminal(*mkt, dt_m, n_paths=pairs, steps=QEM_STEPS,
                                             antithetic=True, **kw))
        put(f"K7 {s}", qk.heston_qe_mixing_values(*mkt, dt_q, STRIKE, 1.0, n_paths=pairs,
                                                  steps=QE_STEPS, antithetic=True, **kw))
        # K7 and K5 at solve's pairs; at EDGE_STEPS over a ragged pair count from
        # a point offset off the 32-point cells, both pairings (K5 also without
        # the martingale correction); under QMC on both sides of their staging
        # decision and past the staging limit
        put(f"K7 {s} 2^22", qk.heston_qe_mixing_values(*mkt, dt_q, STRIKE, 1.0,
                                                       n_paths=SOLVE_PAIRS, steps=QE_STEPS,
                                                       antithetic=True, **kw))
        put(f"K5 {s} 2^23", qk.heston_qe_terminal(*mkt, dt_m, n_paths=QEM_SOLVE_PAIRS,
                                                  steps=QEM_STEPS, antithetic=True, **kw))
        for steps in EDGE_STEPS:
            p7, t7 = qk.mix_inputs(*mkt, T / steps, STRIKE, 1.0, steps, seed, qmc, dev)
            p5, t5 = qk.qem_inputs(*mkt, T / steps, steps, seed, qmc, dev)
            for anti in (True, False):
                label = f"{steps} steps{'' if anti else ' one group'}"
                put(f"K7 {s} {label}",
                    qk._qe_values(p7, t7, EDGE_PAIRS, steps, anti, seed, 0, EDGE_OFFSET))
                put(f"K5 {s} {label}",
                    qk._qem_terminal(p5, t5, EDGE_PAIRS, steps, anti, True, seed, 0, EDGE_OFFSET))
                if anti or not qmc:
                    put(f"K11 {s} {label}", gk._vjp_sums(
                        p7, vjp_table_at(steps), t7, ct_edge[:1 + anti].contiguous(),
                        EDGE_PAIRS, steps, anti, seed, 0, EDGE_OFFSET))
            put(f"K5 {s} {steps} steps no mcorr",
                qk._qem_terminal(p5, t5, EDGE_PAIRS, steps, True, False, seed, 0, EDGE_OFFSET))
        for steps in (*QE_BAND_STEPS, GLOBAL_QE_STEPS) if qmc else ():
            p7, t7 = qk.mix_inputs(*mkt, T / steps, STRIKE, 1.0, steps, seed, True, dev)
            put(f"K7 QMC {steps} steps",
                qk._qe_values(p7, t7, GLOBAL_TWIN_PAIRS + 7, steps, True, seed, 0, EDGE_OFFSET))
            put(f"K11 QMC {steps} steps",
                gk._vjp_sums(p7, vjp_table_at(steps), t7, ct_band, GLOBAL_TWIN_PAIRS + 7, steps,
                             True, seed, 0, EDGE_OFFSET))
        for steps in (*QEM_BAND_STEPS, GLOBAL_QEM_STEPS) if qmc else ():
            p5, t5 = qk.qem_inputs(*mkt, T / steps, steps, seed, True, dev)
            put(f"K5 QMC {steps} steps", qk._qem_terminal(p5, t5, GLOBAL_TWIN_PAIRS + 7, steps,
                                                          True, True, seed, 0, EDGE_OFFSET))
        price_kw = dict(n_blocks=blocks, n_batches=4, steps=QE_STEPS, **kw)
        put(f"K8 {s}", qk.heston_qe_mixing_vanilla_price(*mkt, dt_q, STRIKE, disc, **price_kw))
        put(f"K10 {s}", *gk.heston_qe_mixing_price_and_greeks(*mkt, dt_q, STRIKE, disc, **price_kw))
        params, table = qk.mix_inputs(*mkt, dt_q, STRIKE, 1.0, QE_STEPS, seed, qmc, dev)
        # K3's, K10's and K8's float64 sums at the grids before their
        # redesign (K3_PARENT_BLOCKS and K8_BLOCKS an SM), the bits every
        # tree since their port gives; the public outputs above are at the
        # package's grid (K8's, and K10's with it, did not move)
        px, tx, kmax = ek._inputs(*mkt, T / SEGMENTS, STRIKE, 1.0, SEGMENTS, seed, qmc, dev)
        for label, n in (("", pairs), (" 2^27", SERVING_PAIRS)):
            put(f"K3 {s}{label} sums", ek._exact_price_sum(
                px, tx, n, SEGMENTS, kmax, seed, 0, 0, **at_grid(ek._exact_price_sum,
                                                                 K3_PARENT_BLOCKS)))
            put(f"K10 {s}{label} sums", gk._greek_sums(
                params, greek_table, table, n, QE_STEPS, seed, 0, 0,
                **at_grid(gk._greek_sums, K8_BLOCKS)))
            put(f"K8 {s}{label} sums", qk._qe_price_sum(
                params, table, n, QE_STEPS, seed, 0, 0, **at_grid(qk._qe_price_sum, K8_BLOCKS)))
        put(f"K11 {s}", gk._vjp_sums(params, vjp_table, table, ct, pairs, QE_STEPS, True, seed, 0, 0))
        put(f"K11 {s} 2^22", gk._vjp_sums(params, vjp_table, table, ct22, SOLVE_PAIRS, QE_STEPS,
                                          True, seed, 0, 0))
        # the gradients of autograd through the QE mixing solve (K7 forward,
        # K11 backward) in its seven market leaves
        leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in PARAMS7]
        spot, v0, kappa, theta, sigma, rho, r = leaves
        sol = ht.solve(ht.PricingProblem(
            ht.VanillaOption(STRIKE, EXPIRY, ht.European(), ht.Call(), ht.Spot()),
            ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)),
            ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True, use_kernel=True),
                          ht.SimulationConfig(SOLVE_PAIRS, QE_STEPS, ht.Antithetic(), seed, qmc),
                          device=device))
        put(f"K11 {s} autograd", torch.stack(torch.autograd.grad(sol.price, leaves)))
        surf_kw = dict(n_strikes=len(SURF_STRIKES), n_blocks=pairs // qk.PAIRS_PER_BLOCK,
                       n_batches=1, **kw)
        # the public surface wrappers at the package's grid (its last bits
        # move with the grid: 528 blocks on an H100 before K12's redesign,
        # 1584 after)
        put(f"K9 {s}", qk.heston_qe_mixing_surface_price(*mkt, T_host, SURF_STRIKES, discs,
                                                         seg_steps=qe_seg, **surf_kw))
        put(f"K12 {s}", *gk.heston_qe_mixing_surface_price_and_jacobian(
            *mkt, T_host, SURF_STRIKES, discs, seg_steps=qe_seg, **surf_kw))
        # K9's and K12's float64 sums at the grid before K12's redesign, the
        # bits every tree since K9's redesign gives
        t9 = torch.as_tensor(qk.sobol_table(seed, 2 * sum(qe_seg)), device=dev) if qmc else None
        at = ({"grid": K9_PARENT_BLOCKS * sms}
              if "grid" in inspect.signature(qk._qe_surface_sums).parameters else {})
        for label, n in (("", pairs), (" 2^26", SURF_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK)):
            put(f"K9 {s}{label} sums", qk._qe_surface_sums(surf["p9"], t9, qe_seg,
                                                           len(SURF_STRIKES), n, seed, 0, 0, **at))
        put(f"K12 {s} sums", gk._surface_jac_sums(surf["p9"], surf["dct"], surf["djt"], t9, qe_seg,
                                                  len(SURF_STRIKES), pairs, seed, 0, 0, **at))
        if at:  # K12 at 2^26 pairs and at the 3 x 17 calibration shape, the same grid
            put(f"K12 {s} 2^26 sums", gk._surface_jac_sums(
                surf["p9"], surf["dct"], surf["djt"], t9, qe_seg, len(SURF_STRIKES),
                SURF_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK, seed, 0, 0, **at))
            cal = calibration_inputs(dev, qmc, seed)
            put(f"K12 {s} 3x17 sums", gk._surface_jac_sums(*cal["jac"], pairs, seed, 0, 0, **at))
            put(f"K9 {s} 3x17 sums", qk._qe_surface_sums(*cal["price"], pairs, seed, 0, 0, **at))
        # both at odd step splits over the expiries, where a segment ends
        # inside a Philox block (draw_steps carries its second normal on)
        odd_seg = ODD_SURF_STEPS
        p_odd = torch.as_tensor(qk._surf_params(*mkt, T_host, odd_seg, SURF_STRIKES, 1.0),
                                device=dev)
        dct_odd, djt_odd = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                            for t in gk._surface_greek_tables(*mkt[3:6], T_host, odd_seg))
        t_odd = torch.as_tensor(qk.sobol_table(seed, 2 * sum(odd_seg)), device=dev) if qmc else None
        run_odd = (t_odd, odd_seg, len(SURF_STRIKES), EDGE_PAIRS, seed, 0, 0)
        put(f"K9 {s} {odd_seg} sums", qk._qe_surface_sums(p_odd, *run_odd))
        put(f"K12 {s} {odd_seg} sums", gk._surface_jac_sums(p_odd, dct_odd, djt_odd, *run_odd))
        t4 = torch.as_tensor(qk.sobol_table(seed, 4 * sum(ex_seg)), device=dev) if qmc else None
        for label, n in (("", pairs), (" 2^26", SURF_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK)):
            run4 = (surf["p4"], t4, ex_seg, surf["kmaxes"], len(SURF_STRIKES), n, seed, 0, 0)
            if "grid" in inspect.signature(ek._exact_surface_sums).parameters:
                put(f"K4 {s}{label} resident", ek._exact_surface_sums(*run4))
                put(f"K4 {s}{label}", ek._exact_surface_sums(
                    *run4, grid=K4_ONE_PAIR_A_THREAD_BLOCKS * sms))
            else:  # a tree whose K4 takes no grid: one pair a thread
                put(f"K4 {s}{label}", ek._exact_surface_sums(*run4))
        ins, inp = rb_device_inputs(pairs, qmc, seed, dev, tangent=False)
        g_ins, _ = rb_device_inputs(pairs, qmc, seed, dev, tangent=True)
        _, v_inp = rb_device_inputs(pairs, qmc, seed, dev, tangent=True, vjp=True)
        rb_kw = dict(n_blocks=pairs // rk.PAIRS_PER_BLOCK, n_batches=1, steps=RB_STEPS, **kw)
        put(f"K14 {s}", rk.rbergomi_mixing_values(*ins.values_args(), n_paths=pairs, steps=RB_STEPS,
                                                  antithetic=True, **kw))
        put(f"K15 {s}", rk.rbergomi_mixing_vanilla_price(*ins.price_args(), **rb_kw))
        put(f"K16 {s}", *rk.rbergomi_mixing_price_and_greeks(*g_ins, **rb_kw))
        _, g24 = rb_device_inputs(RB_BLOCKS * RB_BATCHES * rk.PAIRS_PER_BLOCK, qmc, seed, dev,
                                  tangent=True)
        put(f"K16 {s} 2^24", rk._rb_greek_sums(g24, RB_BLOCKS * RB_BATCHES * rk.PAIRS_PER_BLOCK,
                                               seed, 0, 0))
        for steps in RB_EDGE_STEPS:  # the chunked product's edges, a ragged last trip
            cfg = ht.SimulationConfig(RB_EDGE_PAIRS, steps, ht.Antithetic(), seed, qmc)
            e_inp = rk.rb_inputs_from_trace(rk._rb_greek_trace_inputs(rb_problem(), cfg, 64),
                                            seed=seed, qmc=qmc, device=dev)
            put(f"K16 {s} {steps} steps", rk._rb_greek_sums(e_inp, RB_EDGE_PAIRS, seed, 0, 0))
        put(f"K17 {s}", rk._rb_vjp_sums(v_inp, ct, pairs, True, seed, 0, 0))
        # K14 and K17 at solve's pairs, and at the chunked product's edges with
        # a ragged last trip, antithetic and one group
        _, inp22 = rb_device_inputs(SOLVE_PAIRS, qmc, seed, dev, tangent=False)
        _, v22 = rb_device_inputs(SOLVE_PAIRS, qmc, seed, dev, tangent=True, vjp=True)
        ct22 = torch.full((2, SOLVE_PAIRS), 0.5 / SOLVE_PAIRS, device=dev)
        put(f"K14 {s} 2^22", rk._rb_values(inp22, SOLVE_PAIRS, True, seed, 0, 0))
        put(f"K17 {s} 2^22", rk._rb_vjp_sums(v22, ct22, SOLVE_PAIRS, True, seed, 0, 0))
        for steps in RB_EDGE_STEPS:
            cfg = ht.SimulationConfig(RB_EDGE_PAIRS, steps, ht.Antithetic(), seed, qmc)
            e_inp = rk.rb_inputs_from_trace(rk._rb_trace_inputs(rb_problem(), cfg, 64), seed=seed,
                                            qmc=qmc, device=dev)
            v_e = rk.rb_vjp_inputs(SPOT, RB_MARKET["xi0"], *RB_SCALARS, ins.T, STRIKE, 1.0,
                                   steps=steps, **kw)
            for anti in (True, False):
                label = f"{steps} steps{'' if anti else ' one group'}"
                put(f"K14 {s} {label}", rk._rb_values(e_inp, RB_EDGE_PAIRS, anti, seed, 0, 0))
                if steps >= 2:
                    e_ct = ct[:2 if anti else 1, :RB_EDGE_PAIRS].contiguous()
                    put(f"K17 {s} {label}", rk._rb_vjp_sums(v_e, e_ct, RB_EDGE_PAIRS, anti, seed,
                                                            0, 0))
        if hasattr(rk, "RB_SMILE_KERNEL"):
            c_inp = rk.rb_vjp_inputs(SPOT, RB_CURVE, *RB_SCALARS, ins.T, STRIKE, 1.0,
                                     steps=RB_STEPS, **kw)
            put(f"K18 {s}", rk._rb_vjp_sums(c_inp, ct, pairs, True, seed, 0, 0, per_step=True))
            ct22 = torch.full((2, SOLVE_PAIRS), 0.5 / SOLVE_PAIRS, device=dev)
            put(f"K18 {s} 2^22", rk._rb_vjp_sums(c_inp, ct22, SOLVE_PAIRS, True, seed, 0, 0,
                                                 per_step=True))
            for steps in RB_EDGE_STEPS:  # the chunked product's edges, a ragged last block
                e_inp = rk.rb_vjp_inputs(SPOT, RB_CURVE, *RB_SCALARS, ins.T, STRIKE, 1.0,
                                         steps=steps, **kw)
                for anti in (True, False):
                    e_ct = ct[:2 if anti else 1, :RB_EDGE_PAIRS].contiguous()
                    put(f"K18 {s} {steps} steps{'' if anti else ' one group'}",
                        rk._rb_vjp_sums(e_inp, e_ct, RB_EDGE_PAIRS, anti, seed, 0, 0,
                                        per_step=True))
            ks = rk.smile_strikes(ins.f_base, CAL_STRIKES, dev)
            put(f"K19 {s}", rk._rb_smile_sums(inp, ks, pairs, seed, 0, 0))
    return out


#: K1's, K2's, K5's and K7's digests past their main shapes: step and segment counts,
#: a pair count that is no multiple of a block's pairs or a warp's, and a
#: Sobol' point offset off the warp's 32-point cells
EDGE_STEPS, EDGE_SEGMENTS, EDGE_PAIRS, EDGE_OFFSET = (1, 3, 101), (1, 2, 3), 2**17 + 7, 777
#: K9's and K12's digests at odd step splits over the three expiries
ODD_SURF_STEPS = (3, 5, 7)
#: the serving dispatch's antithetic pairs (SERVING_BLOCKS x SERVING_BATCHES x 32768)
SERVING_PAIRS = 2**27
#: the one-pair-a-thread K3's resident blocks an SM (127 registers, 256
#: threads); its grid was this times the SMs (264 on an H100)
K3_PARENT_BLOCKS = 2
#: K8's resident blocks an SM (79 registers, 256 threads): K8's and K10's
#: grid, one wave of K8, is this times the SMs (396 on an H100)
K8_BLOCKS = 3
#: the one-pair-a-thread K6's resident blocks an SM (62 registers, 256
#: threads); its grid was this times the SMs (528 on an H100)
K6_PARENT_BLOCKS = 4


#: a wide calibration surface for K4's times: quarterly expiries to 2.5 years
#: (one exact segment a gap), 20 strikes from 60 to 140, 2^24 pairs
K4_WIDE = dict(expiries=10, strikes=20, pairs=2**24)
#: the one-pair-a-thread K4's resident blocks an SM (80 registers, 256
#: threads); its grid is this times the SMs (396 on an H100)
K4_ONE_PAIR_A_THREAD_BLOCKS = 3


def repaired_cells(device: str) -> dict:
    """Per output of :func:`output_digests` that draws Heston or GBM normals,
    the draws in a cell the repairs of the Heston streams changed, counted
    on the card from the streams' bits: Sobol' integers a >= 2^30 - 32 (u =
    1.0 in fp32) in the dimensions drawn as normals and as uniforms, and
    Philox radius words whose top 23 bits are zero (a zero Box-Muller
    radius uniform).  Rough Bergomi's streams are not Heston's (unchanged)."""
    import torch

    from hedgehog_tpu_torch.ops import hh_device as hd

    dev, seed, chunk = torch.device(device), 5, 2**22
    _, _, qe_seg, ex_seg = surface_grid()

    def chunks(n):
        for start in range(0, n, chunk):
            yield torch.arange(start, min(start + chunk, n), dtype=torch.int64, device=dev)

    def sobol(steps, period, normals, pairs=CHECK_PAIRS):
        """Sobol' cells of ``steps`` steps of ``period`` dims over points
        [0, pairs), dims with residue in ``normals`` drawn as normals."""
        table = torch.as_tensor(hd.sobol_table(seed, period * steps), device=dev)
        hits = [0] * (period * steps)
        for idx in chunks(pairs):
            masks = hd.sobol_masks(idx)
            for d in range(period * steps):
                hits[d] += int((hd.sobol_bits(masks, table, d) >= (1 << 30) - 32).sum())
        normal = sum(h for d, h in enumerate(hits) if d % period in normals)
        return dict(sobol_normal=normal, sobol_uniform=sum(hits) - normal)

    def philox(blocks, words=(0,), counters=CHECK_PAIRS):
        """Zero radius words among ``words`` of Philox blocks 0..blocks-1 of
        counters [0, counters)."""
        return dict(box_muller_zero=sum(
            int(((hd.philox_block(c, b, seed, 0)[w] >> 9) == 0).sum())
            for c in chunks(counters) for b in range(blocks) for w in words))

    out = {"K1 PRNG": philox(EULER_STEPS // 2, (0, 2)), "K6 PRNG": philox(QEM_STEPS),
           "K13 PRNG": philox(1, (0, 2), CHECK_PAIRS // 4)}
    for steps, names in ((QE_STEPS, ("K7", "K8", "K10", "K11")), (sum(qe_seg), ("K9", "K12"))):
        for k in names:
            out[f"{k} QMC"], out[f"{k} PRNG"] = sobol(steps, 2, (0,)), philox((steps + 1) // 2)
    for segs, names in ((SEGMENTS, ("K2", "K3")), (sum(ex_seg), ("K4",))):
        for k in names:
            out[f"{k} QMC"], out[f"{k} PRNG"] = sobol(segs, 4, (1, 3)), philox(segs)
    surface = SURF_BLOCKS * SURF_BATCHES * 32768
    out["K4 QMC 2^26"] = sobol(sum(ex_seg), 4, (1, 3), surface)
    out["K4 PRNG 2^26"] = philox(sum(ex_seg), counters=surface)
    out["K5 QMC"], out["K5 PRNG"] = sobol(QEM_STEPS, 3, (0, 1)), philox(QEM_STEPS)
    return out


def smi_query(fields: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=FIELDS`` line."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def kernel_times(device: str, only=None) -> dict:
    """The redesigned kernels' times for the package imported (this tree's,
    or ``--root``'s), to compare trees in turns in one call, with the card's
    name and power limit: :func:`rb_kernel_times`, :func:`surface_kernel_times`
    (K9, K12), and K4 (CUDA events, 5 calls after a warm-up) at 2^20 pairs
    (PERF.md's row) and at the 2^26-pair surface dispatch (3 x 5, exact-4 =
    5 segments) on both streams, with K4's occupancy where the package
    reports it, and the public K4 wrapper on the wide calibration surface
    (K4_WIDE: its launches and strike chunks as a user pays them); K2 (the
    values) at 2^20 pairs and at ``solve``'s 2^22, 2 segments, both
    streams; K3 (the exact kernels share K4's
    Poisson draw) at 2^20 pairs, both streams, and per serving dispatch
    (2^27 pairs, PRNG) with its grid and occupancy where the package reports
    them; K8 and K10, :func:`qe_price_times`; K6, :func:`qem_price_times`;
    K1, K5, K7, K11 and K13, :func:`path_kernel_times`; ``solve`` on the
    exact and Euler routes, :func:`solve_walls`.  ``only`` (kernel names,
    e.g. K4 or K9,K12 or K15,K16; K10 times K8 beside it; ``K8 host``,
    ``K10 host`` and ``K6 host`` add the host clock; ``K8 band`` times K8
    and K10 at K8_BAND_STEPS QMC steps; ``K2 band`` K2 and K3 at
    EXACT_BAND_SEGMENTS, :func:`exact_band_times`; ``K7 band`` and ``K5
    band`` K7 and K5 at QE_BAND_STEPS and QEM_BAND_STEPS QMC steps, ``K11
    band`` K11 at QE_BAND_STEPS, :func:`values_band_times`; ``K1 solve``,
    ``K2 solve``, ``K5 solve`` and ``K7 solve`` the ``solve`` walls, ``K11
    autograd`` the wall of ``torch.autograd.grad`` through the QE mixing
    ``solve``, K7 forward and K11 backward, :func:`solve_walls`) keeps the
    kernels named."""
    import torch

    from hedgehog_tpu_torch.core.dates import yearfrac
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    dev = torch.device(device)
    out = {"nvidia_smi": smi_query("name,power.limit"), "package": ek.__file__}
    if only is None or set(only) & set(RB_KERNELS):
        out.update(rb_kernel_times(dev, only))
    if only is None or {"K9", "K12"} & set(only):
        out.update(surface_kernel_times(dev, only))
    T = float(yearfrac(REF, EXPIRY))
    dt_x = T / SEGMENTS
    if only is None or "K2" in only:
        for qmc in (False, True):
            px, tx, kmax = ek._inputs(*MARKET_ARGS, dt_x, STRIKE, 1.0, SEGMENTS, 5, qmc, dev)
            s = "QMC" if qmc else "PRNG"
            for pairs in (CHECK_PAIRS, SOLVE_PAIRS):
                run2 = (px, tx, pairs, SEGMENTS, True, kmax, 5, 0, 0)
                out[f"K2 {s} {pairs}"] = time_ms(lambda: ek._exact_values(*run2))
    if only is None or "K3" in only:
        for qmc in (False, True):
            px, tx, kmax = ek._inputs(*MARKET_ARGS, dt_x, STRIKE, 1.0, SEGMENTS, 5, qmc, dev)
            s = "QMC" if qmc else "PRNG"
            out[f"K3 {s} {CHECK_PAIRS}"] = time_ms(
                lambda: ek._exact_price_sum(px, tx, CHECK_PAIRS, SEGMENTS, kmax, 5, 0, 0))
        # the serving dispatch (phase 4's: the public wrapper on 6 seeds, PRNG)
        serving = SERVING_BLOCKS * SERVING_BATCHES * ek.PAIRS_PER_BLOCK
        out[f"K3 serving dispatch {serving}"] = ms = serving_dispatches(
            lambda seed: ek.heston_exact_mixing_vanilla_price(
                *MARKET_ARGS, dt_x, STRIKE, math.exp(-R * T), n_blocks=SERVING_BLOCKS,
                n_batches=SERVING_BATCHES, segments=SEGMENTS, seed=seed, device=dev))[0]
        out["serving K3 paths/s"] = 2 * serving / (ms * 1e-3)
        out["K3 grid"] = ek.price_grid(dev) if hasattr(ek, "price_grid") else None
        if hasattr(ek, "price_occupancy"):
            out["K3 occupancy"] = ek.price_occupancy(dev)
    if only is None or "K2 band" in only:
        out.update(exact_band_times(dev))
    if only is None or {"K7 band", "K5 band", "K11 band"} & set(only):
        out.update(values_band_times(dev, only))
    if only is None or {"K8", "K8 host", "K8 band", "K10", "K10 host"} & set(only):
        out.update(qe_price_times(dev, only))
    if only is None or {"K6", "K6 host"} & set(only):
        out.update(qem_price_times(dev, only))
    if only is None or set(PATH_KERNELS) & set(only):
        out.update(path_kernel_times(dev, only))
    if only is None or set(SOLVE_WALLS) & set(only):
        out.update(solve_walls(dev, only))
    T_host, _, _, ex_seg = surface_grid()
    inp = surface_inputs(dev)
    for pairs in (CHECK_PAIRS, SURF_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK):
        if only is not None and "K4" not in only:
            break
        for qmc in (False, True):
            key = f"{'QMC' if qmc else 'PRNG'} {pairs}"
            t4 = torch.as_tensor(qk.sobol_table(5, 4 * sum(ex_seg)), device=dev) if qmc else None
            run4 = (inp["p4"], t4, ex_seg, inp["kmaxes"], len(SURF_STRIKES), pairs, 5, 0, 0)
            out[f"K4 {key}"] = time_ms(lambda: ek._exact_surface_sums(*run4))
            if pairs == CHECK_PAIRS and hasattr(ek, "exact_surface_occupancy"):
                out[f"K4 occupancy {key}"] = ek.exact_surface_occupancy(
                    len(T_host), len(SURF_STRIKES), sum(ex_seg), qmc, dev)
    for qmc in (False, True) if only is None or "K4" in only else ():
        n_exp, m, pairs = K4_WIDE["expiries"], K4_WIDE["strikes"], K4_WIDE["pairs"]
        T_w = [0.25 * (i + 1) for i in range(n_exp)]
        strikes = [60.0 + 80.0 * k / (m - 1) for k in range(m)]
        wide = functools.partial(
            ek.heston_exact_mixing_surface_price, *MARKET_ARGS, T_w, strikes,
            [math.exp(-R * t) for t in T_w], seg_steps=(1,) * n_exp, n_strikes=m,
            n_blocks=pairs // qk.PAIRS_PER_BLOCK, n_batches=1, seed=5, qmc=qmc, device=dev)
        key = f"K4 wide {n_exp}x{m} {'QMC' if qmc else 'PRNG'} {pairs}"
        out[key] = time_ms(wide)
        if hasattr(ek, "exact_surface_occupancy"):
            out[f"K4 occupancy wide {'QMC' if qmc else 'PRNG'}"] = ek.exact_surface_occupancy(
                n_exp, m, n_exp, qmc, dev)
    for key, val in out.items():
        say(f"  {key}: {val}")
    return out


def host_walls(fn, read, ms: float) -> dict:
    """One synchronised call of ``fn(seed)`` on the host clock, the caller
    reading its result with ``read`` (the median of 5 seeds), against
    ``ms``, the back-to-back time of the same call: the wall and the idle
    share 1 - ms / wall."""
    import torch

    walls = []
    for seed in range(7, 12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        read(fn(seed=seed))
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[2]
    return {"synchronised wall ms": wall, "idle share": 1.0 - ms / wall}


def _device_ms(e) -> float:
    """A ``torch.profiler`` event's own device time in ms."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3


def profile_summary(name: str, fn) -> dict:
    """A ``torch.profiler`` summary of one call of ``fn()``: the device ms it
    records and the 15 operations of most host time (key, count, host ms,
    device ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    events = prof.key_averages()
    return {f"{name} profile device ms": sum(_device_ms(e) for e in events),
            f"{name} profile host": [
                [e.key, e.count, e.cpu_time_total / 1e3, _device_ms(e)]
                for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:15]]}


def qe_price_times(dev, only=None) -> dict:
    """K8 (and, for ``K10`` or ``K10 host``, K10 beside it; CUDA events, 5
    calls after a warm-up) at 2^20 pairs, 11 steps, both streams, on fixed
    inputs at the package's grid (PERF.md's rows: the wrappers with their
    float64 reductions; ``launch``: the kernels alone, also at 2^27 pairs on
    PRNG), and per serving dispatch (2^27 pairs, PRNG, the public wrappers
    on 6 seeds, as phase 4) with paths/s, K10/K8 and the occupancies where
    the package reports them.  ``K8 host`` adds K8's synchronised dispatch
    on the host clock against its back-to-back time (the idle share) and a
    ``torch.profiler`` summary of one K8 dispatch; ``K10 host`` (or no
    ``only``) the same of K8 and K10, with K10's summary."""
    import torch

    from hedgehog_tpu_torch.core.dates import yearfrac
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    out = qe_band_times(dev) if only is None or "K8 band" in only else {}
    if only is not None and not {"K8", "K8 host", "K10", "K10 host"} & set(only):
        return out
    greeks = only is None or bool({"K10", "K10 host"} & set(only))
    hosts = [k for k in ("K8", "K10") if only is None or "K10 host" in only
             or (k == "K8" and "K8 host" in only)]
    T = float(yearfrac(REF, EXPIRY))
    dt_q, disc = T / QE_STEPS, math.exp(-R * T)
    dtab = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                           HESTON["sigma"], dt_q, QE_STEPS, 4), device=dev)
    serving = SERVING_BLOCKS * SERVING_BATCHES * qk.PAIRS_PER_BLOCK
    for qmc in (False, True):
        s = "QMC" if qmc else "PRNG"
        params, table = qk.mix_inputs(*MARKET_ARGS, dt_q, STRIKE, 1.0, QE_STEPS, 5, qmc, dev)
        out[f"K8 {s} {CHECK_PAIRS}"] = time_ms(
            lambda: qk._qe_price_sum(params, table, CHECK_PAIRS, QE_STEPS, 5, 0, 0))
        if greeks:
            out[f"K10 {s} {CHECK_PAIRS}"] = time_ms(
                lambda: gk._greek_sums(params, dtab, table, CHECK_PAIRS, QE_STEPS, 5, 0, 0))
        grid = out[f"grid {s}"] = qk.price_grid(dev, table)
        # the kernels alone, without the wrappers' float64 reductions
        partials = torch.empty((7, grid), dtype=torch.float64, device=dev)
        sobol = None if table is None else table.data_ptr()
        for pairs in (CHECK_PAIRS, serving):
            out[f"K8 launch {s} {pairs}"] = time_ms(lambda: qk.QE_PRICE_KERNEL.launch(
                dev, params.data_ptr(), sobol, partials.data_ptr(), grid, pairs, QE_STEPS, 5, 0, 0))
            if greeks and not (qmc and pairs == serving):
                out[f"K10 launch {s} {pairs}"] = time_ms(lambda: gk.QE_GREEKS_KERNEL.launch(
                    dev, params.data_ptr(), dtab.data_ptr(), sobol, partials.data_ptr(), grid,
                    pairs, QE_STEPS, 5, 0, 0))
        if hasattr(qk, "price_occupancy"):
            out[f"K8 occupancy {s}"] = qk.price_occupancy(QE_STEPS, qmc, dev)
        if greeks and hasattr(gk, "greeks_occupancy"):
            out[f"K10 occupancy {s}"] = gk.greeks_occupancy(QE_STEPS, qmc, dev)
    kw = dict(n_blocks=SERVING_BLOCKS, n_batches=SERVING_BATCHES, steps=QE_STEPS, device=dev)
    k8 = functools.partial(qk.heston_qe_mixing_vanilla_price, *MARKET_ARGS, dt_q, STRIKE, disc,
                           **kw)
    k10 = functools.partial(gk.heston_qe_mixing_price_and_greeks, *MARKET_ARGS, dt_q, STRIKE, disc,
                            **kw)
    out[f"K8 serving dispatch {serving}"] = ms = serving_dispatches(lambda seed: k8(seed=seed))[0]
    out["serving K8 paths/s"] = 2 * serving / (ms * 1e-3)
    mss = {"K8": ms}
    if greeks:
        out[f"K10 serving dispatch {serving}"] = mss["K10"] = serving_dispatches(
            lambda seed: k10(seed=seed))[0]
        out["serving K10/K8"] = mss["K10"] / ms
    for name in hosts:
        fn, read = (k8, float) if name == "K8" else (k10, lambda p: float(p[0]))
        for key, val in host_walls(fn, read, mss[name]).items():
            out[f"serving {name} {key}"] = val
    if hosts:
        name = hosts[-1]
        fn = (lambda: float(k8(seed=8))) if name == "K8" else (lambda: k10(seed=8)[1].cpu())
        out.update(profile_summary(name, fn))
    return out


#: QMC segment counts on both sides of K2's and K3's staging decision (the
#: table and each warp's high words staged up to ~113 segments on an H100,
#: where 2 blocks an SM still fit; one block held them to ~230, the table
#: alone to ~460)
EXACT_BAND_SEGMENTS = (64, 100, 160, 252, 400)


def exact_band_times(dev) -> dict:
    """K2 (antithetic) and K3 (CUDA events, 5 calls after a warm-up) at
    2^20 pairs on the QMC stream at each of EXACT_BAND_SEGMENTS segments of
    the past-the-staging-limit case's length (GLOBAL_EXACT_YEARS over
    GLOBAL_EXACT_SEGMENTS, under GLOBAL_EXACT_SIGMA), with the table's
    bytes."""
    from hedgehog_tpu_torch.ops import heston_exact_kernel as ek

    mkt = MARKET_ARGS[:5] + (GLOBAL_EXACT_SIGMA, MARKET_ARGS[6])
    dt_b = GLOBAL_EXACT_YEARS / GLOBAL_EXACT_SEGMENTS
    out = {}
    for segs in EXACT_BAND_SEGMENTS:
        px, tx, kmax = ek._inputs(*mkt, dt_b, STRIKE, 1.0, segs, 5, True, dev)
        key = f"QMC {segs} segments {CHECK_PAIRS}"
        out[f"K2 {key}"] = time_ms(
            lambda: ek._exact_values(px, tx, CHECK_PAIRS, segs, True, kmax, 5, 0, 0))
        out[f"K3 {key}"] = time_ms(
            lambda: ek._exact_price_sum(px, tx, CHECK_PAIRS, segs, kmax, 5, 0, 0))
        out[f"table bytes {segs} segments"] = 4 * tx.numel()
    return out


#: QMC step counts on both sides of K7's and K5's staging decision: on an
#: H100 K7 stages the table and each warp's high words at 2 blocks an SM or
#: more up to ~300 steps, K5 up to ~200, and both read the table from
#: global memory past that (before, each staged the table alone wherever it
#: fitted a block: K7 to ~915 steps, K5 to ~610)
QE_BAND_STEPS = (100, 252, 400, 700)
QEM_BAND_STEPS = (128, 200, 252, 400)


def values_band_times(dev, only=None) -> dict:
    """K7 (``K7 band``), K11 (``K11 band``, under a smooth cotangent) and
    K5 (``K5 band``), antithetic, CUDA events, 5 calls after a warm-up, at
    2^20 pairs on the QMC stream at each of QE_BAND_STEPS (K7, K11) and
    QEM_BAND_STEPS (K5) steps of the serving year, with the table's bytes."""
    import torch

    from hedgehog_tpu_torch.core.dates import yearfrac
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T = float(yearfrac(REF, EXPIRY))
    out = {}
    for steps in QE_BAND_STEPS if only is None or "K7 band" in only else ():
        params, table = qk.mix_inputs(*MARKET_ARGS, T / steps, STRIKE, 1.0, steps, 5, True, dev)
        out[f"K7 QMC {steps} steps {CHECK_PAIRS}"] = time_ms(
            lambda: qk._qe_values(params, table, CHECK_PAIRS, steps, True, 5, 0, 0))
        out[f"K7 table bytes {steps} steps"] = 4 * table.numel()
    ct = (0.5 + 0.5 * torch.sin(torch.arange(2 * CHECK_PAIRS, device=dev, dtype=torch.float32))
          ).reshape(2, CHECK_PAIRS)
    for steps in QE_BAND_STEPS if only is None or "K11 band" in only else ():
        params, table = qk.mix_inputs(*MARKET_ARGS, T / steps, STRIKE, 1.0, steps, 5, True, dev)
        t5 = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                             HESTON["sigma"], T / steps, steps, 5), device=dev)
        out[f"K11 QMC {steps} steps {CHECK_PAIRS}"] = time_ms(
            lambda: gk._vjp_sums(params, t5, table, ct, CHECK_PAIRS, steps, True, 5, 0, 0))
    for steps in QEM_BAND_STEPS if only is None or "K5 band" in only else ():
        params, table = qk.qem_inputs(*MARKET_ARGS, T / steps, steps, 5, True, dev)
        out[f"K5 QMC {steps} steps {CHECK_PAIRS}"] = time_ms(
            lambda: qk._qem_terminal(params, table, CHECK_PAIRS, steps, True, True, 5, 0, 0))
        out[f"K5 table bytes {steps} steps"] = 4 * table.numel()
    return out


#: QMC step counts where K8's staged table and high words hold fewer blocks an
#: SM than its table alone (250: 2 against 3 on an H100), and where they pass
#: the staging limit while the table alone does not (700)
K8_BAND_STEPS = (250, 700)


def qe_band_times(dev) -> dict:
    """K8 and K10 (CUDA events, 5 calls after a warm-up) at 2^20 pairs on the
    QMC stream at each of K8_BAND_STEPS steps, at the package's grid, with
    the grid and K8's and K10's occupancy where the package reports them;
    where K8 takes a grid, also K8 at K8_BLOCKS an SM (the grid its table
    alone would give)."""
    import torch

    from hedgehog_tpu_torch.core.dates import yearfrac
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T = float(yearfrac(REF, EXPIRY))
    out = {}
    for steps in K8_BAND_STEPS:
        dt_b = T / steps
        params, table = qk.mix_inputs(*MARKET_ARGS, dt_b, STRIKE, 1.0, steps, 5, True, dev)
        dtab = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                               HESTON["sigma"], dt_b, steps, 4), device=dev)
        key = f"QMC {steps} steps {CHECK_PAIRS}"
        out[f"K8 {key}"] = time_ms(
            lambda: qk._qe_price_sum(params, table, CHECK_PAIRS, steps, 5, 0, 0))
        out[f"K10 {key}"] = time_ms(
            lambda: gk._greek_sums(params, dtab, table, CHECK_PAIRS, steps, 5, 0, 0))
        out[f"grid QMC {steps} steps"] = qk.price_grid(dev, table)
        if "grid" in inspect.signature(qk._qe_price_sum).parameters:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            out[f"K8 {key} at {K8_BLOCKS} blocks an SM"] = time_ms(lambda: qk._qe_price_sum(
                params, table, CHECK_PAIRS, steps, 5, 0, 0, grid=K8_BLOCKS * sms))
        if hasattr(qk, "price_occupancy"):
            out[f"K8 occupancy QMC {steps} steps"] = qk.price_occupancy(steps, True, dev)
        if hasattr(gk, "greeks_occupancy"):
            out[f"K10 occupancy QMC {steps} steps"] = gk.greeks_occupancy(steps, True, dev)
    return out


def qem_price_times(dev, only=None) -> dict:
    """K6 (CUDA events, 5 calls after a warm-up) at 2^20 pairs, 10 steps,
    PRNG, on fixed inputs at the package's grid (PERF.md's row: the wrapper
    with its float64 reduction; ``launch``: the kernel alone, also at 2^27
    pairs), its grid and occupancy where the package reports them, and per
    serving dispatch (2^27 pairs, the public wrapper on 6 seeds, as phase 4)
    with paths/s.  ``K6 host`` (or no ``only``) adds one synchronised
    dispatch on the host clock against the back-to-back time (the idle
    share) and a ``torch.profiler`` summary of one dispatch."""
    import torch

    from hedgehog_tpu_torch.core.dates import yearfrac
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T = float(yearfrac(REF, EXPIRY))
    dt_m, disc = T / QEM_STEPS, math.exp(-R * T)
    serving = SERVING_BLOCKS * SERVING_BATCHES * qk.PAIRS_PER_BLOCK
    p15 = torch.as_tensor(qk._qem_params(*MARKET_ARGS, dt_m, strike=STRIKE), device=dev)
    out = {f"K6 PRNG {CHECK_PAIRS}": time_ms(
        lambda: qk._qem_price_sum(p15, CHECK_PAIRS, QEM_STEPS, 5, 0))}
    grid = out["K6 grid"] = (qk.qem_price_grid(dev) if hasattr(qk, "qem_price_grid")
                             else qk.resident_grid("hh_qem_price_grid", dev))
    partials = torch.empty((grid,), dtype=torch.float64, device=dev)
    for pairs in (CHECK_PAIRS, serving):
        out[f"K6 launch PRNG {pairs}"] = time_ms(lambda: qk.QEM_PRICE_KERNEL.launch(
            dev, p15.data_ptr(), partials.data_ptr(), grid, pairs, QEM_STEPS, 5, 0))
    if hasattr(qk, "qem_price_occupancy"):
        out["K6 occupancy"] = qk.qem_price_occupancy(dev)
    k6 = functools.partial(qk.heston_qe_call_price, *MARKET_ARGS, dt_m, STRIKE, disc,
                           n_blocks=SERVING_BLOCKS, n_batches=SERVING_BATCHES, steps=QEM_STEPS,
                           device=dev)
    out[f"K6 serving dispatch {serving}"] = ms = serving_dispatches(lambda seed: k6(seed=seed))[0]
    out["serving K6 paths/s"] = 2 * serving / (ms * 1e-3)
    if only is None or "K6 host" in only:
        for key, val in host_walls(k6, float, ms).items():
            out[f"serving K6 {key}"] = val
        out.update(profile_summary("K6", lambda: float(k6(seed=8))))
    return out


#: the per-path kernels, for ``--times --only``
PATH_KERNELS = ("K1", "K5", "K7", "K11", "K13")


def path_kernel_times(dev, only=None) -> dict:
    """K1, K5, K7, K11 and K13 (CUDA events, 5 calls after a warm-up) at
    PERF.md's shapes, through the launching wrappers phase 3 times: 2^20
    pairs (K13 2^24), K1 at EULER_STEPS on PRNG (also at ``solve``'s 2^23
    pairs), K5 at QEM_STEPS (also at ``solve``'s 2^23) and K7 (also at
    ``solve``'s 2^22) and K11 (also at autograd's 2^22) at QE_STEPS on both
    streams."""
    import torch

    from hedgehog_tpu_torch.core.dates import yearfrac
    from hedgehog_tpu_torch.ops import gbm_kernel as gbk
    from hedgehog_tpu_torch.ops import heston_kernel as hk
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    def want(k):
        return only is None or k in only

    T = float(yearfrac(REF, EXPIRY))
    out = {}
    if want("K1"):
        pe = torch.as_tensor(hk._euler_params(*MARKET_ARGS, T / EULER_STEPS), device=dev)
        for pairs in (CHECK_PAIRS, EULER_PAIRS):
            out[f"K1 PRNG {pairs}"] = time_ms(
                lambda: hk._euler_terminal(pe, pairs, EULER_STEPS, 7, True, 0))
    dt_q = T / QE_STEPS
    cts = {n: (0.5 + 0.5 * torch.sin(torch.arange(2 * n, device=dev, dtype=torch.float32))
               ).reshape(2, n) for n in (CHECK_PAIRS, SOLVE_PAIRS)}
    t5 = torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                         HESTON["sigma"], dt_q, QE_STEPS, 5), device=dev)
    for qmc in (False, True):
        s = "QMC" if qmc else "PRNG"
        if want("K5"):
            p_qem, t_qem = qk.qem_inputs(*MARKET_ARGS, T / QEM_STEPS, QEM_STEPS, 5, qmc, dev)
            for pairs in (CHECK_PAIRS, QEM_SOLVE_PAIRS):
                out[f"K5 {s} {pairs}"] = time_ms(lambda: qk._qem_terminal(
                    p_qem, t_qem, pairs, QEM_STEPS, True, True, 5, 0, 0))
        params, table = qk.mix_inputs(*MARKET_ARGS, dt_q, STRIKE, 1.0, QE_STEPS, 5, qmc, dev)
        if want("K7"):
            for pairs in (CHECK_PAIRS, SOLVE_PAIRS):
                out[f"K7 {s} {pairs}"] = time_ms(
                    lambda: qk._qe_values(params, table, pairs, QE_STEPS, True, 5, 0, 0))
        for pairs in (CHECK_PAIRS, SOLVE_PAIRS) if want("K11") else ():
            out[f"K11 {s} {pairs}"] = time_ms(lambda: gk._vjp_sums(
                params, t5, table, cts[pairs], pairs, QE_STEPS, True, 5, 0, 0))
    if want("K13"):
        mean_g, std_g = lognormal_law(T)
        pg = torch.tensor([mean_g, std_g], dtype=torch.float32, device=dev)
        out[f"K13 PRNG {GBM_PAIRS}"] = time_ms(
            lambda: gbk._gbm_terminal(pg, GBM_PAIRS, True, 0, 0))
        out[f"K13 PRNG {GBM_PAIRS}, 50 calls"] = time_ms(
            lambda: gbk._gbm_terminal(pg, GBM_PAIRS, True, 0, 0), reps=50)
    return out


def solve_walls(dev, only=None) -> dict:
    """``solve`` on the card as phase 3 calls it: the exact route (K2, 2^22
    pairs, 2 segments, both streams; ``K2 solve``), the Euler route (K1,
    2^23 pairs x 100 steps; ``K1 solve``), the QE mixing route (K7, 2^22
    pairs x 11 steps, both streams; ``K7 solve``) and the QE-M route (K5,
    2^23 pairs x 10 steps, both streams; ``K5 solve``); and
    ``torch.autograd.grad`` of the QE mixing route's price in its seven
    market leaves (K7 forward, K11 backward, both streams; ``K11
    autograd``).  Per call: the synchronised wall on the host clock (median
    of 5 after a warm-up), the device time of one call and its kernels'
    (``torch.profiler``), and the idle share 1 - device / wall; for the
    autograd route also the forward's and the backward's walls (the price
    read between them), the 15 operations of most host time in the profiled
    call, and the wall of rebuilding K11's inputs on the host as the
    backward once did (``mix_inputs`` and the tangent table's copy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    def problem(leaves=None):
        spot, v0, kappa, theta, sigma, rho, r = leaves or PARAMS7
        market = ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
        return ht.PricingProblem(ht.VanillaOption(STRIKE, EXPIRY, ht.European(), ht.Call(),
                                                  ht.Spot()), market)

    prob, qe = problem(), ht.HestonQE(conditional=True, use_kernel=True)
    runs = []
    if only is None or "K2 solve" in only:
        runs += [(f"solve exact {'QMC' if qmc else 'PRNG'} {SOLVE_PAIRS}",
                  ht.HestonExactMixing(use_kernel=True),
                  ht.SimulationConfig(SOLVE_PAIRS, SEGMENTS, ht.Antithetic(), 0, qmc),
                  ("exact_values",), False)
                 for qmc in (True, False)]
    if only is None or "K1 solve" in only:
        runs.append((f"solve Euler {EULER_PAIRS} x {EULER_STEPS}",
                     ht.EulerMaruyama(use_kernel=True),
                     ht.SimulationConfig(EULER_PAIRS, EULER_STEPS, ht.Antithetic(), 0, False),
                     ("heston_euler",), False))
    if only is None or "K7 solve" in only:
        runs += [(f"solve QE {'QMC' if qmc else 'PRNG'} {SOLVE_PAIRS} x {QE_STEPS}", qe,
                  ht.SimulationConfig(SOLVE_PAIRS, QE_STEPS, ht.Antithetic(), 0, qmc),
                  ("qe_values",), False)
                 for qmc in (True, False)]
    if only is None or "K5 solve" in only:
        runs += [(f"solve QE-M {'QMC' if qmc else 'PRNG'} {QEM_SOLVE_PAIRS} x {QEM_STEPS}",
                  ht.HestonQE(use_kernel=True),
                  ht.SimulationConfig(QEM_SOLVE_PAIRS, QEM_STEPS, ht.Antithetic(), 0, qmc),
                  ("qem_terminal",), False)
                 for qmc in (True, False)]
    if only is None or "K11 autograd" in only:
        runs += [(f"autograd QE {'QMC' if qmc else 'PRNG'} {SOLVE_PAIRS} x {QE_STEPS}", qe,
                  ht.SimulationConfig(SOLVE_PAIRS, QE_STEPS, ht.Antithetic(), 0, qmc),
                  ("qe_values", "qe_vjp"), True)
                 for qmc in (True, False)]
    out = {}
    for label, strat, cfg, kernels, grad in runs:
        method = ht.MonteCarlo(ht.HestonDynamics(), strat, cfg, device=str(dev))
        halves = []

        def call():
            if not grad:
                return float(ht.solve(prob, method).price)
            leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in PARAMS7]
            t0 = time.perf_counter()
            sol = ht.solve(problem(leaves), method)
            price = float(sol.price)
            t1 = time.perf_counter()
            grads = [float(g) for g in torch.autograd.grad(sol.price, leaves)]
            halves.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)))
            return price, grads

        call()
        halves.clear()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall = sorted(walls)[2]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
        events = prof.key_averages()
        device_ms = sum(_device_ms(e) for e in events)
        out[f"{label} wall ms"] = wall
        out[f"{label} device ms"] = device_ms
        for kernel in kernels:
            key = "kernel ms" if len(kernels) == 1 else f"{kernel} ms"
            out[f"{label} {key}"] = sum(_device_ms(e) for e in events if kernel in e.key)
        out[f"{label} idle share"] = 1.0 - device_ms / wall
        if grad:
            out[f"{label} forward wall ms"] = sorted(f for f, _ in halves[:5])[2]
            out[f"{label} backward wall ms"] = sorted(b for _, b in halves[:5])[2]
            out[f"{label} profile host"] = [
                [e.key, e.count, e.cpu_time_total / 1e3, _device_ms(e)]
                for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:15]]
            T = float(ht.yearfrac(REF, EXPIRY))
            rebuild = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                qk.mix_inputs(*MARKET_ARGS, T / QE_STEPS, STRIKE, 1.0, QE_STEPS, 0, cfg.qmc, dev)
                torch.as_tensor(gk._greek_table(HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                                                HESTON["sigma"], T / QE_STEPS, QE_STEPS, 5),
                                device=dev)
                torch.cuda.synchronize()
                rebuild.append(1e3 * (time.perf_counter() - t0))
            out[f"{label} backward input rebuild ms"] = sorted(rebuild[1:])[2]
    return out


#: the ``solve`` routes :func:`solve_walls` times, for ``--times --only``
SOLVE_WALLS = ("K1 solve", "K2 solve", "K5 solve", "K7 solve", "K11 autograd")


#: the rough-Bergomi kernels, for ``--times --only`` ("K15 wide": K15 past
#: the staged steps, :func:`rb_wide_times`)
RB_KERNELS = ("K14", "K15", "K16", "K17", "K18", "K19", "K15 wide")
#: the QE surface kernels' resident blocks an SM before K9's redesign (K9 63
#: registers: 4 blocks of 256 threads, K12 114: 2); their grid was this
#: times the SMs (528 on an H100)
K9_PARENT_BLOCKS = 4


def surface_kernel_times(dev, only=None) -> dict:
    """K9 and K12 (CUDA events, 5 calls after a warm-up) on the 3 x 5 QE-32
    surface at 2^20 pairs (PERF.md's rows) and at the 2^26-pair surface
    dispatch and on the 3 x 17 calibration shape at 2^20 pairs, both
    streams, through ``_qe_surface_sums`` and ``_surface_jac_sums`` at the
    package's grid; the grid, and K9's and K12's occupancy where the package
    reports it."""
    import torch

    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T_host, _, qe_seg, _ = surface_grid()
    inp, m = surface_inputs(dev), len(SURF_STRIKES)
    out = {"K9 grid": qk.surface_grid(dev)}
    for pairs in (CHECK_PAIRS, SURF_BLOCKS * SURF_BATCHES * qk.PAIRS_PER_BLOCK):
        for qmc in (False, True):
            key = f"{'QMC' if qmc else 'PRNG'} {pairs}"
            t9 = torch.as_tensor(qk.sobol_table(5, 2 * sum(qe_seg)), device=dev) if qmc else None
            run = (t9, qe_seg, m, pairs, 5, 0, 0)
            if only is None or "K9" in only:
                out[f"K9 {key}"] = time_ms(lambda: qk._qe_surface_sums(inp["p9"], *run))
            if only is None or "K12" in only:
                out[f"K12 {key}"] = time_ms(
                    lambda: gk._surface_jac_sums(inp["p9"], inp["dct"], inp["djt"], *run))
            if pairs == CHECK_PAIRS and hasattr(qk, "surface_occupancy"):
                out[f"K9 occupancy {key}"] = qk.surface_occupancy(
                    len(T_host), m, sum(qe_seg), qmc, dev)
                out[f"K12 occupancy {key}"] = qk.surface_occupancy(
                    len(T_host), m, sum(qe_seg), qmc, dev, jac=True)
    # the 3 x 17 calibration shape (51 points, K12 357 columns) at 2^20 pairs
    for qmc in (False, True):
        cal = calibration_inputs(dev, qmc, 5)
        key = f"3x17 {'QMC' if qmc else 'PRNG'} {CHECK_PAIRS}"
        if only is None or "K9" in only:
            out[f"K9 {key}"] = time_ms(lambda: qk._qe_surface_sums(*cal["price"], CHECK_PAIRS, 5,
                                                                   0, 0))
        if only is None or "K12" in only:
            out[f"K12 {key}"] = time_ms(lambda: gk._surface_jac_sums(*cal["jac"], CHECK_PAIRS, 5,
                                                                     0, 0))
    return out


def rb_kernel_times(dev, only=None) -> dict:
    """The rough-Bergomi kernels' times: K15 per serving dispatch (2^24
    pairs x 64 steps, PRNG, the public wrapper on 6 seeds, as phase 4); per
    kernel call on fixed inputs on both streams K15, K16 and K19 (17
    strikes) at 2^20 pairs (PERF.md's rows) and 2^24, K14 at those and at
    ``solve``'s 2^22, K17 and K18 (the sloped curve) at 2^20 and 2^22;
    K14's, K15's, K16's, K17's and K18's occupancy where the package
    reports it.  ``only`` keeps the kernels named."""
    import torch

    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    def want(k):
        return only is None or k in only

    serving = RB_BLOCKS * RB_BATCHES * rk.PAIRS_PER_BLOCK
    out = {}
    ins = rk._rb_trace_inputs(rb_problem(), rb_config(serving, False), 64)
    kw = dict(n_blocks=RB_BLOCKS, n_batches=RB_BATCHES, steps=RB_STEPS, device=dev)
    if want("K15"):
        out["K15 serving dispatch"] = serving_dispatches(
            lambda seed: rk.rbergomi_mixing_vanilla_price(*ins.price_args(), seed=seed, **kw))[0]
    ks = rk.smile_strikes(ins.f_base, CAL_STRIKES, dev)
    for pairs in (CHECK_PAIRS, SOLVE_PAIRS, serving):
        ct = torch.full((2, pairs), 0.5 / pairs, dtype=torch.float32, device=dev)
        for qmc in (False, True):
            key = f"{'QMC' if qmc else 'PRNG'} {pairs}"
            _, inp = rb_device_inputs(pairs, qmc, 1, dev, tangent=False)
            if want("K14"):
                out[f"K14 {key}"] = time_ms(lambda: rk._rb_values(inp, pairs, True, 1, 0, 0))
                if pairs == CHECK_PAIRS and hasattr(rk, "values_occupancy"):
                    out[f"K14 occupancy {key}"] = rk.values_occupancy(inp)
            if pairs != SOLVE_PAIRS:
                _, g_inp = rb_device_inputs(pairs, qmc, 1, dev, tangent=True)
                if want("K15"):
                    out[f"K15 {key}"] = time_ms(lambda: rk._rb_price_sum(inp, pairs, 1, 0, 0))
                if want("K19"):
                    out[f"K19 {key}"] = time_ms(
                        lambda: rk._rb_smile_sums(inp, ks, pairs, 1, 0, 0))
                if want("K16"):
                    out[f"K16 {key}"] = time_ms(lambda: rk._rb_greek_sums(g_inp, pairs, 1, 0, 0))
                out[f"grid {key}"] = rk.price_grid(inp)
                if hasattr(rk, "price_occupancy") and pairs == serving:
                    out[f"occupancy {key}"] = rk.price_occupancy(inp)
                if hasattr(rk, "greeks_occupancy") and pairs == serving:
                    out[f"K16 occupancy {key}"] = rk.greeks_occupancy(g_inp)
            if pairs != serving:
                _, v_inp = rb_device_inputs(pairs, qmc, 1, dev, tangent=True, vjp=True)
                c_inp = rk.rb_vjp_inputs(SPOT, RB_CURVE, *RB_SCALARS, ins.T, STRIKE, 1.0,
                                         steps=RB_STEPS, seed=1, qmc=qmc, device=dev)
                if want("K17"):
                    out[f"K17 {key}"] = time_ms(
                        lambda: rk._rb_vjp_sums(v_inp, ct, pairs, True, 1, 0, 0))
                    if pairs == CHECK_PAIRS and hasattr(rk, "vjp_occupancy"):
                        out[f"K17 occupancy {key}"] = rk.vjp_occupancy(v_inp)
                if want("K18"):
                    out[f"K18 {key}"] = time_ms(
                        lambda: rk._rb_vjp_sums(c_inp, ct, pairs, True, 1, 0, 0, per_step=True))
                if pairs == CHECK_PAIRS and hasattr(rk, "vjp_curve_occupancy") and want("K18"):
                    out[f"K18 occupancy {key}"] = rk.vjp_curve_occupancy(c_inp)
    if want("K15 wide") and hasattr(rk, "STAGED_STEPS"):
        out.update(rb_wide_times(dev))
    return out


#: the wide kernels' step counts in ``--times --only "K15 wide"``: the
#: staged limit (the xi columns in shared memory), then the slab past it
RB_WIDE_STEPS = (256, 320, 512)


def rb_wide_times(dev) -> dict:
    """K15 at the staged step limit and past it (PRNG, 2^22 pairs): at each
    of ``RB_WIDE_STEPS`` steps, with the grid and the occupancy; ms per
    n(n-1) of the product."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    out = {}
    for steps in RB_WIDE_STEPS:
        _, inp = rb_device_inputs(SOLVE_PAIRS, False, 1, dev, tangent=False, steps=steps)
        key = f"K15 wide {steps} PRNG {SOLVE_PAIRS}"
        out[key] = ms = time_ms(lambda: rk._rb_price_sum(inp, SOLVE_PAIRS, 1, 0, 0), reps=2)
        out[f"{key} per n(n-1)"] = ms / (steps * (steps - 1))
        out[f"{key} grid"] = rk.price_grid(inp)
        out[f"{key} occupancy"] = rk.price_occupancy(inp)
    return out


#: the exact-greeks phase: bench.py's market at 2^20 QMC pairs x 2 segments,
#: and the CPU comparison at 2^16 pairs
EXACT_GREEK_PAIRS, EXACT_GREEK_CPU_PAIRS = 2**20, 2**16
#: test_exact_greeks.py's limits against central Carr-Madan differences
EXACT_GREEK_RTOL, EXACT_GREEK_ATOL = 5e-2, 2e-2
EXACT_GREEK_LENSES = {"spot": "market_inputs.spot", "V0": "market_inputs.V0",
                      "kappa": "market_inputs.kappa", "theta": "market_inputs.theta",
                      "sigma": "market_inputs.sigma", "rho": "market_inputs.rho",
                      "rate": "market_inputs.rate.rate"}
#: the american phase: CRR and LSM sizes, and the dual bound's nested paths
CRR_STEPS, LSM_PAIRS, LSM_STEPS, LSM_DEGREE = 2000, 2**17, 100, 5
DUAL_OUTER, DUAL_INNER, DUAL_STEPS = 4096, 128, 24
AMERICAN_GOLDENS = (("Call", "Spot", 0.25225758542934945),
                    ("Put", "Forward", 0.07409148128021317))


def say_profile(label: str, rec: dict) -> None:
    say(f"  {label}: wall {rec['eval wall ms']:.3f} ms, {rec['eval device ms']:.3f} ms on the "
        f"device (events summed {rec['eval device sum ms']:.3f} ms, profiled wall "
        f"{rec['eval profiled wall ms']:.3f} ms), idle share {rec['idle share']}")


def phase_exact_greeks(smi: str, device: str) -> dict:
    """Greeks through the float64 exact-mixing ``solve`` on the card (bench.py's
    market, 2^20 QMC pairs x 2 segments): ``BatchGreekProblem(ReverseAD)``
    against ``heston_exact_price_and_greeks`` (1e-10), both against central
    Carr-Madan differences (rel 5e-2 / abs 2e-2, tests/agreement/
    test_exact_greeks.py), and the card's vector against the same code's on
    the CPU at 2^16 pairs (1e-10).  Prints each solve's wall and idle
    share."""
    import torch

    import hedgehog_tpu_torch as ht

    say(f"phase 3 (exact greeks): likelihood-ratio greeks through HestonExactMixing() on "
        f"{device}; {smi}")
    market = ht.HestonInputs(REF, R, SPOT, *HESTON.values())
    prob = ht.PricingProblem(ht.VanillaOption(STRIKE, EXPIRY, ht.European(), ht.Call(), ht.Spot()),
                             market)

    def method(pairs, dev):
        cfg = ht.SimulationConfig(pairs, SEGMENTS, ht.Antithetic(), 1, True)
        return ht.MonteCarlo(ht.HestonDynamics(), ht.HestonExactMixing(), cfg, device=dev)

    mc = method(EXACT_GREEK_PAIRS, device)
    lenses = [ht.FieldLens(path) for path in EXACT_GREEK_LENSES.values()]
    batch = ht.solve(ht.BatchGreekProblem(prob, lenses), ht.ReverseAD(), mc)
    rev = torch.stack([batch[lens] for lens in lenses])
    price, greeks = ht.heston_exact_price_and_greeks(prob, mc)
    vec = torch.stack([greeks[k] for k in GREEK_ORDER])
    check(rev.device.type == torch.device(device).type == vec.device.type,
          f"the greeks left the card ({rev.device}, {vec.device})")
    say(f"  heston_exact_price_and_greeks, {EXACT_GREEK_PAIRS} QMC pairs: price "
        f"{float(price):.8f}, " + ", ".join(f"{k} {float(g):.8f}" for k, g in zip(GREEK_ORDER, vec)))
    compare_vectors("BatchGreekProblem(ReverseAD) against heston_exact_price_and_greeks",
                    rev, vec, 1e-10)
    cm = ht.CarrMadan(1.0, 32.0, ht.HestonDynamics(), device=device)
    fd = ht.FiniteDifference(1e-4, ht.FDCentral())
    cm_greeks = [float(ht.solve(ht.GreekProblem(prob, lens), fd, cm).greek) for lens in lenses]
    for name, got, want in zip(GREEK_ORDER, vec.tolist(), cm_greeks):
        check(abs(got - want) <= EXACT_GREEK_ATOL + EXACT_GREEK_RTOL * abs(want),
              f"exact greek {name}: {got} against Carr-Madan's central difference {want}")
        check(got != 0.0, f"exact greek {name} is zero")
    say("  against central Carr-Madan differences (rel 5e-2, abs 2e-2): "
        + ", ".join(f"{k} {g:.6f}" for k, g in zip(GREEK_ORDER, cm_greeks)))
    small_price, small = ht.heston_exact_price_and_greeks(prob, method(EXACT_GREEK_CPU_PAIRS,
                                                                       device))
    cpu_price, cpu = ht.heston_exact_price_and_greeks(prob, method(EXACT_GREEK_CPU_PAIRS, "cpu"))
    compare_vectors(f"the card's greek vector against the CPU's at {EXACT_GREEK_CPU_PAIRS} pairs",
                    torch.stack([small[k] for k in GREEK_ORDER]).cpu(),
                    torch.stack([cpu[k] for k in GREEK_ORDER]), 1e-10)
    check(abs(float(small_price) - float(cpu_price)) <= 1e-10 * abs(float(cpu_price)),
          f"the card's price {float(small_price)} against the CPU's {float(cpu_price)}")
    out = {"greeks": dict(zip(GREEK_ORDER, vec.tolist())), "carr_madan": cm_greeks,
           "price": float(price), "nvidia_smi": smi}
    for label, fn in (
            ("heston_exact_price_and_greeks", lambda: ht.heston_exact_price_and_greeks(prob, mc)),
            ("BatchGreekProblem(ReverseAD)", lambda: ht.solve(
                ht.BatchGreekProblem(prob, lenses), ht.ReverseAD(), mc)),
            ("solve (price only)", lambda: ht.solve(prob, mc))):
        out[label] = eval_profile(fn, device)
        say_profile(f"{label}, {EXACT_GREEK_PAIRS} pairs ({smi})", out[label])
    return out


def lsm_price_se(sol) -> float:
    """Standard error of an antithetic LSM price, over the pair means of the
    per-path discounted stopping values (the groups are the halves of the
    flattened path axis)."""
    import torch

    from hedgehog_tpu_torch.methods.lsm import _lsm_setup

    log_disc, _ = _lsm_setup(sol.problem, sol.method)
    tau, value = sol.stopping_info
    v = torch.exp(tau * log_disc) * value
    half = v.numel() // 2
    return float(torch.std(0.5 * (v[:half] + v[half:])) / math.sqrt(half))


def phase_american(smi: str, device: str) -> dict:
    """Early exercise on the card: CRR(2000) for the American put (S = K =
    100, r = 0.05, sigma = 0.2, 1y) equal to the CPU's (1e-12) and the CRR
    goldens; LSM (BlackScholesExact, 2^17 pairs x 100 steps, degree 5) and
    the quarterly Bermudan put within 4 SE + 1% of CRR's; conditional LSM
    under Heston; the Andersen-Broadie dual bound (4096 x 128 nested paths)
    bracketing CRR(2000) (Black-Scholes) and an Euler-grid LSM primal
    (Heston).  Prints each solve's wall and idle share."""
    import torch

    import hedgehog_tpu_torch as ht

    say(f"phase 3 (american): CRR, LSM and the dual bound on {device}; {smi}")
    out = {"nvidia_smi": smi}
    ref, exp1 = dt.date(2020, 1, 1), dt.date(2021, 1, 1)
    bs = ht.BlackScholesInputs(ref, 0.05, 100.0, 0.2)

    def put(style, market=bs, strike=100.0, expiry=exp1):
        return ht.PricingProblem(ht.VanillaOption(strike, expiry, style, ht.Put(), ht.Spot()),
                                 market)

    # CRR: the card against the CPU, and the goldens
    crr, crr_cpu = ht.CoxRossRubinsteinMethod(CRR_STEPS, device), ht.CoxRossRubinsteinMethod(
        CRR_STEPS, "cpu")
    am = ht.solve(put(ht.American()), crr).price
    am_cpu = float(ht.solve(put(ht.American()), crr_cpu).price)
    check(am.device.type == torch.device(device).type, f"CRR priced on {am.device}")
    check(abs(float(am) - am_cpu) <= 1e-12 * abs(am_cpu),
          f"CRR({CRR_STEPS}) on the card {float(am)!r} against the CPU's {am_cpu!r}")
    gold_market = ht.BlackScholesInputs(ref, 0.2, 1.0, 0.4)
    for cp, und, golden in AMERICAN_GOLDENS:
        gp = ht.PricingProblem(ht.VanillaOption(1.0, dt.date(2020, 12, 31), ht.American(),
                                                getattr(ht, cp)(), getattr(ht, und)()),
                               gold_market)
        got = float(ht.solve(gp, ht.CoxRossRubinsteinMethod(80, device)).price)
        check(abs(got - golden) <= 1e-8, f"CRR golden {cp} on {und}: {got!r}, golden {golden!r}")
    say(f"  CRR({CRR_STEPS}) American put {float(am):.10f} (the CPU's {am_cpu:.10f}, "
        "within 1e-12); the two CRR(80) goldens within 1e-8")

    # LSM against CRR, American and quarterly Bermudan
    cfg = ht.SimulationConfig(LSM_PAIRS, LSM_STEPS, ht.Antithetic(), 12345)
    lsm = ht.LSM(ht.MonteCarlo(ht.LognormalDynamics(), ht.BlackScholesExact(), cfg,
                               device=device), LSM_DEGREE)
    quarters = (dt.date(2020, 4, 1), dt.date(2020, 7, 1), dt.date(2020, 10, 1))
    rows = {}
    for label, style in (("American", ht.American()), ("Bermudan", ht.Bermudan(quarters))):
        prob = put(style)
        sol = ht.solve(prob, lsm)
        lattice = float(ht.solve(prob, crr).price)
        se = lsm_price_se(sol)
        err = abs(float(sol.price) - lattice)
        check(err <= 4.0 * se + 0.01 * lattice,
              f"LSM {label} put {float(sol.price)} against CRR {lattice}: {err} > 4 SE ({se}) + 1%")
        rows[label] = {"lsm": float(sol.price), "crr": lattice, "se": se,
                       **eval_profile(lambda: ht.solve(prob, lsm), device)}
        say(f"  LSM {label} put ({LSM_PAIRS} pairs x {LSM_STEPS} steps, degree {LSM_DEGREE}): "
            f"{float(sol.price):.6f}, CRR {lattice:.6f}, SE {se:.6f}")
        say_profile(f"LSM {label} solve ({smi})", rows[label])
    rows["CRR"] = eval_profile(lambda: ht.solve(put(ht.American()), crr), device)
    say_profile(f"CRR({CRR_STEPS}) solve ({smi})", rows["CRR"])
    out["lsm"] = rows

    # conditional LSM under Heston, and the dual bounds
    hm = ht.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, *HESTON.values())
    dual_exp = dt.date(2024, 12, 31)
    hprob = put(ht.American(), hm, 110.0, dual_exp)
    lsm_c = ht.LSM(ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True),
                                 ht.SimulationConfig(20_000, DUAL_STEPS, seed=0), device=device),
                   degree=3)
    p_cond = float(ht.solve(hprob, lsm_c).price)
    lsm_e = ht.LSM(ht.MonteCarlo(ht.HestonDynamics(), ht.EulerMaruyama(),
                                 ht.SimulationConfig(30_000, 48, seed=2), device=device), degree=4)
    p_euler = float(ht.solve(hprob, lsm_e).price)
    check(abs(p_cond - p_euler) <= 2e-2 * p_euler,
          f"conditional LSM {p_cond} against the Euler-grid LSM {p_euler} (rel 2e-2)")
    db = ht.lsm_dual_bound(hprob, lsm_c, n_outer=DUAL_OUTER, n_inner=DUAL_INNER)
    lo, up = float(db.lower), float(db.upper)
    check(lo <= up and lo - 3 * float(db.se_lower) <= p_euler
          and up + 3 * float(db.se_upper) >= p_euler - 0.05,
          f"Heston dual bound [{lo}, {up}] does not bracket the Euler-grid LSM {p_euler}")
    say(f"  Heston conditional LSM {p_cond:.6f}, Euler-grid LSM {p_euler:.6f}; dual bound "
        f"[{lo:.6f}, {up:.6f}] (SE {float(db.se_lower):.6f}, {float(db.se_upper):.6f}), "
        f"primal {float(db.primal):.6f}")
    bs_dual = ht.BlackScholesInputs(dt.date(2024, 1, 1), 0.05, 100.0, 0.3)
    bprob = put(ht.American(), bs_dual, 110.0, dual_exp)
    truth = float(ht.solve(bprob, crr).price)
    lsm_b = ht.LSM(ht.MonteCarlo(ht.LognormalDynamics(), ht.EulerMaruyama(),
                                 ht.SimulationConfig(20_000, DUAL_STEPS, seed=0), device=device),
                   degree=5)
    db_b = ht.lsm_dual_bound(bprob, lsm_b, n_outer=DUAL_OUTER, n_inner=DUAL_INNER)
    lo_b, up_b = float(db_b.lower), float(db_b.upper)
    check(lo_b - 3 * float(db_b.se_lower) <= truth <= up_b + 3 * float(db_b.se_upper)
          and float(db_b.gap) < 0.05 * truth,
          f"Black-Scholes dual bound [{lo_b}, {up_b}] against CRR {truth}")
    say(f"  Black-Scholes dual bound [{lo_b:.6f}, {up_b:.6f}] brackets CRR({CRR_STEPS}) "
        f"{truth:.6f}, gap {float(db_b.gap):.6f}")
    out["dual"] = {
        "heston": {"lower": lo, "upper": up, "primal": float(db.primal), "euler_lsm": p_euler,
                   "conditional_lsm": p_cond},
        "black_scholes": {"lower": lo_b, "upper": up_b, "crr": truth, "gap": float(db_b.gap)},
    }
    for label, fn in (("conditional LSM solve", lambda: ht.solve(hprob, lsm_c)),
                      ("lsm_dual_bound (Heston)", lambda: ht.lsm_dual_bound(
                          hprob, lsm_c, n_outer=DUAL_OUTER, n_inner=DUAL_INNER)),
                      ("lsm_dual_bound (Black-Scholes)", lambda: ht.lsm_dual_bound(
                          bprob, lsm_b, n_outer=DUAL_OUTER, n_inner=DUAL_INNER))):
        out[label] = eval_profile(fn, device)
        say_profile(f"{label} ({smi})", out[label])
    return out


#: the phases ``--only`` runs alone
ONLY_PHASES = {"exact greeks": phase_exact_greeks, "american": phase_american}


def only_main(names: str) -> int:
    """``--only "exact greeks,american"``: the named phases alone on the card
    (they launch no CUDA kernel, so nothing is built)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = smi_query("name,power.limit")
    say(smi)
    result = {}
    for name in names.split(","):
        check(name in ONLY_PHASES, f"no phase {name!r}; --only takes {sorted(ONLY_PHASES)}")
        result[name] = ONLY_PHASES[name](smi, "cuda")
    result["elapsed_s"] = time.perf_counter() - t0
    say(json.dumps(result))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def digest_main(argv: list) -> int:
    """``--digest OUT [--root DIR]``: build the kernels of the package in DIR
    (default: beside this script) and write its :func:`output_digests` to
    OUT as JSON, with :func:`repaired_cells` under ``cells``; ``--times OUT
    [--root DIR]`` likewise its :func:`kernel_times`.  ``--compare A B``:
    print, for every output either digest file holds, whether the two trees'
    bytes are equal (with its repaired cells), then the counts."""
    if argv[0] == "--compare" and len(argv) == 3:
        a, b = (json.loads(open(p).read()) for p in argv[1:])
        cells = b.pop("cells", None) or a.pop("cells", None) or {}
        a.pop("cells", None)
        keys = sorted(set(a) | set(b), key=lambda k: (int(k.split()[0][1:]), k))
        same = [k for k in keys if k in a and k in b and a[k] == b[k]]
        for k in keys:
            state = "only in one" if (k in a) != (k in b) else "equal" if k in same else "DIFFERENT"
            hits = cells.get(k.removesuffix(" resident"))
            say(f"  {k}: {state}" + (f" (repaired cells in its draws: {hits})" if hits else ""))
        both = sum(k in a and k in b for k in keys)
        say(json.dumps({"compared": both, "equal": len(same),
                        "different": [k for k in keys if k in a and k in b and k not in same],
                        "only_in_one": [k for k in keys if (k in a) != (k in b)]}))
        return 0
    only = None
    if argv[0] == "--times" and len(argv) >= 4 and argv[-2] == "--only":
        only, argv = tuple(argv[-1].split(",")), argv[:-2]
    if (argv[0] not in ("--digest", "--times") or len(argv) not in (2, 4)
            or (len(argv) == 4 and argv[2] != "--root")):
        print("usage: chip_smoke.py [--digest OUT [--root DIR] | --times OUT [--root DIR] "
              "[--only K4,K18,...] | --compare A B]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if len(argv) == 4:
        sys.path.insert(0, argv[3])
    from hedgehog_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.build_library()
    cuda_lib.load_library()
    if argv[0] == "--digest":
        result = output_digests("cuda")
        result["cells"] = repaired_cells("cuda")
    else:
        result = kernel_times("cuda", only)
    with open(argv[1], "w") as f:
        json.dump(result, f, indent=1)
    say(f"{len(result)} {argv[0][2:]} entries of the kernels built into {lib.parent}")
    return 0


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs one CUDA card",
              file=sys.stderr)
        return 2
    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import cuda_lib
    from hedgehog_tpu_torch.ops.gbm_kernel import GBM_KERNEL
    from hedgehog_tpu_torch.ops.heston_exact_kernel import (
        EXACT_PRICE_KERNEL,
        EXACT_SURFACE_KERNEL,
        EXACT_VALUES_KERNEL,
    )
    from hedgehog_tpu_torch.ops.heston_kernel import EULER_KERNEL
    from hedgehog_tpu_torch.ops.heston_qe_greeks_kernel import (
        QE_GREEKS_KERNEL,
        QE_SURFACE_JAC_KERNEL,
        QE_VJP_KERNEL,
    )
    from hedgehog_tpu_torch.ops.heston_qe_kernel import (
        QE_PRICE_KERNEL,
        QE_SURFACE_KERNEL,
        QE_VALUES_KERNEL,
        QEM_PRICE_KERNEL,
        QEM_TERMINAL_KERNEL,
    )
    from hedgehog_tpu_torch.ops.rbergomi_kernel import (
        RB_GREEKS_KERNEL,
        RB_PRICE_KERNEL,
        RB_SMILE_KERNEL,
        RB_VALUES_KERNEL,
        RB_VJP_CURVE_KERNEL,
        RB_VJP_KERNEL,
    )

    say("phase 1: device")

    smi = smi_query("name,power.limit")
    say(smi)
    sm_clock_hz = float(smi_query("clocks.max.sm").split()[0]) * 1e6
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    lib, build_s = cuda_lib.build_library()
    cuda_lib.load_library()
    say(f"  kernels built in {build_s:.3f} s into {lib.parent}")
    kernel, spill = "?", ""
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            say(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}; {spill}")

    T = float(ht.yearfrac(REF, EXPIRY))
    market = ht.HestonInputs(REF, R, SPOT, *HESTON.values())
    payoff = ht.VanillaOption(STRIKE, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    prob = ht.PricingProblem(payoff, market)
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics())).price)
    bs_prob = ht.PricingProblem(payoff, ht.BlackScholesInputs(REF, R, SPOT, BS_SIGMA))
    bs_price = float(ht.solve(bs_prob, ht.BlackScholesAnalytic()).price)

    records = phase_kernels(T, CHECK_PAIRS, "cuda")
    records.update(phase_qe_kernels(T, CHECK_PAIRS, "cuda"))
    records.update(phase_terminal_kernels(T, CHECK_PAIRS, "cuda"))
    records.update(phase_surface_kernels(CHECK_PAIRS, "cuda"))
    records.update(phase_rb_kernels(CHECK_PAIRS, "cuda"))
    rb_occupancy = phase_rb_occupancy("cuda")
    errs = phase_main_shapes(T, SOLVE_PAIRS, EULER_PAIRS, SERVING_BLOCKS, SERVING_BATCHES, "cuda")
    terminal_errs, k13_times = phase_terminal_shapes(T, QEM_SOLVE_PAIRS, GBM_PAIRS,
                                                     SERVING_BLOCKS, SERVING_BATCHES, "cuda")
    errs.update(terminal_errs)
    errs.update(phase_surface_shapes("cuda"))
    errs.update(phase_rb_shapes("cuda"))
    past_limits = phase_past_old_limits(T, "cuda")
    global_tables = phase_global_tables(T, "cuda")
    records["gbm_exact_terminal"].update(k13_times)
    for name, err in errs.items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    # the timed calls' shapes: CHECK_PAIRS pairs on the PRNG stream, K13 solve's pairs;
    # the surfaces at the full-width grid (steps or segments over all expiries)
    _, _, qe_seg, ex_seg = surface_grid()
    timed_steps = {"heston_euler_terminal": EULER_STEPS, "heston_exact_mixing_values": SEGMENTS,
                   "heston_exact_mixing_vanilla_price": SEGMENTS, "heston_qe_terminal": QEM_STEPS,
                   "heston_qe_call_price": QEM_STEPS, "gbm_exact_terminal": 1,
                   "heston_qe_mixing_surface_price": sum(qe_seg),
                   "heston_qe_mixing_surface_price_and_jacobian": sum(qe_seg),
                   "heston_exact_mixing_surface_price": sum(ex_seg),
                   "rbergomi_mixing_values": RB_STEPS, "rbergomi_mixing_vanilla_price": RB_STEPS,
                   "rbergomi_mixing_price_and_greeks": RB_STEPS, "_rb_values_vjp": RB_STEPS,
                   "_rb_values_vjp_curve": RB_STEPS, "rbergomi_mixing_smile_price": RB_STEPS}
    points = {"rbergomi_mixing_smile_price": len(CAL_STRIKES)}
    points.update((name, len(SURF_EXPIRIES) * len(SURF_STRIKES)) for name in records
                  if "surface" in name)
    for name, rec in records.items():
        pairs = GBM_PAIRS if name == "gbm_exact_terminal" else CHECK_PAIRS
        b = bound(name, pairs, timed_steps.get(name, QE_STEPS), sm_clock_hz,
                  points=points.get(name, 1),
                  expiries=len(SURF_EXPIRIES) if "surface" in name else 1)
        say(f"  bound {name}: {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['flops']:.4g} fp32 "
            f"FLOPs, {b['mufu']:.4g} MUFU, {b['alu']:.4g} ALU, {b['imad']:.4g} IMAD.WIDE, "
            f"{b['bytes']:.4g} bytes; "
            f"{b['bound_fp_ms']:.4f} ms without the integer term); kernel {rec['ms']:.4f} ms")
        rec.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        rec.setdefault("library_ms", None)

    kernels = {"heston_euler_terminal": EULER_KERNEL,
               "heston_exact_mixing_values": EXACT_VALUES_KERNEL,
               "heston_exact_mixing_vanilla_price": EXACT_PRICE_KERNEL,
               "heston_qe_mixing_values": QE_VALUES_KERNEL,
               "heston_qe_mixing_vanilla_price": QE_PRICE_KERNEL,
               "heston_qe_mixing_price_and_greeks": QE_GREEKS_KERNEL,
               "_mixing_values_vjp": QE_VJP_KERNEL,
               "heston_qe_terminal": QEM_TERMINAL_KERNEL,
               "heston_qe_call_price": QEM_PRICE_KERNEL,
               "gbm_exact_terminal": GBM_KERNEL}
    for k in kernels.values():
        k.launches = 0
    phase_main_path(prob, cm, SOLVE_PAIRS, EULER_PAIRS, "cuda")
    phase_terminal_path(prob, cm, bs_prob, bs_price, "cuda")
    phase_qe_autograd(prob, SOLVE_PAIRS, "cuda")
    serving = phase_serving(T, cm, SERVING_BLOCKS, SERVING_BATCHES, "cuda")
    qe_serving = phase_qe_serving(T, cm, prob, SERVING_BLOCKS, SERVING_BATCHES, "cuda")
    qem_serving = phase_qem_serving(T, cm, SERVING_BLOCKS, SERVING_BATCHES, "cuda")
    launches = {name: k.launches for name, k in kernels.items()}
    say(f"launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    heston_cells = phase_heston_cells(prob, "cuda")

    # the surface path, with its own launch window
    surface_kernels = {"heston_qe_mixing_surface_price": QE_SURFACE_KERNEL,
                       "heston_exact_mixing_surface_price": EXACT_SURFACE_KERNEL,
                       "heston_qe_mixing_surface_price_and_jacobian": QE_SURFACE_JAC_KERNEL}
    for k in (*kernels.values(), *surface_kernels.values()):
        k.launches = 0
    surf_market = ht.HestonInputs(REF, R, SPOT, *HESTON.values())
    cm_surf = carr_madan_surface(surf_market, SURF_EXPIRIES, SURF_STRIKES)
    say(f"Carr-Madan surface {[[round(float(x), 6) for x in row] for row in cm_surf]}")
    biases = phase_surface_path(cm_surf, "cuda")
    calibration = phase_surface_calibration("cuda")
    surface_serving = phase_surface_serving(cm_surf, "cuda")
    surface_launches = {name: k.launches for name, k in surface_kernels.items()}
    say(f"launches on the surface path: {surface_launches}")
    for name, n in surface_launches.items():
        check(n > 0, f"{name} was not launched on the surface path")
    launches.update(surface_launches)

    # the rough-Bergomi path, with its own launch window
    rb_kernels = {"rbergomi_mixing_values": RB_VALUES_KERNEL,
                  "rbergomi_mixing_vanilla_price": RB_PRICE_KERNEL,
                  "rbergomi_mixing_price_and_greeks": RB_GREEKS_KERNEL,
                  "_rb_values_vjp": RB_VJP_KERNEL,
                  "_rb_values_vjp_curve": RB_VJP_CURVE_KERNEL,
                  "rbergomi_mixing_smile_price": RB_SMILE_KERNEL}
    for k in (*kernels.values(), *surface_kernels.values(), *rb_kernels.values()):
        k.launches = 0
    rb_path = phase_rb_path("cuda")
    rb_curve = phase_rb_curve("cuda")
    rb_smile = phase_rb_smile(rb_path, "cuda")
    rb_surface = phase_rb_surface("cuda")
    rb_serving = phase_rb_serving(rb_path["float64"], "cuda")
    rb_launches = {name: k.launches for name, k in rb_kernels.items()}
    say(f"launches on the rough-Bergomi path: {rb_launches}")
    for name, n in rb_launches.items():
        check(n > 0, f"{name} was not launched on the rough-Bergomi path")
    launches.update(rb_launches)

    # the calibration path, with its own launch window for K7 and K11
    calibration_path = phase_calibration_path(smi, "cuda")
    # greeks through the exact-mixing flagship, and early exercise (no kernel)
    exact_greeks = phase_exact_greeks(smi, "cuda")
    american = phase_american(smi, "cuda")

    say(json.dumps({"serving": serving, "qe_serving": qe_serving, "qem_serving": qem_serving,
                    "surface_serving": surface_serving, "surface_bias_bp": biases,
                    "calibration": calibration, "rb_path": rb_path, "rb_serving": rb_serving,
                    "rb_occupancy": rb_occupancy, "rb_curve": rb_curve, "rb_smile": rb_smile,
                    "rb_surface": rb_surface, "heston_cells": heston_cells,
                    "past_old_limits": past_limits, "global_tables": global_tables,
                    "calibration_path": calibration_path, "exact_greeks": exact_greeks,
                    "american": american, "build_s": build_s, "nvidia_smi": smi,
                    "elapsed_s": time.perf_counter() - t_start}))
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
        if len(sys.argv) == 3 and sys.argv[1] == "--only":
            sys.exit(only_main(sys.argv[2]))
        sys.exit(digest_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
