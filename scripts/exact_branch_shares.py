"""The branches the exact segment takes on chip_smoke.py's market, and the
work they cost beside the cheap-branch count of chip_smoke's bound.

chip_smoke.py's ``EXACT_SEG`` counts the cheaper side of every branch of
``exact_segment`` (csrc/heston_exact.cu): no Poisson trip, the asymptotic
Bessel ratio, and in both gamma quantiles the series e1 and the series
lambda.  This script runs the plain twin of K2 (``ops/heston_exact_kernel.py``,
the kernel's arithmetic on the CPU) on chip_smoke's market, 2 segments, both
antithetic groups, records the argument of each branch as the segment
takes it, and prints per stream:

- the Poisson count's trips (the CDF loop runs min(n + 1, kmax) times);
- the share of gamma quantiles whose e1 takes the Newton side (|eta0| >=
  0.1), whose lambda(eta0) there takes Newton (|eta0| >= 0.5), and whose
  final lambda(eta) takes Newton (|eta| >= 0.5);
- the share of segments whose Bessel ratio runs the 16-step continued
  fraction (z < 24) rather than the asymptotic ratio;

then the per-segment work of those branches at these shares (hand counts
from csrc/heston_exact.cu, in chip_smoke's units) against ``EXACT_SEG``,
and the bounds of K2 (the values) and K3 (the price) at 2^20 pairs both
ways on an H100 (chip_smoke's peaks at the 1980 MHz SM clock chip_smoke
reads there).

Run on any host (CPU only, a few seconds):

    python3 scripts/exact_branch_shares.py [--pairs 65536]
"""

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hedgehog_tpu_torch.models.heston_exact import GQ_NEWTON, GQ_NEWTON_E1, poisson_kmax  # noqa: E402
from hedgehog_tpu_torch.ops import heston_exact_kernel as ek  # noqa: E402

SM_CLOCK_HZ = 1.98e9  # the H100's max SM clock, as chip_smoke reads it there
KERNELS = {"k2": "heston_exact_mixing_values", "k3": "heston_exact_mixing_vanilla_price"}

# hand counts (fp32 FLOPs, MUFU) of the branches, csrc/heston_exact.cu
POISSON_TRIP = (4, 0)  # the test, p * mu * (1/k), cdf + p
LAM_SERIES = (12, 0)  # six FMAs
LAM_START = cs._ops((7, 0))  # the cube and its clamp, the target
LAM_TRIP = cs._ops((11, 0), cs.LOG, cs.RCP)  # f, the guarded denominator, the step
E1_SERIES = (5, 0)
E1_NEWTON = cs._ops((3, 0), cs.LOG, (2, cs.RCP))  # log(eta0 / w) / eta0, past lambda(eta0)
CF_STEP = cs._ops((5, 0), cs.RCP)  # r = z / (2 (nu + m) + z r)
ASYMPTOTIC = cs._ops((12, 0), (2, cs.RCP))


def record(pairs: int, qmc: bool) -> dict:
    """The branch arguments of every segment of ``pairs`` antithetic pairs
    (both groups), seed 5, through the twin's own functions."""
    T = 366 / 365
    dt_x = T / cs.SEGMENTS
    px = torch.as_tensor(ek._exact_params(*cs.MARKET_ARGS, dt_x, cs.SEGMENTS, cs.STRIKE, 1.0))
    table = torch.as_tensor(ek.sobol_table(5, 4 * cs.SEGMENTS)) if qmc else None
    h = cs.HESTON
    kmax = poisson_kmax(h["kappa"], h["theta"], h["sigma"], dt_x, h["V0"])
    seen = {"alpha": [], "eta0": [], "eta": [], "z": []}
    lam, gq, bessel = ek._lam_of_eta, ek._gamma_qtl, ek._bessel_ratio_tile

    def lam_rec(eta, trips):
        seen["eta0" if trips == GQ_NEWTON_E1 else "eta"].append(eta.flatten())
        return lam(eta, trips)

    def gq_rec(alpha, z):
        seen["alpha"].append(alpha.flatten())
        return gq(alpha, z)

    def bessel_rec(z, c):
        seen["z"].append(z.flatten())
        return bessel(z, c)

    ek._lam_of_eta, ek._gamma_qtl, ek._bessel_ratio_tile = lam_rec, gq_rec, bessel_rec
    try:
        ek.heston_exact_mixing_values_plain(px, table, pairs, cs.SEGMENTS, True, kmax, 5, 0, 0)
    finally:
        ek._lam_of_eta, ek._gamma_qtl, ek._bessel_ratio_tile = lam, gq, bessel
    assert GQ_NEWTON != GQ_NEWTON_E1
    # the quantiles alternate: the boost's Gamma(d/2 + N + 1), then the
    # integrated variance's; N = alpha - 1 - d/2 of the first
    d_half = float(ek._exact_c(px)["d_half"])
    boost = torch.cat(seen["alpha"][0::2])
    return dict(n=torch.round(boost - 1.0 - d_half), kmax=kmax,
                eta0=torch.cat(seen["eta0"]).abs(), eta=torch.cat(seen["eta"]).abs(),
                z=torch.cat(seen["z"]))


def shares(rec: dict) -> dict:
    trips = torch.clamp(rec["n"] + 1.0, max=rec["kmax"])
    newton_e1 = rec["eta0"] >= 0.1
    return dict(
        segments=int(rec["z"].numel()),
        poisson_mean_count=float(rec["n"].mean()),
        poisson_share_zero=float((rec["n"] == 0).double().mean()),
        poisson_mean_trips=float(trips.mean()),
        poisson_max_trips=int(trips.max()),
        gamma_e1_newton=float(newton_e1.double().mean()),
        gamma_lam_eta0_newton=float((rec["eta0"] >= 0.5).double().mean()),
        gamma_final_newton=float((rec["eta"] >= 0.5).double().mean()),
        bessel_fraction=float((rec["z"] < 24.0).double().mean()),
        bessel_z_mean=float(rec["z"].mean()),
    )


def segment_work(s: dict) -> tuple:
    """(fp32 FLOPs, MUFU) of one exact segment at these branch shares: the
    cheap count plus each branch's extra over its cheap side (a Newton
    lambda's start at a negative eta adds an exp, not counted)."""
    def scale(k, t):
        return (k * t[0], k * t[1])

    lam_newton = cs._ops(LAM_START, (GQ_NEWTON_E1, LAM_TRIP))
    e1_extra = cs._ops(scale(s["gamma_lam_eta0_newton"], lam_newton),
                       scale(s["gamma_e1_newton"] - s["gamma_lam_eta0_newton"], LAM_SERIES),
                       scale(s["gamma_e1_newton"], E1_NEWTON),
                       scale(-s["gamma_e1_newton"], E1_SERIES))
    final_extra = scale(s["gamma_final_newton"],
                        cs._ops(LAM_START, (GQ_NEWTON, LAM_TRIP), scale(-1, LAM_SERIES)))
    bessel_extra = scale(s["bessel_fraction"],
                         cs._ops((ek._CF_ITERS, CF_STEP), scale(-1, ASYMPTOTIC)))
    poisson = scale(s["poisson_mean_trips"], POISSON_TRIP)
    return cs._ops(cs.EXACT_SEG, poisson, (2, e1_extra), (2, final_extra), bessel_extra)


def bound_ms(name: str, seg: tuple, pairs: int, qmc: bool) -> float:
    """The bound of exact kernel ``name`` (K2 ``heston_exact_mixing_values``
    or K3 ``heston_exact_mixing_vanilla_price``) at ``pairs`` pairs with
    ``seg`` a segment: the draws, closes and bytes as chip_smoke's ``work``
    counts them, the stream's integer operations as its ``int_ops``."""
    flops, mufu, nbytes = cs.work(name, pairs, cs.SEGMENTS, qmc)
    alu, imad = cs.int_ops(name, pairs, cs.SEGMENTS, qmc)
    cheap_f, cheap_m = cs.EXACT_SEG
    flops += pairs * 2 * cs.SEGMENTS * (seg[0] - cheap_f) + 2 * imad
    mufu += pairs * 2 * cs.SEGMENTS * (seg[1] - cheap_m)
    return 1e3 * max(flops / cs.FP32_PEAK, mufu / (cs.MUFU_PER_CLK * cs.SMS * SM_CLOCK_HZ),
                     alu / (cs.INT_PER_CLK * cs.SMS * SM_CLOCK_HZ), nbytes / cs.MEM_PEAK)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2**16)
    args = ap.parse_args()
    out = {}
    for qmc in (False, True):
        s = shares(record(args.pairs, qmc))
        seg = segment_work(s)
        s.update(segment_flops=seg[0], segment_mufu=seg[1], cheap_flops=cs.EXACT_SEG[0],
                 cheap_mufu=cs.EXACT_SEG[1])
        for k, name in KERNELS.items():
            s[f"{k}_bound_ms_cheap"] = cs.bound(name, cs.CHECK_PAIRS, cs.SEGMENTS, SM_CLOCK_HZ,
                                               qmc)["bound_ms"]
            s[f"{k}_bound_ms_data"] = bound_ms(name, seg, cs.CHECK_PAIRS, qmc)
        out["QMC" if qmc else "PRNG"] = s
    print(json.dumps(out, indent=1))
    for name, s in out.items():
        print(f"{name}: Bessel fraction {s['bessel_fraction']:.4f} of segments (mean z "
              f"{s['bessel_z_mean']:.3f}); gamma e1 Newton {s['gamma_e1_newton']:.4f}, lambda(eta0) "
              f"Newton {s['gamma_lam_eta0_newton']:.4f}, final lambda Newton "
              f"{s['gamma_final_newton']:.4f}; Poisson mean trips {s['poisson_mean_trips']:.4f} "
              f"(count 0: {s['poisson_share_zero']:.4f}); a segment {s['segment_flops']:.1f} FLOPs "
              f"+ {s['segment_mufu']:.2f} MUFU against the cheap {s['cheap_flops']:.0f} + "
              f"{s['cheap_mufu']:.0f}; bounds at 2^20 pairs "
              + ", ".join(f"{k.upper()} {s[f'{k}_bound_ms_data']:.4f} ms against "
                          f"{s[f'{k}_bound_ms_cheap']:.4f}" for k in KERNELS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
