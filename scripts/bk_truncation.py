"""The Broadie-Kaya price's series allowance, measured on the CPU.

``HestonBroadieKaya(cf_terms=128)`` inverts ∫V's CDF from a Fourier series
of 128 terms at the step h = π/(mean + 5·std), which aliases the law past
2·(mean + 5·std), by a bisection on [0, mean + 11·std].  A pair's draws
(V_T, the inversion's uniform, the close's normal) depend on none of these,
so pricing the same pairs under other series settings isolates what each
moves.  The reference is 512 terms at std_mult 10 and hi_mult 22 (half the
step, twice the alias period and the bracket, twice the highest
frequency); beside the sampler's own settings the script prices 512 terms
at the sampler's window (the cut alone) and 256 terms at std_mult 10 (the
window alone, the sampler's highest frequency).  For each setting against
the reference it prints the mean of the per-pair discounted payoff
differences and its standard error, in price units and in bp of
Carr-Madan's price, and the largest per-pair relative ∫V difference with
the count of pairs past 1e-6, for chip_smoke.py's market (the bench market:
S = K = 100, one year, V0 = θ = 0.04, κ = 2, σ = 0.3, ρ = −0.7, r = 0.03)
and for its weekly σ = 0.1 market.  chip_smoke.py allows the sampler's
|mean| + 4 SE (BK_SERIES_BP) beside its 4 standard errors against
Carr-Madan.

Run from the repository root (CPU only; about four minutes and 10 GB of
memory at the default 32768 pairs, on 8 cores):

    python3 scripts/bk_truncation.py [--pairs 32768] [--seed 7]
"""

import argparse
import datetime as dt
import json
import math
import sys
import pathlib

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import hedgehog_tpu_torch as ht  # noqa: E402
from hedgehog_tpu_torch.distributions import broadie_kaya as bk  # noqa: E402

REF = dt.date(2024, 1, 1)
MARKETS = {
    "bench": (dt.date(2025, 1, 1), (0.04, 2.0, 0.04, 0.3, -0.7)),
    "weekly sigma 0.1": (dt.date(2024, 1, 8), (0.04, 2.0, 0.04, 0.1, -0.7)),
}
#: series settings (terms, std_mult, hi_mult)
SAMPLER = (128, 5.0, 11.0)
SETTINGS = {"sampler": SAMPLER, "more terms": (512, 5.0, 11.0), "wider window": (256, 10.0, 11.0)}
REFERENCE = (512, 10.0, 22.0)


def priced_pairs(prob, pairs, seed, setting):
    """(∫V, discounted call payoff) per pair under one series setting."""
    terms, std_mult, hi_mult = setting
    cfg = ht.SimulationConfig(pairs, 1, ht.Antithetic(), seed)
    paths = bk.broadie_kaya_paths(prob, cfg, ht.HestonBroadieKaya(cf_terms=terms), device="cpu",
                                  std_mult=std_mult, hi_mult=hi_mult)
    disc = float(ht.df(prob.market_inputs.rate, prob.payoff.expiry))
    return paths.IV, disc * torch.clamp(paths.ST - prob.payoff.strike, min=0.0).mean(dim=0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    out = {}
    for name, (expiry, heston) in MARKETS.items():
        market = ht.HestonInputs(REF, 0.03, 100.0, *heston)
        prob = ht.PricingProblem(ht.VanillaOption(100.0, expiry, ht.European(), ht.Call(),
                                                  ht.Spot()), market)
        cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics(),
                                               device="cpu")).price)
        iv_ref, pay_ref = priced_pairs(prob, args.pairs, args.seed, REFERENCE)
        out[name] = {"carr_madan": cm}
        for label, setting in SETTINGS.items():
            iv, pay = priced_pairs(prob, args.pairs, args.seed, setting)
            d = pay - pay_ref
            rel_iv = (iv - iv_ref).abs() / iv_ref
            mean, se = float(d.mean()), float(d.std() / math.sqrt(d.numel()))
            rec = {"setting": setting, "mean": mean, "se": se, "mean_bp": 1e4 * mean / cm,
                   "se_bp": 1e4 * se / cm, "allowance_bp": 1e4 * (abs(mean) + 4.0 * se) / cm,
                   "max_rel_iv": float(rel_iv.max()), "pairs_past_1e-6": int((rel_iv > 1e-6).sum())}
            out[name][label] = rec
            print(f"{name}, {label} {setting} - {REFERENCE} over {args.pairs} pairs: mean "
                  f"{mean:.3e} (SE {se:.3e}) = {rec['mean_bp']:.4f} bp (SE {rec['se_bp']:.4f}) of "
                  f"Carr-Madan {cm:.6f}; |mean| + 4 SE = {rec['allowance_bp']:.4f} bp; per-pair "
                  f"IV largest rel {rec['max_rel_iv']:.3e}, {rec['pairs_past_1e-6']} pairs past 1e-6")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
