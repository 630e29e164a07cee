"""The scheme allowances of chip_smoke.py's "normal and local vol" phase,
measured on the CPU.

For each Monte Carlo route of the phase (``nl_mc_routes``: the exact
Bachelier draw and the Bachelier, CEV and SABR Euler grids at 64 steps),
for the local-vol grid at 50 steps on the Heston-implied cubic surface, and
for the SLV grid at 64 steps on a leverage calibrated at the JAX defaults
(64 steps, 32768 particles, 65 bins, at mixing 1 and 0), the script prices
the phase's markets and strikes on randomised Sobol' points (``--pairs``
antithetic pairs, QMC, so the sampling error is far below a PRNG run's)
and prints the relative error against the oracle in bp: the closed form
(Bachelier, CEV, Hagan's SABR expansion), Heston Carr-Madan (local vol) or
the surface's Black-Scholes price (SLV; the leverage's own particle noise
is part of that error), with the 4-SE width a PRNG run at 2^20 pairs
would have beside it.  chip_smoke.py's ``NL_BIAS_BP`` rounds the Euler
routes' |error| up.

Run from the repository root (CPU only; about a minute at the default
2^17 pairs on 8 cores):

    python3 scripts/normal_lv_bias.py [--pairs 131072] [--seed 7]
"""

import argparse
import json
import math
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import hedgehog_tpu_torch as ht  # noqa: E402

CPU = "cpu"


def _price_and_se(prob, method, discount: float):
    """The QMC price and the standard error a PRNG run at chip_smoke's pairs
    would have (from the per-pair spread)."""
    vals = ht.mc_path_values(prob, method)
    return discount * float(vals.mean()), discount * float(vals.std()) / math.sqrt(cs.NL_PAIRS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2**17)
    ap.add_argument("--seed", type=int, default=cs.NL_SEED)
    args = ap.parse_args(argv)
    out = {}
    markets = cs.nl_markets(ht)
    for label, key, dyn, strat, steps, K, oracle in cs.nl_mc_routes(ht):
        prob = ht.PricingProblem(ht.VanillaOption(K, cs.NL_EXPIRY), markets[key])
        mc = ht.MonteCarlo(dyn, strat, ht.SimulationConfig(args.pairs, steps, ht.Antithetic(),
                                                           args.seed, True), device=CPU)
        D = float(ht.df(markets[key].rate, cs.NL_EXPIRY))
        p, se = _price_and_se(prob, mc, D)
        want = float(ht.solve(prob, oracle(device=CPU)).price)
        out[label] = {"bias_bp": 1e4 * (p / want - 1.0), "four_se_bp_at_2^20": 4e4 * se / want}
    lv = ht.BlackScholesInputs(cs.REF, cs.NL_HESTON[0], cs.NL_HESTON[1], cs.nl_lv_surface(ht, CPU))
    hm = ht.HestonInputs(cs.REF, *cs.NL_HESTON)
    cm = ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device=CPU)
    mc = ht.MonteCarlo(ht.LocalVolDynamics(), ht.EulerMaruyama(), ht.SimulationConfig(
        args.pairs, cs.NL_LV_STEPS, ht.Antithetic(), args.seed, True), device=CPU)
    for K, tol in cs.NL_LV_CASES:
        prob = ht.PricingProblem(ht.VanillaOption(K, cs.NL_EXPIRY), lv)
        p, se = _price_and_se(prob, mc, float(ht.df(lv.rate, cs.NL_EXPIRY)))
        want = float(ht.solve(ht.PricingProblem(prob.payoff, hm), cm).price)
        out[f"local vol K={K:g}"] = {"bias_bp": 1e4 * (p / want - 1.0),
                                     "four_se_bp_at_2^20": 4e4 * se / want, "bound_bp": 1e4 * tol}
    for mixing in (1.0, 0.0):
        m = cs.nl_slv_market(ht, mixing, CPU)
        m = m.with_leverage(ht.calibrate_leverage(m, cs.NL_SLV_EXPIRY, device=CPU))
        mc = ht.MonteCarlo(ht.SLVDynamics(), ht.EulerMaruyama(), ht.SimulationConfig(
            args.pairs, cs.NL_STEPS, ht.Antithetic(), args.seed, True), device=CPU)
        bs = ht.BlackScholesInputs(cs.NL_SLV_REF, 0.03, 100.0, m.sigma_surface)
        for K in cs.NL_SLV_STRIKES:
            prob = ht.PricingProblem(ht.VanillaOption(K, cs.NL_SLV_EXPIRY), m)
            p, se = _price_and_se(prob, mc, float(ht.df(m.rate, cs.NL_SLV_EXPIRY)))
            want = float(ht.solve(ht.PricingProblem(prob.payoff, bs),
                                  ht.BlackScholesAnalytic(device=CPU)).price)
            out[f"SLV mixing {mixing:g} K={K:g}"] = {
                "bias_bp": 1e4 * (p / want - 1.0), "four_se_bp_at_2^20": 4e4 * se / want,
                "bound_bp": 1e4 * cs.NL_SLV_RTOL}
    out["pairs"], out["seed"] = args.pairs, args.seed
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    torch.set_num_threads(min(8, torch.get_num_threads()))
    sys.exit(main())
