"""K14 (rough-Bergomi per-path values) against its plain twin per path on
the card, at the chunk edges the card tests use (RB_EDGE_STEPS steps over
RB_EDGE_PAIRS pairs, seed 5, both streams, antithetic): the share of
values within rel 1e-3 of max(|twin|, 1e-3), the largest gaps, the mean's
relative gap, and at up to 9 steps how far the CPU twin is from the card's
twin by the same measure.

Run on a GPU host, from the repository root:

    python3 scripts/values_twin_gap.py
"""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def share_outside(got, want, rtol=1e-3, floor=1e-3):
    rel = (got.double() - want.double()).abs() / want.double().abs().clamp(min=floor)
    return rel > rtol, rel


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    import hedgehog_tpu_torch as ht
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    if not torch.cuda.is_available():
        print("values_twin_gap: needs a CUDA card", file=sys.stderr)
        return 2
    dev, pairs = torch.device("cuda"), cs.RB_EDGE_PAIRS
    print(cs.smi_query("name,power.limit"))
    for qmc in (True, False):
        for steps in cs.RB_EDGE_STEPS:
            cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 5, qmc)
            ins = rk._rb_trace_inputs(cs.rb_problem(), cfg, 64)
            inp = rk.rb_inputs_from_trace(ins, seed=5, qmc=qmc, device=dev)
            got = rk._rb_values(inp, pairs, True, 5, 0, 0)
            want = rk.rbergomi_mixing_values_plain(inp, pairs, True, 5, 0, 0)
            bad, rel = share_outside(got, want)
            diff = (got.double() - want.double()).abs()
            mean_rel = abs(float(got.double().mean() - want.double().mean())) / float(
                want.double().mean())
            line = (f"qmc={qmc} steps={steps}: within {1.0 - float(bad.double().mean()):.6f}, "
                    f"outside {int(bad.sum())}, largest rel {float(rel.max()):.3e}, largest abs "
                    f"gap of those outside {float(diff[bad].max()) if bad.any() else 0.0:.3e}, "
                    f"mean rel {mean_rel:.3e}")
            if steps <= 9:
                cpu = rk.rbergomi_mixing_values_plain(
                    rk.rb_inputs_from_trace(ins, seed=5, qmc=qmc, device="cpu"), pairs, True, 5,
                    0, 0)
                apart = int(share_outside(want.cpu(), cpu)[0].sum())
                line += f"; card twin against CPU twin outside {apart}"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
