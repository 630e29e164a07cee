"""Readings of the numbers that decide ``correct``, for setting their
limits: the program's (the lower readings) and the control's (the upper).

    python3 hhbench/control.py --workload <cell> --seeds 11 12 13 --mode control

runs the cell for each seed in one process, with a short window (enough
to finish and compare as many requests as a run compares), and prints one
JSON line per seed with the numbers compared.  ``--mode program`` runs the
program as a benchmark run does; ``--mode control`` puts the plain
reference, computed in the precision below the configuration's
(``precision.control``: bfloat16 under float32 paths), in the program's
place, per program call.  Needs a card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from hhbench import cells, cli  # noqa: E402


def lower_precision(config: dict):
    import torch

    return getattr(torch, config["precision"]["control"])


def control_adapter(cell: cells.Cell):
    """Puts the reference, in the control's precision, in the program's
    place."""
    dtype = lower_precision(cell.config)

    def adapt(kind):
        kind.call = lambda inputs: kind.reference_call(inputs, dtype=dtype)

    return adapt


def readings(cell: cells.Cell, seeds, mode: str, seconds: float, device: str) -> list:
    """[(seed, checks)] of each seed's run."""
    adapt = None
    if mode == "control":  # the control is not timed: no warm-up
        adapt = control_adapter(cell)
        cell.traffic["warmup_requests"] = 0
    out = []
    for seed in seeds:
        result = cli.run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                              adapt=adapt)
        out.append((seed, result["checks"], result["attempted"]))
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="hhbench/control.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=("program", "control"), required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("hhbench/control.py: no CUDA card", file=sys.stderr)
        return cli.EXIT_NO_CARD
    cell = cells.load(args.workload)
    for seed, checks, attempted in readings(cell, args.seeds, args.mode, args.seconds, "cuda"):
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "attempted": attempted, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
