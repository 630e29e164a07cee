"""The command line: argument parsing, the guards, one run, the result.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared with the reference, each
beside its limit.  No result is printed, and the exit code is not 0, when
the card is missing, when a JAX module is loaded, or when the run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import cells, guard, harness

EXIT_NO_CARD, EXIT_JAX = 2, 3


def _say(msg: str) -> None:
    print(f"hhbench: {msg}", file=sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="hhbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="any whole number")
    p.add_argument("--seconds", type=float, required=True, help="length of the timed window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: the per-layer metrics from a profiled part of the window")
    return p.parse_args(argv)


def card_state() -> str:
    """The card's name, SM clock, power draw and power limit, as nvidia-smi
    reads them (printed beside the numbers, never used in them)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read ({exc})"


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, adapt=None) -> dict:
    """One run of ``cell`` on ``device`` ("cuda", or "cpu" for the tests);
    returns the result object.  ``adapt(kind)``, where given, may change
    the request kind before the run (control.py and the tests put other
    code in the program's place with it)."""
    import torch

    cuda = device == "cuda"
    if cuda:
        from hedgehog_tpu_torch.ops import cuda_lib

        torch.cuda.set_device(0)
        _, build_s = cuda_lib.build_library()
        cuda_lib.load_library()
        _say(f"kernel library: built in {build_s:.3f} s (0: found built in the checkout)")
        _say(f"card before the window: {card_state()}")
    kind = cells.request_kind(cell).Kind(cell.config, cell.traffic, device)
    if adapt is not None:
        adapt(kind)
    client = harness.Client(kind, cell, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    harness.warm_up(client, trace)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    records, window, traced = harness.window(client, seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        _say(f"card after the window: {card_state()}")
        torch.cuda.empty_cache()
    checks = harness.check(kind, cell, seed, records)
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = harness.Run(cell, setup_s, records, window, traced, cells.peaks(name))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": harness.passed(checks), "attempted": len(records),
              "failed": sum(r.error is not None for r in records), "metrics": metrics,
              "device": dev}
    if trace and traced is not None and traced.spans:
        dev["busy_s"], dev["window_s"] = traced.busy()
        from .trace import breakdown

        result["breakdown"] = breakdown(traced)
    errors = sorted({r.error for r in records if r.error})
    if errors:
        _say(f"failed requests: {errors[:3]}")
    # a number that is not finite is written as null (and has failed)
    result["checks"] = {k: {"value": c["value"] if c["value"] == c["value"] else None,
                            "limit": c["limit"]} for k, c in checks.items()}
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    hits = guard.forbidden_modules()
    if hits:
        _say(f"JAX modules loaded at start: {hits}")
        return EXIT_JAX
    root = cells.ROOT
    # the caches a run may fill sit at fixed paths in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "hhbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "hhbench" / "torch_extensions")
    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _say(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}")
        return EXIT_NO_CARD
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    hits = guard.forbidden_modules()
    if hits:
        _say(f"JAX modules loaded by the run: {hits}")
        return EXIT_JAX
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
