"""Times of a kernel built in variants of a tree (its launch bounds: the
blocks an SM it is built for; its staging decision), in turns on one card.

For each variant the script copies a tree's package (``--root``, default
the repository) to ``build/variant_times/<kernel> <variant>/``, applies the
variant's edits to the sources there (each edit's text must occur once) and
times the copy with ``chip_smoke.py --times OUT --root COPY --only
KERNEL``.  The tree and the variants run in turns: the tree, each variant,
each variant again in reverse order, the tree again.

Run on a GPU host, from the repository root:

    python3 scripts/variant_times.py OUT.json --kernel "K5|K7|K11|K5 band|K7 band|K11 band"
        [--root DIR]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import phase_costs  # noqa: E402

REPO = phase_costs.REPO


def _blocks(file: str, name: str, old: int, new: int) -> list:
    """One alternative (phase_costs.make_copy's form): constant ``name``
    from ``old`` to ``new``."""
    return [[(file, f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")]]


# Per kernel (a chip_smoke.py --times --only name), variants: the blocks an
# SM each stream's build is declared for (__launch_bounds__ minimum blocks;
# nvcc caps the registers to fit them)
VARIANTS = {
    "K7": {f"{n} blocks": [[("heston_qe.cu", "__launch_bounds__(kThreads)\nqe_values_kernel(",
                             f"__launch_bounds__(kThreads, {n})\nqe_values_kernel(")]]
           for n in (5, 6)},
    "K5": {
        "PRNG 4 blocks": [[("heston_qe_terminal.cu",
                            "__launch_bounds__(kThreads, kQmc ? kTerminalQmcBlocks : kPriceBlocks)",
                            "__launch_bounds__(kThreads, kQmc ? kTerminalQmcBlocks : 4)")]],
        "QMC 3 blocks": _blocks("heston_qe_terminal.cu", "kTerminalQmcBlocks", 4, 3),
        "QMC 5 blocks": _blocks("heston_qe_terminal.cu", "kTerminalQmcBlocks", 4, 5),
    },
    # the staging decision over the QMC band (chip_smoke.py --only "K7 band" /
    # "K5 band"): the split draw staged wherever a block holds it, or never
    "K7 band": {
        "split draw at 1 block an SM": _blocks("heston_qe.cuh", "kStagedBlocks", 2, 1),
        "table in global memory": _blocks("heston_qe.cuh", "kStagedBlocks", 2, 1000),
    },
    # K11: its Philox build at 2 and 4 blocks an SM (the tree: 3), and a
    # build whose pairing is antithetic at compile time (what a build per
    # pairing would save; the timed calls are antithetic)
    "K11": {
        "PRNG 2 blocks": _blocks("heston_qe_greeks.cu", "kVjpBlocks", 3, 2),
        "PRNG 4 blocks": _blocks("heston_qe_greeks.cu", "kVjpBlocks", 3, 4),
        "antithetic build": [[("heston_qe_greeks.cu",
                               "  if (i < n_paths) {\n    const int c = ",
                               "  if (i < n_paths) {\n    constexpr bool antithetic = true;\n"
                               "    const int c = ")]],
    },
}
VARIANTS["K5 band"] = VARIANTS["K7 band"]
# K11's QMC builds at 3 blocks an SM (the tree: hh::kStagedBlocks, which
# also sets their launch bounds, so K7's two band variants rebuild them
# too): the global-table build (117 registers) past the staging decision
VARIANTS["K11 band"] = {**VARIANTS["K7 band"], "QMC 3 blocks": [[(
    "heston_qe_greeks.cu", "kQmc ? hh::kStagedBlocks : kVjpBlocks", "kQmc ? 3 : kVjpBlocks")]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--kernel", choices=sorted(VARIANTS), required=True)
    args = ap.parse_args()
    root, work = pathlib.Path(args.root).resolve(), REPO / "build" / "variant_times"
    work.mkdir(parents=True, exist_ok=True)
    trees = {"tree": root}
    for name, alternatives in VARIANTS[args.kernel].items():
        dest = work / f"{args.kernel} {name}"
        phase_costs.make_copy(root, dest, alternatives)
        trees[name] = dest
    order = list(trees) + list(reversed(trees))
    runs = {}
    for k, name in enumerate(order):
        runs.setdefault(name, []).append(
            phase_costs.times(trees[name], args.kernel, work / f"{args.kernel} {k}.json"))
    keys = [k for k, v in runs["tree"][0].items()
            if k.startswith(args.kernel.split()[0] + " ") and isinstance(v, float)]
    spans = {name: {k: [min(r[k] for r in rs), max(r[k] for r in rs)] for k in keys}
             for name, rs in runs.items()}
    result = {"kernel": args.kernel, "root": str(root), "order": order, "runs": runs,
              "ms": spans}
    pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    for name, span in spans.items():
        print(f"  {name}: " + ", ".join(f"{k} {lo:.4f}-{hi:.4f}" for k, (lo, hi) in span.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
