"""Run one cell of the benchmark: see hhbench/__init__.py and PERF.md.

    python3 hhbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up is timed from the first statement below.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this directory, heads the import path: the
# benchmark is the package ``hhbench`` and the program sits beside it
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from hhbench import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
