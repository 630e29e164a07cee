"""hhbench: the benchmark of hedgehog_tpu_torch on NVIDIA GPUs.

``python3 hhbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line.  Everything
that belongs to one configuration, traffic mix, request kind, metric or
work count sits in a file of its own and is found by name:

- ``configs/<config>.json``: a pricing desk (market, schemes, precision);
- ``traffic/<traffic>.json``: a traffic mix, the parameters that
  ``generator.py`` and the mix's request kind read;
- ``requests/<kind>.py``: how one request of that kind drives the program,
  what it produced, and its plain reference (``reference/``);
- ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``;
- ``work/<scheme>.py``: the operations and bytes a kernel's work needs,
  read against ``peaks.json`` by ``kernel_roofline_pct``.
"""
