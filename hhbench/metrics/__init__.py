"""Metric readers, one module per metric of BENCHMARK.json, found by
name.  ``read(run)`` takes a ``harness.Run`` and returns the number, or
None where the run holds nothing to read (the metric is then left out of
the result line)."""
