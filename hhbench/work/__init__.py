"""Work counts, one module per scheme, found by name (``work/<scheme>.py``
with ``count(kind, **shape)``), and the least time a request's work
needs on a card of ``peaks.json``."""

from __future__ import annotations

import importlib


def counts(work: dict) -> dict:
    """(flops, mufu, alu, imad, bytes) of one item of a request's work:
    ``{"scheme": ..., "kind": ..., <shape>}``."""
    shape = {k: v for k, v in work.items() if k not in ("scheme", "kind")}
    return importlib.import_module(f"hhbench.work.{work['scheme']}").count(work["kind"], **shape)


def least_seconds(work: dict, peaks: dict) -> float:
    """The largest of four quotients: fp32 operations (the stream's
    IMAD.WIDE two each, as they run on the FMA pipe) over the fp32 peak;
    MUFU operations, and the stream's integer ALU operations, over their
    rates per clock and SM at the fixed clock; bytes over the memory
    peak."""
    c = counts(work)
    per_clock = peaks["sms"] * peaks["clock_hz"]
    return max((c["flops"] + 2 * c["imad"]) / peaks["fp32_flops_per_s"],
               c["mufu"] / (peaks["mufu_per_clock_sm"] * per_clock),
               c["alu"] / (peaks["int_per_clock_sm"] * per_clock),
               c["bytes"] / peaks["bytes_per_s"])
