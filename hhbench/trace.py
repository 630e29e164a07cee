"""The traced window: a torch.profiler session over some requests, read
into device intervals, request spans and host operations.

Each request runs under ``record_function("hhbench.request.<index>")``, so
its span and the device's operations share the profiler's clock.  The
session's Chrome trace is written to a file in ``TMPDIR``, read, and
deleted.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile

from .stats import clip, union_seconds

SPAN_PREFIX = "hhbench.request."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Traced:
    """A read trace, times in seconds on the profiler's clock."""

    device: list  # (start, end, name, cat) of each device operation
    spans: dict  # request index -> (start, end)
    host_ops: list  # (start, end, name) of the host's operations

    @property
    def window(self):
        """(first span's start, last span's end)."""
        return (min(a for a, _ in self.spans.values()), max(b for _, b in self.spans.values()))

    def __post_init__(self):
        self._starts = [e[0] for e in self.device]

    def ops_in(self, span) -> list:
        """The device operations that start inside ``span``."""
        lo, hi = (bisect.bisect_left(self._starts, t) for t in span)
        return self.device[lo:hi]

    def busy(self):
        """(seconds in which a device operation ran, wall) over the window."""
        lo, hi = self.window
        return union_seconds(clip(self.device, lo, hi)), hi - lo


def read_chrome_trace(path: str) -> Traced:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, spans, host_ops = [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start = float(ev["ts"]) * 1e-6
        end = start + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((start, end, name, cat))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans[int(name[len(SPAN_PREFIX):])] = (start, end)
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host_ops.append((start, end, name))
    return Traced(device=sorted(device), spans=spans, host_ops=host_ops)


class Profiler:
    """One torch.profiler session of CPU and CUDA activity; ``stop()``
    returns its :class:`Traced`."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> Traced:
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="hhbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return read_chrome_trace(path)
        finally:
            os.unlink(path)


# kernels that PyTorch and the libraries under it define; every other
# kernel is the program's own
_TORCH_KERNEL = re.compile(r"\bat::|\bc10::|\bcub::|cutlass|cublas|cudnn|gemm|xmma|nvjet")


def program_kernel(event) -> bool:
    """A device operation (start, end, name, cat) that is a kernel of the
    program's own, not a copy, a fill or a kernel of PyTorch's."""
    return event[3] == "kernel" and not _TORCH_KERNEL.search(event[2])


def breakdown(traced: Traced, top: int = 10) -> dict:
    """The device operations that took most time in the window, summed by
    name, and the device's 100 longest idle gaps summed by what the host
    was doing at each gap's middle (the innermost host operation there),
    each [[name, seconds], ...] with at most ``top`` entries."""
    lo, hi = traced.window
    ops = {}
    for a, b, name, _ in traced.device:
        if lo <= a < hi:
            ops[name] = ops.get(name, 0.0) + (b - a)
    busy = sorted((max(a, lo), min(b, hi)) for a, b, *_ in traced.device if b > lo and a < hi)
    gaps, end = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    host = sorted(traced.host_ops)
    starts = [h[0] for h in host]
    labels = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:100]:
        mid = 0.5 * (a + b)
        inner = [h for h in host[:bisect.bisect_right(starts, mid)] if h[1] > mid]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "(host outside any operation)"
        labels[name] = labels.get(name, 0.0) + (b - a)
    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(labels)}
