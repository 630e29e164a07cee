"""Profiling helpers (port of ``hedgehog_tpu/utils/profiling.py``):
a ``torch.profiler`` trace and a synchronised median wall."""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Iterator

import torch

from . import tree_leaves

__all__ = ["trace", "time_fn"]


@contextlib.contextmanager
def trace(logdir: str = "/tmp/hedgehog_trace") -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) and write its Chrome trace into ``logdir`` as
    ``trace_<pid>_<ns>.json`` (open it in Perfetto or chrome://tracing).
    The device work the block queued is waited for inside the trace.
    Yields the profiler, whose ``key_averages()`` sums the block by
    operation and kernel."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _wait(out) -> None:
    """Wait for the queued work of every CUDA tensor among the leaves of
    ``out`` (a tensor, a solution, or a tuple, list or dict of them)."""
    devices = {x.device for x in tree_leaves(out)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def time_fn(fn, *args, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time in seconds of ``fn(*args)``, each call ended by a
    synchronise of the device its result lies on."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median_high(times)
