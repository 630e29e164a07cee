"""hedgehog_tpu_torch.utils.profiling on the CPU: ``time_fn``'s median and
call count, and ``trace``'s Chrome trace file."""

import json

import torch

from hedgehog_tpu_torch.utils.profiling import time_fn, trace


def test_time_fn_calls_warmup_plus_reps_and_gives_a_positive_median():
    calls = []

    def fn(x):
        calls.append(1)
        return torch.sin(x).sum()

    median = time_fn(fn, torch.linspace(0.0, 1.0, 10_000), reps=5, warmup=3)
    assert len(calls) == 8 and median > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())
