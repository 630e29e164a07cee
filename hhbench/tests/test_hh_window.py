"""Rates, tails and the trace readers over synthetic windows."""

import json

import pytest

from hhbench import cells, harness, stats, trace
from hhbench.metrics import (aux_device_ms, device_idle_pct, host_ms_per_request,
                             kernel_roofline_pct, paths_per_s, request_p95_ms, setup_s)


def _records(latencies, paths=1000, works=()):
    out, t = [], 0.0
    for i, lat in enumerate(latencies):
        out.append(harness.Record({"index": i}, t, t + lat, paths, list(works), [], None))
        t += lat
    return out


def _run(records, traced=None, peaks=None):
    window = (records[0].t_submit, records[-1].t_done)
    return harness.Run(None, 12.5, records, window, traced, peaks)


def test_percentile_nearest_rank():
    assert stats.percentile(range(1, 101), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 95) == 10
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_a_stall_shows_in_the_tail_and_the_rate():
    steady = [0.010] * 94
    stalled = steady[:50] + [0.050] * 6 + steady[50:]
    run_a, run_b = _run(_records(steady + [0.010] * 6)), _run(_records(stalled))
    assert request_p95_ms.read(run_a) == pytest.approx(10.0)
    assert request_p95_ms.read(run_b) == pytest.approx(50.0)
    # the rate is over all the work and all the time, the stall's included
    assert paths_per_s.read(run_a) == pytest.approx(100 * 1000 / 1.0)
    assert paths_per_s.read(run_b) == pytest.approx(100 * 1000 / (0.94 + 0.30))


def test_a_single_stall_in_a_short_window_is_the_tail():
    run = _run(_records([0.02] * 9 + [0.2]))
    assert request_p95_ms.read(run) == pytest.approx(200.0)


def test_failed_requests_count_nowhere_but_failed():
    recs = _records([0.01, 0.01, 0.5])
    recs[2].error = "RuntimeError: boom"
    run = _run(recs)
    assert request_p95_ms.read(run) == pytest.approx(10.0)
    assert paths_per_s.read(run) == pytest.approx(2000 / 0.52)
    assert setup_s.read(run) == 12.5


def test_union_and_clip():
    assert stats.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert stats.clip([(0, 1, "a"), (2, 5, "b")], 0.5, 3) == [(0.5, 1), (2, 3)]


PEAKS = {"fp32_flops_per_s": 1e12, "bytes_per_s": 1e12, "sms": 1, "clock_hz": 1e9,
         "mufu_per_clock_sm": 1e9, "int_per_clock_sm": 1e9}


def _traced():
    # two requests of 10 ms: the program's kernel 6 ms and a copy 1 ms in
    # each, a torch kernel of 1 ms in the second
    device = [(0.001, 0.007, "qe_greeks_kernel<false>", "kernel"),
              (0.007, 0.008, "Memcpy DtoH (Device -> Pinned)", "gpu_memcpy"),
              (0.011, 0.017, "qe_greeks_kernel<false>", "kernel"),
              (0.017, 0.018, "void at::native::reduce_kernel<512, 1>", "kernel"),
              (0.018, 0.019, "Memcpy DtoH (Device -> Pinned)", "gpu_memcpy")]
    spans = {0: (0.0, 0.010), 1: (0.010, 0.020)}
    host = [(0.0, 0.001, "aten::copy_"), (0.008, 0.010, "aten::item"),
            (0.010, 0.011, "hhbench.request.1"), (0.010, 0.0109, "aten::to")]
    return trace.Traced(device=device, spans=spans, host_ops=host)


def test_trace_readers_on_a_known_window():
    recs = _records([0.010, 0.010])
    work = dict(scheme="qe_mixing", kind="price_and_greeks", pairs=2**10, steps=11)
    for r in recs:
        r.works = [work]
    run = _run(recs, _traced(), PEAKS)
    least = run.least_seconds(recs[0])
    assert kernel_roofline_pct.read(run) == pytest.approx(100 * 2 * least / 0.012)
    assert aux_device_ms.read(run) == pytest.approx((1 + 2) / 2)
    # spans 10 ms each, device busy 7 and 8 ms inside them
    assert host_ms_per_request.read(run) == pytest.approx((3 + 2) / 2)
    assert device_idle_pct.read(run) == pytest.approx(100 * (1 - 0.015 / 0.020))


def test_trace_readers_read_nothing_without_a_trace():
    run = _run(_records([0.01]), None, PEAKS)
    for reader in (kernel_roofline_pct, aux_device_ms, host_ms_per_request, device_idle_pct):
        assert reader.read(run) is None
    assert kernel_roofline_pct.read(_run(_records([0.01]), _traced(), None)) is None


def test_program_kernels_are_those_torch_does_not_define():
    assert trace.program_kernel((0, 1, "qe_greeks_kernel<false>", "kernel"))
    assert trace.program_kernel((0, 1, "void surface_jac_kernel<true, false>(float)", "kernel"))
    assert not trace.program_kernel((0, 1, "void at::native::vectorized_elementwise_kernel<4>",
                                     "kernel"))
    assert not trace.program_kernel((0, 1, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy"))


def test_breakdown_names_ops_and_what_the_host_did_in_the_gaps():
    b = trace.breakdown(_traced())
    assert b["device_ops"][0] == ["qe_greeks_kernel<false>", pytest.approx(0.012)]
    labels = dict((k, v) for k, v in b["idle_gaps"])
    assert labels["aten::item"] == pytest.approx(0.003)
    assert labels["aten::copy_"] == pytest.approx(0.001)
    assert labels["(host outside any operation)"] == pytest.approx(0.001)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_chrome_trace_is_read_into_device_ops_spans_and_host_ops(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 1600.0, "dur": 10.0},
        {"ph": "X", "cat": "user_annotation", "name": "hhbench.request.7", "ts": 900.0,
         "dur": 900.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "hhbench.request.7", "ts": 1000.0,
         "dur": 600.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 950.0, "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.read_chrome_trace(str(path))
    assert [e[2] for e in t.device] == ["k", "Memcpy"]
    assert t.spans == {7: (pytest.approx(0.0009), pytest.approx(0.0018))}
    assert t.host_ops == [(pytest.approx(0.00095), pytest.approx(0.000955), "aten::empty")]
    assert t.busy() == (pytest.approx(0.00051), pytest.approx(0.0009))


def test_the_peaks_table_names_the_h100():
    p = cells.peaks("NVIDIA H100 80GB HBM3")
    assert p["fp32_flops_per_s"] == 67e12 and p["clock_hz"] == 1.98e9
    assert cells.peaks("some other card") is None
