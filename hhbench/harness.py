"""One run of a cell: set-up, the timed window, the traced window, the
comparison with the reference, and the metrics.

The client is a closed loop of one: request i + 1 is sent when request i
has returned its result to the host.  A request's latency is from its
submission to its result read on the host; the window runs from the first
submission to the last result, and every request submitted before the
deadline counts, with all its time.
"""

from __future__ import annotations

import dataclasses
import math
import time

from . import cells, compare, generator, work
from .trace import SPAN_PREFIX, Profiler, Traced

WARMUP_INDEX = 2**40
# the traced part of a --trace 1 run: from this share of the window, for
# this many seconds (at most half the window)
PROFILE_START_SHARE, PROFILE_SECONDS = 0.35, 3.0


@dataclasses.dataclass
class Record:
    """One request of the window."""

    spec: dict
    t_submit: float
    t_done: float
    paths: int
    works: list
    calls: list | None  # the program calls' (inputs, outputs); None if it failed
    error: str | None = None

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: cells.Cell
    setup_s: float
    records: list
    window: tuple  # (start, end), host clock
    traced: Traced | None
    peaks: dict | None

    @property
    def done(self) -> list:
        return [r for r in self.records if r.error is None]

    def traced_records(self) -> list:
        """The completed requests whose spans the trace holds, with their
        spans: [(record, (start, end))]."""
        if self.traced is None:
            return []
        by_index = {r.spec["index"]: r for r in self.done}
        return [(by_index[i], span) for i, span in sorted(self.traced.spans.items())
                if i in by_index]

    def least_seconds(self, record: Record) -> float | None:
        if self.peaks is None:
            return None
        return sum(work.least_seconds(w, self.peaks) for w in record.works)


class Client:
    """The closed loop over a request kind."""

    def __init__(self, kind, cell: cells.Cell, seed: int):
        self.kind, self.cell, self.seed = kind, cell, seed
        self.draw = cell.traffic["draw"]

    def spec(self, index: int) -> dict:
        return generator.request_spec(self.seed, index, self.draw)

    def one(self, index: int, annotate: bool = False) -> Record:
        spec = self.spec(index)
        t0 = time.perf_counter()
        try:
            if annotate:
                import torch

                with torch.profiler.record_function(f"{SPAN_PREFIX}{index}"):
                    calls = self.kind.send(spec)
            else:
                calls = self.kind.send(spec)
            error = None
        except Exception as exc:  # a failed request is counted, not fatal
            calls, error = None, f"{type(exc).__name__}: {exc}"
        t1 = time.perf_counter()
        return Record(spec, t0, t1, self.kind.paths(spec), self.kind.works(spec), calls, error)


def warm_up(client: Client, trace: bool) -> None:
    """The cell's own shapes, before the window: ``warmup_requests``
    requests (indices from 2^40, so no timed request repeats one); with a
    trace, one more under a profiler session so that its start-up cost
    falls here."""
    n = int(client.cell.traffic["warmup_requests"])
    for i in range(n):
        rec = client.one(WARMUP_INDEX + i)
        if rec.error:
            raise RuntimeError(f"warm-up request failed: {rec.error}")
    if trace:
        prof = Profiler()
        client.one(WARMUP_INDEX + n, annotate=True)
        prof.stop()


def window(client: Client, seconds: float, trace: bool):
    """The timed window: requests until ``seconds`` have passed; with a
    trace, a profiler session over the requests that start between
    ``PROFILE_START_SHARE`` of the window and ``PROFILE_SECONDS`` later.
    Returns (records, (start, end), traced or None)."""
    t_start = time.perf_counter()
    deadline = t_start + seconds
    prof_on = t_start + seconds * PROFILE_START_SHARE
    prof_off = prof_on + min(PROFILE_SECONDS, 0.5 * seconds)
    records, prof, traced, index = [], None, None, 0
    while time.perf_counter() < deadline:
        now = time.perf_counter()
        if trace and prof is None and traced is None and now >= prof_on:
            prof = Profiler()
        if prof is not None and now >= prof_off:
            traced, prof = prof.stop(), None
        records.append(client.one(index, annotate=prof is not None))
        index += 1
    t_end = records[-1].t_done if records else time.perf_counter()
    if prof is not None:
        traced = prof.stop()
    return records, (t_start, t_end), traced


def check(kind, cell: cells.Cell, seed: int, records: list) -> dict:
    """The comparison with the reference: each number, the worst over a
    sample of the completed requests drawn from the seed, beside its
    limit.  A failed request, or an output that is not finite, fails
    ``outputs_finite``."""
    done = [r for r in records if r.error is None]
    finite = all(compare.all_finite(r.calls) for r in done)
    checks = {"failed_requests": {"value": len(records) - len(done), "limit": 0},
              "outputs_finite": {"value": 0 if finite else 1, "limit": 0}}
    sample = generator.sample(seed, done, int(cell.traffic["check"]["requests"]), salt=1)
    gaps = kind.compare(sample, seed)
    for name, limit in cell.traffic["limits"].items():
        checks[name] = {"value": gaps.get(name, math.nan), "limit": limit}
    return checks


def passed(checks: dict) -> bool:
    """Every number at or under its limit (a NaN, or a number not given,
    never is)."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
