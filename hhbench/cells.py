"""Cells by name: a workload of ``BENCHMARK.json`` with its configuration,
traffic mix, request kind and metrics, each from a file of its own."""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, benchmark: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``benchmark`` (the checkout's BENCHMARK.json by
    default); its files are found under the directory of that file."""
    benchmark = ROOT / "BENCHMARK.json" if benchmark is None else benchmark
    spec = _load_json(benchmark)
    base = benchmark.parent / "hhbench"
    for w in spec["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(base / "configs" / f"{w['config']}.json"),
        traffic=_load_json(base / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reported(m, name)],
    )


def request_kind(cell: Cell):
    """The module of the cell's request kind, ``requests/<kind>.py``."""
    return importlib.import_module(f"hhbench.requests.{cell.traffic['request']}")


def metric_reader(name: str):
    """The reader of metric ``name``, ``metrics/<name>.py``'s ``read``."""
    return importlib.import_module(f"hhbench.metrics.{name}").read


def peaks(kind: str) -> dict | None:
    """The peaks of the card called ``kind``, or None for a card the table
    does not hold."""
    return _load_json(HERE / "peaks.json")["cards"].get(kind)
