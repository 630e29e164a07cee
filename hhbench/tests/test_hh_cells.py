"""Cells are found by name, and a cell added as files alone runs."""

import json
import shutil

import pytest
import torch

from hhbench import cells, cli

ROOT = cells.ROOT


def test_every_workload_loads_with_its_files_and_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = cells.load(w["name"])
        assert cell.chips == 1
        cells.request_kind(cell)
        assert {m["name"] for m in cell.end_to_end} == {"paths_per_s", "request_p95_ms",
                                                       "setup_s"}
        assert len(cell.per_layer) == 4
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
        assert set(cell.traffic["limits"]) == {"price_gap", "greek_gap"}


def test_a_cell_added_as_files_alone_loads_and_runs(tmp_path):
    """A later PR adds a cell by adding a traffic file and a workload entry:
    here a risk desk at strike 90 and 95, on the CPU at 2^15 pairs."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "heston_atm1y.risk_serve_otm", "config": "heston_atm1y",
                              "traffic": "risk_serve_otm", "chips": 1, "why": "a test cell"})
    for m in spec["per_layer"]:
        m["workloads"].append("heston_atm1y.risk_serve_otm")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(ROOT / "hhbench" / "configs", tmp_path / "hhbench" / "configs")
    traffic = json.loads((ROOT / "hhbench" / "traffic" / "risk_serve.json").read_text())
    traffic.update(pairs={"n_blocks": 1, "n_batches": 1}, warmup_requests=0,
                   draw={"strike": {"choice": [90.0, 95.0]}})
    (tmp_path / "hhbench" / "traffic").mkdir()
    (tmp_path / "hhbench" / "traffic" / "risk_serve_otm.json").write_text(json.dumps(traffic))

    cell = cells.load("heston_atm1y.risk_serve_otm", tmp_path / "BENCHMARK.json")
    assert len(cell.per_layer) == 4
    torch.manual_seed(0)
    result = cli.run_cell(cell, 2**32 + 17, 0.01, False, "cpu", 0.0)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"paths_per_s", "request_p95_ms", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cells.load("no_such.cell")
