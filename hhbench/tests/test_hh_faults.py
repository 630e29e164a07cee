"""The comparison that decides ``correct`` fails a broken timed path.

Each test drives a run on the CPU (the kernel wrappers run their plain
twins there) at 2^15 or 2^16 pairs, with the harness's look for a card
skipped and something else in the program's place: the control (the
reference in bfloat16), half of the pairs left out with the mean taken
over the rest, an answer altered where it is produced, and, for the fit,
a surface call that returns its first answer unchanged."""

import numpy as np
import pytest
import torch

from hhbench import cells, cli, control

SEED = 2**33 + 5
SMALL = {
    "heston_atm1y.risk_serve": {"pairs": {"n_blocks": 1, "n_batches": 2}},
    "heston_atm1y.risk_solve": {"trajectories": 2**16},
    "heston_calib51.gn_fit": {"pairs": {"n_blocks": 1, "n_batches": 2}, "iterations": 2,
                              "check": {"requests": 1, "iterations": 1}},
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(name):
    cell = cells.load(name)
    cell.traffic.update(SMALL[name], warmup_requests=0)
    return cell


def _run(cell, adapt=None):
    return cli.run_cell(cell, SEED, 0.01, False, "cpu", 0.0, adapt=adapt)


def _half_entry(kind):
    entry = kind._entry
    kind._entry = lambda *a, **kw: entry(*a, **{**kw, "n_batches": kw["n_batches"] // 2})


def _half_solve(kind):
    call = kind.program_call

    def half(inputs):
        pairs = kind.pairs
        kind.pairs = pairs // 2
        try:
            return call(inputs)
        finally:
            kind.pairs = pairs

    kind.call = half


def _altered(kind):
    call = kind.program_call

    def altered(inputs):
        out = call(inputs)
        key = "surface" if "surface" in out else "price"
        return {**out, key: out[key] * (1.0 + 1e-3)}

    kind.call = altered


def _stale(kind):
    first = {}

    def stale(inputs):
        if not first:
            first.update(kind.program_call(inputs))
        return dict(first)

    kind.call = stale


@pytest.mark.parametrize("name", ["heston_atm1y.risk_serve", "heston_atm1y.risk_solve"])
def test_the_program_passes(name):
    result = _run(_cell(name))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", [
    ("heston_atm1y.risk_serve", _half_entry),
    ("heston_atm1y.risk_serve", _altered),
    ("heston_atm1y.risk_solve", _half_solve),
    ("heston_atm1y.risk_solve", _altered),
    ("heston_calib51.gn_fit", _half_entry),
    ("heston_calib51.gn_fit", _altered),
    ("heston_calib51.gn_fit", _stale),
])
def test_a_broken_path_is_not_correct(name, fault):
    result = _run(_cell(name), adapt=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["heston_atm1y.risk_serve", "heston_atm1y.risk_solve"])
def test_the_control_is_not_correct(name):
    cell = _cell(name)
    result = _run(cell, adapt=control.control_adapter(cell))
    assert not result["correct"], result["checks"]
    assert result["checks"]["price_gap"]["value"] is None or \
        result["checks"]["price_gap"]["value"] > cell.traffic["limits"]["price_gap"]


def test_a_nan_answer_is_not_correct():
    def nan(kind):
        call = kind.program_call
        kind.call = lambda inputs: {**call(inputs), "greeks": np.full(7, np.nan)}

    result = _run(_cell("heston_atm1y.risk_serve"), adapt=nan)
    assert not result["correct"]
    assert result["checks"]["outputs_finite"]["value"] == 1
