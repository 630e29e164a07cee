"""On the card, at each cell's own size: the program's run is correct and
the control's is not.  Run on a GPU host with
``python -m pytest hhbench/tests -m cuda``; elsewhere these skip."""

import pytest
import torch

from hhbench import cells, control, harness

CELLS = ["heston_atm1y.risk_serve", "heston_atm1y.risk_solve", "heston_calib51.gn_fit"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct_at_the_cells_size(name):
    _card()
    cell = cells.load(name)
    [(_, checks, attempted)] = control.readings(cell, [2**31 + 11], "program", 0.5, "cuda")
    assert attempted >= 1
    assert harness.passed(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(name):
    _card()
    cell = cells.load(name)
    [(_, checks, _)] = control.readings(cell, [2**31 + 12], "control", 0.5, "cuda")
    assert not harness.passed(checks), checks
