"""scripts/phase_costs.py against the port's sources: every phase of every
kernel it times has a rewrite that applies to this tree (a tree with none
raises), and the rewrite changes the kernel's source."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("phase_costs", ROOT / "scripts" / "phase_costs.py")
pc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pc)

CASES = [(k, phase) for k, phases in pc.PHASES.items() for phase in phases]


@pytest.mark.parametrize("kernel, phase", CASES, ids=[f"{k}-{p}" for k, p in CASES])
def test_each_phase_rewrites_this_tree(kernel, phase, tmp_path):
    pc.make_copy(ROOT, tmp_path, pc.PHASES[kernel][phase])
    csrc = ROOT / "hedgehog_tpu_torch" / "csrc"
    changed = [path.name for path in sorted(csrc.glob("*.cu*"))
               if (tmp_path / "hedgehog_tpu_torch" / "csrc" / path.name).read_text()
               != path.read_text()]
    assert changed, f"{kernel} {phase}: the rewrite left every source as it was"
