"""scripts/variant_times.py against the port's sources: every variant of
every kernel it times applies to this tree and changes the kernel's
source."""

import importlib.util
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
_spec = importlib.util.spec_from_file_location("variant_times", ROOT / "scripts" / "variant_times.py")
vt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(vt)

CASES = [(k, name) for k, variants in vt.VARIANTS.items() for name in variants]


@pytest.mark.parametrize("kernel, variant", CASES, ids=[f"{k}-{v}" for k, v in CASES])
def test_each_variant_edits_this_tree(kernel, variant, tmp_path):
    vt.phase_costs.make_copy(ROOT, tmp_path, vt.VARIANTS[kernel][variant])
    csrc = ROOT / "hedgehog_tpu_torch" / "csrc"
    changed = [path.name for path in sorted(csrc.glob("*.cu*"))
               if (tmp_path / "hedgehog_tpu_torch" / "csrc" / path.name).read_text()
               != path.read_text()]
    assert changed, f"{kernel} {variant}: the variant left every source as it was"
