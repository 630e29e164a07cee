"""The frozen work counts at the cells' shapes.

The bounds at 2^20 pairs are those chip_smoke.py's ``bound`` gave for
K10, K7, K11 and K12 (PERF.md's kernel table: 0.0374, 0.0228, 0.0410 and
0.1524 ms at 1,980 MHz), so the copy is the count it was made from."""

import pytest

from hhbench import cells, work

H100 = cells.peaks("NVIDIA H100 80GB HBM3")


def _ms(kind, pairs, steps, **shape):
    return 1e3 * work.least_seconds(dict(scheme="qe_mixing", kind=kind, pairs=pairs,
                                         steps=steps, **shape), H100)


@pytest.mark.parametrize("kind,steps,shape,want", [
    ("price_and_greeks", 11, {}, 0.0374),
    ("values", 11, {}, 0.0228),
    ("values_vjp", 11, {}, 0.0410),
    ("surface_price_and_jacobian", 32, {"points": 15, "expiries": 3}, 0.1524),
])
def test_bounds_at_2_20_pairs_are_chip_smokes(kind, steps, shape, want):
    assert _ms(kind, 2**20, steps, **shape) == pytest.approx(want, abs=5e-5)


def test_counts_at_the_cells_shapes():
    k10 = work.counts(dict(scheme="qe_mixing", kind="price_and_greeks", pairs=2**27, steps=11))
    assert k10 == {"flops": 2256011264.0 * 128, "mufu": 66584576.0 * 128,
                   "alu": 125829120 * 128, "imad": 125829120 * 128, "bytes": 0}
    k12 = work.counts(dict(scheme="qe_mixing", kind="surface_price_and_jacobian", pairs=2**23,
                           steps=32, points=51, expiries=3))
    assert k12["bytes"] == 56 * 51 and k12["alu"] == 2**23 * 16 * 20
    # the bounds are set by operations: the greek kernel by fp32 work
    assert _ms("price_and_greeks", 2**27, 11) == pytest.approx(4.7908, abs=1e-3)
    assert _ms("surface_price_and_jacobian", 2**23, 32, points=51, expiries=3) == pytest.approx(
        2.1792, abs=1e-3)
    assert _ms("values", 2**24, 11) + _ms("values_vjp", 2**24, 11) == pytest.approx(1.0204,
                                                                                   abs=1e-3)


def test_work_scales_with_pairs():
    one = work.counts(dict(scheme="qe_mixing", kind="values", pairs=2**20, steps=11))
    two = work.counts(dict(scheme="qe_mixing", kind="values", pairs=2**21, steps=11))
    assert all(two[k] == 2 * one[k] for k in one)
