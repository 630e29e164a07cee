"""The Heston kernels' draws where the TPU kernels' arithmetic breaks down,
and the repairs of them in the port (csrc/hh_device.cuh and its twin
``ops/hh_device.py``):

- a Sobol' integer a ≥ 2^30 − 32 rounds to u = 1.0 in float32, where
  ``ndtri_approx`` returns +11.46σ instead of Φ⁻¹((a + ½)·2^-30) ≈ 5.4–6.1:
  every Heston normal now goes through ``sobol_normals_tile``, the exact
  kernels' Poisson uniform through ``sobol_uniform_top`` (−w there, minus
  the exact complement w = 1 − (a + ½)·2^-30: the count inverts the tail,
  the mirror draws w) and every other uniform through
  ``sobol_uniforms_open_tile`` (1 − 2^-24 there);
- a Philox radius word whose top 23 bits are zero gives a zero Box–Muller
  uniform, which the TPU kernels floor at FLT_MIN (a 13.2σ normal):
  ``box_muller`` now takes that cell's centre, 2^-24.

The cells are pinned: the Sobol' ones solved over GF(2) for the top 25
bits of each dimension's integer (seed 0; the K2 table of 2 segments × 4
dims and the K7 table of 11 steps × 2 dims share their first 8 rows), the
Philox one found by a search of pairs [0, 2^24) of block 0 under seed 0.
No Pallas kernel runs here: the paths are held against the port's float64
estimators on the same Sobol' points.
"""

import datetime as dt
import math

import numpy as np
import pytest
import torch

import hedgehog_tpu_torch as ht
from hedgehog_tpu_torch.methods import heston_exact_mixing, heston_qe_mixing
from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
from hedgehog_tpu_torch.ops import heston_qe_kernel as qk
from hedgehog_tpu_torch.ops import hh_device as hd

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
MKT = (math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7)  # log S, V0, r, κ, θ, σ, ρ
SEED = 0
TOP = (1 << 30) - 32  # the smallest Sobol' integer whose float32 uniform is 1.0
#: (point, dim, its Sobol' integer) of seed 0: a normal of K2 (z_gam of
#: segment 0), a normal of K7 (z of step 0) and two uniforms of K2 (u_pois of
#: segments 0 and 1)
K2_NORMAL_CELL = (15512210, 1, 1073741796)
K7_NORMAL_CELL = (894640, 0, 1073741801)
K2_UNIFORM_CELL = (894640, 0, 1073741801)
K2_POIS_CELL = (3671734, 4, 1073741805)
#: a pair of seed 0 whose Philox block 0 word 0 has its top 23 bits zero
PHILOX_ZERO_PAIR = 14883995
PHILOX_SEARCHED = 2**24
#: the largest |z| of a Box–Muller radius uniform of 2^-24
BM_MAX_Z = math.sqrt(-2.0 * math.log(2.0**-24))
#: per path, a float32 twin against its float64 estimator on the same QMC
#: points: ≥ 99.9% within 1e-3 and every path within 1e-2, relative (values
#: below 1e-3 compared absolutely); measured 4.6e-3 at worst over 4096 K2
#: paths, 1.4e-3 over 4096 K7 paths
PATH_TOL = dict(rel=1e-2, share_rel=1e-3, share=0.999, floor=1e-3)
WINDOW = 4096  # points around a cell held against the float64 estimator


def _masks(points):
    return hd.sobol_masks(torch.as_tensor(points, dtype=torch.int64))


def _parent_normals(masks, table, dims):
    """The TPU kernels' Sobol' normals: ndtri_approx of the float32 uniform."""
    return [hd.ndtri_approx(u) for u in hd.sobol_uniforms_tile(masks, table, dims)]


def _parent_box_muller(b0, b1, dtype=torch.float32):
    """The TPU kernels' Box–Muller: a zero radius uniform floored at FLT_MIN."""
    return hd._polar(torch.clamp(hd.uniform_from_bits(b0), min=1.1754944e-38), b1, dtype)


@pytest.mark.parametrize("cell, dims", [(K2_NORMAL_CELL, 8), (K7_NORMAL_CELL, 22)],
                         ids=["K2", "K7"])
def test_sobol_top_cell_normal_is_the_cells_quantile(cell, dims):
    """The repaired normal is Φ⁻¹((a + ½)·2^-30) within 1e-3; the TPU
    arithmetic drew 11.46 there."""
    point, dim, a = cell
    table = torch.as_tensor(hd.sobol_table(SEED, dims))
    masks = _masks([point])
    assert int(hd.sobol_bits(masks, table, dim)) == a >= TOP
    want = float(torch.special.ndtri(torch.tensor((a + 0.5) * 2.0**-30, dtype=torch.float64)))
    (z,) = hd.sobol_normals_tile(masks, table, (dim,))
    (z_parent,) = _parent_normals(masks, table, (dim,))
    assert abs(float(z) - want) <= 1e-3 and 5.4 <= want <= 6.1
    assert float(z_parent) == pytest.approx(11.46, abs=0.01)


def test_sobol_top_cell_uniform_is_below_one():
    """The repaired uniform (u_boost, the QE and QE-M u) is 1 − 2^-24, the
    float32 in (0, 1) nearest (a + ½)·2^-30, so its antithetic 1 − u is
    2^-24, not 0; the Poisson uniform carries the exact complement as −w
    (a float32: w = (2^30 − 1 − a + ½)·2^-30)."""
    point, dim, a = K2_UNIFORM_CELL
    table = torch.as_tensor(hd.sobol_table(SEED, 8))
    masks = _masks([point])
    assert int(hd.sobol_bits(masks, table, dim)) == a >= TOP
    (u,) = hd.sobol_uniforms_open_tile(masks, table, (dim,))
    (u_parent,) = hd.sobol_uniforms_tile(masks, table, (dim,))
    assert float(u) == 1.0 - 2.0**-24 < 1.0 == float(u_parent)
    assert float(1.0 - u) == 2.0**-24
    u_top = hd.sobol_uniform_top(masks, table, dim)
    assert -float(u_top) == (2**30 - 1 - a + 0.5) * 2.0**-30 > 0.0


@pytest.mark.parametrize("cell", [K2_NORMAL_CELL, K2_UNIFORM_CELL], ids=["normal", "uniform"])
def test_sobol_repairs_keep_every_other_cell(cell):
    """Over the WINDOW points around a cell, all 8 dims of the K2 table:
    the repaired draws equal the TPU arithmetic's bits wherever a < 2^30 −
    32, and differ in the top cells only."""
    point = cell[0]
    table = torch.as_tensor(hd.sobol_table(SEED, 8))
    masks = _masks(np.arange(point - WINDOW // 2, point + WINDOW // 2))
    dims = range(8)
    top = torch.stack([hd.sobol_bits(masks, table, d) >= TOP for d in dims])
    z, z_parent = (torch.stack(f(masks, table, dims))
                   for f in (hd.sobol_normals_tile, _parent_normals))
    u, u_parent = (torch.stack(f(masks, table, dims))
                   for f in (hd.sobol_uniforms_open_tile, hd.sobol_uniforms_tile))
    u_top = torch.stack([hd.sobol_uniform_top(masks, table, d) for d in dims])
    assert int(top.sum()) == 1
    assert torch.equal(z[~top], z_parent[~top]) and torch.equal(u[~top], u_parent[~top])
    assert not torch.equal(z[top], z_parent[top]) and bool((u[top] < 1.0).all())
    assert torch.equal(u_top[~top], u_parent[~top]) and bool((u_top[top] < 0.0).all())


def _k2_twin(point_offset, n):
    return ek.heston_exact_mixing_values(
        *MKT, _T() / 2, 100.0, 1.0, n_paths=n, segments=2, seed=SEED, antithetic=True, qmc=True,
        point_offset=point_offset, device="cpu")


def _k7_twin(point_offset, n):
    return qk.heston_qe_mixing_values(
        *MKT, _T() / 11, 100.0, 1.0, n_paths=n, steps=11, seed=SEED, antithetic=True, qmc=True,
        point_offset=point_offset, device="cpu")


def _T():
    return float(ht.yearfrac(REF, EXPIRY))


def _problem():
    market = ht.HestonInputs(REF, MKT[2], 100.0, *MKT[1:2], *MKT[3:])
    payoff = ht.VanillaOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    return ht.PricingProblem(payoff, market)


def _rel(got, want):
    return (got - want).abs() / want.abs().clamp(min=PATH_TOL["floor"])


def _parent_pois(masks, table, dim):
    """The TPU kernels' Poisson uniform: 1.0 in a top cell, mirrored to 0,
    its count where the float32 CDF rounds to 1."""
    return hd.sobol_uniforms_tile(masks, table, (dim,))[0]


def _open_pois(masks, table, dim):
    """The Poisson uniform as 1 − 2^-24 in a top cell (sobol_uniforms_open_tile)."""
    return hd.sobol_uniforms_open_tile(masks, table, (dim,))[0]


_K2_F64 = heston_exact_mixing.heston_exact_mixing_values


@pytest.mark.parametrize("name, cell, steps, twin, estimator, restore", [
    ("K2", K2_NORMAL_CELL, 2, _k2_twin, _K2_F64, ("sobol_normals_tile", _parent_normals)),
    ("K7", K7_NORMAL_CELL, 11, _k7_twin, heston_qe_mixing.heston_qe_mixing_values,
     ("sobol_normals_tile", _parent_normals)),
    ("K2", K2_POIS_CELL, 2, _k2_twin, _K2_F64, ("sobol_uniform_top", _parent_pois)),
    ("K2", K2_UNIFORM_CELL, 2, _k2_twin, _K2_F64, ("sobol_uniform_top", _open_pois)),
], ids=["K2", "K7", "K2-u_pois", "K2-u_pois-open"])
def test_twin_path_at_a_top_cell_matches_the_float64_estimator(name, cell, steps, twin, estimator,
                                                                restore, monkeypatch):
    """The twin's values on the WINDOW points around a top cell against the
    float64 estimator's (exact float64 uniforms and ndtri on the same
    Sobol' points) within PATH_TOL, the cell's path too; with the TPU
    arithmetic restored (a normal; the Poisson uniform's 1.0 counted up to
    the float32 CDF's 1.0), or the Poisson uniform taken as 1 − 2^-24, the
    cell's path falls outside it."""
    point = cell[0]
    base = point - WINDOW // 2
    cfg = ht.SimulationConfig(WINDOW, steps, ht.Antithetic(), SEED, qmc=True)
    want = estimator(_problem(), cfg, point_offset=base, device="cpu")
    got = twin(base, WINDOW).double()
    assert got.shape == want.shape == (2, WINDOW)
    rel = _rel(got, want)
    assert float((rel <= PATH_TOL["share_rel"]).double().mean()) >= PATH_TOL["share"]
    assert float(rel.max()) <= PATH_TOL["rel"]
    monkeypatch.setattr(ek if name == "K2" else qk, *restore)
    parent = twin(point, 1).double()[:, 0]
    assert float(_rel(parent, want[:, point - base]).max()) > PATH_TOL["rel"]


def test_box_muller_zero_cell_takes_its_centre():
    """The pinned Philox zero cell: the twin's normals (float32, and the
    float64 estimators' from the same words) satisfy |z| ≤ 5.77, where the
    TPU arithmetic gave 13.2σ; every other pair of the searched range keeps
    the TPU arithmetic's bits."""
    pair = torch.arange(PHILOX_SEARCHED, dtype=torch.int64)
    w = hd.philox_block(pair, 0, SEED, 0)
    zero = torch.nonzero((w[0] >> 9) == 0).flatten().tolist()
    assert zero == [PHILOX_ZERO_PAIR]
    z0, z1 = hd.box_muller(w[0], w[1])
    p0, p1 = _parent_box_muller(w[0], w[1])
    i = PHILOX_ZERO_PAIR
    for dtype in (torch.float32, torch.float64):
        z = hd.box_muller(w[0][i:i + 1], w[1][i:i + 1], dtype=dtype)
        assert math.hypot(float(z[0]), float(z[1])) == pytest.approx(BM_MAX_Z, rel=1e-6)
    assert max(abs(float(z0[i])), abs(float(z1[i]))) <= BM_MAX_Z
    assert math.hypot(float(p0[i]), float(p1[i])) > 13.0
    keep = torch.ones(PHILOX_SEARCHED, dtype=torch.bool)
    keep[i] = False
    assert torch.equal(z0[keep], p0[keep]) and torch.equal(z1[keep], p1[keep])
