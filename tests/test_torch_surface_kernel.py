"""The surface kernels' plain twins (K9 QE surface, K4 exact surface, K12
surface + Jacobian) against the Pallas kernels run in interpret mode on the
CPU, on the in-kernel Sobol' stream (the Pallas PRNG stream has no CPU
form); the twins against each other and against the one-expiry price
kernels on both streams; the differentiable surface; the adapter's routing.

Each JAX kernel is called once, in a module-scoped fixture, at one
32768-pair tile: K9 and K12 at the shape of
tests/agreement/test_kernel_greeks.py:162-206 (expiries 2024-07-01 and
2025-01-01, strikes 90/100/110, 8 steps: 4 + 4), K4 at the 2 × 2 grid of
tests/unit/test_exact_kernel.py:123-153 with one exact segment per gap
(interpret mode costs about 17 s per exact segment here).

Interpret mode evaluates ``pl.reciprocal(x, approx=True)`` as the float32
reciprocal of ``x`` rounded to bfloat16 (tests/test_torch_exact_kernel.py),
so the reference's ``_rcp`` carries ~1.5e-5 relative error after its Newton
polish; the twins' (and the CUDA kernels') reciprocal is fp32-accurate.
The tight comparisons give the twin the interpret-mode estimate."""

import datetime as dt
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu_torch as ht
from hedgehog_tpu.ops import heston_exact_kernel as jk
from hedgehog_tpu.ops import heston_qe_greeks_kernel as jg
from hedgehog_tpu.ops import heston_qe_kernel as jq
from hedgehog_tpu_torch.ops import heston_exact_kernel as pk
from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as pg
from hedgehog_tpu_torch.ops import heston_qe_kernel as pq
from hedgehog_tpu_torch.ops import hh_device

REF = dt.date(2024, 1, 1)
R = 0.03
MKT = (math.log(100.0), 0.04, R, 2.0, 0.04, 0.3, -0.7)
T_HOST = ((dt.date(2024, 7, 1) - REF).days / 365.0, (dt.date(2025, 1, 1) - REF).days / 365.0)
DISC = tuple(math.exp(-R * t) for t in T_HOST)
STRIKES = (90.0, 100.0, 110.0)
QE_SEG = (4, 4)
XS_STRIKES = (95.0, 105.0)
XS_SEG = (1, 1)
SEED = 9
TILE = dict(n_blocks=1, n_batches=1, seed=SEED, qmc=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module runs many small ops on tensors of 2^11-2^16 elements,
    where intra-op threads cost more than they give and, under several test
    workers, oversubscribe the cores: one thread while it runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interpret_rcp(x):
    """The interpret-mode ``_rcp``: bfloat16-rounded input, float32
    reciprocal, one Newton polish."""
    r = torch.reciprocal(x.to(torch.bfloat16).to(torch.float32))
    return r * (2.0 - x * r)


def _emulate_interpret_rcp(monkeypatch):
    for mod in (hh_device, pg, pk):
        monkeypatch.setattr(mod, "rcp", _interpret_rcp)


@pytest.fixture(scope="module")
def jax_k9():
    return np.asarray(jq.heston_qe_mixing_surface_price(
        *MKT, T_HOST, jnp.asarray(STRIKES), jnp.asarray(DISC), seg_steps=QE_SEG, n_strikes=3,
        interpret=True, **TILE))


@pytest.fixture(scope="module")
def jax_k12():
    surf, jac = jg.heston_qe_mixing_surface_price_and_jacobian(
        *MKT, T_HOST, jnp.asarray(STRIKES), jnp.asarray(DISC), seg_steps=QE_SEG, n_strikes=3,
        interpret=True, **TILE)
    return np.asarray(surf), np.asarray(jac)


@pytest.fixture(scope="module")
def jax_k4():
    return np.asarray(jk.heston_exact_mixing_surface_price(
        *MKT, T_HOST, jnp.asarray(XS_STRIKES), jnp.asarray(DISC), seg_steps=XS_SEG, n_strikes=2,
        interpret=True, **TILE))


def _k9(**kw):
    return pq.heston_qe_mixing_surface_price(*MKT, T_HOST, STRIKES, DISC, seg_steps=QE_SEG,
                                             n_strikes=3, **dict(TILE, device="cpu", **kw))


def _k12(**kw):
    return pg.heston_qe_mixing_surface_price_and_jacobian(
        *MKT, T_HOST, STRIKES, DISC, seg_steps=QE_SEG, n_strikes=3,
        **dict(TILE, device="cpu", **kw))


def _k4(**kw):
    return pk.heston_exact_mixing_surface_price(*MKT, T_HOST, XS_STRIKES, DISC, seg_steps=XS_SEG,
                                                n_strikes=2, **dict(TILE, device="cpu", **kw))


class _Float64Jnp(types.SimpleNamespace):
    """``jax.numpy`` with float32 read as float64, so that the JAX
    function keeps its jacfwd tables in float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def test_parameter_vectors_match_reference():
    """fp32 vectors from the same float64 formulas: within 1e-6 relative."""
    strikes = jnp.asarray(STRIKES)
    want = np.asarray(jq._surf_params(*MKT, T_HOST, QE_SEG, strikes, 1.0))
    got = pq._surf_params(*MKT, T_HOST, QE_SEG, STRIKES, 1.0)
    assert got.dtype == np.float32 and got.shape == want.shape == (pq.surf_nparams(2, 3),)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    want = np.asarray(jk._exact_surf_params(*MKT, T_HOST, (2, 3), jnp.asarray(XS_STRIKES), -1.0))
    got = pk._exact_surf_params(*MKT, T_HOST, (2, 3), XS_STRIKES, -1.0)
    assert got.shape == want.shape == (pk.exact_surf_nparams(2, 2),)
    assert jk._exact_surf_nparams(2, 2) == pk.exact_surf_nparams(2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_surface_greek_tables_match_reference_jacfwd(monkeypatch):
    """The closed-form tables against JAX's jacfwd tables: float64 within
    rel 1e-12, and the float32 tables the kernel takes within 1e-6."""
    args = (2.0, 0.04, 0.3, (0.3, 1.1, 2.5), (2, 3, 5))
    want32 = [np.asarray(t) for t in jg._surface_greek_tables(*args)]
    monkeypatch.setattr(jg, "jnp", _Float64Jnp())
    want = [np.asarray(t) for t in jg._surface_greek_tables(*args)]
    got = pg._surface_greek_tables(*args)
    for g, w, w32, shape in zip(got, want, want32, ((12, 4), (12, 3))):
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape == shape
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(g.astype(np.float32), w32, rtol=1e-6, atol=1e-12)


def test_k9_twin_matches_interpret_kernel(jax_k9, monkeypatch):
    """Same Sobol' points, fp32 arithmetic and reciprocal estimate: every
    point within rel 2e-6 (the fp32 per-pair values summed in another
    order); the shipped twin within 3e-4, the K8 tolerance of
    tests/test_torch_qe_kernel.py (the bf16 reciprocal error moves it
    ~1e-5)."""
    shipped = _k9().numpy()
    np.testing.assert_allclose(shipped, jax_k9, rtol=3e-4, atol=0.0)
    _emulate_interpret_rcp(monkeypatch)
    got = _k9().numpy()
    assert got.shape == jax_k9.shape == (2, 3)
    np.testing.assert_allclose(got, jax_k9, rtol=2e-6, atol=0.0)


def test_k12_twin_matches_interpret_kernel(jax_k12, monkeypatch):
    """Surface within rel 2e-4 and every Jacobian entry within
    max(5e-3·|g|, 1e-3·max over its column), the K10 tolerances of
    tests/test_torch_qe_kernel.py (fp32 sums; an entry near zero is all
    cancellation); with the interpret-mode reciprocal, 2e-6 and 1e-4."""
    want_surf, want_jac = jax_k12
    surf, jac = (x.numpy() for x in _k12())
    assert surf.shape == want_surf.shape == (2, 3) and jac.shape == want_jac.shape == (2, 3, 7)
    np.testing.assert_allclose(surf, want_surf, rtol=2e-4, atol=0.0)
    scale = np.abs(want_jac).max(axis=(0, 1), keepdims=True)
    assert (np.abs(jac - want_jac) <= np.maximum(5e-3 * np.abs(want_jac), 1e-3 * scale)).all()
    _emulate_interpret_rcp(monkeypatch)
    surf, jac = (x.numpy() for x in _k12())
    np.testing.assert_allclose(surf, want_surf, rtol=2e-6, atol=0.0)
    assert (np.abs(jac - want_jac) <= 1e-4 * scale).all()


def test_k4_twin_matches_interpret_kernel(jax_k4, monkeypatch):
    """With the interpret-mode reciprocal (tests/test_torch_exact_kernel.py)
    every point within rel 2e-6; the shipped twin within 3e-4."""
    np.testing.assert_allclose(_k4().numpy(), jax_k4, rtol=3e-4, atol=0.0)
    _emulate_interpret_rcp(monkeypatch)
    got = _k4().numpy()
    assert got.shape == jax_k4.shape == (2, 2)
    np.testing.assert_allclose(got, jax_k4, rtol=2e-6, atol=0.0)


@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_k12_twin_surface_is_k9s(qmc):
    """The same primal, close and float64 sums: equal to the bit."""
    kw = dict(qmc=qmc, n_batches=2, seed=4)
    surf, jac = _k12(**kw)
    assert torch.equal(surf, _k9(**kw))
    assert bool(torch.isfinite(jac).all())


@pytest.mark.parametrize("steps", [4, 5])
@pytest.mark.parametrize("qmc", [True, False], ids=["qmc", "prng"])
def test_one_expiry_surface_twins_are_the_price_twins(qmc, steps):
    """A one-expiry, one-strike surface draws the price kernels' stream
    (the step index runs across segments): K9's twin against K8's and K4's
    against K3's on the same pairs and seed, rel 1e-6 (the same fp32 values
    summed per point; measured equal)."""
    T, D = T_HOST[1], DISC[1]
    kw = dict(n_blocks=1, n_batches=2, seed=11, qmc=qmc, device="cpu")
    k8 = pq.heston_qe_mixing_vanilla_price(*MKT, T / steps, 105.0, D, steps=steps, **kw)
    k9 = pq.heston_qe_mixing_surface_price(*MKT, [T], [105.0], [D], seg_steps=(steps,),
                                           n_strikes=1, **kw)
    assert float(k9[0, 0]) == pytest.approx(float(k8), rel=1e-6)
    k3 = pk.heston_exact_mixing_vanilla_price(*MKT, T / 2, 105.0, D, segments=2, **kw)
    k4 = pk.heston_exact_mixing_surface_price(*MKT, [T], [105.0], [D], seg_steps=(2,),
                                              n_strikes=1, **kw)
    assert float(k4[0, 0]) == pytest.approx(float(k3), rel=1e-6)


def test_k9_twin_matches_the_float64_surface():
    """The fp32 twin against the float64 estimator on the same QMC points:
    the in-kernel stream is the estimator's (exact ndtri against the kernel's
    approximation), so within 2e-4 per point."""
    market = ht.HestonInputs(REF, R, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    cfg = ht.SimulationConfig(32768, sum(QE_SEG), ht.Antithetic(), SEED, True)
    want = ht.heston_surface_mc(market, [dt.date(2024, 7, 1), dt.date(2025, 1, 1)], STRIKES, cfg,
                                device="cpu")
    np.testing.assert_allclose(_k9().numpy(), want.numpy(), rtol=2e-4)


@pytest.mark.parametrize("carry", [0.0, 0.01])
def test_diff_view_gradient_is_the_jacobian_contraction(carry):
    """torch.autograd.grad of a least-squares surface loss through the
    differentiable view (K12 forward) equals jacᵀ·ct from a direct K12 call
    (ct the loss's cotangent), with the log-spot column scaled by S0."""
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in MKT]
    log_s0, v0, r, kappa, theta, sigma, rho = leaves
    kw = dict(seg_steps=QE_SEG, n_strikes=3, n_blocks=1, n_batches=1, seed=5, device="cpu")
    surf = pg.heston_qe_mixing_surface_price_diff(log_s0, v0, r, kappa, theta, sigma, rho, T_HOST,
                                                  STRIKES, carry=carry, **kw)
    quotes = torch.full((2, 3), 8.0, dtype=torch.float64)
    loss = 0.5 * ((surf - quotes) ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    disc = [math.exp(-R * t) for t in T_HOST]
    want_surf, jac = pg.heston_qe_mixing_surface_price_and_jacobian(
        MKT[0], MKT[1], R - carry, *MKT[3:], T_HOST, STRIKES, disc, **kw)
    assert torch.equal(surf.detach(), want_surf)
    g = torch.einsum("emp,em->p", jac, want_surf - quotes)
    want = torch.stack([g[0] * 100.0, g[1], g[6], g[2], g[3], g[4], g[5]])
    torch.testing.assert_close(torch.stack(grads), want, rtol=1e-12, atol=0.0)


def test_diff_view_without_gradients_runs_k9():
    """No input needs a gradient: the forward is K9 (the same surface)."""
    with torch.no_grad():
        surf = pg.heston_qe_mixing_surface_price_diff(
            *MKT, T_HOST, STRIKES, seg_steps=QE_SEG, n_strikes=3, n_blocks=1, n_batches=1, seed=5,
            device="cpu")
    assert torch.equal(surf, pq.heston_qe_mixing_surface_price(
        *MKT, T_HOST, STRIKES, DISC, seg_steps=QE_SEG, n_strikes=3, n_blocks=1, n_batches=1,
        seed=5, device="cpu"))


def test_adapter_routes():
    """Antithetic runs take the kernels (their twins on the CPU) with the
    float64 surface's step allocation: QMC QE → K9, PRNG QE → the
    differentiable view, exact → K4; a run without variance reduction goes
    to the float64 estimator."""
    market = ht.HestonInputs(REF, R, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    expiries = [dt.date(2024, 7, 1), dt.date(2025, 1, 1)]
    disc = list(DISC)
    kw = dict(n_strikes=3, n_blocks=1, n_batches=1, device="cpu")
    cfg = ht.SimulationConfig(32768, 8, ht.Antithetic(), 2, True)
    got = pq.heston_surface_mc_adapter(market, expiries, STRIKES, cfg, device="cpu")
    want = pq.heston_qe_mixing_surface_price(*MKT, T_HOST, STRIKES, disc, seg_steps=QE_SEG,
                                             seed=2, qmc=True, **kw)
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0.0)
    exact = ht.SimulationConfig(32768, 4, ht.Antithetic(), 2, True)
    got = pq.heston_surface_mc_adapter(market, expiries, STRIKES, exact, seed=3,
                                       strategy=ht.HestonExactMixing(), device="cpu")
    want = pk.heston_exact_mixing_surface_price(*MKT, T_HOST, STRIKES, disc, seg_steps=(2, 2),
                                                seed=3, qmc=True, **kw)
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0.0)
    prng = ht.SimulationConfig(32768, 3, ht.Antithetic(), 6, False)
    got = pq.heston_surface_mc_adapter(market, expiries, STRIKES, prng, device="cpu")
    want = pq.heston_qe_mixing_surface_price(*MKT, T_HOST, STRIKES, disc, seg_steps=(1, 2),
                                             seed=6, **kw)
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0.0)
    plain = ht.SimulationConfig(1024, 4, ht.NoVarianceReduction(), 6, True)
    got = pq.heston_surface_mc_adapter(market, expiries, STRIKES, plain, device="cpu")
    want = ht.heston_surface_mc(market, expiries, STRIKES, plain, device="cpu")
    assert torch.equal(got, want)


def test_adapter_prng_surface_is_differentiable():
    spot = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
    market = ht.HestonInputs(REF, R, spot, 0.04, 2.0, 0.04, 0.3, -0.7)
    cfg = ht.SimulationConfig(32768, 4, ht.Antithetic(), 1, False)
    surf = pq.heston_surface_mc_adapter(market, [dt.date(2025, 1, 1)], [100.0], cfg, device="cpu")
    (delta,) = torch.autograd.grad(surf.sum(), spot)
    assert 0.5 < float(delta) < 0.8


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    kernels = (pq.QE_SURFACE_KERNEL, pg.QE_SURFACE_JAC_KERNEL, pk.EXACT_SURFACE_KERNEL)
    before = [k.launches for k in kernels]
    small = dict(n_blocks=1, n_batches=1, seed=0, device="cpu")
    for qmc in (True, False):
        pq.heston_qe_mixing_surface_price(*MKT, T_HOST, STRIKES, DISC, seg_steps=(1, 1),
                                          n_strikes=3, qmc=qmc, **small)
        pg.heston_qe_mixing_surface_price_and_jacobian(*MKT, T_HOST, STRIKES, DISC,
                                                       seg_steps=(1, 1), n_strikes=3, qmc=qmc,
                                                       **small)
        pk.heston_exact_mixing_surface_price(*MKT, T_HOST, STRIKES, DISC, seg_steps=(1, 1),
                                             n_strikes=3, qmc=qmc, **small)
    assert [k.launches for k in kernels] == before


def test_strike_chunks_cover_wide_grids():
    """A grid whose per-warp sums exceed the shared-memory budget is split
    into strike chunks, each a launch over the same pairs; a surface's
    points do not depend on the chunking."""
    def smem(width):
        return pq.surface_smem_bytes(3, width, 7, 64, 148)

    chunks = pq.strike_chunks(1000, smem)
    assert len(chunks) > 1 and chunks[0].start == 0 and chunks[-1].stop == 1000
    assert all(a.stop == b.start for a, b in zip(chunks, chunks[1:]))
    widest = chunks[0].stop - chunks[0].start
    assert smem(widest) <= pq.SURFACE_SMEM_LIMIT < smem(widest + 1)
    assert pq.strike_chunks(17, smem) == [slice(0, 17)]
    with pytest.raises(ValueError, match="one strike"):
        pq.strike_chunks(17, lambda width: pq.SURFACE_SMEM_LIMIT + width)


@pytest.mark.parametrize("qmc", [False, True], ids=["PRNG", "QMC"])
def test_qe_surface_shared_memory_fits(qmc):
    """K9's and K12's layout (csrc/heston_surface.cu layout: a float64 row
    of sums per warp and column, 32 B of segment constants and a step count
    per expiry, K12's 112 B of tangent rows per expiry, 28 B of close
    constants per point, the Sobol' table, and under QMC both kernels'
    per-warp high Sobol' words, 8 warps x 2 candidates a dimension) counted
    by hand with 64 B of slack: the QE-32 3 x 5 surface, the 3 x 17
    calibration shape up to 128 steps and a five-year QE-32 surface (5 x 5,
    160 steps) fit one launch with the table staged; K9's widest strike
    chunk of a 1000 strike surface at 128 steps is as wide as fits.  Past
    about 540 steps a one-strike launch with the table would not fit, so
    the table stays in global memory and the strikes are chunked without
    it."""
    for n_exp, m, steps in ((3, 5, 32), (3, 17, 48), (3, 17, 128), (5, 5, 160), (1, 1, 1)):
        dims = 2 * steps if qmc else 0
        for jac, cols, per_exp in ((False, 1, pq.SURF_EXP_BYTES), (True, 7, 148)):
            want = ((8 * 8 * cols + 28) * n_exp * m + (36 + 112 * jac) * n_exp + 4 * 31 * dims
                    + 4 * 2 * 8 * dims + 64)
            got = pq.surface_smem_bytes(n_exp, m, cols, dims, per_exp, high=True)
            assert got == want <= pq.SURFACE_SMEM_LIMIT

    def smem(width, rows=2 * 128 if qmc else 0):
        return pq.surface_smem_bytes(3, width, 1, rows, pq.SURF_EXP_BYTES, high=True)

    chunks = pq.strike_chunks(1000, smem)
    widest = chunks[0].stop - chunks[0].start
    assert smem(widest) <= pq.SURFACE_SMEM_LIMIT < smem(widest + 1)
    assert chunks[-1].stop == 1000 and all(a.stop == b.start for a, b in zip(chunks, chunks[1:]))
    assert pq.staged_rows(2 * 160, smem) == 2 * 160
    assert pq.staged_rows(2 * 600, smem) == 0 and pq.staged_rows(0, smem) == 0


@pytest.mark.parametrize("jac", [False, True], ids=["K9", "K12"])
def test_qe_surface_staging_decision(jac):
    """K9's and K12's one staging decision (``surface_staged``, which the
    launch follows): the table staged up to a five-year QE-32 surface and
    the calibration shape at 128 steps, in global memory at 600 steps and
    absent without QMC; the strikes chunked as wide as fits with that
    table (the 3 x 17 calibration shape in one launch)."""
    assert pq.surface_staged(3, 2 * 128, jac) and pq.surface_staged(5, 2 * 160, jac)
    assert not pq.surface_staged(3, 2 * 600, jac) and not pq.surface_staged(3, 0, jac)
    assert pq.surface_strike_chunks(3, 17, 2 * 128, jac) == [slice(0, 17)]
    for rows in (2 * 128, 2 * 600):
        staged = rows if pq.surface_staged(3, rows, jac) else 0
        chunks = pq.surface_strike_chunks(3, 1000, rows, jac)
        assert chunks[-1].stop == 1000 and all(a.stop == b.start for a, b in zip(chunks, chunks[1:]))
        widest = chunks[0].stop - chunks[0].start
        assert (pq.surface_launch_bytes(3, widest, staged, jac) <= pq.SURFACE_SMEM_LIMIT
                < pq.surface_launch_bytes(3, widest + 1, staged, jac))


def test_exact_surface_staging_decision():
    """K4's one staging decision (``exact_surface_staged``): the table
    staged at the serving and calibration shapes and up to 400 segments,
    in global memory at 480 and absent without QMC."""
    for n_exp, segs in ((3, 5), (3, 16), (10, 40), (2, 400)):
        assert pk.exact_surface_staged(n_exp, segs, True)
        assert not pk.exact_surface_staged(n_exp, segs, False)
    assert not pk.exact_surface_staged(2, 480, True)


@pytest.mark.parametrize("qmc", [False, True], ids=["PRNG", "QMC"])
@pytest.mark.parametrize("segments", [1, 5, 16])
def test_exact_surface_shared_memory_fits(segments, qmc):
    """K4's layout (csrc/heston_exact.cu xs_layout: the float64 row sums
    per point, a round's 256 fp32 pair values at up to 48 staged points
    (one expiry's strikes where there are more), per-gap parameters, per
    point close constants, counts, the Sobol' table) counted by hand, under
    the H100's 227 KB a block at the calibration shape and 1-16 segments,
    and a 10 x 20 surface in one launch; the strike chunks keep each launch
    within SURFACE_SMEM_LIMIT."""
    table = 4 * 4 * segments * 31 if qmc else 0
    for n_exp, m, staged in ((3, 17, 48), (10, 20, 48), (1, 60, 60), (2, 5, 10)):
        want = (8 * 8 + 28) * n_exp * m + 4 * 256 * staged + (4 * 33 + 8) * n_exp + table
        assert pk.exact_surface_smem_bytes(n_exp, m, segments, qmc) == want <= 227 * 1024

        def smem(width):
            return pk.exact_surface_smem_bytes(n_exp, width, segments, qmc)

        assert pq.strike_chunks(m, smem) == [slice(0, m)]
    chunks = pq.strike_chunks(1000, smem)
    assert len(chunks) > 1 and chunks[-1].stop == 1000
    assert all(a.stop == b.start for a, b in zip(chunks, chunks[1:]))
    widest = chunks[0].stop - chunks[0].start
    assert smem(widest) <= pq.SURFACE_SMEM_LIMIT < smem(widest + 1)


def test_exact_surface_grid_guards():
    """``_exact_surface_sums``'s optional grid: a positive int or None; the
    twin on the CPU sums the same values whatever the grid."""
    params = torch.as_tensor(pk._exact_surf_params(*MKT, T_HOST, XS_SEG, XS_STRIKES, 1.0))
    run = (params, None, XS_SEG, [20, 20], 2, 8, 0, 0, 0)
    for bad in (0, -3, 1.5, True, "396"):
        with pytest.raises(ValueError, match="grid"):
            pk._exact_surface_sums(*run, grid=bad)
    assert torch.equal(pk._exact_surface_sums(*run, grid=396), pk._exact_surface_sums(*run))


def test_qe_surface_twin_past_128_qmc_steps_matches_the_float64_surface():
    """A QMC surface of 200 steps over its expiries, past the 128 the
    kernels once refused: K9's twin summed over 4096 pairs against the JAX
    package's float64 ``heston_surface_mc`` on the same pairs (its steps
    allocated as the kernel's, the same Sobol' points; exact ndtri there,
    fp32 and the approximate ndtri here): every point within 1e-5
    relative (measured 9.3e-7); K12's twin's surface column is K9's twin's
    to the bit."""
    import hedgehog_tpu as hh
    from hedgehog_tpu_torch.methods.heston_surface import surface_seg_steps

    expiries = (dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2026, 1, 1))
    t_host = [(d - REF).days / 365.0 for d in expiries]
    n, steps = 4096, 200
    seg = tuple(surface_seg_steps(t_host, steps)[1])
    assert sum(seg) == steps
    mkt = hh.HestonInputs(REF, R, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    cfg = hh.SimulationConfig(trajectories=n, steps=steps, variance_reduction=hh.Antithetic(),
                              seed=SEED, qmc=True)
    want = np.asarray(hh.heston_surface_mc(mkt, list(expiries), list(STRIKES), cfg))
    params = torch.as_tensor(pq._surf_params(*MKT, t_host, seg, STRIKES, 1.0))
    table = torch.as_tensor(pq.sobol_table(SEED, 2 * steps))
    sums = pq._qe_surface_sums(params, table, seg, len(STRIKES), n, SEED, 0, 0)
    disc = np.exp(-R * np.asarray(t_host))[:, None]
    got = disc * sums.numpy().reshape(len(t_host), len(STRIKES)) / (2 * n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    dct, djt = (torch.as_tensor(x, dtype=torch.float32)
                for x in pg._surface_greek_tables(*MKT[3:6], t_host, seg))
    jac = pg._surface_jac_sums(params, dct, djt, table, seg, len(STRIKES), n, SEED, 0, 0)
    assert torch.equal(jac.reshape(-1, pg.N_SURF_COLS)[:, 0], sums)


def test_guards():
    with pytest.raises(ValueError, match="period"):
        _k9(point_offset=2**30 - 1)
    with pytest.raises(ValueError, match="period"):
        pq.heston_qe_mixing_surface_price(*MKT, T_HOST, STRIKES, DISC, seg_steps=QE_SEG,
                                          n_strikes=3, n_blocks=2**15, n_batches=2, seed=0,
                                          qmc=True, device="cpu")
    with pytest.raises(ValueError, match="period"):
        _k12(point_offset=2**30 - 100)
    with pytest.raises(ValueError, match="period"):
        _k4(point_offset=2**30 - 1)
    with pytest.raises(ValueError, match="n_strikes"):
        pq.heston_qe_mixing_surface_price(*MKT, T_HOST, STRIKES, DISC, seg_steps=QE_SEG,
                                          n_strikes=2, n_blocks=1, n_batches=1, seed=0,
                                          device="cpu")
    params = torch.as_tensor(pk._exact_surf_params(*MKT, T_HOST, XS_SEG, XS_STRIKES, 1.0))
    with pytest.raises(ValueError, match="trip counts"):
        pk._exact_surface_sums(params, None, XS_SEG, [20, 99], 2, 8, 0, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        pk._exact_surface_sums(params[:-1], None, XS_SEG, [20, 20], 2, 8, 0, 0, 0)
    with pytest.raises(ValueError, match="trip count"):  # poisson_kmax cannot meet its tail
        pk.heston_exact_mixing_surface_price(*MKT[:5], 0.01, MKT[6], T_HOST, XS_STRIKES, DISC,
                                             seg_steps=(40, 40), n_strikes=2, n_blocks=1,
                                             n_batches=1, seed=0, device="cpu")
    market = ht.HestonInputs(REF, R, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    with pytest.raises(ValueError, match="increasing"):
        pq.heston_surface_mc_adapter(market, [dt.date(2025, 1, 1), dt.date(2024, 7, 1)], STRIKES,
                                     ht.SimulationConfig(64, 2, ht.Antithetic()), device="cpu")



@pytest.mark.parametrize("entry", ["k9", "k12", "k4", "adapter"])
def test_entry_points_default_to_the_gpu(entry):
    """Without ``device`` every surface entry point asks for the card and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    kw = dict(seg_steps=(1, 1), n_strikes=3, n_blocks=1, n_batches=1, seed=0)
    market = ht.HestonInputs(REF, R, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    calls = {
        "k9": lambda: pq.heston_qe_mixing_surface_price(*MKT, T_HOST, STRIKES, DISC, **kw),
        "k12": lambda: pg.heston_qe_mixing_surface_price_and_jacobian(*MKT, T_HOST, STRIKES,
                                                                      DISC, **kw),
        "k4": lambda: pk.heston_exact_mixing_surface_price(*MKT, T_HOST, STRIKES, DISC, **kw),
        "adapter": lambda: pq.heston_surface_mc_adapter(
            market, [dt.date(2025, 1, 1)], STRIKES, ht.SimulationConfig(64, 2, ht.Antithetic())),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()

