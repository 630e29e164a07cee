"""The CUDA kernels against their plain twins on the card (chip_smoke.py's
phase 2 at small sizes).  Marked ``cuda``: they skip where
``torch.cuda.is_available()`` is False, and run on a GPU host with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerances (fp32 on both sides, same bits): the card contracts a·b + c into
FMAs and its expf/logf/sincosf differ from the twins' by an ulp, so ≥ 99.9%
of values agree within 1e-4 relative (values below 1e-3 absolutely) and the
means within 1e-6; a rare path crosses an fp32 threshold (a Poisson count)."""

import dataclasses
import datetime as dt
import math
import pathlib

import pytest
import torch

import hedgehog_tpu_torch as ht
from hedgehog_tpu_torch.models.heston_exact import poisson_kmax
from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
from hedgehog_tpu_torch.ops import heston_kernel as hk

pytestmark = pytest.mark.cuda

MKT = (math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7)
T = 366 / 365
PAIRS = 2**17


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _assert_values_close(got, want, rtol=1e-4, share=0.999):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1e-3)
    assert float((rel <= rtol).double().mean()) >= share
    assert float(got.double().mean()) == pytest.approx(float(want.double().mean()), rel=1e-6)


def test_euler_kernel_matches_twin(gpu):
    dt_ = T / 100
    before = hk.EULER_KERNEL.launches
    got = hk.heston_euler_terminal(*MKT, dt_, n_paths=PAIRS, steps=100, seed=7, antithetic=True,
                                   device=gpu)
    torch.cuda.synchronize()
    assert hk.EULER_KERNEL.launches == before + 1
    params = torch.as_tensor(hk._euler_params(*MKT, dt_), device=gpu)
    _assert_values_close(got, hk.heston_euler_terminal_plain(params, PAIRS, 100, 7, True, 0))


RAGGED_PAIRS = PAIRS + 7  # no multiple of 16 (a warp's pairs) or 512 (a block's threads)


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "one-group"])
@pytest.mark.parametrize("steps", [1, 3, 101])
def test_euler_kernel_at_odd_steps_matches_twin(gpu, steps, antithetic):
    """K1's loop of one Philox block per two steps and its odd tail, on a
    ragged last block, both pairings, against the twin."""
    params = torch.as_tensor(hk._euler_params(*MKT, T / steps), device=gpu)
    before = hk.EULER_KERNEL.launches
    got = hk._euler_terminal(params, PAIRS + 5, steps, 7, antithetic, 0)
    torch.cuda.synchronize()
    assert hk.EULER_KERNEL.launches == before + 1 and got.shape == (1 + antithetic, PAIRS + 5)
    _assert_values_close(got, hk.heston_euler_terminal_plain(params, PAIRS + 5, steps, 7,
                                                             antithetic, 0))


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "one-group"])
@pytest.mark.parametrize("segments", [1, 2, 3])
@pytest.mark.parametrize("qmc", [True, False])
def test_exact_values_kernel_layouts_match_twin(gpu, qmc, segments, antithetic):
    """K2 two threads a pair (antithetic) and one path a thread (one group)
    at 1-3 segments on a ragged pair count from a point offset off the
    warp's 32-point cells, against the twin."""
    offset = 777
    params, table, kmax = ek._inputs(*MKT, T / segments, 100.0, 1.0, segments, 5, qmc, gpu)
    before = ek.EXACT_VALUES_KERNEL.launches
    got = ek._exact_values(params, table, RAGGED_PAIRS, segments, antithetic, kmax, 5, 0, offset)
    torch.cuda.synchronize()
    assert ek.EXACT_VALUES_KERNEL.launches == before + 1
    assert got.shape == (1 + antithetic, RAGGED_PAIRS)
    _assert_values_close(got, ek.heston_exact_mixing_values_plain(
        params, table, RAGGED_PAIRS, segments, antithetic, kmax, 5, 0, offset))


def test_device_math_short_forms_keep_every_floats_bits(gpu, tmp_path):
    """scripts/device_math_check.cu, built with the kernels' flags: the short
    forms of hh_device.cuh equal the forms they stand in for on every float
    of their ranges (0 that differ)."""
    import shutil
    import subprocess

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    root = pathlib.Path(__file__).resolve().parents[1]
    exe = tmp_path / "device_math_check"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-o",
                    str(exe), str(root / "scripts" / "device_math_check.cu")], check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    reports = dict(ln.split(": ", 1) for ln in run.stdout.splitlines() if ": " in ln)
    for form, ref in (("rcp_normal", "rcp"), ("sqrt_normal", "sqrtf"), ("sqrt_nonneg", "sqrtf"),
                      ("log_normal", "logf"), ("sincos_small", "sincosf")):
        assert reports.get(f"{form} vs {ref}", "").startswith("0 floats differ in range"), run.stdout


@pytest.mark.parametrize("qmc", [True, False])
def test_exact_kernels_match_twin(gpu, qmc):
    dt_ = T / 2
    before = ek.EXACT_VALUES_KERNEL.launches
    got = ek.heston_exact_mixing_values(*MKT, dt_, 100.0, 1.0, n_paths=PAIRS, segments=2, seed=5,
                                        antithetic=True, qmc=qmc, device=gpu)
    torch.cuda.synchronize()
    assert ek.EXACT_VALUES_KERNEL.launches == before + 1
    params = torch.as_tensor(ek._exact_params(*MKT, dt_, 2, 100.0, 1.0), device=gpu)
    table = torch.as_tensor(ek.sobol_table(5, 8), device=gpu) if qmc else None
    kmax = poisson_kmax(2.0, 0.04, 0.3, dt_, 0.04)
    _assert_values_close(got, ek.heston_exact_mixing_values_plain(params, table, PAIRS, 2, True,
                                                                  kmax, 5, 0, 0))
    price = ek.heston_exact_mixing_vanilla_price(*MKT, dt_, 100.0, 1.0, n_blocks=2, n_batches=2,
                                                 segments=2, seed=5, qmc=qmc, device=gpu)
    assert float(price) == pytest.approx(float(got.double().mean()), rel=1e-6)


def test_solve_on_cuda_runs_the_kernels(gpu):
    prob = ht.PricingProblem(
        ht.VanillaOption(100.0, dt.date(2025, 1, 1)),
        ht.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7))
    cfg = ht.SimulationConfig(PAIRS, 2, ht.Antithetic(), 0, True)
    before = ek.EXACT_VALUES_KERNEL.launches
    sol = ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonExactMixing(True), cfg,
                                       device="cuda"))
    assert ek.EXACT_VALUES_KERNEL.launches == before + 1
    assert sol.ensemble.device.type == "cuda" and math.isfinite(float(sol.price))


QE_STEPS = 11  # the serving step count: odd, so the PRNG layout's tail runs


@pytest.mark.parametrize("qmc", [True, False])
def test_qe_kernels_match_twins(gpu, qmc):
    """K7 per path; K8 against K7's mean; K10's price equal to K8's (same
    stream, grid and reduction) and its greeks against its twin; K11 against
    its twin under a smooth cotangent.  Sums: fp32 per thread in another
    order than the twins', so rel 1e-5 (greeks: plus 1e-5 of the largest)."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    dt_ = T / QE_STEPS
    args = (*MKT, dt_, 100.0, 1.0)
    before = [k.launches for k in (qk.QE_VALUES_KERNEL, qk.QE_PRICE_KERNEL, gk.QE_GREEKS_KERNEL,
                                   gk.QE_VJP_KERNEL)]
    got = qk.heston_qe_mixing_values(*args, n_paths=PAIRS, steps=QE_STEPS, seed=5,
                                     antithetic=True, qmc=qmc, device=gpu)
    torch.cuda.synchronize()
    params, table = qk.mix_inputs(*args, QE_STEPS, 5, qmc, gpu)
    _assert_values_close(got, qk.heston_qe_mixing_values_plain(params, table, PAIRS, QE_STEPS,
                                                               True, 5, 0, 0))
    kw = dict(n_blocks=2, n_batches=2, steps=QE_STEPS, seed=5, qmc=qmc, device=gpu)
    price = qk.heston_qe_mixing_vanilla_price(*MKT, dt_, 100.0, 1.0, **kw)
    assert float(price) == pytest.approx(float(got.double().mean()), rel=1e-6)
    g_price, greeks = gk.heston_qe_mixing_price_and_greeks(*MKT, dt_, 100.0, 1.0, **kw)
    assert float(g_price) == float(price)
    dtab = torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, dt_, QE_STEPS, 4), device=gpu)
    want = gk.heston_qe_mixing_greek_sums_plain(params, dtab, table, PAIRS, QE_STEPS, 5, 0, 0)
    sums = gk._greek_sums(params, dtab, table, PAIRS, QE_STEPS, 5, 0, 0)
    scale = float(want.abs().max())
    assert ((sums - want).abs() <= 1e-5 * scale + 1e-5 * want.abs()).all()
    ct = 0.5 + 0.5 * torch.sin(torch.arange(2 * PAIRS, device=gpu, dtype=torch.float32)).reshape(
        2, PAIRS)
    vdtab = torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, dt_, QE_STEPS, 5), device=gpu)
    want = gk.heston_qe_mixing_vjp_sums_plain(params, vdtab, table, ct, PAIRS, QE_STEPS, True, 5,
                                              0, 0)
    sums = gk._vjp_sums(params, vdtab, table, ct, PAIRS, QE_STEPS, True, 5, 0, 0)
    scale = float(want.abs().max())
    assert ((sums - want).abs() <= 1e-5 * scale + 1e-5 * want.abs()).all()
    after = [k.launches for k in (qk.QE_VALUES_KERNEL, qk.QE_PRICE_KERNEL, gk.QE_GREEKS_KERNEL,
                                  gk.QE_VJP_KERNEL)]
    assert all(a > b for a, b in zip(after, before))


def test_qe_solve_on_cuda_is_differentiable(gpu):
    """solve with HestonQE(conditional=True, use_kernel=True) on cuda launches
    K7, and torch.autograd.grad of its price launches K11."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    spot = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
    sigma = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    prob = ht.PricingProblem(
        ht.VanillaOption(100.0, dt.date(2025, 1, 1)),
        ht.HestonInputs(dt.date(2024, 1, 1), 0.03, spot, 0.04, 2.0, 0.04, sigma, -0.7))
    cfg = ht.SimulationConfig(PAIRS, QE_STEPS, ht.Antithetic(), 0, False)
    before = (qk.QE_VALUES_KERNEL.launches, gk.QE_VJP_KERNEL.launches)
    sol = ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(use_kernel=True,
                                                                        conditional=True),
                                       cfg, device="cuda"))
    delta, vega = torch.autograd.grad(sol.price, (spot, sigma))
    assert (qk.QE_VALUES_KERNEL.launches, gk.QE_VJP_KERNEL.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert 0.5 < float(delta) < 0.8 and math.isfinite(float(vega))


@pytest.mark.parametrize("qmc", [True, False])
def test_qe_terminal_kernels_match_twins(gpu, qmc):
    """K5 per path against its twin on both streams (10 steps, the QE-M
    serving count); K6 over 2 × 2 blocks, exactly K5's PRNG pairs, against
    the mean of K5's call payoffs within rel 1e-6 (another summation order
    of the same fp32 payoffs)."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    steps = 10
    dt_ = T / steps
    before = qk.QEM_TERMINAL_KERNEL.launches
    got = qk.heston_qe_terminal(*MKT, dt_, n_paths=PAIRS, steps=steps, seed=5, antithetic=True,
                                qmc=qmc, device=gpu)
    torch.cuda.synchronize()
    assert qk.QEM_TERMINAL_KERNEL.launches == before + 1
    params, table = qk.qem_inputs(*MKT, dt_, steps, 5, qmc, gpu)
    _assert_values_close(got, qk.heston_qe_terminal_plain(params, table, PAIRS, steps, True, True,
                                                          5, 0, 0))
    if qmc:
        return
    before = qk.QEM_PRICE_KERNEL.launches
    price = qk.heston_qe_call_price(*MKT, dt_, 100.0, 1.0, n_blocks=2, n_batches=2, steps=steps,
                                    seed=5, device=gpu)
    assert qk.QEM_PRICE_KERNEL.launches == before + 1
    pay = torch.clamp(got - 100.0, min=0.0)
    assert float(price) == pytest.approx(float((pay[0] + pay[1]).double().sum()) / (2 * PAIRS),
                                         rel=1e-6)


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "one-group"])
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("qmc", [True, False])
def test_qe_values_and_terminal_kernels_at_the_edges_match_twins(gpu, qmc, steps, antithetic):
    """K7, K5 and K11 (each built per stream) at 1 and 3 steps over a ragged
    pair count from a point offset off the warp's 32-point cells, both
    pairings (K11 antithetic under QMC, as its autograd route runs it),
    against their twins; K5 also without the martingale correction."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    offset = 777
    params, table = qk.mix_inputs(*MKT, T / steps, 100.0, 1.0, steps, 5, qmc, gpu)
    before = qk.QE_VALUES_KERNEL.launches
    got = qk._qe_values(params, table, RAGGED_PAIRS, steps, antithetic, 5, 0, offset)
    torch.cuda.synchronize()
    assert qk.QE_VALUES_KERNEL.launches == before + 1
    assert got.shape == (1 + antithetic, RAGGED_PAIRS)
    _assert_values_close(got, qk.heston_qe_mixing_values_plain(params, table, RAGGED_PAIRS, steps,
                                                               antithetic, 5, 0, offset))
    p5, t5 = qk.qem_inputs(*MKT, T / steps, steps, 5, qmc, gpu)
    for mcorr in (True, False):
        before = qk.QEM_TERMINAL_KERNEL.launches
        got = qk._qem_terminal(p5, t5, RAGGED_PAIRS, steps, antithetic, mcorr, 5, 0, offset)
        torch.cuda.synchronize()
        assert qk.QEM_TERMINAL_KERNEL.launches == before + 1
        assert got.shape == (1 + antithetic, RAGGED_PAIRS)
        _assert_values_close(got, qk.heston_qe_terminal_plain(p5, t5, RAGGED_PAIRS, steps,
                                                              antithetic, mcorr, 5, 0, offset))
    if qmc and not antithetic:
        return
    vtab = _vjp_table(gpu, steps)
    ct = _smooth_ct(gpu, RAGGED_PAIRS)[:1 + antithetic].contiguous()
    before = gk.QE_VJP_KERNEL.launches
    sums = gk._vjp_sums(params, vtab, table, ct, RAGGED_PAIRS, steps, antithetic, 5, 0, offset)
    torch.cuda.synchronize()
    assert gk.QE_VJP_KERNEL.launches == before + 1
    _sums_close(sums, gk.heston_qe_mixing_vjp_sums_plain(params, vtab, table, ct, RAGGED_PAIRS,
                                                         steps, antithetic, 5, 0, offset))


def _vjp_table(gpu, steps):
    """K11's (5, 8) tangent table at ``steps`` steps of ``T``."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk

    return torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, T / steps, steps, 5),
                           device=gpu)


def _smooth_ct(gpu, n):
    """A smooth (2, n) cotangent in (0, 1)."""
    return 0.5 + 0.5 * torch.sin(torch.arange(2 * n, device=gpu, dtype=torch.float32)).reshape(
        2, n)


@pytest.mark.parametrize("n_paths", [PAIRS, PAIRS + 3], ids=["aligned", "ragged"])
def test_gbm_kernel_matches_twin(gpu, n_paths):
    """K13 per path: 16-byte stores where the rows are aligned, scalar stores
    at a ragged end."""
    from hedgehog_tpu_torch.ops import gbm_kernel as gbk

    before = gbk.GBM_KERNEL.launches
    got = gbk.gbm_exact_terminal(4.6, 0.2, n_paths=n_paths, seed=7, antithetic=True, device=gpu)
    torch.cuda.synchronize()
    assert gbk.GBM_KERNEL.launches == before + 1
    params = torch.tensor([4.6, 0.2], dtype=torch.float32, device=gpu)
    _assert_values_close(got, gbk.gbm_exact_terminal_plain(params, n_paths, True, 7, 0))


def test_terminal_solves_on_cuda_run_the_kernels(gpu):
    """HestonQE(use_kernel=True) launches K5 (both streams),
    BlackScholesExact(use_kernel=True) K13, and the default MonteCarlo
    simulates on the card."""
    from hedgehog_tpu_torch.ops import gbm_kernel as gbk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    heston = ht.PricingProblem(
        ht.VanillaOption(100.0, dt.date(2025, 1, 1)),
        ht.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7))
    bs = ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2025, 1, 1)),
                           ht.BlackScholesInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.2))
    before = (qk.QEM_TERMINAL_KERNEL.launches, gbk.GBM_KERNEL.launches)
    for qmc in (True, False):
        sol = ht.solve(heston, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(use_kernel=True),
                                             ht.SimulationConfig(PAIRS, 10, ht.Antithetic(), 0,
                                                                 qmc)))
        assert sol.ensemble.device.type == "cuda" and math.isfinite(float(sol.price))
    cfg = ht.SimulationConfig(PAIRS, 1, ht.Antithetic(), 0)
    sol = ht.solve(bs, ht.MonteCarlo(ht.LognormalDynamics(), ht.BlackScholesExact(True), cfg))
    assert sol.ensemble.device.type == "cuda" and math.isfinite(float(sol.price))
    assert (qk.QEM_TERMINAL_KERNEL.launches, gbk.GBM_KERNEL.launches) == (before[0] + 2,
                                                                          before[1] + 1)
    sol = ht.solve(bs, ht.MonteCarlo(config=cfg))
    assert sol.ensemble.device.type == "cuda" and math.isfinite(float(sol.price))


SURF_T = (182 / 365, 366 / 365, 731 / 365)
SURF_K = (85.0, 95.0, 100.0, 105.0, 120.0)
SURF_D = tuple(math.exp(-0.03 * t) for t in SURF_T)


@pytest.mark.parametrize("qmc", [True, False])
def test_surface_kernels_match_twins(gpu, qmc):
    """K9, K4 and K12 at the 3 × 5 grid against their twins (each point
    within rel 1e-5: the same fp32 per-pair values summed per warp into
    float64 against the twin's float64 sums, with the tails of the fp32
    normal CDF rounding differently on the card; K12's columns within 1e-5
    of the largest plus 1e-5 of each, as K10); K12's surface equal to K9's
    to the bit; one-expiry K9 and K4 against K8 and K3 within rel 1e-6."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    qe_seg, ex_seg, pairs = (8, 8, 16), (2, 1, 2), 2 * qk.PAIRS_PER_BLOCK
    kernels = (qk.QE_SURFACE_KERNEL, gk.QE_SURFACE_JAC_KERNEL, ek.EXACT_SURFACE_KERNEL)
    before = [k.launches for k in kernels]
    kw = dict(n_strikes=5, n_blocks=2, n_batches=1, seed=5, qmc=qmc, device=gpu)
    s9 = qk.heston_qe_mixing_surface_price(*MKT, SURF_T, SURF_K, SURF_D, seg_steps=qe_seg, **kw)
    s12, jac = gk.heston_qe_mixing_surface_price_and_jacobian(*MKT, SURF_T, SURF_K, SURF_D,
                                                              seg_steps=qe_seg, **kw)
    s4 = ek.heston_exact_mixing_surface_price(*MKT, SURF_T, SURF_K, SURF_D, seg_steps=ex_seg, **kw)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    assert torch.equal(s9, s12) and bool(torch.isfinite(jac).all())
    cpu = dict(kw, device="cpu")
    torch.testing.assert_close(s9.cpu(), qk.heston_qe_mixing_surface_price(
        *MKT, SURF_T, SURF_K, SURF_D, seg_steps=qe_seg, **cpu), rtol=1e-5, atol=0.0)
    torch.testing.assert_close(s4.cpu(), ek.heston_exact_mixing_surface_price(
        *MKT, SURF_T, SURF_K, SURF_D, seg_steps=ex_seg, **cpu), rtol=1e-5, atol=0.0)
    _, want = gk.heston_qe_mixing_surface_price_and_jacobian(*MKT, SURF_T, SURF_K, SURF_D,
                                                             seg_steps=qe_seg, **cpu)
    scale = want.abs().amax(dim=(0, 1), keepdim=True)
    assert ((jac.cpu() - want).abs() <= 1e-5 * scale + 1e-5 * want.abs()).all()
    one = dict(n_blocks=2, n_batches=1, seed=5, qmc=qmc, device=gpu)
    k8 = qk.heston_qe_mixing_vanilla_price(*MKT, T / QE_STEPS, 100.0, 1.0, steps=QE_STEPS, **one)
    k9 = qk.heston_qe_mixing_surface_price(*MKT, [T], [100.0], [1.0], seg_steps=(QE_STEPS,),
                                           n_strikes=1, **one)
    assert float(k9[0, 0]) == pytest.approx(float(k8), rel=1e-6)
    k3 = ek.heston_exact_mixing_vanilla_price(*MKT, T / 2, 100.0, 1.0, segments=2, **one)
    k4 = ek.heston_exact_mixing_surface_price(*MKT, [T], [100.0], [1.0], seg_steps=(2,),
                                              n_strikes=1, **one)
    assert float(k4[0, 0]) == pytest.approx(float(k3), rel=1e-6)


def test_surface_adapter_on_cuda_is_differentiable(gpu):
    """The PRNG QE surface through the adapter launches K12 under a gradient
    request, and its gradient is K12's jacᵀ·ct."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (100.0, 0.04, 2.0, 0.04, 0.3, -0.7, 0.03)]
    spot, v0, kappa, theta, sigma, rho, r = leaves
    market = ht.HestonInputs(dt.date(2024, 1, 1), r, spot, v0, kappa, theta, sigma, rho)
    expiries = [dt.date(2024, 7, 1), dt.date(2025, 1, 1)]
    cfg = ht.SimulationConfig(2 * 32768, 8, ht.Antithetic(), 0, False)
    before = gk.QE_SURFACE_JAC_KERNEL.launches
    surf = qk.heston_surface_mc_adapter(market, expiries, [95.0, 105.0], cfg, device="cuda")
    grads = torch.stack(torch.autograd.grad(surf.sum(), leaves))
    assert gk.QE_SURFACE_JAC_KERNEL.launches == before + 1
    _, jac = gk.heston_qe_mixing_surface_price_and_jacobian(
        math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7, [182 / 365, 366 / 365], [95.0, 105.0],
        [math.exp(-0.03 * 182 / 365), math.exp(-0.03 * 366 / 365)], seg_steps=(4, 4),
        n_strikes=2, n_blocks=1, n_batches=2, seed=0, device="cuda")
    torch.testing.assert_close(grads, jac.sum(dim=(0, 1)).cpu(), rtol=1e-10, atol=1e-12)


# K9's resident blocks an SM before its redesign (63 registers, 256 threads;
# K12 2): the surface kernels' grid was this times the SMs
K9_PARENT_BLOCKS = 4


@pytest.mark.parametrize("qmc", [True, False])
def test_surface_kernels_share_their_pairs_at_each_grid(gpu, qmc):
    """K9 and K12 on the 3 × 5 grid over 3·2^12 + 37 pairs (a ragged last
    round), at the default grid and at the grid before K9's redesign
    (K9_PARENT_BLOCKS an SM): K12's surface column equal to K9's sums to
    the bit at each grid; K9 at the earlier grid against its twin within rel
    1e-5 (test_surface_kernels_match_twins's tolerance), and the two grids'
    sums within 1e-12 of each other."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    qe_seg, m, pairs = (8, 8, 16), len(SURF_K), 3 * 2**12 + 37
    params = torch.as_tensor(qk._surf_params(*MKT, SURF_T, qe_seg, SURF_K, 1.0), device=gpu)
    dct, djt = (torch.as_tensor(t, dtype=torch.float32, device=gpu)
                for t in gk._surface_greek_tables(*MKT[3:6], SURF_T, qe_seg))
    table = torch.as_tensor(qk.sobol_table(5, 2 * sum(qe_seg)), device=gpu) if qmc else None
    run = (table, qe_seg, m, pairs, 5, 0, 0)
    earlier = K9_PARENT_BLOCKS * torch.cuda.get_device_properties(gpu).multi_processor_count
    before = (qk.QE_SURFACE_KERNEL.launches, gk.QE_SURFACE_JAC_KERNEL.launches)
    sums = {}
    for grid in (None, earlier):
        sums[grid] = qk._qe_surface_sums(params, *run, grid=grid)
        jac = gk._surface_jac_sums(params, dct, djt, *run, grid=grid).reshape(-1, 7)
        assert torch.equal(jac[:, 0], sums[grid]) and bool(torch.isfinite(jac).all())
    assert (qk.QE_SURFACE_KERNEL.launches, gk.QE_SURFACE_JAC_KERNEL.launches) == (
        before[0] + 2, before[1] + 2)
    want = qk.heston_qe_mixing_surface_sums_plain(
        params.cpu(), None if table is None else table.cpu(), qe_seg, m, pairs, 5, 0, 0)
    torch.testing.assert_close(sums[earlier].cpu(), want, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(sums[None], sums[earlier], rtol=1e-12, atol=0.0)


RB_STEPS = 64  # the rough-Bergomi serving width (bench.py:681-692)


def _rb_problem(spot=100.0, xi0=0.04, eta=1.9, hurst=0.08, rho=-0.9):
    mkt = ht.RoughBergomiInputs(dt.date(2024, 1, 1), 0.03, spot, xi0, eta, hurst, rho)
    return ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2024, 12, 31)), mkt)


@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_kernels_match_twins(gpu, qmc):
    """K14 per path; K15 against K14's mean; K16's price equal to K15's (same
    stream, grid and reduction) and its sums against its twin; K17 against
    its twin under a smooth cotangent; at 64 steps.  Sums: fp32 per thread
    in another order than the twins', so rel 1e-5 of the largest plus 1e-5
    of each."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    assert torch.backends.cuda.matmul.allow_tf32 is False  # the twins' product in full fp32
    kernels = (rk.RB_VALUES_KERNEL, rk.RB_PRICE_KERNEL, rk.RB_GREEKS_KERNEL, rk.RB_VJP_KERNEL)
    before = [k.launches for k in kernels]
    cfg = ht.SimulationConfig(PAIRS, RB_STEPS, ht.Antithetic(), 5, qmc)
    ins = rk._rb_trace_inputs(_rb_problem(), cfg, 64)
    got = rk.rbergomi_mixing_values(*ins.values_args(), n_paths=PAIRS, steps=RB_STEPS, seed=5,
                                    antithetic=True, qmc=qmc, device=gpu)
    torch.cuda.synchronize()
    inp = rk.rb_inputs_from_trace(ins, seed=5, qmc=qmc, device=gpu)
    # per path within rel 1e-3: the kernel sums a Z row's 2n terms with FMAs in
    # its own order, the twin through cuBLAS; e^{eta Z} and the close amplify it
    _assert_values_close(got, rk.rbergomi_mixing_values_plain(inp, PAIRS, True, 5, 0, 0), 1e-3)
    kw = dict(n_blocks=PAIRS // rk.PAIRS_PER_BLOCK, n_batches=1, steps=RB_STEPS, seed=5, qmc=qmc,
              device=gpu)
    price = rk.rbergomi_mixing_vanilla_price(*ins._replace(discount=1.0).price_args(), **kw)
    assert float(price) == pytest.approx(float(got.double().mean()), rel=1e-6)
    g_ins = rk._rb_greek_trace_inputs(_rb_problem(), cfg, 64)
    g_price, greeks = rk.rbergomi_mixing_price_and_greeks(*g_ins._replace(discount=1.0), **kw)
    assert float(g_price) == float(price) and bool(torch.isfinite(greeks).all())
    g_inp = rk.rb_inputs_from_trace(g_ins, seed=5, qmc=qmc, device=gpu)
    want = rk.rbergomi_mixing_greek_sums_plain(g_inp, PAIRS, 5, 0, 0)
    sums = rk._rb_greek_sums(g_inp, PAIRS, 5, 0, 0)
    assert ((sums - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()).all()
    ct = 0.5 + 0.5 * torch.sin(torch.arange(2 * PAIRS, device=gpu, dtype=torch.float32)).reshape(
        2, PAIRS)
    v_inp = rk.rb_inputs_from_trace(g_ins, seed=5, qmc=qmc, device=gpu, hurst=0.08)
    want = rk.rbergomi_mixing_vjp_sums_plain(v_inp, ct, PAIRS, True, 5, 0, 0)
    sums = rk._rb_vjp_sums(v_inp, ct, PAIRS, True, 5, 0, 0)
    assert ((sums - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()).all()
    assert [k.launches for k in kernels] == [b + n for b, n in zip(before, (1, 1, 2, 1))]


def test_rbergomi_solve_on_cuda_is_differentiable(gpu):
    """solve with RoughBergomiMixing(use_kernel=True) on cuda launches K14,
    torch.autograd.grad of its price launches K17, and the gradient agrees
    with K16's greeks on the same pairs (rel 1e-5 of the largest plus 1e-5)."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (100.0, 0.04, 1.9, 0.08, -0.9)]
    spot, xi0, eta, hurst, rho = leaves
    cfg = ht.SimulationConfig(PAIRS, RB_STEPS, ht.Antithetic(), 0, False)
    before = (rk.RB_VALUES_KERNEL.launches, rk.RB_VJP_KERNEL.launches)
    sol = ht.solve(_rb_problem(spot, xi0, eta, hurst, rho),
                   ht.MonteCarlo(ht.RoughBergomiDynamics(), ht.RoughBergomiMixing(use_kernel=True),
                                 cfg, device="cuda"))
    grads = torch.autograd.grad(sol.price, leaves)
    assert (rk.RB_VALUES_KERNEL.launches, rk.RB_VJP_KERNEL.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    price, greeks = rk.rbergomi_kernel_price_and_greeks(
        _rb_problem(), cfg, n_blocks=PAIRS // rk.PAIRS_PER_BLOCK, n_batches=1, device="cuda")
    assert float(sol.price.detach()) == pytest.approx(float(price), rel=1e-6)
    got = torch.stack([grads[0], grads[1], grads[2], grads[4], grads[3]])
    want = torch.stack([greeks[k] for k in ("spot", "xi0", "eta", "rho", "hurst")]).cpu()
    assert ((got - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_curve_kernel_flat_identity(gpu, qmc):
    """K18 under a flat curve (every level 0.04) on K17's stream and
    cotangent: the bucket vegas sum to K17's xi0 gradient within rel 1e-5
    (n per-step fp32 rows against one), the tenor sensitivities are exactly
    0; and K18's n + 6 sums against its twin within rel 1e-5 of the largest
    plus 1e-5 of each."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    ct = 0.5 + 0.5 * torch.sin(torch.arange(2 * PAIRS, device=gpu, dtype=torch.float32)).reshape(
        2, PAIRS)
    kw = dict(n_paths=PAIRS, steps=RB_STEPS, seed=5, antithetic=True, qmc=qmc)
    rest = (1.9, 0.08, -0.9, 0.03, 1.0, 100.0, 1.0, ct)
    before = rk.RB_VJP_CURVE_KERNEL.launches
    curve = rk._rb_values_vjp_curve(100.0, [0.04] * 3, [0.25, 0.5, 1.0], *rest, **kw)
    assert rk.RB_VJP_CURVE_KERNEL.launches == before + 1
    flat = rk._rb_values_vjp(100.0, 0.04, *rest, **kw)
    assert float(curve[1].sum()) == pytest.approx(float(flat[1]), rel=1e-5)
    assert curve[2].tolist() == [0.0, 0.0, 0.0]
    inp = rk.rb_vjp_inputs(100.0, ([0.25, 0.5, 1.0], [0.04] * 3), 1.9, 0.08, -0.9, 0.03, 1.0,
                           100.0, 1.0, steps=RB_STEPS, seed=5, qmc=qmc, device=gpu)
    sums = rk._rb_vjp_sums(inp, ct, PAIRS, True, 5, 0, 0, per_step=True)
    want = rk.rbergomi_mixing_vjp_curve_sums_plain(inp, ct, PAIRS, True, 5, 0, 0)
    assert sums.shape == (RB_STEPS + 6,)
    assert ((sums - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_smile_kernel_equals_the_price_kernel(gpu, qmc):
    """K19 at strikes 80, 100, 120: each price equals K15's at that strike to
    the bit (K15's pairs, grid, close and reduction), and its sums agree
    with the twin's within rel 1e-6."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    strikes = (80.0, 100.0, 120.0)
    cfg = ht.SimulationConfig(PAIRS, RB_STEPS, ht.Antithetic(), 5, qmc)
    kw = dict(n_blocks=PAIRS // rk.PAIRS_PER_BLOCK, n_batches=1, device=gpu)
    before = rk.RB_SMILE_KERNEL.launches
    smile = rk.rbergomi_kernel_smile(_rb_problem(), cfg, strikes, **kw)
    assert rk.RB_SMILE_KERNEL.launches == before + 1
    for k, strike in enumerate(strikes):
        prob = ht.PricingProblem(ht.VanillaOption(strike, dt.date(2024, 12, 31)),
                                 _rb_problem().market_inputs)
        ins = rk._rb_trace_inputs(prob, cfg, 64)
        price = rk.rbergomi_mixing_vanilla_price(*ins.price_args(), steps=RB_STEPS, seed=5,
                                                 qmc=qmc, **kw)
        assert float(smile[k]) == float(price), strike
    ins = rk._rb_trace_inputs(_rb_problem(), cfg, 64)
    inp = rk.rb_inputs_from_trace(ins, seed=5, qmc=qmc, device=gpu)
    ks = rk.smile_strikes(ins.f_base, strikes, gpu)
    torch.testing.assert_close(rk._rb_smile_sums(inp, ks, PAIRS, 5, 0, 0),
                               rk.rbergomi_mixing_smile_sums_plain(inp, ks, PAIRS, 5, 0, 0),
                               rtol=1e-6, atol=0)


# the step counts at the chunked product's edges: one step (no product), the
# 8-row tiles (8, 9), the 32-row chunks (32, 33; csrc/rbergomi.cu
# kChunkRows), the serving 64 and 65, and the 256-step limit (MAX_STEPS)
RB_EDGE_STEPS = (1, 2, 8, 9, 32, 33, 64, 65, 255, 256)
RB_EDGE_PAIRS = 3 * 2**14 + 5  # no multiple of 64 x the grid: the last trip masks slots


@pytest.mark.parametrize("steps", RB_EDGE_STEPS)
@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_chunked_product_keeps_each_pairs_bits(gpu, qmc, steps):
    """K15 and K19 (the block-cooperative product over row chunks) at the
    chunks' and tiles' edges: K15 against its twin within rel 1e-6; K16
    (the tangent chunk product, on K15's grid) equal to K15's sum to the
    bit, so each pair's fp32 value kept its bits; K19 at each
    strike equal to K15's at that strike to the bit and against its twin
    within rel 1e-6."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs, strikes = RB_EDGE_PAIRS, (80.0, 100.0, 120.0)
    cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 5, qmc)
    ins = rk._rb_trace_inputs(_rb_problem(), cfg, 64)
    inp = rk.rb_inputs_from_trace(ins, seed=5, qmc=qmc, device=gpu)
    before = (rk.RB_PRICE_KERNEL.launches, rk.RB_SMILE_KERNEL.launches)
    k15 = float(rk._rb_price_sum(inp, pairs, 5, 0, 0))
    assert k15 == pytest.approx(float(rk.rbergomi_mixing_price_sum_plain(inp, pairs, 5, 0, 0)),
                                rel=1e-6)
    g_inp = rk.rb_inputs_from_trace(rk._rb_greek_trace_inputs(_rb_problem(), cfg, 64), seed=5,
                                    qmc=qmc, device=gpu)
    assert float(rk._rb_greek_sums(g_inp, pairs, 5, 0, 0)[0]) == k15
    ks = rk.smile_strikes(ins.f_base, strikes, gpu)
    smile = rk._rb_smile_sums(inp, ks, pairs, 5, 0, 0)
    for k, strike in enumerate(strikes):
        k_inp = rk.rb_inputs_from_trace(
            ins._replace(strike=strike, log_f_over_k=math.log(ins.f_base / strike)), seed=5,
            qmc=qmc, device=gpu)
        assert float(smile[k]) == float(rk._rb_price_sum(k_inp, pairs, 5, 0, 0)), strike
    torch.testing.assert_close(smile, rk.rbergomi_mixing_smile_sums_plain(inp, ks, pairs, 5, 0, 0),
                               rtol=1e-6, atol=0)
    assert (rk.RB_PRICE_KERNEL.launches, rk.RB_SMILE_KERNEL.launches) == (before[0] + 4,
                                                                           before[1] + 1)


@pytest.mark.parametrize("steps, qmc, pairs", [
    (2, True, RB_EDGE_PAIRS), (2, False, RB_EDGE_PAIRS), (3, True, RB_EDGE_PAIRS),
    (3, False, RB_EDGE_PAIRS), (17, True, RB_EDGE_PAIRS), (17, False, RB_EDGE_PAIRS),
    (64, True, RB_EDGE_PAIRS), (64, False, RB_EDGE_PAIRS), (64, True, 2**20),
    (64, False, 2**20), (256, True, RB_EDGE_PAIRS)])
def test_rbergomi_greek_kernel_on_the_tangent_chunk_product(gpu, qmc, steps, pairs):
    """K16 (two threads a pair on the tangent chunk product, 16-row chunks:
    17 steps fill one) at the chunks' edges over RB_EDGE_PAIRS pairs (the
    last trip masks slots) and at the serving 64 steps over 2^20 pairs: its
    price equal to K15's sum to the bit, and its six sums against its twin
    within rel 1e-5 of the largest plus 1e-5 of each
    (test_rbergomi_kernels_match_twins's tolerance)."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 5, qmc)
    inp = rk.rb_inputs_from_trace(rk._rb_trace_inputs(_rb_problem(), cfg, 64), seed=5, qmc=qmc,
                                  device=gpu)
    g_inp = rk.rb_inputs_from_trace(rk._rb_greek_trace_inputs(_rb_problem(), cfg, 64), seed=5,
                                    qmc=qmc, device=gpu)
    before = rk.RB_GREEKS_KERNEL.launches
    sums = rk._rb_greek_sums(g_inp, pairs, 5, 0, 0)
    assert rk.RB_GREEKS_KERNEL.launches == before + 1
    assert float(sums[0]) == float(rk._rb_price_sum(inp, pairs, 5, 0, 0))
    want = rk.rbergomi_mixing_greek_sums_plain(g_inp, pairs, 5, 0, 0)
    assert sums.shape == (6,) and bool(torch.isfinite(sums).all())
    assert ((sums - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "one-group"])
@pytest.mark.parametrize("steps", RB_EDGE_STEPS)
@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_curve_kernel_at_the_chunk_edges(gpu, qmc, steps, antithetic):
    """K18 on the tangent chunk product at the chunks' and tiles' edges,
    with a last block of 5 pairs: its n + 6 sums against its twin within
    rel 1e-5 of the largest plus 1e-5 of each under a sloped curve, and
    (steps >= 2, where the curve route runs) under a flat curve its bucket
    vegas sum to K17's xi0 gradient within rel 1e-5, tenor sensitivities 0."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs, groups = RB_EDGE_PAIRS, 2 if antithetic else 1
    ct = 0.5 + 0.5 * torch.sin(torch.arange(groups * pairs, device=gpu, dtype=torch.float32))
    ct = ct.reshape(groups, pairs)
    inp = rk.rb_vjp_inputs(100.0, ([0.25, 0.5, 1.0], [0.035, 0.04, 0.045]), 1.9, 0.08, -0.9, 0.03,
                           1.0, 100.0, 1.0, steps=steps, seed=5, qmc=qmc, device=gpu)
    before = rk.RB_VJP_CURVE_KERNEL.launches
    sums = rk._rb_vjp_sums(inp, ct, pairs, antithetic, 5, 0, 0, per_step=True)
    assert rk.RB_VJP_CURVE_KERNEL.launches == before + 1
    want = rk.rbergomi_mixing_vjp_curve_sums_plain(inp, ct, pairs, antithetic, 5, 0, 0)
    assert sums.shape == (steps + 6,) and bool(torch.isfinite(sums).all())
    assert ((sums - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()).all()
    if steps < 2:
        return
    kw = dict(n_paths=pairs, steps=steps, seed=5, antithetic=antithetic, qmc=qmc)
    rest = (1.9, 0.08, -0.9, 0.03, 1.0, 100.0, 1.0, ct)
    curve = rk._rb_values_vjp_curve(100.0, [0.04] * 3, [0.25, 0.5, 1.0], *rest, **kw)
    flat = rk._rb_values_vjp(100.0, 0.04, *rest, **kw)
    assert float(curve[1].sum()) == pytest.approx(float(flat[1]), rel=1e-5)
    assert curve[2].tolist() == [0.0, 0.0, 0.0]


def _k15_order_sum(values, grid: int):
    """The float64 sum of each pair's fp32 (value + antithetic value) in K15's
    order at ``grid`` blocks (csrc/rbergomi.cu rb_price_kernel): slot t of
    block b adds the pairs 64·b + t + 64·grid·r over its trips r in fp32,
    the 64 slot sums of a block reduce in float64 by the halving tree
    (slot_tree), then the (grid,) partials by one contiguous sum."""
    v = values[0] + values[1]
    per = grid * 64
    trips = -(-v.numel() // per)
    v = torch.nn.functional.pad(v, (0, trips * per - v.numel())).reshape(trips, grid, 64)
    acc = torch.zeros((grid, 64), dtype=torch.float32, device=v.device)
    for r in range(trips):
        acc = acc + v[r]
    red, h = acc.double(), 32
    while h:
        red[:, :h] = red[:, :h] + red[:, h: 2 * h]
        h //= 2
    return red[:, 0].contiguous().sum()


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "one-group"])
@pytest.mark.parametrize("steps", RB_EDGE_STEPS)
@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_values_kernel_at_the_chunk_edges(gpu, qmc, steps, antithetic):
    """K14 (K15's chunked trips on a resident wave of its own) at the chunks'
    and tiles' edges over RB_EDGE_PAIRS pairs (a ragged last trip), one
    launch a call: per path against its twin at chip_smoke's K14 tolerance
    (RB_VALUES_TOL: >= 99.8% within rel 1e-3 of max(|value|, 1e-3), the
    means within 1e-6); one group equal to the antithetic call's first row;
    each pair's (value + antithetic value) summed in K15's order equal to
    K15's sum to the bit.

    The share is 99.8%, not test_rbergomi_kernels_match_twins's 99.9%: the
    close forms f·N(d1) − K·N(d2) from terms of the strike's size, so a
    value below a few 1e-3 carries up to an ulp of 100 (7.6e-6) from either
    side's fp32 rounding (the card contracts it into FMAs), up to 6e-3
    relative at the 1e-3 floor.  On an H100 0.03-0.16% of the paths here
    differ so, one step (no product) included, and the twin on the card and
    on the CPU differ so on 14-46 paths; the values keep their bits from the
    one-pair-a-thread kernel (chip_smoke.py --digest)."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs = RB_EDGE_PAIRS
    cfg = ht.SimulationConfig(pairs, steps, ht.Antithetic(), 5, qmc)
    inp = rk.rb_inputs_from_trace(rk._rb_trace_inputs(_rb_problem(), cfg, 64), seed=5, qmc=qmc,
                                  device=gpu)
    before = rk.RB_VALUES_KERNEL.launches
    got = rk._rb_values(inp, pairs, antithetic, 5, 0, 0)
    assert rk.RB_VALUES_KERNEL.launches == before + 1
    want = rk.rbergomi_mixing_values_plain(inp, pairs, antithetic, 5, 0, 0)
    _assert_values_close(got, want, 1e-3, share=0.998)
    if not antithetic:
        assert torch.equal(got[0], rk._rb_values(inp, pairs, True, 5, 0, 0)[0])
        return
    assert float(_k15_order_sum(got, rk.price_grid(inp))) == float(
        rk._rb_price_sum(inp, pairs, 5, 0, 0))


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "one-group"])
@pytest.mark.parametrize("steps", [n for n in RB_EDGE_STEPS if n >= 2])
@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_vjp_kernel_at_the_chunk_edges(gpu, qmc, steps, antithetic):
    """K17 (one trip of 64 pairs a block on the tangent chunk product) at the
    chunks' and tiles' edges, with a last block of 5 pairs, one launch a
    call: its seven sums against its twin within rel 1e-5 of the largest
    plus 1e-5 of each (test_rbergomi_kernels_match_twins's tolerance)."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs, groups = RB_EDGE_PAIRS, 2 if antithetic else 1
    ct = 0.5 + 0.5 * torch.sin(torch.arange(groups * pairs, device=gpu, dtype=torch.float32))
    ct = ct.reshape(groups, pairs)
    inp = rk.rb_vjp_inputs(100.0, 0.04, 1.9, 0.08, -0.9, 0.03, 1.0, 100.0, 1.0, steps=steps,
                           seed=5, qmc=qmc, device=gpu)
    before = rk.RB_VJP_KERNEL.launches
    sums = rk._rb_vjp_sums(inp, ct, pairs, antithetic, 5, 0, 0)
    assert rk.RB_VJP_KERNEL.launches == before + 1
    want = rk.rbergomi_mixing_vjp_sums_plain(inp, ct, pairs, antithetic, 5, 0, 0)
    assert sums.shape == (7,) and bool(torch.isfinite(sums).all())
    assert ((sums - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()).all()


def _exact_surface_run(gpu, seg_steps, m, qmc, pairs):
    """K4's launch arguments for m strikes from 60 to 140 and an expiry after
    each gap of seg_steps[i] exact segments of a quarter year each (the
    Poisson trip count of shorter segments outgrows its limit at this
    market)."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    T_host = [0.25 * sum(seg_steps[:i + 1]) for i in range(len(seg_steps))]
    strikes = [60.0 + 80.0 * k / max(m - 1, 1) for k in range(m)]
    params = torch.as_tensor(ek._exact_surf_params(*MKT, T_host, seg_steps, strikes, 1.0),
                             device=gpu)
    kmaxes = [poisson_kmax(*MKT[3:6], d, MKT[1]) for d in qk.segment_dts(T_host, seg_steps)]
    table = (torch.as_tensor(qk.sobol_table(5, 4 * sum(seg_steps)), device=gpu) if qmc else None)
    return (params, table, tuple(seg_steps), kmaxes, m, pairs, 5, 0, 0)


@pytest.mark.parametrize("seg_steps, m", [((1,), 1), ((2, 1, 2), 5), ((16,), 3), ((6, 5, 5), 17)],
                         ids=["1x1", "3x5", "16-segments", "3x17"])
@pytest.mark.parametrize("qmc", [True, False])
def test_exact_surface_kernel_matches_twin(gpu, qmc, seg_steps, m):
    """K4 (two threads a pair) at 1 to 16 segments and up to 3 × 17 points,
    over 3·2^12 + 37 pairs (no multiple of a block's 256 a round): each
    point's sum against the twin's within rel 1e-5, at the resident grid
    and at the one-pair-a-thread kernel's (3 blocks an SM), and the two
    grids' sums within 1e-12 of each other."""
    run = _exact_surface_run(gpu, seg_steps, m, qmc, 3 * 2**12 + 37)
    before = ek.EXACT_SURFACE_KERNEL.launches
    got = ek._exact_surface_sums(*run)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    at_parent = ek._exact_surface_sums(*run, grid=3 * sms)
    assert ek.EXACT_SURFACE_KERNEL.launches == before + 2
    want = ek.heston_exact_mixing_surface_sums_plain(*run)
    assert got.shape == (len(seg_steps) * m,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(at_parent, got, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("qmc", [True, False])
def test_exact_surface_kernel_wide_surface_matches_twin(gpu, qmc):
    """K4 on a 10 × 20 surface (quarterly expiries, one launch) over 3·2^12 +
    37 pairs: each point's mean value against the twin's within rel 1e-5,
    means below 1e-3 compared absolutely (chip_smoke's compare_points: the
    deep out-of-the-money points of the first expiries)."""
    pairs = 3 * 2**12 + 37
    run = _exact_surface_run(gpu, (1,) * 10, 20, qmc, pairs)
    got = ek._exact_surface_sums(*run).cpu() / (2 * pairs)
    want = ek.heston_exact_mixing_surface_sums_plain(*run).cpu() / (2 * pairs)
    assert got.shape == (200,) and bool(torch.isfinite(got).all())
    assert float(((got - want).abs() / want.abs().clamp(min=1e-3)).max()) <= 1e-5


# sha256 of the one-pair-a-thread K4's float64 sums of the 3 x 5 surface
# (bench.py's grid, exact-4 = 5 segments) at 2^20 pairs, seed 5, with the
# repaired Heston draws: chip_smoke.py --digest's "K4 QMC" and "K4 PRNG" of
# that tree
K4_ONE_PAIR_A_THREAD_DIGESTS = {
    True: "4db2a4b4a05b75f9a7c8084b9ae4f6fece6ab8252832e1da66bd4b4ec3caa9f5",
    False: "932415da32146a120ee456d92d232c31ccf6a81082c93d92b2e56531c20e43d5",
}


@pytest.mark.parametrize("qmc", [True, False])
def test_exact_surface_kernel_at_the_earlier_grid_keeps_its_bits(gpu, qmc):
    """Two threads a pair, at the one-pair-a-thread kernel's grid (3 blocks
    an SM of 256 pairs a round), sum every pair's fp32 value in that
    kernel's order: the surface's sums equal its stored digest."""
    import hashlib

    from hedgehog_tpu_torch.methods.heston_surface import surface_seg_steps
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    ref = dt.date(2024, 1, 1)
    T_host = [float(ht.yearfrac(ref, e)) for e in
              (dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2026, 1, 1))]
    ex_seg = tuple(surface_seg_steps(T_host, 4, min_first=2)[1])
    params = torch.as_tensor(ek._exact_surf_params(*MKT, T_host, ex_seg,
                                                   (85.0, 95.0, 100.0, 105.0, 120.0), 1.0),
                             device=gpu)
    kmaxes = [poisson_kmax(*MKT[3:6], d, MKT[1]) for d in qk.segment_dts(T_host, ex_seg)]
    table = torch.as_tensor(qk.sobol_table(5, 4 * sum(ex_seg)), device=gpu) if qmc else None
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    sums = ek._exact_surface_sums(params, table, ex_seg, kmaxes, 5, 2**20, 5, 0, 0, grid=3 * sms)
    digest = hashlib.sha256(sums.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    assert digest == K4_ONE_PAIR_A_THREAD_DIGESTS[qmc]


# ---- past the sizes the port once refused (the JAX kernels take them) ----------
#
# Each repaired kernel just past its old limit against its twin.  The kernel
# and the twin differ by fp32 ulps a step, which add up along the chain, so
# the per-path limits are this file's at the serving chain (QE 11 steps,
# exact 2 segments, rough Bergomi 64 steps) scaled by the chain's length
# (chip_smoke.py chain_tol); sums as elsewhere here.

WIDE_PAIRS = 2**14


def _chain_close(got, want, steps, base, rtol=1e-4, share=0.999, mean_rtol=1e-6):
    k = max(1.0, steps / base)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1e-3)
    assert float((rel <= rtol * k).double().mean()) >= share
    assert float(got.double().mean()) == pytest.approx(float(want.double().mean()),
                                                       rel=mean_rtol * k)


def _sums_close(got, want, rtol=1e-5):
    got, want = got.double().cpu(), want.double().cpu()
    assert bool(torch.isfinite(got).all())
    assert ((got - want).abs() <= rtol * float(want.abs().max()) + rtol * want.abs()).all()


@pytest.mark.parametrize("qmc", [True, False])
def test_qe_kernels_past_128_qmc_steps_match_twins(gpu, qmc):
    """K7, K8, K10, K11 and K5 at 129 steps (QMC once stopped at 128; the
    129-step Sobol' tables are staged past the 48 KB a block takes without
    opting in for K5) against their twins; K10's price equal to K8's."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    n, pairs = 129, WIDE_PAIRS
    params, table = qk.mix_inputs(*MKT, T / n, 100.0, 1.0, n, 5, qmc, gpu)
    _chain_close(qk._qe_values(params, table, pairs, n, True, 5, 0, 0),
                 qk.heston_qe_mixing_values_plain(params, table, pairs, n, True, 5, 0, 0), n, 11)
    price = qk._qe_price_sum(params, table, pairs, n, 5, 0, 0)
    _sums_close(price.reshape(1),
                qk.heston_qe_mixing_price_sum_plain(params, table, pairs, n, 5, 0, 0).reshape(1))
    dtab = torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, T / n, n, 4), device=gpu)
    sums = gk._greek_sums(params, dtab, table, pairs, n, 5, 0, 0)
    assert float(sums[0]) == float(price)
    _sums_close(sums, gk.heston_qe_mixing_greek_sums_plain(params, dtab, table, pairs, n, 5, 0, 0))
    vtab = torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, T / n, n, 5), device=gpu)
    ct = 0.5 + 0.5 * torch.sin(torch.arange(2 * pairs, device=gpu, dtype=torch.float32)).reshape(
        2, pairs)
    _sums_close(gk._vjp_sums(params, vtab, table, ct, pairs, n, True, 5, 0, 0),
                gk.heston_qe_mixing_vjp_sums_plain(params, vtab, table, ct, pairs, n, True, 5, 0,
                                                   0))
    p5, t5 = qk.qem_inputs(*MKT, T / n, n, 5, qmc, gpu)
    _chain_close(qk._qem_terminal(p5, t5, pairs, n, True, True, 5, 0, 0),
                 qk.heston_qe_terminal_plain(p5, t5, pairs, n, True, True, 5, 0, 0), n, 10)


@pytest.mark.parametrize("qmc", [True, False])
def test_exact_kernels_past_16_qmc_segments_match_twins(gpu, qmc):
    """K2 and K3 at 17 segments of a five-year call, and K4 on two expiries
    (2.5 and 5 years) of 9 and 8 segments (QMC once stopped at 16), against
    their twins."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    segs, pairs = 17, WIDE_PAIRS
    params, table, kmax = ek._inputs(*MKT, 5.0 / segs, 100.0, 1.0, segs, 5, qmc, gpu)
    _chain_close(ek._exact_values(params, table, pairs, segs, True, kmax, 5, 0, 0),
                 ek.heston_exact_mixing_values_plain(params, table, pairs, segs, True, kmax, 5, 0,
                                                     0), segs, 2)
    _sums_close(ek._exact_price_sum(params, table, pairs, segs, kmax, 5, 0, 0).reshape(1),
                ek.heston_exact_mixing_price_sum_plain(params, table, pairs, segs, kmax, 5, 0,
                                                       0).reshape(1))
    T_host, seg, strikes = (2.5, 5.0), (9, 8), (80.0, 100.0, 125.0)
    p4 = torch.as_tensor(ek._exact_surf_params(*MKT, T_host, seg, strikes, 1.0), device=gpu)
    kmaxes = [poisson_kmax(*MKT[3:6], d, MKT[1]) for d in qk.segment_dts(T_host, seg)]
    t4 = torch.as_tensor(qk.sobol_table(5, 4 * sum(seg)), device=gpu) if qmc else None
    run = (p4, t4, seg, kmaxes, len(strikes), pairs, 5, 0, 0)
    torch.testing.assert_close(ek._exact_surface_sums(*run).cpu(),
                               ek.heston_exact_mixing_surface_sums_plain(*run).cpu(), rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("qmc", [True, False])
def test_surface_kernels_past_128_qmc_steps_match_twins(gpu, qmc):
    """K9 and K12 on the 3 × 5 grid at 129 steps over the expiries (QMC
    once stopped at 128) against their twins; K12's surface column equal to
    K9's sums to the bit."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    qe_seg, m, pairs = (43, 43, 43), len(SURF_K), WIDE_PAIRS
    params = torch.as_tensor(qk._surf_params(*MKT, SURF_T, qe_seg, SURF_K, 1.0), device=gpu)
    dct, djt = (torch.as_tensor(t, dtype=torch.float32, device=gpu)
                for t in gk._surface_greek_tables(*MKT[3:6], SURF_T, qe_seg))
    table = torch.as_tensor(qk.sobol_table(5, 2 * sum(qe_seg)), device=gpu) if qmc else None
    run = (table, qe_seg, m, pairs, 5, 0, 0)
    s9 = qk._qe_surface_sums(params, *run)
    torch.testing.assert_close(s9.cpu(), qk.heston_qe_mixing_surface_sums_plain(params, *run).cpu(),
                               rtol=1e-5, atol=0.0)
    s12 = gk._surface_jac_sums(params, dct, djt, *run)
    assert torch.equal(s12.reshape(-1, 7)[:, 0], s9)
    _sums_close(s12, gk.heston_qe_mixing_surface_jac_sums_plain(params, dct, djt, *run))


# ---- past the staging limit: the Sobol' table read from global memory --------
#
# Past the table that fits a block's shared memory (227 KB on an H100 with
# the opt-in) the QMC kernels run their second instantiation, which reads
# the table from global memory; K9, K12 and K4 stage it only where a
# one-strike launch with it fits SURFACE_SMEM_LIMIT.  Per path the
# tolerances above scaled by the chain's length; sums within the larger of
# 1e-5 and the chain's mean tolerance (1e-6 a serving chain, scaled).  The
# exact cases run a 20-year call under a vol-of-vol of 0.9: at 0.3 a
# segment that short needs more Poisson trips than the scheme takes.

GLOBAL_EXACT_MKT = MKT[:5] + (0.9, MKT[6])


def _optin_bytes(gpu):
    return getattr(torch.cuda.get_device_properties(gpu), "shared_memory_per_block_optin",
                   227 * 1024)


def test_qe_kernels_past_the_staging_limit_match_twins(gpu):
    """K7, K8, K10, K11 at 1000 QMC steps (a 248 KB table) and K5 at 700
    (260 KB) against their twins; K10's price equal to K8's."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    n, pairs = 1000, WIDE_PAIRS
    params, table = qk.mix_inputs(*MKT, T / n, 100.0, 1.0, n, 5, True, gpu)
    assert 4 * table.numel() > _optin_bytes(gpu)
    _chain_close(qk._qe_values(params, table, pairs, n, True, 5, 0, 0),
                 qk.heston_qe_mixing_values_plain(params, table, pairs, n, True, 5, 0, 0), n, 11)
    sum_rtol = max(1e-5, 1e-6 * n / 11)
    price = qk._qe_price_sum(params, table, pairs, n, 5, 0, 0)
    _sums_close(price.reshape(1),
                qk.heston_qe_mixing_price_sum_plain(params, table, pairs, n, 5, 0, 0).reshape(1),
                sum_rtol)
    dtab = torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, T / n, n, 4), device=gpu)
    sums = gk._greek_sums(params, dtab, table, pairs, n, 5, 0, 0)
    assert float(sums[0]) == float(price)
    _sums_close(sums, gk.heston_qe_mixing_greek_sums_plain(params, dtab, table, pairs, n, 5, 0, 0),
                sum_rtol)
    vtab = torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, T / n, n, 5), device=gpu)
    ct = 0.5 + 0.5 * torch.sin(torch.arange(2 * pairs, device=gpu, dtype=torch.float32)).reshape(
        2, pairs)
    _sums_close(gk._vjp_sums(params, vtab, table, ct, pairs, n, True, 5, 0, 0),
                gk.heston_qe_mixing_vjp_sums_plain(params, vtab, table, ct, pairs, n, True, 5, 0,
                                                   0), sum_rtol)
    n = 700
    p5, t5 = qk.qem_inputs(*MKT, T / n, n, 5, True, gpu)
    assert 4 * t5.numel() > _optin_bytes(gpu)
    _chain_close(qk._qem_terminal(p5, t5, pairs, n, True, True, 5, 0, 0),
                 qk.heston_qe_terminal_plain(p5, t5, pairs, n, True, True, 5, 0, 0), n, 10)


@pytest.mark.parametrize("kernel, steps", [("K7", 252), ("K7", 400), ("K5", 200), ("K5", 252),
                                           ("K11", 252), ("K11", 400)])
def test_qe_values_and_terminal_kernels_past_the_staging_decision_match_twins(gpu, kernel, steps):
    """K7, K11 and K5 under QMC on both sides of their staging decision
    against their twins, from a point offset off the warp's 32-point cells:
    they stage the table and each warp's high words (the split draw) where 2
    blocks an SM still hold them (K7 and K11 to ~300 steps, K5 to ~200 on an
    H100) and read the table from global memory past that, where the table
    alone still fits a block."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    pairs, offset = WIDE_PAIRS + 7, 777
    if kernel == "K11":
        params, table = qk.mix_inputs(*MKT, T / steps, 100.0, 1.0, steps, 5, True, gpu)
        assert 4 * table.numel() < _optin_bytes(gpu)
        vtab, ct = _vjp_table(gpu, steps), _smooth_ct(gpu, pairs)
        _sums_close(gk._vjp_sums(params, vtab, table, ct, pairs, steps, True, 5, 0, offset),
                    gk.heston_qe_mixing_vjp_sums_plain(params, vtab, table, ct, pairs, steps, True,
                                                       5, 0, offset), max(1e-5, 1e-6 * steps / 11))
    elif kernel == "K7":
        params, table = qk.mix_inputs(*MKT, T / steps, 100.0, 1.0, steps, 5, True, gpu)
        assert 4 * table.numel() < _optin_bytes(gpu)
        _chain_close(qk._qe_values(params, table, pairs, steps, True, 5, 0, offset),
                     qk.heston_qe_mixing_values_plain(params, table, pairs, steps, True, 5, 0,
                                                      offset), steps, 11)
    else:
        params, table = qk.qem_inputs(*MKT, T / steps, steps, 5, True, gpu)
        assert 4 * table.numel() < _optin_bytes(gpu)
        _chain_close(qk._qem_terminal(params, table, pairs, steps, True, True, 5, 0, offset),
                     qk.heston_qe_terminal_plain(params, table, pairs, steps, True, True, 5, 0,
                                                 offset), steps, 10)


def test_vjp_kernel_staged_and_global_qmc_builds_give_equal_bits(gpu, tmp_path):
    """K11 under QMC at 252 steps, where this tree stages the split draw,
    against a copy of the package whose every QMC launch reads the table
    from global memory (scripts/variant_times.py's "table in global memory"
    edit of hh::kStagedBlocks), run in a process of its own: the eight
    float64 sums are equal to the bit (the same integers, and each block's
    sums in the same order), and both builds' against the twin."""
    import subprocess
    import sys

    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "scripts"))
    import variant_times

    variant_times.phase_costs.make_copy(root, tmp_path, variant_times.VARIANTS["K11 band"][
        "table in global memory"])
    steps, pairs, offset = 252, WIDE_PAIRS + 7, 777
    script = (
        "import math, sys, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk\n"
        "from hedgehog_tpu_torch.ops import heston_qe_kernel as qk\n"
        f"T, steps, pairs = {T!r}, {steps}, {pairs}\n"
        f"params, table = qk.mix_inputs(*{MKT!r}, T / steps, 100.0, 1.0, steps, 5, True, 'cuda')\n"
        "vtab = torch.as_tensor(gk._greek_table(0.04, 2.0, 0.04, 0.3, T / steps, steps, 5),"
        " device='cuda')\n"
        "ct = 0.5 + 0.5 * torch.sin(torch.arange(2 * pairs, device='cuda',"
        " dtype=torch.float32)).reshape(2, pairs)\n"
        f"sums = gk._vjp_sums(params, vtab, table, ct, pairs, steps, True, 5, 0, {offset})\n"
        "assert gk.__file__.startswith(sys.path[0]), gk.__file__\n"
        "print(' '.join(float(x).hex() for x in sums.cpu()))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    global_sums = torch.tensor([float.fromhex(x) for x in proc.stdout.split()],
                               dtype=torch.float64)
    params, table = qk.mix_inputs(*MKT, T / steps, 100.0, 1.0, steps, 5, True, gpu)
    vtab, ct = _vjp_table(gpu, steps), _smooth_ct(gpu, pairs)
    staged = gk._vjp_sums(params, vtab, table, ct, pairs, steps, True, 5, 0, offset).cpu()
    assert staged.tolist() == global_sums.tolist()
    _sums_close(staged, gk.heston_qe_mixing_vjp_sums_plain(params, vtab, table, ct, pairs, steps,
                                                           True, 5, 0, offset),
                max(1e-5, 1e-6 * steps / 11))


def test_exact_kernels_past_the_staging_limit_match_twins(gpu):
    """K2 and K3 at 480 QMC segments (a 238 KB table), and K4 on two
    expiries of 240, against their twins."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    segs, years, pairs = 480, 20.0, WIDE_PAIRS
    params, table, kmax = ek._inputs(*GLOBAL_EXACT_MKT, years / segs, 100.0, 1.0, segs, 5, True,
                                     gpu)
    assert 4 * table.numel() > _optin_bytes(gpu)
    _chain_close(ek._exact_values(params, table, pairs, segs, True, kmax, 5, 0, 0),
                 ek.heston_exact_mixing_values_plain(params, table, pairs, segs, True, kmax, 5, 0,
                                                     0), segs, 2)
    sum_rtol = 1e-6 * segs / 2
    _sums_close(ek._exact_price_sum(params, table, pairs, segs, kmax, 5, 0, 0).reshape(1),
                ek.heston_exact_mixing_price_sum_plain(params, table, pairs, segs, kmax, 5, 0,
                                                       0).reshape(1), sum_rtol)
    T_host, seg, strikes = (years / 2, years), (segs // 2, segs // 2), (80.0, 100.0, 125.0)
    assert not ek.exact_surface_staged(2, segs, True)
    p4 = torch.as_tensor(ek._exact_surf_params(*GLOBAL_EXACT_MKT, T_host, seg, strikes, 1.0),
                         device=gpu)
    kmaxes = [poisson_kmax(*GLOBAL_EXACT_MKT[3:6], d, GLOBAL_EXACT_MKT[1])
              for d in qk.segment_dts(T_host, seg)]
    t4 = torch.as_tensor(qk.sobol_table(5, 4 * sum(seg)), device=gpu)
    run = (p4, t4, seg, kmaxes, len(strikes), pairs, 5, 0, 0)
    torch.testing.assert_close(ek._exact_surface_sums(*run).cpu(),
                               ek.heston_exact_mixing_surface_sums_plain(*run).cpu(),
                               rtol=1e-6 * segs / 4, atol=0.0)


@pytest.mark.parametrize("segs", [160, 300])
def test_exact_kernels_past_the_staging_decision_match_twins(gpu, segs):
    """K2 and K3 at 160 and 300 QMC segments against their twins: past
    ~113 segments they read the table from global memory, where staging it
    would leave one block an SM; at 160 the table and each warp's high
    words (the split draw) fit a block, at 300 the table alone (145 KiB)."""
    pairs = WIDE_PAIRS
    params, table, kmax = ek._inputs(*GLOBAL_EXACT_MKT, 20.0 / 480, 100.0, 1.0, segs, 5, True,
                                     gpu)
    assert 4 * table.numel() < _optin_bytes(gpu)
    _chain_close(ek._exact_values(params, table, pairs, segs, True, kmax, 5, 0, 0),
                 ek.heston_exact_mixing_values_plain(params, table, pairs, segs, True, kmax, 5, 0,
                                                     0), segs, 2)
    _sums_close(ek._exact_price_sum(params, table, pairs, segs, kmax, 5, 0, 0).reshape(1),
                ek.heston_exact_mixing_price_sum_plain(params, table, pairs, segs, kmax, 5, 0,
                                                       0).reshape(1), 1e-6 * segs / 2)


def test_surface_kernels_past_the_staging_limit_match_twins(gpu):
    """K9 and K12 on the 3 × 5 grid at 600 QMC steps (the table in global
    memory) against their twins; K12's surface column equal to K9's sums
    to the bit."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    qe_seg, m, pairs = (200, 200, 200), len(SURF_K), WIDE_PAIRS
    assert not qk.surface_staged(3, 2 * sum(qe_seg))
    assert not qk.surface_staged(3, 2 * sum(qe_seg), jac=True)
    params = torch.as_tensor(qk._surf_params(*MKT, SURF_T, qe_seg, SURF_K, 1.0), device=gpu)
    dct, djt = (torch.as_tensor(t, dtype=torch.float32, device=gpu)
                for t in gk._surface_greek_tables(*MKT[3:6], SURF_T, qe_seg))
    table = torch.as_tensor(qk.sobol_table(5, 2 * sum(qe_seg)), device=gpu)
    run = (table, qe_seg, m, pairs, 5, 0, 0)
    rtol = max(1e-5, 1e-6 * sum(qe_seg) / 32)
    s9 = qk._qe_surface_sums(params, *run)
    torch.testing.assert_close(s9.cpu(), qk.heston_qe_mixing_surface_sums_plain(params, *run).cpu(),
                               rtol=rtol, atol=0.0)
    s12 = gk._surface_jac_sums(params, dct, djt, *run)
    assert torch.equal(s12.reshape(-1, 7)[:, 0], s9)
    _sums_close(s12, gk.heston_qe_mixing_surface_jac_sums_plain(params, dct, djt, *run), rtol)


# K12's float64 sums on the 3 x 5 QE-32 surface at 2^20 pairs, seed 5, at
# the grid before its redesign (K9_PARENT_BLOCKS an SM): the sha256 of the
# kernel before the redesign (chip_smoke.py --digest "K12 QMC sums" / "K12
# PRNG sums" of the parent tree, an H100)
K12_PARENT_DIGESTS = {
    True: "679a6133152192aaa9c1a36676f6c99a7196cfe19bb0df7ccff55712c2167621",
    False: "d637c91c5cbf3477c4a40ccf7fac2a659f21f5aaef362e67e6a8126c5ffdde4b",
}


@pytest.mark.parametrize("qmc", [True, False])
def test_surface_jacobian_kernel_keeps_its_columns_bits(gpu, qmc):
    """K12 on K9's draw and the close split at the strike: at the earlier
    grid its seven columns of every point sum to the bits of the kernel
    before the redesign (its stored digest)."""
    import hashlib

    from hedgehog_tpu_torch.methods.heston_surface import surface_seg_steps
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    ref = dt.date(2024, 1, 1)
    T_host = [float(ht.yearfrac(ref, e)) for e in
              (dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2026, 1, 1))]
    qe_seg = tuple(surface_seg_steps(T_host, 32)[1])
    strikes = (85.0, 95.0, 100.0, 105.0, 120.0)
    params = torch.as_tensor(qk._surf_params(*MKT, T_host, qe_seg, strikes, 1.0), device=gpu)
    dct, djt = (torch.as_tensor(t, dtype=torch.float32, device=gpu)
                for t in gk._surface_greek_tables(*MKT[3:6], T_host, qe_seg))
    table = torch.as_tensor(qk.sobol_table(5, 2 * sum(qe_seg)), device=gpu) if qmc else None
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    sums = gk._surface_jac_sums(params, dct, djt, table, qe_seg, len(strikes), 2**20, 5, 0, 0,
                                grid=K9_PARENT_BLOCKS * sms)
    digest = hashlib.sha256(sums.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    assert digest == K12_PARENT_DIGESTS[qmc]


@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_kernels_past_256_steps_match_twins(gpu, qmc):
    """K14-K18 at 257 steps (once stopped at 256: the Sobol' table is read
    from global memory and the xi columns kept in a global slab) against
    their twins; K16's price equal to K15's."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    n, pairs = 257, WIDE_PAIRS
    cfg = ht.SimulationConfig(pairs, n, ht.Antithetic(), 5, qmc)
    tr = rk._rb_trace_inputs(_rb_problem(), cfg, 64)
    inp = rk.rb_inputs_from_trace(tr, seed=5, qmc=qmc, device=gpu)
    g_inp = rk.rb_inputs_from_trace(rk._rb_greek_trace_inputs(_rb_problem(), cfg, 64), seed=5,
                                    qmc=qmc, device=gpu, hurst=0.08)
    _chain_close(rk._rb_values(inp, pairs, True, 5, 0, 0),
                 rk.rbergomi_mixing_values_plain(inp, pairs, True, 5, 0, 0), n, RB_STEPS,
                 rtol=1e-3, share=0.998)
    price = rk._rb_price_sum(inp, pairs, 5, 0, 0)
    _sums_close(price.reshape(1), rk.rbergomi_mixing_price_sum_plain(inp, pairs, 5, 0,
                                                                     0).reshape(1))
    greeks = rk._rb_greek_sums(g_inp, pairs, 5, 0, 0)
    assert float(greeks[0]) == float(rk._rb_price_sum(g_inp, pairs, 5, 0, 0))
    _sums_close(greeks, rk.rbergomi_mixing_greek_sums_plain(g_inp, pairs, 5, 0, 0))
    ct = 0.5 + 0.5 * torch.sin(torch.arange(2 * pairs, device=gpu, dtype=torch.float32)).reshape(
        2, pairs)
    _sums_close(rk._rb_vjp_sums(g_inp, ct, pairs, True, 5, 0, 0),
                rk.rbergomi_mixing_vjp_sums_plain(g_inp, ct, pairs, True, 5, 0, 0))
    c_inp = rk.rb_vjp_inputs(100.0, ((0.25, 0.5, 1.0), (0.035, 0.04, 0.045)), 1.9, 0.08, -0.9,
                             0.03, tr.T, 100.0, 1.0, steps=n, seed=5, qmc=qmc, device=gpu)
    _sums_close(rk._rb_vjp_sums(c_inp, ct, pairs, True, 5, 0, 0, per_step=True),
                rk.rbergomi_mixing_vjp_curve_sums_plain(c_inp, ct, pairs, True, 5, 0, 0))


@pytest.mark.parametrize("qmc", [True, False])
def test_rbergomi_smile_past_64_strikes_equals_the_price_kernel(gpu, qmc):
    """K19 at 65 strikes (two launches of 64 and 1 on the same pairs and
    grid): each strike, the 64th and 65th at the chunk edge included, equal
    to K15's price at that strike to the bit; the sums against the twin."""
    from hedgehog_tpu_torch.ops import rbergomi_kernel as rk

    pairs, strikes = WIDE_PAIRS, [60.0 + 1.25 * k for k in range(65)]
    tr = rk._rb_trace_inputs(_rb_problem(), ht.SimulationConfig(pairs, RB_STEPS, ht.Antithetic(),
                                                                5, qmc), 64)
    inp = rk.rb_inputs_from_trace(tr, seed=5, qmc=qmc, device=gpu)
    ks = rk.smile_strikes(tr.f_base, strikes, gpu)
    before = rk.RB_SMILE_KERNEL.launches
    smile = rk._rb_smile_sums(inp, ks, pairs, 5, 0, 0)
    assert rk.RB_SMILE_KERNEL.launches == before + 2 and smile.shape == (65,)
    for k in (0, 63, 64):
        one = rk.rb_inputs_from_trace(
            tr._replace(strike=strikes[k], log_f_over_k=math.log(tr.f_base / strikes[k])), seed=5,
            qmc=qmc, device=gpu)
        assert float(smile[k]) == float(rk._rb_price_sum(one, pairs, 5, 0, 0)), k
    torch.testing.assert_close(smile.cpu(),
                               rk.rbergomi_mixing_smile_sums_plain(inp, ks, pairs, 5, 0, 0).cpu(),
                               rtol=1e-5, atol=0.0)


# ---- K3 two threads a pair; K10 one wave of K8's grid ---------------------------
#
# The serving kernels on chip_smoke.py's market (2^20 pairs, seed 5; QE 11
# steps, exact 2 segments).  K3_PARENT_BLOCKS: the one-pair-a-thread K3's
# resident blocks an SM (127 registers, 256 threads); K8_BLOCKS: K8's (79
# registers), whose one wave is K8's and K10's grid.  The digests are the
# sha256 of the float64 sums of the kernels before their redesign at those
# grids (chip_smoke.py --digest, "K3 ... sums" and "K10 ... sums").

K3_PARENT_BLOCKS = 2
K8_BLOCKS = 3
K3_PARENT_DIGESTS = {
    True: "67d9e42627e04a7115122cf9343f5b32ffb1cdf51feac30970eb58e555245b62",
    False: "988ffe84eeb711fec616a675940b9964c7931b9da67c81abbdcfa13890a3bbd4",
}
K10_PARENT_DIGESTS = {
    True: "f6ea45fcdcc5a04a93ea3334e1f5c085f5249d7a708b7cad47123018088e0c5f",
    False: "2f7516876a7959152c252e554e9770492e02c22b645a3611a6081f626b991cf2",
}
SERVE_PAIRS = 2**20


def _sha256(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _qe_serving_inputs(gpu, qmc):
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    dt_ = T / QE_STEPS
    params, table = qk.mix_inputs(*MKT, dt_, 100.0, 1.0, QE_STEPS, 5, qmc, gpu)
    dtab = torch.as_tensor(gk._greek_table(*MKT[1:2], *MKT[3:6], dt_, QE_STEPS, 4), device=gpu)
    return params, dtab, table


@pytest.mark.parametrize("qmc", [True, False])
def test_exact_price_kernel_at_the_earlier_grid_keeps_its_bits(gpu, qmc):
    """K3 two threads a pair, at the one-pair-a-thread kernel's grid, sums
    every pair's value + antithetic value in that kernel's order: its sum
    equals that kernel's stored digest."""
    px, tx, kmax = ek._inputs(*MKT, T / 2, 100.0, 1.0, 2, 5, qmc, gpu)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    before = ek.EXACT_PRICE_KERNEL.launches
    sums = ek._exact_price_sum(px, tx, SERVE_PAIRS, 2, kmax, 5, 0, 0, grid=K3_PARENT_BLOCKS * sms)
    assert ek.EXACT_PRICE_KERNEL.launches == before + 1
    assert _sha256(sums) == K3_PARENT_DIGESTS[qmc]


@pytest.mark.parametrize("qmc", [True, False])
def test_exact_price_kernel_at_its_grid_matches_the_values_mean(gpu, qmc):
    """K3 at its default grid (one resident wave of it) against K2's mean
    over the same points within chip_smoke's PRICE_RTOL (1e-6)."""
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    occ = ek.price_occupancy(gpu)
    assert ek.price_grid(gpu) == occ["blocks_per_sm"] * sms and occ["threads"] == 512
    values = ek.heston_exact_mixing_values(*MKT, T / 2, 100.0, 1.0, n_paths=SERVE_PAIRS,
                                           segments=2, seed=5, antithetic=True, qmc=qmc,
                                           device=gpu)
    price = ek.heston_exact_mixing_vanilla_price(*MKT, T / 2, 100.0, 1.0, n_blocks=8,
                                                 n_batches=4, segments=2, seed=5, qmc=qmc,
                                                 device=gpu)
    assert float(price) == pytest.approx(float(values.double().mean()), rel=1e-6)


@pytest.mark.parametrize("qmc", [True, False])
def test_greek_kernel_price_equals_the_price_kernel(gpu, qmc):
    """K10's price column equal to K8's sum to the bit at their grid; at
    K8_BLOCKS an SM (that grid on an H100) K10's seven sums equal the stored
    digest of the kernel before its redesign."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    params, dtab, table = _qe_serving_inputs(gpu, qmc)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    price = qk._qe_price_sum(params, table, SERVE_PAIRS, QE_STEPS, 5, 0, 0)
    sums = gk._greek_sums(params, dtab, table, SERVE_PAIRS, QE_STEPS, 5, 0, 0)
    assert bool(torch.isfinite(sums).all()) and float(sums[0]) == float(price)
    sums = gk._greek_sums(params, dtab, table, SERVE_PAIRS, QE_STEPS, 5, 0, 0,
                          grid=K8_BLOCKS * sms)
    assert _sha256(sums) == K10_PARENT_DIGESTS[qmc]


@pytest.mark.parametrize("qmc", [True, False])
def test_greek_kernel_holds_one_resident_wave_of_its_grid(gpu, qmc):
    """K10's resident blocks an SM (the runtime's occupancy at its shared
    memory) times the SMs is its grid, K8's: one wave, no tail."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    _, _, table = _qe_serving_inputs(gpu, qmc)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    occ = gk.greeks_occupancy(QE_STEPS, qmc, gpu)
    assert qk.price_grid(gpu, table) == occ["blocks_per_sm"] * sms


# ---- K8 one body per stream; K6 at 5 blocks an SM; the short rcp and sqrt forms -----
#
# K8_PARENT_DIGESTS: the sha256 of K8's float64 sum at K8_BLOCKS an SM (its
# grid then and now) of the kernel before its per-stream build (chip_smoke.py
# --digest, "K8 ... sums").  K6_PARENT_BLOCKS: the one-pair-a-thread K6's
# resident blocks an SM (62 registers, 256 threads); K6_PARENT_DIGEST its sum
# at that grid ("K6 PRNG sums").  Both on chip_smoke.py's market, 2^20 pairs,
# seed 5 (QE mixing 11 steps, QE-M 10).

K6_PARENT_BLOCKS = 4
QEM_STEPS = 10
K8_PARENT_DIGESTS = {
    True: "ec07be1c322ab9e364d3815a334386dd936ce0e199dc1e693bd68c6701d35cc6",
    False: "70b11442927d24311ea62d2f2ab0aa4c21b9768150529e775ca1a529c5249e30",
}
K6_PARENT_DIGEST = "a2c81b2d0089352f6b9a1b1b75b86161fb45b585cc489e84b58b21c7e8e842f1"


def _qem_price_params(gpu, steps=QEM_STEPS, strike=100.0):
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    return torch.as_tensor(qk._qem_params(*MKT, T / steps, strike=strike), device=gpu)


@pytest.mark.parametrize("qmc", [True, False])
def test_price_kernel_keeps_its_bits_at_its_grid(gpu, qmc):
    """K8 compiled once per stream, on the split Sobol' draw, at its grid
    (K8_BLOCKS an SM, as before) sums every pair in the earlier kernel's
    order: its sum equals that kernel's stored digest, and its default grid
    is that grid."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    params, _, table = _qe_serving_inputs(gpu, qmc)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    before = qk.QE_PRICE_KERNEL.launches
    sums = qk._qe_price_sum(params, table, SERVE_PAIRS, QE_STEPS, 5, 0, 0, grid=K8_BLOCKS * sms)
    assert qk.QE_PRICE_KERNEL.launches == before + 1
    assert _sha256(sums) == K8_PARENT_DIGESTS[qmc]
    assert float(qk._qe_price_sum(params, table, SERVE_PAIRS, QE_STEPS, 5, 0, 0)) == float(sums)


@pytest.mark.parametrize("qmc", [True, False])
def test_price_kernel_holds_one_resident_wave_of_its_grid(gpu, qmc):
    """K8's grid is K8_BLOCKS an SM, and K8 holds at least that many blocks
    an SM (the runtime's occupancy at its shared memory): one wave."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    _, _, table = _qe_serving_inputs(gpu, qmc)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    occ = qk.price_occupancy(QE_STEPS, qmc, gpu)
    assert qk.price_grid(gpu, table) == K8_BLOCKS * sms
    assert occ["blocks_per_sm"] >= K8_BLOCKS


@pytest.mark.parametrize("steps", [250, 700])
def test_price_grid_is_one_wave_of_both_price_kernels_at_many_qmc_steps(gpu, steps):
    """Where K8's staged table and high words hold fewer blocks an SM than
    its table alone (250 QMC steps on an H100), or pass the staging limit
    where the table alone would not (700), the grid follows K8's launch:
    min(K8_BLOCKS, K8's blocks an SM) times the SMs, one wave of K8 and of
    K10, and K10's price still equals K8's."""
    from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    dt_ = T / steps
    params, table = qk.mix_inputs(*MKT, dt_, 100.0, 1.0, steps, 5, True, gpu)
    dtab = torch.as_tensor(gk._greek_table(*MKT[1:2], *MKT[3:6], dt_, steps, 4), device=gpu)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    occ8 = qk.price_occupancy(steps, True, gpu)
    occ10 = gk.greeks_occupancy(steps, True, gpu)
    grid = qk.price_grid(gpu, table)
    assert grid == min(K8_BLOCKS, occ8["blocks_per_sm"]) * sms
    assert occ8["blocks_per_sm"] * sms >= grid and occ10["blocks_per_sm"] * sms >= grid
    price = qk._qe_price_sum(params, table, 2**14, steps, 5, 0, 0)
    sums = gk._greek_sums(params, dtab, table, 2**14, steps, 5, 0, 0)
    assert bool(torch.isfinite(sums).all()) and float(sums[0]) == float(price)


def test_call_price_kernel_at_the_earlier_grid_keeps_its_bits(gpu):
    """K6 at 5 blocks an SM on the short rcp and sqrt forms, at the grid of
    the kernel before it (K6_PARENT_BLOCKS an SM), sums every pair's two
    payoffs in that kernel's order: its sum equals that kernel's stored
    digest."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    before = qk.QEM_PRICE_KERNEL.launches
    sums = qk._qem_price_sum(_qem_price_params(gpu), SERVE_PAIRS, QEM_STEPS, 5, 0,
                             grid=K6_PARENT_BLOCKS * sms)
    assert qk.QEM_PRICE_KERNEL.launches == before + 1
    assert _sha256(sums) == K6_PARENT_DIGEST


@pytest.mark.parametrize("steps", [QEM_STEPS, 7, 1])
def test_call_price_kernel_at_its_grid_matches_the_terminal_payoff_mean(gpu, steps):
    """K6 at its default grid (one resident wave of it) against the mean of
    K5's call payoffs over the same pairs within chip_smoke's PRICE_RTOL
    (1e-6), at the serving step count and at odd ones."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    occ = qk.qem_price_occupancy(gpu)
    assert qk.qem_price_grid(gpu) == occ["blocks_per_sm"] * sms and occ["threads"] == 256
    got = qk.heston_qe_terminal(*MKT, T / steps, n_paths=SERVE_PAIRS, steps=steps, seed=5,
                                antithetic=True, device=gpu)
    pay = torch.clamp(got - 100.0, min=0.0)
    price = qk.heston_qe_call_price(*MKT, T / steps, 100.0, 1.0, n_blocks=8, n_batches=4,
                                    steps=steps, seed=5, device=gpu)
    want = float((pay[0] + pay[1]).double().sum()) / (2 * SERVE_PAIRS)
    assert float(price) == pytest.approx(want, rel=1e-6)


def test_broadie_kaya_on_the_card_matches_the_cpu_on_one_stream(gpu):
    """Broadie-Kaya (no kernel; float64 and complex128 on the card): per
    pair V_T, ∫V and the terminal prices equal the CPU's on the same Philox
    stream within 1e-9 relative, and ``solve`` runs on the card."""
    from hedgehog_tpu_torch.distributions import broadie_kaya as bk

    market = ht.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2025, 1, 1), ht.European(),
                                              ht.Call(), ht.Spot()), market)
    strat = ht.HestonBroadieKaya(cf_terms=64)
    cfg = ht.SimulationConfig(2**12, 1, ht.Antithetic(), 3)
    card = bk.broadie_kaya_paths(prob, cfg, strat, device=gpu)
    cpu = bk.broadie_kaya_paths(prob, cfg, strat, device="cpu")
    for got, want in zip(card, cpu):
        assert got.device.type == "cuda"
        rel = (got.cpu() - want).abs() / want.abs().clamp(min=1e-300)
        assert float(rel.max()) <= 1e-9
    sol = ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), strat, cfg, device=gpu))
    assert sol.price.device.type == "cuda" and math.isfinite(float(sol.price))


def test_resolve_quotes_batch_on_the_card_matches_the_cpu(gpu):
    """A 3 × 9 quote grid with gaps under forward observations: every
    resolved level on the card equals the CPU's within 1e-10."""
    import numpy as np

    ref = dt.date(2024, 1, 1)
    expiries = np.array([[float(ht.to_ticks(dt.date(2024, m, 1)))] for m in (4, 7, 12)])
    T = np.array([[float(ht.yearfrac(ref, dt.date(2024, m, 1)))] for m in (4, 7, 12)])
    F = 100.0 * np.exp(0.03 * T)
    K = F * np.exp(np.linspace(-0.3, 0.3, 9))[None, :]
    ivs = 0.2 + 0.1 * np.log(K / F) ** 2
    prices = ht.iv_to_price_bs(torch.from_numpy(ivs), torch.from_numpy(K), torch.from_numpy(T),
                               torch.from_numpy(F * np.exp(-0.03 * T)), 0.03).numpy()
    prices[0, 3] = ivs[1, 2] = float("nan")
    levels = dict(mid_price=prices, mid_iv=np.where(np.isnan(prices), ivs, np.nan),
                  bid_iv=ivs - 0.004, ask_price=prices * 1.01)
    out = {}
    for dev in (gpu, "cpu"):
        cfg = ht.VolQuoteConfig(iv_model=ht.BlackScholesAnalytic(device=dev))
        out[str(dev)] = ht.resolve_quotes_batch(K, expiries, ht.ForwardObs(F), 0.03, ref,
                                                config=cfg, **levels)
    for name in ("bid_price", "mid_price", "ask_price", "bid_iv", "mid_iv", "ask_iv"):
        got, want = getattr(out[str(gpu)], name), getattr(out["cpu"], name)
        assert got.device.type == "cuda"
        assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert torch.allclose(got.cpu()[keep], want[keep], rtol=1e-10, atol=1e-10)


def test_calibrate_svi_slices_on_the_card_matches_the_cpu(gpu):
    """Three raw-SVI slices fitted on the card and on the CPU: parameters
    within 2e-4 of each other and of the truth, and an SVIVolSurface on the
    card prices through BlackScholesAnalytic with gradients in them."""
    import numpy as np

    tenors = np.array([0.25, 0.5, 1.0])
    fwds = 100.0 * np.exp(0.03 * tenors)
    params = np.array([[0.010, 0.10, -0.30, 0.00, 0.20], [0.018, 0.12, -0.35, 0.02, 0.25],
                       [0.032, 0.14, -0.40, 0.05, 0.30]])
    k = np.linspace(-0.35, 0.35, 15)
    w = np.stack([ht.svi_total_variance(tuple(torch.from_numpy(p)), torch.from_numpy(k)).numpy()
                  for p in params])
    strikes, ivs = fwds[:, None] * np.exp(k)[None, :], np.sqrt(w / tenors[:, None])
    card = ht.calibrate_svi_slices(tenors, fwds, strikes, ivs, device=gpu)
    cpu = ht.calibrate_svi_slices(tenors, fwds, strikes, ivs, device="cpu")
    assert card[0].device.type == "cuda" and bool(card[2].all())
    assert float((card[0].cpu() - cpu[0]).abs().max()) <= 2e-4
    assert float((card[0].cpu() - torch.from_numpy(params)).abs().max()) <= 2e-4
    p = card[0].clone().requires_grad_(True)
    surf = ht.SVIVolSurface(dt.date(2024, 1, 1), tenors, p, fwds, device=gpu)
    mkt = ht.BlackScholesInputs(dt.date(2024, 1, 1), 0.03, 100.0, surf)
    opt = ht.VanillaOption(105.0, dt.date(2024, 7, 1), ht.European(), ht.Call(), ht.Spot())
    price = ht.solve(ht.PricingProblem(opt, mkt), ht.BlackScholesAnalytic(device=gpu)).price
    (g,) = torch.autograd.grad(price, p)
    assert g.device.type == "cuda" and bool(torch.isfinite(g).all()) and float(g[2].abs().max()) == 0


DIV_REF, DIV_EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)


def _dividend_market():
    divs = ht.DividendSchedule([dt.date(2024, 4, 1), dt.date(2024, 10, 1)], [2.0, 2.0])
    return ht.BlackScholesInputs(DIV_REF, 0.03, 100.0, 0.2, dividends=divs)


def test_k13_draws_the_escrowed_law_on_a_dividend_market(gpu):
    """``BlackScholesExact(use_kernel=True)`` on a dividend market launches
    K13 once with the escrowed (mean, std), and its draws match the twin's
    on the CPU from the same (mean, std)."""
    from hedgehog_tpu_torch.models.dynamics import lognormal_terminal_law
    from hedgehog_tpu_torch.ops import gbm_kernel as gk

    prob = ht.PricingProblem(ht.VanillaOption(100.0, DIV_EXPIRY), _dividend_market())
    cfg = ht.SimulationConfig(PAIRS, 1, ht.Antithetic(), 9)
    before = gk.GBM_KERNEL.launches
    card = ht.simulate_terminal_prices(prob, ht.MonteCarlo(
        ht.LognormalDynamics(), ht.BlackScholesExact(use_kernel=True), cfg, device=gpu))
    torch.cuda.synchronize()
    assert gk.GBM_KERNEL.launches == before + 1
    mean, std = lognormal_terminal_law(prob.market_inputs, prob.payoff.expiry)
    twin = gk.gbm_exact_terminal(float(mean), float(std), n_paths=PAIRS, seed=9, antithetic=True,
                                 device="cpu")
    _assert_values_close(card.float(), twin.to(gpu))


def test_barrier_lattices_on_the_card_match_the_cpu(gpu):
    """The knock-out, the American knock-in quadrature, the European
    knock-in parity and the dividend lattice, card against CPU to 1e-12."""
    market = ht.BlackScholesInputs(DIV_REF, 0.05, 100.0, 0.25)
    cases = [(ht.BarrierOption(110.0, DIV_EXPIRY, 80.0, ht.American(), ht.Put()), market),
             (ht.BarrierOption(110.0, DIV_EXPIRY, 85.0, ht.American(), ht.Put(),
                               knock=ht.KnockIn(), rebate=2.0), market),
             (ht.BarrierOption(100.0, DIV_EXPIRY, 120.0, direction=ht.Up(), knock=ht.KnockIn()),
              market),
             (ht.VanillaOption(100.0, DIV_EXPIRY, ht.American()), _dividend_market())]
    for payoff, mkt in cases:
        prob = ht.PricingProblem(payoff, mkt)
        card = ht.solve(prob, ht.CoxRossRubinsteinMethod(300, device=gpu)).price
        cpu = ht.solve(prob, ht.CoxRossRubinsteinMethod(300, device="cpu")).price
        assert card.device.type == "cuda"
        assert float(card) == pytest.approx(float(cpu), rel=1e-12)


def test_pde_on_the_card_matches_the_cpu(gpu):
    """The American put, an American knock-out and a dividend call on the
    PDE, card against CPU to 1e-10."""
    market = ht.BlackScholesInputs(DIV_REF, 0.05, 100.0, 0.2)
    cases = [(ht.VanillaOption(110.0, DIV_EXPIRY, ht.American(), ht.Put()), market),
             (ht.BarrierOption(100.0, DIV_EXPIRY, 80.0, ht.American(), ht.Put()), market),
             (ht.VanillaOption(100.0, DIV_EXPIRY, ht.American()), _dividend_market())]
    for payoff, mkt in cases:
        prob = ht.PricingProblem(payoff, mkt)
        card = ht.solve(prob, ht.PDEMethod(space_steps=200, time_steps=100, device=gpu))
        cpu = ht.solve(prob, ht.PDEMethod(space_steps=200, time_steps=100, device="cpu"))
        assert card.price.device.type == "cuda"
        assert float(card.price) == pytest.approx(float(cpu.price), rel=1e-10)
        assert torch.allclose(card.grid_values.cpu(), cpu.grid_values, rtol=1e-10, atol=1e-10)


def test_barrier_lsm_on_the_card_matches_the_cpu(gpu):
    """A GBM knock-out on a dividend market and a Heston knock-in on QMC
    grids: the stopping steps equal and the price within 1e-10."""
    heston = ht.HestonInputs(DIV_REF, 0.05, 100.0, 0.0625, 2.0, 0.0625, 0.4, -0.6)
    cfg = ht.SimulationConfig(1024, 16, ht.Antithetic(), 0, True)
    cases = [(ht.BarrierOption(110.0, DIV_EXPIRY, 80.0, ht.American(), ht.Put()),
              _dividend_market(), ht.LognormalDynamics(), ht.EulerMaruyama(), 4),
             (ht.BarrierOption(110.0, DIV_EXPIRY, 85.0, ht.American(), ht.Put(),
                               knock=ht.KnockIn(), rebate=2.0),
              heston, ht.HestonDynamics(), ht.HestonQE(conditional=True), 3)]
    for payoff, mkt, dyn, strat, degree in cases:
        prob = ht.PricingProblem(payoff, mkt)
        sols = [ht.solve(prob, ht.LSM(ht.MonteCarlo(dyn, strat, cfg, device=d), degree))
                for d in (gpu, "cpu")]
        assert sols[0].price.device.type == "cuda"
        assert torch.equal(sols[0].stopping_info[0].cpu(), sols[1].stopping_info[0])
        assert float(sols[0].price) == pytest.approx(float(sols[1].price), rel=1e-10)


NL_REF, NL_EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)


def test_normal_and_cev_families_on_the_card_match_the_cpu(gpu):
    """The Bachelier, CEV (its incomplete gamma's loops and β-gradient) and
    SABR closed forms to 1e-12, and their Euler grids on 1024 PRNG pairs
    per path to 1e-10."""
    beta = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    markets = {"bach": ht.BachelierInputs(NL_REF, 0.05, 100.0, 20.0),
               "cev": ht.CEVInputs(NL_REF, 0.05, 100.0, 2.0, beta, dividend_yield=0.01),
               "sabr": ht.SABRInputs(NL_REF, 0.03, 100.0, 0.2, 0.7, -0.3, 0.4)}
    strikes = torch.linspace(60.0, 140.0, 9, dtype=torch.float64)
    for key, method, dyn in (("bach", ht.BachelierAnalytic, ht.NormalDynamics()),
                             ("cev", ht.CEVAnalytic, ht.CEVDynamics()),
                             ("sabr", ht.SABRAnalytic, ht.SABRDynamics())):
        prices = [ht.solve(ht.PricingProblem(ht.VanillaOption(strikes.to(d), NL_EXPIRY),
                                             markets[key]), method(device=d)).price
                  for d in (gpu, "cpu")]
        assert prices[0].device.type == "cuda"
        # 1e-12 of each price and of the largest (chip_smoke's compare_vectors):
        # the CEV legs' lgamma-weighted sums round differently on the card
        assert torch.allclose(prices[0].detach().cpu(), prices[1].detach(), rtol=1e-12,
                              atol=1e-12 * float(prices[1].abs().max()))
        grids = [ht.simulate_price_grid(
            ht.PricingProblem(ht.VanillaOption(100.0, NL_EXPIRY), markets[key]),
            ht.MonteCarlo(dyn, ht.EulerMaruyama(), ht.SimulationConfig(1024, 16, ht.Antithetic(),
                                                                        3), device=d))
            for d in (gpu, "cpu")]
        assert torch.allclose(grids[0].detach().cpu(), grids[1].detach(), rtol=1e-10, atol=1e-10)
    grads = [torch.autograd.grad(ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, NL_EXPIRY),
                                                            markets["cev"]),
                                          ht.CEVAnalytic(device=d)).price, beta)[0]
             for d in (gpu, "cpu")]
    assert float(grads[0]) == pytest.approx(float(grads[1]), rel=1e-10)


def test_local_vol_and_slv_on_the_card_match_the_cpu(gpu):
    """Dupire local vol on a cubic surface, the local-vol grid (QMC) and the
    PDE, a leverage calibration and the SLV grid on it, card against CPU to
    1e-10."""
    strikes = torch.tensor([70.0, 85.0, 100.0, 115.0, 130.0], dtype=torch.float64)
    row = torch.clamp(0.25 - 0.10 * torch.log(strikes / 100.0), 0.12, 0.45)
    vols = torch.stack([row, 1.05 * row])
    tenors = torch.tensor([0.5, 1.5], dtype=torch.float64)

    def market(d):
        surf = ht.RectVolSurface(NL_REF, tenors.to(d), strikes.to(d), vols.to(d),
                                 interp_strike="cubic")
        return (ht.BlackScholesInputs(NL_REF, 0.03, 100.0, surf),
                ht.SLVInputs(NL_REF, 0.03, 100.0, 0.0625, 1.5, 0.0625, 0.5, -0.6,
                             sigma_surface=surf))

    t = torch.tensor([0.1, 0.7, 1.2], dtype=torch.float64)[:, None]
    k = torch.tensor([75.0, 100.0, 125.0], dtype=torch.float64)[None, :]
    lvs = [ht.dupire_local_vol(market(d)[0], t.to(d), k.to(d)) for d in (gpu, "cpu")]
    assert lvs[0].device.type == "cuda"
    assert torch.allclose(lvs[0].cpu(), lvs[1], rtol=1e-12, atol=0)
    call = ht.VanillaOption(100.0, NL_EXPIRY)
    cfg = ht.SimulationConfig(1024, 12, ht.Antithetic(), 0, True)
    grids = [ht.simulate_price_grid(ht.PricingProblem(call, market(d)[0]), ht.MonteCarlo(
        ht.LocalVolDynamics(), ht.EulerMaruyama(), cfg, device=d)) for d in (gpu, "cpu")]
    assert torch.allclose(grids[0].cpu(), grids[1], rtol=1e-10, atol=0)
    pdes = [ht.solve(ht.PricingProblem(ht.VanillaOption(110.0, NL_EXPIRY, ht.American(),
                                                        ht.Put()), market(d)[0]),
                     ht.PDEMethod(ht.LocalVolDynamics(), 200, 100, device=d)).price
            for d in (gpu, "cpu")]
    assert float(pdes[0]) == pytest.approx(float(pdes[1]), rel=1e-10)
    levs = [ht.calibrate_leverage(market(d)[1], NL_EXPIRY, steps=12, paths=2048, bins=33,
                                  device=d) for d in (gpu, "cpu")]
    assert torch.allclose(levs[0].values.cpu(), levs[1].values, rtol=1e-10, atol=1e-12)
    grids = [ht.simulate_price_grid(ht.PricingProblem(call, market(d)[1].with_leverage(levs[1])),
                                    ht.MonteCarlo(ht.SLVDynamics(), ht.EulerMaruyama(),
                                                  dataclasses.replace(cfg, qmc=False), device=d))
             for d in (gpu, "cpu")]
    assert torch.allclose(grids[0].cpu(), grids[1], rtol=1e-10, atol=0)


def _hw_market(d, sigma=0.012):
    tenors = torch.tensor([0.5, 1.0, 2.0, 3.0, 5.0], dtype=torch.float64, device=d)
    zeros = torch.tensor([0.02, 0.025, 0.03, 0.032, 0.035], dtype=torch.float64, device=d)
    return ht.HullWhiteInputs(NL_REF, ht.RateCurve(NL_REF, tenors, zeros), 0.1, sigma)


def test_hull_white_and_heston_hull_white_on_the_card_match_the_cpu(gpu):
    """The Hull-White closed forms (Jamshidian's root, its σ-gradient) and the
    Bermudan grid to 1e-12, the exact short-rate Monte Carlo (QMC), the
    Bermudan LSM and the Heston-Hull-White estimator (Philox) per path on
    1024 pairs to 1e-10."""
    swap_dates = [dt.date(2026, 1, 1), dt.date(2027, 1, 1), dt.date(2028, 1, 1)]
    e = dt.date(2025, 1, 1)
    payoffs = [ht.ZeroCouponBond(dt.date(2027, 1, 1)), ht.BondOption(0.92, e, dt.date(2028, 1, 1)),
               ht.Caplet(0.03, e, dt.date(2025, 7, 1), 100.0),
               ht.CapFloor(0.03, [NL_REF, dt.date(2024, 7, 1), e], 100.0),
               ht.Swaption(0.032, e, swap_dates, True, 100.0)]
    berm = ht.Swaption(0.032, e, swap_dates, True, 100.0,
                       ht.Bermudan([dt.date(2026, 1, 1), dt.date(2027, 1, 1)]))
    for payoff in payoffs:
        prices = [ht.solve(ht.PricingProblem(payoff, _hw_market(d)),
                           ht.HullWhiteAnalytic(device=d)).price for d in (gpu, "cpu")]
        assert prices[0].device.type == "cuda"
        assert float(prices[0]) == pytest.approx(float(prices[1]), rel=1e-12)
    grids = [ht.solve(ht.PricingProblem(berm, _hw_market(d)), ht.HullWhiteGrid(device=d)).price
             for d in (gpu, "cpu")]
    assert float(grids[0]) == pytest.approx(float(grids[1]), rel=1e-12)
    vegas = []
    for d in (gpu, "cpu"):
        sig = torch.tensor(0.012, dtype=torch.float64, device=d, requires_grad=True)
        price = ht.solve(ht.PricingProblem(payoffs[-1], _hw_market(d, sig)),
                         ht.HullWhiteAnalytic(device=d)).price
        vegas.append(torch.autograd.grad(price, sig)[0])
    assert float(vegas[0]) == pytest.approx(float(vegas[1]), rel=1e-10)
    cfg = ht.SimulationConfig(1024, 4, ht.Antithetic(), 3, True)
    for payoff, config in ((payoffs[-1], cfg), (berm, dataclasses.replace(cfg, qmc=False))):
        vals = [ht.solve(ht.PricingProblem(payoff, _hw_market(d)),
                         ht.HullWhiteMonteCarlo(config, device=d)).ensemble for d in (gpu, "cpu")]
        assert torch.allclose(vals[0].cpu(), vals[1], rtol=1e-10, atol=1e-12)
    hhw = ht.HestonHullWhiteInputs(NL_REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.6, 0.1, 0.012,
                                   -0.3)
    vals = [ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, NL_EXPIRY), hhw), ht.MonteCarlo(
        ht.HestonHullWhiteDynamics(), ht.HestonQE(conditional=True),
        ht.SimulationConfig(1024, 16, ht.Antithetic(), 3), device=d)).ensemble
        for d in (gpu, "cpu")]
    assert torch.allclose(vals[0].cpu(), vals[1], rtol=1e-10, atol=1e-12)


def test_multi_asset_and_vix_on_the_card_match_the_cpu(gpu):
    """The multi-asset closed forms (Margrabe, Kirk, the geometric basket,
    Stulz) to 1e-12, the correlated Black-Scholes and Heston draws per path
    on 1024 pairs (QMC and Philox) to 1e-10, and VIX futures and options at
    32 nodes x 256 terms to 1e-12."""
    ma = ht.MultiAssetBSInputs(NL_REF, 0.03, [100.0, 95.0], [0.25, 0.2], [[1.0, 0.5], [0.5, 1.0]])
    mh = ht.MultiAssetHestonInputs(NL_REF, 0.03, [100.0, 95.0], [0.04, 0.09], [2.0, 1.5],
                                   [0.04, 0.09], [0.3, 0.4], [-0.6, -0.5], [[1.0, 0.5], [0.5, 1.0]])
    payoffs = [ht.SpreadOption(0.0, NL_EXPIRY), ht.SpreadOption(5.0, NL_EXPIRY),
               ht.BasketOption(95.0, NL_EXPIRY, [0.6, 0.4], geometric=True),
               ht.RainbowOption(100.0, NL_EXPIRY), ht.RainbowOption(100.0, NL_EXPIRY, False,
                                                                  call_put=ht.Put())]
    for payoff in payoffs:
        prices = [ht.solve(ht.PricingProblem(payoff, ma), ht.BlackScholesAnalytic(device=d)).price
                  for d in (gpu, "cpu")]
        assert prices[0].device.type == "cuda"
        assert float(prices[0]) == pytest.approx(float(prices[1]), rel=1e-12)
    basket = ht.BasketOption(97.0, NL_EXPIRY, [0.5, 0.5])
    for market, dyn, strat, steps in ((ma, ht.LognormalDynamics(), ht.BlackScholesExact(), 1),
                                      (mh, ht.HestonDynamics(), ht.HestonQE(conditional=True), 8)):
        for qmc in (False, True):
            cfg = ht.SimulationConfig(1024, steps, ht.Antithetic(), 3, qmc)
            vals = [ht.solve(ht.PricingProblem(basket, market),
                             ht.MonteCarlo(dyn, strat, cfg, device=d)).ensemble
                    for d in (gpu, "cpu")]
            assert torch.allclose(vals[0].cpu(), vals[1], rtol=1e-10, atol=1e-12)
    ref, expiry = dt.date(2025, 1, 1), dt.date(2025, 7, 1)
    for market in (ht.HestonInputs(ref, 0.03, 100.0, 0.04, 2.0, 0.05, 0.6, -0.7),
                   ht.BatesInputs(ref, 0.03, 100.0, 0.04, 2.0, 0.05, 0.6, -0.7, 0.3, -0.1, 0.15)):
        for payoff in (ht.VIXFuture(expiry), ht.VIXOption(20.0, expiry),
                       ht.VIXOption(20.0, expiry, call_put=ht.Put())):
            prices = [ht.solve(ht.PricingProblem(payoff, market),
                               ht.VIXAnalytic(nodes=32, terms=256, device=d)).price
                      for d in (gpu, "cpu")]
            assert float(prices[0]) == pytest.approx(float(prices[1]), rel=1e-12)


@pytest.mark.parametrize("kernel", ["K2", "K7"])
def test_kernel_slices_compose_over_disjoint_offsets(gpu, kernel):
    """4 disjoint point_offset slices of one Sobol' sequence through K2 (2
    segments) or K7 (11 steps), concatenated, are the full-range call bit
    for bit: why a QMC sharded price equals the single-device one."""
    from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

    if kernel == "K2":
        kern, fn, kw = ek.EXACT_VALUES_KERNEL, ek.heston_exact_mixing_values, dict(segments=2)
        args = (*MKT, T / 2, 100.0, 1.0)
    else:
        kern, fn, kw = qk.QE_VALUES_KERNEL, qk.heston_qe_mixing_values, dict(steps=QE_STEPS)
        args = (*MKT, T / QE_STEPS, 100.0, 1.0)
    per = PAIRS // 4
    kw.update(seed=5, antithetic=True, qmc=True, device=gpu)
    before = kern.launches
    full = fn(*args, n_paths=PAIRS, **kw)
    parts = [fn(*args, n_paths=per, point_offset=i * per, **kw) for i in range(4)]
    assert kern.launches == before + 5
    assert torch.equal(torch.cat(parts, dim=-1), full)


def test_nccl_world_of_one_sharded_flagship_equals_solve(gpu, tmp_path):
    """An nccl process group of one rank: the sharded exact flagship through
    K2 equals ``solve`` (float64 sums in another order)."""
    import datetime

    import torch.distributed as dist

    from hedgehog_tpu_torch.parallel import make_paths_mesh, sharded_mc_price

    prob = ht.PricingProblem(
        ht.VanillaOption(100.0, dt.date(2025, 1, 1)),
        ht.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7))
    method = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonExactMixing(True),
                           ht.SimulationConfig(PAIRS, 2, ht.Antithetic(), 0, True), device="cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        before = ek.EXACT_VALUES_KERNEL.launches
        price = float(sharded_mc_price(prob, method, make_paths_mesh()))
        assert ek.EXACT_VALUES_KERNEL.launches == before + 1
    finally:
        dist.destroy_process_group()
    assert price == pytest.approx(float(ht.solve(prob, method).price), rel=1e-9)
