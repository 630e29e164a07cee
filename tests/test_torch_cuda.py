"""The CUDA kernels against their plain twins on the card (chip_smoke.py's
phase 2 at small sizes).  Marked ``cuda``: they skip where
``torch.cuda.is_available()`` is False, and run on a GPU host with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerances (fp32 on both sides, same bits): the card contracts a·b + c into
FMAs and its expf/logf/sincosf differ from the twins' by an ulp, so ≥ 99.9%
of values agree within 1e-4 relative (values below 1e-3 absolutely) and the
means within 1e-6; a rare path crosses an fp32 threshold (a Poisson count)."""

import datetime as dt
import math

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


def _assert_values_close(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1e-3)
    assert float((rel <= 1e-4).double().mean()) >= 0.999
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
