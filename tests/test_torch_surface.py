"""The port's float64 (expiry × strike) surface against the JAX package's
``heston_surface_mc``: the step allocation and expiry checks, the surface
per point under QMC (the same Sobol' points), its Jacobian against
``jax.jacfwd``, the one-expiry surface against the port's ``solve`` on the
PRNG stream, and the exact surface's refusal to differentiate."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import heston_surface as ps

REF = dt.date(2024, 1, 1)
R, SPOT = 0.03, 100.0
H = (0.04, 2.0, 0.04, 0.3, -0.7)  # V0, κ, θ, σ, ρ
EXPIRIES = [dt.date(2024, 7, 1), dt.date(2025, 1, 1)]
STRIKES = [90.0, 100.0, 110.0]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module runs many small ops on tensors of 2^11-2^16 elements,
    where intra-op threads cost more than they give and, under several test
    workers, oversubscribe the cores: one thread while it runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _markets(**over):
    kw = dict(reference_date=REF, rate=R, spot=SPOT, V0=H[0], kappa=H[1], theta=H[2],
              sigma=H[3], rho=H[4])
    kw.update(over)
    return hh.HestonInputs(**kw), ht.HestonInputs(**kw)


GRIDS = [
    [0.5, 1.0],
    [0.25, 0.5, 1.0, 2.0],
    [0.1, 3.0],
    [1.0],
    [0.08, 0.09, 0.5],
]


@pytest.mark.parametrize("steps", [1, 4, 7, 32])
@pytest.mark.parametrize("min_first", [1, 2])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"grid{i}" for i in range(len(GRIDS))])
def test_seg_steps_match_reference(grid, min_first, steps):
    assert ps.surface_seg_steps(grid, steps, min_first) == jmc.surface_seg_steps(grid, steps,
                                                                                min_first)


@pytest.mark.parametrize("expiries", [
    [dt.date(2024, 7, 1), dt.date(2025, 1, 1), dt.date(2026, 1, 1)],
    [dt.date(2024, 1, 2)],
    [dt.date(2025, 1, 1), dt.date(2024, 7, 1)],
    [dt.date(2024, 7, 1), dt.date(2024, 7, 1)],
    [dt.date(2023, 12, 1), dt.date(2024, 7, 1)],
    [dt.date(2024, 1, 1)],
    [],
], ids=["increasing", "one-day", "decreasing", "repeated", "before-ref", "at-ref", "empty"])
def test_validate_expiries_matches_reference(expiries):
    jm, tm = _markets()
    try:
        want = jmc.validate_surface_expiries(jm, expiries)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            ps.validate_surface_expiries(tm, expiries)
        assert str(got.value) == str(exc)
        return
    assert ps.validate_surface_expiries(tm, expiries) == want


@pytest.mark.parametrize("exact", [False, True], ids=["qe", "exact"])
def test_qmc_surface_matches_reference_per_point(exact):
    """The same Sobol' points through the same float64 arithmetic: every
    point within rel 1e-10 (2^13 pairs; QE 8 steps, exact 3 segments)."""
    jm, tm = _markets()
    cfg = hh.SimulationConfig(2**13, 3 if exact else 8, hh.Antithetic(), 9, True)
    want = np.asarray(hh.heston_surface_mc(jm, EXPIRIES, jnp.asarray(STRIKES), cfg,
                                           strategy=hh.HestonExactMixing() if exact else None))
    got = ht.heston_surface_mc(tm, EXPIRIES, STRIKES, ht.from_reference(cfg),
                               strategy=ht.HestonExactMixing() if exact else None, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0.0)


def test_puts_and_point_offset_match_reference():
    jm, tm = _markets()
    cfg = hh.SimulationConfig(2**11, 6, hh.Antithetic(), 4, True)
    want = np.asarray(hh.heston_surface_mc(jm, EXPIRIES, jnp.asarray(STRIKES), cfg, cp=-1.0,
                                           point_offset=2**11))
    got = ht.heston_surface_mc(tm, EXPIRIES, STRIKES, ht.from_reference(cfg), cp=-1.0,
                               point_offset=2**11, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0.0)


def test_surface_jacobian_matches_reference_jacfwd():
    """torch.autograd.grad of each point in (spot, V0, κ, θ, σ, ρ, rate)
    against jax.jacfwd of the JAX QMC surface: the same float64 chain rule,
    rel 1e-8 (abs 1e-10 of the largest entry for entries near zero)."""
    cfg = hh.SimulationConfig(2**11, 6, hh.Antithetic(), 9, True)
    x0 = np.array([SPOT, *H, R])

    def jax_surface(p):
        spot, v0, kappa, theta, sigma, rho, r = p
        return hh.heston_surface_mc(hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho),
                                    EXPIRIES, jnp.asarray(STRIKES), cfg)

    want = np.asarray(jax.jacfwd(jax_surface)(jnp.asarray(x0)))
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in x0]
    spot, v0, kappa, theta, sigma, rho, r = leaves
    surf = ht.heston_surface_mc(ht.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho),
                                EXPIRIES, STRIKES, ht.from_reference(cfg), device="cpu")
    rows = [torch.stack(torch.autograd.grad(y, leaves, retain_graph=True)) for y in surf.ravel()]
    got = torch.stack(rows).reshape(2, 3, 7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("exact", [False, True], ids=["qe", "exact"])
def test_one_expiry_prng_surface_is_the_solve_price(exact):
    """The step (segment) index runs across segments, so a one-expiry
    surface draws the stream of ``solve`` with the same strategy, seed and
    steps: equal prices to rel 1e-12."""
    _, tm = _markets()
    expiry, strike = dt.date(2025, 1, 1), 105.0
    cfg = ht.SimulationConfig(4096, 2 if exact else 5, ht.Antithetic(), 17, False)
    strat = ht.HestonExactMixing() if exact else ht.HestonQE(conditional=True)
    surf = ht.heston_surface_mc(tm, [expiry], [strike], cfg,
                                strategy=strat if exact else None, device="cpu")
    sol = ht.solve(ht.PricingProblem(ht.VanillaOption(strike, expiry), tm),
                   ht.MonteCarlo(ht.HestonDynamics(), strat, cfg, device="cpu"))
    assert float(surf[0, 0]) == pytest.approx(float(sol.price), rel=1e-12)


def test_multi_expiry_prng_surface_shares_its_paths():
    """Under PRNG each expiry's row is the price of a path set truncated at
    that expiry: the last row is the ``solve`` of all the steps when the
    segments share one dt."""
    _, tm = _markets()
    expiries = [dt.date(2024, 7, 2), dt.date(2025, 1, 1)]  # 183 + 183 days
    cfg = ht.SimulationConfig(2048, 6, ht.Antithetic(), 3, False)
    surf = ht.heston_surface_mc(tm, expiries, [100.0], cfg, device="cpu")
    sol = ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, expiries[-1]), tm),
                   ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True), cfg,
                                 device="cpu"))
    assert float(surf[1, 0]) == pytest.approx(float(sol.price), rel=1e-12)


def test_exact_surface_refuses_gradients():
    """The exact surface no longer refuses a gradient request: it closes
    each point through the likelihood-ratio surrogate, so a market tensor
    that requires grad gets a finite, nonzero gradient (held against JAX's
    in tests/test_torch_exact_greeks.py), and the primal is the detached
    surface to the bit."""
    _, tm = _markets()
    cfg = ht.SimulationConfig(256, 3, ht.Antithetic(), 0, True)
    sigma = torch.tensor(H[3], dtype=torch.float64, requires_grad=True)
    surf_g = ht.heston_surface_mc(dataclasses.replace(tm, sigma=sigma), EXPIRIES, STRIKES, cfg,
                                  strategy=ht.HestonExactMixing(), device="cpu")
    (g_sigma,) = torch.autograd.grad(surf_g.sum(), sigma)
    rate = torch.tensor(R, dtype=torch.float64, requires_grad=True)
    surf_r = ht.heston_surface_mc(ht.HestonInputs(REF, rate, SPOT, *H), EXPIRIES, STRIKES, cfg,
                                  strategy=ht.HestonExactMixing(), device="cpu")
    (g_rate,) = torch.autograd.grad(surf_r.sum(), rate)
    assert bool(torch.isfinite(g_sigma)) and float(g_sigma) != 0.0
    assert bool(torch.isfinite(g_rate)) and float(g_rate) != 0.0
    # without a gradient request the same tensors price the same surface
    surf = ht.heston_surface_mc(dataclasses.replace(tm, sigma=sigma.detach()), EXPIRIES, STRIKES,
                                cfg, strategy=ht.HestonExactMixing(), device="cpu")
    assert bool(torch.isfinite(surf).all())
    assert torch.equal(surf, surf_g.detach())


def test_default_device_is_the_gpu():
    _, tm = _markets()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.heston_surface_mc(tm, EXPIRIES, STRIKES, ht.SimulationConfig(64, 2, ht.Antithetic()))
