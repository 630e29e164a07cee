"""The JAX suite's SLV oracles (tests/unit/test_slv.py:53-175) on the port,
with the port's own calibration (Philox draws): a leverage calibrated by
the particle method reprices the vanilla surface it was built from at
every mixing fraction, within that suite's tolerances; the delta through
calibrate → price agrees with same-seed central differences to 1e-1
relative; the SLV grid feeds the Asian and LSM consumers; and the QMC
stream prices."""

import datetime as dt

import pytest
import torch

import hedgehog_tpu_torch as ht

REF = dt.date(2025, 1, 1)
EXPIRY = dt.date(2026, 1, 1)
CPU = "cpu"
CALL = ht.VanillaOption(100.0, EXPIRY)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat_market(mixing=1.0, sigma_flat=0.2):
    return ht.SLVInputs(REF, 0.03, 100.0, V0=0.04, kappa=2.0, theta=0.05, sigma=0.6, rho=-0.7,
                        sigma_surface=sigma_flat, mixing=mixing)


def _skew_surface():
    strikes = torch.tensor([70.0, 85.0, 100.0, 115.0, 130.0], dtype=torch.float64)
    row = torch.clamp(0.25 - 0.10 * torch.log(strikes / 100.0), 0.12, 0.45)
    return ht.RectVolSurface(REF, torch.tensor([0.5, 1.5], dtype=torch.float64), strikes,
                             torch.stack([row, row]), interp_strike="cubic")


def _mc(paths=2**15, steps=24, seed=7, qmc=False):
    return ht.MonteCarlo(ht.SLVDynamics(), ht.EulerMaruyama(),
                         ht.SimulationConfig(paths, steps, ht.Antithetic(), seed, qmc), device=CPU)


def _bs(payoff, sigma_or_surface):
    return float(ht.solve(ht.PricingProblem(payoff, ht.BlackScholesInputs(
        REF, 0.03, 100.0, sigma_or_surface)), ht.BlackScholesAnalytic(device=CPU)).price)


def _calibrate(m, **kw):
    return ht.calibrate_leverage(m, EXPIRY, device=CPU, **kw)


@pytest.mark.parametrize("mixing, rtol", [(1.0, 1.5e-2), (0.0, 1e-2)])
def test_flat_surface_reprices(mixing, rtol):
    """test_slv.py:53 and :65: full Heston vol of vol flattened back to the
    20% surface, and mixing 0 as pure local vol."""
    m = _flat_market(mixing)
    lev = _calibrate(m, steps=24, paths=16384 if mixing else 8192, bins=51 if mixing else 41,
                     seed=1 if mixing else 2)
    p = float(ht.solve(ht.PricingProblem(CALL, m.with_leverage(lev)), _mc()).price)
    assert p == pytest.approx(_bs(CALL, 0.2), rel=rtol)


def test_skew_surface_reprices():
    """test_slv.py:76: the Gyöngy test on a skewed surface across strikes,
    the wings held by the shrinkage prior, not the cap."""
    surf = _skew_surface()
    m = ht.SLVInputs(REF, 0.03, 100.0, V0=0.0625, kappa=1.5, theta=0.0625, sigma=0.5, rho=-0.6,
                     sigma_surface=surf, mixing=1.0)
    lev = _calibrate(m, steps=32, paths=32768, bins=51, seed=3)
    assert float(lev.values.max()) < 10.0
    strikes = torch.tensor([85.0, 100.0, 115.0], dtype=torch.float64)
    p = ht.solve(ht.PricingProblem(ht.VanillaOption(strikes, EXPIRY), m.with_leverage(lev)),
                 _mc(paths=2**16, steps=32, seed=11)).price
    for k, got in zip(strikes.tolist(), p):
        assert float(got) == pytest.approx(_bs(ht.VanillaOption(k, EXPIRY), surf), rel=2e-2), k


def test_delta_through_calibration():
    """test_slv.py:107: autograd through calibrate → price against
    same-seed central differences (rel 1e-1), within (0.3, 0.9)."""
    surf = _skew_surface()

    def price_of_spot(s):
        m = ht.SLVInputs(REF, 0.02, s, V0=0.0625, kappa=1.5, theta=0.0625, sigma=0.5, rho=-0.6,
                         sigma_surface=surf, mixing=1.0)
        lev = _calibrate(m, steps=10, paths=4096, bins=41, seed=3)
        return ht.solve(ht.PricingProblem(CALL, m.with_leverage(lev)),
                        _mc(paths=8192, steps=10, seed=11)).price

    s = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
    (d_ad,) = torch.autograd.grad(price_of_spot(s), s)
    with torch.no_grad():
        d_fd = float(price_of_spot(100.5) - price_of_spot(99.5))
    assert float(d_ad) == pytest.approx(d_fd, rel=1e-1)
    assert 0.3 < float(d_ad) < 0.9


def test_grid_consumers_and_qmc():
    """test_slv.py:133 and :153: Asians below the vanilla, the LSM American
    put above the European, and the QMC stream against Black-Scholes."""
    m = _flat_market(1.0)
    m2 = m.with_leverage(_calibrate(m, steps=16, paths=8192, bins=41, seed=4))
    mc = _mc(paths=8192, steps=16, seed=9)
    asian = ht.AsianOption(100.0, EXPIRY, observations=16, averaging=ht.ArithmeticAverage())
    p_asian = float(ht.solve(ht.PricingProblem(asian, m2), mc).price)
    p_van = float(ht.solve(ht.PricingProblem(CALL, m2), mc).price)
    assert 0.0 < p_asian < p_van
    put = ht.VanillaOption(100.0, EXPIRY, call_put=ht.Put())
    p_eur = float(ht.solve(ht.PricingProblem(put, m2), mc).price)
    am = ht.VanillaOption(100.0, EXPIRY, ht.American(), ht.Put())
    p_am = float(ht.solve(ht.PricingProblem(am, m2), ht.LSM(mc, degree=4)).price)
    assert p_am >= p_eur - 0.05
    m3 = m.with_leverage(_calibrate(m, steps=8, paths=4096, bins=41, seed=5))
    p = float(ht.solve(ht.PricingProblem(CALL, m3), _mc(paths=4096, steps=8, seed=0,
                                                        qmc=True)).price)
    assert p == pytest.approx(_bs(CALL, 0.2), rel=2e-2)
