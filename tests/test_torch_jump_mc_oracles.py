"""The jump and variance-gamma Monte Carlo on the port alone, against its
own closed forms: the checks of tests/unit/test_merton.py, test_kou.py,
test_variance_gamma.py and test_bates.py that price by simulation, at
their sizes and tolerances on JAX's QMC points, and on the port's Philox
streams each sampler within 4 standard errors of its Carr–Madan price
(the Bates Euler grid with the JAX test's 2% scheme allowance at 50
steps).  The per-path agreement with JAX is in tests/test_torch_jump_mc.py."""

import dataclasses
import datetime as dt
import math

import pytest
import torch

import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
CPU = "cpu"
MERTON = ht.MertonInputs(REF, 0.03, 100.0, 0.2, 0.5, -0.1, 0.15)
KOU = ht.KouInputs(REF, 0.05, 100.0, 0.16, 1.0, 0.4, 10.0, 5.0)
VG = ht.VarianceGammaInputs(REF, 0.05, 100.0, 0.18, 0.25, -0.14)
BATES = ht.BatesInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7, 0.5, -0.1, 0.15)
DYN = {"merton": ht.MertonJumpDynamics(), "kou": ht.KouJumpDynamics(),
       "vg": ht.VarianceGammaDynamics(), "bates": ht.BatesDynamics()}
MARKET = {"merton": MERTON, "kou": KOU, "vg": VG, "bates": BATES}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opt(strike=100.0, cp=None, style=None):
    return ht.VanillaOption(strike, EXPIRY, style or ht.European(), cp or ht.Call(), ht.Spot())


def _mc(family, strat, pairs, steps, seed=0, qmc=True):
    return ht.MonteCarlo(DYN[family], strat,
                         ht.SimulationConfig(pairs, steps, ht.Antithetic(), seed, qmc), device=CPU)


def _price(payoff, market, method) -> float:
    return float(ht.solve(ht.PricingProblem(payoff, market), method).price)


def _cm(family, payoff=None, market=None) -> float:
    return _price(payoff or _opt(), market or MARKET[family],
                  ht.CarrMadan(1.0, "auto", DYN[family], device=CPU))


PRNG_CASES = {
    "merton exact": ("merton", ht.MertonExact(), 1 << 16, 1, 0.0),
    "merton grid": ("merton", ht.EulerMaruyama(), 1 << 14, 4, 0.0),
    "kou exact": ("kou", ht.KouExact(), 1 << 16, 1, 0.0),
    "kou grid": ("kou", ht.EulerMaruyama(), 1 << 14, 4, 0.0),
    "vg exact": ("vg", ht.VarianceGammaExact(), 1 << 16, 1, 0.0),
    "vg grid, boosted": ("vg", ht.EulerMaruyama(), 1 << 14, 8, 0.0),
    "bates mixing": ("bates", ht.HestonQE(conditional=True), 1 << 14, 12, 0.0),
    "bates grid": ("bates", ht.EulerMaruyama(), 1 << 14, 50, 2e-2),
}


@pytest.mark.parametrize("name", sorted(PRNG_CASES))
def test_prng_price_within_4_se_of_carr_madan(name):
    family, strat, pairs, steps, allowance = PRNG_CASES[name]
    prob = ht.PricingProblem(_opt(), MARKET[family])
    method = _mc(family, strat, pairs, steps, seed=1, qmc=False)
    values = ht.mc_path_values(prob, method)
    D = float(ht.df(MARKET[family].rate, EXPIRY))
    price, se = D * float(values.mean()), D * float(values.std()) / math.sqrt(values.numel())
    assert price == pytest.approx(float(ht.solve(prob, method).price), rel=1e-12)
    cm = _cm(family)
    assert abs(price - cm) <= 4.0 * se + allowance * cm, (price, cm, se)


# -- Merton (tests/unit/test_merton.py) ------------------------------------------------------


def test_merton_exact_and_digital_vs_series():
    series = ht.MertonAnalytic(device=CPU)
    assert _price(_opt(), MERTON, _mc("merton", ht.MertonExact(), 1 << 16, 1)) == pytest.approx(
        _price(_opt(), MERTON, series), rel=2e-3)
    dig = ht.DigitalOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot(), 1.0)
    assert _price(dig, MERTON, _mc("merton", ht.MertonExact(), 1 << 16, 1, seed=1)) == (
        pytest.approx(_price(dig, MERTON, series), rel=5e-3))


@pytest.mark.parametrize("field", ["jump_intensity", "jump_mean", "jump_std", "sigma"])
def test_merton_mc_greeks_vs_series(field):
    """Autograd through the exact ``solve`` is unbiased in every field, λ by
    the likelihood-ratio surrogate (rel 3e-2 of the series' own greek)."""
    def greek(method):
        x = torch.tensor(float(getattr(MERTON, field)), dtype=torch.float64, requires_grad=True)
        price = ht.solve(ht.PricingProblem(_opt(), dataclasses.replace(MERTON, **{field: x})),
                         method).price
        return float(torch.autograd.grad(price, x)[0])

    assert greek(_mc("merton", ht.MertonExact(), 1 << 16, 1)) == pytest.approx(
        greek(ht.MertonAnalytic(device=CPU)), rel=3e-2)


def test_merton_mc_path_values_keep_the_surrogate():
    lam = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    prob = ht.PricingProblem(_opt(), dataclasses.replace(MERTON, jump_intensity=lam))
    values = ht.mc_path_values(prob, _mc("merton", ht.MertonExact(), 1 << 15, 1))
    (g_vals,) = torch.autograd.grad(values.mean(), lam)
    lam = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    series = ht.solve(ht.PricingProblem(_opt(), dataclasses.replace(MERTON, jump_intensity=lam)),
                      ht.MertonAnalytic(device=CPU)).price * math.exp(0.03 * 365 / 365)
    (g_series,) = torch.autograd.grad(series, lam)
    assert float(g_vals) == pytest.approx(float(g_series), rel=5e-2)


def test_merton_grid_terminal_is_exact_and_asians_compose():
    series = _price(_opt(), MERTON, ht.MertonAnalytic(device=CPU))
    grid = _mc("merton", ht.EulerMaruyama(), 1 << 15, 8)
    assert _price(_opt(), MERTON, grid) == pytest.approx(series, rel=3e-3)
    asian = ht.AsianOption(100.0, EXPIRY, 8, ht.European(), ht.Call(), ht.Spot(),
                           ht.ArithmeticAverage())
    assert 0.0 < _price(asian, MERTON, grid) < series


def test_american_lsm_under_merton_jumps():
    am = _opt(105.0, ht.Put(), ht.American())
    lsm = ht.LSM(_mc("merton", ht.EulerMaruyama(), 1 << 14, 50), 4)
    crr = _price(am, ht.BlackScholesInputs(REF, 0.03, 100.0, 0.2),
                 ht.CoxRossRubinsteinMethod(500, device=CPU))
    no_jumps = _price(am, dataclasses.replace(MERTON, jump_intensity=0.0), lsm)
    assert no_jumps == pytest.approx(crr, rel=2e-2)
    assert _price(am, MERTON, lsm) > no_jumps


# -- Kou and variance gamma ---------------------------------------------------------------


@pytest.mark.parametrize("family,strat,steps,rtol", [
    ("kou", ht.KouExact(), 4, 5e-3), ("kou", ht.EulerMaruyama(), 4, 5e-3),
    ("vg", ht.VarianceGammaExact(), 1, 2e-3), ("vg", ht.EulerMaruyama(), 4, 3e-3),
    ("vg", ht.EulerMaruyama(), 50, 8e-3)],
    ids=["kou exact", "kou grid", "vg exact", "vg grid", "vg fine grid, boosted"])
def test_qmc_prices_vs_carr_madan(family, strat, steps, rtol):
    assert _price(_opt(), MARKET[family], _mc(family, strat, 1 << 16, steps)) == pytest.approx(
        _cm(family), rel=rtol)


def test_kou_digital_vs_gil_pelaez():
    dig = ht.DigitalOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    assert _price(dig, KOU, _mc("kou", ht.KouExact(), 1 << 16, 1)) == pytest.approx(
        _cm("kou", dig), rel=1e-2)


@pytest.mark.parametrize("family", ["kou", "vg"])
def test_american_and_asian_on_the_jump_grid(family):
    market = MARKET[family]
    am = _price(_opt(105.0, ht.Put(), ht.American()), market,
                ht.LSM(_mc(family, ht.EulerMaruyama(), 1 << 14, 48), 4))
    assert am > _cm(family, _opt(105.0, ht.Put()))
    asian = ht.AsianOption(100.0, EXPIRY, 8, ht.European(), ht.Call(), ht.Spot(),
                           ht.ArithmeticAverage())
    assert 0.0 < _price(asian, market, _mc(family, ht.EulerMaruyama(), 1 << 15, 8)) < _cm(family)


# -- Bates (tests/unit/test_bates.py) ---------------------------------------------------------


def test_bates_mixing_vs_carr_madan():
    mixing = _mc("bates", ht.HestonQE(conditional=True), 1 << 16, 12)
    assert _price(_opt(), BATES, mixing) == pytest.approx(_cm("bates"), rel=6e-3)
    dig = ht.DigitalOption(100.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    assert _price(dig, BATES, mixing) == pytest.approx(_cm("bates", dig), rel=1e-2)


def test_bates_mixing_pathwise_delta_vs_carr_madan():
    def delta(method):
        s = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
        price = ht.solve(ht.PricingProblem(_opt(), dataclasses.replace(BATES, spot=s)),
                         method).price
        return float(torch.autograd.grad(price, s)[0])

    assert delta(_mc("bates", ht.HestonQE(conditional=True), 1 << 15, 12)) == pytest.approx(
        delta(ht.CarrMadan(1.0, "auto", ht.BatesDynamics(), device=CPU)), rel=2e-2)


def test_bates_euler_grid_lsm_and_asian():
    cm = _cm("bates")
    assert _price(_opt(), BATES, _mc("bates", ht.EulerMaruyama(), 1 << 15, 100)) == (
        pytest.approx(cm, rel=2e-2))
    am = _price(_opt(105.0, ht.Put(), ht.American()), BATES,
                ht.LSM(_mc("bates", ht.EulerMaruyama(), 1 << 14, 50), 4))
    assert am > _cm("bates", _opt(105.0, ht.Put()))
    asian = ht.AsianOption(100.0, EXPIRY, 8, ht.European(), ht.Call(), ht.Spot(),
                           ht.ArithmeticAverage())
    assert 0.0 < _price(asian, BATES, _mc("bates", ht.EulerMaruyama(), 1 << 15, 8)) < cm
