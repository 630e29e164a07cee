"""The port's substrate and oracle against the JAX package: day counts,
payoffs, the Black-Scholes goldens, Carr-Madan, ``from_reference``, the
JAX defaults of ``MonteCarlo``, the rule that the entry points run on the
GPU unless asked for the CPU, and the rule that the port never imports jax.

The JAX reference runs on the CPU in float64 (tests/conftest.py); inputs are
built once on the JAX side and carried across with ``from_reference``."""

import dataclasses
import datetime as dt
import math
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu_torch.ops import gbm_kernel as gbk
from hedgehog_tpu_torch.ops import heston_exact_kernel as ek
from hedgehog_tpu_torch.ops import heston_kernel as hk
from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel as gk
from hedgehog_tpu_torch.ops import heston_qe_kernel as qk

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
BENCH = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
BS = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.2)


@pytest.mark.parametrize("daycount", ["ACT365F", "Act360", "Act36525", "Thirty360E", "ActActISDA"])
@pytest.mark.parametrize("d0,d1", [(dt.date(2020, 1, 1), dt.date(2021, 1, 1)),
                                   (dt.date(2023, 2, 28), dt.date(2024, 3, 31)),
                                   (dt.date(2024, 7, 31), dt.date(2024, 1, 30))])
def test_yearfrac_matches_reference(daycount, d0, d1):
    ref_dc = getattr(hh, daycount)
    port_dc = getattr(ht, daycount)
    if isinstance(ref_dc, type):
        ref_dc, port_dc = ref_dc(), port_dc()
    assert ht.yearfrac(d0, d1, port_dc) == float(hh.yearfrac(d0, d1, ref_dc))


def test_ticks_and_add_yearfrac():
    d = dt.datetime(2024, 5, 17, 13, 45, 10, 250000)
    assert ht.to_ticks(d) == int(hh.to_ticks(d))
    assert ht.to_ticks(dt.date(1, 1, 1)) == 366 * ht.MILLISECONDS_IN_DAY
    t1 = ht.add_yearfrac(REF, 0.5)
    assert t1 == float(hh.add_yearfrac(REF, 0.5))
    assert ht.ticks_to_datetime(int(t1)) == hh.ticks_to_datetime(int(t1)) == dt.datetime(2024, 7, 1, 12)


@pytest.mark.parametrize("cp", ["Call", "Put"])
def test_vanilla_intrinsic_matches_reference(cp):
    spots = np.linspace(50.0, 150.0, 11)
    ref = hh.VanillaOption(100.0, EXPIRY, hh.European(), getattr(hh, cp)(), hh.Spot())
    port = ht.from_reference(ref)
    assert port.call_put() == ref.call_put()
    assert port.expiry == ref.expiry
    np.testing.assert_array_equal(port(torch.as_tensor(spots)).numpy(), np.asarray(ref(spots)))


def test_black_scholes_goldens():
    """QuantLib goldens (tests/unit/test_black_scholes.py): S=100, K=90,
    r=5%, σ=20%, T=1 → call 16.6994, put 2.3101 (atol 1e-4)."""
    expiry = ht.add_yearfrac(REF, 1.0)
    market = ht.BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    for cp, want in ((ht.Call(), 16.6994), (ht.Put(), 2.3101)):
        payoff = ht.VanillaOption(90.0, expiry, ht.European(), cp, ht.Spot())
        price = float(ht.solve(ht.PricingProblem(payoff, market),
                               ht.BlackScholesAnalytic(device="cpu")).price)
        assert price == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("market,dynamics", [(BENCH, "HestonDynamics"), (BS, "LognormalDynamics")])
@pytest.mark.parametrize("strike", [80.0, 100.0, 120.0, (90.0, 100.0, 110.0)])
@pytest.mark.parametrize("cp", ["Call", "Put"])
def test_carr_madan_matches_reference(market, dynamics, strike, cp):
    """Same panel quadrature and auto bound in complex128 on both sides:
    agreement to near f64 rounding (rel 1e-10)."""
    payoff = hh.VanillaOption(np.asarray(strike), EXPIRY, hh.European(), getattr(hh, cp)(), hh.Spot())
    prob = hh.PricingProblem(payoff, market)
    method = hh.CarrMadan(1.0, "auto", getattr(hh, dynamics)())
    want = np.asarray(hh.solve(prob, method).price)
    got = ht.solve(ht.from_reference(prob),
                   dataclasses.replace(ht.from_reference(method), device="cpu")).price.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0.0)


def test_carr_madan_black_scholes_market_matches_analytic():
    payoff = ht.VanillaOption(95.0, EXPIRY, ht.European(), ht.Call(), ht.Spot())
    prob = ht.PricingProblem(payoff, ht.from_reference(BS))
    cm = float(ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.LognormalDynamics(),
                                           device="cpu")).price)
    bs = float(ht.solve(prob, ht.BlackScholesAnalytic(device="cpu")).price)
    assert cm == pytest.approx(bs, rel=1e-10)


def test_from_reference_round_trip():
    """Problem and method objects built in JAX carry across field by field."""
    cfg = hh.SimulationConfig(trajectories=4096, steps=2, variance_reduction=hh.Antithetic(),
                              seed=5, qmc=True)
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(use_kernel=True), cfg)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Put(), hh.Spot()),
                             BENCH)
    p, m = ht.from_reference(prob), ht.from_reference(method)
    assert isinstance(p.market_inputs, ht.HestonInputs)
    assert isinstance(p.payoff.call_put, ht.Put)
    assert isinstance(p.market_inputs.rate, ht.FlatRateCurve)
    assert p.market_inputs.rate.rate == pytest.approx(0.03)
    for name in ("V0", "kappa", "theta", "sigma", "rho", "spot"):
        assert getattr(p.market_inputs, name) == float(getattr(BENCH, name))
    assert p.market_inputs.reference_date == BENCH.reference_date
    assert m.strategy == ht.HestonExactMixing(use_kernel=True)
    assert m.config == ht.SimulationConfig(4096, 2, ht.Antithetic(), 5, True)
    assert m.device == "cuda"  # the port's default; the JAX method names no device
    assert dataclasses.replace(m.config, seed=6).seed == 6


def test_from_reference_rejects_what_the_port_lacks():
    # every reference class has its counterpart now: a class of a name the
    # port lacks stands in for one
    @dataclasses.dataclass(frozen=True)
    class ShardedPricer:
        devices: int = 4

    with pytest.raises(TypeError, match="no counterpart"):
        ht.from_reference(ShardedPricer())
    assert isinstance(ht.from_reference(hh.HullWhiteAnalytic()), ht.HullWhiteAnalytic)

    @dataclasses.dataclass(frozen=True)
    class CarrMadan:  # a reference class with a field the port's CarrMadan lacks
        alpha: float = 1.0
        legacy: int = 0

    assert ht.from_reference(CarrMadan(alpha=2.0)).alpha == 2.0  # the default carries
    with pytest.raises(TypeError, match="no counterpart"):
        ht.from_reference(CarrMadan(legacy=1))


def test_montecarlo_defaults_are_the_reference_ones():
    """``MonteCarlo()`` is the JAX package's ``MonteCarlo()``
    (LognormalDynamics, BlackScholesExact, SimulationConfig()), simulated on
    the GPU."""
    port, ref = ht.MonteCarlo(), hh.MonteCarlo()
    assert port.device == "cuda"
    assert [type(x).__name__ for x in (port.dynamics, port.strategy, port.config)] == [
        type(x).__name__ for x in (ref.dynamics, ref.strategy, ref.config)]
    assert ht.from_reference(ref) == port
    assert ht.from_reference(hh.BlackScholesExact(use_kernel=True)) == ht.BlackScholesExact(True)


MKT = (math.log(100.0), 0.04, 0.03, 2.0, 0.04, 0.3, -0.7)
BLOCK = dict(n_blocks=1, n_batches=1, seed=0)
WRAPPERS = {
    "heston_euler_terminal": lambda: hk.heston_euler_terminal(*MKT, 0.1, n_paths=8, steps=2,
                                                              seed=0),
    "heston_exact_mixing_values": lambda: ek.heston_exact_mixing_values(
        *MKT, 0.5, 100.0, 1.0, n_paths=8, segments=1, seed=0),
    "heston_exact_mixing_vanilla_price": lambda: ek.heston_exact_mixing_vanilla_price(
        *MKT, 0.5, 100.0, 1.0, segments=1, **BLOCK),
    "heston_qe_mixing_values": lambda: qk.heston_qe_mixing_values(
        *MKT, 0.1, 100.0, 1.0, n_paths=8, steps=2, seed=0),
    "heston_qe_mixing_vanilla_price": lambda: qk.heston_qe_mixing_vanilla_price(
        *MKT, 0.1, 100.0, 1.0, steps=2, **BLOCK),
    "heston_qe_mixing_price_and_greeks": lambda: gk.heston_qe_mixing_price_and_greeks(
        *MKT, 0.1, 100.0, 1.0, steps=2, **BLOCK),
    "heston_qe_mixing_values_diff": lambda: gk.heston_qe_mixing_values_diff(
        *MKT, 0.1, 100.0, 1.0, n_paths=8, steps=2, seed=0),
    "heston_qe_terminal": lambda: qk.heston_qe_terminal(*MKT, 0.1, n_paths=8, steps=2, seed=0),
    "heston_qe_call_price": lambda: qk.heston_qe_call_price(*MKT, 0.1, 100.0, 1.0, steps=2,
                                                            **BLOCK),
    "gbm_exact_terminal": lambda: gbk.gbm_exact_terminal(4.6, 0.2, n_paths=8, seed=0),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_default_device_wrapper_raises_without_a_gpu(name, monkeypatch):
    """Every public kernel wrapper defaults to the GPU: with no usable GPU a
    call that names no device raises instead of running the plain twin on
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        WRAPPERS[name]()


@pytest.mark.parametrize("method", [
    ht.MonteCarlo(config=ht.SimulationConfig(64, 1)),
    ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(), ht.SimulationConfig(64, 2)),
    ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(conditional=True, use_kernel=True),
                  ht.SimulationConfig(64, 2)),
], ids=["defaults", "qe_m", "qe_mixing_kernel"])
def test_default_device_solve_raises_without_a_gpu(method, monkeypatch):
    """``solve`` with the default device and no usable GPU raises; the same
    method with ``device="cpu"`` prices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    market = BS if isinstance(method.dynamics, ht.LognormalDynamics) else BENCH
    prob = ht.from_reference(hh.PricingProblem(
        hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()), market))
    with pytest.raises(RuntimeError, match="is_available"):
        ht.solve(prob, method)
    assert math.isfinite(float(ht.solve(prob, dataclasses.replace(method, device="cpu")).price))


def test_import_never_reaches_jax():
    """Import every module of the package and chip_smoke.py, and price
    once, in a fresh process in which any import of jax or of the JAX
    package fails."""
    code = textwrap.dedent("""
        import sys
        for name in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
            del sys.modules[name]

        class NoJax:
            def find_spec(self, name, path=None, target=None):
                if name in ("jax", "hedgehog_tpu") or name.startswith(
                        ("jax.", "jaxlib", "hedgehog_tpu.")):
                    raise ImportError("the port must not import " + name)
                return None

        sys.meta_path.insert(0, NoJax())
        import datetime as dt
        import importlib
        import pkgutil
        import hedgehog_tpu_torch as ht
        modules = [m.name for m in pkgutil.walk_packages(ht.__path__, "hedgehog_tpu_torch.")]
        for name in modules:
            importlib.import_module(name)
        assert "hedgehog_tpu_torch.methods.heston_qe_paths" in modules, modules
        import chip_smoke
        mkt = ht.HestonInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
        prob = ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2025, 1, 1)), mkt)
        cfg = ht.SimulationConfig(64, 2, ht.Antithetic(), 0, True)
        ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonExactMixing(True), cfg,
                                     device="cpu"))
        ht.solve(prob, ht.CarrMadan(1.0, "auto", ht.HestonDynamics(), device="cpu"))
        ht.solve(prob, ht.MonteCarlo(ht.HestonDynamics(), ht.HestonQE(), cfg, device="cpu"))
        bs = ht.BlackScholesInputs(dt.date(2024, 1, 1), 0.03, 100.0, 0.2)
        ht.solve(ht.PricingProblem(prob.payoff, bs), ht.MonteCarlo(config=cfg, device="cpu"))
        assert not any(m in ("jax", "hedgehog_tpu") or m.startswith(("jax.", "hedgehog_tpu."))
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=pathlib.Path(__file__).resolve().parents[1],
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_heston_characteristic_function_matches_reference():
    """complex128 on both sides, on Carr-Madan's shifted contour u = v − 2i."""
    from hedgehog_tpu.models.dynamics import heston_cf as jax_heston_cf
    from hedgehog_tpu_torch.models.dynamics import heston_cf

    v = np.linspace(-60.0, 60.0, 121)
    args = (100.0, 0.04, 2.0, 0.04, 0.3, -0.7, 0.03, 366 / 365)
    want = np.asarray(jax_heston_cf(v - 2.0j, *args))
    got = heston_cf(torch.as_tensor(v - 2.0j), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("t", [dt.date(2024, 7, 1), EXPIRY, dt.date(2030, 2, 28)])
def test_rate_curve_and_market_helpers_match_reference(t):
    from hedgehog_tpu.market import inputs as jax_inputs
    from hedgehog_tpu_torch.market import inputs

    market = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7, dividend_yield=0.01)
    port = ht.from_reference(market)
    assert float(ht.df(port.rate, t)) == pytest.approx(float(hh.df(market.rate, t)), rel=1e-15)
    assert float(ht.zero_rate(port.rate, t)) == float(hh.zero_rate(market.rate, t))
    yf = inputs.market_yearfrac(port, ht.to_ticks(t))
    assert yf == float(jax_inputs.market_yearfrac(market, hh.to_ticks(t)))
    assert float(ht.df_yf(port.rate, yf)) == pytest.approx(float(hh.df_yf(market.rate, yf)),
                                                           rel=1e-15)
    assert float(inputs.forward_spot(port, yf)) == pytest.approx(
        float(jax_inputs.forward_spot(market, yf)), rel=1e-15)
    assert inputs.carry_yield(port) == 0.01
