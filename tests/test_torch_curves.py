"""The port's interpolation, rate curves, vol surfaces and lenses against the
JAX package: the cases of tests/unit/test_rate_curve.py and
tests/unit/test_vol_surface.py, each on both sides, plus the interpolation
kinds, the lenses' reads and writes, and the slice modules' public names.

Inputs are made from a seed with numpy (or taken from the JAX tests), built
as JAX objects and carried across with ``from_reference``.  Deterministic
float64 on both sides: agreement to 1e-10 relative unless stated."""

import dataclasses
import datetime as dt
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2020, 1, 1)
RTOL = 1e-10
SPINE = np.array([0.5, 1.0, 2.0, 5.0, 10.0])


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _surface(interp_strike="linear", interp_time="linear"):
    return hh.RectVolSurface(REF, jnp.array([0.25, 0.5, 1.0]), jnp.array([80.0, 100.0, 120.0]),
                             jnp.array([[0.30, 0.25, 0.28], [0.32, 0.26, 0.29],
                                        [0.34, 0.27, 0.30]]),
                             interp_time=interp_time, interp_strike=interp_strike)


# ---- math/interpolation -----------------------------------------------------


@pytest.mark.parametrize("kind", ht.INTERP_KINDS)
@pytest.mark.parametrize("knots", [2, 5, 9])
def test_interp1d_matches_reference(kind, knots):
    rng = np.random.default_rng(100 + knots)
    xs = np.sort(rng.uniform(0.1, 10.0, knots))
    ys = rng.normal(0.03, 0.01, knots)
    x = np.concatenate([[0.0, xs[0], xs[-1], 12.0], rng.uniform(0.0, 11.0, 16)])
    _close(ht.interp1d(_t(x), _t(xs), _t(ys), kind=kind),
           hh.math.interpolation.interp1d(x, xs, ys, kind=kind), atol=1e-15)


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_interp1d_knot_gradient_matches_reference(kind):
    """Gradients in the knot values (the rate-spine greeks' path)."""
    rng = np.random.default_rng(7)
    xs = np.sort(rng.uniform(0.1, 10.0, 6))
    ys = rng.normal(0.03, 0.01, 6)
    x = rng.uniform(0.0, 11.0, 5)
    want = jax.grad(lambda y: jnp.sum(hh.math.interpolation.interp1d(x, xs, y, kind=kind) ** 2))(
        jnp.asarray(ys))
    y = _t(ys).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(ht.interp1d(_t(x), _t(xs), y, kind=kind) ** 2), y)
    _close(got, want, atol=1e-15)


@pytest.mark.parametrize("kind_x,kind_y", [("linear", "linear"), ("linear", "cubic"),
                                           ("cubic", "quadratic")])
def test_interp2d_nested_matches_reference(kind_x, kind_y):
    rng = np.random.default_rng(11)
    xv, yv = np.sort(rng.uniform(0.1, 3.0, 4)), np.sort(rng.uniform(50.0, 150.0, 5))
    values = rng.uniform(0.1, 0.5, (4, 5))
    x, y = rng.uniform(0.0, 3.5, 6), rng.uniform(40.0, 160.0, 6)
    want = hh.math.interpolation.interp2d_nested(x, y, xv, yv, values, kind_x=kind_x,
                                                 kind_y=kind_y)
    _close(ht.interp2d_nested(_t(x), _t(y), _t(xv), _t(yv), _t(values), kind_x=kind_x,
                              kind_y=kind_y), want)


# ---- market/rate_curve (tests/unit/test_rate_curve.py) ----------------------


def test_flat_curve_identities():
    ref, port = hh.FlatRateCurve(REF, 0.03), ht.FlatRateCurve(REF, 0.03)
    t = ht.add_yearfrac(ht.to_ticks(REF), 2.0)
    for fn in ("zero_rate", "df"):
        _close(getattr(ht, fn)(port, t), getattr(hh, fn)(ref, t))
    _close(ht.df_yf(port, 2.0), np.exp(-0.06))
    assert float(ht.zero_rate_yf(port, 5.0)) == 0.03


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_df_recovery_at_spine_points(interp):
    dfs = np.exp(-0.02 * SPINE**1.1)
    ref = hh.RateCurve.from_dfs(REF, SPINE, dfs, interp=interp)
    port = ht.from_reference(ref)
    assert isinstance(port, ht.RateCurve) and port.interp == interp
    for tau, d in zip(SPINE, dfs):
        assert float(ht.df_yf(port, tau)) == pytest.approx(float(d), abs=1e-12)
        _close(ht.zero_rate_yf(port, tau), hh.zero_rate_yf(ref, tau))
    q = np.linspace(0.1, 12.0, 25)
    _close(ht.df_yf(port, q), hh.df_yf(ref, q))
    _close(ht.df(port, ht.add_yearfrac(REF, 3.3)), hh.df(ref, hh.add_yearfrac(REF, 3.3)))


def test_constant_extrapolation():
    port = ht.RateCurve.from_dfs(REF, [1.0, 2.0], [np.exp(-0.02), np.exp(-0.06)])
    assert float(ht.zero_rate_yf(port, 0.25)) == pytest.approx(0.02)
    assert float(ht.zero_rate_yf(port, 30.0)) == pytest.approx(0.03)


def test_forward_rate():
    _close(ht.forward_rate(ht.FlatRateCurve(REF, 0.04), 1.0, 2.0), 0.04)
    ref = hh.RateCurve(REF, jnp.asarray([1.0, 2.0]), jnp.asarray([0.02, 0.03]))
    port = ht.from_reference(ref)
    _close(ht.forward_rate(port, 1.0, 2.0), hh.forward_rate(ref, 1.0, 2.0))
    _close(ht.forward_rate(port, dt.date(2020, 6, 1), dt.date(2021, 6, 1)),
           hh.forward_rate(ref, dt.date(2020, 6, 1), dt.date(2021, 6, 1)))
    with pytest.raises(ValueError):
        ht.forward_rate(port, 2.0, 1.0)


@pytest.mark.parametrize("tenors,dfs", [([], []), ([1.0, 2.0], [0.9]), ([2.0, 1.0], [0.9, 0.8]),
                                        ([1.0, 2.0], [0.9, -0.1]), ([0.0, 1.0], [1.0, 0.9])])
def test_ctor_validation(tenors, dfs):
    with pytest.raises(ValueError) as ref_err:
        hh.RateCurve.from_dfs(REF, tenors, dfs)
    with pytest.raises(ValueError, match=str(ref_err.value)):
        ht.RateCurve.from_dfs(REF, tenors, dfs)


def test_spine_accessors():
    dfs = np.array([0.98, 0.95])
    ref = hh.RateCurve.from_dfs(REF, [1.0, 2.0], dfs)
    port = ht.from_reference(ref)
    _close(ht.spine_tenors(port), hh.spine_tenors(ref))
    _close(ht.spine_zeros(port), -np.log(dfs) / np.array([1.0, 2.0]))
    _close(ht.spine_zeros(ht.FlatRateCurve(REF, 0.01)), [0.01])
    _close(ht.spine_tenors(ht.FlatRateCurve(REF, 0.01)), [0.0])
    assert ht.is_flat(ht.FlatRateCurve(REF, 0.01)) and not ht.is_flat(port)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_df_is_differentiable_wrt_spine(interp):
    tenors, zr = np.array([1.0, 2.0, 3.0]), np.array([0.02, 0.025, 0.03])
    want = jax.grad(lambda z: hh.df_yf(hh.RateCurve(REF, jnp.asarray(tenors), z, interp=interp),
                                       1.5))(jnp.asarray(zr))
    z = _t(zr).requires_grad_(True)
    (got,) = torch.autograd.grad(ht.df_yf(ht.RateCurve(REF, _t(tenors), z, interp=interp), 1.5), z)
    _close(got, want, atol=1e-16)
    if interp == "linear":
        assert float(got[0]) != 0.0 and float(got[1]) != 0.0 and float(got[2]) == 0.0


def test_curve_prices_black_scholes_like_reference():
    """An interpolated curve and a rect surface drive BlackScholesAnalytic."""
    rng = np.random.default_rng(3)
    curve = hh.RateCurve.from_dfs(REF, SPINE, np.exp(-rng.uniform(0.01, 0.05, 5) * SPINE),
                                  interp="cubic")
    market = hh.BlackScholesInputs(REF, curve, 100.0, _surface("cubic"))
    for expiry, strike in ((dt.date(2020, 5, 1), 90.0), (dt.date(2021, 3, 1), 105.0)):
        prob = hh.PricingProblem(hh.VanillaOption(strike, expiry, hh.European(), hh.Put(),
                                                  hh.Spot()), market)
        want = hh.solve(prob, hh.BlackScholesAnalytic()).price
        got = ht.solve(ht.from_reference(prob), ht.BlackScholesAnalytic(device="cpu")).price
        _close(got, want)


def test_heston_market_keeps_a_flat_rate():
    curve = ht.RateCurve.from_dfs(REF, [1.0, 2.0], [0.98, 0.95])
    with pytest.raises(TypeError, match="one short rate"):
        ht.HestonInputs(REF, curve, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)


# ---- market/vol_surface (tests/unit/test_vol_surface.py) --------------------


def test_flat_surface():
    surf = ht.FlatVolSurface(0.25, REF)
    assert ht.get_vol(surf, dt.date(2021, 1, 1), 100.0) == 0.25
    assert ht.get_vol_yf(surf, 0.5, 1.0) == 0.25


def test_grid_point_recovery():
    port = ht.from_reference(_surface())
    for i, t in enumerate([0.25, 0.5, 1.0]):
        for j, k in enumerate([80.0, 100.0, 120.0]):
            assert float(ht.get_vol_yf(port, t, k)) == pytest.approx(float(port.vols[i, j]),
                                                                     abs=1e-14)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_interior_matches_reference(interp):
    ref = _surface(interp)
    port = ht.from_reference(ref)
    _close(ht.get_vol_yf(port, 0.375, 90.0), hh.get_vol_yf(ref, 0.375, 90.0))
    if interp == "linear":
        assert float(ht.get_vol_yf(port, 0.375, 90.0)) == pytest.approx(
            np.mean([0.30, 0.25, 0.32, 0.26]))
    t, k = np.array([0.3, 0.6, 0.9]), np.array([85.0, 110.0, 119.0])
    _close(ht.get_vol_yf(port, _t(t), _t(k)), hh.get_vol_yf(ref, t, k))


def test_constant_extrapolation_both_axes():
    port = ht.from_reference(_surface())
    for t, k in ((0.01, 80.0), (5.0, 120.0), (0.25, 10.0), (1.0, 500.0)):
        assert float(ht.get_vol_yf(port, t, k)) == pytest.approx(0.30)


def test_get_vol_with_dates():
    port = ht.from_reference(_surface())
    assert float(ht.get_vol(port, ht.add_yearfrac(ht.to_ticks(REF), 0.5), 100.0)) == \
        pytest.approx(0.26)


def test_interpolator2d_api():
    itp = ht.Interpolator2D(_t([1.0, 2.0]), _t([10.0, 20.0]), _t([[1.0, 2.0], [3.0, 4.0]]))
    assert float(itp[1.0, 10.0]) == 1.0
    assert float(itp[1.5, 15.0]) == pytest.approx(2.5)
    assert float(itp(0.0, 0.0)) == 1.0  # clamped on both axes
    port = ht.from_reference(_surface())
    assert float(port.interpolator[0.375, 90.0]) == float(ht.get_vol_yf(port, 0.375, 90.0))


def test_vol_lookup_differentiable_wrt_grid():
    ref = _surface()
    want = jax.grad(lambda v: hh.get_vol_yf(ref.with_vols(v), 0.375, 90.0))(ref.vols)
    port = ht.from_reference(ref)
    vols = _t(port.vols).requires_grad_(True)
    (got,) = torch.autograd.grad(ht.get_vol_yf(port.with_vols(vols), 0.375, 90.0), vols)
    _close(got, want, atol=1e-16)
    assert float(got.sum()) == pytest.approx(1.0) and float(got[0, 0]) == pytest.approx(0.25)
    _close(ht.spine_vols(port), hh.spine_vols(ref))
    _close(ht.spine_strikes(port), hh.spine_strikes(ref))
    _close(ht.surface_spine_tenors(port), hh.surface_spine_tenors(ref))
    _close(ht.spine_vols(ht.FlatVolSurface(0.2)), [[0.2]])


# ---- core/lenses ------------------------------------------------------------


def _bs_problem(rate=0.03, sigma=0.2):
    payoff = hh.VanillaOption(1.1, dt.date(2020, 9, 1), hh.European(), hh.Call(), hh.Spot())
    return hh.PricingProblem(payoff, hh.BlackScholesInputs(REF, rate, 1.0, sigma))


@pytest.mark.parametrize("lens,x", [(hh.SpotLens(), 1.05), (hh.FieldLens("market_inputs.spot"), 1.05),
                                    (hh.VolLens(1, 1), 0.37), (hh.VolLens(80.0, 0.5), 0.37),
                                    (hh.ZeroRateSpineLens(0), 0.045),
                                    (hh.ZeroRateSpineLens(3), 0.045),
                                    (hh.FieldLens("payoff.strike"), 1.05)],
                         ids=["spot", "field_spot", "vol_flat", "vol_rect", "zero_flat",
                              "zero_curve", "strike"])
def test_lens_get_set_matches_reference(lens, x):
    prob = _bs_problem()
    if isinstance(lens, hh.VolLens) and lens.expiry != 1:
        prob = dataclasses.replace(prob, market_inputs=dataclasses.replace(
            prob.market_inputs, sigma=_surface()))
    if isinstance(lens, hh.ZeroRateSpineLens) and lens.i > 0:
        curve = hh.RateCurve.from_dfs(REF, SPINE, np.exp(-0.03 * SPINE), interp="cubic")
        prob = dataclasses.replace(prob, market_inputs=dataclasses.replace(
            prob.market_inputs, rate=curve))
    port, plens = ht.from_reference(prob), ht.from_reference(lens)
    assert plens == type(plens)(*dataclasses.astuple(plens)) and hash(plens) == hash(plens)
    _close(ht.lens_get(port, plens), hh.lens_get(prob, lens))
    value = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    bumped = ht.lens_set(port, plens, value)
    assert plens(bumped).requires_grad
    _close(plens.get(bumped), x)
    want = hh.solve(hh.lens_set(prob, lens, x), hh.BlackScholesAnalytic()).price
    price = ht.solve(bumped, ht.BlackScholesAnalytic(device="cpu")).price
    _close(price, want)
    (g,) = torch.autograd.grad(price, value)  # the write kept the value's history
    _close(g, jax.grad(lambda v: hh.solve(hh.lens_set(prob, lens, v),
                                          hh.BlackScholesAnalytic()).price)(x), atol=1e-14)


def test_vol_lens_needs_an_exact_grid_point():
    prob = ht.from_reference(_bs_problem())
    prob = dataclasses.replace(prob, market_inputs=dataclasses.replace(
        prob.market_inputs, sigma=ht.from_reference(_surface())))
    with pytest.raises(KeyError, match="no exact match"):
        ht.VolLens(90.0, 0.5).get(prob)
    with pytest.raises(KeyError, match="no exact match"):
        ht.VolLens(100.0, 0.3).set(prob, 0.2)


# ---- public names -----------------------------------------------------------

SLICE_MODULES = ["math.interpolation", "market.rate_curve", "market.vol_surface", "core.lenses",
                 "core.solve", "greeks.greeks", "math.rootfind", "math.optimize",
                 "calibration.implied", "calibration.calibration"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_exports_the_reference_names(module):
    ref = importlib.import_module(f"hedgehog_tpu.{module}")
    port = importlib.import_module(f"hedgehog_tpu_torch.{module}")
    assert set(ref.__all__) <= set(port.__all__), set(ref.__all__) - set(port.__all__)
    assert set(ref.__all__) <= set(ht.__all__), set(ref.__all__) - set(ht.__all__)
    for name in ref.__all__:
        assert getattr(ht, name) is getattr(port, name)


def test_basket_problem_names():
    ref = importlib.import_module("hedgehog_tpu.core.problems")
    for name in ("PricingProblem", "BasketPricingProblem", "BasketPricingSolution"):
        assert name in ref.__all__ and name in ht.__all__
