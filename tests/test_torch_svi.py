"""The port's SVI surface (hedgehog_tpu_torch/market/svi.py) against the JAX
package's: the cases of tests/unit/test_svi.py, on the CPU.

Tolerances: slice evaluations, forwards and margins against JAX to 1e-12
relative; fitted parameters within 2e-4 of the truth and of JAX's fit (the
JAX test's limit; each slice its own bounded L-BFGS in both, the port's
following optax's iterates); the price through ``solve`` to 1e-12 and its
parameter gradient against ``jax.grad`` to 1e-8."""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2024, 1, 1)
S0, RATE = 100.0, 0.03
TENORS = np.array([0.25, 0.5, 1.0])
FWDS = S0 * np.exp(RATE * TENORS)
# a benign skewed surface: total variance grows in t, wings well-behaved
PARAMS = np.array([
    [0.010, 0.10, -0.30, 0.00, 0.20],
    [0.018, 0.12, -0.35, 0.02, 0.25],
    [0.032, 0.14, -0.40, 0.05, 0.30],
])
RTOL = 1e-12


def _surface(params=PARAMS, tenors=TENORS, fwds=FWDS):
    return ht.SVIVolSurface(REF, torch.from_numpy(tenors.copy()), torch.as_tensor(params),
                            torch.from_numpy(fwds.copy()), device="cpu")


def _j_surface(params=PARAMS, tenors=TENORS, fwds=FWDS):
    return hh.SVIVolSurface(REF, jnp.asarray(tenors), jnp.asarray(params), jnp.asarray(fwds))


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def test_slice_eval_matches_raw_formula():
    surf = _surface()
    k = np.linspace(-0.4, 0.4, 9)
    K = FWDS[2] * np.exp(k)
    iv = ht.get_vol_yf(surf, 1.0, torch.from_numpy(K))
    w = ht.svi_total_variance(tuple(torch.from_numpy(PARAMS[2])), torch.from_numpy(k))
    np.testing.assert_allclose(_np(iv**2 * 1.0), _np(w), rtol=RTOL)
    np.testing.assert_allclose(_np(w), _np(hh.svi_total_variance(tuple(PARAMS[2]), k)), rtol=RTOL)
    np.testing.assert_allclose(_np(iv), _np(hh.get_vol_yf(_j_surface(), 1.0, K)), rtol=RTOL)


@pytest.mark.parametrize("t", [0.1, 0.25, 0.375, 0.5, 0.9, 1.0, 2.0])
def test_surface_lookups_match_reference(t):
    """forward_at, total_variance and vol_yf inside, at and beyond the
    tenors, against JAX's."""
    surf, j = _surface(), _j_surface()
    K = np.linspace(70.0, 140.0, 15)
    np.testing.assert_allclose(_np(surf.forward_at(t)), _np(j.forward_at(t)), rtol=RTOL)
    np.testing.assert_allclose(_np(surf.total_variance(t, torch.from_numpy(K))),
                               _np(j.total_variance(t, K)), rtol=RTOL)
    np.testing.assert_allclose(_np(surf.vol_yf(t, torch.from_numpy(K))), _np(j.vol_yf(t, K)),
                               rtol=RTOL)
    with pytest.raises(TypeError, match="scalar t"):
        surf.total_variance(torch.tensor([t, t], dtype=torch.float64), 100.0)


def test_time_interpolation_is_linear_in_total_variance():
    surf = _surface()
    k = 0.08

    def w(t):
        K = surf.forward_at(t) * np.exp(k)
        return float(ht.get_vol_yf(surf, t, K) ** 2 * t)

    np.testing.assert_allclose(w(0.375), 0.5 * (w(0.25) + w(0.5)), rtol=1e-10)
    K_far = float(surf.forward_at(2.0)) * np.exp(0.1)
    K_end = float(surf.forward_at(1.0)) * np.exp(0.1)
    np.testing.assert_allclose(float(ht.get_vol_yf(surf, 2.0, K_far)),
                               float(ht.get_vol_yf(surf, 1.0, K_end)), rtol=1e-10)


def test_one_slice_surface():
    surf = _surface(PARAMS[:1], TENORS[:1], FWDS[:1])
    j = _j_surface(PARAMS[:1], TENORS[:1], FWDS[:1])
    for t in (0.1, 0.25, 0.7):
        np.testing.assert_allclose(_np(surf.vol_yf(t, 104.0)), _np(j.vol_yf(t, 104.0)), rtol=RTOL)
        np.testing.assert_allclose(_np(surf.forward_at(t)), _np(j.forward_at(t)), rtol=RTOL)


def test_no_arbitrage_diagnostics_pass_and_flag():
    bf, cal = ht.check_svi_arbitrage(_surface())
    assert bool(torch.all(bf > 0.0)) and float(cal) > 0.0
    j_bf, j_cal = hh.check_svi_arbitrage(_j_surface())
    np.testing.assert_allclose(_np(bf), _np(j_bf), rtol=RTOL)
    np.testing.assert_allclose(float(cal), float(j_cal), rtol=RTOL)
    _, cal2 = ht.check_svi_arbitrage(_surface(PARAMS[::-1].copy()))
    assert float(cal2) < 0.0
    # Axel Vogt's classic arbitrageable raw-SVI slice
    vogt = np.array([[-0.0410, 0.1331, 0.3060, 0.3586, 0.4153]])
    bf3, cal3 = ht.check_svi_arbitrage(_surface(vogt, TENORS[:1], FWDS[:1]))
    assert float(bf3[0]) < 0.0 and float(cal3) == float("inf")
    k = np.linspace(-1.5, 1.5, 31)
    np.testing.assert_allclose(_np(ht.svi_butterfly_margin(tuple(vogt[0]), torch.from_numpy(k))),
                               _np(hh.svi_butterfly_margin(tuple(vogt[0]), jnp.asarray(k))),
                               rtol=RTOL, atol=1e-15)


@pytest.fixture(scope="module")
def smile_data():
    strikes = np.exp(np.linspace(-0.35, 0.35, 15))[None, :] * FWDS[:, None]
    k = np.log(strikes / FWDS[:, None])
    w = np.stack([_np(hh.svi_total_variance(tuple(p), kr)) for p, kr in zip(PARAMS, k)])
    return strikes, np.sqrt(w / TENORS[:, None])


@pytest.fixture(scope="module")
def reference_fit(smile_data):
    strikes, ivs = smile_data
    return [np.asarray(x) for x in hh.calibrate_svi_slices(jnp.asarray(TENORS), jnp.asarray(FWDS),
                                                           jnp.asarray(strikes),
                                                           jnp.asarray(ivs))]


def test_calibration_recovers_slices(smile_data, reference_fit):
    strikes, ivs = smile_data
    params, loss, conv = ht.calibrate_svi_slices(TENORS, FWDS, strikes, ivs, device="cpu")
    assert params.shape == (3, 5) and loss.shape == (3,) and conv.dtype == torch.bool
    assert bool(torch.all(conv))
    np.testing.assert_allclose(_np(params), PARAMS, atol=2e-4)
    np.testing.assert_allclose(_np(params), reference_fit[0], atol=2e-4)
    assert float(torch.max(loss)) < 1e-10


def test_calibration_with_weights_broadcast_per_strike(smile_data):
    """(m,) per-strike weights apply to every slice, as strikes do (the
    JAX test's atol 2e-3)."""
    strikes, ivs = smile_data
    p_w, _, conv_w = ht.calibrate_svi_slices(TENORS, FWDS, strikes, ivs,
                                             weights=np.linspace(0.5, 1.5, ivs.shape[1]),
                                             device="cpu")
    assert bool(torch.all(conv_w))
    np.testing.assert_allclose(_np(p_w), PARAMS, atol=2e-3)


def test_calibration_options_match_reference(smile_data):
    """A shared (m,) strike row, a given x0 and a butterfly penalty, on a
    smile with noise: the port's fit within 2e-4 of JAX's."""
    _, ivs = smile_data
    row = np.exp(np.linspace(-0.35, 0.35, 15)) * 100.0
    noisy = ivs * (1.0 + 0.002 * np.random.default_rng(1).standard_normal(ivs.shape))
    kw = dict(x0=PARAMS[1], butterfly_penalty=10.0, max_iters=200)
    got = ht.calibrate_svi_slices(TENORS, FWDS, row, noisy, device="cpu", **kw)
    want = hh.calibrate_svi_slices(jnp.asarray(TENORS), jnp.asarray(FWDS), jnp.asarray(row),
                                   jnp.asarray(noisy), **kw)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=2e-4)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-3, atol=1e-12)


def test_prices_through_solve_with_param_gradients():
    opt = ht.VanillaOption(105.0, dt.date(2024, 7, 1), ht.European(), ht.Call(), ht.Spot())
    j_opt = hh.VanillaOption(105.0, dt.date(2024, 7, 1), hh.European(), hh.Call(), hh.Spot())
    bs = ht.BlackScholesAnalytic(device="cpu")

    def price_of(p):
        mkt = ht.BlackScholesInputs(REF, RATE, S0, _surface(p))
        return ht.solve(ht.PricingProblem(opt, mkt), bs).price

    def j_price_of(p):
        mkt = hh.BlackScholesInputs(REF, RATE, S0, _j_surface(p))
        return hh.solve(hh.PricingProblem(j_opt, mkt), hh.BlackScholesAnalytic()).price

    params = torch.from_numpy(PARAMS.copy()).requires_grad_(True)
    price = price_of(params)
    np.testing.assert_allclose(float(price.detach()), float(j_price_of(jnp.asarray(PARAMS))),
                               rtol=RTOL)
    t = ht.yearfrac(REF, dt.date(2024, 7, 1))
    iv = float(ht.get_vol_yf(_surface(), t, 105.0))
    flat = ht.BlackScholesInputs(REF, RATE, S0, iv)
    np.testing.assert_allclose(float(price.detach()),
                               float(ht.solve(ht.PricingProblem(opt, flat), bs).price), rtol=1e-12)
    (g,) = torch.autograd.grad(price, params)
    want = np.asarray(jax.grad(j_price_of)(jnp.asarray(PARAMS)))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-8, atol=1e-12)
    assert bool(torch.all(torch.isfinite(g)))
    # t ≈ 0.499 interpolates slices 0 and 1; the t = 1 slice is untouched
    assert float(torch.max(torch.abs(g[1]))) > 0.0
    assert float(torch.max(torch.abs(g[2]))) == 0.0


def test_from_reference_and_the_device_rule():
    port = ht.from_reference(_j_surface())
    assert isinstance(port, ht.SVIVolSurface) and port.device == "cuda"
    cpu = dataclasses.replace(port, device="cpu")
    np.testing.assert_allclose(_np(cpu.vol_yf(0.5, 100.0)), _np(_j_surface().vol_yf(0.5, 100.0)),
                               rtol=RTOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port.vol_yf(0.5, 100.0)
        with pytest.raises(RuntimeError, match="cuda"):
            ht.calibrate_svi_slices(TENORS, FWDS, FWDS[:, None] * np.ones((3, 4)),
                                    0.2 * np.ones((3, 4)))


def test_slice_entry_points_run_without_jax():
    """Broadie-Kaya, the quotes and the SVI fit price in a fresh process in
    which any import of jax or of the JAX package fails."""
    import pathlib
    import subprocess
    import sys
    import textwrap

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
        import math
        import numpy as np
        import hedgehog_tpu_torch as ht
        ref = dt.date(2024, 1, 1)
        mkt = ht.HestonInputs(ref, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
        prob = ht.PricingProblem(ht.VanillaOption(100.0, dt.date(2025, 1, 1)), mkt)
        cfg = ht.SimulationConfig(64, 1, ht.Antithetic(), 0)
        bk = ht.MonteCarlo(ht.HestonDynamics(), ht.HestonBroadieKaya(16), cfg, device="cpu")
        assert math.isfinite(float(ht.solve(prob, bk).price))
        q = ht.resolve_quotes_batch(np.array([90.0, 110.0]), [dt.date(2025, 1, 1)] * 2,
                                    ht.SpotObs(100.0), 0.03, ref, mid_iv=np.array([0.2, 0.2]),
                                    config=ht.VolQuoteConfig(
                                        iv_model=ht.BlackScholesAnalytic(device="cpu")))
        assert bool((q.mid_price > 0).all())
        k = np.linspace(-0.3, 0.3, 9)
        ivs = np.sqrt(0.03 + 0.1 * (-0.3 * k + np.sqrt(k * k + 0.04)))[None, :]
        p, _, conv = ht.calibrate_svi_slices([1.0], [100.0], 100.0 * np.exp(k), ivs,
                                             device="cpu")
        assert bool(conv.all())
        assert not any(m in ("jax", "hedgehog_tpu") or m.startswith(("jax.", "hedgehog_tpu."))
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=pathlib.Path(__file__).resolve().parents[1], timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_svi_feeds_dupire_local_vol():
    """tests/unit/test_svi.py:113 on the port's surface, and the local vol
    against JAX's at the same point."""
    mkt = ht.BlackScholesInputs(REF, RATE, S0, _surface())
    lv = ht.dupire_local_vol(mkt, 0.5, 100.0)
    assert bool(torch.isfinite(lv)) and 0.05 < float(lv) < 1.0
    want = hh.dupire_local_vol(hh.BlackScholesInputs(REF, RATE, S0, _j_surface()), 0.5, 100.0)
    np.testing.assert_allclose(_np(lv), _np(want), rtol=RTOL)
