"""The port's market quotes (hedgehog_tpu_torch/market/vol_quotes.py) against
the JAX package's: every case of tests/unit/test_vol_quotes.py and
tests/unit/test_resolve_quotes_batch.py, the port's prices and IVs held to
JAX's at 1e-10 (relative, absolute below 1e-10), the same warnings and
errors, and the JAX tests' own limits against their oracles.

The port resolves on its pricing method's device: the tests pass
``BlackScholesAnalytic(device="cpu")`` (or a CPU Carr-Madan) as the
``iv_model``; with none the GPU is asked for and, without one, the call
raises."""

import dataclasses
import datetime as dt
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

REF = dt.date(2025, 1, 1)
EXP = dt.date(2025, 7, 1)
OPT = ht.VanillaOption(100.0, EXP, ht.European(), ht.Call(), ht.Spot())
J_OPT = hh.VanillaOption(100.0, EXP, hh.European(), hh.Call(), hh.Spot())
BS = ht.BlackScholesAnalytic(device="cpu")
CFG = ht.VolQuoteConfig(iv_model=BS)
NAN = float("nan")
TOL = dict(rtol=1e-10, atol=1e-10)


def _cfg(**kw):
    return ht.VolQuoteConfig(**{"iv_model": BS, **kw})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    if isinstance(x, (list, tuple)):
        return np.array([float(v) for v in x])
    return np.asarray(x, dtype=np.float64)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _quote_fields(q):
    return [q.bid_price, q.mid_price, q.ask_price, q.bid_iv, q.mid_iv, q.ask_iv]


def _build_both(opt_k=100.0, und=("SpotObs", 100.0), r=0.02, config=None, j_config=None, **levels):
    """One quote through both packages: (port, JAX)."""
    opt = dataclasses.replace(OPT, strike=opt_k)
    j_opt = hh.VanillaOption(opt_k, EXP, hh.European(), hh.Call(), hh.Spot())
    port = ht.VolQuote.build(opt, getattr(ht, und[0])(und[1]), r, reference_date=REF,
                             config=config or CFG, **levels)
    ref = hh.VolQuote.build(j_opt, getattr(hh, und[0])(und[1]), r, reference_date=REF,
                            config=j_config, **levels)
    return port, ref


@pytest.mark.parametrize("S,K,sigma", [(100.0, 80.0, 0.2), (100.0, 100.0, 0.5),
                                       (100.0, 130.0, 1.0)])
def test_price_iv_roundtrip(S, K, sigma):
    opt = dataclasses.replace(OPT, strike=K)
    j_opt = hh.VanillaOption(K, EXP, hh.European(), hh.Call(), hh.Spot())
    p = float(ht.iv_to_price(opt, S, 0.02, sigma, REF, BS))
    _close(p, float(hh.iv_to_price(j_opt, S, 0.02, sigma, REF, hh.BlackScholesAnalytic())))
    sigma2 = float(ht.price_to_iv(opt, S, 0.02, p, REF, BS, iv_guess=sigma))
    assert sigma2 == pytest.approx(sigma, rel=1e-8, abs=1e-10)
    _close(sigma2, float(hh.price_to_iv(j_opt, S, 0.02, p, REF, hh.BlackScholesAnalytic(),
                                        iv_guess=sigma)))


def test_underlying_observations():
    r = 0.02
    T = ht.yearfrac(REF, EXP)
    D = math.exp(-r * T)
    assert float(ht.underlying_spot(ht.SpotObs(100.0), r, REF, EXP)) == 100.0
    assert float(ht.underlying_forward(ht.SpotObs(100.0), r, REF, EXP)) == pytest.approx(100.0 / D)
    assert float(ht.underlying_spot(ht.ForwardObs(105.0), r, REF, EXP)) == pytest.approx(105.0 * D)
    assert float(ht.underlying_forward(ht.ForwardObs(105.0), r, REF, EXP)) == 105.0
    assert float(ht.underlying_spot(ht.FuturesObs(105.0), r, REF, EXP)) == pytest.approx(105.0 * D)
    for obs in ("SpotObs", "ForwardObs", "FuturesObs"):
        for fn in ("underlying_spot", "underlying_forward"):
            _close(getattr(ht, fn)(getattr(ht, obs)(105.0), r, REF, EXP, ht.Thirty360E()),
                   getattr(hh, fn)(getattr(hh, obs)(105.0), r, REF, EXP, hh.Thirty360E()))


def test_normalization_is_price_over_F():
    und = ht.SpotObs(100.0)
    vq = ht.VolQuote.build(OPT, und, 0.02, mid_iv=0.4, reference_date=REF, config=CFG)
    p_abs = float(vq.iv_to_price(0.4, normalize=False))
    F = float(ht.underlying_forward(und, 0.02, REF, EXP))
    assert float(vq.iv_to_price(0.4, normalize=True)) == pytest.approx(p_abs / F, rel=1e-12)
    j = hh.VolQuote.build(J_OPT, hh.SpotObs(100.0), 0.02, mid_iv=0.4, reference_date=REF)
    _close(vq.iv_to_price(0.4), j.iv_to_price(0.4))
    _close(vq.price_to_iv(p_abs), j.price_to_iv(p_abs))


def test_monotonicity_warnings():
    cfg = _cfg(iv_monotonicity_handling="warn", price_monotonicity_handling="warn")
    with pytest.warns(UserWarning) as record:
        port = ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, bid_iv=0.25, mid_iv=0.24,
                                 ask_iv=0.23, reference_date=REF, config=cfg)
    msgs = " | ".join(str(w.message) for w in record)
    assert "Price monotonicity" in msgs and "IV monotonicity" in msgs
    with pytest.warns(UserWarning):
        ref = hh.VolQuote.build(J_OPT, hh.SpotObs(100.0), 0.02, bid_iv=0.25, mid_iv=0.24,
                                ask_iv=0.23, reference_date=REF)
    _close(_quote_fields(port), _quote_fields(ref))


def test_monotonicity_throw_policy():
    with pytest.raises(ValueError, match="IV monotonicity"):
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, bid_iv=0.25, mid_iv=0.24, ask_iv=0.23,
                          reference_date=REF, config=_cfg(iv_monotonicity_handling="throw"))


def test_nan_storage_policy():
    vq, ref = _build_both(mid_iv=0.3)
    assert math.isnan(vq.bid_price) and math.isnan(vq.bid_iv)
    assert math.isnan(vq.ask_price) and math.isnan(vq.ask_iv)
    assert vq.mid_iv == 0.3 and vq.mid_price > 0
    _close(_quote_fields(vq), _quote_fields(ref))


def test_inconsistency_policies():
    p_consistent = float(ht.iv_to_price(OPT, 100.0, 0.02, 0.3, REF, BS))
    _close(p_consistent, float(hh.iv_to_price(J_OPT, 100.0, 0.02, 0.3, REF)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p_consistent, mid_iv=0.3,
                          reference_date=REF, config=CFG)
    with pytest.warns(UserWarning, match="Inconsistent price/IV"):
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p_consistent * 1.1,
                          mid_iv=0.3, reference_date=REF, config=CFG)
    with pytest.raises(ValueError, match="Inconsistent price/IV"):
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p_consistent * 1.1,
                          mid_iv=0.3, reference_date=REF,
                          config=_cfg(vol_price_inconsistency_handling="throw"))
    vq = ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p_consistent * 1.1,
                           mid_iv=0.3, reference_date=REF,
                           config=_cfg(vol_price_inconsistency_handling="ignore"))
    assert vq.mid_price == pytest.approx(p_consistent * 1.1)


def test_missing_mid_policy():
    with pytest.raises(ValueError, match="at least one of mid_price or mid_iv"):
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, reference_date=REF, config=CFG)
    with pytest.warns(UserWarning):
        vq = ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, reference_date=REF,
                               config=_cfg(missing_mid_handling="warn"))
    assert all(math.isnan(x) for x in _quote_fields(vq))


def test_input_validation():
    with pytest.raises(ValueError, match="Expiry"):
        ht.VolQuote.build(ht.VanillaOption(100.0, dt.date(2024, 1, 1), ht.European(), ht.Call(),
                                           ht.Spot()),
                          ht.SpotObs(100.0), 0.02, mid_iv=0.3, reference_date=REF, config=CFG)
    with pytest.raises(ValueError, match="positive"):
        ht.VolQuote.build(OPT, ht.SpotObs(-5.0), 0.02, mid_iv=0.3, reference_date=REF, config=CFG)
    with pytest.raises(ValueError, match="must be one of"):
        ht.VolQuoteConfig(vol_price_inconsistency_handling="explode")
    with pytest.warns(UserWarning, match="unrealistic"):
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 1.5, mid_iv=0.3, reference_date=REF, config=CFG)


def test_normalized_input_prices():
    und = ht.SpotObs(100.0)
    F = float(ht.underlying_forward(und, 0.02, REF, EXP))
    p_abs = float(ht.iv_to_price(OPT, 100.0, 0.02, 0.25, REF, BS))
    vq, ref = _build_both(mid_price=p_abs / F, config=_cfg(normalized_input=True),
                          j_config=hh.VolQuoteConfig(normalized_input=True))
    assert vq.mid_price == pytest.approx(p_abs, rel=1e-12)
    assert vq.mid_iv == pytest.approx(0.25, abs=1e-10)
    _close(_quote_fields(vq), _quote_fields(ref))


def test_price_to_iv_with_carr_madan_model():
    """iv_model can be any pricing method: the root find runs through the
    Fourier pricer (CalibrationProblem + RootFinderAlgo)."""
    method = ht.CarrMadan(1.0, 16.0, ht.LognormalDynamics(), device="cpu")
    j_method = hh.CarrMadan(1.0, 16.0, hh.LognormalDynamics())
    p = float(ht.iv_to_price(OPT, 100.0, 0.02, 0.35, REF, method))
    _close(p, float(hh.iv_to_price(J_OPT, 100.0, 0.02, 0.35, REF, j_method)))
    iv = float(ht.price_to_iv(OPT, 100.0, 0.02, p, REF, method))
    assert iv == pytest.approx(0.35, abs=1e-8)
    _close(iv, float(hh.price_to_iv(J_OPT, 100.0, 0.02, p, REF, j_method)))
    cfg = _cfg(iv_model=method)
    vq = ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p, reference_date=REF,
                           config=cfg)
    assert vq.mid_iv == pytest.approx(0.35, abs=1e-8) and vq.iv_model == method


def test_daycount_30e360_roundtrip_matches_independent_tau():
    """A 30E/360-quoted surface resolves on the market's τ (exactly 0.5 here),
    not ACT/365's; the oracle price is the plain BS formula on that τ."""
    dc = ht.Thirty360E()
    tau = 0.5
    assert abs(tau - float(ht.yearfrac(REF, EXP))) > 3e-3
    S, K, r, sigma = 100.0, 100.0, 0.02, 0.25
    D = math.exp(-r * tau)
    sq = sigma * math.sqrt(tau)
    d1 = (math.log(S / D / K) + 0.5 * sq * sq) / sq
    oracle = D * (S / D * norm.cdf(d1) - K * norm.cdf(d1 - sq))
    p = float(ht.iv_to_price(OPT, S, r, sigma, REF, BS, daycount=dc))
    assert p == pytest.approx(oracle, rel=1e-12)
    assert float(ht.price_to_iv(OPT, S, r, p, REF, BS, daycount=dc)) == pytest.approx(sigma,
                                                                                      abs=1e-10)
    iv_wrong = float(ht.price_to_iv(OPT, S, r, p, REF, BS))
    assert abs(iv_wrong - sigma) > 5e-4
    _close(iv_wrong, float(hh.price_to_iv(J_OPT, S, r, p, REF)))


def test_daycount_volquote_build_and_helpers():
    dc = ht.Thirty360E()
    cfg = _cfg(daycount=dc)
    sigma = 0.3
    p = float(ht.iv_to_price(OPT, 100.0, 0.02, sigma, REF, BS, daycount=dc))
    vq = ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p, reference_date=REF,
                           config=cfg)
    assert vq.daycount == dc
    assert vq.mid_iv == pytest.approx(sigma, abs=1e-10)
    assert float(vq.price_to_iv(p)) == pytest.approx(sigma, abs=1e-10)
    F = float(ht.underlying_forward(ht.SpotObs(100.0), 0.02, REF, EXP, dc))
    assert float(vq.iv_to_price(sigma)) == pytest.approx(p / F, rel=1e-12)
    ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p, mid_iv=sigma, reference_date=REF,
                      config=_cfg(daycount=dc, vol_price_inconsistency_handling="throw"))
    with pytest.raises(ValueError, match="Inconsistent"):
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_price=p, mid_iv=sigma,
                          reference_date=REF, config=_cfg(vol_price_inconsistency_handling="throw"))


def test_from_reference_carries_quotes_and_config():
    j_cfg = hh.VolQuoteConfig(daycount=hh.Thirty360E(), missing_mid_handling="warn")
    cfg = ht.from_reference(j_cfg)
    assert cfg.daycount == ht.Thirty360E() and cfg.missing_mid_handling == "warn"
    assert cfg.iv_model == ht.BlackScholesAnalytic()  # the GPU by default
    for obs in ("SpotObs", "ForwardObs", "FuturesObs"):
        assert ht.from_reference(getattr(hh, obs)(101.5)) == getattr(ht, obs)(101.5)


# ------------------------------------------------------------ batches


def _expiry(yf):
    return ht.add_yearfrac(ht.to_ticks(dt.date(2024, 1, 1)), yf)


def _resolve_both(strikes, expiries, und, r, ref, config=None, j_config=None, **levels):
    port = ht.resolve_quotes_batch(strikes, expiries, getattr(ht, und[0])(und[1]), r, ref,
                                   config=config or CFG, **levels)
    j_levels = {k: jnp.asarray(v) for k, v in levels.items()}
    j_exp = expiries if isinstance(expiries, list) else jnp.asarray(expiries)
    want = hh.resolve_quotes_batch(jnp.asarray(strikes), j_exp, getattr(hh, und[0])(und[1]), r,
                                   ref, config=j_config, **j_levels)
    return port, want


def _assert_resolved_close(port, want):
    for name in ("bid_price", "mid_price", "ask_price", "bid_iv", "mid_iv", "ask_iv"):
        got, ref = getattr(port, name), np.asarray(getattr(want, name))
        assert np.array_equal(np.isnan(got.numpy()), np.isnan(ref)), name
        _close(got, ref)


def test_batch_matches_scalar_build_and_reference():
    """A 3×4 grid with missing bids and asks resolves as twelve scalar
    builds (rel 1e-6 / abs 1e-8, the JAX test's limits) and as JAX's batch
    (1e-10)."""
    ref = dt.date(2024, 1, 1)
    strikes = np.array([90.0, 100.0, 110.0, 120.0])
    tenors = np.array([0.25, 1.0, 2.0])
    spot, r = 100.0, 0.03
    K, Tg = np.meshgrid(strikes, tenors)
    expiries = np.vectorize(_expiry)(Tg)
    true_iv = 0.2 + 0.05 * (K / spot - 1.0)
    mid_price = ht.iv_to_price_bs(torch.from_numpy(true_iv), torch.from_numpy(K),
                                  torch.from_numpy(Tg), spot, r).numpy()
    bid_iv = true_iv - 0.01
    ask_price = mid_price * 1.02
    bid_iv[0, 0] = NAN
    ask_price[2, 3] = NAN
    port, want = _resolve_both(K, expiries, ("SpotObs", spot), r, ref, mid_price=mid_price,
                               bid_iv=bid_iv, ask_price=ask_price)
    _assert_resolved_close(port, want)
    for i in range(3):
        for j in range(4):
            payoff = ht.VanillaOption(float(K[i, j]), float(expiries[i, j]), ht.European(),
                                      ht.Call(), ht.Spot())
            q = ht.VolQuote.build(payoff, ht.SpotObs(spot), r, mid_price=float(mid_price[i, j]),
                                  bid_iv=float(bid_iv[i, j]), ask_price=float(ask_price[i, j]),
                                  reference_date=ref, config=CFG)
            for got, w in ((port.mid_iv[i, j], q.mid_iv), (port.bid_price[i, j], q.bid_price),
                           (port.ask_iv[i, j], q.ask_iv), (port.mid_price[i, j], q.mid_price)):
                if math.isnan(w):
                    assert math.isnan(float(got)), (i, j)
                else:
                    assert float(got) == pytest.approx(w, rel=1e-6, abs=1e-8), (i, j)


def test_batch_normalized_input():
    ref = dt.date(2024, 1, 1)
    strikes = np.array([95.0, 105.0])
    expiries = np.array([_expiry(1.0), _expiry(1.0)])
    spot, r = 100.0, 0.05
    F = spot * math.exp(r * 1.0)
    abs_price = ht.iv_to_price_bs(0.2, torch.from_numpy(strikes), torch.ones(2, dtype=torch.float64),
                                  spot, r).numpy()
    port, want = _resolve_both(strikes, expiries, ("SpotObs", spot), r, ref,
                               config=_cfg(normalized_input=True),
                               j_config=hh.VolQuoteConfig(normalized_input=True),
                               mid_price=abs_price / F)
    np.testing.assert_allclose(port.mid_iv.numpy(), 0.2, atol=1e-8)
    _assert_resolved_close(port, want)


def test_batch_inconsistency_policy():
    ref = dt.date(2024, 1, 1)
    strikes, expiries = np.array([100.0]), np.array([_expiry(1.0)])
    with pytest.raises(ValueError, match="Inconsistent"):
        ht.resolve_quotes_batch(strikes, expiries, ht.SpotObs(100.0), 0.03, ref,
                                mid_price=np.array([8.0]), mid_iv=np.array([0.5]),
                                config=_cfg(vol_price_inconsistency_handling="throw"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ht.resolve_quotes_batch(strikes, expiries, ht.SpotObs(100.0), 0.03, ref,
                                mid_price=np.array([8.0]), mid_iv=np.array([0.5]), config=CFG)
    assert any("Inconsistent" in str(x.message) and "mid=1" in str(x.message) for x in w)


def test_batch_monotonicity_policy():
    ref = dt.date(2024, 1, 1)
    strikes, expiries = np.array([100.0]), np.array([_expiry(1.0)])
    kw = dict(bid_price=np.array([9.0]), mid_price=np.array([8.5]), ask_price=np.array([9.5]))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ht.resolve_quotes_batch(strikes, expiries, ht.SpotObs(100.0), 0.03, ref, config=CFG, **kw)
    assert any("Price monotonicity violated in 1" in str(x.message) for x in w)
    assert any("IV monotonicity violated in 1" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="Price monotonicity"):
        ht.resolve_quotes_batch(strikes, expiries, ht.SpotObs(100.0), 0.03, ref,
                                config=_cfg(price_monotonicity_handling="throw"), **kw)


def test_batch_missing_mid_policy():
    ref = dt.date(2024, 1, 1)
    strikes, expiries = np.array([100.0]), np.array([_expiry(1.0)])
    with pytest.raises(ValueError, match="neither"):
        ht.resolve_quotes_batch(strikes, expiries, ht.SpotObs(100.0), 0.03, ref,
                                bid_price=np.array([8.0]), config=CFG)
    with pytest.warns(UserWarning, match="neither"):
        ht.resolve_quotes_batch(strikes, expiries, ht.SpotObs(100.0), 0.03, ref,
                                bid_price=np.array([8.0]), config=_cfg(missing_mid_handling="warn"))


@pytest.mark.parametrize("obs", ["ForwardObs", "FuturesObs"])
def test_batch_forward_obs(obs):
    """Forward (and futures) observations resolve against S = F·D, also
    per quote."""
    ref = dt.date(2024, 1, 1)
    r = 0.05
    F = 100.0 * math.exp(r * 1.0)
    p = float(ht.iv_to_price_bs(0.25, 100.0, 1.0, 100.0, r))
    port, want = _resolve_both(np.array([100.0]), np.array([_expiry(1.0)]), (obs, F), r, ref,
                               mid_price=np.array([p]))
    assert float(port.mid_iv[0]) == pytest.approx(0.25, abs=1e-8)
    _assert_resolved_close(port, want)
    per_quote, want2 = _resolve_both(np.array([95.0, 100.0]), np.array([_expiry(1.0)] * 2),
                                     (obs, np.array([F, F * 1.01])), r, ref,
                                     mid_price=np.array([p + 3.0, p]))
    _assert_resolved_close(per_quote, want2)


def test_batch_validation_mirrors_scalar_build():
    ref = dt.date(2024, 6, 1)
    good, bad = ht.to_ticks(dt.date(2024, 12, 1)), ht.to_ticks(dt.date(2024, 1, 1))
    with pytest.raises(ValueError, match="after reference_date"):
        ht.resolve_quotes_batch(np.array([100.0, 100.0]), np.array([good, bad], dtype=np.float64),
                                ht.SpotObs(100.0), 0.03, ref, mid_price=np.array([5.0, 5.0]),
                                config=CFG)
    with pytest.raises(ValueError, match="positive"):
        ht.resolve_quotes_batch(np.array([100.0]), np.array([good], dtype=np.float64),
                                ht.SpotObs(-1.0), 0.03, ref, mid_price=np.array([5.0]), config=CFG)
    with pytest.raises(TypeError, match="BlackScholesAnalytic"):
        ht.resolve_quotes_batch(np.array([100.0]), np.array([good], dtype=np.float64),
                                ht.SpotObs(100.0), 0.03, ref, mid_price=np.array([5.0]),
                                config=_cfg(iv_model=ht.CarrMadan(1.0, 16.0, ht.LognormalDynamics(),
                                                                   device="cpu")))


def test_batch_daycount_30e360():
    """IVs recovered from prices on the convention's τ (exact 30E/360
    fractions), and the default convention's resolution of the same prices
    disagrees."""
    dc = ht.Thirty360E()
    expiries = [dt.date(2025, 4, 1), dt.date(2025, 7, 1)]
    taus = np.array([90 / 360.0, 180 / 360.0])
    strikes = np.array([95.0, 100.0, 110.0])
    sigmas = np.array([[0.2, 0.25, 0.3], [0.22, 0.27, 0.32]])
    TT = np.broadcast_to(taus[:, None], sigmas.shape)
    KK = np.broadcast_to(strikes[None, :], sigmas.shape)
    prices = ht.iv_to_price_bs(torch.from_numpy(sigmas), torch.from_numpy(KK.copy()),
                               torch.from_numpy(TT.copy()), 100.0, 0.02).numpy()
    ticks = np.broadcast_to(np.array([float(ht.to_ticks(e)) for e in expiries])[:, None],
                            sigmas.shape).copy()
    port, want = _resolve_both(KK.copy(), ticks, ("SpotObs", 100.0), 0.02, REF,
                               config=_cfg(daycount=dc),
                               j_config=hh.VolQuoteConfig(daycount=hh.Thirty360E()),
                               mid_price=prices)
    np.testing.assert_allclose(port.mid_iv.numpy(), sigmas, atol=1e-10)
    _assert_resolved_close(port, want)
    wrong = ht.resolve_quotes_batch(KK.copy(), ticks, ht.SpotObs(100.0), 0.02, REF,
                                    mid_price=prices, config=CFG)
    assert float(torch.max(torch.abs(wrong.mid_iv - torch.from_numpy(sigmas)))) > 5e-4


def test_mixed_convention_surface_ingestion():
    """An ACT/360 money-market short end and a 30E/360 long end, each bucket
    resolved under its convention against independently computed τ, and
    the policies where a pair is consistent only under the right one."""
    S, r = 100.0, 0.02
    exp_short, exp_long = dt.date(2025, 2, 1), dt.date(2026, 1, 1)
    tau_short, tau_long = 31 / 360.0, 1.0

    def bs(K, sigma, tau):
        D = math.exp(-r * tau)
        sq = sigma * math.sqrt(tau)
        d1 = (math.log(S / D / K) + 0.5 * sq * sq) / sq
        return D * (S / D * norm.cdf(d1) - K * norm.cdf(d1 - sq))

    strikes = np.array([95.0, 105.0])
    sig_short, sig_long = np.array([0.32, 0.28]), np.array([0.26, 0.24])
    p_short = np.array([bs(k, s, tau_short) for k, s in zip(strikes, sig_short)])
    p_long = np.array([bs(k, s, tau_long) for k, s in zip(strikes, sig_long)])
    res_s, want_s = _resolve_both(strikes, [exp_short] * 2, ("SpotObs", S), r, REF,
                                  config=_cfg(daycount=ht.Act360()),
                                  j_config=hh.VolQuoteConfig(daycount=hh.Act360()),
                                  mid_price=p_short)
    res_l = ht.resolve_quotes_batch(strikes, [exp_long] * 2, ht.SpotObs(S), r, REF,
                                    mid_price=p_long, config=_cfg(daycount=ht.Thirty360E()))
    np.testing.assert_allclose(res_s.mid_iv.numpy(), sig_short, atol=1e-8)
    np.testing.assert_allclose(res_l.mid_iv.numpy(), sig_long, atol=1e-8)
    _assert_resolved_close(res_s, want_s)
    wrong = ht.resolve_quotes_batch(strikes, [exp_short] * 2, ht.SpotObs(S), r, REF,
                                    mid_price=p_short, config=CFG)
    assert np.all(np.abs(wrong.mid_iv.numpy() - sig_short) > 2e-4)
    with pytest.raises(ValueError, match="[Ii]nconsisten"):
        ht.resolve_quotes_batch(strikes, [exp_short] * 2, ht.SpotObs(S), r, REF,
                                mid_price=p_short, mid_iv=sig_short,
                                config=_cfg(vol_price_inconsistency_handling="throw"))
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        ht.resolve_quotes_batch(strikes, [exp_short] * 2, ht.SpotObs(S), r, REF,
                                mid_price=p_short, mid_iv=sig_short,
                                config=_cfg(daycount=ht.Act360(),
                                            vol_price_inconsistency_handling="throw"))
    assert not any("nconsisten" in str(x.message) for x in w2)


def test_quote_entry_points_ask_for_the_gpu():
    """With no device the conversions and the batch ask for the GPU: without
    one they raise in resolve_device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.price_to_iv(OPT, 100.0, 0.02, 5.0, REF)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.resolve_quotes_batch(np.array([100.0]), [EXP], ht.SpotObs(100.0), 0.02, REF,
                                mid_price=np.array([5.0]))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.VolQuote.build(OPT, ht.SpotObs(100.0), 0.02, mid_iv=0.3, reference_date=REF)


# ------------------- RectVolSurface price-ctor parity -------------------


def test_surface_ctor_curve_rates():
    """A non-flat RateCurve: each tenor's own zero rate, against per-point
    scalar inversion (abs 1e-7) and the JAX constructor (1e-10)."""
    ref = dt.date(2024, 1, 1)
    tenors, strikes, spot = [0.5, 1.0, 2.0], [90.0, 100.0, 110.0], 100.0
    rates = np.array([0.02, 0.03, 0.045])
    true_vols = np.array([[0.25, 0.2, 0.22], [0.24, 0.21, 0.23], [0.26, 0.22, 0.24]])
    prices = np.array([[float(ht.iv_to_price_bs(true_vols[i, j], K, T, spot, rates[i]))
                        for j, K in enumerate(strikes)] for i, T in enumerate(tenors)])
    curve = ht.RateCurve(ht.to_ticks(ref), torch.tensor(tenors, dtype=torch.float64),
                         torch.from_numpy(rates))
    surf = ht.rect_vol_surface_from_prices(ref, curve, spot, tenors, strikes,
                                           torch.from_numpy(prices))
    j_surf = hh.rect_vol_surface_from_prices(
        ref, hh.RateCurve(hh.to_ticks(ref), jnp.asarray(tenors), jnp.asarray(rates)), spot,
        tenors, strikes, jnp.asarray(prices))
    for i, T in enumerate(tenors):
        for j, K in enumerate(strikes):
            got = float(ht.get_vol_yf(surf, T, K))
            assert got == pytest.approx(true_vols[i, j], abs=1e-7), (i, j)
            _close(got, float(hh.get_vol_yf(j_surf, T, K)))


def test_surface_ctor_date_tenors():
    ref = dt.date(2024, 1, 1)
    dates = [dt.date(2024, 7, 1), dt.date(2025, 1, 1)]
    yfs = [ht.yearfrac(ref, d) for d in dates]
    strikes, spot, r = [95.0, 105.0], 100.0, 0.03
    prices = torch.tensor([[float(ht.iv_to_price_bs(0.2, K, T, spot, r)) for K in strikes]
                           for T in yfs], dtype=torch.float64)
    surf_dates = ht.rect_vol_surface_from_prices(ref, r, spot, dates, strikes, prices)
    surf_yfs = ht.rect_vol_surface_from_prices(ref, r, spot, yfs, strikes, prices)
    for T in yfs:
        for K in strikes:
            assert float(ht.get_vol_yf(surf_dates, T, K)) == pytest.approx(
                float(ht.get_vol_yf(surf_yfs, T, K)), abs=1e-12)


@pytest.mark.parametrize("module, top_level", [
    ("market.vol_quotes", True), ("market.svi", True), ("math.besseli", False),
    ("distributions.sample_from_cf", False), ("distributions.broadie_kaya", False)])
def test_slice_module_exports_the_reference_names(module, top_level):
    """Each module of the slice exports the JAX module's names; the quote
    and SVI names are the package's too, as ``hh.*`` has them."""
    import importlib

    ref = importlib.import_module(f"hedgehog_tpu.{module}")
    port = importlib.import_module(f"hedgehog_tpu_torch.{module}")
    assert set(ref.__all__) <= set(port.__all__), set(ref.__all__) - set(port.__all__)
    if top_level:
        assert set(ref.__all__) <= set(ht.__all__), set(ref.__all__) - set(ht.__all__)
        for name in ref.__all__:
            assert getattr(ht, name) is getattr(port, name) and hasattr(hh, name)
    assert "HestonBroadieKaya" in ht.__all__ and ht.HestonBroadieKaya().cf_terms == 128
