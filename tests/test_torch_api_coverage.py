"""Export parity of the port (the counterpart of tests/unit/test_api_coverage.py):
every name in ``hedgehog_tpu_torch.__all__`` resolves, and every name of
``hedgehog_tpu.__all__`` the port lacks stands in ``NOT_YET_PORTED`` beside
the ROADMAP.md Queue 1 item that will port it.  The list must equal the
gap exactly: a name that goes missing fails, and so does a ported name
left on the list (the list shrinks with each slice)."""

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

#: ROADMAP.md Queue 1 item → the JAX export names it ports
NOT_YET_PORTED = {
    "8.3 rates": (
        "ZeroCouponBond", "BondOption", "Caplet", "CapFloor", "Swaption", "HullWhiteInputs",
        "HullWhiteAnalytic", "HullWhiteGrid", "HullWhiteMonteCarlo", "hw_zbo_price",
        "HestonHullWhiteInputs", "HestonHullWhiteDynamics"),
    "8.4 multi-asset": (
        "SpreadOption", "BasketOption", "RainbowOption", "MultiAssetBSInputs",
        "MultiAssetHestonInputs", "quanto_dividend_yield", "margrabe_price", "kirk_spread_price",
        "geometric_basket_price", "rainbow_prices", "stulz_min_call_price"),
    "8.5 VIX": ("VIXFuture", "VIXOption", "VIXAnalytic", "vix_future_price", "vix_option_price"),
    "10 export parity": ("AbstractMarketInputs",),
}


def test_port_exports_resolve():
    unresolved = [name for name in ht.__all__ if getattr(ht, name, None) is None]
    assert not unresolved
    assert len(ht.__all__) == len(set(ht.__all__)), "a name is exported twice"


def test_missing_exports_are_listed_with_their_roadmap_item():
    listed = [n for names in NOT_YET_PORTED.values() for n in names]
    assert len(listed) == len(set(listed)), "a name is listed twice"
    gap = set(hh.__all__) - set(ht.__all__)
    assert not gap - set(listed), f"exports missing from the port and from the list: {gap - set(listed)}"
    assert not set(listed) - gap, f"ported, take them off the list: {set(listed) - gap}"


def test_this_slice_exports_where_the_reference_does():
    for name in ("MertonInputs", "KouInputs", "VarianceGammaInputs", "BatesInputs",
                 "MertonJumpDynamics", "KouJumpDynamics", "VarianceGammaDynamics",
                 "BatesDynamics", "MertonExact", "KouExact", "VarianceGammaExact",
                 "MertonAnalytic", "carr_madan_error_estimate", "heston_cf", "lognormal_cf",
                 "market_yearfrac", "carry_yield",
                 "BachelierInputs", "BachelierAnalytic", "BachelierExact", "NormalDynamics",
                 "bachelier_price", "implied_normal_vol", "CEVInputs", "CEVAnalytic",
                 "CEVDynamics", "cev_call_price", "cev_survival", "ncx2_cdf", "SABRInputs",
                 "SABRAnalytic", "SABRDynamics", "hagan_vol", "LocalVolDynamics",
                 "dupire_local_vol", "SLVInputs", "SLVDynamics", "LeverageSurface",
                 "calibrate_leverage", "leverage_at"):
        assert name in hh.__all__ and name in ht.__all__, name
