"""Export parity of the port (the counterpart of tests/unit/test_api_coverage.py):
every name in ``hedgehog_tpu_torch.__all__`` resolves, and every name of
``hedgehog_tpu.__all__`` the port lacks stands in ``NOT_YET_PORTED`` beside
the ROADMAP.md Queue 1 item that will port it.  The list must equal the
gap exactly: a name that goes missing fails, and so does a ported name
left on the list.  The list is empty: the port exports every name of the
reference, and every market-input container subclasses
``AbstractMarketInputs``."""

import importlib

import pytest

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht

#: ROADMAP.md Queue 1 item → the JAX export names it ports (empty: the port
#: exports every name of the reference)
NOT_YET_PORTED = {}


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
                 "calibrate_leverage", "leverage_at",
                 "ZeroCouponBond", "BondOption", "Caplet", "CapFloor", "Swaption",
                 "HullWhiteInputs", "HullWhiteAnalytic", "HullWhiteGrid", "HullWhiteMonteCarlo",
                 "hw_zbo_price", "HestonHullWhiteInputs", "HestonHullWhiteDynamics",
                 "SpreadOption", "BasketOption", "RainbowOption", "MultiAssetBSInputs",
                 "MultiAssetHestonInputs", "quanto_dividend_yield", "margrabe_price",
                 "kirk_spread_price", "geometric_basket_price", "rainbow_prices",
                 "stulz_min_call_price", "VIXFuture", "VIXOption", "VIXAnalytic",
                 "vix_future_price", "vix_option_price", "AbstractMarketInputs"):
        assert name in hh.__all__ and name in ht.__all__, name


def test_every_market_inputs_class_subclasses_the_abstract_base():
    """Every market-input container of the port (each class of
    market/inputs.py named ``*Inputs``) is an ``AbstractMarketInputs``, as in
    the reference, and every reference container has its counterpart."""
    import inspect

    from hedgehog_tpu.market import inputs as jinputs
    from hedgehog_tpu_torch.market import inputs as pinputs

    def containers(mod):
        return {name: cls for name, cls in vars(mod).items()
                if inspect.isclass(cls) and name.endswith("Inputs") and cls.__module__ == mod.__name__}

    port = containers(pinputs)
    assert set(containers(jinputs)) <= set(port)
    for name, cls in port.items():
        assert issubclass(cls, ht.AbstractMarketInputs), name


@pytest.mark.parametrize("module", ["parallel", "utils.checkpoint", "utils.profiling"])
def test_submodule_exports_exist_in_the_port(module):
    """Every name of the JAX submodule's ``__all__`` is in the port's module
    of the same path."""
    ref = importlib.import_module(f"hedgehog_tpu.{module}")
    port = importlib.import_module(f"hedgehog_tpu_torch.{module}")
    missing = [name for name in ref.__all__ if getattr(port, name, None) is None]
    assert not missing
    assert set(ref.__all__) <= set(port.__all__)
