"""hedgehog_tpu_torch — the PyTorch/CUDA port of hedgehog_tpu.

The JAX package ``hedgehog_tpu`` stays the reference; this package ports it
slice by slice and keeps its module tree and public names.  It prices a
European vanilla under Heston, Black-Scholes or rough Bergomi by Monte
Carlo through ``solve(PricingProblem(...), MonteCarlo(...))``, and the
path-dependent and exotic payoffs (digital, barrier, double barrier, Asian,
lookback, forward start, cliquet, autocallable, variance swap, compound,
chooser) through the closed forms, the Carr–Madan digital and the
Brownian-bridge grid estimators, with
hand-written CUDA kernels for the Euler, exact-mixing, QE-mixing and QE-M
schemes and the exact lognormal draw (``ops/``, sources in ``csrc/``), checked against the
Carr–Madan Fourier price, and its 7-parameter greek vector
(``heston_mixing_price_and_greeks``, the greek kernel, or
``torch.autograd.grad`` through ``solve``), and whole (expiry × strike)
surfaces from one variance simulation (``heston_surface_mc``; the surface
kernels and their Jacobian through ``ops.heston_qe_kernel
.heston_surface_mc_adapter``); the rough-Bergomi mixing estimator
(``RoughBergomiMixing``) with its kernels for values, the serving price,
the price + 6-greek vector, the values' backward (bucketed
forward-variance vegas included) and the one-simulation smile
(``ops.rbergomi_kernel``), and its float64 (expiry × strike) surface
(``rbergomi_surface_mc``).  Greeks and calibration run through lenses
(``GreekProblem``, ``BatchGreekProblem``, ``CalibrationProblem`` solved by
bounded L-BFGS or a bracketed root) over interpolated rate curves and
rectangular vol surfaces.  ``MonteCarlo``, ``CarrMadan``,
``BlackScholesAnalytic`` and the kernel wrappers run on the GPU unless the
caller asks for ``device="cpu"``.  Early exercise: the Cox-Ross-Rubinstein
lattice (``CoxRossRubinsteinMethod``), Longstaff-Schwartz (``LSM``) over
the Monte Carlo grids (``simulate_price_grid``; the conditional Heston
bridge with the joint (S, V) basis) and its Andersen-Broadie dual bound
(``lsm_dual_bound``), for American and Bermudan vanillas, and the lattice
and LSM for American, Bermudan and European single barriers (knock-outs
with bridge-corrected edges or survival factors, knock-ins by parity or
the hit-time quadrature), on the GPU too; the 1-D finite-difference engine
(``PDEMethod``) prices vanillas, digitals and barriers with early
exercise.  Discrete cash dividends (``DividendSchedule`` on
``BlackScholesInputs``) price in the escrowed convention on the
terminal-law engines and in the spot model on the PDE and the log-Euler
grid.
The exact-mixing estimator's greeks (``heston_exact_price_and_greeks``, or
AD through ``solve``) carry the likelihood-ratio term of its Poisson
counts.
Market quotes resolve through ``VolQuote`` and ``resolve_quotes_batch``
(bid/mid/ask prices and implied vols under their policies), smiles fit to
raw-SVI slices (``calibrate_svi_slices``, ``SVIVolSurface``), and
``HestonBroadieKaya`` samples Heston terminals exactly (complex128 on the
card).  ``PDEMethod(HestonDynamics())`` is the Heston 2-D Craig–Sneyd ADI
solver.  The jump and variance-gamma families (``MertonJumpDynamics``,
``KouJumpDynamics``, ``VarianceGammaDynamics``, ``BatesDynamics`` on their
inputs) price through Carr–Madan (panel or Gauss–Legendre quadrature, the
FFT smile, ``carr_madan_error_estimate``), ``MertonAnalytic``, the exact
samplers ``MertonExact``, ``KouExact`` and ``VarianceGammaExact``, their
Euler grids (LSM, Asians) and the Bates mixing estimator.  The normal and
local-vol families price through ``BachelierAnalytic`` (and
``implied_normal_vol``), ``CEVAnalytic`` (``ncx2_cdf``, differentiable in
β), ``SABRAnalytic`` (``hagan_vol``), ``BachelierExact`` and the Euler grids
of ``NormalDynamics``, ``CEVDynamics``, ``SABRDynamics``,
``LocalVolDynamics`` (``dupire_local_vol`` per path) and ``SLVDynamics``
(on a leverage from ``calibrate_leverage``), and the PDE under the CEV and
local-vol dynamics.  Rates: the Hull-White closed forms (bonds, bond
options, caplets, caps, Jamshidian swaptions; ``HullWhiteAnalytic``), its
exact short-rate Monte Carlo (``HullWhiteMonteCarlo``, Bermudan swaptions by
Longstaff–Schwartz) and x-grid induction (``HullWhiteGrid``), and the
Heston-Hull-White mixing estimator (``HestonHullWhiteDynamics``).
Multi-asset: spread, basket and rainbow options on correlated
Black-Scholes markets (Margrabe, Kirk, the geometric basket, Stulz, and the
correlated terminal draw) and correlated Heston markets (Monte Carlo).  VIX
futures and options under Heston and Bates (``VIXAnalytic``).
Deterministic layers run in float64; the kernels and their plain twins in
float32.  Importing the package imports no jax and builds nothing.
"""

from .core.dates import (
    ACT365F,
    MILLISECONDS_IN_DAY,
    MILLISECONDS_IN_YEAR_365,
    SECONDS_IN_YEAR_365,
    Act360,
    Act365Fixed,
    Act36525,
    ActActISDA,
    DayCount,
    Thirty360E,
    add_yearfrac,
    ticks_to_datetime,
    to_ticks,
    yearfrac,
)
from .core.payoffs import (
    American,
    ArithmeticAverage,
    AsianOption,
    Autocallable,
    BarrierOption,
    BasketOption,
    Bermudan,
    BondOption,
    Call,
    CapFloor,
    Caplet,
    ChooserOption,
    Cliquet,
    CompoundOption,
    DigitalOption,
    DoubleBarrierOption,
    Down,
    European,
    FixedStrike,
    FloatingStrike,
    Forward,
    ForwardStartOption,
    GeometricAverage,
    KnockIn,
    KnockOut,
    LookbackOption,
    Put,
    RainbowOption,
    Spot,
    SpreadOption,
    Swaption,
    Up,
    VanillaOption,
    VarianceSwap,
    ZeroCouponBond,
    parity_transform,
)
from .core.lenses import (
    FieldLens,
    Lens,
    SpotLens,
    VolLens,
    ZeroRateSpineLens,
    lens_get,
    lens_set,
)
from .core.problems import (
    AnalyticSolution,
    BasketPricingProblem,
    BasketPricingSolution,
    CarrMadanSolution,
    CRRSolution,
    LSMSolution,
    MonteCarloSolution,
    PDESolution,
    PricingProblem,
)
from .core.solve import AbstractPricingMethod, register_solver, solve
from .market.dividends import DividendSchedule, dividend_pv, escrowed_spot
from .market.inputs import (
    AbstractMarketInputs,
    BachelierInputs,
    BatesInputs,
    BlackScholesInputs,
    CEVInputs,
    HestonHullWhiteInputs,
    HestonInputs,
    HullWhiteInputs,
    KouInputs,
    MertonInputs,
    MultiAssetBSInputs,
    MultiAssetHestonInputs,
    RoughBergomiInputs,
    SABRInputs,
    SLVInputs,
    VarianceGammaInputs,
    carry_yield,
    forward_spot,
    market_yearfrac,
    quanto_dividend_yield,
)
from .market.rate_curve import (
    FlatRateCurve,
    RateCurve,
    df,
    df_yf,
    forward_rate,
    is_flat,
    spine_tenors,
    spine_zeros,
    zero_rate,
    zero_rate_yf,
)
from .market.svi import (
    SVIVolSurface,
    calibrate_svi_slices,
    check_svi_arbitrage,
    svi_butterfly_margin,
    svi_calendar_margin,
    svi_total_variance,
)
from .market.vol_quotes import (
    ForwardObs,
    FuturesObs,
    ResolvedQuotes,
    SpotObs,
    VolQuote,
    VolQuoteConfig,
    iv_to_price,
    price_to_iv,
    resolve_quotes_batch,
    underlying_forward,
    underlying_spot,
)
from .market.vol_surface import (
    FlatVolSurface,
    Interpolator2D,
    RectVolSurface,
    get_vol,
    get_vol_yf,
    spine_strikes,
    spine_vols,
    surface_spine_tenors,
)
from .math.bvn import bvn_cdf
from .math.interpolation import INTERP_KINDS, interp1d, interp2d_nested
from .math.optimize import LBFGSResult, argmin_ift, minimize_lbfgs
from .math.rootfind import RootResult, bisect_root, implicit_root, implicit_root_full
from .greeks.greeks import (
    AnalyticGreek,
    BatchGreekProblem,
    FDBackward,
    FDCentral,
    FDForward,
    FiniteDifference,
    ForwardAD,
    GreekMethod,
    GreekProblem,
    GreekResult,
    ReverseAD,
    SecondOrderGreekProblem,
)
from .calibration.implied import (
    implied_vol,
    implied_vol_bs,
    iv_to_price_bs,
    rect_vol_surface_from_prices,
)
from .calibration.calibration import (
    CalibrationProblem,
    CalibrationSolution,
    OptimizerAlgo,
    RootFinderAlgo,
)
from .methods.bachelier import BachelierAnalytic, bachelier_price, implied_normal_vol
from .methods.black_scholes import BlackScholesAnalytic
from .methods.carr_madan import CarrMadan, carr_madan_error_estimate
from .methods.cev import CEVAnalytic, cev_call_price, cev_survival, ncx2_cdf
from .methods.crr import CoxRossRubinsteinMethod
from .methods.duality import DualBound, lsm_dual_bound
from .methods.lsm import LSM
from .methods.merton import MertonAnalytic
from .methods.pde import PDEMethod
from .methods.sabr import SABRAnalytic, hagan_vol
from .methods.hull_white import HullWhiteAnalytic, HullWhiteGrid, HullWhiteMonteCarlo, hw_zbo_price
from .methods.multi_asset import (
    geometric_basket_price,
    kirk_spread_price,
    margrabe_price,
    rainbow_prices,
    stulz_min_call_price,
)
from .methods.vix import VIXAnalytic, VIXFuture, VIXOption, vix_future_price, vix_option_price
from .methods.montecarlo import (
    Antithetic,
    BachelierExact,
    BlackScholesExact,
    EulerMaruyama,
    HestonBroadieKaya,
    HestonExactMixing,
    HestonQE,
    KouExact,
    MertonExact,
    MonteCarlo,
    NoVarianceReduction,
    RoughBergomiMixing,
    SimulationConfig,
    VarianceGammaExact,
    heston_variance_swap_strike,
    mc_path_values,
    reduce_payoffs,
    simulate_conditional_values,
    simulate_price_grid,
    simulate_terminal_prices,
)
from .methods.heston_surface import heston_surface_mc
from .methods.mixing_greeks import (
    GREEK_ORDER,
    heston_exact_price_and_greeks,
    heston_mixing_price_and_greeks,
)
from .methods.rough_bergomi_surface import rbergomi_surface_mc
from .models.dynamics import (
    BatesDynamics,
    CEVDynamics,
    HestonDynamics,
    KouJumpDynamics,
    LocalVolDynamics,
    LognormalDynamics,
    MertonJumpDynamics,
    NormalDynamics,
    RoughBergomiDynamics,
    SABRDynamics,
    SLVDynamics,
    VarianceGammaDynamics,
    HestonHullWhiteDynamics,
    heston_cf,
    lognormal_cf,
)
from .models.local_vol import dupire_local_vol
from .models.slv import LeverageSurface, calibrate_leverage, leverage_at
from .models.rough_bergomi import ForwardVarianceCurve
from .ops.rbergomi_kernel import GREEK_ORDER_RB
from .interop import from_reference

__all__ = [
    "ACT365F", "MILLISECONDS_IN_DAY", "MILLISECONDS_IN_YEAR_365", "SECONDS_IN_YEAR_365",
    "Act360", "Act365Fixed", "Act36525", "ActActISDA", "DayCount", "Thirty360E",
    "add_yearfrac", "ticks_to_datetime", "to_ticks", "yearfrac",
    "American", "Bermudan", "Call", "European", "Forward", "Put", "Spot", "VanillaOption",
    "parity_transform",
    "DigitalOption", "BarrierOption", "DoubleBarrierOption", "Up", "Down", "KnockIn", "KnockOut",
    "AsianOption", "ArithmeticAverage", "GeometricAverage", "LookbackOption", "FloatingStrike",
    "FixedStrike", "ForwardStartOption", "CompoundOption", "ChooserOption", "Cliquet",
    "Autocallable", "VarianceSwap",
    "Lens", "FieldLens", "SpotLens", "VolLens", "ZeroRateSpineLens", "lens_get", "lens_set",
    "AnalyticSolution", "BasketPricingProblem", "BasketPricingSolution", "CarrMadanSolution",
    "CRRSolution", "LSMSolution", "MonteCarloSolution", "PDESolution", "PricingProblem",
    "AbstractPricingMethod", "register_solver", "solve",
    "BlackScholesInputs", "HestonInputs", "RoughBergomiInputs", "forward_spot",
    "MertonInputs", "KouInputs", "VarianceGammaInputs", "BatesInputs", "carry_yield",
    "market_yearfrac",
    "DividendSchedule", "dividend_pv", "escrowed_spot",
    "FlatRateCurve", "RateCurve", "df", "df_yf", "forward_rate", "is_flat", "spine_tenors",
    "spine_zeros", "zero_rate", "zero_rate_yf",
    "FlatVolSurface", "Interpolator2D", "RectVolSurface", "get_vol", "get_vol_yf",
    "spine_strikes", "spine_vols", "surface_spine_tenors",
    "SVIVolSurface", "calibrate_svi_slices", "check_svi_arbitrage", "svi_butterfly_margin",
    "svi_calendar_margin", "svi_total_variance",
    "ForwardObs", "FuturesObs", "ResolvedQuotes", "SpotObs", "VolQuote", "VolQuoteConfig",
    "iv_to_price", "price_to_iv", "resolve_quotes_batch", "underlying_forward", "underlying_spot",
    "bvn_cdf", "INTERP_KINDS", "interp1d", "interp2d_nested",
    "LBFGSResult", "argmin_ift", "minimize_lbfgs",
    "RootResult", "bisect_root", "implicit_root", "implicit_root_full",
    "AnalyticGreek", "BatchGreekProblem", "FDBackward", "FDCentral", "FDForward",
    "FiniteDifference", "ForwardAD", "GreekMethod", "GreekProblem", "GreekResult", "ReverseAD",
    "SecondOrderGreekProblem",
    "implied_vol", "implied_vol_bs", "iv_to_price_bs", "rect_vol_surface_from_prices",
    "CalibrationProblem", "CalibrationSolution", "OptimizerAlgo", "RootFinderAlgo",
    "BlackScholesAnalytic", "CarrMadan", "CoxRossRubinsteinMethod", "LSM", "PDEMethod",
    "carr_madan_error_estimate", "MertonAnalytic",
    "DualBound",
    "lsm_dual_bound",
    "Antithetic", "BlackScholesExact", "EulerMaruyama", "HestonBroadieKaya", "HestonExactMixing",
    "HestonQE", "MertonExact", "KouExact", "VarianceGammaExact",
    "MonteCarlo",
    "NoVarianceReduction", "RoughBergomiMixing", "SimulationConfig",
    "heston_variance_swap_strike", "mc_path_values",
    "reduce_payoffs", "simulate_conditional_values", "simulate_price_grid",
    "simulate_terminal_prices",
    "GREEK_ORDER", "heston_exact_price_and_greeks", "heston_mixing_price_and_greeks", "heston_surface_mc", "rbergomi_surface_mc",
    "HestonDynamics", "LognormalDynamics", "RoughBergomiDynamics", "ForwardVarianceCurve",
    "MertonJumpDynamics", "KouJumpDynamics", "VarianceGammaDynamics", "BatesDynamics",
    "heston_cf", "lognormal_cf",
    "GREEK_ORDER_RB",
    "BachelierInputs", "BachelierAnalytic", "BachelierExact", "NormalDynamics",
    "bachelier_price", "implied_normal_vol", "CEVInputs", "CEVAnalytic", "CEVDynamics",
    "cev_call_price", "cev_survival", "ncx2_cdf", "SABRInputs", "SABRAnalytic", "SABRDynamics",
    "hagan_vol", "LocalVolDynamics", "dupire_local_vol", "SLVInputs", "SLVDynamics",
    "LeverageSurface", "calibrate_leverage", "leverage_at",
    "AbstractMarketInputs",
    "ZeroCouponBond", "BondOption", "Caplet", "CapFloor", "Swaption", "HullWhiteInputs",
    "HullWhiteAnalytic", "HullWhiteGrid", "HullWhiteMonteCarlo", "hw_zbo_price",
    "HestonHullWhiteInputs", "HestonHullWhiteDynamics",
    "SpreadOption", "BasketOption", "RainbowOption", "MultiAssetBSInputs",
    "MultiAssetHestonInputs", "quanto_dividend_yield", "margrabe_price", "kirk_spread_price",
    "geometric_basket_price", "rainbow_prices", "stulz_min_call_price",
    "VIXFuture", "VIXOption", "VIXAnalytic", "vix_future_price", "vix_option_price",
    "from_reference",
]
