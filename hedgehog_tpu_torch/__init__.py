"""hedgehog_tpu_torch — the PyTorch/CUDA port of hedgehog_tpu.

The JAX package ``hedgehog_tpu`` stays the reference; this package ports it
slice by slice and keeps its module tree and public names.  It prices a
European vanilla under Heston, Black-Scholes or rough Bergomi by Monte
Carlo through ``solve(PricingProblem(...), MonteCarlo(...))``, with
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
(``lsm_dual_bound``), for American and Bermudan vanillas, on the GPU too.
The exact-mixing estimator's greeks (``heston_exact_price_and_greeks``, or
AD through ``solve``) carry the likelihood-ratio term of its Poisson
counts.
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
    Bermudan,
    Call,
    European,
    Forward,
    Put,
    Spot,
    VanillaOption,
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
    PricingProblem,
)
from .core.solve import AbstractPricingMethod, register_solver, solve
from .market.inputs import BlackScholesInputs, HestonInputs, RoughBergomiInputs
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
from .methods.black_scholes import BlackScholesAnalytic
from .methods.carr_madan import CarrMadan
from .methods.crr import CoxRossRubinsteinMethod
from .methods.duality import DualBound, lsm_dual_bound
from .methods.lsm import LSM
from .methods.montecarlo import (
    Antithetic,
    BlackScholesExact,
    EulerMaruyama,
    HestonExactMixing,
    HestonQE,
    MonteCarlo,
    NoVarianceReduction,
    RoughBergomiMixing,
    SimulationConfig,
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
from .models.dynamics import HestonDynamics, LognormalDynamics, RoughBergomiDynamics
from .models.rough_bergomi import ForwardVarianceCurve
from .ops.rbergomi_kernel import GREEK_ORDER_RB
from .interop import from_reference

__all__ = [
    "ACT365F", "MILLISECONDS_IN_DAY", "MILLISECONDS_IN_YEAR_365", "SECONDS_IN_YEAR_365",
    "Act360", "Act365Fixed", "Act36525", "ActActISDA", "DayCount", "Thirty360E",
    "add_yearfrac", "ticks_to_datetime", "to_ticks", "yearfrac",
    "American", "Bermudan", "Call", "European", "Forward", "Put", "Spot", "VanillaOption",
    "parity_transform",
    "Lens", "FieldLens", "SpotLens", "VolLens", "ZeroRateSpineLens", "lens_get", "lens_set",
    "AnalyticSolution", "BasketPricingProblem", "BasketPricingSolution", "CarrMadanSolution",
    "CRRSolution", "LSMSolution", "MonteCarloSolution", "PricingProblem",
    "AbstractPricingMethod", "register_solver", "solve",
    "BlackScholesInputs", "HestonInputs", "RoughBergomiInputs",
    "FlatRateCurve", "RateCurve", "df", "df_yf", "forward_rate", "is_flat", "spine_tenors",
    "spine_zeros", "zero_rate", "zero_rate_yf",
    "FlatVolSurface", "Interpolator2D", "RectVolSurface", "get_vol", "get_vol_yf",
    "spine_strikes", "spine_vols", "surface_spine_tenors",
    "INTERP_KINDS", "interp1d", "interp2d_nested",
    "LBFGSResult", "argmin_ift", "minimize_lbfgs",
    "RootResult", "bisect_root", "implicit_root", "implicit_root_full",
    "AnalyticGreek", "BatchGreekProblem", "FDBackward", "FDCentral", "FDForward",
    "FiniteDifference", "ForwardAD", "GreekMethod", "GreekProblem", "GreekResult", "ReverseAD",
    "SecondOrderGreekProblem",
    "implied_vol", "implied_vol_bs", "iv_to_price_bs", "rect_vol_surface_from_prices",
    "CalibrationProblem", "CalibrationSolution", "OptimizerAlgo", "RootFinderAlgo",
    "BlackScholesAnalytic", "CarrMadan", "CoxRossRubinsteinMethod", "LSM", "DualBound",
    "lsm_dual_bound",
    "Antithetic", "BlackScholesExact", "EulerMaruyama", "HestonExactMixing", "HestonQE",
    "MonteCarlo",
    "NoVarianceReduction", "RoughBergomiMixing", "SimulationConfig", "mc_path_values",
    "reduce_payoffs", "simulate_conditional_values", "simulate_price_grid",
    "simulate_terminal_prices",
    "GREEK_ORDER", "heston_exact_price_and_greeks", "heston_mixing_price_and_greeks", "heston_surface_mc", "rbergomi_surface_mc",
    "HestonDynamics", "LognormalDynamics", "RoughBergomiDynamics", "ForwardVarianceCurve",
    "GREEK_ORDER_RB",
    "from_reference",
]
