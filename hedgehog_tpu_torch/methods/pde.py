"""Finite-difference PDE pricing: a 1-D theta-scheme in spot space, on the
device.

Port of the 1-D engine of ``hedgehog_tpu/methods/pde.py`` under
``LognormalDynamics`` (the Black-Scholes generator), ``CEVDynamics`` (the
σ·S^β diffusion on ``CEVInputs``) and ``LocalVolDynamics`` (Dupire's
σ_loc(t, S) from a ``BlackScholesInputs`` surface at each step's mid
time).  One backward solve
values every spot level at once, American and Bermudan exercise is a
projection (no regression noise), and barriers and digitals price without
Monte Carlo error.

- **Space**: a sinh-stretched spot grid clustered at the strike (the
  terminal kink), frozen (``detach``: autograd flows through the
  coefficients and the cubic readout, not the nodes), non-uniform 3-point
  central differences with branchless Péclet-limited upwinding wherever a
  central off-diagonal would go negative (an M-matrix: monotone, no
  oscillation at digital or barrier discontinuities).  The terminal
  condition is the payoff averaged over each node's cell.
- **Time**: the theta-scheme (Crank-Nicolson by default) with a Rannacher
  start (the first steps after expiry fully implicit), curve-exact
  per-step forward rates, exercise by projection after each step.  Each
  step solves one tridiagonal system by parallel cyclic reduction
  (``math/linalg.tridiag_solve_pcr``): ⌈log₂ n⌉ wide stages, no sequential
  sweep.  Every step's operator is built before the loop, which reads
  nothing back to the host.
- **Boundaries**: far-field rows drop diffusion and take one-sided
  advection.  A knock-out makes the barrier a grid endpoint with a
  Dirichlet rebate row (continuous monitoring); a European knock-in prices
  by in-out parity.
- **Discrete cash dividends** (market/dividends.py, the spot model): at
  each ex-date, snapped to the grid as the Monte Carlo grid snaps it, the
  jump condition V(t⁻, S) = V(t⁺, S − D) by clamped linear interpolation,
  with exercise just before the drop (Bermudans when the ex-date is an
  exercise date) and the Dirichlet row pinned again.

``PDEMethod(HestonDynamics())`` runs the Heston 2-D ADI solver of
``pde2d.py`` on a (variance × spot) grid of ``var_steps`` + 1 rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.payoffs import (
    American,
    BarrierOption,
    Bermudan,
    DigitalOption,
    European,
    KnockIn,
    KnockOut,
    Spot,
    Up,
    VanillaOption,
    bermudan_step_mask,
)
from ..core.problems import PDESolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import (
    BlackScholesInputs,
    CEVInputs,
    HestonInputs,
    carry_yield,
    market_yearfrac,
)
from ..market.rate_curve import df, df_yf
from ..market.vol_surface import get_vol
from ..math.interpolation import interp1d
from ..math.linalg import tridiag_solve_pcr
from ..models.dynamics import CEVDynamics, HestonDynamics, LocalVolDynamics, LognormalDynamics
from ..utils import f64, resolve_device

__all__ = ["PDEMethod", "convection_diffusion_operator"]


@dataclasses.dataclass(frozen=True)
class PDEMethod(AbstractPricingMethod):
    """1-D finite-difference theta-scheme on ``device`` (the GPU unless the
    caller asks for the CPU), or the 2-D Craig–Sneyd ADI solver under
    ``HestonDynamics`` (pde2d.py).  ``space_steps`` / ``time_steps`` set the
    (N + 1)-node spot grid and the number of backward steps; ``theta`` the
    implicitness (0.5 Crank-Nicolson, 1.0 fully implicit); ``rannacher``
    how many startup steps run fully implicit; ``n_std`` the grid
    half-width in terminal standard deviations; ``cluster`` the sinh
    clustering scale as a fraction of the strike; ``var_steps`` the
    variance intervals of the 2-D grid (Heston only)."""

    dynamics: Any = LognormalDynamics()
    space_steps: int = 400
    time_steps: int = 200
    theta: float = 0.5
    rannacher: int = 2
    n_std: float = 7.0
    cluster: float = 0.1
    var_steps: int = 64
    device: str = "cuda"


def _sinh_grid(s_lo, s_hi, center, scale, n: int) -> torch.Tensor:
    """n + 1 spot nodes on [s_lo, s_hi], sinh-clustered around ``center``,
    the endpoints pinned exactly (a barrier's Dirichlet row sits on one)."""
    c1 = torch.asinh((s_lo - center) / scale)
    c2 = torch.asinh((s_hi - center) / scale)
    u = torch.linspace(0.0, 1.0, n + 1, dtype=torch.float64, device=center.device)
    s = center + scale * torch.sinh(c1 + u * (c2 - c1))
    return torch.cat([s_lo.reshape(1), s[1:-1], s_hi.reshape(1)])


def _reference_vol(market, dynamics, payoff, dev) -> torch.Tensor:
    """A lognormal-vol proxy that sizes the grid: σ·S₀^{β−1} under CEV,
    else the implied vol at (expiry, strike)."""
    if isinstance(dynamics, CEVDynamics):
        return (f64(market.sigma, device=dev)
                * torch.clamp(f64(market.spot, device=dev), min=1e-12) ** (
                    f64(market.beta, device=dev) - 1.0))
    return f64(get_vol(market.sigma, payoff.expiry, payoff.strike), device=dev)


def _local_sigmas(market, dynamics, payoff, s_grid, t_mid) -> torch.Tensor:
    """σ(t, S) in price-vol units (dS = … + σ·S dW) at the grid nodes:
    (M, n + 1) at the steps' mid times under local vol, (n + 1,) otherwise
    (CEV's σ·S^{β−1}, or the flat implied vol)."""
    dev = s_grid.device
    if isinstance(dynamics, CEVDynamics):
        return f64(market.sigma, device=dev) * torch.clamp(s_grid, min=1e-12) ** (
            f64(market.beta, device=dev) - 1.0)
    if isinstance(dynamics, LocalVolDynamics):
        from ..models.local_vol import dupire_local_vol

        sig = dupire_local_vol(market, t_mid[:, None], s_grid[None, :])
        return torch.broadcast_to(f64(sig, device=dev), (t_mid.shape[0], s_grid.shape[0]))
    sigma = f64(get_vol(market.sigma, payoff.expiry, payoff.strike), device=dev)
    return torch.broadcast_to(sigma, s_grid.shape)


def convection_diffusion_operator(x, dcoef, drift, kill):
    """Tridiagonal generator diagonals (l, m, u) of

        L·V = dcoef·V_xx + drift·V_x − kill·V

    on the non-uniform grid ``x`` (last axis; ``dcoef``, ``drift`` and
    ``kill`` broadcast against leading batch axes, one operator a row).
    Interior rows: central 3-point differences, switched node by node to
    one-sided drift where a central off-diagonal would go negative
    (Péclet limiting: an M-matrix, a monotone scheme).  Boundary rows: no
    diffusion, one-sided advection toward the interior (exact for linear
    and constant far-field asymptotes)."""
    h = x[1:] - x[:-1]
    h_m = h[:-1]  # h_{i−1} for interior i = 1..n−1
    h_p = h[1:]  # h_i
    mu = drift[..., 1:-1]
    dc = dcoef[..., 1:-1]

    w_m = -h_p / (h_m * (h_m + h_p))
    w_p = h_m / (h_p * (h_m + h_p))
    w_0 = -(w_m + w_p)
    v_m = 2.0 / (h_m * (h_m + h_p))
    v_p = 2.0 / (h_p * (h_m + h_p))
    v_0 = -(v_m + v_p)

    l_c = dc * v_m + mu * w_m
    u_c = dc * v_p + mu * w_p
    m_c = dc * v_0 + mu * w_0

    zero = torch.zeros_like(mu)
    l_uw = dc * v_m + torch.where(mu < 0.0, -mu / h_m, zero)
    u_uw = dc * v_p + torch.where(mu > 0.0, mu / h_p, zero)
    m_uw = dc * v_0 + torch.where(mu > 0.0, -mu / h_p, mu / h_m)
    need_uw = (l_c < 0.0) | (u_c < 0.0)
    l_i = torch.where(need_uw, l_uw, l_c)
    u_i = torch.where(need_uw, u_uw, u_c)
    m_i = torch.where(need_uw, m_uw, m_c) - kill

    mu_lo = drift[..., :1]
    mu_hi = drift[..., -1:]
    zeros = torch.zeros_like(mu_lo)
    lower = torch.cat([zeros, l_i, -mu_hi / h[-1]], dim=-1)
    upper = torch.cat([mu_lo / h[0], u_i, zeros], dim=-1)
    main = torch.cat([-mu_lo / h[0] - kill, m_i, mu_hi / h[-1] - kill], dim=-1)
    return lower, main, upper


def _terminal_condition(payoff, s_grid) -> torch.Tensor:
    """The payoff averaged over each interior node's cell
    [(s_{i−1} + s_i)/2, (s_i + s_{i+1})/2] (closed form: the payoffs are
    piecewise linear with one breakpoint at the strike), less the linear
    part's centroid bias, so a kink-free cell keeps its pointwise value;
    the boundary nodes keep theirs."""
    k = f64(payoff.strike, device=s_grid.device)
    cp = payoff.call_put()
    mid = 0.5 * (s_grid[:-1] + s_grid[1:])
    a, b = mid[:-1], mid[1:]
    w = b - a
    s_i = s_grid[1:-1]
    zero = torch.zeros_like(s_i)
    if isinstance(payoff, DigitalOption):
        cash = f64(payoff.cash, device=s_grid.device)
        if cp > 0:
            avg = cash * torch.clamp(b - torch.maximum(k, a), min=0.0) / w
        else:
            avg = cash * torch.clamp(torch.minimum(k, b) - a, min=0.0) / w
        slope = zero
    else:  # the vanilla ramp (BarrierOption's intrinsic is the same)
        if cp > 0:
            avg = 0.5 * (torch.clamp(b - k, min=0.0) ** 2 - torch.clamp(a - k, min=0.0) ** 2) / w
        else:
            avg = 0.5 * (torch.clamp(k - a, min=0.0) ** 2 - torch.clamp(k - b, min=0.0) ** 2) / w
        slope = torch.where(cp * (s_i - k) > 0.0, torch.full_like(s_i, float(cp)), zero)
    v_avg = avg - slope * (0.5 * (a + b) - s_i)
    v = payoff(s_grid)
    return torch.cat([v[:1], v_avg, v[-1:]])


def _pde_backward(market, method: PDEMethod, payoff, s_grid, v_T, dirichlet) -> torch.Tensor:
    """The backward theta-scheme: V(·, t = 0) on ``s_grid``.  ``dirichlet``
    is None or ``(side, values)``, side 0 or −1 and ``values`` the
    (time_steps + 1,) pinned endpoint value at each time (a knock-out's
    rebate)."""
    dev = s_grid.device
    M = method.time_steps
    T = market_yearfrac(market, payoff.expiry)
    dt = T / M
    q = f64(carry_yield(market), device=dev)

    # curve-exact forward rates over [t_k, t_{k+1}], mid-step local vols and
    # every step's operator
    t_edges = torch.arange(M + 1, dtype=torch.float64, device=dev) * dt
    log_df = torch.log(df_yf(market.rate, t_edges).to(dev))
    r_steps = (-(log_df[1:] - log_df[:-1]) / dt)[:, None]  # (M, 1)
    t_mid = (torch.arange(M, dtype=torch.float64, device=dev) + 0.5) * dt
    sig = _local_sigmas(market, method.dynamics, payoff, s_grid, t_mid)
    lower, main, upper = convection_diffusion_operator(
        s_grid, 0.5 * sig**2 * s_grid**2, (r_steps - q) * s_grid, r_steps)
    # Rannacher: the first steps walked (nearest expiry, i ≥ M − rannacher)
    # fully implicit
    rann = min(method.rannacher, M)
    thetas = torch.where(torch.arange(M, device=dev) >= M - rann,
                         torch.ones((), dtype=torch.float64, device=dev),
                         f64(method.theta, device=dev))[:, None]
    a_l = -thetas * dt * lower
    a_m = 1.0 - thetas * dt * main
    a_u = -thetas * dt * upper
    explicit = (1.0 - thetas) * dt

    style = payoff.exercise_style
    is_american = isinstance(style, American)
    is_bermudan = isinstance(style, Bermudan)
    can_exercise = is_american or is_bermudan
    ex_mask = (bermudan_step_mask(style, market, payoff.expiry, M, device=dev) if is_bermudan
               else torch.ones((max(M, 1),), dtype=torch.bool, device=dev))
    intrinsic = payoff(s_grid) if can_exercise else torch.zeros_like(s_grid)

    pin = None
    if dirichlet is not None:
        d_side, d_vals = dirichlet
        idx = torch.arange(s_grid.shape[0], device=dev)
        pin = idx == (idx[-1] if d_side == -1 else idx[0])
        zero = torch.zeros_like(a_l)
        a_l = torch.where(pin, zero, a_l)
        a_u = torch.where(pin, zero, a_u)
        a_m = torch.where(pin, torch.ones_like(a_m), a_m)

    div_steps = None
    if getattr(market, "dividends", None) is not None:
        from ..market.dividends import dividend_step_amounts

        # the cash drop at grid time (i + 1)·dt is slot i (the grid Monte
        # Carlo's snapping: both engines discretize the same spot model)
        div_steps = dividend_step_amounts(market, T, M, device=dev)
        # exercise just before the drop at t_{i+1}: slot i gated by the next
        # time's right (ex_mask[i] gates t_i; the terminal payoff covers an
        # ex-date at expiry)
        ex_mask_end = torch.cat([ex_mask[1:], torch.zeros(1, dtype=torch.bool, device=dev)])

    v = v_T
    zero1 = torch.zeros(1, dtype=torch.float64, device=dev)
    for i in range(M - 1, -1, -1):
        if div_steps is not None:
            # V(t⁻, S) = V(t⁺, S − D) at the ex-date t_{i+1} (linear
            # interpolation keeps the scheme monotone; the clamped ends sit
            # in the far field, where V is its asymptote)
            d_i = div_steps[i]
            drop = d_i > 0.0
            v = torch.where(drop, interp1d(s_grid - d_i, s_grid, v, kind="linear"), v)
            if can_exercise:
                gate = drop if is_american else drop & ex_mask_end[i]
                v = torch.where(gate, torch.maximum(v, intrinsic), v)
            if pin is not None:
                v = torch.where(pin, d_vals[i + 1], v)
        Lv = (lower[i] * torch.cat([zero1, v[:-1]]) + main[i] * v
              + upper[i] * torch.cat([v[1:], zero1]))
        rhs = v + explicit[i] * Lv
        if pin is not None:
            rhs = torch.where(pin, d_vals[i], rhs)
        v = tridiag_solve_pcr(a_l[i], a_m[i], a_u[i], rhs)
        if can_exercise:
            exercised = torch.maximum(v, intrinsic)
            v = torch.where(ex_mask[i], exercised, v) if is_bermudan else exercised
            if pin is not None:  # the barrier endpoint is not exercisable
                v = torch.where(pin, d_vals[i], v)
    return v


def _grid_bounds(market, payoff, sigma_ref, T, n_std, dev):
    """The grid's bounds, covering strike, spot and the drift over T."""
    k = f64(payoff.strike, device=dev)
    s0 = f64(market.spot, device=dev)
    Tc = max(T, 1e-12)
    b = -torch.log(df(market.rate, payoff.expiry).to(dev)) / Tc - f64(carry_yield(market), dev)
    w = n_std * torch.clamp(sigma_ref, min=0.01) * Tc**0.5 + 0.05
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    lo = torch.minimum(torch.log(k), torch.log(s0)) - w + torch.minimum(b, zero) * T
    hi = torch.maximum(torch.log(k), torch.log(s0)) + w + torch.maximum(b, zero) * T
    return torch.exp(lo), torch.exp(hi)


def _check_supported(prob: PricingProblem, method: PDEMethod):
    payoff = prob.payoff
    if not isinstance(payoff, (VanillaOption, DigitalOption, BarrierOption)):
        raise TypeError(
            "PDEMethod prices vanilla, digital and single-barrier payoffs; "
            "path-dependent payoffs (Asians, lookbacks, doubles) carry "
            "running state the 1-D grid does not — use Monte Carlo"
        )
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("PDEMethod evolves the spot; use Spot underlying")
    if torch.as_tensor(payoff.strike).ndim > 0:
        raise TypeError(
            "PDEMethod prices one contract per solve (its grid is built "
            "around the strike); loop over contracts for grids"
        )
    dyn, market = method.dynamics, prob.market_inputs
    if isinstance(dyn, HestonDynamics):
        if not isinstance(market, HestonInputs):
            raise TypeError(
                f"PDEMethod(HestonDynamics()) prices HestonInputs markets; got "
                f"{type(market).__name__}"
            )
        return
    if not isinstance(dyn, (LognormalDynamics, CEVDynamics, LocalVolDynamics)):
        raise TypeError(
            f"PDEMethod supports Lognormal/CEV/LocalVol dynamics (1-D grid) "
            f"and Heston (2-D ADI), got {type(dyn).__name__}; "
            "other stochastic-vol/jump models use their MC/Fourier engines"
        )
    want = CEVInputs if isinstance(dyn, CEVDynamics) else BlackScholesInputs
    if not isinstance(market, want):
        raise TypeError(
            f"PDEMethod({type(dyn).__name__}()) prices {want.__name__} markets; got "
            f"{type(market).__name__}"
        )
    if getattr(market, "dividends", None) is not None and not isinstance(dyn, LognormalDynamics):
        raise TypeError(
            "discrete-dividend PDE jump conditions are wired for "
            "LognormalDynamics (a Dupire surface already embeds its own "
            "dividend assumptions); strip the schedule or use "
            "LognormalDynamics"
        )


@register_solver(PDEMethod)
def _solve_pde(prob: PricingProblem, method: PDEMethod) -> PDESolution:
    _check_supported(prob, method)
    if isinstance(method.dynamics, HestonDynamics):
        from .pde2d import solve_pde_heston

        return solve_pde_heston(prob, method)
    payoff = prob.payoff
    market = prob.market_inputs
    if isinstance(payoff, BarrierOption):
        if isinstance(payoff.knock, KnockIn):
            if not isinstance(payoff.exercise_style, European):
                raise TypeError(
                    "early-exercise knock-ins have no in-out parity; price "
                    "them on the CRR hit-time quadrature or barrier LSM"
                )
            return _solve_pde_knock_in(prob, method)
        return _solve_pde_knock_out(prob, method)

    dev = resolve_device(method.device)
    T = market_yearfrac(market, payoff.expiry)
    k = f64(payoff.strike, device=dev)
    sigma_ref = _reference_vol(market, method.dynamics, payoff, dev)
    s_lo, s_hi = _grid_bounds(market, payoff, sigma_ref, T, method.n_std, dev)
    if getattr(market, "dividends", None) is not None:
        # the cash drops push the path band down: widen the lower bound by
        # the escrowed fraction so post-drop paths stay on the grid
        from ..market.dividends import escrowed_spot

        frac = torch.clamp(escrowed_spot(market, T, device=dev) / f64(market.spot, dev),
                           0.05, 1.0)
        s_lo = s_lo * frac
    s_grid = _sinh_grid(s_lo, s_hi, k, method.cluster * k, method.space_steps).detach()
    v0 = _pde_backward(market, method, payoff, s_grid, _terminal_condition(payoff, s_grid),
                       None)
    price = interp1d(f64(market.spot, dev), s_grid, v0, kind="cubic")
    return PDESolution(prob, method, price, s_grid, v0)


def _solve_pde_knock_out(prob: PricingProblem, method: PDEMethod) -> PDESolution:
    """Knock-out: the barrier is a grid endpoint with a Dirichlet rebate row
    (continuous monitoring, no monitoring-date bias); exercise projects on
    the live region only."""
    payoff = prob.payoff
    market = prob.market_inputs
    if torch.as_tensor(payoff.barrier).ndim > 0:
        raise TypeError("PDEMethod prices one (strike, barrier) pair per solve")
    dev = resolve_device(method.device)
    T = market_yearfrac(market, payoff.expiry)
    sigma_ref = _reference_vol(market, method.dynamics, payoff, dev)
    s_lo, s_hi = _grid_bounds(market, payoff, sigma_ref, T, method.n_std, dev)
    up = isinstance(payoff.direction, Up)
    H = f64(payoff.barrier, device=dev)
    if up:
        s_hi, d_side = H, -1
    else:
        s_lo, d_side = H, 0
    # cluster at the kink the live region holds (the strike if inside, else
    # the barrier itself)
    k = f64(payoff.strike, device=dev)
    center = torch.minimum(torch.maximum(k, s_lo), s_hi)
    s_grid = _sinh_grid(s_lo, s_hi, center, method.cluster * k, method.space_steps).detach()

    M = method.time_steps
    R = f64(payoff.rebate, device=dev)
    if payoff.rebate_at_hit:
        d_vals = R.expand(M + 1)
    else:
        t_edges = torch.arange(M + 1, dtype=torch.float64, device=dev) * (T / M)
        d_vals = R * df(market.rate, payoff.expiry).to(dev) / df_yf(market.rate, t_edges).to(dev)
    v_T = _terminal_condition(payoff, s_grid)
    v_T = torch.cat([R.reshape(1), v_T[1:]]) if d_side == 0 else torch.cat([v_T[:-1], R.reshape(1)])
    v0 = _pde_backward(market, method, payoff, s_grid, v_T, (d_side, d_vals))
    spot = f64(market.spot, device=dev)
    price_live = interp1d(spot, s_grid, v0, kind="cubic")
    # already beyond the barrier at inception: knocked, the rebate's value at 0
    knocked0 = (spot >= H) if up else (spot <= H)
    price = torch.where(knocked0, d_vals[0], price_live)
    return PDESolution(prob, method, price, s_grid, v0)


def _solve_pde_knock_in(prob: PricingProblem, method: PDEMethod) -> PDESolution:
    """European knock-in by in-out parity on the same engine:
    KI(R) = vanilla − KO(0) + R·NT, NT = D_T − (KO(rebate 1 at expiry) − KO(0))."""
    payoff = prob.payoff
    market = prob.market_inputs
    van = VanillaOption(payoff.strike, payoff.expiry, European(), payoff.call_put, Spot())
    ko0 = dataclasses.replace(payoff, knock=KnockOut(), rebate=0.0)
    ko1e = dataclasses.replace(payoff, knock=KnockOut(), rebate=1.0, rebate_at_hit=False)
    p_van = _solve_pde(PricingProblem(van, market), method).price
    p_ko0 = _solve_pde_knock_out(PricingProblem(ko0, market), method).price
    p_ko1e = _solve_pde_knock_out(PricingProblem(ko1e, market), method).price
    no_touch = df(market.rate, payoff.expiry).to(p_van.device) - (p_ko1e - p_ko0)
    price = p_van - p_ko0 + f64(payoff.rebate, device=p_van.device) * no_touch
    return PDESolution(prob, method, price, None, None)
