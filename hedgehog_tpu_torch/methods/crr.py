"""Cox-Ross-Rubinstein binomial tree: the backward induction on the device.

Port of ``hedgehog_tpu/methods/crr.py`` (reference
src/pricing_methods/cox_ross_rubinstein.jl).  Forward-measure tree: up factor
``u = exp(σ√ΔT)``, down ``1/u``, up probability ``p = 1/(1+u)`` (the forward
is a martingale), per-step discount ``exp(−z(T)·ΔT)`` (crr.jl:113-130).
European, American and Bermudan exercise; Spot or Forward underlying (Spot
discounts the forward node values back with the curve, crr.jl:77-97); carry
through the market's dividend yield, and discrete cash dividends by Hull's
escrowed tree (the tree evolves S − PV(divs); exercise decisions add the
remaining dividends' PV back).

The shrinking tree is a fixed-width (steps + 1) vector on the device: each
contraction reads v[j] and v[j+1], and after k steps slot j depends only on
the payoff nodes j..j+k, so slot 0 holds the root price after ``steps``
contractions with no masking.  The loop over steps reads nothing back to the
host: every per-step scalar (node offsets, zero rates, rebate values, the
dividend add-back) is computed for all steps before it, and the barrier
lattices compute their node tables (no-cross factors, intrinsic values)
for blocks of 256 steps at once.  An array strike
prices one tree per strike along a leading axis (the node axis last), with
per-strike vols from the market's surface.

Single barriers: knock-outs carry the Brownian-bridge no-cross factor on
every edge (continuous monitoring) and absorb the crossing mass at the
rebate, or, for American holders, at the better of the rebate and the
intrinsic at the barrier; European knock-ins by in-out parity over three
inductions; American and Bermudan knock-ins by the hit-time quadrature of
the live option's lattice value at the barrier against the closed-form
first-passage law.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.payoffs import (
    American,
    AsianOption,
    BarrierOption,
    Bermudan,
    DigitalOption,
    DoubleBarrierOption,
    European,
    KnockIn,
    KnockOut,
    LookbackOption,
    Spot,
    Up,
    VanillaOption,
    bermudan_step_mask,
)
from ..core.problems import CRRSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import BlackScholesInputs, carry_yield, forward_spot, market_yearfrac
from ..market.rate_curve import df, df_yf, zero_rate, zero_rate_yf
from ..market.vol_surface import get_vol
from ..utils import f64, resolve_device

__all__ = ["CoxRossRubinsteinMethod"]


@dataclasses.dataclass(frozen=True)
class CoxRossRubinsteinMethod(AbstractPricingMethod):
    """A ``steps``-step CRR lattice on ``device`` (the GPU unless the caller
    asks for the CPU)."""

    steps: int = 100
    device: str = "cuda"


@register_solver(CoxRossRubinsteinMethod)
def _solve_crr(prob: PricingProblem, method: CoxRossRubinsteinMethod) -> CRRSolution:
    payoff = prob.payoff
    market = prob.market_inputs
    steps = method.steps
    if isinstance(payoff, AsianOption):
        raise TypeError(
            "CRR's backward induction carries no running-average state; "
            "Asian options price analytically under Black-Scholes (geometric) "
            "or via grid Monte Carlo"
        )
    if isinstance(payoff, LookbackOption):
        raise TypeError(
            "CRR's backward induction carries no running-extremum state; "
            "lookbacks price analytically under Black-Scholes or via the "
            "bridge Monte Carlo estimator"
        )
    if isinstance(payoff, DoubleBarrierOption):
        raise TypeError(
            "the CRR lattice carries the single-barrier bridge correction "
            "only; double barriers price analytically under Black-Scholes "
            "or via the two-sided bridge Monte Carlo estimator"
        )
    if not isinstance(payoff, (VanillaOption, DigitalOption, BarrierOption)):
        raise TypeError(f"the CRR lattice has no induction for {type(payoff).__name__}")
    if not isinstance(market, BlackScholesInputs):
        raise TypeError(
            f"the CRR lattice is a Black-Scholes tree; got {type(market).__name__} "
            "(price Heston early exercise with LSM)"
        )
    if isinstance(payoff, BarrierOption):
        # knocked nodes are absorbed at the rebate value in the induction, so
        # no path state is needed; knock-ins reduce to knock-outs by in-out
        # parity (European only: knocking in leaves a LIVE American option)
        if isinstance(payoff.knock, KnockIn):
            if not isinstance(payoff.exercise_style, European):
                return _solve_crr_knock_in_early(prob, method)
            return _solve_crr_knock_in(prob, method)
        return _solve_crr_knock_out(prob, method)
    has_divs = getattr(market, "dividends", None) is not None
    if has_divs and not isinstance(payoff.underlying, Spot):
        raise TypeError(
            "discrete dividends on the CRR lattice need a Spot underlying "
            "(the escrowed add-back is a spot-level correction)"
        )
    device = resolve_device(method.device)
    strike = f64(payoff.strike, device=device)
    if strike.ndim > 0:
        # strike grid: one tree per strike on a leading axis, the node axis last
        strike = strike[:, None]
    # the strike on the device: the intrinsic value then copies nothing to the card
    payoff = dataclasses.replace(payoff, strike=strike)
    sigma = f64(get_vol(market.sigma, payoff.expiry, strike), device=device)
    T = market_yearfrac(market, payoff.expiry)
    D_T = df(market.rate, payoff.expiry).to(device)
    q = f64(carry_yield(market), device=device)
    # forward_spot subtracts PV(cash divs ≤ T): the tree evolves the escrowed
    # spot, plain GBM, so u and p are unchanged and the tree recombines
    forward = forward_spot(market, T, device=device) / D_T  # carry-adjusted T-forward
    dT = T / steps
    u = torch.exp(sigma * dT**0.5)
    p = 1.0 / (1.0 + u)
    step_discount = torch.exp(-zero_rate(market.rate, payoff.expiry).to(device) * dT)

    is_bermudan = isinstance(payoff.exercise_style, Bermudan)
    can_exercise = is_bermudan or isinstance(payoff.exercise_style, American)
    ex_mask = (bermudan_step_mask(payoff.exercise_style, market, payoff.expiry, steps,
                                  device=device) if is_bermudan else None)
    j = torch.arange(steps + 1, dtype=torch.float64, device=device)
    # the leaves are the escrowed spot = the full spot at T (every ex-date
    # ≤ T has dropped): no add-back there
    value = payoff(forward * u ** (2.0 * j - steps))
    if can_exercise and isinstance(payoff.underlying, Spot):
        # forward nodes back to spot at node time i·ΔT (crr.jl:77-83), the
        # zero-rate lookup in year fractions; with carry q the no-arbitrage
        # relation is S_t = F_t·D(t, T)·e^{q(T − t)}
        i = torch.arange(steps, dtype=torch.float64, device=device)
        z_i = zero_rate_yf(market.rate, i * dT).to(device)
        to_spot = torch.exp((q - z_i) * (steps - i) * dT)
        if has_divs:
            from ..market.dividends import remaining_dividend_pv

            # full spot at node time = escrowed node + PV_t(remaining divs)
            add_back = remaining_dividend_pv(market, i * dT, T, device=device)
    for i in range(steps - 1, -1, -1):
        v_up = torch.roll(value, -1, dims=-1)  # v[j+1]; the last slot is never consumed
        continuation = step_discount * (p * v_up + (1.0 - p) * value)
        if not can_exercise:
            value = continuation
            continue
        nodes = forward * u ** (2.0 * j - i)
        if isinstance(payoff.underlying, Spot):
            nodes = to_spot[i] * nodes
            if has_divs:
                nodes = nodes + add_back[i]
        exercised = torch.maximum(continuation, payoff(nodes))
        # mask slot 0 is never set, so i = 0 stays pure continuation
        value = torch.where(ex_mask[i], exercised, continuation) if is_bermudan else exercised
    return CRRSolution(prob, method, value[..., 0])


def _barrier_guards(prob: PricingProblem, what: str) -> None:
    """What the barrier lattices refuse: another underlying than the spot, a
    strike or barrier grid, and a dividend schedule (``what`` names the part
    of the lattice's law that the escrowed convention breaks)."""
    payoff = prob.payoff
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("barrier CRR monitors the spot; use Spot underlying")
    if torch.as_tensor(payoff.strike).ndim > 0 or torch.as_tensor(payoff.barrier).ndim > 0:
        raise TypeError(
            "barrier CRR prices one (strike, barrier) pair per solve; loop "
            "over contracts for grids"
        )
    if getattr(prob.market_inputs, "dividends", None) is not None:
        raise TypeError(
            f"barrier CRR assumes a dividend-free GBM path law (the {what} "
            "is escrow-inconsistent); price discrete-dividend barriers on "
            "the PDE engine or the barrier LSM / bridge Monte Carlo on "
            "EulerMaruyama grids (spot model)"
        )


#: the time steps whose node tables (no-cross factors, intrinsic values) a barrier
#: lattice computes at once: (_BLOCK, steps + 1) doubles each
_BLOCK = 256


class _BarrierTree:
    """The geometry the barrier lattices share, on the method's device: the
    lattice constants, and the log node spots ``x(i) = c[i] + (2j − i)·σ√ΔT``
    at time i·ΔT, ``c`` the discounted-forward level of every time
    0..steps (crr.jl:77-83 with carry: S_t = F_t·D(t, T)·e^{q(T − t)})."""

    def __init__(self, prob: PricingProblem, method: CoxRossRubinsteinMethod, what: str):
        _barrier_guards(prob, what)
        payoff = prob.payoff
        market = prob.market_inputs
        dev = resolve_device(method.device)
        steps = method.steps
        self.device, self.steps = dev, steps
        self.payoff = dataclasses.replace(payoff, strike=f64(payoff.strike, device=dev))
        self.sigma = f64(get_vol(market.sigma, payoff.expiry, payoff.strike), device=dev)
        T = market_yearfrac(market, payoff.expiry)
        self.D_T = df(market.rate, payoff.expiry).to(dev)
        self.q = f64(carry_yield(market), device=dev)
        self.forward = forward_spot(market, T, device=dev) / self.D_T
        self.dT = dT = T / steps
        self.p = 1.0 / (1.0 + torch.exp(self.sigma * dT**0.5))
        self.z_T = zero_rate(market.rate, payoff.expiry).to(dev)
        self.step_discount = torch.exp(-self.z_T * dT)
        self.j2 = 2.0 * torch.arange(steps + 1, dtype=torch.float64, device=dev)
        self.up = isinstance(payoff.direction, Up)
        self.barrier = f64(payoff.barrier, device=dev)
        self.log_b = torch.log(self.barrier)
        self.R = f64(payoff.rebate, device=dev)
        self.rate = market.rate
        self.sqrt_dT = torch.sqrt(f64(dT, device=dev))
        self.sq_dT = self.sigma * self.sqrt_dT
        i = torch.arange(steps + 1, dtype=torch.float64, device=dev)
        z_i = zero_rate_yf(market.rate, i * dT).to(dev)
        self.c = torch.log(self.forward) + (self.q - z_i) * (steps - i) * dT
        style = payoff.exercise_style
        self.is_american = isinstance(style, American)
        self.is_bermudan = isinstance(style, Bermudan)
        self.ex_mask = (bermudan_step_mask(style, market, payoff.expiry, steps, device=dev)
                        if self.is_bermudan else None)

    def x(self, lo: int, hi: int, shift: int = 0) -> torch.Tensor:
        """(hi − lo, steps + 1) log node spots at the times i = lo..hi − 1
        with exponents 2j − i + ``shift`` (shift ±1 at time i + 1: the up
        and down children)."""
        t = lo + (shift != 0)
        i = torch.arange(lo, hi, dtype=torch.float64, device=self.device)[:, None]
        return self.c[t:t + hi - lo, None] + (self.j2 - i + shift) * self.sigma * self.sqrt_dT

    def blocks(self):
        """(lo, hi) blocks of at most ``_BLOCK`` times, from the last to the
        first: the induction computes each block's node tables at once and
        walks its steps on them."""
        for hi in range(self.steps, 0, -_BLOCK):
            yield max(hi - _BLOCK, 0), hi

    def knocked(self, x: torch.Tensor) -> torch.Tensor:
        return (x >= self.log_b) if self.up else (x <= self.log_b)

    def exercise(self, i: int, cont: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
        """The exercise decision at time i (Bermudan: on its grid dates only)."""
        exercised = torch.maximum(cont, intrinsic)
        return torch.where(self.ex_mask[i], exercised, cont) if self.is_bermudan else exercised


def _solve_crr_knock_out(prob: PricingProblem, method: CoxRossRubinsteinMethod) -> CRRSolution:
    """Knock-out barrier CRR (European, American, Bermudan) with
    bridge-corrected edges: each parent→child edge carries the no-cross
    factor q = 1 − exp(−2·d0·d1/σ²ΔT) over its segment and the crossing
    mass (1 − q) is absorbed at the rebate value, pricing continuous
    monitoring with the plain O(ΔT) lattice error (no sawtooth).

    Rebates as ``BarrierOption``'s: at the segment midpoint
    (``rebate_at_hit``) or discounted from expiry.  An American holder whose
    edge is about to cross exercises at the barrier, so the crossing mass
    absorbs at max(intrinsic(H)·disc^½, rebate leg); Bermudan holders keep
    the plain rebate.  A node beyond the barrier never propagates."""
    tree = _BarrierTree(prob, method, "bridge edge factors and hit law")
    payoff, steps, dev = tree.payoff, tree.steps, tree.device
    p, disc, R = tree.p, tree.step_discount, tree.R
    seg_var = tree.sigma**2 * tree.dT
    half_disc = torch.sqrt(disc)

    def no_cross(x0, x1):
        d0 = (tree.log_b - x0) if tree.up else (x0 - tree.log_b)
        d1 = (tree.log_b - x1) if tree.up else (x1 - tree.log_b)
        inside = (d0 > 0.0) & (d1 > 0.0)
        arg = torch.where(inside, -2.0 * d0 * d1 / seg_var, torch.zeros_like(d0))
        return torch.where(inside, -torch.expm1(arg), torch.zeros_like(d0))

    # the value at t_i of R given a crossing in [t_i, t_{i+1}], for every i
    if payoff.rebate_at_hit:
        reb = (R * half_disc).expand(steps)
    else:
        i = torch.arange(steps, dtype=torch.float64, device=dev)
        reb = R * tree.D_T / df_yf(tree.rate, i * tree.dT).to(dev)
    if tree.is_american:
        hit_ex = payoff(torch.exp(tree.log_b))
        reb = torch.maximum(hit_ex * half_disc, reb)
    # a knocked node holds R (at the hit) or the rebate leg (at expiry)
    knocked_value = R.expand(steps) if payoff.rebate_at_hit else reb
    can_exercise = tree.is_american or tree.is_bermudan

    x_T = tree.x(steps, steps + 1)[0]
    value = torch.where(tree.knocked(x_T), R, payoff(torch.exp(x_T)))
    q = 1.0 - p
    for lo, hi in tree.blocks():
        x = tree.x(lo, hi)
        q_up, q_dn = no_cross(x, tree.x(lo, hi, 1)), no_cross(x, tree.x(lo, hi, -1))
        reb_b = reb[lo:hi, None]
        qd_up, r_up = q_up * disc, (1.0 - q_up) * reb_b
        qd_dn, r_dn = q_dn * disc, (1.0 - q_dn) * reb_b
        knocked = tree.knocked(x)
        intrinsic = payoff(torch.exp(x)) if can_exercise else None
        for i in range(hi - 1, lo - 1, -1):
            r = i - lo
            v_up = torch.roll(value, -1, dims=-1)  # up-child values
            new = p * (qd_up[r] * v_up + r_up[r]) + q * (qd_dn[r] * value + r_dn[r])
            if can_exercise:
                new = tree.exercise(i, new, intrinsic[r])
            # beyond-barrier nodes are knocked already (their inbound edges
            # carry q = 0, so this matters only for the root when S0 is
            # beyond H)
            value = torch.where(knocked[r], knocked_value[i], new)
    return CRRSolution(prob, method, value[..., 0])


def _solve_crr_knock_in_early(prob: PricingProblem,
                              method: CoxRossRubinsteinMethod) -> CRRSolution:
    """American/Bermudan knock-in: the hit-time quadrature against the
    lattice value of the live option at the barrier (knocking in leaves a
    live early-exercise option, so no in-out parity exists).  By the strong
    Markov property

        KI = ∫₀ᵀ D(0,t)·V_live(t, H) dF(t) + R·D(0,T)·(1 − F(T)),

    F the closed-form first-passage law of the drifted log spot to log H
    (drift z(T) − q − σ²/2, the lattice's own flat drift) and V_live(t, H)
    the vanilla lattice value (layer A) interpolated at log H per time step,
    clamped to the nodes the lattice reaches; per-segment midpoint rule
    (P(τ ∈ segment) from F differences, V at the endpoints' average, the
    curve discount at the midpoint).  Already beyond the barrier at
    inception, the contract is the live option: layer A's root."""
    tree = _BarrierTree(prob, method, "first-passage hit law")
    payoff, steps, dev = tree.payoff, tree.steps, tree.device
    p, disc, dT = tree.p, tree.step_discount, tree.dT

    # barrier_interp's slot and weight for every time it = 0..steps−1: after
    # steps − it contractions slots 0..it hold node values (slot j, exponent
    # 2j − it), so the slot is clamped to [0, it]; the clamp engages only
    # while the lattice cannot reach the barrier, where the first-passage
    # mass it multiplies is ~0
    it = torch.arange(steps, dtype=torch.float64, device=dev)
    jf = torch.minimum(torch.clamp(((tree.log_b - tree.c[:steps]) / tree.sq_dT + it) / 2.0,
                                   min=0.0), it)
    j0 = torch.clamp(torch.floor(jf).to(torch.int64), 0, steps - 1)
    w = jf - j0.to(torch.float64)
    pair = torch.stack([j0, j0 + 1], dim=1)  # (steps, 2) node indices on the device

    am = payoff(torch.exp(tree.x(steps, steps + 1)[0]))  # the live vanilla at expiry
    ys = [None] * steps
    q = 1.0 - p
    for lo, hi in tree.blocks():
        intrinsic = payoff(torch.exp(tree.x(lo, hi)))
        for i in range(hi - 1, lo - 1, -1):
            am_cont = disc * (p * torch.roll(am, -1, dims=-1) + q * am)
            am = tree.exercise(i, am_cont, intrinsic[i - lo])
            v0, v1 = am[pair[i]].unbind()
            ys[i] = (1.0 - w[i]) * v0 + w[i] * v1
    # V_live(t_k, H) for k = 0..steps (terminal: the intrinsic at the barrier)
    y = torch.cat([torch.stack(ys), payoff(tree.barrier)[None]])

    # the closed-form first-passage law of the log spot to log H
    sigma = tree.sigma
    x_root = tree.c[0]
    nu = tree.z_T - tree.q - 0.5 * sigma**2
    d = (tree.log_b - x_root) if tree.up else (x_root - tree.log_b)  # > 0 while live
    mu = nu if tree.up else -nu  # the signed drift toward the barrier
    d_safe = torch.clamp(d, min=1e-300)
    t_grid = torch.arange(steps + 1, dtype=torch.float64, device=dev) * dT
    # P(τ_H ≤ t) = Φ((μt − d)/(σ√t)) + e^{2μd/σ²}·Φ((−d − μt)/(σ√t)), the
    # reflection term in log space (e^{2μd/σ²} alone can overflow where its
    # Φ factor underflows), and 0 at t = 0
    st = sigma * torch.sqrt(torch.clamp(t_grid, min=1e-300))
    direct = torch.special.ndtr((mu * t_grid - d_safe) / st)
    reflect = torch.exp(2.0 * mu * d_safe / sigma**2
                        + torch.special.log_ndtr((-d_safe - mu * t_grid) / st))
    F = torch.where(t_grid > 0.0, direct + reflect, torch.zeros_like(direct))
    t_mid = (torch.arange(steps, dtype=torch.float64, device=dev) + 0.5) * dT
    disc_mid = df_yf(tree.rate, t_mid).to(dev)  # the exact curve discount to midpoints
    v_mid = 0.5 * (y[:-1] + y[1:])
    ki = torch.sum(torch.diff(F) * disc_mid * v_mid) + tree.R * tree.D_T * (1.0 - F[-1])
    price = torch.where(tree.knocked(x_root), am[..., 0], ki)
    return CRRSolution(prob, method, price)


def _solve_crr_knock_in(prob: PricingProblem, method: CoxRossRubinsteinMethod) -> CRRSolution:
    """European knock-in by in-out parity on the same lattice:
    KI(R) = vanilla − KO(0) + R·NT with the no-touch bond
    NT = D(T) − (KO(rebate 1 at expiry) − KO(0)): three inductions."""
    payoff = prob.payoff
    market = prob.market_inputs
    _barrier_guards(prob, "bridge edge factors")
    van = VanillaOption(payoff.strike, payoff.expiry, European(), payoff.call_put, Spot())
    ko0 = dataclasses.replace(payoff, knock=KnockOut(), rebate=0.0)
    ko1e = dataclasses.replace(payoff, knock=KnockOut(), rebate=1.0, rebate_at_hit=False)
    p_van = _solve_crr(PricingProblem(van, market), method).price
    p_ko0 = _solve_crr_knock_out(PricingProblem(ko0, market), method).price
    p_ko1e = _solve_crr_knock_out(PricingProblem(ko1e, market), method).price
    no_touch = df(market.rate, payoff.expiry).to(p_van.device) - (p_ko1e - p_ko0)
    price = p_van - p_ko0 + f64(payoff.rebate, device=p_van.device) * no_touch
    return CRRSolution(prob, method, price)
