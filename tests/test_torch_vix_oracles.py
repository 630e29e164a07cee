"""VIX futures and options in the port (methods/vix.py) on the CPU: the
future's greeks in the five Heston parameters through autograd against
``jax.grad`` to 1e-8 (the port mirrors JAX's linearisation of the ncx2
survival in d), and the oracles of tests/unit/test_vix.py: put-call parity on the
future, the σ_v → 0 limit (the Edgeworth tail's exact limit), the
Feller-violating regime against the port's exact CIR draw of V_T (the draw
of ``HestonExactMixing`` and Broadie–Kaya, ``sample_noncentral_chisq``)
within 4 SE, the Bates convexity term, and the guards with JAX's exception
types."""

import datetime as dt
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu as hh
import hedgehog_tpu_torch as ht
from hedgehog_tpu_torch.distributions.broadie_kaya import sample_noncentral_chisq
from hedgehog_tpu_torch.methods import vix as pvix

REF = dt.date(2025, 1, 1)
EXPIRY = dt.date(2025, 7, 1)
R = 0.03
CPU = "cpu"
GRAD_RTOL = 1e-8
P0 = np.array([0.04, 2.0, 0.05, 0.6, -0.7])  # V0, κ, θ, σ, ρ
SMALL = dict(nodes=32, terms=256)
TAU = 30.0 / 365.0
JUMPS = (0.3, -0.1, 0.15)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _market(mod, sigma_v=0.6, kappa=2.0, theta=0.05, v0=0.04, rho=-0.7, jumps=None):
    if jumps is not None:
        return mod.BatesInputs(REF, R, 100.0, v0, kappa, theta, sigma_v, rho, *jumps)
    return mod.HestonInputs(REF, R, 100.0, v0, kappa, theta, sigma_v, rho)


def _pprice(payoff, market, **kw):
    return ht.solve(ht.PricingProblem(ht.from_reference(payoff), market),
                    ht.VIXAnalytic(**{**SMALL, **kw}, device=CPU)).price


def test_greeks_match_jax():
    """d(future)/d(V0, κ, θ, σ, ρ) through autograd against ``jax.grad``
    (jitted) at the same small sizes; ρ never enters."""
    future = hh.VIXFuture(EXPIRY)

    def jprice(x):
        m = hh.HestonInputs(REF, R, 100.0, x[0], x[1], x[2], x[3], x[4])
        return hh.solve(hh.PricingProblem(future, m), hh.VIXAnalytic(**SMALL)).price

    want = np.asarray(jax.jit(jax.grad(jprice))(jnp.asarray(P0)))
    x = torch.tensor(P0, dtype=torch.float64, requires_grad=True)
    m = ht.HestonInputs(REF, R, 100.0, x[0], x[1], x[2], x[3], x[4])
    (got,) = torch.autograd.grad(_pprice(future, m), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL, atol=1e-14)
    assert got[0] > 0 and got[2] > 0 and float(got[4]) == 0.0


def test_parity_and_sigma_v_zero_limit():
    """C − P = D·(F − K) (test_vix.py:44) and, at σ_v = 1e-6 (the Edgeworth
    tail), the future 100·√(a·m_T + b) with m_T the CIR mean (:52)."""
    m = _market(ht)
    T = hh.yearfrac(REF, EXPIRY)
    fut = float(_pprice(hh.VIXFuture(EXPIRY), m))
    D = math.exp(-R * T)
    for K in (15.0, 20.0, 25.0):
        c = float(_pprice(hh.VIXOption(K, EXPIRY), m))
        p = float(_pprice(hh.VIXOption(K, EXPIRY, call_put=hh.Put()), m))
        assert c - p == pytest.approx(D * (fut - K), rel=1e-10)
    m0 = _market(ht, sigma_v=1e-6)
    a, b = (float(x) for x in pvix.vix_params(m0, T, TAU)[:2])
    m_t = 0.05 + (0.04 - 0.05) * math.exp(-2.0 * T)
    assert float(_pprice(hh.VIXFuture(EXPIRY), m0)) == pytest.approx(100.0 * math.sqrt(a * m_t + b),
                                                                     rel=1e-9)


def _exact_vix(market, n=2**18, seed=0):
    """100·√(a·V_T + b) on the port's exact CIR draw V_T = c̄·χ'²(d, λ)."""
    T = hh.yearfrac(REF, EXPIRY)
    a, b, c_bar, d, lam = (float(x) for x in pvix.vix_params(market, T, TAU))
    chi = sample_noncentral_chisq(seed, d, lam, n, device=CPU)
    return 100.0 * torch.sqrt(a * c_bar * chi + b), (a, b, c_bar, d, lam)


def test_feller_violating_regime_against_the_exact_draw():
    """d < 2 (test_vix.py:73): the quadrature needs no density; at 128 nodes
    (32 are too few for the survival's step near 0 here: 11.97 against 12.20)
    the future sits below Jensen's bound and within 4 SE of the exact draw's
    mean, and a call within 4 SE of its discounted mean payoff."""
    m = _market(ht, sigma_v=1.0, kappa=1.0, theta=0.04, v0=0.04, rho=-0.9)
    vix, (a, b, c_bar, d, lam) = _exact_vix(m)
    assert d < 2.0
    fut = float(_pprice(hh.VIXFuture(EXPIRY), m, nodes=128))
    assert 0.0 < fut < 100.0 * math.sqrt(a * c_bar * (d + lam) + b)
    se = float(vix.std()) / math.sqrt(vix.numel())
    assert abs(fut - float(vix.mean())) <= 4.0 * se, (fut, float(vix.mean()), se)
    D = math.exp(-R * hh.yearfrac(REF, EXPIRY))
    pay = D * torch.clamp(vix - 20.0, min=0.0)
    call = float(_pprice(hh.VIXOption(20.0, EXPIRY), m, nodes=128))
    assert abs(call - float(pay.mean())) <= 4.0 * float(pay.std()) / math.sqrt(pay.numel())


def test_bates_carries_the_jump_convexity():
    """test_vix.py:112: b shifts by 2λ(e^{μ+σ²/2} − 1 − μ), the Bates future
    exceeds Heston's and matches the exact draw under the shifted map, and
    λ = 0 is Heston."""
    T = hh.yearfrac(REF, EXPIRY)
    mh, mb = _market(ht), _market(ht, jumps=JUMPS)
    lam_j, mu_j, sig_j = JUMPS
    jump = 2.0 * lam_j * (math.exp(mu_j + 0.5 * sig_j**2) - 1.0 - mu_j)
    bh, bb = (float(pvix.vix_params(m, T, TAU)[1]) for m in (mh, mb))
    assert bb - bh == pytest.approx(jump, rel=1e-12)
    fh, fb = (float(_pprice(hh.VIXFuture(EXPIRY), m)) for m in (mh, mb))
    assert fb > fh
    vix, _ = _exact_vix(mb, seed=1)
    assert abs(fb - float(vix.mean())) <= 4.0 * float(vix.std()) / math.sqrt(vix.numel())
    fb0 = float(_pprice(hh.VIXFuture(EXPIRY), _market(ht, jumps=(0.0, mu_j, sig_j))))
    assert fb0 == pytest.approx(fh, rel=1e-12)


def test_guards():
    """test_vix.py:139-156, with JAX's exception types."""
    slv = ht.SLVInputs(REF, R, 100.0, 0.04, 2.0, 0.05, 0.6, -0.7, 0.2)
    method = ht.VIXAnalytic(**SMALL, device=CPU)
    with pytest.raises(TypeError, match="pure Heston/Bates"):
        ht.solve(ht.PricingProblem(ht.VIXFuture(EXPIRY), slv), method)
    with pytest.raises(TypeError, match="CIR variance block"):
        ht.solve(ht.PricingProblem(ht.VIXFuture(EXPIRY),
                                   ht.BlackScholesInputs(REF, R, 100.0, 0.2)), method)
    with pytest.raises(TypeError, match="VIXFuture/VIXOption"):
        ht.solve(ht.PricingProblem(ht.VanillaOption(100.0, EXPIRY), _market(ht)), method)
    with pytest.raises(TypeError, match="European-exercise"):
        ht.solve(ht.PricingProblem(ht.VIXOption(20.0, EXPIRY, ht.American()), _market(ht)),
                 method)
    with pytest.raises(TypeError, match="pure Heston/Bates"):
        hh.solve(hh.PricingProblem(hh.VIXFuture(EXPIRY),
                                   hh.SLVInputs(REF, R, 100.0, 0.04, 2.0, 0.05, 0.6, -0.7, 0.2)),
                 hh.VIXAnalytic())
