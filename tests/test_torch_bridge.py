"""The Brownian-bridge primitives against the JAX package on the CPU, on the
same inputs: the single-barrier no-cross factors and their product, the
exact bridge extremum and the two-sided corridor factors to 1e-12
relative or 1e-14 absolute, their gradients (through the masked branches
too) to 1e-10 relative or 1e-11 absolute, and the lookback's own Philox
stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu_torch as ht
from hedgehog_tpu.methods import montecarlo as jmc
from hedgehog_tpu_torch.methods import bridge_mc as pbr
from hedgehog_tpu_torch.methods import montecarlo as pmc

STEPS, GROUPS, PATHS = 6, 2, 64


def _close(got, want, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _grid(seed=0):
    """A log-price grid around log 100 that crosses 90 and 110, segment
    variances and uniforms (u = 0 included)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0.0, 0.06, (STEPS, GROUPS, PATHS))
    grid = np.log(100.0) + np.concatenate([np.zeros((1, GROUPS, PATHS)),
                                           np.cumsum(steps, axis=0)])
    seg = rng.uniform(0.001, 0.01, (STEPS, GROUPS, PATHS))
    u = rng.uniform(0.0, 1.0, (STEPS, GROUPS, PATHS))
    u[0, 0, :4] = 0.0
    return grid, seg, u


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("up,level,scalar_var", [(True, 110.0, False), (True, 100.0, True),
                                                 (False, 90.0, False), (False, 95.0, True)])
def test_survival_factors_match_reference(up, level, scalar_var):
    grid, seg, _ = _grid()
    seg = 0.004 if scalar_var else seg
    want = jmc.brownian_bridge_survival_factors(grid, seg, np.log(level), up)
    got = pbr.brownian_bridge_survival_factors(_t(grid), seg if scalar_var else _t(seg),
                                               np.log(level), up)
    _close(got, want)
    _close(ht.methods.montecarlo.brownian_bridge_survival(_t(grid), _t(seg), np.log(level), up),
           jmc.brownian_bridge_survival(grid, seg, np.log(level), up))


def test_time_varying_barrier_and_its_shape_check():
    grid, seg, _ = _grid(1)
    barrier = np.log(np.linspace(108.0, 112.0, STEPS + 1))[:, None, None]
    _close(pbr.brownian_bridge_survival_factors(_t(grid), _t(seg), _t(barrier), True),
           jmc.brownian_bridge_survival_factors(grid, seg, barrier, True))
    for f, arr in ((jmc.brownian_bridge_survival_factors, np.log(np.full(STEPS, 110.0))),
                   (pbr.brownian_bridge_survival_factors, _t(np.log(np.full(STEPS, 110.0))))):
        g = grid if f is jmc.brownian_bridge_survival_factors else _t(grid)
        with pytest.raises(ValueError, match="per-grid-time"):
            f(g, seg, arr, True)


@pytest.mark.parametrize("maximum", [True, False])
def test_bridge_extremum_matches_reference(maximum):
    grid, seg, u = _grid(2)
    _close(pbr.brownian_bridge_extremum(_t(grid), _t(seg), _t(u), maximum),
           jmc.brownian_bridge_extremum(grid, seg, u, maximum))
    _close(pbr.brownian_bridge_extremum(_t(grid[::3]), 0.01, _t(u[:2]), maximum),
           jmc.brownian_bridge_extremum(grid[::3], 0.01, u[:2], maximum))


@pytest.mark.parametrize("lower,upper", [(90.0, 110.0), (97.0, 130.0), (60.0, 160.0)])
def test_double_bridge_factors_match_reference(lower, upper):
    grid, seg, _ = _grid(3)
    _close(pbr.double_bridge_survival_factors(_t(grid), _t(seg), np.log(lower), np.log(upper)),
           jmc.double_bridge_survival_factors(grid, seg, np.log(lower), np.log(upper)))


def test_bridge_gradients_match_jax_grad():
    """Gradients in the grid, the variances and the barrier, with paths on
    both sides of it: the double where keeps the dead branch out."""
    grid, seg, u = _grid(4)

    def f_jax(g, s, b):
        single = jnp.sum(jmc.brownian_bridge_survival(g, s, b, True))
        double = jnp.sum(jnp.prod(jmc.double_bridge_survival_factors(g, s, b - 0.25, b), 0))
        ext = jnp.sum(jmc.brownian_bridge_extremum(g, s, u, True))
        return single + double + ext

    want = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(grid), jnp.asarray(seg),
                                              jnp.float64(np.log(108.0)))
    g, s, b = (_t(x).requires_grad_() for x in (grid, seg, np.log(108.0)))
    single = torch.sum(pbr.brownian_bridge_survival(g, s, b, True))
    double = torch.sum(torch.prod(pbr.double_bridge_survival_factors(g, s, b - 0.25, b), 0))
    ext = torch.sum(pbr.brownian_bridge_extremum(g, s, _t(u), True))
    got = torch.autograd.grad(single + double + ext, (g, s, b))
    for x, w in zip(got, want):
        assert bool(torch.isfinite(x).all())
        # atol 1e-11: torch differentiates expm1 as (expm1(x) + 1), which is
        # 0 where expm1(x) rounds to −1 (a factor of exactly 1.0); JAX's
        # exp(x) keeps the 1e-12-sized derivative there
        _close(x, w, rtol=1e-10, atol=1e-11)


def test_montecarlo_reexports_the_primitives():
    for name in ("brownian_bridge_survival_factors", "brownian_bridge_survival",
                 "brownian_bridge_extremum", "double_bridge_survival_factors"):
        assert getattr(pmc, name) is getattr(pbr, name)
        assert name in pmc.__all__


def test_lookback_uniforms_are_a_stream_of_their_own():
    cfg = ht.SimulationConfig(1000, 9, ht.Antithetic(), 11)
    u = pbr.lookback_uniforms(cfg, 9, "cpu")
    assert tuple(u.shape) == (9, 1000) and u.dtype == torch.float64
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert torch.equal(u, pbr.lookback_uniforms(cfg, 9, "cpu"))
    # its first rows do not depend on the segment count, and its words are
    # not the untagged blocks' (the grids' Box-Muller words)
    assert torch.equal(pbr.lookback_uniforms(cfg, 5, "cpu"), u[:5])
    from hedgehog_tpu_torch.math.counter_rng import uniform_from_bits
    from hedgehog_tpu_torch.ops.hh_device import philox_block

    plain = philox_block(torch.arange(1000), 0, 11, 0)
    assert not torch.equal(uniform_from_bits(plain[0]).double(), u[0])
    other = pbr.lookback_uniforms(ht.SimulationConfig(1000, 9, ht.Antithetic(), 12), 9, "cpu")
    assert not torch.equal(other, u)
