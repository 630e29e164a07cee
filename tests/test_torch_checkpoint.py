"""hedgehog_tpu_torch.utils.checkpoint against tests/unit/test_checkpoint.py
and the JAX package's npz layout: a problem over a rate curve and a
calibration state round-trip, and a dict of arrays written by either
package loads in the other to equal values."""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hedgehog_tpu_torch as ht
from hedgehog_tpu.utils import checkpoint as jax_checkpoint
from hedgehog_tpu_torch.utils.checkpoint import load_pytree, save_pytree

REF = dt.date(2024, 1, 1)


def _problem(spot=100.0):
    curve = ht.RateCurve.from_dfs(REF, [0.5, 1.0, 2.0], [0.99, 0.975, 0.95])
    market = ht.BlackScholesInputs(REF, curve, spot, 0.2)
    payoff = ht.VanillaOption(100.0, dt.date(2025, 1, 1), ht.European(), ht.Call(), ht.Spot())
    return ht.PricingProblem(payoff, market)


def test_pytree_roundtrip(tmp_path):
    """test_checkpoint.py:13-27: the problem loads into its own structure
    and prices to the same bits."""
    prob = _problem()
    path = str(tmp_path / "prob")
    save_pytree(path, prob)
    loaded = load_pytree(path, _problem(spot=90.0))  # the values come from the file
    method = ht.BlackScholesAnalytic(device="cpu")
    assert float(ht.solve(loaded, method).price) == float(ht.solve(prob, method).price)
    curve, like = loaded.market_inputs.rate, prob.market_inputs.rate
    assert torch.equal(curve.zero_rates, like.zero_rates)
    assert curve.zero_rates.dtype == torch.float64 and loaded.market_inputs.spot == 100.0


def test_calibration_state_roundtrip(tmp_path):
    """test_checkpoint.py:30-35."""
    params = {"x": torch.tensor([0.02, 3.0, 0.03], dtype=torch.float64), "step": 17}
    save_pytree(str(tmp_path / "calib"), params)
    loaded = load_pytree(str(tmp_path / "calib.npz"), {"x": torch.zeros(3, dtype=torch.float64),
                                                       "step": 0})
    assert torch.equal(loaded["x"], params["x"]) and loaded["step"] == 17
    assert isinstance(loaded["step"], int)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    state = {"x": jnp.asarray([0.02, 3.0, 0.03]), "step": jnp.asarray(17)}
    jax_checkpoint.save_pytree(str(tmp_path / "calib"), state)
    loaded = load_pytree(str(tmp_path / "calib"), {"x": torch.zeros(3, dtype=torch.float64),
                                                   "step": torch.tensor(0)})
    np.testing.assert_array_equal(loaded["x"].numpy(), np.asarray(state["x"]))
    assert int(loaded["step"]) == 17 and loaded["step"].dtype == torch.int64


def test_port_checkpoint_loads_in_jax(tmp_path):
    state = {"x": torch.tensor([0.02, 3.0, 0.03], dtype=torch.float64), "step": torch.tensor(17)}
    save_pytree(str(tmp_path / "calib"), state)
    like = {"x": jnp.zeros(3), "step": jnp.asarray(0)}
    loaded = jax_checkpoint.load_pytree(str(tmp_path / "calib"), like)
    np.testing.assert_array_equal(np.asarray(loaded["x"]), state["x"].numpy())
    assert int(loaded["step"]) == 17


def test_leaf_count_mismatch_raises(tmp_path):
    save_pytree(str(tmp_path / "two"), {"a": torch.zeros(2), "b": 1.0})
    with pytest.raises(ValueError, match="checkpoint has 2 leaves; example tree has 3"):
        load_pytree(str(tmp_path / "two"), {"a": torch.zeros(2), "b": 1.0, "c": 2.0})
