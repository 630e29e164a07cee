"""One whole damped Gauss–Newton fit of (V0, κ, θ, σ, ρ) to a quote
surface, each iteration one call of the QE mixing surface and its
Jacobian (K12):
``ops.heston_qe_greeks_kernel.heston_qe_mixing_surface_price_and_jacobian``.

The client's arithmetic is chip_smoke.py's ``phase_surface_calibration``
loop: the residual r = surface − quotes, the step solving
(JᵀJ + λI) s = Jᵀr over the five free columns, x ← x − s, then x clipped
to the traffic's bounds.  A fit runs exactly ``iterations`` iterations
from the traffic's start, scaled per parameter by 1 + the spec's
``start_scale``; every iteration of a fit draws the fit's seed (common
random numbers).  The quotes are the configuration's true market priced
by ``reference.heston_cf`` at set-up.

Compared, at the last iteration of each sampled fit and at
``check.iterations`` − 1 more drawn from the seed: the surface
(``price_gap``) and each Jacobian column as a group (``greek_gap``),
against the float64 reference at that iteration's parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import compare, desk, generator
from ..reference import heston_cf, heston_mixing

PAIRS_PER_BLOCK = 256 * 128
FREE = (1, 2, 3, 4, 5)  # V0, κ, θ, σ, ρ in reference.heston_mixing.PARAMS


class Kind:
    def __init__(self, config: dict, traffic: dict, device: str):
        from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel

        market = config["market"]
        surface = config["surface"]
        self.spot, self.rate = float(market["spot"]), float(market["rate"])
        self.T_exp = [desk.yearfrac(market["reference_date"], e) for e in surface["expiries"]]
        self.strikes = [float(k) for k in surface["strikes"]]
        self.seg_steps = tuple(int(s) for s in config["schemes"]["qe_mixing"]["seg_steps"])
        self.discounts = [math.exp(-self.rate * t) for t in self.T_exp]
        true = desk.params(market)
        self.quotes = np.stack([heston_cf.call_prices(self.spot, self.rate, *true[1:6], t,
                                                      self.strikes) for t in self.T_exp])
        self.iterations = int(traffic["iterations"])
        self.start = np.array(traffic["start"], dtype=np.float64)
        self.damping = float(traffic["damping"])
        self.lower = np.array(traffic["bounds"]["lower"], dtype=np.float64)
        self.upper = np.array(traffic["bounds"]["upper"], dtype=np.float64)
        self.n_blocks = int(traffic["pairs"]["n_blocks"])
        self.n_batches = int(traffic["pairs"]["n_batches"])
        self.pairs = self.n_blocks * self.n_batches * PAIRS_PER_BLOCK
        self.check_iterations = int(traffic["check"]["iterations"])
        self.device = device
        self._entry = heston_qe_greeks_kernel.heston_qe_mixing_surface_price_and_jacobian
        self.call = self.program_call

    def _params7(self, x) -> list:
        return [self.spot, *[float(v) for v in x], self.rate]

    def program_call(self, inputs: dict) -> dict:
        v0, kappa, theta, sigma, rho = inputs["x"]
        surf, jac = self._entry(
            math.log(self.spot), v0, self.rate, kappa, theta, sigma, rho, self.T_exp,
            self.strikes, self.discounts, seg_steps=self.seg_steps, n_strikes=len(self.strikes),
            n_blocks=self.n_blocks, n_batches=self.n_batches, seed=inputs["seed"],
            device=self.device)
        out = torch.cat([surf.reshape(-1), jac.reshape(-1)]).cpu().numpy()
        n = surf.numel()
        return {"surface": out[:n].reshape(surf.shape), "jacobian": out[n:].reshape(jac.shape)}

    def reference_call(self, inputs: dict, dtype=torch.float64) -> dict:
        surf, jac = heston_mixing.surface_and_jacobian(
            self._params7(inputs["x"]), self.T_exp, self.seg_steps, self.strikes, self.pairs,
            inputs["seed"], dtype=dtype, device=self.device)
        return {"surface": surf.numpy(), "jacobian": jac.numpy()}

    def step(self, x, out: dict):
        """The client's damped Gauss–Newton step from one call's outputs."""
        r = (out["surface"] - self.quotes).ravel()
        J = out["jacobian"][:, :, list(FREE)].reshape(-1, len(FREE))
        s = np.linalg.solve(J.T @ J + self.damping * np.eye(len(FREE)), J.T @ r)
        return np.clip(x - s, self.lower, self.upper)

    def send(self, spec: dict) -> list:
        x = self.start * (1.0 + np.asarray(spec["start_scale"]))
        calls = []
        for _ in range(self.iterations):
            inputs = {"x": [float(v) for v in x], "seed": spec["seed"]}
            out = self.call(inputs)
            calls.append((inputs, out))
            x = self.step(x, out)
        return calls

    def paths(self, spec: dict) -> int:
        return 2 * self.pairs * self.iterations

    def works(self, spec: dict) -> list:
        one = dict(scheme="qe_mixing", kind="surface_price_and_jacobian", pairs=self.pairs,
                   steps=sum(self.seg_steps), points=len(self.T_exp) * len(self.strikes),
                   expiries=len(self.T_exp))
        return [one] * self.iterations

    def compare(self, sample: list, seed: int) -> dict:
        price, greek = [], []
        for rec in sample:
            last = len(rec.calls) - 1
            picks = generator.sample(seed, list(range(last)), self.check_iterations - 1,
                                     salt=2 + rec.spec["index"])
            for i in [*picks, last]:
                inputs, out = rec.calls[i]
                ref = self.reference_call(inputs)
                price.append(compare.gap(out["surface"], ref["surface"]))
                greek.append(compare.worst(compare.gap(out["jacobian"][..., c],
                                                       ref["jacobian"][..., c])
                                           for c in range(ref["jacobian"].shape[-1])))
        return {"price_gap": compare.worst(price), "greek_gap": compare.worst(greek)}
