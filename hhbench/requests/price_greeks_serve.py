"""The serving entry of the QE mixing price and its 7-greek vector (K10):
``ops.heston_qe_greeks_kernel.heston_qe_mixing_price_and_greeks``, one
call a request.

A request is the desk's option (the configuration's market and strike,
or the spec's ``strike``) at the traffic's pairs, with its own seed.
Compared: the price (``price_gap``) and the greeks in
``reference.heston_mixing.PARAMS`` order as one group (``greek_gap``),
against the float64 reference on the same Philox pairs.
"""

from __future__ import annotations

import math

import torch

from .. import compare, desk
from ..reference import heston_mixing

PAIRS_PER_BLOCK = 256 * 128


class Kind:
    def __init__(self, config: dict, traffic: dict, device: str):
        from hedgehog_tpu_torch.ops import heston_qe_greeks_kernel

        self.desk(config, device)
        self.n_blocks = int(traffic["pairs"]["n_blocks"])
        self.n_batches = int(traffic["pairs"]["n_batches"])
        self.pairs = self.n_blocks * self.n_batches * PAIRS_PER_BLOCK
        self._entry = heston_qe_greeks_kernel.heston_qe_mixing_price_and_greeks
        self.call = self.program_call

    def desk(self, config: dict, device: str) -> None:
        market = config["market"]
        self.params = desk.params(market)
        self.strike = float(market["strike"])
        self.T = desk.yearfrac(market["reference_date"], market["expiry"])
        self.steps = int(config["schemes"]["qe_mixing"]["steps"])
        self.device = device
        self.call = self.program_call

    def program_call(self, inputs: dict) -> dict:
        spot, v0, kappa, theta, sigma, rho, r = self.params
        price, greeks = self._entry(
            math.log(spot), v0, r, kappa, theta, sigma, rho, self.T / self.steps,
            inputs["strike"], math.exp(-r * self.T), n_blocks=self.n_blocks,
            n_batches=self.n_batches, steps=self.steps, seed=inputs["seed"], device=self.device)
        out = torch.cat([price.reshape(1), greeks]).cpu().numpy()
        return {"price": out[:1], "greeks": out[1:]}

    def reference_call(self, inputs: dict, dtype=torch.float64) -> dict:
        price, greeks = heston_mixing.price_and_greeks(
            self.params, self.T, self.steps, inputs["strike"], self.pairs, inputs["seed"],
            dtype=dtype, device=self.device)
        return {"price": price.reshape(1).numpy(), "greeks": greeks.numpy()}

    def send(self, spec: dict) -> list:
        inputs = {"seed": spec["seed"], "strike": float(spec.get("strike", self.strike))}
        return [(inputs, self.call(inputs))]

    def paths(self, spec: dict) -> int:
        return 2 * self.pairs

    def works(self, spec: dict) -> list:
        return [dict(scheme="qe_mixing", kind="price_and_greeks", pairs=self.pairs,
                     steps=self.steps)]

    def compare(self, sample: list, seed: int) -> dict:
        price, greek = [], []
        for rec in sample:
            for inputs, out in rec.calls:
                ref = self.reference_call(inputs)
                price.append(compare.gap(out["price"], ref["price"]))
                greek.append(compare.gap(out["greeks"], ref["greeks"]))
        return {"price_gap": compare.worst(price), "greek_gap": compare.worst(greek)}
