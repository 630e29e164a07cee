"""The public API's risk vector: ``torch.autograd.grad`` of ``solve``'s
price over the seven market leaves, through
``MonteCarlo(HestonDynamics(), HestonQE(conditional=True, use_kernel=True),
SimulationConfig(trajectories, steps, Antithetic(), seed))`` (K7 forward,
K11 backward).

A request is the configuration's market with the spec's strike and seed.
Compared: the price (``price_gap``) and the seven gradients in
``reference.heston_mixing.PARAMS`` order (``greek_gap``), against the
float64 reference on the same Philox pairs (under ``Antithetic`` a
trajectory is a pair).
"""

from __future__ import annotations

import torch

from .. import desk
from .price_greeks_serve import Kind as ServeKind


class Kind(ServeKind):
    def __init__(self, config: dict, traffic: dict, device: str):
        import hedgehog_tpu_torch as ht

        self.ht = ht
        self.desk(config, device)
        self.ref_date = desk.date(config["market"]["reference_date"])
        self.expiry = desk.date(config["market"]["expiry"])
        self.pairs = int(traffic["trajectories"])

    def program_call(self, inputs: dict) -> dict:
        ht = self.ht
        leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in self.params]
        spot, v0, kappa, theta, sigma, rho, r = leaves
        prob = ht.PricingProblem(
            ht.VanillaOption(inputs["strike"], self.expiry, ht.European(), ht.Call(), ht.Spot()),
            ht.HestonInputs(self.ref_date, r, spot, v0, kappa, theta, sigma, rho))
        method = ht.MonteCarlo(
            ht.HestonDynamics(), ht.HestonQE(conditional=True, use_kernel=True),
            ht.SimulationConfig(self.pairs, self.steps, ht.Antithetic(), inputs["seed"]),
            device=self.device)
        price = ht.solve(prob, method).price
        grads = torch.autograd.grad(price, leaves)
        out = torch.stack([price.detach().cpu(), *(g.detach().cpu() for g in grads)]).numpy()
        return {"price": out[:1], "greeks": out[1:]}

    def works(self, spec: dict) -> list:
        return [dict(scheme="qe_mixing", kind=kind, pairs=self.pairs, steps=self.steps)
                for kind in ("values", "values_vjp")]
