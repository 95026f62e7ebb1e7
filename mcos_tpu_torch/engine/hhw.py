"""Heston-Hull-White engine: long-dated pricing under stochastic rates
(counterpart of `mcos_tpu/engine/hhw.py`).

Engine layer over `ops/hhw.py` (model, scheme and closed-form oracles in
its header). `price` and `rate_vol_impact` run kernel K7
(`cuda_kernels.hhw_terminal`: the kernel on a CUDA device, its plain
version on the CPU). Greeks ride the differentiable torch twin: delta,
v0-vega and the rate-vol sensitivity dP/d sigma_r ("rate vega": the
quantity that says whether stochastic rates matter for this contract) come
from one `torch.autograd.grad` pass through the simulation, on common
random numbers by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from mcos_tpu_torch.engine.pricer import seeded_generator, to_host
from mcos_tpu_torch.ops import cuda_kernels
from mcos_tpu_torch.ops.hhw import HHWParams, hhw_terminal, vasicek_bond
from mcos_tpu_torch.ops.simulate import _pair_payoffs


def _reduce_disc_payoff(s: torch.Tensor, d: torch.Tensor,
                        strikes: torch.Tensor, *, is_call: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """((strikes,) mean, (strikes,) stderr, scalar E[D]) of the pathwise
    discounted payoff, antithetic pairs pooled before the moments."""
    comb = _pair_payoffs(s, strikes, is_call, d)
    mean = torch.mean(comb, dim=0)
    se = (torch.std(comb, dim=0, correction=0)
          / float(np.sqrt(np.float32(comb.shape[0]))))
    return mean, se, torch.mean(d)


def _disc_payoff_mean(p: HHWParams, spot, strikes: torch.Tensor, T,
                      generator: torch.Generator, *, num_paths: int,
                      num_steps: int, is_call: bool,
                      device="cuda") -> torch.Tensor:
    """(strikes,) mean discounted payoff through the differentiable twin."""
    s, d = hhw_terminal(p, spot, T, generator, num_paths=num_paths,
                        num_steps=num_steps, device=device)
    phi = 1.0 if is_call else -1.0
    pay = torch.clamp(phi * (s[..., None] - strikes[None, None, :]), min=0.0)
    return torch.mean(pay * d[..., None], dim=(0, 1))


class HHWEngine:
    """Monte Carlo pricer for the Heston-Hull-White hybrid on `device`.

    backend: "cuda" (kernel K7; its plain version on the CPU) or "torch"
    (the step-loop twin on a generator seeded with `seed`). Greeks always
    ride the twin. ValueError for a correlation matrix that is not positive
    definite.
    """

    def __init__(self, params: HHWParams, num_paths: int = 200_000,
                 num_steps: int = 128, seed: int = 42,
                 backend: str = "cuda", *, device="cuda"):
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.backend = backend
        self.device = torch.device(device)

    def _terminal(self, spot: float, T: float):
        if self.backend == "cuda":
            return cuda_kernels.hhw_terminal(
                self.params, spot, T, self.seed, num_paths=self.num_paths,
                num_steps=self.num_steps, device=self.device)
        return hhw_terminal(
            self.params, spot, T, seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self.num_steps,
            device=self.device)

    def price(self, spot: float, strikes, T: float,
              is_call: bool = True) -> Dict[str, object]:
        strikes_arr = torch.atleast_1d(torch.as_tensor(
            np.asarray(strikes, np.float32), device=self.device))
        s, d = self._terminal(spot, T)
        mean, se, zc = _reduce_disc_payoff(s, d, strikes_arr,
                                           is_call=is_call)
        # One device→host copy for the three results.
        host = to_host({"mean": mean, "se": se, "zc": zc})
        mean, se = host["mean"], host["se"]
        scalar = np.ndim(strikes) == 0
        return {
            "price": float(mean[0]) if scalar else mean.tolist(),
            "std_error": float(se[0]) if scalar else se.tolist(),
            "zero_coupon_mc": float(host["zc"]),
            "zero_coupon_exact": vasicek_bond(self.params, T),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
        }

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict[str, float]:
        """delta / v0-vega / rate-vega (dP/d sigma_r) / rho-rate (dP/dr0),
        one backward pass through the discounted-payoff twin."""
        k_arr = torch.tensor([strike], dtype=torch.float32,
                             device=self.device)
        args = [torch.tensor(float(x), dtype=torch.float32,
                             device=self.device, requires_grad=True)
                for x in (spot, self.params.v0, self.params.sigma_r,
                          self.params.r0)]
        s0, v0, sigma_r, r0 = args
        p = dataclasses.replace(self.params, v0=v0, sigma_r=sigma_r, r0=r0)
        price = _disc_payoff_mean(
            p, s0, k_arr, T, seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self.num_steps,
            is_call=is_call, device=self.device)[0]
        grads = torch.autograd.grad(price, args)
        host = to_host({"price": price.detach(),
                        "grads": torch.stack(grads)})
        g = host["grads"]
        sigma0 = float(np.sqrt(float(self.params.v0)))
        return {
            "price": float(host["price"]),
            "delta": float(g[0]),
            # Per-vol-point convention shared by every endpoint:
            # 2·sigma·dP/dv0, no extra /100.
            "vega_per_vol_point": float(2.0 * sigma0 * g[1]),
            "rate_vega": float(g[2]),     # dP / d sigma_r (absolute)
            "rho_rate": float(g[3]),      # dP / d r0
        }

    def rate_vol_impact(self, spot: float, strike: float, T: float,
                        is_call: bool = True) -> Dict[str, float]:
        """How much of the price is stochastic rates? Reprice with
        sigma_r = 1e-8 on the same seed (K7's normals depend on the seed,
        pair and step only: common random numbers) and report the spread."""
        base = self.price(spot, strike, T, is_call)
        frozen = HHWEngine(dataclasses.replace(self.params, sigma_r=1e-8),
                           num_paths=self.num_paths,
                           num_steps=self.num_steps, seed=self.seed,
                           backend=self.backend, device=self.device)
        det = frozen.price(spot, strike, T, is_call)
        return {
            "price": base["price"],
            "price_deterministic_rates": det["price"],
            "stochastic_rates_premium": base["price"] - det["price"],
            "std_error": float(np.hypot(base["std_error"],
                                        det["std_error"])),
        }
