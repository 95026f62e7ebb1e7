"""SVCJ pricing engine: MC with companion control variate + the
semi-analytic oracle (counterpart of `mcos_tpu/engine/svcj.py`).

Correlated price/variance jumps let one crash clock gap the spot down
while kicking variance up. The engine follows the port's standard shape: a
functional core on device tensors, a thin stateful wrapper with the JAX
package's result keys, and the COS oracle (`ops/svcj.py:svcj_cos_price`)
as the exactness anchor for smiles.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import scaled_steps
from mcos_tpu_torch.engine.pricer import (
    _companion_pairs,
    resolve_mesh,
    seeded_generator,
    to_host,
)
from mcos_tpu_torch.models.params import SVCJParams
from mcos_tpu_torch.ops import cuda_kernels
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.svcj import svcj_cos_price, svcj_terminal


def _svcj_price_core(params: SVCJParams, spot, strikes, T, seed: int, *,
                     num_paths: int, num_steps: int, is_call: bool,
                     backend: str = "cuda",
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Antithetic + companion-CV SVCJ pricing over a strike vector.

    Same estimator discipline as engine/pricer.py:mc_price_core: the
    companion GBM leg rides the same dW₁ (β = 1 control; its expectation is
    the BS(√v0) price, since variance jumps never touch it), payoffs pool
    over both antithetic branches, moments stay float32 on the device.
    backend="cuda" runs kernel K8 keyed on `seed` (its plain version on
    the CPU), "torch" the differentiable twin on a generator seeded with
    it: the same recursion.
    """
    device = torch.device(device)
    strikes = torch.atleast_1d(torch.as_tensor(strikes, dtype=torch.float32,
                                               device=device))
    if backend == "cuda":
        s_final, v_final, g_final = cuda_kernels.svcj_terminal(
            params, spot, T, seed, num_paths=num_paths, num_steps=num_steps,
            antithetic=True, companion=True, device=device)
    elif backend == "torch":
        s_final, v_final, g_final = svcj_terminal(
            params, spot, T, seeded_generator(seed, device),
            num_paths=num_paths, num_steps=num_steps, antithetic=True,
            companion=True, device=device)
    else:
        raise ValueError(f"unknown backend: {backend!r}")
    eff, bs_ref, discount = _companion_pairs(params, spot, strikes, T,
                                             s_final, g_final, is_call)
    n = float(eff.shape[0])
    mean = torch.mean(eff, dim=0)
    var = torch.clamp(torch.mean(eff * eff, dim=0) - mean * mean, min=0.0)
    return {
        "price": discount * mean,
        "std_error": discount * torch.sqrt(var / n),
        "bs_ref": bs_ref,
        "v_max": torch.max(v_final),
        "frac_nonfinite": torch.mean((~torch.isfinite(s_final)).float()),
    }


def _svcj_delta_vega(params: SVCJParams, spot, strike, T,
                     generator: torch.Generator, *, num_paths: int,
                     num_steps: int, is_call: bool, device="cuda"):
    """Pathwise AD (∂P/∂S₀, ∂P/∂v₀) through the twin in one backward pass.

    Jump indicators do not depend on (S₀, v₀), so the pathwise derivative
    of the vanilla payoff is unbiased. Returns 0-d tensors (price, dS, dv0).
    """
    device = torch.device(device)
    s0 = torch.tensor(float(spot), dtype=torch.float32, device=device,
                      requires_grad=True)
    v0 = torch.tensor(float(params.v0), dtype=torch.float32, device=device,
                      requires_grad=True)
    p = params.replace(v0=v0)
    s_final, _, g_final = svcj_terminal(
        p, s0, T, generator, num_paths=num_paths, num_steps=num_steps,
        antithetic=True, companion=True, device=device)
    discount = torch.exp(-params.r * torch.tensor(T, dtype=torch.float32,
                                                  device=device))
    sign = 1.0 if is_call else -1.0
    pay = torch.clamp(sign * (s_final - strike), min=0.0)
    g_pay = torch.clamp(sign * (g_final - strike), min=0.0)
    bs_ref = bs_price(s0, strike, T, params.r, params.q, torch.sqrt(v0),
                      is_call, device=device)
    price = discount * torch.mean(pay - g_pay) + bs_ref
    d_s, d_v0 = torch.autograd.grad(price, (s0, v0))
    return price.detach(), d_s, d_v0


class SVCJEngine:
    """Stateful wrapper over the SVCJ cores (one per API request) on
    `device`. backend: "cuda" (kernel K8; its plain version on the CPU) or
    "torch" (the twin). Greeks always ride the twin. mesh: None | "auto" |
    a `parallel.mesh.Mesh` (`resolve_mesh`); a resolved mesh shards
    `price` (`parallel/families.py:sharded_svcj_price`)."""

    def __init__(self, params: SVCJParams, num_paths: int = 200_000,
                 num_steps: int = 252, seed: int = 42, mesh=None,
                 backend: str = "cuda", *, device="cuda"):
        self.mesh = mesh
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.backend = backend
        self.device = torch.device(device)

    def _steps(self, T: float) -> int:
        return scaled_steps(self.num_steps, T)

    def _core(self, spot, strikes, T, is_call: bool) -> Dict[str, np.ndarray]:
        return to_host(_svcj_price_core(
            self.params, spot, strikes, T, self.seed,
            num_paths=self.num_paths, num_steps=self._steps(T),
            is_call=is_call, backend=self.backend, device=self.device))

    def price(self, spot: float, strike, T: float,
              is_call: bool = True) -> Dict:
        strikes = np.atleast_1d(np.asarray(strike, np.float32))
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu_torch.parallel.families import sharded_svcj_price

            res = sharded_svcj_price(
                self.params, spot, strikes, T, self.seed, mesh=mesh,
                num_paths=self.num_paths, num_steps=self._steps(T),
                is_call=is_call, backend=self.backend)
            device = res["price"].device
            res["bs_ref"] = bs_price(
                spot, torch.as_tensor(strikes, device=device), T,
                self.params.r, self.params.q,
                torch.sqrt(torch.tensor(self.params.v0, dtype=torch.float32,
                                        device=device)),
                is_call, device=device)
            res = to_host(res)
        else:
            res = self._core(spot, strikes, T, is_call)
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "bs_ref": float(res["bs_ref"][0]),
            "num_paths_used": int(np.asarray(
                res.get("num_paths_used", self.num_paths))),
            "num_steps": self._steps(T),
            "v_max": float(res["v_max"]),
            "frac_nonfinite": float(res["frac_nonfinite"]),
        }
        if strikes.shape[0] > 1:
            out["chain"] = [
                {"strike": float(k), "price": float(res["price"][i]),
                 "std_error": float(res["std_error"][i])}
                for i, k in enumerate(strikes)]
        return out

    def cos_price(self, spot: float, strikes, T: float,
                  is_call: bool = True) -> np.ndarray:
        """Semi-analytic oracle (exact up to COS truncation)."""
        return svcj_cos_price(self.params, spot, strikes, T, is_call)

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict:
        price, d_s, d_v0 = _svcj_delta_vega(
            self.params, spot, strike, T,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self._steps(T),
            is_call=is_call, device=self.device)
        host = to_host({"price": price, "dS": d_s, "dv0": d_v0})
        sigma0 = float(np.sqrt(float(self.params.v0)))
        return {
            "price": float(host["price"]),
            "delta": float(host["dS"]),
            # Vega per unit vol = ∂P/∂σ₀ = 2σ₀·∂P/∂v₀.
            "vega": 2.0 * sigma0 * float(host["dv0"]),
            "dP_dv0": float(host["dv0"]),
        }

    def smile(self, spot: float, T: float,
              strikes: Sequence[float]) -> Dict:
        """Exact COS-implied vols across strikes (no MC noise)."""
        from mcos_tpu_torch.engine.surface import implied_vol

        strikes = np.asarray(strikes, np.float64)
        prices = self.cos_price(spot, strikes, T, True)
        ivs = [implied_vol(float(c), spot, float(k), T,
                           float(self.params.r), float(self.params.q), True)
               for c, k in zip(prices, strikes)]
        return {
            "strikes": strikes.tolist(),
            "prices": [float(c) for c in prices],
            "iv": [None if v is None else float(v) for v in ivs],
        }

    def mc_vs_cos(self, spot: float, strikes, T: float,
                  is_call: bool = True) -> Dict:
        """MC-vs-oracle diagnostic rows (the /api/svcj compare mode)."""
        strikes = np.atleast_1d(np.asarray(strikes, np.float64))
        exact = self.cos_price(spot, strikes, T, is_call)
        res = self._core(spot, strikes.astype(np.float32), T, is_call)
        rows = []
        for i, k in enumerate(strikes):
            se = float(res["std_error"][i])
            rows.append({
                "strike": float(k),
                "mc_price": float(res["price"][i]),
                "cos_price": float(exact[i]),
                "std_error": se,
                "err_sigmas": float(abs(res["price"][i] - exact[i])
                                    / max(se, 1e-12)),
            })
        return {"rows": rows}
