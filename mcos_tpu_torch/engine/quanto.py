"""Quanto options: foreign-asset payoffs paid in domestic currency
(counterpart of `mcos_tpu/engine/quanto.py`).

A quanto call pays max(S_T − K, 0)·FX_fixed where S is a foreign-currency
asset. The change to the domestic risk-neutral measure tilts the asset's
drift by −ρ_fx σ_fx σ_S; under stochastic volatility the correction is
path-dependent:

    d log S = (r_f − q − ρ_fx σ_fx √v_t − v_t/2) dt + √v_t dW₁ + jumps,

discounted at the DOMESTIC rate r_d.

`_quanto_terminal` is a Python step loop of torch ops (the shared step
`_svj_step_core`, the tilt taken from the pre-step variance and subtracted
after the step), with a GBM companion leg on the same dW₁ under the
constant-vol tilt, whose expectation is the closed form `quanto_bs` (host
float64, copied; tests/test_torch_copies.py holds it equal to the JAX
package's): the exact companion control variate. No kernel of the repo
computes the tilted law; the JAX package runs a `lax.scan`.

Randoms: a `torch.Generator`, one step's (3, paths) normals and (paths,)
jump uniforms at a time, or `draws=(z, u)`, (steps, 3, paths) and
(steps, paths).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mcos_tpu_torch.config import DEFAULT_NUM_PATHS
from mcos_tpu_torch.engine.cliquet import _optimal_beta_adjust
from mcos_tpu_torch.engine.pricer import resolve_mesh, seeded_generator
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.simulate import (
    _f32,
    _safe_sqrt,
    _step_draws,
    _svj_step_core,
    combine_antithetic,
    mc_mean_stderr,
)


def quanto_bs(S: float, K: float, T: float, r_d: float, r_f: float,
              q: float, sigma: float, sigma_fx: float, rho_fx: float,
              is_call: bool = True) -> float:
    """Closed-form quanto Black-Scholes (constant vol).

    The domestic-measure drift of S is r_f - q - rho_fx sigma_fx sigma;
    discounting at r_d. Expressed through the vanilla pricer as
    BS(S, K, T, r = r_d, q_eff = r_d - (r_f - q - rho sigma_fx sigma)).
    """
    drift = r_f - q - rho_fx * sigma_fx * sigma
    q_eff = r_d - drift
    return float(bs_price(S, K, T, r_d, q_eff, sigma, is_call))


def _quanto_terminal(params: SVJParams, spot, T, r_d, sigma_fx, rho_fx,
                     generator: Optional[torch.Generator], *,
                     num_paths: int, num_steps: int, draws=None,
                     device="cuda"):
    """(2, paths) quanto-measure terminal spots for SVJ and the
    constant-vol GBM companion (same dW₁). `r_d` is not used by the
    dynamics (it discounts); kept for the reference's signature."""
    if draws is not None:
        device = draws[0].device
    device = torch.device(device)
    step_draws = _step_draws(draws, generator, (num_paths,), num_steps,
                             device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[:, None]
    spot = _f32(spot, device)
    rho_fx, sigma_fx = _f32(rho_fx, device), _f32(sigma_fx, device)
    sigma_cv = torch.sqrt(_f32(params.v0, device))
    # Companion: constant-vol quanto drift (exact closed form exists).
    g_drift = (params.r - params.q - rho_fx * sigma_fx * sigma_cv
               - 0.5 * sigma_cv**2) * dt
    log_s = log_g = torch.zeros((2, num_paths), dtype=torch.float32,
                                device=device)
    v = _f32(params.v0, device).expand(2, num_paths)
    for t in range(num_steps):
        z, u = step_draws(t)
        z1 = z[0] * sign
        # The tilt from the PRE-step variance (left-point rule, the same
        # convention as the Euler drift inside the core step).
        tilt = rho_fx * sigma_fx * _safe_sqrt(torch.clamp(v, min=0.0)) * dt
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z1,
                                  z[1] * sign, u[None, :], z[2] * sign)
        log_s = log_s - tilt
        log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
    return spot * torch.exp(log_s), spot * torch.exp(log_g)


def _quanto_payoffs(s: torch.Tensor, g: torch.Tensor, strike,
                    is_call: bool, control_variate: bool):
    """Pairs-collapsed (paths,) payoffs of the quanto vanilla on (2, paths)
    terminals, and of its companion control (None without the CV): what
    `QuantoEngine.price` and its mesh shards read."""
    phi = 1.0 if is_call else -1.0
    pay = combine_antithetic(torch.clamp(phi * (s - strike), min=0.0))
    if not control_variate:
        return pay, None
    return pay, combine_antithetic(torch.clamp(phi * (g - strike), min=0.0))


class QuantoEngine:
    """Quanto vanilla pricing under SVJ with an exact companion control, on
    `device` (default the card).

    `params.r` plays the FOREIGN rate r_f (the asset's own carry);
    `r_domestic` prices and discounts the payoff currency. mesh: None |
    "auto" | a `parallel.mesh.Mesh` (`resolve_mesh`); a resolved mesh
    shards `price` (`parallel/families.py:sharded_quanto_price`).
    """

    def __init__(self, params: SVJParams, r_domestic: float,
                 sigma_fx: float, rho_fx: float,
                 num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 64, seed: int = 42,
                 use_control_variate: bool = True, mesh=None, *,
                 device="cuda"):
        self.mesh = mesh
        self.params = params
        self.r_d = float(r_domestic)
        self.sigma_fx = float(sigma_fx)
        self.rho_fx = float(rho_fx)
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_cv = bool(use_control_variate)
        self.device = torch.device(device)

    def _draws(self, steps: int):
        """Replayed (z, u) for `steps` steps, or None: the simulator draws
        from the seeded generator. Tests override it."""
        return None

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True,
              fx_fixed: float = 1.0) -> Dict[str, float]:
        p = self.params
        sigma = np.sqrt(float(p.v0))
        ctrl_exact = quanto_bs(spot, strike, T, self.r_d, float(p.r),
                               float(p.q), float(sigma), self.sigma_fx,
                               self.rho_fx, is_call)
        out = {"num_paths_used": self.num_paths,
               "num_steps": self.num_steps,
               "quanto_adjustment_bs": ctrl_exact - float(bs_price(
                   spot, strike, T, self.r_d,
                   self.r_d - float(p.r) + float(p.q), sigma, is_call))}
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu_torch.parallel.families import sharded_quanto_price

            res = sharded_quanto_price(
                p, self.r_d, self.sigma_fx, self.rho_fx, spot, strike, T,
                self.seed, mesh=mesh, num_paths=self.num_paths,
                num_steps=self.num_steps, is_call=is_call,
                control_variate=self.use_cv, fx_fixed=fx_fixed)
            out["num_paths_used"] = int(res["num_paths_used"])
            if self.use_cv:
                out["cv_beta"] = float(res["cv_beta"])
            out["price"] = float(res["price"])
            out["std_error"] = float(res["std_error"])
            return out
        s, g = _quanto_terminal(
            p, spot, T, self.r_d, self.sigma_fx, self.rho_fx,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self.num_steps,
            draws=self._draws(self.num_steps), device=self.device)
        pay, ctrl = _quanto_payoffs(s, g, strike, is_call, self.use_cv)
        disc = float(np.exp(-self.r_d * T))
        if self.use_cv:
            out["cv_beta"], pay = _optimal_beta_adjust(pay, ctrl, ctrl_exact,
                                                       disc)
        mean, se = mc_mean_stderr(pay)
        out["price"] = fx_fixed * disc * float(mean)
        out["std_error"] = fx_fixed * disc * float(se)
        return out
        s, g = _quanto_terminal(
            p, spot, T, self.r_d, self.sigma_fx, self.rho_fx,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self.num_steps,
            draws=self._draws(self.num_steps), device=self.device)
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(torch.clamp(phi * (s - strike), min=0.0))
        disc = float(np.exp(-self.r_d * T))
        ctrl_exact = quanto_bs(spot, strike, T, self.r_d, float(p.r),
                               float(p.q), float(sigma), self.sigma_fx,
                               self.rho_fx, is_call)
        out = {"num_paths_used": self.num_paths,
               "num_steps": self.num_steps,
               "quanto_adjustment_bs": ctrl_exact - float(bs_price(
                   spot, strike, T, self.r_d,
                   self.r_d - float(p.r) + float(p.q), sigma, is_call))}
        if self.use_cv:
            ctrl = combine_antithetic(torch.clamp(phi * (g - strike),
                                                  min=0.0))
            out["cv_beta"], pay = _optimal_beta_adjust(pay, ctrl, ctrl_exact,
                                                       disc)
        mean, se = mc_mean_stderr(pay)
        out["price"] = fx_fixed * disc * float(mean)
        out["std_error"] = fx_fixed * disc * float(se)
        return out
