"""Forward-start and cliquet (ratchet) options under SVJ dynamics
(counterpart of `mcos_tpu/engine/cliquet.py`).

These are the forward-skew instruments: a cliquet's value is driven by the
distribution of future period returns, which a calibrated SVJ model prices
very differently from sticky-strike Black-Scholes.

- `simulate_period_log_returns`: a Python loop over reset periods, each a
  loop over the steps inside it (the shared step `_svj_step_core`); only
  the variance crosses a period boundary, the log carries restart at 0, and
  one period return is kept a period. The GBM companion leg rides the same
  dW₁. Torch ops on the device, as the JAX package runs a `lax.scan`: no
  kernel of the repo computes per-period returns.
- `CliquetEngine`: the clipped-sum cliquet and the forward-start
  performance option, each with the exact companion control (`cliquet_bs`,
  `forward_start_bs`, optimal β).

The closed forms are host float64, copied; tests/test_torch_copies.py holds
them equal to the JAX package's. A forward-start performance call is
Rubinstein (1991): Black-Scholes on the ratio S_T/S_t₁, which is
independent of F_t₁; the uncapped-sum cliquet decomposes per period into
clip(R, f, c) = f + (R−f)⁺ − (R−c)⁺, each term a forward-start call.

Randoms: a `torch.Generator`, one step's (3, paths) normals and (paths,)
jump uniforms at a time, or `draws=(z, u)`, (steps, 3, paths) and
(steps, paths), the layout of `termsvj._period_log_returns_td`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy.stats import norm

from mcos_tpu_torch.config import DEFAULT_NUM_PATHS
from mcos_tpu_torch.engine.pricer import resolve_mesh, seeded_generator
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.simulate import (
    _companion,
    _f32,
    _step_draws,
    _svj_step_core,
    combine_antithetic,
    mc_mean_stderr,
)


def _performance_call_undisc(k: float, tau: float, r: float, q: float,
                             sigma: float) -> float:
    """E[max(S_{t+τ}/S_t − k, 0)] under GBM: Black-76 on the gross return
    (forward F = e^{(r−q)τ}, unit notional)."""
    if k <= 0.0:
        return float(np.exp((r - q) * tau) - k)
    st = sigma * np.sqrt(tau)
    F = np.exp((r - q) * tau)
    d1 = (np.log(F / k) + 0.5 * st**2) / max(st, 1e-12)
    d2 = d1 - st
    return float(F * norm.cdf(d1) - k * norm.cdf(d2))


def forward_start_bs(t1: float, T: float, k: float, r: float, q: float,
                     sigma: float, is_call: bool = True) -> float:
    """Forward-start performance option e^{-rT}·E[max(±(S_T/S_t₁ − k), 0)].

    Rubinstein (1991): the ratio is lognormal over τ = T − t₁ and
    independent of S_t₁, so the t₁-measurability integrates out.
    """
    tau = T - t1
    call = np.exp(-r * T) * _performance_call_undisc(k, tau, r, q, sigma)
    if is_call:
        return float(call)
    # Parity on the ratio: E[ratio] = e^{(r−q)τ}.
    return float(call - np.exp(-r * T)
                 * (np.exp((r - q) * tau) - k))


def cliquet_bs(T: float, n_periods: int, r: float, q: float, sigma: float,
               local_floor: float, local_cap: float,
               notional: float = 1.0) -> float:
    """Uncapped-sum cliquet e^{-rT}·N·Σⱼ E[clip(Rⱼ, f, c)] under GBM.

    Period returns are iid, and clip(R, f, c) = f + (R−f)⁺ − (R−c)⁺: two
    forward-start calls per period. Exact only without the global floor/cap
    (those couple the periods); the MC handles the general contract.
    """
    tau = T / n_periods
    e_clip = (local_floor
              + _performance_call_undisc(1.0 + local_floor, tau, r, q, sigma)
              - _performance_call_undisc(1.0 + local_cap, tau, r, q, sigma))
    return float(notional * n_periods * e_clip * np.exp(-r * T))


def _cliquet_payoff(dlog: torch.Tensor, local_floor, local_cap, global_floor,
                    global_cap) -> torch.Tensor:
    """Clipped-sum cliquet payoff from (n_periods, 2, paths) log returns."""
    r_per = torch.clamp(torch.exp(dlog) - 1.0, min=local_floor, max=local_cap)
    total = torch.clamp(torch.sum(r_per, dim=0), min=global_floor,
                        max=global_cap)
    return combine_antithetic(total)


def _cliquet_legs(dlog_s: torch.Tensor, dlog_g: Optional[torch.Tensor],
                  local_floor, local_cap, global_floor, global_cap,
                  notional: float, control_variate: bool):
    """Pairs-collapsed (paths,) payoffs of the cliquet and of its control
    (None without the CV): `CliquetEngine.price_cliquet`'s and its mesh
    shards'. The control is the UNCAPPED-sum cliquet on the companion
    legs, exact in closed form (`cliquet_bs`); the global clip only
    weakens the correlation, it never biases (optimal β absorbs the
    slope)."""
    pay = notional * _cliquet_payoff(dlog_s, local_floor, local_cap,
                                     global_floor, global_cap)
    if not control_variate:
        return pay, None
    return pay, notional * _cliquet_payoff(dlog_g, local_floor, local_cap,
                                           -np.inf, np.inf)


def _optimal_beta_adjust(pay: torch.Tensor, ctrl: torch.Tensor,
                         ctrl_exact: float, discount: float):
    """(β*, payoffs adjusted by β*·(control − its exact undiscounted
    mean)): the per-contract optimal control-variate arithmetic of the
    cliquet, forward-start, quanto and basket pricers."""
    ctrl_c = ctrl - torch.mean(ctrl)
    var_c = float(torch.mean(ctrl_c**2))
    beta = (float(torch.mean((pay - torch.mean(pay)) * ctrl_c))
            / max(var_c, 1e-12) if var_c > 1e-12 else 0.0)
    return beta, pay - beta * (ctrl - ctrl_exact / discount)


def _period_loop(params: SVJParams, T, step_draws: Callable, *,
                 num_paths: int, n_periods: int, steps_per_period: int,
                 companion: bool, step_params: Optional[Callable] = None,
                 device="cuda"):
    """The period loop behind `simulate_period_log_returns` and
    `termsvj._period_log_returns_td`: (n_periods, 2, paths) log returns of S
    and of the companion (None without `companion`). `step_draws(t)` gives
    step t's (3, paths) normals and (paths,) uniforms, `step_params(t)` its
    parameters (default: `params` at every step)."""
    n_steps = n_periods * steps_per_period
    dt = _f32(T, device) / n_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[:, None]
    sigma_cv, g_drift = _companion(params, dt, device)
    zero = torch.zeros((2, num_paths), dtype=torch.float32, device=device)
    v = _f32(params.v0, device).expand(2, num_paths)
    dlog_s, dlog_g = [], []
    for period in range(n_periods):
        log_s = log_g = zero
        for t in range(period * steps_per_period,
                       (period + 1) * steps_per_period):
            z, u = step_draws(t)
            p_t = params if step_params is None else step_params(t)
            z1 = z[0] * sign
            log_s, v = _svj_step_core(p_t, dt, sqrt_dt, log_s, v, z1,
                                      z[1] * sign, u[None, :], z[2] * sign)
            if companion:
                log_g = log_g + g_drift + sigma_cv * sqrt_dt * z1
        dlog_s.append(log_s)
        dlog_g.append(log_g)
    return (torch.stack(dlog_s),
            torch.stack(dlog_g) if companion else None)


def simulate_period_log_returns(params: SVJParams, T,
                                generator: Optional[torch.Generator], *,
                                num_paths: int, n_periods: int,
                                steps_per_period: int,
                                companion: bool = True, draws=None,
                                device="cuda"):
    """(n_periods, 2, num_paths) per-period log returns of S (and of the GBM
    companion on the same dW₁, else None), antithetic branches on axis 1.

    Both branches share the jump uniform; the companion runs on the same
    signed z₁. Randoms: one step at a time from `generator`, or `draws` =
    (z, u) of shapes (steps, 3, num_paths) and (steps, num_paths).
    """
    if draws is not None:
        device = draws[0].device
    device = torch.device(device)
    n_steps = n_periods * steps_per_period
    return _period_loop(
        params, T, _step_draws(draws, generator, (num_paths,), n_steps,
                               device),
        num_paths=num_paths, n_periods=n_periods,
        steps_per_period=steps_per_period, companion=companion,
        device=device)


class CliquetEngine:
    """Cliquet and forward-start pricing with exact companion controls, on
    `device` (default the card); the paths come from a generator seeded
    with `seed`. mesh: None | "auto" | a `parallel.mesh.Mesh`
    (`resolve_mesh`); a resolved mesh shards `price_cliquet`
    (`parallel/families.py:sharded_cliquet_price`)."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 steps_per_period: int = 16, seed: int = 42,
                 use_control_variate: bool = True, mesh=None, *,
                 device="cuda"):
        self.mesh = mesh
        self.params = params
        self.num_paths = int(num_paths)
        self.steps_per_period = int(steps_per_period)
        self.seed = int(seed)
        self.use_control_variate = bool(use_control_variate)
        self.device = torch.device(device)

    def _draws(self, steps: int):
        """Replayed (z, u) for `steps` steps, or None: the simulator draws
        from the seeded generator. Tests override it."""
        return None

    def _returns(self, T, n_periods: int, steps_per_period: int):
        return simulate_period_log_returns(
            self.params, T, seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, n_periods=n_periods,
            steps_per_period=steps_per_period,
            companion=self.use_control_variate,
            draws=self._draws(n_periods * steps_per_period),
            device=self.device)

    def _cv(self, out, pay, ctrl_pay, ctrl_exact_disc, discount):
        out["cv_beta"], adj = _optimal_beta_adjust(pay, ctrl_pay,
                                                   ctrl_exact_disc, discount)
        mean, se = mc_mean_stderr(adj)
        out["price"] = discount * float(mean)
        out["std_error"] = discount * float(se)
        return out

    def price_cliquet(self, T: float, n_periods: int = 4,
                      local_floor: float = 0.0, local_cap: float = 0.08,
                      global_floor: float = 0.0,
                      global_cap: float = float("inf"),
                      notional: float = 1.0) -> Dict[str, float]:
        """N · clip(Σⱼ clip(Rⱼ, f_loc, c_loc), f_glob, c_glob), paid at T."""
        p = self.params
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu_torch.parallel.families import sharded_cliquet_price

            res = sharded_cliquet_price(
                p, T, self.seed, mesh=mesh, num_paths=self.num_paths,
                n_periods=n_periods, steps_per_period=self.steps_per_period,
                local_floor=local_floor, local_cap=local_cap,
                global_floor=global_floor, global_cap=global_cap,
                notional=notional, control_variate=self.use_control_variate)
            out = {
                "price": float(res["price"]),
                "std_error": float(res["std_error"]),
                "n_periods": n_periods,
                "num_paths_used": int(res["num_paths_used"]),
                "num_steps": n_periods * self.steps_per_period,
            }
            if self.use_control_variate:
                out["cv_beta"] = float(res["cv_beta"])
            return out
        dlog_s, dlog_g = self._returns(T, n_periods, self.steps_per_period)
        pay, ctrl_pay = _cliquet_legs(dlog_s, dlog_g, local_floor, local_cap,
                                      global_floor, global_cap, notional,
                                      self.use_control_variate)
        discount = float(np.exp(-float(p.r) * T))
        mean, se = mc_mean_stderr(pay)
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "n_periods": n_periods,
            "num_paths_used": self.num_paths,
            "num_steps": n_periods * self.steps_per_period,
        }
        if self.use_control_variate:
            ctrl_exact = cliquet_bs(
                T, n_periods, float(p.r), float(p.q),
                float(np.sqrt(float(p.v0))), local_floor, local_cap,
                notional)
            out = self._cv(out, pay, ctrl_pay, ctrl_exact, discount)
        return out

    def price_forward_start(self, t1: float, T: float, k: float = 1.0,
                            is_call: bool = True) -> Dict[str, float]:
        """Forward-start performance option max(±(S_T/S_t₁ − k), 0).

        Simulated as 2·steps_per_period one-step periods on a uniform grid
        over [0, T], the reset on the nearest step (exact when t1/T is a
        round fraction), the log return summed from the reset on.
        """
        p = self.params
        n_total = 2 * self.steps_per_period
        split = max(min(int(round(t1 / T * n_total)), n_total - 1), 1)
        dlog_s, dlog_g = self._returns(T, n_total, 1)
        ratio = torch.exp(torch.sum(dlog_s[split:], dim=0))
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(torch.clamp(phi * (ratio - k), min=0.0))
        discount = float(np.exp(-float(p.r) * T))
        mean, se = mc_mean_stderr(pay)
        t1_eff = split / n_total * T
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "t1_effective": t1_eff,
            "num_paths_used": self.num_paths,
            "num_steps": n_total,
        }
        if self.use_control_variate:
            ratio_g = torch.exp(torch.sum(dlog_g[split:], dim=0))
            ctrl_pay = combine_antithetic(
                torch.clamp(phi * (ratio_g - k), min=0.0))
            ctrl_exact = forward_start_bs(
                t1_eff, T, k, float(p.r), float(p.q),
                float(np.sqrt(float(p.v0))), is_call)
            out = self._cv(out, pay, ctrl_pay, ctrl_exact, discount)
        return out
