r"""Stochastic local volatility (SLV) of the port (counterpart of
`mcos_tpu/engine/slv.py`): the particle method on a Dupire surface and a
Heston mix.

    dS/S = (r - q) dt + L(t, S) sqrt(v_t) dW1
    dv   = kappa (theta - v) dt + xi sqrt(v) dW2,   <dW1, dW2> = rho dt,

with the leverage fixed by the mimicking condition
L(t, S)^2 * E[v_t | S_t = S] = sigma_loc(t, S)^2, so the SLV marginals
match the Dupire surface while v keeps the smile's dynamics stochastic.

The particle method (Guyon & Henry-Labordere) runs as one torch step loop
on the device: at each step E[v_t | S_t] is estimated from the path cloud
by binning both antithetic branches in forward log-moneyness
(`torch.bincount` with weights over a fixed bin count, then a gather),
the leverage row is formed on the fly, and the step advances with L per
path. On a CUDA device `bincount` sums with atomics in no fixed order, so
the bin sums differ from the CPU's by float32 rounding.

Oracles: xi -> 0 collapses v to v0 and SLV to pure local vol; a flat
Dupire surface makes vanillas Black-Scholes. A sharded run (the JAX
package's `axis_name`) passes `pool`, which pools each step's bin
statistics over the shards (`parallel/families.py:sharded_slv_price`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mcos_tpu_torch.engine.localvol import (LocalVolSurface, _f32,
                                            _local_var_lookup)
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.simulate import (_pair_payoffs, _safe_sqrt,
                                         combine_antithetic)

_VAR_FLOOR, _VAR_CAP = 1e-6, 16.0
_LEV2_MIN, _LEV2_MAX = 0.01, 100.0      # leverage^2 clip (stability)


def slv_terminal(params: SVJParams, var_rows, t_mid, y0, dy, spot, T,
                 generator: Optional[torch.Generator] = None, *,
                 num_paths: Optional[int] = None,
                 num_steps: Optional[int] = None, n_bins: int = 101,
                 k_snapshot: int = -1, track_extremes: bool = False,
                 emit_sheet: bool = False,
                 normals: Optional[torch.Tensor] = None,
                 pool: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None, device="cuda") -> torch.Tensor:
    """(2, num_paths) terminal spots under the particle-calibrated SLV —
    or, with `k_snapshot >= 0`, a (2, 2, num_paths) stack of (S at step
    k_snapshot, S at T) for forward-start payoffs; with `track_extremes`,
    a (3, 2, num_paths) stack of (S_T, running max, running min) for
    barrier payoffs; with `emit_sheet`, the (num_steps, 2, num_paths)
    log(S/S0) sheet.

    `params` supplies the Heston block (kappa, theta, xi, rho, v0, r, q;
    jumps ignored); `var_rows`/`t_mid`/`y0`/`dy` are the Dupire table in
    the localvol engine's step-table layout. `normals`: an explicit
    (num_steps, 2, num_paths) sheet (z1 and z2 of each step); else drawn
    from `generator` up front on `device`.

    `pool`: one shard of a sharded cloud. Each step it takes this shard's
    (n_bins + 2,) float32 vector (bin sums of v, bin counts, the sum of v
    and the particle count) and returns the vector pooled over every
    shard, so that the leverage is estimated from the whole cloud.
    """
    if normals is None:
        normals = torch.randn((num_steps, 2, num_paths), generator=generator,
                              device=torch.device(device),
                              dtype=torch.float32)
    device = normals.device
    num_steps, _, num_paths = normals.shape
    p = params
    rows = _f32(var_rows, device)
    t_mid = _f32(t_mid, device)
    spot, T, r, q, y0, dy = (_f32(x, device)
                             for x in (spot, T, p.r, p.q, y0, dy))
    dt = T / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[:, None]
    n_y = rows.shape[1]
    y_hi = y0 + dy * (n_y - 1)
    bin_w = (y_hi - y0) / n_bins
    rho_perp = torch.sqrt(_f32(1.0 - p.rho * p.rho, device))
    prior = 16.0
    v_cnt = float(2 * num_paths)

    log_s = torch.zeros((2, num_paths), dtype=torch.float32, device=device)
    v = torch.full_like(log_s, float(np.float32(p.v0)))
    snap = mx = mn = log_s     # log(S/S0) = 0 seeds max/min with t_0
    sheet = []
    for k in range(num_steps):
        z1 = normals[k, 0][None] * sign
        z2 = normals[k, 1][None] * sign

        y = log_s - (r - q) * t_mid[k]                # (2, paths)
        sig_loc2 = torch.clamp(_local_var_lookup(rows[k], y, y0, dy),
                               _VAR_FLOOR, _VAR_CAP)

        # Particle estimate of E[v | S] by binning the cloud in y (both
        # antithetic branches pooled); each path reads its own bin's
        # mean, with a ~16-particle prior toward the cloud mean that
        # stabilizes near-empty wing bins.
        v_pos = torch.clamp(v, min=0.0)
        bins = torch.clamp(((y - y0) / bin_w).to(torch.int64), 0,
                           n_bins - 1).reshape(-1)
        v_flat = v_pos.reshape(-1)
        sums = torch.bincount(bins, weights=v_flat, minlength=n_bins)
        cnts = torch.bincount(bins, minlength=n_bins).to(torch.float32)
        if pool is None:
            ev_bin = (sums + prior * (torch.sum(v_flat) / v_cnt)) \
                / (cnts + prior)
        else:
            pooled = pool(torch.cat([
                sums, cnts, torch.sum(v_flat)[None],
                torch.full((1,), v_cnt, dtype=torch.float32,
                           device=device)]))
            ev_bin = ((pooled[:n_bins]
                       + prior * (pooled[-2] / pooled[-1]))
                      / (pooled[n_bins:2 * n_bins] + prior))
        ev = ev_bin[bins].reshape(2, num_paths)

        lev2 = torch.clamp(sig_loc2 / torch.clamp(ev, min=_VAR_FLOOR),
                           _LEV2_MIN, _LEV2_MAX)
        eff_var = lev2 * v_pos
        sig_eff = _safe_sqrt(eff_var)

        log_s = log_s + (r - q - 0.5 * eff_var) * dt \
            + sig_eff * z1 * sqrt_dt
        dw2 = p.rho * z1 + rho_perp * z2
        v = torch.clamp(v_pos + p.kappa * (p.theta - v_pos) * dt
                        + p.xi * _safe_sqrt(v_pos) * dw2 * sqrt_dt,
                        min=0.0)
        if k == k_snapshot:
            snap = log_s
        if track_extremes:
            mx = torch.maximum(mx, log_s)
            mn = torch.minimum(mn, log_s)
        if emit_sheet:
            sheet.append(log_s)
    if emit_sheet:
        return torch.stack(sheet)            # (n, 2, paths) log(S/S0)
    if track_extremes:
        return spot * torch.exp(torch.stack([log_s, mx, mn]))
    if k_snapshot >= 0:
        return spot * torch.exp(torch.stack([snap, log_s]))
    return spot * torch.exp(log_s)


class SLVEngine:
    """Particle-method SLV pricer on a Dupire surface + Heston mix, on
    `device`. Every call draws from `seeded_generator(seed, device)`, so
    calls share their paths (the CRN of `greeks`)."""

    def __init__(self, surface: LocalVolSurface, heston: SVJParams,
                 num_paths: int = 200_000, num_steps: int = 128,
                 n_bins: int = 101, seed: int = 42, device="cuda"):
        self.surface = surface
        self.heston = heston.replace(lambda_j=0.0, mu_j=0.0, sigma_j=1e-4,
                                     r=surface.r, q=surface.q)
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.n_bins = int(n_bins)
        self.seed = int(seed)
        self.device = torch.device(device)

    def _run(self, spot: float, T: float, num_steps: int, **kw
             ) -> torch.Tensor:
        rows, t_mid = self.surface.step_tables(T, num_steps)
        return slv_terminal(
            self.heston, rows, t_mid, float(self.surface.y_grid[0]),
            float(self.surface.y_grid[1] - self.surface.y_grid[0]),
            spot, T, seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=num_steps,
            n_bins=self.n_bins, device=self.device, **kw)

    def terminal(self, spot: float, T: float) -> torch.Tensor:
        return self._run(spot, T, self.num_steps)

    def _mean_se(self, pay: torch.Tensor, T: float):
        """(discounted mean, its population-std standard error) of the
        antithetic-combined (paths, ...) payoffs, on the host."""
        disc = float(np.exp(-float(self.heston.r) * T))
        host = torch.stack([torch.mean(pay, dim=0),
                            torch.std(pay, dim=0, correction=0)])
        host = host.cpu().numpy()
        return (disc * host[0].astype(np.float64),
                disc * host[1].astype(np.float64) / np.sqrt(pay.shape[0]))

    def price_forward_start(self, spot: float, t1: float, T: float,
                            k: float = 1.0,
                            is_call: bool = True) -> Dict[str, float]:
        """Forward-start performance option e^{-rT} E[(±(S_T/S_t1 − k))⁺]:
        where local vol's forward smile flattens and SLV's stochastic v
        keeps it."""
        k1 = max(min(int(round(t1 / T * self.num_steps)),
                     self.num_steps - 1), 0)
        s = self._run(spot, T, self.num_steps, k_snapshot=k1)
        ratio = s[1] / s[0]
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(torch.clamp(phi * (ratio - k), min=0.0))
        price, se = self._mean_se(pay, T)
        return {
            "price": float(price),
            "std_error": float(se),
            "t1_effective": (k1 + 1) * T / self.num_steps,
            "num_paths_used": self.num_paths,
        }

    def price_barrier(self, spot: float, strike: float, T: float,
                      barrier: float, is_call: bool = True,
                      knock: str = "out",
                      direction: str = None) -> Dict[str, float]:
        """Discretely-monitored barrier under SLV."""
        if direction is None:
            direction = "up" if barrier >= spot else "down"
        s = self._run(spot, T, self.num_steps, track_extremes=True)
        s_t, s_max, s_min = s[0], s[1], s[2]
        hit = s_max >= barrier if direction == "up" else s_min <= barrier
        alive = hit if knock == "in" else ~hit
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(
            torch.clamp(phi * (s_t - strike), min=0.0) * alive)
        price, se = self._mean_se(pay, T)
        return {
            "price": float(price),
            "std_error": float(se),
            "hit_fraction": float(torch.mean(hit.to(torch.float32))),
            "mixing_xi": float(self.heston.xi),
            "num_paths_used": self.num_paths,
        }

    def hedging_backtest(self, spot: float, strike: float, T: float,
                         is_call: bool = True,
                         num_days: int = None,
                         txn_cost_bps: float = 5.0,
                         slippage_bps: float = 2.0) -> Dict[str, object]:
        """Daily BS-delta replication P&L in the SLV world, on the
        sheet-driven hedge loop of `engine/risk.py`."""
        from mcos_tpu_torch.engine.risk import _hedge_paths_from_sheet

        if num_days is None:
            num_days = max(int(T * 252), 16)
        sheet = self._run(spot, T, int(num_days), emit_sheet=True)
        sheet = torch.movedim(sheet, 0, -1).reshape(-1, int(num_days))
        premium = self.price(spot, strike, T, is_call)["price"]
        sigma_h = float(np.sqrt(float(self.heston.v0)))
        pnl, _ = _hedge_paths_from_sheet(
            sheet, spot, strike, T, premium, sigma_h,
            float(self.heston.r), float(self.heston.q),
            num_days=int(num_days), is_call=is_call,
            txn_cost_bps=txn_cost_bps, slippage_bps=slippage_bps)
        pnl = pnl.cpu().numpy()
        return {
            "mean_pnl": float(pnl.mean()),
            "std_pnl": float(pnl.std()),
            "pnl_percentiles": {f"{p}%": float(np.percentile(pnl, p))
                                for p in (1, 5, 50, 95, 99)},
            "mixing_xi": float(self.heston.xi),
            "premium": premium,
        }

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True,
               rel_bump: float = 0.005) -> Dict[str, float]:
        """delta/gamma by CRN central differences of the engine price:
        the bin assignment is a discrete function of the cloud, so the
        bumps reprice through the whole self-calibrating loop."""
        h = spot * rel_bump
        pu = self.price(spot + h, strike, T, is_call)["price"]
        pm = self.price(spot, strike, T, is_call)
        pd = self.price(spot - h, strike, T, is_call)["price"]
        return {
            "price": pm["price"],
            "delta": (pu - pd) / (2 * h),
            "gamma": (pu - 2 * pm["price"] + pd) / h**2,
            "std_error": pm["std_error"],
        }

    def price(self, spot: float, strikes, T: float,
              is_call: bool = True) -> Dict[str, object]:
        strikes_arr = torch.atleast_1d(_f32(np.asarray(strikes, np.float32),
                                            self.device))
        pay = _pair_payoffs(self.terminal(spot, T), strikes_arr,
                            is_call)               # (paths, strikes)
        price, stderr = self._mean_se(pay, T)
        scalar = np.ndim(strikes) == 0
        return {
            "price": float(price[0]) if scalar else price.tolist(),
            "std_error": float(stderr[0]) if scalar else stderr.tolist(),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
            "mixing_xi": float(self.heston.xi),
        }
