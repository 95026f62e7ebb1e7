"""Risk engine of the port (counterpart of `mcos_tpu/engine/risk.py`): stress
ladders, VaR/CVaR/tail metrics, liquidity stress, the delta-hedging
backtest and portfolio VaR with Euler contributions.

Where it runs:

- **Stress.** SVJ log-dynamics do not depend on S₀, so a spot shock is a
  payoff-axis transform on one shared path set,
      max(±((1+s)·S_T − K), 0) = (1+s) · max(±(S_T − K/(1+s)), 0),
  and the spot ladder plus the gap scenario are one strike-vectorized
  price. backend="cuda": `MonteCarloEngine(use_sobol=False)`, one K3
  `svj_terminal` launch (the JAX package's `mc_price_pallas` → K3 on the
  TPU), and one K3 launch per shocked vol member (a report takes its base
  member from the spot axis) or matrix vol row, every launch on the
  engine's seed: K3's Philox words depend on (seed, path, step) and not
  on the member's parameters, so common random numbers hold exactly.
  backend="torch": the step-loop twins on `StressTestEngine._draws`
  (`simulate_terminal_with_score` for the spot axis, the member twin
  `simulate_terminal_members` for the vol axis), the counterparts of the
  JAX package's scan and `vmap` of `mc_price_core` on one key.
- **Tail metrics.** Sort, quantile index and moments as torch ops on the
  device; the Hill estimator in numpy on the host.
- **Hedging.** A Python day loop of torch ops with every scenario in
  lockstep (the JAX `lax.scan` over days): the GBM world one normal a day,
  the SVJ world `ops/simulate._svj_step_core` on (3, n) normals and an (n,)
  uniform a day. The premium of those worlds is one K3 launch
  (`MonteCarloEngine(num_paths=50 000, use_sobol=False)`); the rough world
  runs the exact sampler of `ops/rough.py` (a matmul, no kernel).
- **Portfolio.** The correlated-GBM step loop of `randn @ chol.T` (a
  torch matmul: the JAX package computes that product outside any Pallas
  kernel too) and the Student-t copula, whose t CDF is a regularized
  incomplete beta evaluated in float64 on the device by Lentz's continued
  fraction (`betainc`: PyTorch has `ndtri` but no `betainc`).

Randoms: every PRNG-driven function takes a `torch.Generator` and,
optionally, the draws themselves, so the CPU tests replay the JAX keys'
draws. Every entry point takes an explicit `device` ("cuda" by default).
`portfolio_var(mesh=...)` shards the Gaussian copula's paths
(`parallel/mesh.py:sharded_portfolio_returns`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import (JUMP_SCENARIO_SIZE, SPOT_SHOCKS,
                                   VOL_SHOCKS, scaled_steps)
from mcos_tpu_torch.engine.greeks import _mc_price
from mcos_tpu_torch.engine.pricer import (MonteCarloEngine, _price_terminal,
                                          has_not_drawn, resolve_mesh,
                                          seeded_generator, to_host)
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import simulate
from mcos_tpu_torch.ops.bs import bs_delta, bs_gamma, bs_vega
from mcos_tpu_torch.ops.simulate import _f32

_FIELDS = tuple(SVJParams.__dataclass_fields__)


# ─────────────────────────────────────────────────────────────────────────────
# Tail risk metrics
# ─────────────────────────────────────────────────────────────────────────────
def _risk_metrics_device(returns: torch.Tensor, confidence: float = 0.99
                         ) -> Dict[str, torch.Tensor]:
    """Sorted-quantile VaR/CVaR and moments on the device (population std,
    as `jnp.std`); the quantile index is taken in Python float64."""
    sorted_r = torch.sort(returns).values
    n = returns.shape[0]
    cutoff = int(n * (1.0 - confidence))
    var = -sorted_r[min(cutoff, n - 1)]
    cvar = -torch.mean(sorted_r[:max(cutoff, 1)])
    mean = torch.mean(returns)
    std = torch.std(returns, correction=0)
    z = (returns - mean) / torch.clamp(std, min=1e-10)
    return {
        "var": var,
        "cvar": cvar,
        "skewness": torch.mean(z**3),
        "kurtosis": torch.mean(z**4),
        "mean": mean,
        "std": std,
        "sorted": sorted_r,
    }


def _hill_estimator(sorted_losses: np.ndarray, k: Optional[int] = None) -> float:
    """Hill tail-index on the top-k order statistics (risk.py:158-173)."""
    n = len(sorted_losses)
    if n < 2:
        return float("nan")
    if k is None:
        k = max(int(np.sqrt(n)), 10)
    k = min(k, n - 1)
    desc = np.sort(sorted_losses)[::-1]
    if desc[k] <= 0:
        return float("nan")
    log_ratios = np.log(desc[:k] / desc[k])
    s = log_ratios.sum()
    return float(k / s) if s > 0 else float("nan")


def compute_risk_metrics(returns, confidence: float = 0.99, *,
                         device="cuda") -> Dict[str, float]:
    """VaR, CVaR, skewness, kurtosis, Hill tail index (risk.py:117-155 key
    layout). A tensor stays on its device; anything else goes to `device`
    as float32. One device→host copy."""
    if isinstance(returns, torch.Tensor):
        returns = returns.to(torch.float32)
    else:
        returns = torch.as_tensor(np.asarray(returns, np.float32),
                                  device=device)
    m = to_host(_risk_metrics_device(returns, confidence=confidence))
    sorted_r = m["sorted"]
    losses = -sorted_r[sorted_r < 0]
    tail = _hill_estimator(losses) if len(losses) > 20 else float("nan")
    kurt = float(m["kurtosis"])
    return {
        "var": float(m["var"]),
        "cvar": float(m["cvar"]),
        "skewness": float(m["skewness"]),
        "kurtosis": kurt,
        "excess_kurtosis": kurt - 3.0,
        "tail_index": tail,
        "mean": float(m["mean"]),
        "std": float(m["std"]),
    }


# ─────────────────────────────────────────────────────────────────────────────
# Stress testing
# ─────────────────────────────────────────────────────────────────────────────
def _stack_members(members: Sequence[SVJParams], device) -> SVJParams:
    """A members batch: every leaf an (M,) float32 tensor on `device`, as
    the JAX package stacks its `vmap` batch."""
    return SVJParams(**{
        f: torch.tensor([float(getattr(m, f)) for m in members],
                        dtype=torch.float32, device=device)
        for f in _FIELDS})


def _params_batch_price_grid(params_batch: SVJParams, spot, strikes, T,
                             draws, *, num_paths: int, num_steps: int,
                             is_call: bool) -> torch.Tensor:
    """(n_params, n_strikes) CRN price grid on the member twin: every member
    on the same draws (z, u), (steps, 3, paths) normals and (steps, paths)
    uniforms, the counterpart of the JAX `vmap` of `mc_price_core` on one
    key (companion control variate, β = 1)."""
    z, u = draws
    if tuple(u.shape) != (num_steps, num_paths):
        raise ValueError(f"draws are {tuple(u.shape)}, not "
                         f"({num_steps}, {num_paths})")
    strikes = torch.atleast_1d(_f32(strikes, z.device))
    with torch.no_grad():
        s_final, g_final, _ = simulate.simulate_terminal_members(
            params_batch, spot, T, draws=draws)
        return _mc_price(params_batch, s_final, g_final, spot, strikes, T,
                         is_call)


def _params_batch_prices(params_batch: SVJParams, spot, strike, T, draws, *,
                         num_paths: int, num_steps: int,
                         is_call: bool) -> torch.Tensor:
    """CRN prices of one contract under a batch of parameterizations
    (`_params_batch_price_grid` at one strike), shape (n_params,)."""
    return _params_batch_price_grid(
        params_batch, spot, [strike], T, draws, num_paths=num_paths,
        num_steps=num_steps, is_call=is_call)[:, 0]


class StressTestEngine:
    """Scenario ladders with reference semantics (risk.py:23-111 API) on
    `device`.

    backend="cuda": the spot axis (ladder and gap) is one K3 launch, each
    shocked vol member (`full_stress_report`) or vol row
    (`scenario_matrix`) one more, all on the engine's seed; on a CPU device the wrappers run K3's
    plain version. backend="torch": the twins on `_draws` (a generator
    seeded with the engine's seed).
    """

    def __init__(self, params: SVJParams, num_paths: int = 200_000,
                 seed: int = 42, num_steps: int = 252, *,
                 backend: str = "cuda", device="cuda"):
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.backend = backend
        self.device = torch.device(device)
        self._draw_cache: tuple = (None, None)

    def _engine(self, params: SVJParams) -> MonteCarloEngine:
        return MonteCarloEngine(params, num_paths=self.num_paths,
                                num_steps=self.num_steps, seed=self.seed,
                                use_sobol=False, device=self.device)

    def _draws(self, steps: int):
        """backend="torch": the (z, u) of `steps` steps from a generator
        seeded with the engine's seed on its device, one set cached."""
        key = (steps, self.num_paths, self.seed, str(self.device))
        if self._draw_cache[0] != key:
            self._draw_cache = (key, simulate._euler_draws(
                None, seeded_generator(self.seed, self.device),
                self.num_paths, steps, self.device))
        return self._draw_cache[1]

    def _steps(self, T: float) -> int:
        return scaled_steps(self.num_steps, T)

    def _member_prices(self, members: Sequence[SVJParams], spot, strikes,
                       T, is_call: bool) -> torch.Tensor:
        """(n_members, n_strikes) CRN prices on the device, unsynced."""
        if self.backend == "cuda":
            return torch.stack([
                self._engine(m)._price_result(spot, strikes, T,
                                              is_call)["price"]
                for m in members])
        steps = self._steps(T)
        return _params_batch_price_grid(
            _stack_members(members, self.device), spot, strikes, T,
            self._draws(steps), num_paths=self.num_paths, num_steps=steps,
            is_call=is_call)

    # -- shared scenario construction / formatting ---------------------------
    def _shock_prices_device(self, spot: float, strike: float, T: float,
                             is_call: bool, shocks: np.ndarray):
        """Enqueue prices at spot·(1+sᵢ): ONE batched program off one shared
        path set; returns (rel, the device result dict), unsynced."""
        rel = 1.0 + np.asarray(shocks, np.float64)
        strikes = (strike / rel).astype(np.float32)
        if self.backend == "cuda":
            return rel, self._engine(self.params)._price_result(
                spot, strikes, T, is_call)
        s_final, v_final, g_final, _ = simulate.simulate_terminal_with_score(
            self.params, spot, T, draws=self._draws(self._steps(T)))
        return rel, _price_terminal(self.params, spot, strikes, T, s_final,
                                    v_final, g_final, is_call, True,
                                    "companion", "one")

    def _shock_prices(self, spot: float, strike: float, T: float,
                      is_call: bool, shocks: np.ndarray) -> np.ndarray:
        rel, res = self._shock_prices_device(spot, strike, T, is_call,
                                             shocks)
        return np.asarray(res["price"].cpu().numpy(), np.float64) * rel

    def _vol_members(self):
        """Base + shocked params per the reference convention
        (risk.py:60-67: v0 += 2√v0·s, θ += s², 0.001 floors)."""
        v0_base = float(self.params.v0)
        members = [self.params]
        v0s = []
        for shock in VOL_SHOCKS:
            v0 = max(v0_base + 2.0 * v0_base**0.5 * shock, 0.001)
            theta = max(float(self.params.theta) + shock**2, 0.001)
            members.append(self.params.replace(v0=v0, theta=theta))
            v0s.append(v0)
        return members, v0s

    def _vol_prices_device(self, spot, strike, T, is_call, base=None):
        """Enqueue the (base + shocks) CRN members, unsynced: (v0s, (M,)).
        backend="cuda" with `base`, a (1,) tensor holding the unshocked
        price of the same seed, paths and steps (the spot axis's first
        entry), prices the shocked members only and puts `base` first."""
        members, v0s = self._vol_members()
        strikes = np.array([strike], np.float32)
        if self.backend == "cuda" and base is not None:
            shocked = self._member_prices(members[1:], spot, strikes, T,
                                          is_call)[:, 0]
            return v0s, torch.cat([base, shocked])
        prices = self._member_prices(members, spot, strikes, T,
                                     is_call)[:, 0]
        return v0s, prices

    @staticmethod
    def _format_spot_rows(spot, shocks, prices, base) -> List[Dict]:
        return [
            {
                "shock_pct": shock * 100,
                "spot": spot * (1.0 + shock),
                "price": float(price),
                "pnl": float(price - base),
                "pnl_pct": float((price - base) / max(base, 1e-6) * 100),
            }
            for shock, price in zip(shocks, prices)
        ]

    @staticmethod
    def _format_vol_rows(v0s, prices) -> List[Dict]:
        base = float(prices[0])
        return [
            {
                "vol_shock": shock * 100,
                "v0": v0,
                "price": float(price),
                "pnl": float(price - base),
            }
            for shock, v0, price in zip(VOL_SHOCKS, v0s, prices[1:])
        ]

    @staticmethod
    def _format_jump(base, down, up, gap_size) -> Dict:
        return {
            "base_price": float(base),
            "gap_down_price": float(down),
            "gap_down_pnl": float(down - base),
            "gap_up_price": float(up),
            "gap_up_pnl": float(up - base),
            "gap_size_pct": gap_size * 100,
        }

    # -- reference API ------------------------------------------------------
    def spot_shock_ladder(self, spot: float, strike: float, T: float,
                          is_call: bool = True) -> List[Dict]:
        """Spot ±2/5/8% ladder (risk.py:33-51) as one vectorized call."""
        shocks = np.asarray(SPOT_SHOCKS, np.float64)
        prices = self._shock_prices(spot, strike, T, is_call,
                                    np.concatenate([[0.0], shocks]))
        return self._format_spot_rows(spot, shocks, prices[1:], prices[0])

    def vol_shock_ladder(self, spot: float, strike: float, T: float,
                         is_call: bool = True) -> List[Dict]:
        """±5 vol-point shocks mapped into (v0, θ) exactly as the reference
        does (risk.py:60-67); base + both shocks on common random numbers."""
        v0s, prices = self._vol_prices_device(spot, strike, T, is_call)
        return self._format_vol_rows(v0s, prices.cpu().numpy())

    def jump_scenario(self, spot: float, strike: float, T: float,
                      is_call: bool = True,
                      gap_size: float = JUMP_SCENARIO_SIZE) -> Dict:
        """4% overnight gap, both directions (risk.py:80-102), one call."""
        prices = self._shock_prices(spot, strike, T, is_call,
                                    np.array([0.0, -gap_size, gap_size]))
        return self._format_jump(prices[0], prices[1], prices[2], gap_size)

    def full_stress_report(self, spot: float, strike: float, T: float,
                           is_call: bool = True) -> Dict:
        """All scenarios (risk.py:104-111): the spot ladder and the gap on
        one shared path set, the vol members beside it, both enqueued
        before one device→host copy. backend="cuda" reads the base member
        off the spot axis (the same K3 launch's unshocked price), so a
        report is 1 + len(VOL_SHOCKS) launches."""
        gap = JUMP_SCENARIO_SIZE
        spot_shocks = np.asarray(SPOT_SHOCKS, np.float64)
        rel, dev_spot = self._shock_prices_device(
            spot, strike, T, is_call,
            np.concatenate([[0.0], spot_shocks, [-gap, gap]]))
        v0s, dev_vol = self._vol_prices_device(spot, strike, T, is_call,
                                               base=dev_spot["price"][:1])

        host = to_host({"price": dev_spot["price"], "vol": dev_vol})
        prices = np.asarray(host["price"], np.float64) * rel
        base = prices[0]
        n_spot = len(spot_shocks)
        return {
            "spot_shocks": self._format_spot_rows(
                spot, spot_shocks, prices[1:n_spot + 1], base),
            "vol_shocks": self._format_vol_rows(v0s, host["vol"]),
            "jump_scenario": self._format_jump(
                base, prices[n_spot + 1], prices[n_spot + 2], gap),
        }

    def scenario_matrix(self, spot: float, strike: float, T: float,
                        is_call: bool = True,
                        spot_shocks=None, vol_shocks=None) -> Dict:
        """Full spot×vol scenario P&L matrix, the desk "risk cube": rows are
        vol shocks (vol points), columns spot shocks, every cell on common
        random numbers. A zero shock is inserted on each axis if absent so
        the P&L anchor is the unshocked price."""
        spot_shocks = np.asarray(
            SPOT_SHOCKS if spot_shocks is None else spot_shocks, np.float64)
        vol_shocks = np.asarray(
            VOL_SHOCKS if vol_shocks is None else vol_shocks, np.float64)
        spot_shocks = np.unique(np.concatenate([spot_shocks, [0.0]]))
        vol_shocks = np.unique(np.concatenate([vol_shocks, [0.0]]))
        i0 = int(np.searchsorted(vol_shocks, 0.0))
        j0 = int(np.searchsorted(spot_shocks, 0.0))

        rel = 1.0 + spot_shocks
        v0_base = float(self.params.v0)
        members, v0s = [], []
        for shock in vol_shocks:
            if shock == 0.0:
                members.append(self.params)
                v0s.append(v0_base)
                continue
            v0 = max(v0_base + 2.0 * v0_base**0.5 * shock, 0.001)
            theta = max(float(self.params.theta) + shock**2, 0.001)
            members.append(self.params.replace(v0=v0, theta=theta))
            v0s.append(v0)
        grid = self._member_prices(members, spot,
                                   (strike / rel).astype(np.float32), T,
                                   is_call)
        prices = (np.asarray(grid.cpu().numpy(), np.float64)
                  * rel[None, :])
        base = prices[i0, j0]
        return {
            "spot_shocks_pct": (spot_shocks * 100).tolist(),
            "vol_shocks_pts": (vol_shocks * 100).tolist(),
            "spots": (spot * rel).tolist(),
            "v0s": [float(v) for v in v0s],
            "base_price": float(base),
            "prices": [[float(x) for x in row] for row in prices],
            "pnl": [[float(x - base) for x in row] for row in prices],
        }


# ─────────────────────────────────────────────────────────────────────────────
# Liquidity stress layer
# ─────────────────────────────────────────────────────────────────────────────
class LiquidityStress:
    """NIFTY-weekly liquidity scenarios (risk.py:179-221 API)."""

    @staticmethod
    def bid_ask_widening(base_spread: float,
                         widening_factor: float = 3.0) -> Dict:
        stressed = base_spread * widening_factor
        return {
            "base_spread": base_spread,
            "stressed_spread": stressed,
            "slippage_increase": stressed - base_spread,
        }

    @staticmethod
    def vol_gap_no_spot_move(params: SVJParams,
                             vol_jump: float = 0.05) -> SVJParams:
        """Vol spike, spot unchanged: v0 → (√v0 + jump)² (risk.py:195-206)."""
        new_v0 = (float(params.v0)
                  + 2.0 * float(params.v0) ** 0.5 * vol_jump + vol_jump**2)
        return params.replace(v0=new_v0)

    @staticmethod
    def expiry_vol_crush(params: SVJParams,
                         crush_pct: float = 0.30) -> SVJParams:
        """Expiry-day IV crush: v0 ×(1−c), θ ×(1−c/2) (risk.py:209-221)."""
        return params.replace(
            v0=max(float(params.v0) * (1 - crush_pct), 0.001),
            theta=max(float(params.theta) * (1 - crush_pct * 0.5), 0.001),
        )


# ─────────────────────────────────────────────────────────────────────────────
# Hedging backtest: a day loop, every scenario in lockstep
# ─────────────────────────────────────────────────────────────────────────────
def _hedge_paths(params: SVJParams, spot, strike, T, premium,
                 generator: Optional[torch.Generator] = None, *,
                 num_days: int, num_scenarios: int, is_call: bool,
                 txn_cost_bps: float, slippage_bps: float,
                 dynamics: str = "gbm", hedge: str = "bs_delta",
                 risk_aversion: float = 1e-3, draws=None, device="cuda"):
    """All hedge scenarios in lockstep (the vectorized form of
    risk.py:264-317): a short option hedged daily, returns (pnl, cost),
    each (num_scenarios,).

    dynamics="gbm" is the reference's world, GBM at √v0; "svj" steps the
    full jump-diffusion with `_svj_step_core` (any other value runs the GBM
    world, as in the JAX package). hedge="bs_delta" rebalances to the BS
    delta at σ = √v0; "mv_delta" to Δ + ρξ·decay·vega_BS/(2σS) with
    decay = (1 − e^{−κτ})/(κτ); "ww_band" trades to the nearest edge of
    the Whalley-Wilmott band Δ ± (3/2·k·S·Γ²/γ)^{1/3}.

    Randoms: each day's draws come from `generator` as they are needed
    (GBM: (n,) normals; SVJ: (3, n) normals, then (n,) uniforms), or from
    `draws` = (z, u): z (days, n) and u None in the GBM world, z (days, 3,
    n) and u (days, n) in the SVJ world.
    """
    svj = dynamics == "svj"
    device = draws[0].device if draws is not None else torch.device(device)
    n = int(num_scenarios)
    f32 = dict(dtype=torch.float32, device=device)
    spot_t, strike_t = _f32(spot, device), _f32(strike, device)
    r_t, q_t, v0_t = (_f32(x, device) for x in (params.r, params.q,
                                                params.v0))
    dt = _f32(T, device) / num_days
    sqrt_dt = torch.sqrt(dt)
    sigma = torch.sqrt(v0_t)
    cost_rate = (txn_cost_bps + slippage_bps) / 10_000.0
    gbm_drift = (r_t - q_t - 0.5 * v0_t) * dt
    gbm_vol = torch.sqrt(v0_t * dt)

    log_s = torch.zeros(n, **f32)
    v = torch.full((n,), float(np.float32(params.v0)), **f32)
    cash = torch.full((n,), float(np.float32(premium)), **f32)
    shares = torch.zeros(n, **f32)
    cost_acc = torch.zeros(n, **f32)
    t_remaining = _f32(T, device)
    for day in range(num_days):
        s = spot_t * torch.exp(log_s)
        t_left = torch.clamp(t_remaining, min=1e-6)
        delta = bs_delta(s, strike_t, t_left, r_t, q_t, sigma, is_call)
        if hedge == "mv_delta":
            # h* = Δ + ρξ·P_v/S with P_v ≈ vega_BS/(2σ)·(1−e^{−κτ})/(κτ).
            ktau = params.kappa * t_left
            decay = torch.where(ktau > 1e-6, -torch.expm1(-ktau)
                                / torch.clamp(ktau, min=1e-6),
                                torch.ones_like(ktau))
            delta = delta + params.rho * params.xi * decay * bs_vega(
                s, strike_t, t_left, r_t, q_t, sigma) / (2 * sigma * s)
        if hedge == "ww_band":
            # The optimal policy trades to the NEAREST band edge, which the
            # clamp encodes exactly; zero cost collapses the band to delta.
            gamma_bs = bs_gamma(s, strike_t, t_left, r_t, q_t, sigma)
            half_band = (1.5 * cost_rate * s * gamma_bs**2
                         / risk_aversion) ** (1.0 / 3.0)
            target = torch.clamp(shares, delta - half_band,
                                 delta + half_band)
        else:
            target = delta
        trade = target - shares
        cost = torch.abs(trade) * s * cost_rate
        cash = cash - trade * s - cost
        shares = target
        if svj:
            if draws is not None:
                z, u = draws[0][day], draws[1][day]
            else:
                z = torch.randn((3, n), generator=generator, **f32)
                u = torch.rand((n,), generator=generator, **f32)
            log_s, v = simulate._svj_step_core(params, dt, sqrt_dt, log_s,
                                               v, z[0], z[1], u, z[2])
        else:
            z = (draws[0][day] if draws is not None
                 else torch.randn((n,), generator=generator, **f32))
            log_s = log_s + gbm_drift + gbm_vol * z
        cost_acc = cost_acc + cost
        t_remaining = t_remaining - dt
    s = spot_t * torch.exp(log_s)
    payoff = simulate.vanilla_payoff(s, strike_t, is_call)
    return cash + shares * s - payoff, cost_acc


def _hedge_paths_from_sheet(log_sheet: torch.Tensor, spot, strike, T,
                            premium, sigma_h, r, q, *, num_days: int,
                            is_call: bool, txn_cost_bps: float,
                            slippage_bps: float):
    """Delta-hedge over a PRE-SIMULATED (scenarios, num_days) log(S/S0)
    sheet on its device, for non-Markovian worlds (rough Bergomi) whose
    spot cannot be stepped inside the day loop. Same accounting as
    `_hedge_paths`; the hedge ratio is the BS delta at `sigma_h`."""
    device = log_sheet.device
    spot_t, strike_t, sigma_t, r_t, q_t = (
        _f32(x, device) for x in (spot, strike, sigma_h, r, q))
    dt = _f32(T, device) / num_days
    cost_rate = (txn_cost_bps + slippage_bps) / 10_000.0
    n_scen = log_sheet.shape[0]
    log_s = torch.zeros(n_scen, dtype=torch.float32, device=device)
    cash = torch.full((n_scen,), float(np.float32(premium)),
                      dtype=torch.float32, device=device)
    shares = torch.zeros_like(log_s)
    cost_acc = torch.zeros_like(log_s)
    t_remaining = _f32(T, device)
    for day in range(num_days):
        s = spot_t * torch.exp(log_s)
        delta = bs_delta(s, strike_t, torch.clamp(t_remaining, min=1e-6),
                         r_t, q_t, sigma_t, is_call)
        trade = delta - shares
        cost = torch.abs(trade) * s * cost_rate
        cash = cash - trade * s - cost
        log_s = log_sheet[:, day]
        shares = delta
        cost_acc = cost_acc + cost
        t_remaining = t_remaining - dt
    s = spot_t * torch.exp(log_s)
    payoff = simulate.vanilla_payoff(s, strike_t, is_call)
    return cash + shares * s - payoff, cost_acc


class HedgingBacktest:
    """Daily delta-hedge backtest of a short option (risk.py:227-337 API)
    on `device`; the gbm/svj premium is one K3 launch (its plain version on
    a CPU device)."""

    def __init__(self, params: SVJParams, seed: int = 42, *, device="cuda"):
        self.params = params
        self.seed = int(seed)
        self.device = torch.device(device)

    def _rough_world(self, spot, strike, T, is_call, num_days: int,
                     num_scenarios: int, num_mc_paths: int):
        """(log sheet (scenarios, days), premium) of the rough-Bergomi
        world: the exact sampler (one matmul), premium on seed + 1 and the
        sheet on the seed, as the JAX package keys them."""
        from mcos_tpu_torch.ops.rough import (RoughBergomiParams,
                                              rbergomi_chol_device,
                                              rbergomi_conditional_payoffs,
                                              rbergomi_log_paths)

        p = self.params
        rp = RoughBergomiParams(xi=float(p.v0), eta=1.9, rho=-0.9,
                                r=float(p.r), q=float(p.q), hurst=0.07)
        chol = rbergomi_chol_device(rp.hurst, float(T), num_days,
                                    device=self.device)
        pay = rbergomi_conditional_payoffs(
            rp, spot, [strike], T, chol,
            seeded_generator(self.seed + 1, self.device),
            num_paths=num_mc_paths, num_steps=num_days, is_call=is_call,
            device=self.device)
        premium = float(np.exp(-float(p.r) * T) * float(torch.mean(pay)))
        half = max(int(num_scenarios) // 2, 1)
        sheet = rbergomi_log_paths(
            rp, T, chol, seeded_generator(self.seed, self.device),
            num_paths=half, num_steps=num_days, device=self.device)
        return sheet.reshape(-1, num_days), premium

    def run_backtest(
        self,
        spot: float,
        strike: float,
        T: float,
        is_call: bool = True,
        num_days: Optional[int] = None,
        txn_cost_bps: float = 5.0,
        slippage_bps: float = 2.0,
        num_scenarios: int = 1000,
        num_mc_paths: int = 50_000,
        dynamics: str = "gbm",
        hedge: str = "bs_delta",
        risk_aversion: float = 1e-3,
    ) -> Dict:
        """dynamics: "gbm" (the reference's constant-vol world), "svj" (the
        jump-diffusion: gap risk and vega bleed against a delta-only hedge)
        or "rough" (a rough-Bergomi path sheet, premium by the rough
        sampler, the hedge the BS delta at σ = √v0). hedge: "bs_delta",
        "mv_delta" or "ww_band" (gbm/svj worlds only). Raises ValueError as
        the JAX package does."""
        if hedge not in ("bs_delta", "mv_delta", "ww_band"):
            raise ValueError(f"unknown hedge {hedge!r} (expected "
                             "'bs_delta', 'mv_delta' or 'ww_band')")
        if hedge != "bs_delta" and dynamics == "rough":
            raise ValueError(f"hedge={hedge!r} supports gbm/svj dynamics "
                             "only (the rough world replays a fixed sheet "
                             "with the desk BS delta)")
        if risk_aversion <= 0.0:
            raise ValueError("risk_aversion must be positive")
        if num_days is None:
            num_days = max(int(T * 252), 1)
        num_days = int(num_days)

        if dynamics == "rough":
            sheet, premium = self._rough_world(spot, strike, T, is_call,
                                               num_days, num_scenarios,
                                               num_mc_paths)
            p = self.params
            pnl, cost = _hedge_paths_from_sheet(
                sheet, spot, strike, T, premium,
                torch.sqrt(_f32(p.v0, self.device)), p.r, p.q,
                num_days=num_days, is_call=is_call,
                txn_cost_bps=txn_cost_bps, slippage_bps=slippage_bps)
        else:
            # The premium is received once (the reference re-prices it per
            # scenario: same expectation, extra work).
            eng = MonteCarloEngine(self.params, num_paths=num_mc_paths,
                                   seed=self.seed, use_sobol=False,
                                   device=self.device)
            premium = eng.price(spot, strike, T, is_call)["price"]
            pnl, cost = _hedge_paths(
                self.params, spot, strike, T, premium,
                seeded_generator(self.seed, self.device),
                num_days=num_days, num_scenarios=int(num_scenarios),
                is_call=is_call, txn_cost_bps=txn_cost_bps,
                slippage_bps=slippage_bps, dynamics=dynamics, hedge=hedge,
                risk_aversion=risk_aversion, device=self.device)
        host = to_host({"pnl": pnl, "cost": cost})
        pnl_h = host["pnl"]
        return {
            "dynamics": dynamics,
            "hedge": hedge,
            "mean_pnl": float(pnl_h.mean()),
            "std_pnl": float(pnl_h.std()),
            "pnl_percentiles": {
                f"{p}%": float(np.percentile(pnl_h, p))
                for p in (1, 5, 25, 50, 75, 95, 99)
            },
            "risk_metrics": compute_risk_metrics(pnl, confidence=0.99),
            "num_scenarios": int(num_scenarios),
            "total_txn_cost_avg": float(host["cost"].mean()),
            "premium": float(premium),
        }


# ─────────────────────────────────────────────────────────────────────────────
# Multi-asset correlated GBM (portfolio VaR)
# ─────────────────────────────────────────────────────────────────────────────
def _corr_cholesky(corr, device) -> torch.Tensor:
    """Lower float32 Cholesky factor of `corr` (taken on the host, as small
    as the asset count), on `device`. The float32 matrix is symmetrized,
    (c + cᵀ)/2, as the JAX package's `cholesky` does. ValueError unless
    `corr` is a finite, square matrix, symmetric to float32 rounding (rtol
    1e-6, atol 1e-7) and positive definite: the JAX package takes its
    factor unchecked, and a matrix that is not positive definite prices
    every figure to NaN."""
    try:
        c = np.asarray(corr, np.float64)
    except ValueError:
        raise ValueError("corr must be a square matrix of numbers")
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError("corr must be a square matrix")
    if not np.isfinite(c).all() or not np.allclose(c, c.T, rtol=1e-6,
                                                   atol=1e-7):
        raise ValueError("corr must be a finite symmetric matrix")
    c32 = torch.as_tensor(c, dtype=torch.float32)
    chol, info = torch.linalg.cholesky_ex((c32 + c32.T) / 2)
    if int(info) != 0 or not bool(torch.isfinite(chol).all()):
        raise ValueError("corr is not positive definite")
    return chol.to(device)


def multi_asset_gbm_terminal(spots, sigmas, corr, r, q, T,
                             generator: Optional[torch.Generator] = None, *,
                             num_paths: int, num_steps: int, draws=None,
                             device="cuda") -> torch.Tensor:
    """Terminal spots of A correlated GBMs, shape (num_paths, A): a step
    loop of Cholesky-mixed normals (`randn @ chol.T`), log-space
    accumulation, one exp at the end. Each step's (num_paths, A) normals
    come from `generator`, or from `draws`, a (num_steps, num_paths, A)
    tensor."""
    device = draws.device if draws is not None else torch.device(device)
    spots = _f32(np.asarray(spots, np.float32), device)
    sigmas = _f32(np.asarray(sigmas, np.float32), device)
    n_assets = spots.shape[0]
    chol_t = _corr_cholesky(corr, device).T
    dt = _f32(T, device) / num_steps
    drift = (r - q - 0.5 * sigmas**2) * dt
    vol = sigmas * torch.sqrt(dt)
    log_s = torch.log(spots).expand(num_paths, n_assets)
    for step in range(num_steps):
        z = (draws[step] if draws is not None else torch.randn(
            (num_paths, n_assets), generator=generator, device=device,
            dtype=torch.float32))
        log_s = log_s + drift + vol * (z @ chol_t)
    return torch.exp(log_s)


#: Iteration cap of the incomplete beta's continued fraction; for
#: b = 1/2 and a ≤ 150 (ν ≤ 300) it converges in well under 100.
BETAINC_MAX_ITER = 300
_BETAINC_EPS = 1e-15
_BETAINC_TINY = 1e-300
#: Continued-fraction iterations between the early-exit checks (each check
#: is one device→host read).
_BETAINC_CHECK = 16


def _betacf(a, b, x: torch.Tensor, max_iter: int) -> torch.Tensor:
    """Lentz's modified continued fraction of I_x(a, b) (Numerical Recipes
    §6.4), float64 elementwise; an element stops updating once its step
    factor is within 1e-15 of 1, and the loop ends when every element has
    stopped or after `max_iter` iterations."""
    tiny = _BETAINC_TINY

    def guard(t):
        return torch.where(t.abs() < tiny, torch.full_like(t, tiny), t)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / guard(1.0 - qab * x / qap)
    h = d
    active = torch.ones_like(x, dtype=torch.bool)
    for m in range(1, max_iter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        step = d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        delta = d * c
        h = torch.where(active, h * step * delta, h)
        active = active & ((delta - 1.0).abs() > _BETAINC_EPS)
        if m % _BETAINC_CHECK == 0 and not bool(active.any()):
            break
    return h


def betainc(a: float, b: float, x, max_iter: int = BETAINC_MAX_ITER,
            complement=None) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b) for scalar a, b > 0, in float64
    on x's device: the continued fraction where it converges fast,
    x < (a + 1)/(a + b + 2), else 1 − I_{1−x}(b, a); prefactor
    x^a (1 − x)^b / (a·B(a, b)) from `lgamma`. `complement`, if given, is
    1 − x computed without cancellation by the caller."""
    x = torch.as_tensor(x).to(torch.float64)
    y = 1.0 - x if complement is None else complement.to(torch.float64)
    a, b = float(a), float(b)
    ln_beta = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
    front = torch.exp(ln_beta + a * torch.log(x) + b * torch.log(y))
    swap = x > (a + 1.0) / (a + b + 2.0)
    xs = torch.where(swap, y, x)
    a_t, b_t = torch.full_like(x, a), torch.full_like(x, b)
    aa, bb = torch.where(swap, b_t, a_t), torch.where(swap, a_t, b_t)
    direct = front * _betacf(aa, bb, xs, max_iter) / aa
    return torch.where(swap, 1.0 - direct, direct)


def student_t_cdf(x: torch.Tensor, nu: float) -> torch.Tensor:
    """Student-t CDF in float64: F = 1 − I/2 for x ≥ 0, I/2 below, with
    I = I_{ν/(ν+x²)}(ν/2, 1/2) and its complement x²/(ν+x²) formed
    directly (near x = 0 the argument is within rounding of 1)."""
    x = x.to(torch.float64)
    den = nu + x * x
    ib = betainc(0.5 * nu, 0.5, nu / den, complement=x * x / den)
    return torch.where(x >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


def multi_asset_t_copula_terminal(spots, sigmas, corr, r, q, T,
                                  generator: Optional[torch.Generator] = None,
                                  *, num_paths: int, nu: float = 5.0,
                                  draws=None, device="cuda") -> torch.Tensor:
    """Terminal spots under a Student-t copula with LOGNORMAL marginals:

        X = (Z @ L^T) / sqrt(G/nu),  G ~ chi2(nu)      (joint t, float32)
        U_i = F_t(X_i; nu)                              (float64 betainc)
        z_i = ndtri(U_i)                                (float64, clipped)
        S_i = S0_i exp((r - q - sig_i^2/2) T + sig_i sqrt(T) z_i)

    `draws` = (z (num_paths, A) normals, g (num_paths, 1) χ²(ν) draws),
    else z and then g = 2·Gamma(ν/2) from `generator`."""
    device = draws[0].device if draws is not None else torch.device(device)
    spots = _f32(np.asarray(spots, np.float32), device)
    sigmas = _f32(np.asarray(sigmas, np.float32), device)
    n_assets = spots.shape[0]
    chol_t = _corr_cholesky(corr, device).T
    if draws is None:
        z = torch.randn((num_paths, n_assets), generator=generator,
                        device=device, dtype=torch.float32)
        g = 2.0 * torch._standard_gamma(
            torch.full((num_paths, 1), 0.5 * nu, dtype=torch.float32,
                       device=device), generator=generator)
    else:
        z, g = draws
    x = (z @ chol_t) * torch.sqrt(nu / torch.clamp(g, min=1e-10))
    u = torch.clamp(student_t_cdf(x, nu), 1e-7, 1.0 - 1e-7)
    z_marg = torch.special.ndtri(u).to(torch.float32)
    T_t = _f32(T, device)
    log_s = (torch.log(spots) + (r - q - 0.5 * sigmas**2) * T_t
             + sigmas * torch.sqrt(T_t) * z_marg)
    return torch.exp(log_s)


def _risk_contrib_device(rel: torch.Tensor, weights, *, k_tail: int,
                         k_band: int) -> Dict[str, torch.Tensor]:
    """Euler allocation on the device: (VaR, CVaR, marginal and component
    vectors). CVaR contributions are the tail conditional means, so
    Σᵢ wᵢ·∂CVaR/∂wᵢ = CVaR path by path; VaR marginals are the conditional
    means on the k_band paths nearest the quantile."""
    w = _f32(np.asarray(weights, np.float32), rel.device)
    port = rel @ w                                     # (paths,)
    losses, idx = torch.topk(-port, k_tail)            # worst k, descending
    var = losses[-1]
    cvar = torch.mean(losses)
    marginal_cvar = -torch.mean(rel[idx], dim=0)
    _, band_idx = torch.topk(-torch.abs(port + var), k_band)
    marginal_var = -torch.mean(rel[band_idx], dim=0)
    return {
        "var": var,
        "cvar": cvar,
        "marginal_var": marginal_var,
        "marginal_cvar": marginal_cvar,
        "component_var_raw": w * marginal_var,
        "component_cvar": w * marginal_cvar,
    }


def _relative_returns(s_t: torch.Tensor, spots) -> torch.Tensor:
    return s_t / _f32(np.asarray(spots, np.float32), s_t.device)[None, :] \
        - 1.0


def _portfolio_returns(s_t: torch.Tensor, spots, weights) -> torch.Tensor:
    return _relative_returns(s_t, spots) @ _f32(
        np.asarray(weights, np.float32), s_t.device)


def portfolio_risk_contributions(
    spots,
    sigmas,
    corr,
    weights,
    T,
    generator: Optional[torch.Generator] = None,
    r: float = 0.065,
    q: float = 0.012,
    num_paths: int = 1_000_000,
    num_steps: int = 32,
    confidence: float = 0.99,
    *,
    draws=None,
    device="cuda",
) -> Dict[str, object]:
    """Per-asset Euler VaR/CVaR decomposition of the correlated-GBM book:
    marginal = ∂risk/∂wᵢ (tail conditional expectations), component =
    wᵢ·marginal, Σ components = CVaR exactly and = VaR after the band
    rescale (`var_scale` reports the raw gap). `generator` defaults to one
    seeded with 0 on `device`."""
    if generator is None and draws is None:
        generator = seeded_generator(0, device)
    s_t = multi_asset_gbm_terminal(
        spots, sigmas, corr, r, q, T, generator, num_paths=num_paths,
        num_steps=num_steps, draws=draws, device=device)
    rel = _relative_returns(s_t, spots)
    k_tail = max(int(num_paths * (1.0 - confidence)), 1)
    k_band = max(k_tail // 5, min(200, num_paths))
    out = to_host(_risk_contrib_device(rel, weights, k_tail=k_tail,
                                       k_band=k_band))
    var, cvar = float(out["var"]), float(out["cvar"])
    comp_raw = np.asarray(out["component_var_raw"], np.float64)
    scale = var / comp_raw.sum() if abs(comp_raw.sum()) > 1e-12 else 1.0
    comp_var = comp_raw * scale
    comp_cvar = np.asarray(out["component_cvar"], np.float64)
    return {
        "var": var,
        "cvar": cvar,
        "marginal_var": np.asarray(out["marginal_var"]).tolist(),
        "marginal_cvar": np.asarray(out["marginal_cvar"]).tolist(),
        "component_var": comp_var.tolist(),
        "component_cvar": comp_cvar.tolist(),
        "component_var_pct": (comp_var / var * 100).tolist()
        if var > 0 else [float("nan")] * len(comp_var),
        "component_cvar_pct": (comp_cvar / cvar * 100).tolist()
        if cvar > 0 else [float("nan")] * len(comp_cvar),
        "var_scale": float(scale),
        "confidence": confidence,
        "num_paths_used": num_paths,
    }


def _sharded_portfolio_var(spots, sigmas, corr, weights, T, generator, r,
                           q, num_paths, num_steps, confidence, mesh,
                           draws) -> Dict[str, float]:
    """portfolio_var's Gaussian path over a mesh, the JAX package's host
    statistics: raw moments pooled in float32, central moments and the
    tail order statistics in float64."""
    from mcos_tpu_torch.parallel.mesh import sharded_portfolio_returns

    if draws is not None:
        raise ValueError("replayed draws cannot be sharded: pass no mesh")
    seed = 0
    if generator is not None:
        if not has_not_drawn(generator):
            raise ValueError("a mesh seeds its shards from the seed of "
                             "`generator`: pass one that has not drawn")
        seed = generator.initial_seed()
    n_dev = int(np.prod(mesh.dims))
    # Quota: the global tail spread over the shards with a 2x + 4√k margin,
    # so the union of the shards' worst sets holds the global worst k with
    # overwhelming probability (binomial concentration).
    k_tail = max(int(num_paths * (1.0 - confidence)), 1)
    quota = int(2.0 * k_tail / n_dev + 4.0 * np.sqrt(k_tail) + 64)
    stats = sharded_portfolio_returns(
        spots, sigmas, corr, weights, T, seed, mesh=mesh,
        num_paths=num_paths, num_steps=num_steps, r=r, q=q,
        tail_quota=quota)
    n = float(stats["n"])
    m1, m2, m3, m4 = (float(stats[f"sum{k}"]) / n for k in (1, 2, 3, 4))
    std = float(np.sqrt(max(m2 - m1 * m1, 1e-20)))
    mu3 = m3 - 3 * m1 * m2 + 2 * m1**3
    mu4 = m4 - 4 * m1 * m3 + 6 * m1**2 * m2 - 3 * m1**4
    tail = np.sort(stats["tail"].cpu().numpy().astype(np.float64))
    k = min(k_tail, len(tail))
    var = -tail[min(k, len(tail) - 1)]
    cvar = -tail[:max(k, 1)].mean()
    losses = -tail[tail < 0]
    hill = _hill_estimator(losses) if len(losses) > 20 else float("nan")
    kurt = float(mu4 / max(std**4, 1e-20))
    return {
        "var": float(var),
        "cvar": float(cvar),
        "skewness": float(mu3 / max(std**3, 1e-20)),
        "kurtosis": kurt,
        "excess_kurtosis": kurt - 3.0,
        "tail_index": hill,
        "mean": float(m1),
        "std": std,
        "num_devices": n_dev,
        "num_paths_used": int(n),
    }


def portfolio_var(
    spots,
    sigmas,
    corr,
    weights,
    T,
    generator: Optional[torch.Generator] = None,
    r: float = 0.065,
    q: float = 0.012,
    num_paths: int = 1_000_000,
    num_steps: int = 32,
    confidence: float = 0.99,
    mesh=None,
    copula: str = "gaussian",
    nu: float = 5.0,
    *,
    draws=None,
    device="cuda",
) -> Dict[str, float]:
    """Portfolio VaR/ES over correlated GBM terminals (risk.py:117-155
    semantics on portfolio returns) on one device. `copula="student_t"`
    (ν degrees of freedom, clamped to [1, 300] as in the JAX package)
    swaps the Gaussian dependence for a t-copula, lognormal marginals
    kept. `draws` as `multi_asset_gbm_terminal`'s or, for the t-copula,
    `multi_asset_t_copula_terminal`'s. `generator` defaults to one seeded
    with 0 on `device`.

    The Gaussian copula shards its paths over a `mesh` (or "auto"; with
    mesh=None, over every CUDA device when `device` is CUDA and there is
    more than one, as the JAX package takes every device): moments pool as
    sums and the tail by the exact union of the shards' worst returns
    (`parallel/mesh.py:sharded_portfolio_returns`), so no device holds
    the whole return vector. Its shards take the seed of `generator` (0
    without one), which must not have drawn yet; `draws` cannot be
    sharded. Given `draws` or a generator that has drawn, a mesh the
    caller passed raises ValueError, and the implicit one leaves the call
    on one device."""
    if copula != "student_t":
        explicit = mesh is not None
        if mesh is None and torch.device(device).type == "cuda" \
                and torch.cuda.device_count() > 1:
            from mcos_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh()
        elif mesh == "auto":
            mesh = resolve_mesh(mesh)
        shardable = draws is None and (generator is None
                                       or has_not_drawn(generator))
        if mesh is not None and (explicit or shardable):
            return _sharded_portfolio_var(
                spots, sigmas, corr, weights, T, generator, r, q, num_paths,
                num_steps, confidence, mesh, draws)
    if generator is None and draws is None:
        generator = seeded_generator(0, device)
    if copula == "student_t":
        s_t = multi_asset_t_copula_terminal(
            spots, sigmas, corr, r, q, T, generator, num_paths=num_paths,
            nu=float(np.clip(nu, 1.0, 300.0)), draws=draws, device=device)
        out = compute_risk_metrics(_portfolio_returns(s_t, spots, weights),
                                   confidence=confidence)
        out["copula"] = "student_t"
        out["nu"] = float(nu)
        return out
    s_t = multi_asset_gbm_terminal(
        spots, sigmas, corr, r, q, T, generator, num_paths=num_paths,
        num_steps=num_steps, draws=draws, device=device)
    return compute_risk_metrics(_portfolio_returns(s_t, spots, weights),
                                confidence=confidence)
