"""SPAN-style portfolio initial margin, 16-scenario risk arrays
(counterpart of `mcos_tpu/engine/margin.py`).

The scenario set is the classic 16-point array:

    1-2:   price unchanged,            vol +VSR / −VSR
    3-14:  price ±{1/3, 2/3, 3/3}·PSR, vol +VSR / −VSR
    15-16: price ±extreme_mult·PSR, base vol, charged at `extreme_coverage`

with PSR the price scan range (fraction of spot) and VSR the vol scan range
(absolute shift of σ). NSE's parameters for index options are roughly
PSR 6%, VSR 4% (wider for stocks) — the defaults.

Execution model (one common-random-number pass a maturity, not 16
repricings): the SVJ log-dynamics do not depend on S₀, so every price
scenario is a payoff-axis transform on one shared path set,
V(f·S₀, K) = f · V(S₀, K/f). Vol scenarios change the dynamics, so they
take three vol states (σ−VSR, base, σ+VSR in v0 and θ) on the same random
numbers:

- backend="cuda": three K3 launches a maturity group
  (`cuda_kernels.svj_terminal`: the kernel on a CUDA device, its plain
  version on the CPU), all on the maturity's seed, companion off. K3's
  normals and jump counts depend on the seed, the pair and λ·dt only, and
  the vol shift leaves λ alone, so the three states share their paths as
  the JAX package's `vmap` on one key does.
- backend="torch": the Euler member twin
  (`ops/simulate.py:simulate_terminal_members`) with the three states as
  the member axis, on the maturity's (z, u) from a generator seeded with
  the maturity's seed, or on draws the caller swaps in (`_draws`).

A maturity's seed is the engine's seed in the high word and
round(T·1e4) in the low one, so two maturities never share paths. The
(positions × 9 factors) strike table is reduced against the paths in
chunks of at most _PAYOFF_CHUNK_BYTES of payoff, so a 4 096-position book
needs no more device memory than a small one; the scenario algebra is
float64 on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import scaled_steps
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.engine.risk import _stack_members
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels, simulate

#: Upper bound on the (strikes, 2, paths) float32 payoff block reduced at
#: once.
_PAYOFF_CHUNK_BYTES = 256 << 20


def _vol_shift(params: SVJParams, dv: float) -> SVJParams:
    """Shift the vol *level* by dv: σ → σ+dv applied to √v0 and √θ."""
    s0 = max(float(params.v0), 1e-8) ** 0.5
    st = max(float(params.theta), 1e-8) ** 0.5
    return params.replace(v0=max(s0 + dv, 0.01) ** 2,
                          theta=max(st + dv, 0.01) ** 2)


def _maturity_seed(seed: int, T: float) -> int:
    """The seed of one maturity group: `seed` in the high 32 bits,
    round(T·1e4) in the low 32 (the JAX package's fold_in(key,
    round(T·1e4))). A word outside uint32 (a negative maturity) raises
    OverflowError, as the JAX package's fold_in does."""
    word = int(round(T * 1e4))
    if not 0 <= word <= 0xFFFFFFFF:
        raise OverflowError(f"Python integer {word} out of bounds for uint32")
    return ((int(seed) & 0xFFFFFFFF) << 32) | word


def _price_rows(s_final: torch.Tensor, strikes: torch.Tensor,
                flags: torch.Tensor, discount: float) -> torch.Tensor:
    """(n_strikes,) discounted prices max(±(S − K), 0) off (2, paths)
    antithetic terminals, in strike chunks of at most _PAYOFF_CHUNK_BYTES."""
    per_strike = 4 * s_final.numel()
    chunk = max(1, _PAYOFF_CHUNK_BYTES // per_strike)
    rows = []
    for i in range(0, strikes.shape[0], chunk):
        k, f = strikes[i:i + chunk], flags[i:i + chunk]
        pay = torch.clamp(
            f[:, None, None] * (s_final[None] - k[:, None, None]), min=0.0)
        rows.append(torch.mean(torch.mean(pay, dim=1), dim=-1))
    return discount * torch.cat(rows)


class MarginEngine:
    """SPAN-style margin for a single-underlying option book on `device`.

    backend: "cuda" (three K3 launches a maturity group; its plain version
    on the CPU) or "torch" (the Euler member twin on `_draws`).
    """

    def __init__(self, params: SVJParams, num_paths: int = 200_000,
                 num_steps: int = 252, seed: int = 42,
                 price_scan_range: float = 0.06,
                 vol_scan_range: float = 0.04,
                 extreme_multiplier: float = 2.0,
                 extreme_coverage: float = 0.35, *, backend: str = "cuda",
                 device="cuda"):
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.psr = float(price_scan_range)
        self.vsr = float(vol_scan_range)
        self.extreme_mult = float(extreme_multiplier)
        self.extreme_coverage = float(extreme_coverage)
        self.backend = backend
        self.device = torch.device(device)

    def _draws(self, steps: int, T: float):
        """backend="torch": the maturity's (z, u), (steps, 3, paths) normals
        and (steps, paths) uniforms from a generator seeded with the
        maturity's seed."""
        return simulate._euler_draws(
            None, seeded_generator(_maturity_seed(self.seed, T), self.device),
            self.num_paths, steps, self.device)

    def _state_terminals(self, states: Sequence[SVJParams], spot: float,
                         T: float) -> List[torch.Tensor]:
        """(2, paths) terminal spots of each vol state, on one maturity's
        random numbers."""
        steps = scaled_steps(self.num_steps, float(T))
        if self.backend == "cuda":
            seed = _maturity_seed(self.seed, T)
            return [cuda_kernels.svj_terminal(
                p, spot, T, seed, num_paths=self.num_paths, num_steps=steps,
                antithetic=True, companion=False, device=self.device)[0]
                for p in states]
        with torch.no_grad():
            s_final, _, _ = simulate.simulate_terminal_members(
                _stack_members(states, self.device), spot, T,
                draws=self._draws(steps, T))
        return list(s_final)

    def _factors(self) -> np.ndarray:
        """Spot factors: base, +1/3, +2/3, +1, −1/3, −2/3, −1 of PSR, ±
        extreme."""
        thirds = self.psr * np.array([1 / 3, 2 / 3, 1.0])
        return np.concatenate([[1.0], 1.0 + thirds, 1.0 - thirds,
                               [1.0 + self.extreme_mult * self.psr,
                                1.0 - self.extreme_mult * self.psr]])

    def price_table(self, spot: float, strikes: np.ndarray, Ts: np.ndarray,
                    calls: np.ndarray) -> np.ndarray:
        """(3 vol states, positions, 9 factors) float64 prices at spot S₀ of
        each position's strike divided by each factor, one maturity group
        at a time."""
        factors = self._factors()
        n_f = len(factors)                      # 9
        states = (_vol_shift(self.params, -self.vsr), self.params,
                  _vol_shift(self.params, +self.vsr))
        prices = np.zeros((3, len(strikes), n_f))
        for T in np.unique(Ts):
            rows = np.nonzero(Ts == T)[0]
            k_eff = (strikes[rows][:, None] / factors[None, :])  # (m, n_f)
            flags = np.where(calls[rows], 1.0, -1.0)
            k_dev = torch.as_tensor(k_eff.reshape(-1).astype(np.float32),
                                    device=self.device)
            f_dev = torch.as_tensor(np.repeat(flags, n_f).astype(np.float32),
                                    device=self.device)
            discount = float(np.exp(np.float32(-np.float32(self.params.r)
                                               * np.float32(T))))
            tab = torch.stack([
                _price_rows(s, k_dev, f_dev, discount)
                for s in self._state_terminals(states, float(spot),
                                               float(T))])
            prices[:, rows, :] = tab.cpu().numpy().astype(
                np.float64).reshape(3, len(rows), n_f)
        return prices

    def margin(self, spot: float, strikes: Sequence[float],
               Ts: Sequence[float], is_calls: Sequence[bool],
               quantities: Sequence[float]) -> Dict:
        """Portfolio SPAN margin. quantities: signed (+ long, − short)."""
        strikes = np.asarray(strikes, np.float64)
        Ts = np.asarray(Ts, np.float64)
        calls = np.asarray(is_calls, bool)
        qty = np.asarray(quantities, np.float64)
        n = len(strikes)
        if not (len(Ts) == len(calls) == len(qty) == n and n > 0):
            raise ValueError("strikes/Ts/is_calls/quantities must be equal, "
                             "nonzero length")
        factors = self._factors()
        thirds = self.psr * np.array([1 / 3, 2 / 3, 1.0])
        prices = self.price_table(spot, strikes, Ts, calls)

        # V[vol_state, pos, factor] = f · price(K/f): scenario value per lot.
        values = prices * factors[None, None, :]
        v_base = values[1, :, 0]                                 # base vol, f=1

        scen_losses: List[float] = []
        scen_labels: List[str] = []
        move_idx = {0.0: 0}
        for i, m in enumerate(thirds, start=1):
            move_idx[m] = i          # up factors at 1..3
            move_idx[-m] = i + 3     # down factors at 4..6
        for m in [0.0, thirds[0], -thirds[0], thirds[1], -thirds[1],
                  thirds[2], -thirds[2]]:
            for vol_state, vol_name in ((2, "vol+"), (0, "vol-")):
                v_scen = values[vol_state, :, move_idx[m]]
                loss = float(np.sum(qty * (v_base - v_scen)))
                scen_losses.append(loss)
                scen_labels.append(f"price{m:+.4f}, {vol_name}")
        for j, sign in ((7, "+"), (8, "-")):     # extremes, base vol, weighted
            v_scen = values[1, :, j]
            loss = self.extreme_coverage * float(np.sum(qty * (v_base - v_scen)))
            scen_losses.append(loss)
            scen_labels.append(
                f"price{sign}{self.extreme_mult:.0f}x, extreme "
                f"({self.extreme_coverage:.0%})")

        worst = int(np.argmax(scen_losses))
        scan_risk = max(scen_losses[worst], 0.0)
        net_value = float(np.sum(qty * v_base))
        return {
            "margin": scan_risk,
            "scan_risk": scan_risk,
            "worst_scenario": scen_labels[worst],
            "risk_array": [round(x, 6) for x in scen_losses],
            "scenario_labels": scen_labels,
            "net_option_value": net_value,
            "price_scan_range": self.psr,
            "vol_scan_range": self.vsr,
            "num_scenarios": len(scen_losses),
        }
