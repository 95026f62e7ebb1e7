"""Rough Bergomi pricing engine: smiles, Greeks by autograd, term skew,
path-dependent payoffs and calibration (counterpart of
`mcos_tpu/engine/rough.py`).

Engine layer over `ops/rough.py` (model, samplers and the lift in its
header). Which body runs which code:

- `sampler="auto"` (the default, and what `POST /api/rough` uses) lifts
  once the step count reaches 512 and the draws are not Sobol; below that,
  and under QMC, the exact sampler runs (one float32 matmul of the normals
  with the (2n, 2n) covariance factor).
- On the lift, `price` (with `smile` and `atm_skew`) runs kernel K10
  (`cuda_kernels.rbergomi_lift_integrals`) and `price_asian`,
  `price_barrier` and `price_lookback` run kernel K11
  (`cuda_kernels.rbergomi_lift_stats`), each once per request: the kernel
  on a CUDA device, its plain version on the CPU. `backend="torch"` runs
  the differentiable lift twins instead.
- `greeks` always rides a twin (the exact sampler, or the lift with
  checkpointing per chunk of steps): delta and gamma by nested autograd,
  which is unbiased because every per-path payoff is a smooth Black price
  in S0; the xi, eta, rho and rate sensitivities come out of the same
  backward pass. I1 and I2 do not depend on S0, so the second derivative
  never enters the step loop.
- `calibrate_rbergomi` fits (eta, rho, xi) per Hurst-grid point by
  differential evolution (the population priced in one batched call) and
  an Adam polish, on common random numbers: every candidate is priced on
  the same Gaussian sheet per maturity, built once per (H, maturity).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu_torch.engine.pricer import seeded_generator, to_host
from mcos_tpu_torch.engine.surface import implied_vol
from mcos_tpu_torch.ops import cuda_kernels
from mcos_tpu_torch.ops.rough import (
    RoughBergomiParams,
    _black_on_forward,
    _conditional_black,
    _wick_var_left,
    rbergomi_chol_device,
    rbergomi_conditional_payoffs,
    rbergomi_lift,
    rbergomi_lifted_payoffs,
    rbergomi_log_paths,
    rbergomi_path_stats,
    rbergomi_path_stats_lifted,
    rbergomi_terminal,
    sample_xi_curve,
    xi_curve_from_variance_swaps,
)
from mcos_tpu_torch.ops.simulate import _f32
from mcos_tpu_torch.ops.sobol import sobol_normals
from mcos_tpu_torch.utils.optim import adam_polish, differential_evolution

RBERGOMI_CAL_BOUNDS = {
    "eta": (0.3, 4.0),
    "rho": (-0.99, -0.05),
    "xi": (0.002, 0.40),
}


def _combine_mean_se(pay: torch.Tensor):
    """(branches, paths, strikes) payoffs → ((strikes,) mean, stderr), the
    antithetic pairs pooled before the moments."""
    comb = torch.mean(pay, dim=0)
    mean = torch.mean(comb, dim=0)
    se = (torch.std(comb, dim=0, correction=0)
          / float(np.sqrt(np.float32(comb.shape[0]))))
    return mean, se


class RoughBergomiEngine:
    """Monte Carlo pricer for the rough Bergomi model on `device`.

    The exact sampler's covariance factor is prepared on the host per
    (hurst, T, num_steps), cached, and copied to the device once; the lift
    tables likewise. backend: "cuda" (kernels K10/K11 on the lift; their
    plain versions on the CPU) or "torch" (the lift twins on a generator
    seeded with `seed`).
    """

    def __init__(self, params: RoughBergomiParams,
                 num_paths: int = 131_072, num_steps: int = 128,
                 seed: int = 42, use_sobol: bool = False,
                 rqmc_randomizations: int = 8, xi_curve=None,
                 sampler: str = "auto", lift_factors: int = 24,
                 backend: str = "cuda", *, device="cuda"):
        if sampler not in ("auto", "exact", "lift"):
            raise ValueError("sampler must be 'auto', 'exact' or 'lift'")
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_sobol = bool(use_sobol)
        self.rqmc = int(rqmc_randomizations)
        # Optional forward-variance term structure (edges, values), e.g.
        # from `xi_curve_from_variance_swaps`; overrides params.xi.
        self.xi_curve = xi_curve
        self.sampler = sampler
        self.lift_factors = int(lift_factors)
        self.backend = backend
        self.device = torch.device(device)

    @classmethod
    def from_variance_swaps(cls, params: RoughBergomiParams, maturities,
                            var_strikes, **kw) -> "RoughBergomiEngine":
        """Engine whose forward-variance curve reprices the given
        variance-swap quotes exactly (piecewise-constant bootstrap)."""
        return cls(params, xi_curve=xi_curve_from_variance_swaps(
            maturities, var_strikes), **kw)

    def _xi_t(self, T: float) -> Optional[np.ndarray]:
        if self.xi_curve is None:
            return None
        edges, vals = self.xi_curve
        return sample_xi_curve(edges, vals, T, self.num_steps)

    def variance_swap_strike(self, T: float) -> float:
        """Model fair variance-swap strike sqrt((1/T) \\int xi) — exact
        from the curve (E[v_t] = xi(t)), no simulation needed."""
        if self.xi_curve is None:
            return float(np.sqrt(float(self.params.xi)))
        return float(np.sqrt(np.asarray(self._xi_t(T), np.float64).mean()))

    # ── internals ────────────────────────────────────────────────────────
    def _chol(self, T: float) -> torch.Tensor:
        # PCA factor under QMC: the first Sobol dimensions then drive the
        # largest variance directions.
        return rbergomi_chol_device(
            float(self.params.hurst), float(T), self.num_steps,
            "pca" if self.use_sobol else "cholesky", self.device)

    def _generator(self) -> torch.Generator:
        return seeded_generator(self.seed, self.device)

    def _use_lift(self) -> bool:
        if self.sampler == "lift":
            return True
        if self.sampler == "exact":
            return False
        return self.num_steps >= 512 and not self.use_sobol

    def _remat_chunk(self) -> int:
        for m in (64, 32, 16, 8):
            if self.num_steps % m == 0:
                return m
        return 0

    def _lift(self, T: float):
        return rbergomi_lift(float(self.params.hurst), float(T),
                             self.num_steps, self.lift_factors)

    def _payoffs(self, params: RoughBergomiParams, spot, strikes_arr, T,
                 is_call, remat_chunk: int = 0, draws=None) -> torch.Tensor:
        """(branches, paths, strikes) conditional-Black payoffs through the
        selected sampler's twin (`params` explicit so autograd callers can
        pass tensors). `draws` replays normals: (paths, 2n) for the exact
        sampler, (steps, 2, paths) for the lift."""
        kw = dict(num_paths=self.num_paths, num_steps=self.num_steps,
                  is_call=is_call, xi_t=self._xi_t(T), device=self.device)
        if self._use_lift():
            c, d, g, tail = self._lift(T)
            return rbergomi_lifted_payoffs(
                params, spot, strikes_arr, T, self._generator(), c, d, g,
                tail, remat_chunk=remat_chunk, draws=draws, **kw)
        return rbergomi_conditional_payoffs(
            params, spot, strikes_arr, T, self._chol(T), self._generator(),
            z=draws, **kw)

    # ── public surface ───────────────────────────────────────────────────
    def price(self, spot: float, strikes, T: float,
              is_call: bool = True) -> Dict[str, object]:
        strikes_arr = torch.atleast_1d(_f32(np.asarray(strikes, np.float32),
                                            self.device))
        disc = float(np.exp(-float(self.params.r) * T))
        scalar = np.ndim(strikes) == 0
        if self.use_sobol:
            chol = self._chol(T)
            # Randomized QMC: R independent Owen scrambles of num_paths/R
            # points each; the spread of the R estimates is the error bar.
            per = max(self.num_paths // self.rqmc, 256)
            ests = []
            for r_i in range(self.rqmc):
                z = sobol_normals(per, 2 * self.num_steps, seed=self.seed,
                                  stream=r_i, device=self.device)
                pay = rbergomi_conditional_payoffs(
                    self.params, spot, strikes_arr, T, chol, None,
                    num_paths=per, num_steps=self.num_steps,
                    is_call=is_call, z=z, xi_t=self._xi_t(T))
                ests.append(torch.mean(pay, dim=(0, 1)))
            ests = to_host({"e": torch.stack(ests)})["e"].astype(np.float64)
            mean = ests.mean(axis=0)
            se = ests.std(axis=0, ddof=1) / np.sqrt(self.rqmc)
            price, stderr = disc * mean, disc * se
            return {
                "price": float(price[0]) if scalar else price.tolist(),
                "std_error": float(stderr[0]) if scalar
                else stderr.tolist(),
                "num_paths_used": per * self.rqmc,
                "num_steps": self.num_steps,
                "estimator": "conditional-black+rqmc",
                "rqmc_randomizations": self.rqmc,
            }
        estimator = "conditional-black"
        if self._use_lift() and self.backend == "cuda":
            # Kernel K10 (the plain version on the CPU); the
            # differentiable twin stays the greeks path.
            p = self.params
            c, d, g, tail = self._lift(T)
            i1, i2 = cuda_kernels.rbergomi_lift_integrals(
                p.eta, T, self.seed, c, d, g, tail, float(p.hurst),
                num_paths=self.num_paths, num_steps=self.num_steps,
                xi_t=self._xi_t(T), xi_flat=p.xi, device=self.device)
            pay = _conditional_black(p, _f32(spot, self.device), strikes_arr,
                                     _f32(T, self.device), i1, i2, is_call)
            estimator += "+lift-cuda"
        else:
            pay = self._payoffs(self.params, spot, strikes_arr, T, is_call)
            if self._use_lift():
                estimator += "+lift"
        mean, se = _combine_mean_se(pay)
        host = to_host({"mean": mean, "se": se})
        price = disc * host["mean"].astype(np.float64)
        stderr = disc * host["se"].astype(np.float64)
        return {
            "price": float(price[0]) if scalar else price.tolist(),
            "std_error": float(stderr[0]) if scalar else stderr.tolist(),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
            "estimator": estimator,
        }

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True, *, draws=None) -> Dict[str, float]:
        """delta/gamma by nested autograd + xi/eta/rho/rate sensitivities,
        through the twin of the selected sampler (the lift with
        checkpointing per chunk of steps). `draws` replays the twin's
        normals (see `_payoffs`)."""
        dev = self.device
        k_arr = torch.tensor([strike], dtype=torch.float32, device=dev)
        names = ("xi", "eta", "rho", "r")
        leaves = {n: torch.tensor(float(getattr(self.params, n)),
                                  dtype=torch.float32, device=dev,
                                  requires_grad=True) for n in names}
        s0 = torch.tensor(float(spot), dtype=torch.float32, device=dev,
                          requires_grad=True)
        p = dataclasses.replace(self.params, **leaves)
        remat = self._remat_chunk() if self._use_lift() else 0
        pay = self._payoffs(p, s0, k_arr, T, is_call, remat_chunk=remat,
                            draws=draws)
        price = (torch.exp(-p.r * _f32(T, dev))
                 * torch.mean(pay, dim=(0, 1)))[0]
        d_p = torch.autograd.grad(price, [leaves[n] for n in names],
                                  retain_graph=True)
        (delta,) = torch.autograd.grad(price, s0, create_graph=True)
        (gamma,) = torch.autograd.grad(delta, s0)
        host = to_host({"v": torch.stack([price.detach(), delta.detach(),
                                          gamma, *d_p])})["v"]
        return {
            "price": float(host[0]),
            "delta": float(host[1]),
            "gamma": float(host[2]),
            "vega_xi": float(host[3]),       # dP/d xi (forward variance)
            "d_eta": float(host[4]),         # vol-of-vol sensitivity
            "d_rho": float(host[5]),         # leverage sensitivity
            "rho_rate": float(host[6]),      # dP/dr (rate rho)
        }

    def smile(self, spot: float, T: float,
              moneyness: Optional[Sequence[float]] = None
              ) -> Dict[str, object]:
        """Implied-vol smile: batch-price one strike grid, invert each to
        Black-Scholes vol (host f64 Newton, engine/surface.py)."""
        if moneyness is None:
            moneyness = np.linspace(0.85, 1.15, 13)
        m = np.asarray(moneyness, np.float64)
        strikes = spot * m
        res = self.price(spot, strikes, T, is_call=True)
        p = self.params
        ivs = [implied_vol(float(px), spot, float(k), T, float(p.r),
                           float(p.q), True)
               for px, k in zip(res["price"], strikes)]
        return {"moneyness": m.tolist(), "strikes": strikes.tolist(),
                "prices": res["price"], "implied_vols": ivs,
                "std_errors": res["std_error"]}

    def atm_skew(self, spot: float, T: float,
                 dm: float = 0.02) -> Dict[str, float]:
        """d(sigma_imp)/d(log-moneyness) at ATM — the quantity whose
        T -> 0 power-law blowup ~ T^{H-1/2} is the rough-vol signature."""
        sm = self.smile(spot, T, moneyness=[np.exp(-dm), 1.0, np.exp(dm)])
        lo, _, hi = sm["implied_vols"]
        if lo is None or hi is None:
            return {"skew": float("nan"), "T": T}
        return {"skew": (hi - lo) / (2.0 * dm), "T": T,
                "atm_vol": sm["implied_vols"][1]}

    # ── path-dependent payoffs (rough-vol exotics) ───────────────────────
    def _stats(self, spot: float, T: float) -> Dict[str, torch.Tensor]:
        """(branches, paths) terminal/mean/max/min spot statistics over
        t_1..t_n via the selected sampler: on the lift, kernel K11 (the
        plain version on the CPU) or, with backend="torch", the twin."""
        p = self.params
        if self._use_lift():
            c, d, g, tail = self._lift(T)
            if self.backend == "cuda":
                return cuda_kernels.rbergomi_lift_stats(
                    (p.eta, p.rho, p.r, p.q, p.xi, spot), T, self.seed,
                    c, d, g, tail, float(p.hurst), num_paths=self.num_paths,
                    num_steps=self.num_steps, xi_t=self._xi_t(T),
                    device=self.device)
            return rbergomi_path_stats_lifted(
                p, spot, T, self._generator(), c, d, g, tail,
                num_paths=self.num_paths, num_steps=self.num_steps,
                xi_t=self._xi_t(T), device=self.device)
        return rbergomi_path_stats(
            p, spot, T, self._chol(T), self._generator(),
            num_paths=self.num_paths, num_steps=self.num_steps,
            device=self.device)

    def _reduce(self, pay: torch.Tensor, T: float,
                extra: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, float]:
        mean, se = _combine_mean_se(pay[..., None])
        host = to_host({"mean": mean, "se": se, **(extra or {})})
        disc = float(np.exp(-float(self.params.r) * T))
        out = {
            "price": disc * float(host["mean"][0]),
            "std_error": disc * float(host["se"][0]),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
        }
        for k in (extra or {}):
            out[k] = float(host[k])
        return out

    def price_asian(self, spot: float, strike: float, T: float,
                    is_call: bool = True) -> Dict[str, float]:
        """Discretely-averaged arithmetic Asian under rough volatility
        (observations on the simulation grid t_1..t_n)."""
        st = self._stats(spot, T)
        phi = 1.0 if is_call else -1.0
        return self._reduce(
            torch.clamp(phi * (st["s_mean"] - strike), min=0.0), T)

    def price_barrier(self, spot: float, strike: float, T: float,
                      barrier: float, is_call: bool = True,
                      knock: str = "out",
                      direction: Optional[str] = None) -> Dict[str, float]:
        """Discretely-monitored barrier under rough volatility."""
        st = self._stats(spot, T)
        if direction is None:
            direction = "up" if barrier >= spot else "down"
        hit = (st["s_max"] >= barrier if direction == "up"
               else st["s_min"] <= barrier)
        alive = hit if knock == "in" else ~hit
        phi = 1.0 if is_call else -1.0
        pay = torch.clamp(phi * (st["s_terminal"] - strike), min=0.0) * alive
        return self._reduce(pay, T, {"hit_fraction":
                                     torch.mean(hit.float())})

    def price_lookback(self, spot: float, T: float, is_call: bool = True,
                       strike: Optional[float] = None) -> Dict[str, float]:
        """Lookback under rough volatility: floating strike when `strike`
        is None (call pays S_T − min, put pays max − S_T), else fixed."""
        st = self._stats(spot, T)
        if strike is None:
            pay = (st["s_terminal"] - st["s_min"] if is_call
                   else st["s_max"] - st["s_terminal"])
        else:
            phi = 1.0 if is_call else -1.0
            extreme = st["s_max"] if is_call else st["s_min"]
            pay = torch.clamp(phi * (extreme - strike), min=0.0)
        return self._reduce(pay, T)

    def _log_sheet(self, T: float, num_paths: int) -> torch.Tensor:
        return rbergomi_log_paths(
            self.params, T, self._chol(T), self._generator(),
            num_paths=num_paths, num_steps=self.num_steps,
            xi_t=self._xi_t(T), device=self.device)    # (2, paths, n)

    def variance_swap_mc(self, T: float,
                         num_paths: Optional[int] = None
                         ) -> Dict[str, float]:
        """MC fair variance-swap strike from realized variance on the
        grid: K² = (1/T)·E[Σ (Δlog S)²]; pins `variance_swap_strike` up to
        the O(dt) drift² and discretization terms."""
        n = int(num_paths or self.num_paths)
        sheet = self._log_sheet(T, n)
        dlog = torch.diff(torch.cat([torch.zeros_like(sheet[..., :1]),
                                     sheet], dim=-1), dim=-1)
        rv = torch.sum(dlog * dlog, dim=-1) / T           # (2, paths)
        host = to_host({"mean": torch.mean(rv),
                        "sd": torch.std(torch.mean(rv, dim=0),
                                        correction=0)})
        mean = float(host["mean"])
        return {
            "fair_variance": mean,
            "fair_vol_strike": float(np.sqrt(max(mean, 0.0))),
            "std_error_variance": float(host["sd"]) / np.sqrt(n),
            "curve_strike": self.variance_swap_strike(T),
            "num_paths_used": n,
        }

    def corridor_variance_swap(self, spot: float, T: float,
                               lower: float = 0.0,
                               upper: float = float("inf"),
                               num_paths: Optional[int] = None
                               ) -> Dict[str, float]:
        """Corridor variance swap: realized variance accrues only on
        observations where the previous fix lies inside [lower, upper].
        The full corridor reduces exactly to `variance_swap_mc`."""
        n = int(num_paths or self.num_paths)
        sheet = self._log_sheet(T, n)
        log_with0 = torch.cat([torch.zeros_like(sheet[..., :1]), sheet],
                              dim=-1)
        dlog = torch.diff(log_with0, dim=-1)
        s_prev = spot * torch.exp(log_with0[..., :-1])    # previous fixes
        in_corr = (s_prev >= lower) & (s_prev <= upper)
        rv = torch.sum(dlog * dlog * in_corr, dim=-1) / T
        host = to_host({"mean": torch.mean(rv),
                        "sd": torch.std(torch.mean(rv, dim=0),
                                        correction=0),
                        "acc": torch.mean(in_corr.float())})
        mean = float(host["mean"])
        return {
            "fair_variance": mean,
            "fair_vol_strike": float(np.sqrt(max(mean, 0.0))),
            "std_error_variance": float(host["sd"]) / np.sqrt(n),
            "accrual_fraction": float(host["acc"]),
            "corridor": [float(lower), float(min(upper, 1e308))],
            "num_paths_used": n,
        }

    def terminal_sample(self, spot: float, T: float,
                        num_paths: Optional[int] = None) -> np.ndarray:
        """Terminal spots from the plain estimator (for histograms/risk)."""
        n = int(num_paths or self.num_paths)
        s = rbergomi_terminal(self.params, spot, T, self._chol(T),
                              self._generator(), num_paths=n,
                              num_steps=self.num_steps, device=self.device)
        return s.cpu().numpy().reshape(-1)


# ─────────────────────────────────────────────────────────────────────────────
# Calibration: fit (eta, rho, xi) per H over the Hurst grid
# ─────────────────────────────────────────────────────────────────────────────
# Largest (candidates × paths × steps) block the objective evaluates at
# once: 2^25 float32 values (128 MB) per temporary.
_CAL_BLOCK = 1 << 25


def _rbergomi_cal_objective(x: torch.Tensor, data: dict) -> torch.Tensor:
    """Weighted price-space SSE over the (maturity, strike) grid for a
    (P, 3) batch of candidates [eta, rho, xi] → (P,).

    Every candidate is priced on the same draws (common random numbers),
    so the objective is a deterministic smooth function of x. Per maturity
    the Gaussian sheet (W~ at the left points, dW) and the Wick variance
    come precomputed in `data["sheets"]`: the sheet does not depend on the
    candidate, so it is built once per (H, maturity), and each candidate's
    conditional Black prices are those of `rbergomi_conditional_payoffs`
    on that sheet."""
    eta, rho, xi = x[:, 0], x[:, 1], x[:, 2]
    r, q, spot = data["r"], data["q"], data["spot"]
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for m_i, (w_left, dw, wick, T_f) in enumerate(data["sheets"]):
        paths, n = w_left.shape
        dt = T_f / n
        strikes = data["strikes"][m_i]
        chunk = max(1, _CAL_BLOCK // (paths * n))
        model = []
        for lo in range(0, x.shape[0], chunk):
            e = eta[lo:lo + chunk, None, None]
            rh = rho[lo:lo + chunk, None]
            i1s, i2s = [], []
            for sign in (1.0, -1.0):
                v = xi[lo:lo + chunk, None, None] * torch.exp(
                    e * (sign * w_left)[None] - 0.5 * e ** 2 * wick)
                i1s.append(torch.sum(torch.sqrt(v) * (sign * dw)[None],
                                     dim=-1))
                i2s.append(torch.sum(v, dim=-1) * dt)
            i1 = torch.stack(i1s, dim=1)                    # (P, 2, paths)
            i2 = torch.stack(i2s, dim=1)
            rh3 = rh[..., None]
            f_eff = spot * torch.exp((r - q) * T_f + rh3 * i1
                                     - 0.5 * rh3 ** 2 * i2)
            s_eff = torch.sqrt(torch.clamp((1.0 - rh3 ** 2) * i2, min=0.0))
            pay = _black_on_forward(f_eff[..., None], strikes, s_eff[..., None],
                                    True)                  # (P, 2, paths, k)
            model.append(torch.exp(-r * T_f) * torch.mean(pay, dim=(1, 2)))
        model = torch.cat(model)                            # (P, k)
        total = total + torch.sum(
            data["weights"][m_i] * (model - data["market"][m_i]) ** 2,
            dim=-1)
    return total


def _cal_sheets(z_list, hurst: float, mats, num_steps: int, device):
    """Per maturity (W~ at the left points (paths, n), dW (paths, n), the
    left-point Wick variance (n,), T as float32), from the maturity's fixed
    normals and the (H, T) Cholesky factor."""
    n = num_steps
    sheets = []
    for z, T in zip(z_list, mats):
        chol = rbergomi_chol_device(float(hurst), float(T), n, "cholesky",
                                    device)
        g = z @ chol.T
        zeros = torch.zeros((z.shape[0], 1), dtype=torch.float32,
                            device=device)
        w_left = torch.cat([zeros, g[:, :n - 1]], dim=1)
        sheets.append((w_left, g[:, n:], _wick_var_left(chol, n),
                       _f32(T, device)))
    return sheets


def calibrate_rbergomi(spot, maturities, strikes, market_prices,
                       r: float = None, q: float = None,
                       weights=None,
                       hurst_grid=(0.05, 0.07, 0.10, 0.15, 0.25, 0.40),
                       num_paths: int = 16_384, num_steps: int = 48,
                       pop_size: int = 24, iters: int = 40,
                       polish_steps: int = 80, seed: int = 0,
                       *, device="cuda") -> Dict[str, object]:
    """Fit rough Bergomi to a call-price surface.

    (eta, rho, xi) are fit by batched DE + Adam per Hurst-grid point; H is
    selected by the best polished objective. Several maturities identify
    H: the T^{H-1/2} skew term structure separates (H, eta).

    Args:
        maturities: (m,) years; strikes: (m, k); market_prices: (m, k)
        call prices; weights: optional (m, k) quote weights.
    """
    device = torch.device(device)
    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    mats = np.asarray(maturities, np.float64)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    if weights is None:
        weights = np.ones_like(market)
    weights = np.asarray(weights, np.float64) / np.sum(weights)

    # One set of normals per maturity, shared by every H and candidate.
    gen = seeded_generator(seed, device)
    z_list = [torch.randn((num_paths, 2 * num_steps), generator=gen,
                          device=device, dtype=torch.float32)
              for _ in mats]
    bounds = np.array([RBERGOMI_CAL_BOUNDS["eta"],
                       RBERGOMI_CAL_BOUNDS["rho"],
                       RBERGOMI_CAL_BOUNDS["xi"]], np.float32)
    best = None
    per_h = {}
    for h in hurst_grid:
        data = {"spot": _f32(spot, device), "r": _f32(r, device),
                "q": _f32(q, device),
                "strikes": _f32(strikes, device),
                "market": _f32(market, device),
                "weights": _f32(weights, device),
                "sheets": _cal_sheets(z_list, float(h), mats, num_steps,
                                      device)}

        def objective(x, data=data):
            return _rbergomi_cal_objective(x, data)

        with torch.no_grad():
            res = differential_evolution(
                objective, bounds, seeded_generator(seed + 1, device),
                pop_size=pop_size, iters=iters)
        x, fun = adam_polish(objective, res.x, bounds, steps=polish_steps,
                             lr=0.02)
        x = x.detach().cpu().numpy().astype(np.float64)
        entry = {"hurst": float(h), "eta": float(x[0]), "rho": float(x[1]),
                 "xi": float(x[2]), "objective": float(fun)}
        per_h[f"{h:g}"] = entry
        if best is None or entry["objective"] < best["objective"]:
            best = entry
    params = RoughBergomiParams(xi=best["xi"], eta=best["eta"],
                                rho=best["rho"], r=r, q=q,
                                hurst=best["hurst"])
    return {
        "params": params,
        **best,
        "rmse_price": float(np.sqrt(best["objective"])),
        "hurst_grid": dict(sorted(per_h.items(),
                                  key=lambda kv: kv[1]["objective"])),
        "n_quotes": int(market.size),
    }
