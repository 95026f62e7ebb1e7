"""Static replication: project a target payoff onto a vanilla hedge chain
(counterpart of `StaticHedgeEngine` in `mcos_tpu/engine/hedge.py`).

Carr–Madan (1998) says any European payoff f(S_T) decomposes exactly into a
bond + forward + a strip of calls; with a finite strike grid the best static
hedge is the L²(paths) projection of the payoff onto
    X = [1, S_T, (S_T − K₁)₊, …, (S_T − K_m)₊],
and for *path-dependent* targets (Asian, barrier, lookback) the projection
residual is precisely the statically-unhedgeable path risk — the number a
desk needs before it agrees to warehouse the exotic.

Where it runs: the target payoff and the terminal spots come off ONE
common-random-number device pass, the path statistics the exotics engine
prices with. backend="cuda": one K6 launch (`cuda_kernels.svj_path_stats`:
the kernel on a CUDA device, its plain version on the CPU) with discrete
monitoring, no bridge and the companion leg off; backend="torch": the twin
`ops/exotics.py:simulate_path_stats` on a generator or on replayed draws.
The (N × m) projection runs on the host in float64 (`np.linalg.lstsq`):
a dense call strip's Gram is near-collinear and float32 normal equations
lose the weights. The hedge is then *valued* by the COS oracle per strike
(`ops/cos_pricer.py`): model prices, not MC noise, in the hedge cost.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import DEFAULT_NUM_PATHS, scaled_steps
from mcos_tpu_torch.engine.exotics import exotic_payoff_and_control
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels
from mcos_tpu_torch.ops import exotics as ops_exotics
from mcos_tpu_torch.ops.cos_pricer import cos_price


def _target_and_terminals(
    params: SVJParams, spot, strike, T, seed: int, barrier,
    *, kind: str, num_paths: int, num_steps: int, is_call: bool,
    averaging: str, knock: str, direction: str, floating: bool,
    backend: str = "cuda", draws=None, device="cuda",
) -> Dict[str, torch.Tensor]:
    """ONE common-random-number device pass: the target payoff samples `y`
    and the terminal spots `s_t`, each (2·num_paths,) float32 on `device`
    (branch-major, as the JAX package flattens them)."""
    if backend == "cuda":
        stats = cuda_kernels.svj_path_stats(
            params, spot, T, seed, num_paths=num_paths, num_steps=num_steps,
            antithetic=True, companion=False, device=device)
    elif backend == "torch":
        generator = (seeded_generator(seed, device) if draws is None
                     else None)
        with torch.no_grad():
            stats = ops_exotics.simulate_path_stats(
                params, spot, T, generator, num_paths=num_paths,
                num_steps=num_steps, antithetic=True, companion=False,
                draws=draws, device=device)
    else:
        raise ValueError(f"unknown backend: {backend!r}")

    s_t = stats["s_final"]
    if kind == "digital":
        pay_b = ((s_t >= strike) if is_call else (s_t <= strike)
                 ).to(torch.float32)
    elif kind == "vanilla":
        pay_b = torch.clamp(s_t - strike, min=0.0) if is_call \
            else torch.clamp(strike - s_t, min=0.0)
    else:
        pay_b, _, _ = exotic_payoff_and_control(
            stats, params, spot, strike, T, barrier, kind=kind,
            num_steps=num_steps, is_call=is_call, averaging=averaging,
            knock=knock, direction=direction, floating=floating,
            one_touch=False, control_variate=False)
    return {"y": pay_b.reshape(-1), "s_t": s_t.reshape(-1)}


def _project(y: np.ndarray, s_t: np.ndarray, spot: float,
             hedge_strikes: np.ndarray) -> Dict:
    """Host-f64 L² projection of y onto [1, S_T, (S_T − Kᵢ)₊]."""
    basis = np.concatenate([
        np.ones((s_t.size, 1)),
        s_t[:, None],
        np.maximum(s_t[:, None] - hedge_strikes[None, :], 0.0),
    ], axis=1)
    w, *_ = np.linalg.lstsq(basis, y, rcond=None)
    resid = y - basis @ w
    var_y = float(np.var(y))
    r2 = 1.0 - float(np.var(resid)) / var_y if var_y > 1e-12 else 1.0
    return {
        "weights": w,
        "r2": r2,
        "resid_std": float(np.std(resid)),
        "resid_quantiles": np.quantile(resid, [0.01, 0.05, 0.5, 0.95,
                                               0.99]),
        "target_mean": float(np.mean(y)),
        "target_se": float(np.std(y) / np.sqrt(y.size)),
    }


class StaticHedgeEngine:
    """Replicating-portfolio construction for a target (possibly
    path-dependent) payoff against a vanilla call chain, on `device`.

    backend: "cuda" (one K6 launch a request; its plain version on the
    CPU) or "torch" (the path-stats twin on a generator seeded with
    `seed`, or on `draws`).
    """

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 252, seed: int = 42, *,
                 backend: str = "cuda", device="cuda"):
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.backend = backend
        self.device = torch.device(device)
        #: backend="torch": (z, u) of the request's steps, else a generator
        #: seeded with `seed` draws them.
        self.draws = None

    def replicate(
        self,
        spot: float,
        T: float,
        kind: str = "digital",
        strike: float = 0.0,
        is_call: bool = True,
        barrier: float = 0.0,
        averaging: str = "arithmetic",
        knock: str = "out",
        direction: str = "up",
        floating: bool = False,
        hedge_strikes: Optional[Sequence[float]] = None,
        n_hedge: int = 13,
    ) -> Dict:
        """Build the static hedge and value it with the exact COS oracle.

        Returns the hedge weights (bond / forward / per-strike calls), the
        model value of the hedge portfolio, the target's MC price off the
        same paths, R², and the residual (unhedged P&L) distribution in
        discounted currency units.
        """
        if kind not in ("digital", "vanilla", "asian", "barrier", "lookback"):
            raise ValueError(f"unknown replication target: {kind!r}")
        if hedge_strikes is None:
            hedge_strikes = np.linspace(0.80, 1.20, int(n_hedge)) * spot
        hedge_strikes = np.asarray(hedge_strikes, np.float64)
        if hedge_strikes.size < 1:
            raise ValueError("need at least one hedge strike")

        steps = scaled_steps(self.num_steps, T)
        dev = _target_and_terminals(
            self.params, spot, strike, T, self.seed, barrier, kind=kind,
            num_paths=self.num_paths, num_steps=steps, is_call=is_call,
            averaging=averaging, knock=knock, direction=direction,
            floating=floating, backend=self.backend, draws=self.draws,
            device=self.device)
        host = torch.stack([dev["y"], dev["s_t"]]).cpu().numpy()
        out = _project(host[0].astype(np.float64),
                       host[1].astype(np.float64), spot, hedge_strikes)

        r, q = float(self.params.r), float(self.params.q)
        discount = float(np.exp(-r * T))
        w = np.asarray(out["weights"], np.float64)
        # The Heston CF divides by ξ² and by β±d (β = κ − ρξiu, which is 0
        # at u=0 when κ=ρ=0); the exact-GBM degenerate point (gbm_params:
        # κ=ξ=0) needs floors for the valuation leg only — the price impact
        # is O(ξ²T) and O(κ·0) respectively, far below f64 COS truncation.
        p_val = self.params
        if float(p_val.xi) < 1e-4:
            p_val = p_val.replace(xi=1e-4)
        if float(p_val.kappa) < 1e-6:
            p_val = p_val.replace(kappa=1e-6)
        call_values = np.asarray(
            cos_price(p_val, spot, hedge_strikes, T, True), np.float64)
        forward_value = spot * float(np.exp(-q * T))
        hedge_value = (w[0] * discount + w[1] * forward_value
                       + float(w[2:] @ call_values))
        resid_q = np.asarray(out["resid_quantiles"], np.float64) * discount
        return {
            "kind": kind,
            "hedge_strikes": hedge_strikes.tolist(),
            "weights": {
                "bond": float(w[0]),
                "forward": float(w[1]),
                "calls": w[2:].tolist(),
            },
            "hedge_value": float(hedge_value),
            "target_price_mc": float(out["target_mean"]) * discount,
            "target_se": float(out["target_se"]) * discount,
            "r2": float(out["r2"]),
            "resid_std": float(out["resid_std"]) * discount,
            "resid_quantiles": {
                "p01": resid_q[0], "p05": resid_q[1], "p50": resid_q[2],
                "p95": resid_q[3], "p99": resid_q[4],
            },
            "unhedgeable_fraction": float(
                np.sqrt(max(1.0 - out["r2"], 0.0))),
        }
