"""Consistent term-structure SVJ engine: one process, many expiries
(counterpart of `mcos_tpu/engine/termsvj.py`).

One piecewise-constant time-dependent SVJ process (ops/tdsvj.py) instead
of one constant-parameter model per expiry, so products whose value
depends on the path across expiries (forward starts, cliquets) have a
well-defined price.

- `TDSVJEngine`: MC pricing under td dynamics with the estimator stack of
  `MonteCarloEngine` (`pricer._price_terminal`: antithetic pairs,
  GBM-companion control variate, pair-pooled standard error).
  `price_batch` runs kernel K9 (`cuda_kernels.svj_terminal_td`: the kernel
  on a CUDA device, its plain version on the CPU); Greeks, forward starts,
  cliquets and the variance swap's Monte Carlo leg ride the differentiable
  torch twins; `cos_chain` is the exact chained-Riccati COS oracle;
  `price_american` is the Longstaff-Schwartz of `engine/american.py` on
  the td sheet (torch ops, no kernel).
- `bootstrap_calibrate_td`: the sequential bootstrap: fit segment s's
  (θ_s, ξ_s, λ_s) to expiry T_s's chain with segments 1..s−1 frozen, on
  the td COS objective (no MC in the loop, host only).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.engine.cliquet import (
    _cliquet_payoff,
    _optimal_beta_adjust,
    _period_loop,
    cliquet_bs,
    forward_start_bs,
)
from mcos_tpu_torch.engine.pricer import (
    _price_terminal,
    resolve_mesh,
    seeded_generator,
    to_host,
)
from mcos_tpu_torch.models.params import SVJParams, TermStructureSVJ
from mcos_tpu_torch.ops import cuda_kernels
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.simulate import (
    _step_draws,
    combine_antithetic,
    mc_mean_stderr,
)
from mcos_tpu_torch.ops.tdsvj import (
    _step_levels,
    cos_price_td,
    normalize_segments,
    segments_from_term_structure,
    simulate_reset_td,
    simulate_terminal_td,
    step_param_arrays,
    td_variance_swap_fair_strike,
)

logger = logging.getLogger("mcos_tpu_torch.termsvj")


def mc_price_td_core(
    params: SVJParams, theta_t, xi_t, lam_t, spot, strikes, T,
    generator: torch.Generator, *, num_paths: int, num_steps: int,
    is_call: bool = True, antithetic: bool = True,
    control_variate: bool = True, cv_beta: str = "optimal", device="cuda",
) -> Dict[str, torch.Tensor]:
    """`mc_price_core` under time-dependent (θ, ξ, λ) dynamics, on the torch
    twin driven by `generator`. Defaults to the β* control since
    time-varying ξ/λ decorrelate the SVJ payoff from its constant-σ GBM
    companion more than the constant model does."""
    s_final, v_final, g_final = simulate_terminal_td(
        params, theta_t, xi_t, lam_t, spot, T, generator,
        num_paths=num_paths, num_steps=num_steps, antithetic=antithetic,
        companion=control_variate, device=device)
    return _price_terminal(params, spot, strikes, T, s_final, v_final,
                           g_final, is_call, control_variate, "companion",
                           cv_beta)


def mc_price_td_cuda(
    params: SVJParams, theta_t, xi_t, lam_t, spot, strikes, T, seed: int, *,
    num_paths: int, num_steps: int, is_call: bool = True,
    antithetic: bool = True, control_variate: bool = True,
    cv_beta: str = "optimal", device="cuda",
) -> Dict[str, torch.Tensor]:
    """`mc_price_td_core` with terminals from kernel K9 keyed on `seed`
    (counterpart of `mc_price_td_pallas`). A CUDA `device` launches the
    kernel, the CPU runs its plain version."""
    s_final, v_final, g_final = cuda_kernels.svj_terminal_td(
        params, theta_t, xi_t, lam_t, spot, T, seed, num_paths=num_paths,
        num_steps=num_steps, antithetic=antithetic,
        companion=control_variate, device=device)
    return _price_terminal(params, spot, strikes, T, s_final, v_final,
                           g_final, is_call, control_variate, "companion",
                           cv_beta)


def _td_delta_vega(params: SVJParams, theta_t, xi_t, lam_t, spot, strike, T,
                   generator: torch.Generator, *, num_paths: int,
                   num_steps: int, is_call: bool, device="cuda"):
    """Pathwise AD (∂P/∂S₀, ∂P/∂v₀) through the td twin in one backward
    pass, with the companion difference as the control (jump indicators do
    not depend on (S₀, v₀), so the pathwise derivative of the vanilla
    payoff is unbiased; the per-step (θ, ξ, λ) enter as constants).
    Returns 0-d tensors (price, dS, dv0)."""
    device = torch.device(device)
    s0 = torch.tensor(float(spot), dtype=torch.float32, device=device,
                      requires_grad=True)
    v0 = torch.tensor(float(params.v0), dtype=torch.float32, device=device,
                      requires_grad=True)
    p = params.replace(v0=v0)
    s_final, _, g_final = simulate_terminal_td(
        p, theta_t, xi_t, lam_t, s0, T, generator, num_paths=num_paths,
        num_steps=num_steps, antithetic=True, companion=True, device=device)
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


def _period_log_returns_td(params: SVJParams, th_ps, xi_ps, lam_ps, T,
                           generator: Optional[torch.Generator], *,
                           num_paths: int, n_periods: int,
                           steps_per_period: int, companion: bool = True,
                           draws=None, device="cuda"):
    """Per-period log returns under td dynamics: (n_periods, 2, num_paths)
    for S and for the GBM companion on the same dW₁ (None without
    `companion`), antithetic branches on axis 1.

    `th_ps/xi_ps/lam_ps` are (n_periods, steps_per_period) per-step levels
    (a host-side reshape of `step_param_arrays`' output). The period loop
    is `cliquet.simulate_period_log_returns`'s, with per-step parameters.
    Randoms: `generator`'s (steps, 3, paths) normals and (steps, paths)
    uniforms, all up front, or `draws=(z, u)` of those shapes.
    """
    n_steps = n_periods * steps_per_period
    if draws is not None:
        device = draws[0].device
    else:
        device = torch.device(device)
        draws = (torch.randn((n_steps, 3, num_paths), generator=generator,
                             device=device, dtype=torch.float32),
                 torch.rand((n_steps, num_paths), generator=generator,
                            device=device, dtype=torch.float32))
    th, xi, lam = _step_levels(th_ps, xi_ps, lam_ps, n_steps)
    return _period_loop(
        params, T, _step_draws(draws, None, (num_paths,), n_steps, device),
        num_paths=num_paths, n_periods=n_periods,
        steps_per_period=steps_per_period, companion=companion,
        step_params=lambda t: params.replace(theta=th[t], xi=xi[t],
                                             lambda_j=lam[t]),
        device=device)


class TDSVJEngine:
    """Pricing engine for the piecewise-constant time-dependent SVJ model
    on `device`.

    Args:
        params: global (κ, ρ, v0, μ_J, σ_J, r, q); its (θ, ξ, λ) fields are
            ignored: the segment arrays supply them.
        seg_ends/thetas/xis/lams: ascending segment right edges (years) and
            per-segment levels. Maturities beyond the last edge extend it
            flat; shorter maturities use the covering prefix
            (`tdsvj.normalize_segments`).
        backend: "cuda" (kernel K9; its plain version on the CPU) or
            "torch" (the twin on a generator seeded with `seed`).
        mesh: None | "auto" | a `parallel.mesh.Mesh` (`_resolved_mesh`); a
            resolved mesh shards `price_batch` with the β = 1 companion CV
            (`parallel/families.py:sharded_td_price`).
    """

    def __init__(
        self,
        params: SVJParams,
        seg_ends: Sequence[float],
        thetas: Sequence[float],
        xis: Sequence[float],
        lams: Sequence[float],
        num_paths: int = 200_000,
        num_steps: int = 512,
        seed: int = 42,
        backend: str = "cuda",
        control_variate: bool = True,
        mesh=None,
        *,
        device="cuda",
    ):
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.params = params
        self.seg_ends = np.asarray(seg_ends, np.float64)
        self.thetas = np.asarray(thetas, np.float64)
        self.xis = np.asarray(xis, np.float64)
        self.lams = np.asarray(lams, np.float64)
        if not (self.seg_ends.shape == self.thetas.shape == self.xis.shape
                == self.lams.shape) or self.seg_ends.size == 0:
            raise ValueError("segment arrays must share one nonzero length")
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.backend = backend
        self.control_variate = control_variate
        self.mesh = mesh
        self.device = torch.device(device)

    @classmethod
    def from_term_structure(
        cls, ts: TermStructureSVJ, horizon: float, n_segments: int = 8,
        **kwargs,
    ) -> "TDSVJEngine":
        """Forward-strip a `TermStructureSVJ`'s maturity curves into one
        consistent process (`tdsvj.segments_from_term_structure`)."""
        ends, th, xi, lam = segments_from_term_structure(
            ts, horizon, n_segments)
        params = SVJParams(
            kappa=ts.kappa, theta=float(th[0]), xi=float(xi[0]),
            rho=ts.rho, v0=ts.v0, lambda_j=float(lam[0]), mu_j=ts.mu_j,
            sigma_j=ts.sigma_j, r=ts.r, q=ts.q)
        return cls(params, ends, th, xi, lam, **kwargs)

    def _step_arrays(self, T: float, num_steps: Optional[int] = None):
        ends, th, xi, lam = normalize_segments(
            self.seg_ends, self.thetas, self.xis, self.lams, T)
        return step_param_arrays(ends, th, xi, lam, T,
                                 num_steps or self.num_steps)

    def _resolved_mesh(self):
        return resolve_mesh(self.mesh)

    def price_batch(self, spot: float, strikes, T: float,
                    is_call: bool = True) -> List[Dict]:
        """European chain at one expiry off one shared td path set."""
        th_t, xi_t, lam_t = self._step_arrays(float(T))
        strikes_arr = np.asarray(np.atleast_1d(strikes), np.float32)
        mesh = self._resolved_mesh()
        if mesh is not None:
            # Path-sharded: pooled moments with the β = 1 companion CV
            # inside the sharded driver.
            from mcos_tpu_torch.parallel.families import sharded_td_price

            res = to_host({k: v for k, v in sharded_td_price(
                self.params, th_t, xi_t, lam_t, spot, strikes_arr, T,
                self.seed, mesh=mesh, num_paths=self.num_paths,
                num_steps=self.num_steps, is_call=is_call,
                control_variate=self.control_variate,
                backend=self.backend).items()
                if k in ("price", "std_error")})
            return [
                {"strike": float(k), "price": float(res["price"][i]),
                 "std_error": float(res["std_error"][i]),
                 "num_devices": mesh.size}
                for i, k in enumerate(np.atleast_1d(strikes))
            ]
        common = dict(num_paths=self.num_paths, num_steps=self.num_steps,
                      is_call=is_call, control_variate=self.control_variate,
                      device=self.device)
        if self.backend == "cuda":
            res = mc_price_td_cuda(self.params, th_t, xi_t, lam_t, spot,
                                   strikes_arr, T, self.seed, **common)
        else:
            res = mc_price_td_core(
                self.params, th_t, xi_t, lam_t, spot, strikes_arr, T,
                seeded_generator(self.seed, self.device), **common)
        host = to_host({k: res[k] for k in ("price", "std_error",
                                            "raw_mc_price")})
        return [
            {"strike": float(k), "price": float(host["price"][i]),
             "std_error": float(host["std_error"][i]),
             "raw_mc_price": float(host["raw_mc_price"][i])}
            for i, k in enumerate(np.atleast_1d(strikes))
        ]

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True) -> Dict:
        return self.price_batch(spot, [strike], T, is_call)[0]

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict:
        """Pathwise AD delta + vega under td dynamics (one backward pass)."""
        th_t, xi_t, lam_t = self._step_arrays(float(T))
        price, d_s, d_v0 = _td_delta_vega(
            self.params, th_t, xi_t, lam_t, spot, strike, T,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self.num_steps,
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

    def price_american(self, spot: float, strike: float, T: float,
                       is_call: bool = False, exercise_every: int = 1) -> Dict:
        """Longstaff-Schwartz American/Bermudan under td dynamics: early
        exercise decisions against a KNOWN vol term structure (e.g. a put
        across a scheduled calm→stressed transition). The LSM of
        engine/american.py on the td sheet recorder, driven by the engine's
        seed; exercise_every = num_steps degenerates to the European td
        price (held against the td COS oracle)."""
        from mcos_tpu_torch.engine.american import lsm_price

        th_t, xi_t, lam_t = self._step_arrays(float(T))
        out = lsm_price(
            self.params, spot, strike, T,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self.num_steps,
            is_call=is_call, exercise_every=exercise_every,
            td_table=np.stack([th_t, xi_t, lam_t]), device=self.device)
        return {k: float(v) for k, v in to_host(out).items()}

    def price_forward_start(self, spot: float, t1: float, T: float,
                            k: float = 1.0, is_call: bool = True) -> Dict:
        """Forward-start performance option max(±(S_T/S_t₁ − k), 0) under
        the td dynamics: the product class that requires one consistent
        process (the same segments that reprice the vanilla strip also
        price the path).

        Companion control: the GBM leg's forward-start price is exact
        (`forward_start_bs` at σ = √v0); β* absorbs decorrelation.
        """
        if not 0.0 < t1 < T:
            raise ValueError("need 0 < t1 < T for a forward start")
        p = self.params
        th_t, xi_t, lam_t = self._step_arrays(float(T))
        split = min(max(int(round(t1 / T * self.num_steps)), 1),
                    self.num_steps - 1)
        s_r, s_T, g_r, g_T = simulate_reset_td(
            p, th_t, xi_t, lam_t, spot, T, split,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=self.num_steps,
            companion=self.control_variate, device=self.device)
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(torch.clamp(phi * (s_T / s_r - k), min=0.0))
        discount = float(np.exp(-float(p.r) * T))
        t1_eff = split / self.num_steps * float(T)
        out = {"t1_effective": t1_eff, "num_paths_used": self.num_paths}
        if self.control_variate:
            ctrl = combine_antithetic(
                torch.clamp(phi * (g_T / g_r - k), min=0.0))
            ctrl_exact = forward_start_bs(
                t1_eff, float(T), k, float(p.r), float(p.q),
                float(np.sqrt(float(p.v0))), is_call)
            out["cv_beta"], pay = _optimal_beta_adjust(pay, ctrl, ctrl_exact,
                                                       discount)
        mean, se = mc_mean_stderr(pay)
        out["price"] = discount * float(mean)
        out["std_error"] = discount * float(se)
        return out

    def price_cliquet(self, T: float, n_periods: int = 4,
                      local_floor: float = 0.0, local_cap: float = 0.08,
                      global_floor: float = 0.0,
                      global_cap: float = float("inf"),
                      notional: float = 1.0) -> Dict:
        """Cliquet N·clip(Σⱼ clip(Rⱼ, f_loc, c_loc), f_glob, c_glob) under
        td dynamics: per-period coupons accrue under different (θ, ξ, λ)
        regimes. Control: the capped-sum cliquet on the GBM companion legs
        with the exact `cliquet_bs` expectation (β*)."""
        p = self.params
        spp = max(self.num_steps // n_periods, 1)
        n_steps = n_periods * spp
        th_t, xi_t, lam_t = self._step_arrays(float(T), n_steps)
        dlog_s, dlog_g = _period_log_returns_td(
            p, th_t, xi_t, lam_t, T,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, n_periods=n_periods,
            steps_per_period=spp, companion=self.control_variate,
            device=self.device)
        pay = notional * _cliquet_payoff(dlog_s, local_floor, local_cap,
                                         global_floor, global_cap)
        discount = float(np.exp(-float(p.r) * T))
        out = {"n_periods": n_periods, "num_paths_used": self.num_paths,
               "num_steps": n_steps}
        if self.control_variate:
            ctrl = notional * _cliquet_payoff(
                dlog_g, local_floor, local_cap, -np.inf, np.inf)
            ctrl_exact = cliquet_bs(
                float(T), n_periods, float(p.r), float(p.q),
                float(np.sqrt(float(p.v0))), local_floor, local_cap,
                notional)
            out["cv_beta"], pay = _optimal_beta_adjust(pay, ctrl, ctrl_exact,
                                                       discount)
        mean, se = mc_mean_stderr(pay)
        out["price"] = discount * float(mean)
        out["std_error"] = discount * float(se)
        return out

    def variance_swap(self, T: float) -> Dict:
        """Fair variance strike under td dynamics: the exact closed form
        (`tdsvj.td_variance_swap_fair_strike`) with a discrete-sampling MC
        round trip on per-step log returns."""
        closed = td_variance_swap_fair_strike(
            self.params, self.seg_ends, self.thetas, self.xis, self.lams,
            float(T))
        th_t, xi_t, lam_t = self._step_arrays(float(T))
        dlog_s, _ = _period_log_returns_td(
            self.params, th_t, xi_t, lam_t, T,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, n_periods=self.num_steps,
            steps_per_period=1, companion=False, device=self.device)
        rv = torch.sum(dlog_s**2, dim=0) / float(T)   # (2, paths)
        pairs = combine_antithetic(rv)
        mc = float(torch.mean(pairs))
        se = (float(torch.std(pairs, correction=0))
              / float(np.sqrt(pairs.shape[-1])))
        return {
            **closed,
            "mc_fair_variance": mc,
            "mc_std_error": se,
            "mc_vs_closed_sigmas": abs(mc - closed["fair_variance"])
            / max(se, 1e-12),
            "num_paths": self.num_paths,
        }

    def cos_chain(self, spot: float, strikes, T: float,
                  is_call: bool = True) -> np.ndarray:
        """Exact chained-Riccati COS prices (the oracle the MC is pinned
        to)."""
        return cos_price_td(self.params, spot, strikes, T, self.seg_ends,
                            self.thetas, self.xis, self.lams, is_call)

    def segments_dict(self) -> Dict:
        return {
            "seg_ends": self.seg_ends.tolist(),
            "thetas": self.thetas.tolist(),
            "xis": self.xis.tolist(),
            "lams": self.lams.tolist(),
        }


def bootstrap_calibrate_td(
    spot: float,
    maturities,
    strikes,
    market_prices,
    shared: SVJParams,
    is_call: bool = True,
    vega_weights=None,
    seed: int = 42,
    maxiter: int = 120,
) -> Dict:
    """Sequential segment bootstrap of the td SVJ model (host only).

    Maturities ascending define the segment grid (segment s = (T_{s−1},
    T_s]). For each s, fit (θ_s, ξ_s, λ_s) to expiry T_s's chain via the td
    COS price with earlier segments frozen, so adding a later expiry never
    reprices an earlier one. `shared` supplies (κ, ρ, v0, μ_J, σ_J, r, q).

    Args:
        market_prices: (num_maturities, num_strikes).
        vega_weights: optional same-shape weights (default uniform).

    Returns dict with the fitted segment arrays + per-expiry objective
    values.
    """
    from scipy.optimize import differential_evolution as scipy_de

    from mcos_tpu_torch.config import TERM_STRUCTURE_BOUNDS

    maturities = np.asarray(maturities, np.float64)
    strikes = np.asarray(strikes, np.float64)
    market_prices = np.asarray(market_prices, np.float64)
    if np.any(np.diff(maturities) <= 0):
        raise ValueError("maturities must be strictly ascending")
    if market_prices.shape != (maturities.size, strikes.size):
        raise ValueError("market_prices must be (num_maturities, num_strikes)")
    if vega_weights is None:
        vega_weights = np.ones_like(market_prices)
    vega_weights = np.asarray(vega_weights, np.float64)

    bounds = [list(TERM_STRUCTURE_BOUNDS["theta_T"]),
              list(TERM_STRUCTURE_BOUNDS["xi_T"]),
              list(TERM_STRUCTURE_BOUNDS["lambda_T"])]

    seg_ends: List[float] = []
    thetas: List[float] = []
    xis: List[float] = []
    lams: List[float] = []
    errors: Dict[float, float] = {}

    for i, T_i in enumerate(maturities):
        w = vega_weights[i]
        market_i = market_prices[i]
        trial_ends = np.asarray(seg_ends + [float(T_i)])

        def obj(x, trial_ends=trial_ends, T_i=T_i, w=w, market_i=market_i):
            th = np.asarray(thetas + [x[0]])
            xi = np.asarray(xis + [x[1]])
            lam = np.asarray(lams + [x[2]])
            model = cos_price_td(shared, spot, strikes, float(T_i),
                                 trial_ends, th, xi, lam, is_call)
            return float(np.sum(w * (model - market_i) ** 2))

        # Best-of-k restarts: DE on the wide TERM_STRUCTURE_BOUNDS box can
        # land on a bound-pinned local minimum for a deep segment; accept
        # early when the fit reaches repricing noise, else keep the best of
        # 3 differently-seeded runs.
        accept = 1e-8 * max(1.0, float(np.sum(w * market_i**2)))
        res = None
        for attempt in range(3):
            cand = scipy_de(obj, bounds, maxiter=maxiter, tol=1e-10,
                            seed=seed + i + 1000 * attempt, polish=True)
            if res is None or cand.fun < res.fun:
                res = cand
            if res.fun < accept:
                break
        seg_ends.append(float(T_i))
        thetas.append(float(res.x[0]))
        xis.append(float(res.x[1]))
        lams.append(float(res.x[2]))
        errors[float(T_i)] = float(res.fun)
        logger.info("td bootstrap segment %d (T=%.3f): θ=%.4f ξ=%.3f λ=%.3f "
                    "err=%.6g", i, T_i, res.x[0], res.x[1], res.x[2], res.fun)

    return {
        "seg_ends": np.asarray(seg_ends),
        "thetas": np.asarray(thetas),
        "xis": np.asarray(xis),
        "lams": np.asarray(lams),
        "errors": errors,
        "shared": shared,
    }
