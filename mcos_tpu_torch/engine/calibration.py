"""Two-stage SVJ calibration engine of the port (counterpart of
`mcos_tpu/engine/calibration.py`).

Semantics as in the JAX package:

- Stage 1 fits the Heston core (κ, θ, ξ, ρ, v0) on 0.95-1.05 forward
  moneyness; stage 2 fits the jumps (λ, μ_J, σ_J) on 0.80-1.20 with the
  core frozen.
- Vega/spread weights w = Vega/BidAsk, normalized.
- Objective = weighted SSE of model-vs-market prices + Tikhonov on ξ/ρ/λ +
  the soft Feller penalty 10·(ξ²−2κθ)².
- Stage 1 gets an Adam polish on the pathwise gradient; stage 2 stays
  derivative-free (the jump indicator 1{U < λdt} has zero pathwise
  derivative in λ).

The Monte Carlo objectives on the device (`calibrate`):

- One draw set per calibration: (z1, z2, u_jump, z_js), each (steps,
  paths), from the engine's seeded generator, kept for every generation
  and both stages (common random numbers: the JAX package prices every
  member on one key's paths).
- A member's chain is the price of `mc_price_from_draws` (antithetic,
  companion control variate). The DE generations take backend="cuda":
  the population copied to the host once a generation, one K1 launch for
  all its members (`svj_terminal_from_draws_population`; on a CPU device
  its plain version) and one (P, K, paths) pricing tail
  (`population_prices_from_draws`), as the JAX package vmaps the
  objective over the population. The Adam polish needs a gradient, so it
  takes backend="torch": the Euler twin under autograd on the same draws,
  member by member (K1 has no backward kernel, in either package).

`calibrate_fast`, `calibrate_from_chain`, `parameter_uncertainty` and
`calibrate_term_structure` are host numpy and scipy over the port's copy
of the COS/Bates pricer, as in the JAX package. `calibrate(mesh=...)`
splits each DE population over the mesh (one K1 population launch a
shard a generation), and `make_sharded_calibration_step` is the JAX
package's sharded training step: strikes over one mesh axis, paths over
the other, an Adam step on the pathwise gradient.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from mcos_tpu_torch.config import (
    CALIBRATION_CONFIG,
    PARAM_BOUNDS,
    REGULARIZATION,
)
from mcos_tpu_torch.engine.pricer import (mc_price_from_draws,
                                          population_prices_from_draws,
                                          seeded_generator)
from mcos_tpu_torch.models.params import SVJParams, forward_price
from mcos_tpu_torch.ops.bs import bs_vega
from mcos_tpu_torch.utils.optim import adam_polish, differential_evolution

logger = logging.getLogger("mcos_tpu_torch.calibration")

HESTON_BOUNDS = np.array([
    PARAM_BOUNDS["kappa"], PARAM_BOUNDS["theta"], PARAM_BOUNDS["xi"],
    PARAM_BOUNDS["rho"], PARAM_BOUNDS["v0"],
], np.float32)
JUMP_BOUNDS = np.array([
    PARAM_BOUNDS["lambda_j"], PARAM_BOUNDS["mu_j"], PARAM_BOUNDS["sigma_j"],
], np.float32)
_HESTON_NAMES = ("kappa", "theta", "xi", "rho", "v0")
_JUMP_NAMES = ("lambda_j", "mu_j", "sigma_j")


def compute_vega_weights(
    spot, strikes, T, r, q, atm_vol, bid_ask_spreads=None, *, device=None,
) -> torch.Tensor:
    """w_i = Vega_i / BidAskSpread_i, normalized; float32 on `device`
    (default the CPU)."""
    strikes = torch.as_tensor(np.asarray(strikes, np.float32),
                              device=device)
    vegas = torch.clamp(bs_vega(spot, strikes, T, r, q, atm_vol), min=1e-10)
    if bid_ask_spreads is not None:
        spreads = torch.as_tensor(np.asarray(bid_ask_spreads, np.float32),
                                  device=strikes.device)
        weights = vegas / torch.clamp(spreads, min=1e-4)
    else:
        weights = vegas
    return weights / torch.sum(weights)


def _feller_penalty(kappa, theta, xi):
    """Soft Feller penalty 10·(ξ² − 2κθ)² when violated."""
    violation = xi * xi - 2.0 * kappa * theta
    return torch.where(violation > 0, 10.0 * violation * violation,
                       torch.zeros_like(violation))


def _chain_prices(params: SVJParams, spot, strikes, T, draws, *,
                  is_call: bool, backend: str) -> torch.Tensor:
    """Model prices for a strike chain off the shared draws (CRN)."""
    z1, z2, u_jump, z_js = draws
    res = mc_price_from_draws(
        params, spot, strikes, T, z1, z2, u_jump, z_js, is_call=is_call,
        antithetic=True, control_variate=True, cv_mode="companion",
        backend=backend, steps_major=True)
    return res["price"]


def _member_params(x: torch.Tensor, names, backend: str, **fixed):
    """One SVJParams per row of the (P, D) population `x`. backend="cuda"
    (the kernel takes host floats): one device→host copy of the whole
    population; backend="torch": the rows' 0-d tensors, so autograd
    records the twin."""
    rows = x.detach().cpu().tolist() if backend == "cuda" else x
    return [SVJParams(**dict(zip(names, row)), **fixed) for row in rows]


def _chain_sse(x: torch.Tensor, names, data, *, is_call: bool,
               backend: str, **fixed) -> torch.Tensor:
    """(P,) weighted SSE of each member's chain against the market.
    backend="cuda" prices the whole population at once: one K1 launch and
    one (P, K, paths) pricing tail (`population_prices_from_draws`);
    backend="torch" runs the twin member by member under autograd."""
    members = _member_params(x, names, backend, r=data["r"], q=data["q"],
                             **fixed)
    if backend == "cuda":
        model = population_prices_from_draws(
            members, data["spot"], data["strikes"], data["T"],
            *data["draws"], is_call=is_call)
    else:
        model = torch.stack([
            _chain_prices(p, data["spot"], data["strikes"], data["T"],
                          data["draws"], is_call=is_call, backend=backend)
            for p in members])
    return torch.sum(data["weights"] * (model - data["market_prices"]) ** 2,
                     dim=-1)


def heston_objective(x: torch.Tensor, data: Dict, *, is_call: bool = True,
                     backend: str = "cuda") -> torch.Tensor:
    """Stage-1 objective over a (P, 5) population of [κ, θ, ξ, ρ, v0] →
    (P,). Jumps off (λ = 0; σ_J = 0.01 placeholder as the JAX package
    uses). `data`: spot, strikes, T, market_prices, weights (on the draws'
    device), r, q (floats) and draws = (z1, z2, u_jump, z_js), each
    (steps, paths). Deterministic given the draws; differentiable in x
    with backend="torch"."""
    sse = _chain_sse(x, _HESTON_NAMES, data, is_call=is_call,
                     backend=backend, lambda_j=0.0, mu_j=0.0, sigma_j=0.01)
    kappa, theta, xi, rho = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    reg = REGULARIZATION["xi"] * xi**2 + REGULARIZATION["rho"] * rho**2
    return sse + reg + _feller_penalty(kappa, theta, xi)


def svj_objective(x_jump: torch.Tensor, data: Dict, *, is_call: bool = True,
                  backend: str = "cuda") -> torch.Tensor:
    """Stage-2 objective over a (P, 3) population of [λ, μ_J, σ_J] with
    the core frozen → (P,). `data` additionally carries `heston_x`, the
    five core floats."""
    core = dict(zip(_HESTON_NAMES, (float(v) for v in data["heston_x"])))
    sse = _chain_sse(x_jump, _JUMP_NAMES, data, is_call=is_call,
                     backend=backend, **core)
    return sse + REGULARIZATION["lambda_j"] * x_jump[:, 0] ** 2


def _calibration_draws(num_paths: int, num_steps: int,
                      generator: torch.Generator):
    """(z1, z2, u_jump, z_js), each (num_steps, num_paths) float32 on the
    generator's device: normals first, then the jump uniforms."""
    device = generator.device
    z = torch.randn((3, num_steps, num_paths), generator=generator,
                    device=device, dtype=torch.float32)
    u = torch.rand((num_steps, num_paths), generator=generator,
                   device=device, dtype=torch.float32)
    return z[0], z[1], u, z[2]


def _data_at(data: Dict):
    """device → `data` with its tensors on that device, each copy made once
    (the objective of a population shard reads its rows' device)."""
    from mcos_tpu_torch.parallel.mesh import _on

    copies: Dict[str, Dict] = {}

    def at(device) -> Dict:
        key = str(device)
        if key not in copies:
            copies[key] = _on(data, torch.device(device))
        return copies[key]
    return at


def _stage_masks(strikes, F, cfg):
    moneyness = strikes / F
    m1 = ((moneyness >= cfg.stage1_moneyness_range[0])
          & (moneyness <= cfg.stage1_moneyness_range[1]))
    m2 = ((moneyness >= cfg.stage2_moneyness_range[0])
          & (moneyness <= cfg.stage2_moneyness_range[1]))
    if not m1.any():
        m1 = np.ones_like(m1)  # degenerate chain: use everything
    if not m2.any():
        m2 = np.ones_like(m2)
    return m1, m2


class CalibrationEngine:
    """Two-stage SVJ calibration (the JAX package's API). Result dict keys:
    `params`, `stage1_result`, `stage2_result`, `warnings`,
    `feller_satisfied`, `uncertainty`. `device` is where `calibrate` runs
    its Monte Carlo objectives."""

    def __init__(self, config=None, device="cuda"):
        self.config = config or CALIBRATION_CONFIG
        self.device = torch.device(device)
        self.history: List[Dict] = []

    def calibrate(
        self,
        spot: float,
        strikes,
        T: float,
        market_prices,
        is_call: bool = True,
        r: float = 0.065,
        q: float = 0.012,
        bid_ask_spreads=None,
        atm_vol: float = 0.15,
        num_paths: int = 100_000,
        num_steps: int = 50,
        seed: int = 42,
        pop_size: int = 24,
        polish: bool = True,
        mesh=None,
        pop_axis: str = "paths",
    ) -> Dict:
        """Two-stage Monte Carlo fit (see the module docstring). The draws
        come from `seeded_generator(seed, device)`, stage 1's DE from
        seed + 1 and stage 2's from seed + 2. `mesh` (a
        `parallel.mesh.Mesh`) splits each DE population over its
        `pop_axis` shards: each shard prices its members with one K1
        population launch off the shared draws, copied once to its
        device; the generations and the Adam polish stay on `device`."""
        device = self.device
        strikes = np.asarray(strikes, np.float32)
        market_prices = np.asarray(market_prices, np.float32)
        cfg = self.config

        F = float(forward_price(spot, r, q, T))
        m1, m2 = _stage_masks(strikes, F, cfg)
        bas = np.asarray(bid_ask_spreads) if bid_ask_spreads is not None else None
        draws = _calibration_draws(num_paths, num_steps,
                                  seeded_generator(seed, device))

        def stage_data(mask):
            return {
                "spot": float(spot), "T": float(T), "r": float(r),
                "q": float(q), "draws": draws,
                "strikes": torch.as_tensor(strikes[mask], device=device),
                "market_prices": torch.as_tensor(market_prices[mask],
                                                 device=device),
                "weights": compute_vega_weights(
                    spot, strikes[mask], T, r, q, atm_vol,
                    bas[mask] if bas is not None else None, device=device),
            }

        # ── Stage 1: Heston core ────────────────────────────────────────────
        logger.info("Stage 1: Heston core on %d strikes", int(m1.sum()))
        data1 = stage_data(m1)
        # Warm-start member: the surface-consistent v0 = θ = ATM_IV².
        x0_heston = [3.0, atm_vol**2, 0.5, -0.7, atm_vol**2]
        iters1 = max(cfg.stage1_max_iter // 4, 25)
        at1 = _data_at(data1)
        with torch.no_grad():
            res1 = differential_evolution(
                lambda x: heston_objective(x, at1(x.device),
                                           is_call=is_call),
                HESTON_BOUNDS, seeded_generator(seed + 1, device),
                pop_size=pop_size, iters=iters1, x0=x0_heston, mesh=mesh,
                pop_axis=pop_axis)
        x1, f1 = res1.x, float(res1.fun)
        if polish:
            x1p, f1p = adam_polish(
                lambda x: heston_objective(x, data1, is_call=is_call,
                                           backend="torch"),
                x1, HESTON_BOUNDS, steps=40, lr=cfg.learning_rate)
            if float(f1p) < f1:
                x1, f1 = x1p.detach(), float(f1p)
        x1 = [float(v) for v in x1.cpu().numpy()]
        logger.info("Stage 1 done: κ=%.3f θ=%.4f ξ=%.3f ρ=%.3f v0=%.4f err=%.6g",
                    *x1, f1)

        # ── Stage 2: jumps, core frozen ─────────────────────────────────────
        logger.info("Stage 2: jump params on %d strikes", int(m2.sum()))
        data2 = dict(stage_data(m2), heston_x=x1)
        iters2 = max(cfg.stage2_max_iter // 4, 25)
        at2 = _data_at(data2)
        with torch.no_grad():
            res2 = differential_evolution(
                lambda x: svj_objective(x, at2(x.device), is_call=is_call),
                JUMP_BOUNDS, seeded_generator(seed + 2, device),
                pop_size=pop_size, iters=iters2, x0=[1.0, -0.05, 0.10],
                mesh=mesh, pop_axis=pop_axis)
        x2 = [float(v) for v in res2.x.cpu().numpy()]
        f2 = float(res2.fun)
        logger.info("Stage 2 done: λ=%.3f μ_J=%.4f σ_J=%.4f err=%.6g",
                    *x2, f2)

        final = SVJParams(**dict(zip(_HESTON_NAMES, x1)),
                          **dict(zip(_JUMP_NAMES, x2)), r=r, q=q)
        warnings = final.validate()
        self.history.append({
            "params": [float(v) for v in final.to_array()],
            "stage1_error": f1,
            "stage2_error": f2,
            "warnings": warnings,
        })
        try:
            # Error bars off the exact COS oracle at the MC-fitted optimum.
            uncertainty = self.parameter_uncertainty(
                final, spot, strikes, T, market_prices, is_call,
                bid_ask_spreads=bid_ask_spreads, atm_vol=atm_vol)
        except (np.linalg.LinAlgError, ValueError, FloatingPointError):
            uncertainty = None
        return {
            "params": final,
            "stage1_result": {"error": f1, "nit": int(res1.nit),
                              "success": bool(np.isfinite(f1))},
            "stage2_result": {"error": f2, "nit": int(res2.nit),
                              "success": bool(np.isfinite(f2))},
            "warnings": warnings,
            "feller_satisfied": final.feller_satisfied,
            "uncertainty": uncertainty,
        }

    def calibrate_fast(
        self,
        spot: float,
        strikes,
        T: float,
        market_prices,
        is_call: bool = True,
        r: float = 0.065,
        q: float = 0.012,
        bid_ask_spreads=None,
        atm_vol: float = 0.15,
        seed: int = 42,
        regime_adjustments: Optional[Dict] = None,
    ) -> Dict:
        """Two-stage calibration against the semi-analytic COS/Bates pricer
        on the host: the same masks, weights, Tikhonov and Feller
        penalties, scipy's differential evolution. `regime_adjustments`
        (`RegimeDetector.classify()["calibration_adjustments"]`) tightens
        or widens the ξ/λ/ρ search bounds and scales the Tikhonov
        weights."""
        from scipy.optimize import differential_evolution as scipy_de

        from mcos_tpu_torch.ops.cos_pricer import cos_price

        strikes = np.asarray(strikes, np.float64)
        market_prices = np.asarray(market_prices, np.float64)
        cfg = self.config

        F = float(forward_price(spot, r, q, T))
        m1, m2 = _stage_masks(strikes, F, cfg)
        bas = np.asarray(bid_ask_spreads) if bid_ask_spreads is not None else None
        w1 = compute_vega_weights(
            spot, strikes[m1], T, r, q, atm_vol,
            bas[m1] if bas is not None else None).numpy()
        w2 = compute_vega_weights(
            spot, strikes[m2], T, r, q, atm_vol,
            bas[m2] if bas is not None else None).numpy()

        # Regime-conditioned search space and regularization strength.
        heston_bounds = HESTON_BOUNDS.tolist()
        jump_bounds = JUMP_BOUNDS.tolist()
        reg_scale = 1.0
        if regime_adjustments:
            adj = regime_adjustments
            if "xi_bounds" in adj:
                heston_bounds[2] = list(adj["xi_bounds"])
            if "rho_bounds" in adj:
                heston_bounds[3] = list(adj["rho_bounds"])
            if "lambda_bounds" in adj:
                jump_bounds[0] = list(adj["lambda_bounds"])
            reg_scale = float(adj.get("regularization_scale", 1.0))

        def obj1(x):
            kappa, theta, xi, rho, v0 = x
            params = SVJParams(kappa=kappa, theta=theta, xi=xi, rho=rho,
                               v0=v0, lambda_j=0.0, mu_j=0.0, sigma_j=0.01,
                               r=r, q=q)
            model = cos_price(params, spot, strikes[m1], T, is_call)
            err = float(np.sum(w1 * (model - market_prices[m1]) ** 2))
            reg = reg_scale * (REGULARIZATION["xi"] * xi**2
                               + REGULARIZATION["rho"] * rho**2)
            viol = xi * xi - 2.0 * kappa * theta
            return err + reg + (10.0 * viol * viol if viol > 0 else 0.0)

        res1 = scipy_de(obj1, heston_bounds,
                        maxiter=cfg.stage1_max_iter, tol=cfg.ftol, seed=seed,
                        polish=True)
        hx = res1.x
        logger.info("fast stage 1: κ=%.3f θ=%.4f ξ=%.3f ρ=%.3f v0=%.4f "
                    "err=%.6g", *hx, res1.fun)

        def obj2(xj):
            lam, mu_j, sig_j = xj
            params = SVJParams(kappa=hx[0], theta=hx[1], xi=hx[2], rho=hx[3],
                               v0=hx[4], lambda_j=lam, mu_j=mu_j,
                               sigma_j=sig_j, r=r, q=q)
            model = cos_price(params, spot, strikes[m2], T, is_call)
            err = float(np.sum(w2 * (model - market_prices[m2]) ** 2))
            return err + reg_scale * REGULARIZATION["lambda_j"] * lam**2

        res2 = scipy_de(obj2, jump_bounds,
                        maxiter=cfg.stage2_max_iter, tol=cfg.ftol, seed=seed,
                        polish=True)
        jx = res2.x
        logger.info("fast stage 2: λ=%.3f μ_J=%.4f σ_J=%.4f err=%.6g",
                    *jx, res2.fun)

        final = SVJParams(kappa=float(hx[0]), theta=float(hx[1]),
                          xi=float(hx[2]), rho=float(hx[3]), v0=float(hx[4]),
                          lambda_j=float(jx[0]), mu_j=float(jx[1]),
                          sigma_j=float(jx[2]), r=r, q=q)
        warnings = final.validate()
        self.history.append({
            "params": [float(v) for v in final.to_array()],
            "stage1_error": float(res1.fun),
            "stage2_error": float(res2.fun),
            "warnings": warnings,
        })
        try:
            uncertainty = self.parameter_uncertainty(
                final, spot, strikes, T, market_prices, is_call,
                bid_ask_spreads=bid_ask_spreads, atm_vol=atm_vol)
        except (np.linalg.LinAlgError, ValueError, FloatingPointError):
            uncertainty = None  # error bars are a diagnostic, never fatal
        return {
            "params": final,
            "stage1_result": {"error": float(res1.fun), "nit": int(res1.nit),
                              "success": bool(res1.success)},
            "stage2_result": {"error": float(res2.fun), "nit": int(res2.nit),
                              "success": bool(res2.success)},
            "warnings": warnings,
            "feller_satisfied": final.feller_satisfied,
            "uncertainty": uncertainty,
        }

    def calibrate_from_chain(
        self,
        chain,
        spot: float,
        T: float,
        is_call: bool = True,
        exercise: str = "european",
        r: float = 0.065,
        q: float = 0.012,
        seed: int = 42,
        regime_adjustments: Optional[Dict] = None,
        min_strikes: int = 4,
    ) -> Dict:
        """Option-chain quotes → SVJ parameters in one call.

        `chain` is a CSV path or the dict from
        `utils.chain_loader.load_chain`. Takes the liquid slice at expiry
        `T` on one side; exercise="american" de-Americanizes every quote
        through the CRR tree (`engine.surface.deamericanize_quotes`) and
        calibrates the European-equivalent prices, "european" calibrates
        the mids. The ATM implied vol seeds the vega weights; the fit is
        `calibrate_fast`.
        """
        from mcos_tpu_torch.engine.surface import (deamericanize_quotes,
                                                   implied_vol)
        from mcos_tpu_torch.utils.chain_loader import (
            chain_to_calibration_inputs,
            load_chain,
        )

        if exercise not in ("european", "american"):
            raise ValueError(f"exercise must be 'european' or 'american', "
                             f"got {exercise!r}")
        if isinstance(chain, str):
            chain = load_chain(chain)
        inputs = chain_to_calibration_inputs(
            chain, T, side="call" if is_call else "put")
        strikes = np.asarray(inputs["strikes"], np.float64)
        market = np.asarray(inputs["market_prices"], np.float64)
        spreads = np.asarray(inputs["bid_ask_spreads"], np.float64)
        if strikes.size < min_strikes:
            raise ValueError(f"only {strikes.size} liquid quotes at T={T} "
                             f"(need >= {min_strikes})")

        dropped = 0
        ivs = None
        if exercise == "american":
            ivs, market, keep = deamericanize_quotes(
                spot, strikes, T, market, r, q, is_call)
            dropped = int(strikes.size - keep.sum())
            strikes, spreads = strikes[keep], spreads[keep]
            if strikes.size < min_strikes:
                raise ValueError(
                    f"only {strikes.size} de-Americanizable quotes at T={T} "
                    f"({dropped} dropped; need >= {min_strikes})")

        atm_idx = int(np.argmin(np.abs(
            strikes - spot * np.exp((r - q) * T))))
        if ivs is not None:
            atm_vol = float(ivs[atm_idx])
        else:
            iv0 = implied_vol(float(market[atm_idx]), spot,
                              float(strikes[atm_idx]), T, r, q, is_call)
            atm_vol = float(iv0) if iv0 else 0.15

        result = self.calibrate_fast(
            spot, strikes, T, market, is_call=is_call, r=r, q=q,
            bid_ask_spreads=spreads, atm_vol=atm_vol, seed=seed,
            regime_adjustments=regime_adjustments)
        result["exercise"] = exercise
        result["n_quotes"] = int(strikes.size)
        result["n_dropped"] = dropped
        result["atm_vol_estimate"] = atm_vol
        if ivs is not None:
            result["deamericanized_ivs"] = [float(x) for x in ivs]
        return result

    _UNC_PARAM_NAMES = ("kappa", "theta", "xi", "rho", "v0",
                        "lambda_j", "mu_j", "sigma_j")

    def parameter_uncertainty(
        self,
        params: SVJParams,
        spot: float,
        strikes,
        T: float,
        market_prices,
        is_call: bool = True,
        bid_ask_spreads=None,
        atm_vol: float = 0.15,
    ) -> Dict:
        """Gauss-Newton parameter covariance at a calibrated optimum, host
        float64: cov(θ̂) = s² (Jᵀ W J)⁻¹ with s² = RSS_w / max(n − p, 1)
        and J the central finite differences of the exact COS/Bates oracle
        (16 chain evaluations). Returns per-parameter standard errors, the
        correlation matrix and identifiability diagnostics."""
        from mcos_tpu_torch.ops.cos_pricer import cos_price

        strikes = np.asarray(strikes, np.float64)
        market = np.asarray(market_prices, np.float64)
        r, q = float(params.r), float(params.q)
        bas = (np.asarray(bid_ask_spreads)
               if bid_ask_spreads is not None else None)
        w = compute_vega_weights(spot, strikes, T, r, q, atm_vol,
                                 bas).numpy().astype(np.float64)

        names = self._UNC_PARAM_NAMES
        x0 = np.array([float(getattr(params, n)) for n in names], np.float64)
        # Lower bumping floors where the CF parameterization degenerates
        # (ξ→0 divides by ξ²; variance levels must stay positive).
        lo = {"theta": 1e-6, "xi": 1e-3, "v0": 1e-6, "lambda_j": 0.0,
              "sigma_j": 1e-4, "kappa": 1e-4}
        hi = {"rho": 0.999}

        def model(x: np.ndarray) -> np.ndarray:
            p = SVJParams(**dict(zip(names, x)), r=r, q=q)
            return np.asarray(cos_price(p, spot, strikes, T, is_call),
                              np.float64)

        resid = model(x0) - market
        J = np.zeros((strikes.size, x0.size))
        for j, name in enumerate(names):
            h = max(1e-4, 1e-3 * abs(x0[j]))
            up = min(x0[j] + h, hi.get(name, np.inf))
            dn = max(x0[j] - h, lo.get(name, -np.inf))
            if up - dn < 1e-12:  # pinned at a degenerate point
                continue
            xu, xd = x0.copy(), x0.copy()
            xu[j], xd[j] = up, dn
            J[:, j] = (model(xu) - model(xd)) / (up - dn)

        n, p_dim = strikes.size, x0.size
        dof = max(n - p_dim, 1)
        s2 = float(np.sum(w * resid**2) / dof)
        A = J.T @ (w[:, None] * J)
        cov = s2 * np.linalg.pinv(A, rcond=1e-12)
        se = np.sqrt(np.maximum(np.diag(cov), 0.0))
        denom = np.outer(se, se)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.where(denom > 0, cov / np.where(denom > 0, denom, 1.0),
                            0.0)
        np.fill_diagonal(corr, 1.0)
        return {
            "param_names": list(names),
            "estimates": x0.tolist(),
            "std_errors": se.tolist(),
            "rel_errors_pct": [
                float(abs(s / v) * 100) if abs(v) > 1e-12 else None
                for s, v in zip(se, x0)],
            "correlation": [[float(c) for c in row] for row in corr],
            "residual_rms": float(np.sqrt(np.mean(resid**2))),
            "s2": s2,
            "dof": int(n - p_dim),
            "condition_number": float(np.linalg.cond(A)),
            "identifiable": bool(np.linalg.cond(A) < 1e12),
        }

    def calibrate_term_structure(
        self,
        spot: float,
        strikes,
        maturities,
        market_prices,
        is_call: bool = True,
        r: float = 0.065,
        q: float = 0.012,
        atm_vols=None,
        seed: int = 42,
    ) -> Dict:
        """Fit a full `TermStructureSVJ` across maturities on the host.

        Stage A: `calibrate_fast` on the longest maturity pins the shared
        parameters (κ, ρ, μ_J, σ_J, v0). Stage B: per maturity, fit
        (θ_T, ξ_T, λ_T) within TERM_STRUCTURE_BOUNDS against that expiry's
        chain (COS objective, no MC). Returns the TermStructureSVJ plus
        per-maturity errors.

        Args:
            market_prices: shape (num_maturities, num_strikes).
            atm_vols: per-maturity ATM vols for vega weights (default 0.15).
        """
        from scipy.optimize import differential_evolution as scipy_de

        from mcos_tpu_torch.config import TERM_STRUCTURE_BOUNDS
        from mcos_tpu_torch.models.params import TermStructureSVJ
        from mcos_tpu_torch.ops.cos_pricer import cos_price

        strikes = np.asarray(strikes, np.float64)
        maturities = np.asarray(maturities, np.float64)
        market_prices = np.asarray(market_prices, np.float64)
        if atm_vols is None:
            atm_vols = np.full(maturities.shape, 0.15)
        atm_vols = np.asarray(atm_vols, np.float64)

        # ── Stage A: shared params from the longest maturity ───────────────
        i_ref = int(np.argmax(maturities))
        base = self.calibrate_fast(
            spot, strikes, float(maturities[i_ref]),
            market_prices[i_ref], is_call=is_call, r=r, q=q,
            atm_vol=float(atm_vols[i_ref]), seed=seed)
        shared = base["params"]
        logger.info("term-structure stage A (T=%.3f): κ=%.3f ρ=%.3f "
                    "μ_J=%.4f σ_J=%.4f v0=%.4f", maturities[i_ref],
                    float(shared.kappa), float(shared.rho),
                    float(shared.mu_j), float(shared.sigma_j),
                    float(shared.v0))

        ts = TermStructureSVJ(
            kappa=float(shared.kappa), rho=float(shared.rho),
            mu_j=float(shared.mu_j), sigma_j=float(shared.sigma_j),
            v0=float(shared.v0), r=r, q=q)

        bounds = [list(TERM_STRUCTURE_BOUNDS["theta_T"]),
                  list(TERM_STRUCTURE_BOUNDS["xi_T"]),
                  list(TERM_STRUCTURE_BOUNDS["lambda_T"])]
        slice_errors = {}

        # ── Stage B: per-maturity (θ, ξ, λ) slices ─────────────────────────
        for i, T_i in enumerate(maturities):
            w = compute_vega_weights(
                spot, strikes, float(T_i), r, q, float(atm_vols[i])).numpy()
            market_i = market_prices[i]

            def obj(x, T_i=T_i, w=w, market_i=market_i):
                theta_t, xi_t, lam_t = x
                params = SVJParams(
                    kappa=float(shared.kappa), theta=theta_t, xi=xi_t,
                    rho=float(shared.rho), v0=float(shared.v0),
                    lambda_j=lam_t, mu_j=float(shared.mu_j),
                    sigma_j=float(shared.sigma_j), r=r, q=q)
                model = cos_price(params, spot, strikes, float(T_i), is_call)
                return float(np.sum(w * (model - market_i) ** 2))

            res = scipy_de(obj, bounds, maxiter=150, tol=1e-10,
                           seed=seed + i, polish=True)
            theta_t, xi_t, lam_t = res.x
            ts.theta_curve[float(T_i)] = float(theta_t)
            ts.xi_curve[float(T_i)] = float(xi_t)
            ts.lambda_curve[float(T_i)] = float(lam_t)
            slice_errors[float(T_i)] = float(res.fun)
            logger.info("term-structure slice T=%.3f: θ=%.4f ξ=%.3f λ=%.3f "
                        "err=%.6g", T_i, theta_t, xi_t, lam_t, res.fun)

        return {
            "term_structure": ts,
            "shared_params": shared,
            "slice_errors": slice_errors,
            "stage_a_result": base,
        }

    def get_history(self) -> List[Dict]:
        """Parameter-evolution log."""
        return self.history


# ─────────────────────────────────────────────────────────────────────────────
# Mesh-sharded training step (multi-device calibration)
# ─────────────────────────────────────────────────────────────────────────────
#: Adam's constants, optax.adam's defaults.
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def make_sharded_calibration_step(
    mesh,
    *,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    lr: float = 0.05,
    r: float = None,
    q: float = None,
    batch_axis: str = "batch",
    path_axis: str = "paths",
    shard_draws=None,
):
    """One optimizer step of Heston calibration over a 2-D mesh.

    Strikes are data-parallel over `batch_axis`: batch row b takes the
    b-th equal chunk of the chain. Each row prices its chunk with the
    paths sharded over `path_axis`: path shard j runs num_paths/n_paths
    paths of the Euler twin under autograd on the generator of
    `shard_seed(seed, j)` (the same paths on every row), or on
    `shard_draws(j)` (the twin's (z, u), tests), and the β = 1 companion
    payoff sums pool over the row (`pool_shards`). The weighted SSE of
    the rows is summed in row order, plus the ξ/ρ Tikhonov and the Feller
    penalty; its gradient with respect to the sigmoid-box parameters
    drives an Adam step (optax.adam(lr): bias-corrected, eps 1e-8).
    r and q default to the SVJParams defaults; pass the market's.

    Returns (step_fn, init_fn):
        init_fn(x0) -> (u, opt_state)
        step_fn(u, opt_state, spot, strikes, T, market, weights, seed)
            -> (u, opt_state, loss)
    with opt_state = (count, mu, nu) and every tensor on the mesh's first
    device."""
    from mcos_tpu_torch.ops import simulate
    from mcos_tpu_torch.parallel.mesh import (beta_one_payoffs, mesh_shards,
                                              pool_shards, shard_moments)
    from mcos_tpu_torch.utils.optim import from_box, to_box

    n_batch = mesh.shape[batch_axis]
    n_path = mesh.shape[path_axis]
    ppd = -(-int(num_paths) // n_path)
    home = mesh.devices[0]
    rate_kw = {k: float(v) for k, v in (("r", r), ("q", q)) if v is not None}
    b_stride = int(np.prod(mesh.dims[mesh.axis_names.index(batch_axis)
                                     + 1:]))
    p_stride = int(np.prod(mesh.dims[mesh.axis_names.index(path_axis)
                                     + 1:]))

    def device_of(b: int, j: int) -> torch.device:
        return mesh.devices[b * b_stride + j * p_stride]

    def loss_fn(u, spot, strikes, T, market, weights, seed):
        x = to_box(u, HESTON_BOUNDS)
        kappa, theta, xi, rho, v0 = x
        strikes, market, weights = (torch.as_tensor(
            np.asarray(a, np.float32), device=home).reshape(n_batch, -1)
            for a in (strikes, market, weights))
        shards = mesh_shards(mesh, seed, axis_name=path_axis,
                             backend="torch", shard_draws=shard_draws)
        draws = {s.index: simulate._euler_draws(
            s.draws, None if s.draws is not None else s.generator(), ppd,
            num_steps, s.device) for s in shards}
        sse = []
        for b in range(n_batch):
            parts = []
            for j in range(n_path):
                dev = device_of(b, j)
                p = SVJParams(kappa=kappa.to(dev), theta=theta.to(dev),
                              xi=xi.to(dev), rho=rho.to(dev), v0=v0.to(dev),
                              lambda_j=0.0, mu_j=0.0, sigma_j=0.01,
                              **rate_kw)
                z, w = draws[j]
                s_f, v_f, g_f = simulate.simulate_terminal(
                    p, spot, T, None, ppd, num_steps, antithetic=True,
                    companion=True, draws=(z.to(dev), w.to(dev)),
                    device=dev)
                parts.append(shard_moments(beta_one_payoffs(
                    p, spot, strikes[b].to(dev), T, s_f, v_f, g_f,
                    is_call=is_call, control_variate=True)))
            stats = pool_shards(parts)
            dev = stats["n"].device
            discount = torch.exp(-torch.tensor(
                float(rate_kw.get("r", SVJParams.r)), device=dev)
                * float(np.float32(T)))
            model = discount * stats["sum"] / stats["n"]
            sse.append(torch.sum(weights[b].to(dev)
                                 * (model - market[b].to(dev)) ** 2))
        total = sse[0].to(home)
        for part in sse[1:]:
            total = total + part.to(home)
        reg = REGULARIZATION["xi"] * xi**2 + REGULARIZATION["rho"] * rho**2
        return total + reg + _feller_penalty(kappa, theta, xi)

    def step_fn(u, opt_state, spot, strikes, T, market, weights, seed):
        count, mu, nu = opt_state
        u_req = u.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(u_req, spot, strikes, T, market, weights, seed)
            (grad,) = torch.autograd.grad(loss, u_req)
        count = count + 1
        # optax's order of operations: moments, bias correction, then
        # u + (−lr)·m̂/(√v̂ + eps).
        mu = (1.0 - _ADAM_B1) * grad + _ADAM_B1 * mu
        nu = (1.0 - _ADAM_B2) * (grad * grad) + _ADAM_B2 * nu
        mu_hat = mu / float(np.float32(1.0 - _ADAM_B1 ** count))
        nu_hat = nu / float(np.float32(1.0 - _ADAM_B2 ** count))
        u = u.detach() + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS))
        return u, (count, mu, nu), loss.detach()

    def init_fn(x0):
        u0 = from_box(torch.as_tensor(np.asarray(x0, np.float32)),
                      HESTON_BOUNDS).to(home)
        return u0, (0, torch.zeros_like(u0), torch.zeros_like(u0))

    return step_fn, init_fn
