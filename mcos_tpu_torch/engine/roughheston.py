"""Rough Heston engine: lifted-MC pricing and the fractional-Riccati oracle
(counterpart of `mcos_tpu/engine/roughheston.py`).

The port's engine shape: a functional core on device tensors, a thin
stateful wrapper with the JAX package's result keys, and the COS oracle
(`ops/roughheston.py:rough_heston_cos_price`, host complex128) as the
exactness anchor for smiles, the skew term structure, calibration and the
MC cross-check.

- The lifted kernel's node set is keyed to a resolution time scale
  (T / KERNEL_RES_STEPS), not to the simulation dt, so refining steps
  converges to one fixed Markovian model.
- Steps oversample that resolution (8 192 a year by default, at least
  512, rounded up to a multiple of 64).
- Every Monte Carlo figure runs the torch step loop of
  `ops/roughheston.py:lifted_terminal`: no kernel of `csrc/` is on this
  path. A price, a delta and the six-member finite differences of one
  engine all run on the same normals (one seeded generator each).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import scaled_steps
from mcos_tpu_torch.engine.pricer import (_companion_pairs, resolve_mesh,
                                          seeded_generator, to_host)
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.roughheston import (
    RoughHestonParams,
    lifted_kernel_error,
    lifted_kernel_nodes,
    lifted_terminal,
    rough_heston_cos_price,
)
from mcos_tpu_torch.ops.simulate import _f32

KERNEL_RES_STEPS = 256          # lifted-kernel resolution: T / 256


def _nodes(params: RoughHestonParams, T: float, n_factors: int):
    """(c, x) of the lifted kernel at the resolution T / KERNEL_RES_STEPS."""
    return lifted_kernel_nodes(float(params.hurst), float(T),
                               float(T) / KERNEL_RES_STEPS, n_factors)


def _rh_price_core(params: RoughHestonParams, spot, strikes, T,
                   generator: torch.Generator, c_weights, x_nodes, *,
                   num_paths: int, num_steps: int, is_call: bool,
                   draws: Optional[torch.Tensor] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Antithetic + companion-CV lifted rough-Heston pricing over strikes.

    The companion GBM leg rides the same dW1 (beta = 1 control, its
    expectation BS(sqrt(v0))); antithetic pairs are collapsed before the
    moments; float32 moments on the device.
    """
    device = torch.device(device)
    strikes = torch.atleast_1d(torch.as_tensor(strikes, dtype=torch.float32,
                                               device=device))
    s_final, v_final, g_final = lifted_terminal(
        params, spot, T, generator, c_weights, x_nodes,
        num_paths=num_paths, num_steps=num_steps, antithetic=True,
        companion=True, draws=draws, device=device)
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


def _rh_mc_price(params: RoughHestonParams, s0, strike, T,
                 generator: torch.Generator, c_weights, x_nodes, *,
                 num_paths: int, num_steps: int, is_call: bool,
                 remat_chunk: int = 0, draws: Optional[torch.Tensor] = None,
                 device="cuda") -> torch.Tensor:
    """The CV-adjusted price (shared by the delta and FD cores): 0-d, or
    (M,) for parameters with a member axis."""
    device = torch.device(device)
    s_final, _, g_final = lifted_terminal(
        params, s0, T, generator, c_weights, x_nodes, num_paths=num_paths,
        num_steps=num_steps, antithetic=True, companion=True,
        remat_chunk=remat_chunk, draws=draws, device=device)
    discount = torch.exp(-params.r * _f32(T, device))
    sign = 1.0 if is_call else -1.0
    pay = torch.clamp(sign * (s_final - strike), min=0.0)
    g_pay = torch.clamp(sign * (g_final - strike), min=0.0)
    bs_ref = bs_price(s0, strike, T, params.r, params.q,
                      torch.sqrt(_f32(params.v0, device)), is_call,
                      device=device)
    return discount * torch.mean(pay - g_pay, dim=(-2, -1)) + bs_ref


def _rh_delta_core(params: RoughHestonParams, spot, strike, T,
                   generator: torch.Generator, c_weights, x_nodes, *,
                   num_paths: int, num_steps: int, is_call: bool,
                   draws: Optional[torch.Tensor] = None, device="cuda"):
    """Pathwise AD delta: (price, dP/dS0), 0-d tensors.

    The spot is the only leaf that requires grad, and it enters only after
    the factor loop (S_T = S0·exp(log S), and the companion's BS price),
    so the loop records no graph: one forward pass, no checkpoints, a
    price's peak memory. The variance-parameter sensitivities go through
    `_rh_fd_sens` (their pathwise chains are heavy-tailed where v pins
    near 0).
    """
    s0 = torch.tensor(float(spot), dtype=torch.float32,
                      device=torch.device(device), requires_grad=True)
    price = _rh_mc_price(params, s0, strike, T, generator, c_weights,
                         x_nodes, num_paths=num_paths, num_steps=num_steps,
                         is_call=is_call, draws=draws, device=device)
    (d_s,) = torch.autograd.grad(price, (s0,))
    return price.detach(), d_s


def _rh_fd_sens(params: RoughHestonParams, spot, strike, T,
                generator: torch.Generator, c_weights, x_nodes, *,
                num_paths: int, num_steps: int, is_call: bool,
                draws: Optional[torch.Tensor] = None, device="cuda"):
    """(dP/dv0, dP/dnu, dP/drho) by CRN central differences: the six
    bumped members (v0 ± 5 %, nu ± 0.02, rho ± 0.02 clipped to ±0.999) as
    one member axis through one step loop on one set of normals, forward
    only. The rho difference divides by the clipped rhos."""
    device = torch.device(device)
    v0 = _f32(params.v0, device)
    nu = _f32(params.nu, device)
    rho = _f32(params.rho, device)
    h_v0 = 0.05 * v0
    h_nu = _f32(0.02, device)
    h_rho = _f32(0.02, device)
    v0s = torch.stack([v0 + h_v0, v0 - h_v0, v0, v0, v0, v0])
    nus = torch.stack([nu, nu, nu + h_nu, nu - h_nu, nu, nu])
    rhos = torch.stack([rho, rho, rho, rho,
                        torch.clamp(rho + h_rho, max=0.999),
                        torch.clamp(rho - h_rho, min=-0.999)])
    with torch.no_grad():
        prices = _rh_mc_price(
            params.replace(v0=v0s, nu=nus, rho=rhos), spot, strike, T,
            generator, c_weights, x_nodes, num_paths=num_paths,
            num_steps=num_steps, is_call=is_call, draws=draws,
            device=device)
    d_v0 = (prices[0] - prices[1]) / (2.0 * h_v0)
    d_nu = (prices[2] - prices[3]) / (2.0 * h_nu)
    d_rho = (prices[4] - prices[5]) / (rhos[4] - rhos[5])
    return d_v0, d_nu, d_rho


class RoughHestonEngine:
    """Stateful wrapper over the lifted-MC cores and the COS oracle on
    `device`.

    `num_steps` is per year (scaled by maturity like every other engine);
    the default 8192 a year oversamples the T/256 kernel resolution 8x.
    mesh: None | "auto" | a `parallel.mesh.Mesh` (`resolve_mesh`); a
    resolved mesh shards `price`
    (`parallel/families.py:sharded_roughheston_price`).
    """

    def __init__(self, params: RoughHestonParams,
                 num_paths: int = 200_000, num_steps: int = 8192,
                 n_factors: int = 24, seed: int = 42, mesh=None, *,
                 device="cuda"):
        self.mesh = mesh
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.n_factors = int(n_factors)
        self.seed = int(seed)
        self.device = torch.device(device)

    def _steps(self, T: float) -> int:
        n = max(scaled_steps(self.num_steps, T), 2 * KERNEL_RES_STEPS)
        return ((n + 63) // 64) * 64     # remat-chunk aligned (greeks)

    def _draws(self, steps: int) -> Optional[torch.Tensor]:
        """Replayed (steps, 2, paths) normals, or None: the step loop
        draws one step at a time from the seeded generator. Tests
        override it."""
        return None

    def _kw(self, T: float, is_call: bool) -> dict:
        steps = self._steps(T)
        return {"num_paths": self.num_paths, "num_steps": steps,
                "is_call": is_call, "draws": self._draws(steps),
                "device": self.device}

    def kernel_fit_error(self, T: float) -> float:
        return lifted_kernel_error(float(self.params.hurst), float(T),
                                   float(T) / KERNEL_RES_STEPS,
                                   self.n_factors)

    def _price_host(self, spot: float, strikes, T: float,
                    is_call: bool) -> Dict[str, np.ndarray]:
        c, x = _nodes(self.params, T, self.n_factors)
        return to_host(_rh_price_core(
            self.params, spot, strikes, T,
            seeded_generator(self.seed, self.device), c, x,
            **self._kw(T, is_call)))

    def price(self, spot: float, strike, T: float,
              is_call: bool = True) -> Dict:
        strikes = np.atleast_1d(np.asarray(strike, np.float32))
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu_torch.parallel.families import (
                sharded_roughheston_price,
            )

            res = sharded_roughheston_price(
                self.params, spot, strikes, T, self.seed, mesh=mesh,
                num_paths=self.num_paths, num_steps=self._steps(T),
                n_factors=self.n_factors, is_call=is_call)
            device = res["price"].device
            res["bs_ref"] = bs_price(
                spot, torch.as_tensor(strikes, device=device), T,
                self.params.r, self.params.q,
                torch.sqrt(_f32(self.params.v0, device)), is_call,
                device=device)
            res = to_host(res)
        else:
            res = self._price_host(spot, strikes, T, is_call)
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "bs_ref": float(res["bs_ref"][0]),
            "num_paths_used": self.num_paths,
            "num_steps": self._steps(T),
            "n_factors": len(_nodes(self.params, T, self.n_factors)[0]),
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
        """Semi-analytic oracle (exact up to COS + Adams truncation)."""
        return rough_heston_cos_price(self.params, spot, strikes, T,
                                      is_call)

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict:
        """AD delta (the stable pathwise chain) and CRN-FD
        variance-parameter sensitivities, on the same normals."""
        c, x = _nodes(self.params, T, self.n_factors)
        kw = self._kw(T, is_call)
        price, d_s = _rh_delta_core(
            self.params, spot, strike, T,
            seeded_generator(self.seed, self.device), c, x, **kw)
        sens = _rh_fd_sens(
            self.params, spot, strike, T,
            seeded_generator(self.seed, self.device), c, x, **kw)
        host = to_host({"price": price, "delta": d_s,
                        **dict(zip(("d_v0", "d_nu", "d_rho"), sens))})
        sigma0 = float(np.sqrt(float(self.params.v0)))
        d_v0 = float(host["d_v0"])
        return {
            "price": float(host["price"]),
            "delta": float(host["delta"]),
            # Vega per unit vol = dP/dsigma0 = 2 sigma0 dP/dv0.
            "vega": 2.0 * sigma0 * d_v0,
            "dP_dv0": d_v0,
            "dP_dnu": float(host["d_nu"]),
            "dP_drho": float(host["d_rho"]),
        }

    def smile(self, spot: float, T: float,
              strikes: Sequence[float]) -> Dict:
        """Exact COS-implied vols across strikes (no MC noise)."""
        from mcos_tpu_torch.engine.surface import implied_vol

        strikes = np.asarray(strikes, np.float64)
        prices = self.cos_price(spot, strikes, T, True)
        ivs = [implied_vol(float(cv), spot, float(k), T,
                           float(self.params.r), float(self.params.q),
                           True)
               for cv, k in zip(prices, strikes)]
        return {
            "strikes": strikes.tolist(),
            "prices": [float(cv) for cv in prices],
            "iv": [None if v is None else float(v) for v in ivs],
        }

    def atm_skew_term_structure(self, spot: float,
                                maturities: Sequence[float]) -> Dict:
        """d(IV)/d(ln K) at the money per maturity, from exact COS prices
        by a central difference in ln K: |skew| ~ T^(H - 1/2) as T -> 0."""
        from mcos_tpu_torch.engine.surface import implied_vol

        rows = []
        for T in maturities:
            bump = 0.02
            ks = spot * np.exp(np.array([-bump, bump]))
            prices = self.cos_price(spot, ks, float(T), True)
            ivs = [implied_vol(float(cv), spot, float(k), float(T),
                               float(self.params.r), float(self.params.q),
                               True)
                   for cv, k in zip(prices, ks)]
            if None in ivs:
                continue
            rows.append({"T": float(T),
                         "atm_skew": (ivs[1] - ivs[0]) / (2.0 * bump)})
        return {"rows": rows, "hurst": float(self.params.hurst)}

    def mc_vs_cos(self, spot: float, strikes, T: float,
                  is_call: bool = True) -> Dict:
        """MC-vs-oracle rows (the `/api/roughheston` compare mode);
        `err_sigmas` does not include the O(dt) scheme bias."""
        strikes = np.atleast_1d(np.asarray(strikes, np.float64))
        exact = self.cos_price(spot, strikes, T, is_call)
        res = self._price_host(spot, strikes.astype(np.float32), T,
                               is_call)
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
        return {"rows": rows, "kernel_fit_error": self.kernel_fit_error(T),
                "num_steps": self._steps(T)}


def calibrate_rough_heston(spot: float, strikes, T: float, market_prices,
                           r: Optional[float] = None,
                           q: Optional[float] = None,
                           is_call: bool = True,
                           hurst: Optional[float] = None,
                           hurst_grid: Sequence[float] = (0.05, 0.1, 0.2,
                                                          0.35),
                           fit_lam_theta: bool = False,
                           n_starts: int = 2, seed: int = 0,
                           n_terms: int = 192,
                           n_adams: int = 128) -> Dict:
    """Fit rough Heston to a single-maturity smile on the COS objective
    (host float64, the JAX package's code).

    H is a grid axis (or a fixed input); the smooth parameters (nu, rho,
    v0[, lam, theta]) go to a multi-start trust-region least squares per
    H. The oracle is exact, so the objective has no MC noise. Reduced COS
    settings (n_terms/n_adams) keep one objective evaluation cheap.
    """
    from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
    from scipy.optimize import least_squares

    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    h_values = [float(hurst)] if hurst is not None else list(hurst_grid)

    if fit_lam_theta:
        lo = np.array([0.05, -0.99, 1e-4, 0.1, 1e-3])
        hi = np.array([2.50, 0.50, 1.00, 8.0, 1.00])
        base = np.array([0.35, -0.6, 0.04, 1.5, 0.04])
    else:
        lo = np.array([0.05, -0.99, 1e-4])
        hi = np.array([2.50, 0.50, 1.00])
        base = np.array([0.35, -0.6, 0.04])

    def make_params(x, h):
        if fit_lam_theta:
            nu, rho, v0, lam, theta = x
        else:
            nu, rho, v0 = x
            lam, theta = 1.5, float(v0)
        return RoughHestonParams(lam=float(lam), theta=float(theta),
                                 nu=float(nu), rho=float(rho),
                                 v0=float(v0), r=r, q=q, hurst=h)

    rng = np.random.default_rng(seed)
    best, best_h = None, None
    for h in h_values:
        def resid(x, _h=h):
            p = make_params(x, _h)
            try:
                model = rough_heston_cos_price(
                    p, spot, strikes, T, is_call,
                    n_terms=n_terms, n_steps=n_adams)
            except FloatingPointError:
                return np.full(market.shape, 1e3)
            return model - market

        starts = [base] + [lo + rng.random(lo.shape) * (hi - lo)
                           for _ in range(n_starts - 1)]
        for x0 in starts:
            try:
                res = least_squares(resid, x0, bounds=(lo, hi), xtol=1e-10)
            except Exception:  # noqa: BLE001 — a bad start must not kill it
                continue
            if best is None or res.cost < best.cost:
                best, best_h = res, h

    if best is None:
        raise RuntimeError("rough-Heston calibration failed on every start")
    params = make_params(best.x, best_h)
    rmse = float(np.sqrt(2.0 * best.cost / max(market.size, 1)))
    return {
        "params": params,
        "hurst": float(best_h),
        "nu": float(params.nu), "rho": float(params.rho),
        "v0": float(params.v0), "lam": float(params.lam),
        "theta": float(params.theta),
        "rmse_price": rmse, "n_quotes": int(market.size),
    }
