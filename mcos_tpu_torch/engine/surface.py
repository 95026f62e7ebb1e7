"""Volatility surface engine of the port (counterpart of
`mcos_tpu/engine/surface.py`): implied vol, SABR, arbitrage-checked
splines.

- Host float64, copied from the JAX package (tests/test_torch_copies.py
  and tests/test_torch_surface.py hold them equal): `implied_vol_grid` /
  `implied_vol` (vectorized bisection + Newton), `NaturalCubicSpline`,
  `ArbitrageFreeSpline`, and the American inversion
  (`implied_vol_american`, `deamericanize_quotes`: scipy's Brent through
  the CRR tree `engine/american.py:binomial_american_bs`).
- `sabr_vol` is torch ops (float32, broadcasting), and `calibrate_sabr`
  runs the port's differential evolution on a (P, D) → (P,) objective on
  `device`, with an explicit seeded generator.

Behavioural parity with the JAX package: non-bracketed quotes give NaN /
None; quotes with a bid-ask spread above 10 % of mid are dropped; Hagan
SABR with the z/x(z) series guard; spline checks of butterfly convexity,
calendar monotonicity of σ²T and the Dupire denominator's sign.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from mcos_tpu_torch.config import SABR_BOUNDS
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.utils.optim import differential_evolution

# Re-exported closed forms.
bs_call_price = partial(bs_price, is_call=True)
bs_put_price = partial(bs_price, is_call=False)


def _bs_price_np(S, K, T, r, q, sigma, is_call: bool):
    """Vectorized f64 Black-Scholes on the host (numpy/scipy)."""
    from scipy.special import ndtr as ndtr_np

    sqrt_t = np.sqrt(np.maximum(T, 1e-300))
    denom = np.maximum(sigma * sqrt_t, 1e-300)
    d1 = (np.log(S / K) + (r - q + 0.5 * sigma**2) * T) / denom
    d2 = d1 - sigma * sqrt_t
    df_r, df_q = np.exp(-r * T), np.exp(-q * T)
    if is_call:
        return S * df_q * ndtr_np(d1) - K * df_r * ndtr_np(d2)
    return K * df_r * ndtr_np(-d2) - S * df_q * ndtr_np(-d1)


def implied_vol_grid(price, S, K, T, r, q, is_call: bool = True,
                     lo: float = 0.001, hi: float = 5.0,
                     bisect_iters: int = 60, newton_iters: int = 3):
    """Implied vols for a whole broadcast grid in one vectorized f64 solve.

    Runs on the host in numpy float64, deliberately: deep-ITM quotes carry
    their information in a tiny extrinsic value on top of a large intrinsic
    one, which float32 cancellation destroys, and IV grids are ≤ O(10³)
    points. 60 bisection halvings + a Newton polish reach ~1e-12;
    non-bracketed inputs (arbitrage-violating or stale quotes) come back
    NaN.
    """
    price, S, K, T, r, q = np.broadcast_arrays(
        *[np.asarray(a, np.float64) for a in (price, S, K, T, r, q)])
    shape = price.shape

    def f(sigma):
        return _bs_price_np(S, K, T, r, q, sigma, is_call) - price

    lo_a = np.full(shape, lo)
    hi_a = np.full(shape, hi)
    bracketed = f(lo_a) * f(hi_a) <= 0

    f_lo_sign = np.sign(f(lo_a))
    for _ in range(bisect_iters):
        mid = 0.5 * (lo_a + hi_a)
        go_left = np.sign(f(mid)) == f_lo_sign
        lo_a = np.where(go_left, mid, lo_a)
        hi_a = np.where(go_left, hi_a, mid)
    sigma = 0.5 * (lo_a + hi_a)

    from scipy.stats import norm as _norm

    for _ in range(newton_iters):
        d1 = (np.log(S / K) + (r - q + 0.5 * sigma**2) * T) / np.maximum(
            sigma * np.sqrt(T), 1e-300)
        vega = np.maximum(
            S * np.exp(-q * T) * np.sqrt(T) * _norm.pdf(d1), 1e-12)
        sigma = np.clip(sigma - f(sigma) / vega, lo, hi)

    return np.where(bracketed, sigma, np.nan)


def implied_vol(price: float, S: float, K: float, T: float,
                r: float, q: float, is_call: bool = True,
                lo: float = 0.001, hi: float = 5.0) -> Optional[float]:
    """Scalar wrapper: None when no vol in [lo, hi] brackets the price."""
    iv = float(implied_vol_grid(price, S, K, T, r, q, is_call, lo=lo, hi=hi))
    return None if np.isnan(iv) else iv


def implied_vol_american(price: float, S: float, K: float, T: float,
                         r: float, q: float, is_call: bool = True,
                         lo: float = 0.001, hi: float = 5.0,
                         steps: int = 256) -> Optional[float]:
    """De-Americanization: invert a CRR American price to a BS vol (host
    float64 Brent on σ through `binomial_american_bs`), None where the
    price is outside the attainable bracket or the tree is unstable."""
    from scipy.optimize import brentq

    from mcos_tpu_torch.engine.american import binomial_american_bs

    if price <= 0 or T <= 0:
        return None

    # CRR stability needs 0 < p < 1 ⇔ σ√dt > |r−q|·dt — lift the lower
    # bracket to the stable region (σ below it is indistinguishable from
    # zero vol at these quote precisions anyway).
    lo = max(lo, 1.05 * abs(r - q) * np.sqrt(T / steps) + 1e-9)

    def f(sigma: float) -> float:
        return binomial_american_bs(S, K, T, r, q, sigma, steps=steps,
                                    is_call=is_call) - price

    try:
        f_lo, f_hi = f(lo), f(hi)
    except ValueError:  # unstable tree at extreme (σ, dt)
        return None
    if f_lo * f_hi > 0:
        return None  # price outside the attainable bracket
    try:
        return float(brentq(f, lo, hi, xtol=1e-7, maxiter=100))
    except (ValueError, RuntimeError):
        return None


def deamericanize_quotes(spot: float, strikes, T: float, prices,
                         r: float, q: float, is_call: bool = True,
                         steps: int = 256):
    """American quotes → European-equivalent BS prices, one expiry slice.

    Each quote inverts through the CRR tree (`implied_vol_american`) and
    reprices as a float32 European Black-Scholes price at that vol. Quotes
    at (or within a basis point of spot of) intrinsic value, or whose
    inversion fails, are dropped via the returned mask: a deep-ITM
    American option trades at intrinsic over a whole σ-interval, so its
    "implied vol" is noise.

    Returns (ivs, european_prices, keep) as float64/bool arrays aligned to
    the kept subset order of `strikes`.
    """
    strikes = np.asarray(strikes, np.float64)
    prices = np.asarray(prices, np.float64)
    ivs, eur, keep = [], [], np.zeros(strikes.shape, bool)
    for i, (K, pmid) in enumerate(zip(strikes, prices)):
        intrinsic = max(spot - K, 0.0) if is_call else max(K - spot, 0.0)
        if pmid - intrinsic <= 1e-4 * spot:
            continue  # vol-dead quote
        iv = implied_vol_american(float(pmid), spot, float(K), float(T),
                                  r, q, is_call, steps=steps)
        if iv is None:
            continue
        keep[i] = True
        ivs.append(iv)
        eur.append(float(bs_price(spot, K, T, r, q, iv, is_call)))
    return (np.asarray(ivs, np.float64), np.asarray(eur, np.float64), keep)


def extract_iv_surface(
    spot: float,
    r: float,
    q: float,
    strikes: np.ndarray,
    maturities: np.ndarray,
    call_prices: np.ndarray,
    put_prices: np.ndarray,
    bid_ask_spreads: Optional[np.ndarray] = None,
    max_spread_pct: float = 0.10,
    exercise: str = "european",
) -> Dict:
    """Full-chain IV extraction with liquidity filtering, one vectorized
    solve per side (host float64). exercise="american" de-Americanizes
    instead: each quote inverts through the CRR tree via
    `implied_vol_american`, scalar Brent per cell."""
    strikes = np.asarray(strikes, np.float32)
    maturities = np.asarray(maturities, np.float32)
    T_grid = maturities[:, None]  # (n_mat, 1) broadcasts against (n_k,)

    if exercise == "american":
        def grid(prices, is_call):
            prices = np.asarray(prices, np.float64)
            out = np.full(prices.shape, np.nan)
            for i, T in enumerate(maturities):
                for j, K in enumerate(strikes):
                    iv = implied_vol_american(
                        float(prices[i, j]), spot, float(K), float(T),
                        r, q, is_call)
                    if iv is not None:
                        out[i, j] = iv
            return out

        iv_call = grid(call_prices, True)
        iv_put = grid(put_prices, False)
    elif exercise == "european":
        iv_call = np.asarray(implied_vol_grid(
            call_prices, spot, strikes[None, :], T_grid, r, q, True))
        iv_put = np.asarray(implied_vol_grid(
            put_prices, spot, strikes[None, :], T_grid, r, q, False))
    else:
        raise ValueError(f"unknown exercise style: {exercise!r}")

    valid = np.isfinite(iv_call) & np.isfinite(iv_put)
    if bid_ask_spreads is not None:
        mid = 0.5 * (np.asarray(call_prices) + np.asarray(put_prices))
        liquid = ~((mid > 0) & (np.asarray(bid_ask_spreads) / np.maximum(mid, 1e-12)
                                > max_spread_pct))
        valid &= liquid
        iv_call = np.where(liquid, iv_call, np.nan)
        iv_put = np.where(liquid, iv_put, np.nan)

    return {
        "iv_call": iv_call,
        "iv_put": iv_put,
        "valid_mask": valid,
        "strikes": strikes,
        "maturities": maturities,
    }


# ─────────────────────────────────────────────────────────────────────────────
# SABR (Hagan 2002), vectorized + differentiable
# ─────────────────────────────────────────────────────────────────────────────
def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def sabr_vol(F, K, T, alpha, beta, rho, nu):
    """Hagan lognormal SABR vol in float32; broadcasts over its tensor
    arguments (a DE population as (P, 1) parameters against (K,) strikes)
    on the first tensor argument's device, else the CPU.

    The z/x(z) → 1 limit uses the series 1 − ρz/2 + (2 − 3ρ²)z²/12 for
    |z| < 1e-3, where the exact quotient cancels in float32 near ATM; the
    series error at the knee is O(z³) ≈ 1e-9.
    """
    device = next((a.device for a in (F, K, T, alpha, beta, rho, nu)
                   if isinstance(a, torch.Tensor)), "cpu")
    F, K, T, alpha, beta, rho, nu = (_f32(a, device) for a in
                                     (F, K, T, alpha, beta, rho, nu))
    one_m_beta = 1.0 - beta
    log_fk = torch.log(F / K)
    fk_pow = (F * K) ** (0.5 * one_m_beta)

    z = (nu / alpha) * fk_pow * log_fk
    sqrt_term = torch.sqrt(1.0 - 2.0 * rho * z + z * z)
    x_z = torch.log((sqrt_term + z - rho) / (1.0 - rho))
    small = torch.abs(z) < 1e-3
    z_safe = torch.where(small, torch.ones_like(z), z)
    x_safe = torch.where(small, torch.ones_like(x_z), x_z)
    series = 1.0 - 0.5 * rho * z + (2.0 - 3.0 * rho * rho) / 12.0 * z * z
    z_over_x = torch.where(small, series, z_safe / x_safe)

    denom = fk_pow * (1.0 + one_m_beta**2 / 24.0 * log_fk**2
                      + one_m_beta**4 / 1920.0 * log_fk**4)
    correction = 1.0 + T * (
        one_m_beta**2 / 24.0 * alpha**2 / (F * K) ** one_m_beta
        + 0.25 * rho * beta * nu * alpha / fk_pow
        + (2.0 - 3.0 * rho**2) / 24.0 * nu**2
    )
    return (alpha / denom) * z_over_x * correction


def calibrate_sabr(
    F: float,
    strikes: np.ndarray,
    T: float,
    market_ivs: np.ndarray,
    vegas: Optional[np.ndarray] = None,
    beta_fixed: Optional[float] = None,
    seed: int = 0,
    pop_size: int = 32,
    iters: int = 120,
    device="cuda",
) -> Dict[str, float]:
    """Vega-weighted SABR fit by differential evolution on `device`, the
    whole population in one objective call a generation. β free in
    [0.5, 1.0] unless `beta_fixed`; the objective is the weighted squared
    IV error. The generator is `seeded_generator(seed, device)`."""
    device = torch.device(device)
    strikes = _f32(np.asarray(strikes, np.float32), device)
    market_ivs = _f32(np.asarray(market_ivs, np.float32), device)
    if vegas is None:
        weights = torch.full_like(market_ivs, 1.0 / market_ivs.shape[0])
    else:
        vegas = _f32(np.asarray(vegas, np.float32), device)
        weights = vegas / torch.sum(vegas)
    data = {"F": _f32(F, device), "strikes": strikes, "T": _f32(T, device),
            "market_ivs": market_ivs, "weights": weights,
            "beta_fixed": _f32(beta_fixed if beta_fixed is not None
                               else 0.0, device)}
    gen = seeded_generator(seed, device)
    if beta_fixed is not None:
        bounds = np.array([SABR_BOUNDS["alpha"], SABR_BOUNDS["rho"],
                           SABR_BOUNDS["nu"]], np.float32)
        res = differential_evolution(
            lambda x: _sabr_objective_fixed_beta(x, data), bounds, gen,
            pop_size=pop_size, iters=iters)
        x, fun = res.x.cpu().numpy(), float(res.fun)
        return {"alpha": float(x[0]), "beta": float(beta_fixed),
                "rho": float(x[1]), "nu": float(x[2]), "error": fun}

    bounds = np.array([SABR_BOUNDS["alpha"], SABR_BOUNDS["beta"],
                       SABR_BOUNDS["rho"], SABR_BOUNDS["nu"]], np.float32)
    res = differential_evolution(
        lambda x: _sabr_objective_free_beta(x, data), bounds, gen,
        pop_size=pop_size, iters=iters)
    x, fun = res.x.cpu().numpy(), float(res.fun)
    return {"alpha": float(x[0]), "beta": float(x[1]), "rho": float(x[2]),
            "nu": float(x[3]), "error": fun}


def _sabr_sse(model: torch.Tensor, data) -> torch.Tensor:
    return torch.sum(data["weights"] * (model - data["market_ivs"]) ** 2,
                     dim=-1)


def _sabr_objective_fixed_beta(x: torch.Tensor, data) -> torch.Tensor:
    """(P, 3) [α, ρ, ν] → (P,) weighted squared IV errors at β fixed."""
    model = sabr_vol(data["F"], data["strikes"], data["T"], x[:, 0:1],
                     data["beta_fixed"], x[:, 1:2], x[:, 2:3])
    return _sabr_sse(model, data)


def _sabr_objective_free_beta(x: torch.Tensor, data) -> torch.Tensor:
    """(P, 4) [α, β, ρ, ν] → (P,) weighted squared IV errors."""
    model = sabr_vol(data["F"], data["strikes"], data["T"], x[:, 0:1],
                     x[:, 1:2], x[:, 2:3], x[:, 3:4])
    return _sabr_sse(model, data)


# ─────────────────────────────────────────────────────────────────────────────
# Natural cubic spline (self-contained; no scipy) + arbitrage checks
# ─────────────────────────────────────────────────────────────────────────────
class NaturalCubicSpline:
    """Natural cubic spline y(x) with analytic first/second derivatives.

    Small host-side linear algebra (≤O(50) IV knots per maturity) — building
    it on-device would waste a kernel launch; evaluation is vectorized numpy.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if x.ndim != 1 or x.size < 3 or np.any(np.diff(x) <= 0):
            raise ValueError("need ≥3 strictly increasing knots")
        n = x.size
        h = np.diff(x)
        # Tridiagonal system for interior second derivatives (natural BCs).
        a = np.zeros((n, n))
        rhs = np.zeros(n)
        a[0, 0] = a[-1, -1] = 1.0
        for i in range(1, n - 1):
            a[i, i - 1] = h[i - 1]
            a[i, i] = 2.0 * (h[i - 1] + h[i])
            a[i, i + 1] = h[i]
            rhs[i] = 6.0 * ((y[i + 1] - y[i]) / h[i]
                            - (y[i] - y[i - 1]) / h[i - 1])
        m = np.linalg.solve(a, rhs)
        self.x, self.y, self.h, self.m = x, y, h, m

    def _segment(self, xq: np.ndarray) -> np.ndarray:
        return np.clip(np.searchsorted(self.x, xq, side="right") - 1,
                       0, self.x.size - 2)

    def __call__(self, xq, nu: int = 0):
        xq = np.asarray(xq, np.float64)
        i = self._segment(xq)
        x0, x1 = self.x[i], self.x[i + 1]
        h = self.h[i]
        m0, m1 = self.m[i], self.m[i + 1]
        t0, t1 = x1 - xq, xq - x0
        if nu == 0:
            return (m0 * t0**3 + m1 * t1**3) / (6 * h) \
                + (self.y[i] / h - m0 * h / 6) * t0 \
                + (self.y[i + 1] / h - m1 * h / 6) * t1
        if nu == 1:
            return (-m0 * t0**2 + m1 * t1**2) / (2 * h) \
                - (self.y[i] / h - m0 * h / 6) \
                + (self.y[i + 1] / h - m1 * h / 6)
        if nu == 2:
            return (m0 * t0 + m1 * t1) / h
        raise ValueError("nu ∈ {0, 1, 2}")


class ArbitrageFreeSpline:
    """Per-maturity IV splines with arbitrage violation reporting
    (surface.py:251-386 contract: fit / get_iv / check_local_variance)."""

    def __init__(self):
        self.splines: Dict[float, NaturalCubicSpline] = {}

    def fit(self, strikes: np.ndarray, maturities: np.ndarray,
            iv_surface: np.ndarray, penalty: float = 100.0) -> Dict:
        del penalty  # reporting-only, as in the reference (violations listed)
        violations: List[Dict] = []
        strikes = np.asarray(strikes, np.float64)

        for i, T in enumerate(np.asarray(maturities, np.float64)):
            ivs = np.asarray(iv_surface[i], np.float64)
            valid = np.isfinite(ivs)
            if valid.sum() < 4:
                continue
            cs = NaturalCubicSpline(strikes[valid], ivs[valid])
            self.splines[float(T)] = cs

            k_fine = np.linspace(strikes[valid].min(), strikes[valid].max(),
                                 200)
            butterfly = int(np.sum(cs(k_fine, 2) < -1e-6))
            if butterfly:
                violations.append({"type": "butterfly", "maturity": float(T),
                                   "count": butterfly})

        mats = sorted(self.splines)
        for t1, t2 in zip(mats, mats[1:]):
            cs1, cs2 = self.splines[t1], self.splines[t2]
            k_common = np.linspace(max(cs1.x.min(), cs2.x.min()),
                                   min(cs1.x.max(), cs2.x.max()), 100)
            tv1 = cs1(k_common) ** 2 * t1
            tv2 = cs2(k_common) ** 2 * t2
            cal = int(np.sum(tv2 < tv1 - 1e-6))
            if cal:
                violations.append({"type": "calendar",
                                   "maturities": (t1, t2), "count": cal})

        return {
            "num_maturities_fitted": len(self.splines),
            "violations": violations,
            "is_arbitrage_free": not violations,
        }

    def get_iv(self, strike: float, maturity: float) -> Optional[float]:
        """IV lookup with total-variance interpolation across maturities
        (surface.py:329-356)."""
        if not self.splines:
            return None
        mats = sorted(self.splines)
        if maturity in self.splines:
            return float(self.splines[maturity](strike))
        if maturity < mats[0]:
            return float(self.splines[mats[0]](strike))
        if maturity > mats[-1]:
            return float(self.splines[mats[-1]](strike))
        idx = int(np.searchsorted(mats, maturity)) - 1
        t1, t2 = mats[idx], mats[idx + 1]
        tv1 = float(self.splines[t1](strike)) ** 2 * t1
        tv2 = float(self.splines[t2](strike)) ** 2 * t2
        w = (maturity - t1) / (t2 - t1)
        tv = tv1 * (1 - w) + tv2 * w
        return float(np.sqrt(max(tv / maturity, 0.0)))

    def check_local_variance(self, strikes: np.ndarray,
                             maturities: np.ndarray) -> Dict:
        """Approximate Dupire local-variance positivity screen
        (surface.py:358-386: denominator-sign check; the full Dupire numerator
        needs ∂w/∂T which single-slice data cannot supply)."""
        negative: List[Dict] = []
        for T in np.asarray(maturities, np.float64):
            cs = self.splines.get(float(T))
            if cs is None:
                continue
            for K in np.asarray(strikes, np.float64):
                iv = float(cs(K))
                d1 = float(cs(K, 1))
                d2 = float(cs(K, 2))
                w = iv * iv * T
                if w <= 0:
                    continue
                dw = 2 * iv * d1 * T
                d2w = 2 * T * (d1 * d1 + iv * d2)
                denom = (1 - K * dw / (2 * w)) ** 2 \
                    - 0.25 * w * (d2w - 0.25) + K * K * d2w
                if denom <= 0:
                    negative.append({"K": float(K), "T": float(T)})
        return {"has_negative_local_var": bool(negative),
                "violations": negative}
