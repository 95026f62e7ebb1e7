"""Implied volatility on the host (counterpart of the first part of
`mcos_tpu/engine/surface.py`: `implied_vol_grid` and `implied_vol`, host
float64, copied; tests/test_torch_copies.py holds them equal to the JAX
package's). The SABR and spline parts of that module are not ported yet
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
