"""Black-Scholes closed forms in torch (counterpart of `mcos_tpu/ops/bs.py`).

Float32 on the given device, as the JAX package computes them; every
function broadcasts over its tensor arguments and is differentiable. At
T ≤ 0 or σ ≤ 0 the price is the discounted-forward intrinsic value, and
the Greeks take the same degenerate branches as the JAX functions (the
live branch runs on safe inputs, so no NaN reaches a gradient).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _args(S, K, T, r, q, sigma, device):
    """The six arguments as float32 tensors on `device` (default: the
    first tensor argument's, else the CPU)."""
    if device is None:
        device = next((x.device for x in (S, K, T, r, q, sigma)
                       if isinstance(x, torch.Tensor)), torch.device("cpu"))
    return tuple(_f32(x, device) for x in (S, K, T, r, q, sigma))


def _safe(T, sigma):
    """(degenerate mask, T, σ with the degenerate entries set to 1)."""
    degenerate = (T <= _EPS) | (sigma <= _EPS)
    return (degenerate, torch.where(degenerate, torch.ones_like(T), T),
            torch.where(degenerate, torch.ones_like(sigma), sigma))


def norm_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / float(np.sqrt(2.0 * np.pi))


def _d1_d2(S, K, T, r, q, sigma):
    """d₁, d₂ with safe denominators (σ√T floored away from 0)."""
    sqrtT = torch.sqrt(torch.clamp(T, min=_EPS))
    denom = torch.clamp(sigma * sqrtT, min=_EPS)
    d1 = (torch.log(S / K) + (r - q + 0.5 * sigma * sigma) * T) / denom
    d2 = d1 - sigma * sqrtT
    return d1, d2


def bs_price(S, K, T, r, q, sigma, is_call: bool = True, *,
             device=None) -> torch.Tensor:
    """European option price; broadcasts over its tensor arguments.

    `device` defaults to the device of the first tensor argument, else CPU.
    """
    S, K, T, r, q, sigma = _args(S, K, T, r, q, sigma, device)
    degenerate, T_s, sig_s = _safe(T, sigma)
    d1, d2 = _d1_d2(S, K, T_s, r, q, sig_s)

    df_r = torch.exp(-r * T)
    df_q = torch.exp(-q * T)
    ndtr = torch.special.ndtr
    if is_call:
        live = S * df_q * ndtr(d1) - K * df_r * ndtr(d2)
        intrinsic = torch.clamp(S * df_q - K * df_r, min=0.0)
    else:
        live = K * df_r * ndtr(-d2) - S * df_q * ndtr(-d1)
        intrinsic = torch.clamp(K * df_r - S * df_q, min=0.0)
    return torch.where(degenerate, intrinsic, live)


def bs_delta(S, K, T, r, q, sigma, is_call: bool = True, *,
             device=None) -> torch.Tensor:
    """∂P/∂S. At expiry the spot-moneyness indicator; at σ → 0 with time
    left e^{-qT}·1{forward in the money}, the N(d₁) limit."""
    S, K, T, r, q, sigma = _args(S, K, T, r, q, sigma, device)
    expired = T <= _EPS
    zero_vol = (sigma <= _EPS) & ~expired
    degenerate = expired | zero_vol
    T_s = torch.where(degenerate, torch.ones_like(T), T)
    sig_s = torch.where(degenerate, torch.ones_like(sigma), sigma)
    d1, _ = _d1_d2(S, K, T_s, r, q, sig_s)
    df_q = torch.exp(-q * T)
    fwd_itm_call = S * torch.exp((r - q) * T) > K
    one, zero = torch.ones_like(df_q), torch.zeros_like(df_q)
    ndtr = torch.special.ndtr
    if is_call:
        live = df_q * ndtr(d1)
        edge = torch.where(expired, torch.where(S > K, one, zero),
                           torch.where(fwd_itm_call, df_q, zero))
    else:
        live = df_q * (ndtr(d1) - 1.0)
        edge = torch.where(expired, torch.where(S < K, -one, zero),
                           torch.where(fwd_itm_call, zero, -df_q))
    return torch.where(degenerate, edge, live)


def bs_gamma(S, K, T, r, q, sigma, *, device=None) -> torch.Tensor:
    """∂²P/∂S² (the same for a call and a put)."""
    S, K, T, r, q, sigma = _args(S, K, T, r, q, sigma, device)
    degenerate, T_s, sig_s = _safe(T, sigma)
    d1, _ = _d1_d2(S, K, T_s, r, q, sig_s)
    live = (torch.exp(-q * T_s) * norm_pdf(d1)
            / (S * sig_s * torch.sqrt(T_s)))
    return torch.where(degenerate, torch.zeros_like(live), live)


def bs_vega(S, K, T, r, q, sigma, *, device=None) -> torch.Tensor:
    """∂P/∂σ (the same for a call and a put)."""
    S, K, T, r, q, sigma = _args(S, K, T, r, q, sigma, device)
    degenerate, T_s, sig_s = _safe(T, sigma)
    d1, _ = _d1_d2(S, K, T_s, r, q, sig_s)
    live = S * torch.exp(-q * T_s) * torch.sqrt(T_s) * norm_pdf(d1)
    return torch.where(degenerate, torch.zeros_like(live), live)


def bs_theta(S, K, T, r, q, sigma, is_call: bool = True, *,
             device=None) -> torch.Tensor:
    """∂P/∂t = −∂P/∂T, annualized."""
    S, K, T, r, q, sigma = _args(S, K, T, r, q, sigma, device)
    degenerate, T_s, sig_s = _safe(T, sigma)
    d1, d2 = _d1_d2(S, K, T_s, r, q, sig_s)
    df_r = torch.exp(-r * T_s)
    df_q = torch.exp(-q * T_s)
    common = -S * df_q * norm_pdf(d1) * sig_s / (2.0 * torch.sqrt(T_s))
    ndtr = torch.special.ndtr
    if is_call:
        live = common - r * K * df_r * ndtr(d2) + q * S * df_q * ndtr(d1)
    else:
        live = common + r * K * df_r * ndtr(-d2) - q * S * df_q * ndtr(-d1)
    return torch.where(degenerate, torch.zeros_like(live), live)


def bs_rho(S, K, T, r, q, sigma, is_call: bool = True, *,
           device=None) -> torch.Tensor:
    """∂P/∂r."""
    S, K, T, r, q, sigma = _args(S, K, T, r, q, sigma, device)
    degenerate, T_s, sig_s = _safe(T, sigma)
    _, d2 = _d1_d2(S, K, T_s, r, q, sig_s)
    df_r = torch.exp(-r * T_s)
    ndtr = torch.special.ndtr
    if is_call:
        live = K * T_s * df_r * ndtr(d2)
    else:
        live = -K * T_s * df_r * ndtr(-d2)
    return torch.where(degenerate, torch.zeros_like(live), live)


def bs_all_greeks(S, K, T, r, q, sigma, is_call: bool = True, *,
                  device=None) -> dict:
    """All five closed-form Greeks and the price in one dict."""
    args = _args(S, K, T, r, q, sigma, device)
    return {
        "price": bs_price(*args, is_call),
        "delta": bs_delta(*args, is_call),
        "gamma": bs_gamma(*args),
        "vega": bs_vega(*args),
        "theta": bs_theta(*args, is_call),
        "rho": bs_rho(*args, is_call),
    }
