"""Black-Scholes price in torch (counterpart of `mcos_tpu/ops/bs.py:bs_price`).

Float32 on the given device, as the JAX package computes it. At T ≤ 0 or
σ ≤ 0 it returns the discounted-forward intrinsic value. Only the price is
ported in this slice: the control variate and the GBM gate need nothing
else.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def bs_price(S, K, T, r, q, sigma, is_call: bool = True, *,
             device=None) -> torch.Tensor:
    """European option price; broadcasts over its tensor arguments.

    `device` defaults to the device of the first tensor argument, else CPU.
    """
    if device is None:
        device = next((x.device for x in (S, K, T, r, q, sigma)
                       if isinstance(x, torch.Tensor)), torch.device("cpu"))
    S, K, T, r, q, sigma = (_f32(x, device) for x in (S, K, T, r, q, sigma))
    degenerate = (T <= _EPS) | (sigma <= _EPS)

    # Safe inputs for the live branch.
    T_s = torch.where(degenerate, torch.ones_like(T), T)
    sig_s = torch.where(degenerate, torch.ones_like(sigma), sigma)
    sqrtT = torch.sqrt(torch.clamp(T_s, min=_EPS))
    denom = torch.clamp(sig_s * sqrtT, min=_EPS)
    d1 = (torch.log(S / K) + (r - q + 0.5 * sig_s * sig_s) * T_s) / denom
    d2 = d1 - sig_s * sqrtT

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
