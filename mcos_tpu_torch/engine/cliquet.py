"""Forward-start and cliquet closed forms and the cliquet payoff
(counterpart of the first part of `mcos_tpu/engine/cliquet.py`): what
`TDSVJEngine.price_forward_start` and `price_cliquet` need. The closed
forms are host float64, copied; tests/test_torch_copies.py holds them
equal to the JAX package's. `CliquetEngine` is not ported yet (ROADMAP.md
queue 1).

A forward-start performance call is Rubinstein (1991): Black-Scholes on
the ratio S_T/S_t₁, which is independent of F_t₁; the uncapped-sum cliquet
decomposes per period into clip(R, f, c) = f + (R−f)⁺ − (R−c)⁺, each term
a forward-start call.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import norm

from mcos_tpu_torch.ops.simulate import combine_antithetic


def _performance_call_undisc(k: float, tau: float, r: float, q: float,
                             sigma: float) -> float:
    """E[max(S_{t+τ}/S_t − k, 0)] under GBM: Black-76 on the gross return
    (forward F = e^{(r−q)τ}, unit notional)."""
    if k <= 0.0:
        return float(np.exp((r - q) * tau) - k)
    st = sigma * np.sqrt(tau)
    F = np.exp((r - q) * tau)
    d1 = (np.log(F / k) + 0.5 * st**2) / max(st, 1e-12)
    d2 = d1 - st
    return float(F * norm.cdf(d1) - k * norm.cdf(d2))


def forward_start_bs(t1: float, T: float, k: float, r: float, q: float,
                     sigma: float, is_call: bool = True) -> float:
    """Forward-start performance option e^{-rT}·E[max(±(S_T/S_t₁ − k), 0)].

    Rubinstein (1991): the ratio is lognormal over τ = T − t₁ and
    independent of S_t₁, so the t₁-measurability integrates out.
    """
    tau = T - t1
    call = np.exp(-r * T) * _performance_call_undisc(k, tau, r, q, sigma)
    if is_call:
        return float(call)
    # Parity on the ratio: E[ratio] = e^{(r−q)τ}.
    return float(call - np.exp(-r * T)
                 * (np.exp((r - q) * tau) - k))


def cliquet_bs(T: float, n_periods: int, r: float, q: float, sigma: float,
               local_floor: float, local_cap: float,
               notional: float = 1.0) -> float:
    """Uncapped-sum cliquet e^{-rT}·N·Σⱼ E[clip(Rⱼ, f, c)] under GBM.

    Period returns are iid, and clip(R, f, c) = f + (R−f)⁺ − (R−c)⁺: two
    forward-start calls per period. Exact only without the global floor/cap
    (those couple the periods); the MC handles the general contract.
    """
    tau = T / n_periods
    e_clip = (local_floor
              + _performance_call_undisc(1.0 + local_floor, tau, r, q, sigma)
              - _performance_call_undisc(1.0 + local_cap, tau, r, q, sigma))
    return float(notional * n_periods * e_clip * np.exp(-r * T))


def _cliquet_payoff(dlog: torch.Tensor, local_floor, local_cap, global_floor,
                    global_cap) -> torch.Tensor:
    """Clipped-sum cliquet payoff from (n_periods, 2, paths) log returns."""
    r_per = torch.clamp(torch.exp(dlog) - 1.0, min=local_floor, max=local_cap)
    total = torch.clamp(torch.sum(r_per, dim=0), min=global_floor,
                        max=global_cap)
    return combine_antithetic(total)
