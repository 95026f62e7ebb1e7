"""P&L explain: attribute a day's option price move to its risk factors
(copy of `mcos_tpu/engine/pnl.py`, JAX-free: it runs on the host in float64
and launches no device work; tests/test_torch_desk.py holds the two equal).

The desk's morning report (capability beyond the reference): given
yesterday's and today's market state (spot, model params, time), decompose

    total P&L = delta·ΔS + ½·gamma·ΔS² + Σ_p (∂P/∂p)·Δp + theta·Δt
                + unexplained

plus the second-order vol terms every real explain carries —
vanna·ΔS·Δv₀ and ½·volga·Δv₀² — so risk knows whether the book moved for
the reasons the Greeks said it would. A small |unexplained| validates the
Greeks; a large one flags higher-order / regime breaks.

Both endpoints AND every sensitivity come from the COS pricer — the
semi-analytic SVJ oracle (`ops/cos_pricer.py`, host f64) — so the
attribution is deterministic: no MC noise pollutes the residual, and the
report's `unexplained` is *exactly* the higher-order remainder (tests pin
it to O(Δ²) for one-factor moves and to zero for the null move). The
per-factor derivatives are central differences of an analytic function in
f64 — accurate to ~1e-9, effectively exact for attribution purposes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.cos_pricer import cos_price

# Central-difference bumps (f64 host; analytic function, so small bumps
# are safe).
_BUMPS = {
    "spot_rel": 1e-4,
    "v0": 1e-5,
    "theta": 1e-5,
    "kappa": 1e-4,
    "xi": 1e-4,
    "rho": 1e-4,
    "lambda_j": 1e-4,
    "mu_j": 1e-5,
    "sigma_j": 1e-5,
    "r": 1e-6,
    "q": 1e-6,
    "T": 1e-5,
}
_PARAM_FIELDS = ("v0", "theta", "kappa", "xi", "rho", "lambda_j", "mu_j",
                 "sigma_j", "r", "q")


def _price(params: SVJParams, spot: float, strike: float, T: float,
           is_call: bool) -> float:
    return float(cos_price(params, spot, [strike], T, is_call)[0])


def pnl_explain(params_old: SVJParams, params_new: SVJParams,
                spot_old: float, spot_new: float,
                T_old: float, T_new: float,
                strike: float, is_call: bool = True,
                quantity: float = 1.0) -> Dict[str, object]:
    """First-order (plus spot-gamma) attribution of the price move.

    T_new < T_old is a day passing (theta contributes); every SVJ
    parameter that moved contributes its own line.
    """
    if T_new <= 0 or T_old <= 0:
        raise ValueError("need positive times to expiry")
    p_old = _price(params_old, spot_old, strike, T_old, is_call)
    p_new = _price(params_new, spot_new, strike, T_new, is_call)
    total = quantity * (p_new - p_old)

    # ── sensitivities at the OLD state ───────────────────────────────────
    ds = max(abs(spot_old) * _BUMPS["spot_rel"], 1e-8)
    up = _price(params_old, spot_old + ds, strike, T_old, is_call)
    dn = _price(params_old, spot_old - ds, strike, T_old, is_call)
    delta = (up - dn) / (2 * ds)
    gamma = (up - 2 * p_old + dn) / ds**2

    dt_bump = _BUMPS["T"]
    theta_t = (_price(params_old, spot_old, strike, T_old + dt_bump,
                      is_call)
               - _price(params_old, spot_old, strike,
                        max(T_old - dt_bump, 1e-6), is_call)) / (2 * dt_bump)

    grads = {}
    for f in _PARAM_FIELDS:
        h = _BUMPS[f]
        pu = dataclasses.replace(params_old,
                                 **{f: float(getattr(params_old, f)) + h})
        pd = dataclasses.replace(params_old,
                                 **{f: float(getattr(params_old, f)) - h})
        grads[f] = (_price(pu, spot_old, strike, T_old, is_call)
                    - _price(pd, spot_old, strike, T_old, is_call)) / (2 * h)

    # ── attribution lines ────────────────────────────────────────────────
    d_spot = spot_new - spot_old
    lines = {
        "delta": quantity * delta * d_spot,
        "gamma": quantity * 0.5 * gamma * d_spot**2,
        # calendar time passing: ∂P/∂T · ΔT (ΔT = T_new − T_old < 0)
        "time_decay": quantity * theta_t * (T_new - T_old),
    }
    cross = {}
    for f in _PARAM_FIELDS:
        dp = float(getattr(params_new, f)) - float(getattr(params_old, f))
        if dp == 0.0:
            continue
        lines[f] = quantity * grads[f] * dp
        # Second-order terms per moved factor: diagonal convexity
        # (½ ∂²P/∂f² Δf², the v0 case is classic volga) and the spot
        # cross (∂²P/∂S∂f ΔS Δf, the v0 case is vanna). Wider bumps for
        # the second differences.
        h2 = _BUMPS[f] * 10.0
        pu2 = dataclasses.replace(params_old,
                                  **{f: float(getattr(params_old, f)) + h2})
        pd2 = dataclasses.replace(params_old,
                                  **{f: float(getattr(params_old, f)) - h2})
        conv = (_price(pu2, spot_old, strike, T_old, is_call) - 2 * p_old
                + _price(pd2, spot_old, strike, T_old, is_call)) / h2**2
        x = ((_price(pu2, spot_old + ds, strike, T_old, is_call)
              - _price(pu2, spot_old - ds, strike, T_old, is_call))
             - (_price(pd2, spot_old + ds, strike, T_old, is_call)
                - _price(pd2, spot_old - ds, strike, T_old, is_call))
             ) / (4 * ds * h2)
        c_line = quantity * 0.5 * conv * dp**2
        x_line = quantity * x * d_spot * dp
        if abs(c_line) > 1e-12:
            cross[f"convexity_{f}"] = c_line
        if abs(x_line) > 1e-12:
            cross[f"cross_spot_{f}"] = x_line
    lines.update(cross)
    explained = sum(lines.values())
    return {
        "total_pnl": total,
        "explained": explained,
        "unexplained": total - explained,
        "attribution": {k: float(v) for k, v in lines.items()},
        "price_old": p_old,
        "price_new": p_new,
        "greeks_at_old": {"delta": delta, "gamma": gamma,
                          "dP_dT": theta_t, **grads},
        "method": "cos-exact-endpoints",
    }
