"""Path-dependent simulation and exotic-payoff analytics of the port
(counterpart of `mcos_tpu/ops/exotics.py`).

One pass tracks the path functionals every exotic needs: running arithmetic
sum, log-sum (geometric mean), running max/min of log S, for the SVJ leg
and the GBM companion leg, plus (bridge=True) the Brownian-bridge
log-survival weight against one barrier or a corridor. Running extrema
stay in log space, so the only per-step `exp` is the arithmetic average's.

`simulate_path_stats` is the differentiable torch twin (a Python loop over
`_svj_step_core`); the hot path runs kernel K6
(`ops/cuda_kernels.py:svj_path_stats`, csrc/svj_stats.cu), which computes
the same functionals from its own Philox stream. `corridor_surv_increment`
is shared by the twin and K6's plain version; csrc/svj_stats.cu holds the
device version of the same series.

Monitoring is discrete at the simulation grid (t_i = i·T/n, i = 1..n);
continuous-monitoring barrier/lookback values differ by the usual
Broadie-Glasserman-Kou O(1/√n) gap unless the bridge weight is used.

The payoffs and `geometric_asian_bs` / `lookback_float_bs` are float32
torch; the barrier closed forms below them are host float64 numpy, as in
the JAX package (tests/test_torch_copies.py holds them equal).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.simulate import _f32, _svj_step_core

_ndtr = torch.special.ndtr


def single_surv_increment(x_old, x_new, var_step, dt, log_b,
                          bridge_up: bool = True):
    """log P(no within-step crossing of the barrier at log(B/S0) = `log_b` |
    endpoints live), −inf on an endpoint breach.

    With d the signed distance to the barrier, the diffusive bridge crosses
    with probability exp(−2·d_old·d_new / (var_step·dt)). Live endpoints
    have d_old·d_new > 0, so the exponent is < 0; clamping it at 0 changes
    only the (discarded) dead branch and keeps `exp` finite, so autograd
    never multiplies a zero cotangent by inf: the weight is differentiated
    pathwise for barrier Greeks."""
    if bridge_up:
        d_old, d_new = log_b - x_old, log_b - x_new
    else:
        d_old, d_new = x_old - log_b, x_new - log_b
    dead = (d_old <= 0.0) | (d_new <= 0.0)
    p_cross = torch.exp(torch.clamp(
        -2.0 * d_old * d_new / torch.clamp(var_step * dt, min=1e-20),
        max=0.0))
    return torch.where(dead, torch.full_like(p_cross, -torch.inf),
                       torch.log1p(-torch.clamp(p_cross, max=1.0 - 1e-7)))


def corridor_surv_increment(x_old, x_new, var_step, dt, log_lo, log_hi,
                            n_images: int = 2):
    """log P(no exit from (lo, hi) within the step | endpoints live).

    Method-of-images series for the Brownian bridge on a corridor: with
    a = x_old − lo, b = x_new − lo, d = hi − lo, s = var_step·dt,

        P_surv = Σ_n [ e^{−2nd(nd−(b−a))/s} − e^{−((a+b−2nd)² − (b−a)²)/(2s)} ]

    (n = 0 first term is 1; n = 0 second term is the lower-barrier crossing
    e^{−2ab/s}; n = 1 second term is the upper-barrier crossing
    e^{−2(d−a)(d−b)/s}; |n| ≥ 1 first terms are the return images). For
    live endpoints every exponent is ≤ 0 and terms decay like
    e^{−2n²d²/s}, so the `n_images`-term truncation is exact to float32
    whenever the corridor is wider than a few step-stdevs. Endpoint breach
    → −inf. Exponents are clamped ≤ 0 and P_surv to [1e−7, 1] so the
    weight stays safe under autograd (no 0·inf through `where`).

    Shared by the twin (`simulate_path_stats(corridor=True)`) and the plain
    version of kernel K6; csrc/svj_stats.cu:corridor_inc evaluates the same
    terms in the same order.
    """
    a = x_old - log_lo
    b = x_new - log_lo
    d = log_hi - log_lo
    s = torch.clamp(var_step * dt, min=1e-20)
    dead = (a <= 0.0) | (a >= d) | (b <= 0.0) | (b >= d)
    delta = b - a
    ssum = a + b
    psurv = torch.ones_like(a)
    for n in range(-n_images, n_images + 1):
        if n != 0:
            psurv = psurv + torch.exp(torch.clamp(
                -2.0 * n * d * (n * d - delta) / s, max=0.0))
        psurv = psurv - torch.exp(torch.clamp(
            -((ssum - 2.0 * n * d) ** 2 - delta**2) / (2.0 * s), max=0.0))
    return torch.where(dead, torch.full_like(psurv, -torch.inf),
                       torch.log(torch.clamp(psurv, 1e-7, 1.0)))


def simulate_path_stats(
    params: SVJParams, spot, T, generator: Optional[torch.Generator],
    num_paths: int, num_steps: int, antithetic: bool = True,
    companion: bool = True, bridge: bool = False, bridge_up: bool = True,
    bridge_log_b=0.0, corridor: bool = False, bridge_log_l=0.0, window=None,
    *, draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """SVJ paths with running functionals; the differentiable torch twin.

    Returns a dict of (n_branch, num_paths) float32 tensors: s_final,
    v_final, avg (arithmetic mean of S at t_1..t_n), log_avg (mean of
    log S; the geometric mean is its exp), max_s, min_s, and the
    companion-leg counterparts (g_final, g_avg, g_log_avg, g_max, g_min)
    when companion=True.

    bridge=True also accumulates `log_surv` (and `g_log_surv`), the
    Brownian-bridge log-survival weight against the barrier at
    log(B/S0) = `bridge_log_b` (`bridge_up` picks the side): the SVJ leg on
    its pre-step variance, the companion on v0; an endpoint breach gives
    −inf. Exact continuous monitoring under GBM at any step count. Under
    jumps the bridge conditions on the diffusive part only.
    corridor=True (with bridge=True) monitors both barriers
    (`bridge_log_l`, `bridge_log_b`) through `corridor_surv_increment`.
    window=(w0, w1) (step indices, with bridge=True) restricts monitoring
    to steps w0..w1−1; steps outside add log-weight 0.

    Randoms: `generator`'s draws, (steps, 3, paths) normals then
    (steps, paths) uniforms, all up front; or `draws=(z, u_jump)` of those
    shapes, so a caller can feed another stream. Differentiable in spot,
    the barrier logs and the fields of `params` given as tensors.
    """
    if draws is not None:
        z, u_jump = draws
        device = z.device
    else:
        device = torch.device(device)
        z = torch.randn((num_steps, 3, num_paths), generator=generator,
                        device=device, dtype=torch.float32)
        u_jump = torch.rand((num_steps, num_paths), generator=generator,
                            device=device, dtype=torch.float32)
    if (tuple(z.shape) != (num_steps, 3, num_paths)
            or tuple(u_jump.shape) != (num_steps, num_paths)):
        raise ValueError("draws must be (steps, 3, paths) normals and "
                         "(steps, paths) uniforms")
    n_branch = 2 if antithetic else 1
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]

    # Carry log(S/S0); spot scales back at the end.
    zeros = torch.zeros((n_branch, num_paths), dtype=torch.float32,
                        device=device)
    log_s, log_g = zeros, zeros
    v = _f32(params.v0, device).expand(n_branch, num_paths)
    sum_s = sum_log = log_surv = zeros
    g_sum_s = g_sum_log = g_log_surv = zeros
    max_log = g_max_log = torch.full_like(zeros, -torch.inf)
    min_log = g_min_log = torch.full_like(zeros, torch.inf)

    sigma_cv = torch.sqrt(_f32(params.v0, device))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt
    b_log = _f32(bridge_log_b, device)
    l_log = _f32(bridge_log_l, device)

    def surv_increment(x_old, x_new, var_step):
        if corridor:
            return corridor_surv_increment(x_old, x_new, var_step, dt,
                                           l_log, b_log)
        return single_surv_increment(x_old, x_new, var_step, dt, b_log,
                                     bridge_up)

    for t in range(num_steps):
        z1 = z[t, 0] * sign
        x_prev, v_prev = log_s, v
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z1,
                                  z[t, 1] * sign, u_jump[t][None, :],
                                  z[t, 2] * sign)
        sum_s = sum_s + torch.exp(log_s)
        sum_log = sum_log + log_s
        max_log = torch.maximum(max_log, log_s)
        min_log = torch.minimum(min_log, log_s)
        in_win = window is None or window[0] <= t < window[1]
        if bridge and in_win:
            log_surv = log_surv + surv_increment(
                x_prev, log_s, torch.clamp(v_prev, min=1e-12))
        if companion:
            x_prev_g = log_g
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
            g_sum_s = g_sum_s + torch.exp(log_g)
            g_sum_log = g_sum_log + log_g
            g_max_log = torch.maximum(g_max_log, log_g)
            g_min_log = torch.minimum(g_min_log, log_g)
            if bridge and in_win:
                g_log_surv = g_log_surv + surv_increment(
                    x_prev_g, log_g, sigma_cv**2)

    n = float(num_steps)
    log_spot = torch.log(spot)
    out = {
        "s_final": spot * torch.exp(log_s),
        "v_final": v,
        "avg": spot * (sum_s / n),
        "log_avg": log_spot + sum_log / n,
        "max_s": spot * torch.exp(max_log),
        "min_s": spot * torch.exp(min_log),
    }
    if bridge:
        out["log_surv"] = log_surv
    if companion:
        out.update({
            "g_final": spot * torch.exp(log_g),
            "g_avg": spot * (g_sum_s / n),
            "g_log_avg": log_spot + g_sum_log / n,
            "g_max": spot * torch.exp(g_max_log),
            "g_min": spot * torch.exp(g_min_log),
        })
        if bridge:
            out["g_log_surv"] = g_log_surv
    return out


def _arg_device(*xs) -> torch.device:
    return next((x.device for x in xs if isinstance(x, torch.Tensor)),
                torch.device("cpu"))


# ─────────────────────────────────────────────────────────────────────────────
# Closed forms (control variates / test oracles), float32 torch
# ─────────────────────────────────────────────────────────────────────────────
def geometric_asian_bs(S, K, T, r, q, sigma, num_obs: int,
                       is_call: bool = True) -> torch.Tensor:
    """Discrete geometric-average Asian option under Black-Scholes.

    Observations at t_i = i·T/n, i = 1..n. ln G ~ N(m, v) with
        m = ln S + (r − q − σ²/2) · T(n+1)/(2n)
        v = σ² T (n+1)(2n+1) / (6n²)
    Price = e^{−rT} (F_G N(d₁) − K N(d₂)), F_G = e^{m+v/2}.
    Exact (Kemna-Vorst discrete form): the arithmetic-Asian control
    variate and the test oracle. Float32 on the device of its first tensor
    argument (else the CPU); differentiable in its tensor arguments.
    """
    device = _arg_device(S, K, T, r, q, sigma)
    S, K, T, r, q, sigma = (_f32(x, device) for x in (S, K, T, r, q, sigma))
    n = float(num_obs)
    t_bar = T * (n + 1.0) / (2.0 * n)
    v = sigma**2 * T * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n * n)
    m = torch.log(S) + (r - q - 0.5 * sigma**2) * t_bar
    sqrt_v = torch.sqrt(torch.clamp(v, min=1e-20))
    f_g = torch.exp(m + 0.5 * v)
    d2 = (m - torch.log(K)) / sqrt_v
    d1 = d2 + sqrt_v
    df = torch.exp(-r * T)
    if is_call:
        return df * (f_g * _ndtr(d1) - K * _ndtr(d2))
    return df * (K * _ndtr(-d2) - f_g * _ndtr(-d1))


def lookback_float_bs(S, T, r, q, sigma, is_call: bool = True
                      ) -> torch.Tensor:
    """Continuously-monitored floating-strike lookback, fresh contract
    (Goldman-Sosin-Gatto; Haug §4.15.1 form with m = M = S).

    Call pays S_T − min S; put pays max S − S_T. Discretely-monitored MC at
    n steps is worth less by the usual O(1/√n) extremum undershoot.
    Requires b = r − q ≠ 0 (the σ²/2b term).
    """
    device = _arg_device(S, T, r, q, sigma)
    S, T, r, q, sigma = (_f32(x, device) for x in (S, T, r, q, sigma))
    b = r - q
    sqrt_t = torch.sqrt(T)
    df_r = torch.exp(-r * T)
    df_q = torch.exp(-q * T)
    a1 = (b + 0.5 * sigma**2) * sqrt_t / sigma
    a2 = a1 - sigma * sqrt_t
    k = 2.0 * b / sigma**2
    if is_call:
        return (S * df_q * _ndtr(a1) - S * df_r * _ndtr(a2)
                + S * df_r * (sigma**2 / (2.0 * b))
                * (_ndtr(-a1 + k * sigma * sqrt_t)
                   - torch.exp(b * T) * _ndtr(-a1)))
    return (S * df_r * _ndtr(-a2) - S * df_q * _ndtr(-a1)
            + S * df_r * (sigma**2 / (2.0 * b))
            * (-_ndtr(a1 - k * sigma * sqrt_t)
               + torch.exp(b * T) * _ndtr(a1)))


# ─────────────────────────────────────────────────────────────────────────────
# Exotic payoffs from path stats
# ─────────────────────────────────────────────────────────────────────────────
def _vanilla(s_t: torch.Tensor, strike, is_call: bool) -> torch.Tensor:
    return torch.clamp(s_t - strike, min=0.0) if is_call \
        else torch.clamp(strike - s_t, min=0.0)


def asian_payoff(stats: Dict[str, torch.Tensor], strike, is_call: bool,
                 averaging: str = "arithmetic", leg: str = ""
                 ) -> torch.Tensor:
    key = {"arithmetic": f"{leg}avg" if leg else "avg",
           "geometric": f"{leg}log_avg" if leg else "log_avg"}[averaging]
    avg = stats[key]
    if averaging == "geometric":
        avg = torch.exp(avg)
    return _vanilla(avg, strike, is_call)


def _alive_or_rebate(alive, vanilla, rebate):
    return torch.where(alive, vanilla, _f32(rebate, vanilla.device))


def barrier_payoff(stats: Dict[str, torch.Tensor], strike, barrier,
                   is_call: bool, knock: str = "out", direction: str = "up",
                   rebate=0.0) -> torch.Tensor:
    """Discretely-monitored barrier payoff.

    direction: 'up' monitors max S vs barrier; 'down' monitors min S.
    knock: 'out' voids on touch; 'in' activates on touch. `rebate` (cash,
    paid at expiry) replaces the payoff on the dead branch: on touch for
    knock-outs, on no-touch for knock-ins; at-hit discounting is the
    caller's (engine/exotics.py:price_barrier).
    """
    vanilla = _vanilla(stats["s_final"], strike, is_call)
    touched = (stats["max_s"] >= barrier if direction == "up"
               else stats["min_s"] <= barrier)
    alive = ~touched if knock == "out" else touched
    return _alive_or_rebate(alive, vanilla, rebate)


def double_barrier_payoff(stats: Dict[str, torch.Tensor], strike, barrier_lo,
                          barrier_hi, is_call: bool, knock: str = "out",
                          rebate=0.0) -> torch.Tensor:
    """Discretely-monitored double-barrier payoff: the option knocks when
    the grid max breaches `barrier_hi` or the grid min breaches
    `barrier_lo` (knock='out' voids on touch; 'in' activates). `rebate`
    (cash at expiry) pays on the dead branch."""
    vanilla = _vanilla(stats["s_final"], strike, is_call)
    touched = (stats["max_s"] >= barrier_hi) | (stats["min_s"] <= barrier_lo)
    alive = ~touched if knock == "out" else touched
    return _alive_or_rebate(alive, vanilla, rebate)


def barrier_bridge_payoff(stats: Dict[str, torch.Tensor], strike,
                          is_call: bool, knock: str = "out", leg: str = "",
                          rebate=0.0) -> torch.Tensor:
    """Continuously-monitored barrier payoff via the Brownian-bridge
    survival weight (`bridge=True` stats).

    knock-out: vanilla(S_T) · P(never crossed); knock-in: vanilla · (1 − P),
    so per-path in-out parity is exact. leg="g" reads the companion GBM leg
    (its exact continuous expectation is `barrier_bs`, the bridge CV).
    `rebate` (cash at expiry) rides the dead weight: KO pays
    rebate·(1−P), KI rebate·P."""
    s_t = stats["g_final" if leg == "g" else "s_final"]
    surv = torch.exp(stats[f"{leg}_log_surv" if leg else "log_surv"])
    vanilla = _vanilla(s_t, strike, is_call)
    if knock == "out":
        return vanilla * surv + rebate * (1.0 - surv)
    return vanilla * (1.0 - surv) + rebate * surv


def one_touch_bridge_payoff(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Touch probability weight 1 − P(survive): the smooth one-touch
    estimator (continuous monitoring, exact under GBM)."""
    return 1.0 - torch.exp(stats["log_surv"])


def lookback_payoff(stats: Dict[str, torch.Tensor], is_call: bool,
                    strike=None) -> torch.Tensor:
    """Floating-strike (strike=None) or fixed-strike lookback payoff."""
    if strike is None:
        return (stats["s_final"] - stats["min_s"] if is_call
                else stats["max_s"] - stats["s_final"])
    return (torch.clamp(stats["max_s"] - strike, min=0.0) if is_call
            else torch.clamp(strike - stats["min_s"], min=0.0))


# ─────────────────────────────────────────────────────────────────────────────
# Continuously-monitored barrier closed forms (GBM; Reiner-Rubinstein),
# host float64 numpy, as in mcos_tpu/ops/exotics.py
# ─────────────────────────────────────────────────────────────────────────────
def barrier_bs(S, K, T, r, q, sigma, barrier, is_call: bool = True,
               knock: str = "out", direction: str = "up") -> float:
    """Continuous-monitoring barrier option under GBM, no rebate (host f64).

    Reiner-Rubinstein (1991) A/B/C/D building blocks (Haug's convention:
    phi = option sign, eta = barrier-direction sign); knock-OUT prices come
    from in-out parity against the vanilla, which is exact without rebates.
    Used as the oracle for the BGK-corrected MC (`engine/exotics.py`
    monitoring="continuous") and the continuous-limit convergence tests.
    """
    from scipy.stats import norm

    S, K, T, H = float(S), float(K), float(T), float(barrier)
    st = sigma * np.sqrt(T)
    mu = (r - q - 0.5 * sigma**2) / sigma**2
    phi = 1.0 if is_call else -1.0
    eta = -1.0 if direction == "up" else 1.0
    dfq, dfr = np.exp(-q * T), np.exp(-r * T)

    def block(x):
        return (phi * S * dfq * norm.cdf(phi * x)
                - phi * K * dfr * norm.cdf(phi * (x - st)))

    def block_y(y):
        pow_s = (H / S) ** (2.0 * (mu + 1.0))
        pow_k = (H / S) ** (2.0 * mu)
        return (phi * S * dfq * pow_s * norm.cdf(eta * y)
                - phi * K * dfr * pow_k * norm.cdf(eta * (y - st)))

    x1 = np.log(S / K) / st + (1.0 + mu) * st
    x2 = np.log(S / H) / st + (1.0 + mu) * st
    y1 = np.log(H * H / (S * K)) / st + (1.0 + mu) * st
    y2 = np.log(H / S) / st + (1.0 + mu) * st
    A = block(x1)
    B = block(x2)
    C = block_y(y1)
    D = block_y(y2)

    up = direction == "up"
    if is_call:
        if up:
            knock_in = A if K >= H else B - C + D
        else:
            knock_in = C if K >= H else A - B + D
    else:
        if up:
            knock_in = A - B + D if K >= H else C
        else:
            knock_in = B - C + D if K >= H else A

    # A path that starts through the barrier is knocked immediately.
    if (up and S >= H) or (not up and S <= H):
        knock_in = block(x1)                      # = vanilla
    knock_in = float(max(knock_in, 0.0))
    if knock == "in":
        return knock_in
    vanilla = float(block(x1))
    return float(max(vanilla - knock_in, 0.0))    # in-out parity


# Broadie-Glasserman-Kou continuity-correction constant: -zeta(1/2)/sqrt(2π).
BGK_BETA = 0.5825971579390107


def one_touch_bs(S, T, r, q, sigma, barrier, direction: str = "up",
                 pay_at_hit: bool = False) -> float:
    """Continuous one-touch digital: pays 1 when the barrier trades.

    pay_at_hit=False (cash at expiry): e^{-rT} * P(touch by T), with the
    touch probability from the reflection principle for drifted BM,
        P(max ln(S_t/S) >= b) = Phi((m T - b)/(sig sqrt(T)))
                              + e^{2 m b / sig^2} Phi((-b - m T)/(sig sqrt(T))),
    m = r - q - sig^2/2, b = ln(B/S) (mirrored for down barriers).
    pay_at_hit=True discounts to the hit time (the rebate-at-hit closed
    form with the sqrt(m^2 + 2 r sig^2) exponents).
    """
    from scipy.stats import norm

    S, T, B = float(S), float(T), float(barrier)
    if (direction == "up" and S >= B) or (direction == "down" and S <= B):
        return 1.0                           # already through
    st = sigma * np.sqrt(T)
    m = r - q - 0.5 * sigma**2
    b = np.log(B / S) if direction == "up" else np.log(S / B)
    mm = m if direction == "up" else -m      # drift toward the barrier
    if not pay_at_hit:
        p_touch = (norm.cdf((mm * T - b) / st)
                   + np.exp(2.0 * mm * b / sigma**2)
                   * norm.cdf((-b - mm * T) / st))
        return float(np.exp(-r * T) * min(max(p_touch, 0.0), 1.0))
    # E[e^{-r tau} 1{tau <= T}] for the level-crossing time of drifted BM
    # (checks: r=0 reduces to the touch probability; T -> infinity gives
    # the Laplace transform e^{-b (lam - mm)/sigma^2}).
    lam = np.sqrt(mm * mm + 2.0 * r * sigma**2)
    a_dec = (mm - lam) / sigma**2            # decaying exponent (<0)
    a_grow = (mm + lam) / sigma**2
    val = (np.exp(a_dec * b) * norm.cdf((-b + lam * T) / st)
           + np.exp(a_grow * b) * norm.cdf((-b - lam * T) / st))
    return float(min(max(val, 0.0), 1.0))


# ─────────────────────────────────────────────────────────────────────────────
# Continuously-monitored DOUBLE-barrier closed forms (GBM, host f64)
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=16)
def _leggauss(n: int):
    """Cached Gauss-Legendre nodes/weights (recomputing them inside the
    per-outer-node loop would dominate the window oracles)."""
    return np.polynomial.legendre.leggauss(n)


@lru_cache(maxsize=16)
def _hermgauss(n: int):
    return np.polynomial.hermite.hermgauss(n)


def _corridor_density(x, lo, hi, m, sigma, T, n_images: int = 8):
    """Sub-density of X_T = x for drifted BM (drift m, vol sigma, X_0 = 0)
    that never exits (lo, hi) — method of images + Girsanov.

    Driftless corridor density by alternating reflections about hi and lo
    (d = hi − lo):  q0(x) = Σ_n [ φ(x − 2nd) − φ(x − 2·hi + 2nd) ]
    (checks: lo → −inf leaves φ(x) − φ(x − 2·hi), the single-barrier
    reflection; hi → +inf leaves φ(x) − φ(x − 2·lo)). The drift enters
    only through the endpoint-measurable Girsanov factor
    e^{m·x/σ² − m²T/(2σ²)}. Vectorized in x; f64."""
    from scipy.stats import norm

    x = np.asarray(x, np.float64)
    sig_t = sigma * np.sqrt(T)
    d = hi - lo
    q0 = np.zeros_like(x)
    for n in range(-n_images, n_images + 1):
        q0 += norm.pdf(x - 2.0 * n * d, scale=sig_t)
        q0 -= norm.pdf(x - 2.0 * hi + 2.0 * n * d, scale=sig_t)
    return np.exp((m * x - 0.5 * m * m * T) / sigma**2) * np.maximum(q0, 0.0)


def double_barrier_bs(S, K, T, r, q, sigma, lower, upper,
                      is_call: bool = True, knock: str = "out",
                      n_quad: int = 256) -> float:
    """Continuously-monitored double-barrier option under GBM, no rebate.

    Knock-out price = e^{−rT} ∫ payoff(S·eˣ) · q_m(x) dx over the corridor
    (Gauss-Legendre against the image-series corridor density
    `_corridor_density` — exact to quadrature/truncation precision, both
    far beyond f32). Knock-in via in-out parity against the vanilla, exact
    without rebates. The MC oracle for bridge-monitored double barriers
    (`ExoticEngine.price_double_barrier`) and the companion-leg CV mean.
    """
    from scipy.stats import norm

    S, K, T, L, U = map(float, (S, K, T, lower, upper))
    if not L < U:
        raise ValueError("double barrier needs lower < upper")
    st = sigma * np.sqrt(T)
    d1 = (np.log(S / K) + (r - q + 0.5 * sigma**2) * T) / st
    d2 = d1 - st
    if is_call:
        vanilla = (S * np.exp(-q * T) * norm.cdf(d1)
                   - K * np.exp(-r * T) * norm.cdf(d2))
    else:
        vanilla = (K * np.exp(-r * T) * norm.cdf(-d2)
                   - S * np.exp(-q * T) * norm.cdf(-d1))

    if S <= L or S >= U:          # starts through a barrier: knocked at t=0
        ko = 0.0
    else:
        lo, hi = np.log(L / S), np.log(U / S)
        m = r - q - 0.5 * sigma**2
        # Restrict to the in-the-money part of the corridor.
        k_log = np.log(K / S)
        a, b = (max(lo, k_log), hi) if is_call else (lo, min(hi, k_log))
        if a >= b:
            ko = 0.0
        else:
            nodes, weights = _leggauss(n_quad)
            x = 0.5 * (b - a) * nodes + 0.5 * (b + a)
            w = 0.5 * (b - a) * weights
            pay = (S * np.exp(x) - K) if is_call else (K - S * np.exp(x))
            dens = _corridor_density(x, lo, hi, m, sigma, T)
            ko = float(np.exp(-r * T) * np.sum(w * pay * dens))
    ko = min(max(ko, 0.0), vanilla if vanilla > 0 else ko)
    if knock == "out":
        return float(ko)
    return float(max(vanilla - ko, 0.0))     # in-out parity


def double_no_touch_bs(S, T, r, q, sigma, lower, upper,
                       n_quad: int = 256) -> float:
    """Double-no-touch digital under GBM: pays 1 at expiry iff the spot
    never leaves (lower, upper). Price = e^{−rT} · ∫ q_m(x) dx over the
    corridor (same image-series density as `double_barrier_bs`). The
    double-ONE-touch (pays on any touch, at expiry) is
    e^{−rT} − this."""
    S, T, L, U = map(float, (S, T, lower, upper))
    if S <= L or S >= U:
        return 0.0
    lo, hi = np.log(L / S), np.log(U / S)
    m = r - q - 0.5 * sigma**2
    nodes, weights = _leggauss(n_quad)
    x = 0.5 * (hi - lo) * nodes + 0.5 * (hi + lo)
    w = 0.5 * (hi - lo) * weights
    p_stay = float(np.sum(w * _corridor_density(x, lo, hi, m, sigma, T)))
    return float(np.exp(-r * T) * min(max(p_stay, 0.0), 1.0))


def window_barrier_bs(S, K, T, r, q, sigma, barrier, t1, t2,
                      is_call: bool = True, knock: str = "out",
                      direction: Optional[str] = None,
                      n_quad: int = 128, n_outer: int = 96,
                      barrier_lo=None) -> float:
    """Window (partial) barrier option under GBM, continuous monitoring
    restricted to [t1, t2] ⊆ [0, T]. Host f64.

    Decomposition over the three free/monitored/free legs:
        KO = e^{−r·t2} · E[ q_surv(x2 | x1; t2−t1) · V(S·e^{x2}) ],
    where x1 = log(S_{t1}/S) is free lognormal drift (Gauss-Hermite),
    q_surv is the single-barrier surviving sub-density over the window
    (the `_corridor_density` image series with the unmonitored side
    pushed far away), and V is the undiscounted-to-t2 European value
    BS(·, K, T−t2) (the payoff itself when t2 = T). A spot already
    through the barrier at t1 is knocked (the window's first monitored
    instant). Knock-in via in-out parity. Limits: (t1, t2) = (0, T)
    reproduces `barrier_bs` (test-pinned); t2 = t1 degenerates to the
    vanilla. The MC oracle for bridge-monitored window barriers
    (`ExoticEngine.price_barrier(window=)`).
    """
    from scipy.stats import norm

    S, K, T, B, t1, t2 = map(float, (S, K, T, barrier, t1, t2))
    if not 0.0 <= t1 <= t2 <= T:
        raise ValueError("window needs 0 <= t1 <= t2 <= T")
    if barrier_lo is not None and not float(barrier_lo) < B:
        raise ValueError("double window barrier needs barrier_lo < barrier")
    if direction is None:
        direction = "up" if B >= S else "down"
    st = sigma * np.sqrt(T)
    d1 = (np.log(S / K) + (r - q + 0.5 * sigma**2) * T) / st
    d2 = d1 - st
    if is_call:
        vanilla = (S * np.exp(-q * T) * norm.cdf(d1)
                   - K * np.exp(-r * T) * norm.cdf(d2))
    else:
        vanilla = (K * np.exp(-r * T) * norm.cdf(-d2)
                   - S * np.exp(-q * T) * norm.cdf(-d1))
    if knock == "in":
        ko = window_barrier_bs(S, K, T, r, q, sigma, B, t1, t2,
                               is_call=is_call, knock="out",
                               direction=direction,
                               n_quad=n_quad, n_outer=n_outer,
                               barrier_lo=barrier_lo)
        return float(max(vanilla - ko, 0.0))
    if t2 - t1 < 1e-12:
        return float(vanilla)
    if t1 < 1e-12 and T - t2 < 1e-12:
        if barrier_lo is not None:
            return double_barrier_bs(S, K, T, r, q, sigma,
                                     float(barrier_lo), B,
                                     is_call=is_call, knock="out")
        return barrier_bs(S, K, T, r, q, sigma, B, is_call=is_call,
                          knock="out", direction=direction)

    m = r - q - 0.5 * sigma**2
    tau = t2 - t1
    # Reachable-region half-width measured from the WINDOW START (x2 = 0),
    # drift included. Measuring the span from the barrier instead would
    # clip real probability mass whenever the barrier sits further than
    # ~12 step-stdevs from the start (far barrier x short window: the
    # windowed KO would price below the full-window KO). Barriers beyond
    # the span are unreachable, so the domain clips at ±span with
    # negligible image error (e^-144).
    span = 12.0 * sigma * np.sqrt(tau) + abs(m) * tau

    def euro_at_t2(s2):
        """Value at t2 of the now-unmonitored leg, discounted to t2."""
        if T - t2 < 1e-12:
            return (np.maximum(s2 - K, 0.0) if is_call
                    else np.maximum(K - s2, 0.0))
        tt = T - t2
        stt = sigma * np.sqrt(tt)
        dd1 = (np.log(s2 / K) + (r - q + 0.5 * sigma**2) * tt) / stt
        dd2 = dd1 - stt
        if is_call:
            return (s2 * np.exp(-q * tt) * norm.cdf(dd1)
                    - K * np.exp(-r * tt) * norm.cdf(dd2))
        return (K * np.exp(-r * tt) * norm.cdf(-dd2)
                - s2 * np.exp(-q * tt) * norm.cdf(-dd1))

    def window_leg(s1):
        """E[1(no touch in window)·V(S_{t2})] given S_{t1}=s1, disc to t2."""
        b = np.log(B / s1)
        if barrier_lo is not None:
            b_lo = np.log(float(barrier_lo) / s1)
            if b <= 0.0 or b_lo >= 0.0:   # outside the corridor at t1
                return 0.0
            lo, hi = max(b_lo, -span), min(b, span)
        elif direction == "up":
            if b <= 0.0:
                return 0.0            # at/through the barrier at t1
            lo, hi = -span, min(b, span)
        else:
            if b >= 0.0:
                return 0.0
            lo, hi = max(b, -span), span
        nodes, weights = _leggauss(n_quad)
        # Split panels at the payoff kink log(K/s1): as t2 -> T the
        # t2-value approaches the raw payoff and a single panel across
        # the kink converges only algebraically.
        x_k = np.log(K / s1)
        cuts = [lo] + ([x_k] if lo < x_k < hi else []) + [hi]
        total = 0.0
        for a_, b_ in zip(cuts[:-1], cuts[1:]):
            x = 0.5 * (b_ - a_) * nodes + 0.5 * (b_ + a_)
            w = 0.5 * (b_ - a_) * weights
            dens = _corridor_density(x, lo, hi, m, sigma, tau)
            total += float(np.sum(w * dens * euro_at_t2(s1 * np.exp(x))))
        return total

    if t1 < 1e-12:
        ko = np.exp(-r * t2) * window_leg(S)
    else:
        # Gauss-Hermite over the free lognormal leg to t1.
        h_nodes, h_w = _hermgauss(n_outer)
        x1 = m * t1 + sigma * np.sqrt(2.0 * t1) * h_nodes
        ko = np.exp(-r * t2) * float(np.sum(
            h_w / np.sqrt(np.pi)
            * np.array([window_leg(S * np.exp(v)) for v in x1])))
    return float(min(max(ko, 0.0), max(vanilla, 0.0)))


def window_no_touch_bs(S, T, r, q, sigma, barrier, t1, t2,
                       direction: Optional[str] = None, barrier_lo=None,
                       n_quad: int = 128, n_outer: int = 96) -> float:
    """Window no-touch digital under GBM: pays 1 at expiry T iff the spot
    does not touch the barrier (or, with `barrier_lo`, does not leave the
    corridor) during [t1, t2] ⊆ [0, T]. Host f64.

    Price = e^{−rT} · E[ P_surv_window(S_{t1}) ] — the same Gauss-Hermite ×
    image-series decomposition as `window_barrier_bs` with the post-window
    value ≡ 1. Full-window limits: `one_touch_bs` complement /
    `double_no_touch_bs` (test-pinned). The windowed ONE-touch (pays at
    expiry on any in-window touch) is e^{−rT} − this.
    """
    S, T, B, t1, t2 = map(float, (S, T, barrier, t1, t2))
    if not 0.0 <= t1 <= t2 <= T:
        raise ValueError("window needs 0 <= t1 <= t2 <= T")
    if direction is None:
        direction = "up" if B >= S else "down"
    if t2 - t1 < 1e-12:
        return float(np.exp(-r * T))
    m = r - q - 0.5 * sigma**2
    tau = t2 - t1
    # span measured from the window start, barriers clipped at +-span:
    # see the window_barrier_bs comment.
    span = 12.0 * sigma * np.sqrt(tau) + abs(m) * tau

    def stay_given(s1):
        b = np.log(B / s1)
        if barrier_lo is not None:
            b_lo = np.log(float(barrier_lo) / s1)
            if b <= 0.0 or b_lo >= 0.0:
                return 0.0
            lo, hi = max(b_lo, -span), min(b, span)
        elif direction == "up":
            if b <= 0.0:
                return 0.0
            lo, hi = -span, min(b, span)
        else:
            if b >= 0.0:
                return 0.0
            lo, hi = max(b, -span), span
        nodes, weights = _leggauss(n_quad)
        x = 0.5 * (hi - lo) * nodes + 0.5 * (hi + lo)
        w = 0.5 * (hi - lo) * weights
        return float(np.sum(w * _corridor_density(x, lo, hi, m, sigma, tau)))

    if t1 < 1e-12:
        stay = stay_given(S)
    else:
        h_nodes, h_w = _hermgauss(n_outer)
        x1 = m * t1 + sigma * np.sqrt(2.0 * t1) * h_nodes
        stay = float(np.sum(h_w / np.sqrt(np.pi)
                            * np.array([stay_given(S * np.exp(v))
                                        for v in x1])))
    return float(np.exp(-r * T) * min(max(stay, 0.0), 1.0))
