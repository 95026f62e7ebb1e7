r"""Heston-Hull-White hybrid: stochastic volatility and stochastic rates
(counterpart of `mcos_tpu/ops/hhw.py`).

    dS/S = (r_t - q) dt + sqrt(v_t) dW1
    dv   = kappa (theta - v) dt + xi sqrt(v) dW2      (Heston, full trunc.)
    dr   = a (b - r) dt + sigma_r dW3                 (Vasicek/Hull-White)

with a full 3x3 correlation (rho_sv, rho_sr, rho_vr; Cholesky-mixed).

`hhw_terminal` is the differentiable torch twin of the JAX package's scan:
a Python loop over steps carrying (log S/S0, v, r, \int r dt). The rate
steps with the exact Ornstein-Uhlenbeck transition, the money-market
integral takes the left point (so D*S_T is an exact discrete martingale),
and antithetic branches negate all three normals. Kernel K7
(`cuda_kernels.hhw_terminal`, csrc/hhw.cu) runs the same recursion on the
card from an in-kernel generator.

The 3x3 Cholesky factor is computed on the host in float64
(`hhw_cholesky`) and raises `ValueError` for a correlation matrix that is
not positive definite. Each of the three correlations may lie in
(-1, 1) and the matrix still fail (rho_sv = -0.999, rho_sr = rho_vr =
0.999); the JAX package's `jnp.linalg.cholesky` then returns NaN silently
and every path is NaN.

Closed forms (host float64, copied; tests/test_torch_copies.py holds them
equal to the JAX package's):
  * vasicek_bond:     P(0,T) = A(T) e^{-B(T) r0}
  * bsm_hullwhite:    European option under GBM + Vasicek rates via the
    T-forward measure: Black on F = S0 e^{-qT} / P(0,T) with total
    variance  V = sig_s^2 T + 2 rho_sr sig_s sig_r (T - B)/a
               + sig_r^2 (T - 2B + B2)/a^2,
    B = (1-e^{-aT})/a, B2 = (1-e^{-2aT})/(2a).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from scipy.stats import norm

from mcos_tpu_torch.config import DIVIDEND_YIELD
from mcos_tpu_torch.ops.simulate import _f32, _safe_sqrt


@dataclasses.dataclass(frozen=True)
class HHWParams:
    """Heston-Hull-White parameters (no jumps: the hybrid targets the
    long-dated regime where rate vol, not jump risk, drives the smile).
    Fields are plain floats; the Greeks' autograd pass replaces v0, sigma_r
    and r0 by 0-d tensors."""

    # Heston block
    kappa: float = 3.0
    theta: float = 0.04
    xi: float = 0.5
    v0: float = 0.04
    # Hull-White block
    a: float = 0.1          # rate mean-reversion speed
    b: float = 0.05         # long-run short rate
    sigma_r: float = 0.01   # absolute rate vol
    r0: float = 0.05        # initial short rate
    # correlations
    rho_sv: float = -0.7
    rho_sr: float = 0.3
    rho_vr: float = 0.0
    q: float = DIVIDEND_YIELD

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """{field: 0-d float64 array}: how parameters cross packages."""
        return {f.name: np.asarray(float(getattr(self, f.name)), np.float64)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, values: Mapping[str, object]) -> "HHWParams":
        """Build from a {field: number or 0-d array} mapping (every field)."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = [n for n in names if n not in values]
        if missing:
            raise KeyError(f"missing HHW fields: {missing}")
        return cls(**{n: float(np.asarray(values[n])) for n in names})


def hhw_cholesky(p: HHWParams) -> np.ndarray:
    """Lower Cholesky factor of the (spot, variance, rate) correlation
    matrix, float64 on the host. Raises ValueError naming the three
    correlations when the matrix is not positive definite."""
    sv, sr, vr = float(p.rho_sv), float(p.rho_sr), float(p.rho_vr)
    corr = np.array([[1.0, sv, sr], [sv, 1.0, vr], [sr, vr, 1.0]])
    try:
        chol = np.linalg.cholesky(corr)
    except np.linalg.LinAlgError:
        chol = None
    if chol is None or not np.isfinite(chol).all():
        raise ValueError(
            f"correlation matrix of rho_sv={sv}, rho_sr={sr}, rho_vr={vr} "
            "is not positive definite")
    return chol


# ─────────────────────────────────────────────────────────────────────────────
# Closed forms (host f64)
# ─────────────────────────────────────────────────────────────────────────────
def vasicek_bond(p: HHWParams, T: float) -> float:
    """Zero-coupon bond P(0, T) under the Vasicek short rate."""
    a, b, s = float(p.a), float(p.b), float(p.sigma_r)
    B = (1.0 - np.exp(-a * T)) / a
    A = np.exp((b - s**2 / (2 * a**2)) * (B - T) - s**2 * B**2 / (4 * a))
    return float(A * np.exp(-B * float(p.r0)))


def bsm_hullwhite(p: HHWParams, spot: float, strike: float, T: float,
                  sigma_s: float, is_call: bool = True) -> float:
    """European option under GBM(sigma_s) + Vasicek rates, exact.

    T-forward-measure Black formula; the derivation in the module header.
    The spot/rate correlation `p.rho_sr` enters the total variance.
    """
    a, s_r = float(p.a), float(p.sigma_r)
    P = vasicek_bond(p, T)
    B = (1.0 - np.exp(-a * T)) / a
    B2 = (1.0 - np.exp(-2.0 * a * T)) / (2.0 * a)
    V = (sigma_s**2 * T
         + 2.0 * float(p.rho_sr) * sigma_s * s_r * (T - B) / a
         + s_r**2 * (T - 2.0 * B + B2) / a**2)
    F = spot * np.exp(-float(p.q) * T) / P
    sv = np.sqrt(max(V, 1e-16))
    d1 = (np.log(F / strike) + 0.5 * V) / sv
    d2 = d1 - sv
    call = P * (F * norm.cdf(d1) - strike * norm.cdf(d2))
    if is_call:
        return float(call)
    return float(call - P * (F - strike))   # forward-measure parity


# ─────────────────────────────────────────────────────────────────────────────
# Simulation: one step loop, exact OU rate stepping
# ─────────────────────────────────────────────────────────────────────────────
def hhw_terminal(p: HHWParams, spot, T, generator: Optional[torch.Generator],
                 *, num_paths: int, num_steps: int, antithetic: bool = True,
                 draws: Optional[torch.Tensor] = None, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(branches, paths) terminal spots and pathwise discount factors
    exp(-\\int r dt); the differentiable torch twin.

    The money-market integral uses the left-point rule, matching the
    left-point r in the log-spot drift: the r terms then cancel pathwise
    in D*S_T, making the discounted spot an exact discrete martingale
    (E[D S_T] = S0 e^{-qT} to float32 noise at any step count). The bond
    E[D] carries the O(dt) left-point bias instead.

    Randoms: `generator`'s (steps, 3, paths) independent normals, all up
    front, or `draws=` of that shape; the Cholesky factor mixes them.
    Differentiable in spot and in the fields of `p` given as tensors (v0,
    sigma_r, r0, ...); the correlations and `a` must be floats.
    """
    if draws is not None:
        z_all = draws
        device = z_all.device
    else:
        device = torch.device(device)
        z_all = torch.randn((num_steps, 3, num_paths), generator=generator,
                            device=device, dtype=torch.float32)
    if tuple(z_all.shape) != (num_steps, 3, num_paths):
        raise ValueError("draws must be (steps, 3, paths) normals")
    chol = hhw_cholesky(p).astype(np.float32)
    l21, l22 = float(chol[1, 0]), float(chol[1, 1])
    l31, l32, l33 = float(chol[2, 0]), float(chol[2, 1]), float(chol[2, 2])
    n_branch = 2 if antithetic else 1
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]

    # Exact OU transition: r' = b + (r-b) e^{-a dt} + s_ou z,
    # s_ou^2 = sigma_r^2 (1 - e^{-2 a dt}) / (2a).
    e_adt = torch.exp(-float(p.a) * dt)
    s_ou = p.sigma_r * torch.sqrt((1.0 - e_adt**2)
                                  / max(2.0 * float(p.a), 1e-12))

    shape = (n_branch, num_paths)
    log_s = torch.zeros(shape, dtype=torch.float32, device=device)
    int_r = torch.zeros_like(log_s)
    v = _f32(p.v0, device).expand(shape)
    r = _f32(p.r0, device).expand(shape)
    for t in range(num_steps):
        z = z_all[t]
        z1 = z[0][None] * sign
        z2 = (l21 * z[0] + l22 * z[1])[None] * sign
        z3 = (l31 * z[0] + l32 * z[1] + l33 * z[2])[None] * sign
        v_pos = torch.clamp(v, min=0.0)
        sqrt_v = _safe_sqrt(v_pos)  # zero (not inf) derivative at v = 0
        log_s = log_s + ((r - p.q - 0.5 * v_pos) * dt + sqrt_v * z1 * sqrt_dt)
        v = torch.clamp(v_pos + p.kappa * (p.theta - v_pos) * dt
                        + p.xi * sqrt_v * z2 * sqrt_dt, min=0.0)
        int_r = int_r + r * dt                              # left-point
        r = p.b + (r - p.b) * e_adt + s_ou * z3
    return spot * torch.exp(log_s), torch.exp(-int_r)
