r"""Rough Heston: the fractional-Riccati COS oracle and the multi-factor
lifted Monte Carlo (counterpart of `mcos_tpu/ops/roughheston.py`).

Rough Heston keeps Heston's CIR mean reversion and drives it through the
fractional kernel

    v_t = v0 + (1/Gamma(alpha)) * int_0^t (t-s)^(alpha-1)
              [ lam*(theta - v_s) ds + nu*sqrt(v_s) dB_s ],
    dS/S = (r - q) dt + sqrt(v_t) dW1,   d<W1, B> = rho dt,

with alpha = H + 1/2. At H = 1/2 the kernel is constant and the model is
classical Heston. Two routes to the same law:

1. **The exact CF (host complex128, copied unchanged).** El Euch-Rosenbaum:
   the CF of ln S_T solves through the fractional Riccati equation
   D^alpha h = F(u, h), solved by the fractional Adams predictor-corrector
   over the whole COS u-grid at once; the COS truncation interval comes
   from cumulants read off the CF itself.
2. **The lifted Monte Carlo (torch, on the device).** The power kernel is
   an exponential sum, K(t) ~= sum_i c_i exp(-x_i t) (`lifted_kernel_nodes`),
   so the variance is an n-factor state

       v = max(v0 + sum_i c_i V_i, 0),
       V_i <- (V_i + dt*lam*(theta - v) + nu*sqrt(v)*dB)/(1 + x_i dt),

   one semi-implicit Euler step a step of the loop over a
   (n_factors, branch, paths) factor block. Antithetic pairs and the GBM
   companion leg on the same dW1 follow `ops/simulate.py`.

No TPU kernel computes this law (the JAX package runs it as `lax.scan`),
so the lifted loop is torch ops: no file of `csrc/` is on this path.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu_torch.ops.cos_pricer import cos_expansion_from_phi
from mcos_tpu_torch.ops.simulate import _f32, _safe_sqrt
from mcos_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class RoughHestonParams:
    """Rough Heston parameters, the JAX package's fields one for one.
    `hurst` is static (it shapes the host-side Adams weights and the
    lifted-kernel fit); lam, theta, nu, rho and v0 may be 0-d tensors
    (autograd leaves) or (M,) tensors (a member axis on shared draws)."""

    lam: float = 1.5        # mean-reversion speed (kappa of the rough CIR)
    theta: float = 0.04     # long-run variance
    nu: float = 0.35        # vol-of-vol on the fractional kernel
    rho: float = -0.7       # spot/vol correlation
    v0: float = 0.04        # initial variance
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    hurst: float = dataclasses.field(default=0.1,
                                     metadata={"static": True})

    def replace(self, **updates) -> "RoughHestonParams":
        return dataclasses.replace(self, **updates)


# ─────────────────────────────────────────────────────────────────────────────
# Fractional Riccati CF (host complex128): the exact oracle, copied
# ─────────────────────────────────────────────────────────────────────────────
def _riccati_rhs(u: np.ndarray, h: np.ndarray, lam: float, nu: float,
                 rho: float) -> np.ndarray:
    """F(u, h) of the rough-Heston Riccati (classical Heston RHS)."""
    iu = 1j * u
    return -0.5 * (u * u + iu) + (iu * rho * nu - lam) * h \
        + 0.5 * nu * nu * h * h


def rough_heston_h(u: np.ndarray, params: RoughHestonParams, T: float,
                   n_steps: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """Solve D^alpha h = F(u, h), h(0) = 0 on [0, T] for a vector of u.

    Fractional Adams predictor-corrector (Diethelm-Ford-Freed), error
    O(dt^(1+alpha)). Both weight families depend only on the lag k - j, so
    each step is one complex dot over the stored F-history, vectorized
    across the whole u grid. Returns (h, Fh), each (n_steps+1, n_u).
    """
    alpha = float(params.hurst) + 0.5
    lam, nu, rho = float(params.lam), float(params.nu), float(params.rho)
    u = np.asarray(u, np.complex128)
    n_u = u.shape[0]
    N = int(n_steps)
    dt = T / N

    m = np.arange(N + 1, dtype=np.float64)
    # Predictor (rectangle) weights b_m and corrector (trapezoid) lag
    # weights a_m, both indexed by lag m = k - j.
    b = (dt ** alpha / alpha) * ((m + 1.0) ** alpha - m ** alpha)
    a = (dt ** alpha / (alpha * (alpha + 1.0))) * (
        (m + 2.0) ** (alpha + 1.0) + m ** (alpha + 1.0)
        - 2.0 * (m + 1.0) ** (alpha + 1.0))
    a_new = dt ** alpha / (alpha * (alpha + 1.0))   # weight of F(h_pred)
    inv_gamma = 1.0 / math.gamma(alpha)

    h = np.zeros((N + 1, n_u), np.complex128)
    Fh = np.zeros((N + 1, n_u), np.complex128)
    Fh[0] = _riccati_rhs(u, h[0], lam, nu, rho)

    ks = np.arange(N, dtype=np.float64)
    # j = 0 corrector weight is the one lag-dependent exception.
    a0 = (dt ** alpha / (alpha * (alpha + 1.0))) * (
        ks ** (alpha + 1.0) - (ks - alpha) * (ks + 1.0) ** alpha)

    # Overflow at coarse N is handled by the caller's step-doubling guard
    # (rough_heston_cos_price): silence the warning, propagate the nan.
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(N):
            hist = Fh[:k + 1]                        # (k+1, n_u)
            pred = inv_gamma * (b[k::-1][:, None] * hist).sum(axis=0)
            f_pred = _riccati_rhs(u, pred, lam, nu, rho)
            if k == 0:
                lag_sum = np.zeros(n_u, np.complex128)
            else:
                lag_sum = (a[k - 1::-1][:, None] * Fh[1:k + 1]).sum(axis=0)
            h[k + 1] = inv_gamma * (a0[k] * Fh[0] + lag_sum + a_new * f_pred)
            Fh[k + 1] = _riccati_rhs(u, h[k + 1], lam, nu, rho)
    return h, Fh


def rough_heston_cf(u: np.ndarray, params: RoughHestonParams, T: float,
                    spot: float, n_steps: int = 256) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] of the rough Heston model.

    log phi = iu(ln S0 + (r-q)T) + theta*lam*I^1 h(T) + v0*I^(1-alpha)h(T).
    I^1 by trapezoid; I^(1-alpha) by the product-trapezoid rule
    (piecewise-linear h integrated exactly against the kernel).
    """
    alpha = float(params.hurst) + 0.5
    r, q, v0 = float(params.r), float(params.q), float(params.v0)
    theta, lam = float(params.theta), float(params.lam)
    u = np.asarray(u, np.complex128)
    N = int(n_steps)
    dt = T / N

    h, _ = rough_heston_h(u, params, T, n_steps=N)

    # I^1 h(T): trapezoid (h is smooth away from 0; h(0)=0).
    i1 = dt * (h.sum(axis=0) - 0.5 * (h[0] + h[-1]))

    # I^(1-alpha) h(T) with gam = 1 - alpha: product-trapezoid weights
    # w_j over the full grid (w_0 multiplies h_0 = 0, dropped).
    gam = 1.0 - alpha
    j = np.arange(1, N, dtype=np.float64)
    w_mid = ((N - j + 1.0) ** (gam + 1.0) - 2.0 * (N - j) ** (gam + 1.0)
             + (N - j - 1.0) ** (gam + 1.0))
    i_frac = (dt ** gam / math.gamma(gam + 2.0)) * (
        (w_mid[:, None] * h[1:N]).sum(axis=0) + h[N])

    log_phi = 1j * u * (np.log(spot) + (r - q) * T) \
        + theta * lam * i1 + v0 * i_frac
    return np.exp(log_phi)


def _cf_cumulant_range(params: RoughHestonParams, T: float, spot: float,
                       L: float = 13.0, n_steps: int = 160):
    """Self-calibrating COS truncation interval [a, b] for ln S_T.

    Re log phi(u) = -u^2 c2/2 + u^4 c4/24 + O(u^6): two small real nodes
    (eps, 2 eps) give (c2, c4) by a 2x2 solve, and c1 = Im log phi(eps)/eps
    to O(eps^2); eps targets c2 * eps^2 ~ 1e-2.
    """
    var_guess = max(float(params.v0), float(params.theta), 1e-4) * T
    eps = 0.1 / math.sqrt(var_guess)
    # Centered CF (spot=1) so log's principal branch is safe.
    phi = rough_heston_cf(np.array([eps, 2.0 * eps]), params, T, 1.0,
                          n_steps=n_steps)
    lp = np.log(phi)
    r1, r2 = float(lp[0].real), float(lp[1].real)
    # r1 = -e^2 c2/2 + e^4 c4/24 ; r2 = -4 e^2 c2/2 + 16 e^4 c4/24.
    c2 = (16.0 * r1 - r2) / (-6.0 * eps ** 2)
    c4 = (r2 - 4.0 * r1) * (2.0 / eps ** 4)
    c1 = float(lp[0].imag) / eps + math.log(spot)
    c2 = max(c2, 1e-8)
    half = L * math.sqrt(c2 + math.sqrt(max(c4, 0.0)))
    return c1 - half, c1 + half


def rough_heston_cos_price(params: RoughHestonParams, spot: float, strikes,
                           T: float, is_call: bool = True,
                           n_terms: int = 384, L: float = 13.0,
                           n_steps: int = 256) -> np.ndarray:
    """European rough-Heston prices via the COS expansion of the CF.

    Adams-step guard: at coarse n_steps the predictor's h^2 term can
    overflow at the largest u nodes; on any non-finite phi the solve
    retries with doubled steps, three times, then raises
    FloatingPointError.
    """
    a, b = _cf_cumulant_range(params, T, spot, L=L,
                              n_steps=max(n_steps // 2, 96))
    u = np.arange(n_terms) * np.pi / (b - a)
    N = int(n_steps)
    for _ in range(3):
        phi = rough_heston_cf(u, params, T, spot, n_steps=N)
        if np.all(np.isfinite(phi)):
            break
        N *= 2
    else:
        raise FloatingPointError(
            "rough_heston_cf did not stabilize; raise n_steps")
    return cos_expansion_from_phi(phi, a, b, spot, strikes, T,
                                  float(params.r), float(params.q), is_call)


# ─────────────────────────────────────────────────────────────────────────────
# Lifted (multi-factor) kernel fit: host, cached, copied
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=64)
def lifted_kernel_nodes(hurst: float, T: float, resolution: float,
                        n_factors: int = 24) -> Tuple[Tuple[float, ...],
                                                      Tuple[float, ...]]:
    """Moment-matched (c_i, x_i) with K(t) ~= sum_i c_i e^{-x_i t}.

    The x-axis is cut into a zeroth cell [0, eta_0] (the quasi-constant
    slow mass) plus a geometric grid over [0.02/T, 20/resolution]; per
    cell c_i = int mu(dx) and x_i = (1/c_i) int x mu(dx). Sup relative
    error on [resolution, T] below 0.8 % for H in [0.05, 0.4] at the
    default 24 factors (`lifted_kernel_error`).

    `resolution` is the finest time scale the lifted model resolves, a
    model constant rather than the simulation dt. H = 1/2 degenerates to
    the constant kernel: one factor (c, x) = (1, 0).
    """
    h = float(hurst)
    if abs(h - 0.5) < 1e-12:
        return (1.0,), (0.0,)
    alpha = h + 0.5
    n = int(n_factors)
    eta = np.concatenate([[0.0],
                          np.geomspace(0.02 / T, 20.0 / resolution, n)])
    norm = math.gamma(alpha) * math.gamma(1.0 - alpha)
    p0 = 1.0 - alpha                       # int x^-alpha = x^p0 / p0
    p1 = 2.0 - alpha
    c = (eta[1:] ** p0 - eta[:-1] ** p0) / (p0 * norm)
    x = (p0 / p1) * (eta[1:] ** p1 - eta[:-1] ** p1) \
        / (eta[1:] ** p0 - eta[:-1] ** p0)
    return tuple(float(v) for v in c), tuple(float(v) for v in x)


def lifted_kernel_error(hurst: float, T: float, resolution: float,
                        n_factors: int = 24) -> float:
    """Sup relative error of the exponential-sum kernel on [resolution, T]."""
    c, x = lifted_kernel_nodes(hurst, T, resolution, n_factors)
    t = np.geomspace(resolution, T, 400)
    k_exact = t ** (hurst - 0.5) / math.gamma(hurst + 0.5)
    k_hat = (np.asarray(c)[:, None]
             * np.exp(-np.asarray(x)[:, None] * t[None, :])).sum(axis=0)
    return float(np.max(np.abs(k_hat - k_exact) / k_exact))


# ─────────────────────────────────────────────────────────────────────────────
# Lifted Monte Carlo: a torch step loop over the factor block
# ─────────────────────────────────────────────────────────────────────────────
def _leaf(x, device) -> torch.Tensor:
    """A parameter as a float32 tensor: a (M,) member axis → (M, 1, 1), so
    it broadcasts against (branch, paths); anything else as it is."""
    x = _f32(x, device)
    return x.reshape(-1, 1, 1) if x.dim() == 1 else x


@spans.traced("program.lifted")
def lifted_terminal(
    params: RoughHestonParams,
    spot,
    T,
    generator: Optional[torch.Generator],
    c_weights,
    x_nodes,
    *,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = False,
    remat_chunk: int = 0,
    draws: Optional[torch.Tensor] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Terminal (S, v, G) under lifted rough Heston, (…, branch, paths).

    State per path: log-spot and the (n_factors, …, branch, paths) factor
    block V; one semi-implicit Euler step a step (module docstring). The
    companion G is the constant-vol GBM leg on the same dW1 with
    sigma = sqrt(v0): E[G-payoff] is the BS(sqrt(v0)) price.

    A (M,) tensor in lam, theta, nu, rho or v0 gives every carry a leading
    member axis: M parameter sets on one set of normals.

    Randoms: `draws` (steps, 2, paths) normals (row 0 drives dW1, row 1
    the orthogonal part of dB), else one step's (2, paths) drawn from
    `generator` at a time, so no more than a step of randoms is held.

    The factor sum is one contraction over the factor axis. Where
    autograd records nothing (forward prices, a delta whose spot enters
    only after the loop) the factor block is updated in place. Where it
    records (a leaf of `params` or T that requires grad), the update is
    out of place, and `remat_chunk` > 0 runs each chunk of that many steps
    under `torch.utils.checkpoint` (non-reentrant) on normals drawn before
    the chunk: autograd then keeps only the chunk boundaries' carries.
    """
    device = draws.device if draws is not None else torch.device(device)
    if draws is not None and tuple(draws.shape) != (num_steps, 2, num_paths):
        raise ValueError(f"draws must be ({num_steps}, 2, {num_paths}) "
                         "normals")
    n_branch = 2 if antithetic else 1
    T_f = _f32(T, device)
    dt = T_f / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]

    v0, lam, theta, nu, rho = (_leaf(getattr(params, k), device)
                               for k in ("v0", "lam", "theta", "nu", "rho"))
    r, q = params.r, params.q
    rho_perp = torch.sqrt(1.0 - rho * rho)
    state = torch.broadcast_shapes(v0.shape, lam.shape, theta.shape,
                                   nu.shape, rho.shape,
                                   (n_branch, num_paths))
    c = _f32(c_weights, device)
    damp = (1.0 / (1.0 + _f32(x_nodes, device) * dt)).reshape(
        -1, *([1] * len(state)))
    sigma_cv = torch.sqrt(v0)
    g_drift = (r - q - 0.5 * v0) * dt
    recording = torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for x in (T, *(getattr(params, f.name)
                       for f in dataclasses.fields(params))))

    def factor_sum(v_fac):
        return torch.clamp(v0 + torch.tensordot(c, v_fac, dims=1), min=0.0)

    def step(log_s, v_fac, log_g, z):
        z1 = z[0] * sign                          # spot driver
        zv = rho * z1 + rho_perp * (z[1] * sign)  # variance driver dB
        v_pos = factor_sum(v_fac)
        sqrt_v = _safe_sqrt(v_pos)
        shock = lam * (theta - v_pos) * dt + nu * sqrt_v * zv * sqrt_dt
        if recording:
            v_fac = (v_fac + shock) * damp
        else:
            v_fac.add_(shock).mul_(damp)
        log_s = log_s + (r - q - 0.5 * v_pos) * dt + sqrt_v * z1 * sqrt_dt
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        return log_s, v_fac, log_g

    def draw(t):
        if draws is not None:
            return draws[t]
        return torch.randn((2, num_paths), generator=generator,
                           device=device, dtype=torch.float32)

    log_s = torch.zeros(state, dtype=torch.float32, device=device)
    v_fac = torch.zeros((c.shape[0], *state), dtype=torch.float32,
                        device=device)
    log_g = torch.zeros_like(log_s)
    if recording and remat_chunk:
        if num_steps % remat_chunk:
            raise ValueError(f"num_steps={num_steps} not a multiple of "
                             f"remat_chunk={remat_chunk}")

        def chunk(log_s, v_fac, log_g, z):
            for k in range(z.shape[0]):
                log_s, v_fac, log_g = step(log_s, v_fac, log_g, z[k])
            return log_s, v_fac, log_g

        for start in range(0, num_steps, remat_chunk):
            z = torch.stack([draw(t)
                             for t in range(start, start + remat_chunk)])
            log_s, v_fac, log_g = checkpoint(chunk, log_s, v_fac, log_g, z,
                                             use_reentrant=False)
    else:
        for t in range(num_steps):
            log_s, v_fac, log_g = step(log_s, v_fac, log_g, draw(t))
    v_final = factor_sum(v_fac)
    spot = _f32(spot, device)    # a float32 leaf on `device` as it is
    return (spot * torch.exp(log_s), v_final,
            spot * torch.exp(log_g) if companion else None)
