"""SVCJ dynamics: correlated jumps in price and variance
(counterpart of `mcos_tpu/ops/svcj.py`).

1. `svcj_terminal`: the differentiable torch twin of the JAX package's scan
   (a Python loop over steps), with antithetic pairing and the GBM companion
   control-variate leg. The step extends `_svj_step_core`'s full-truncation
   log-Euler scheme with the exponential variance jump Z_v = μ_v·E and the
   correlated price-jump mean μ_j + ρ_J·Z_v. Kernel K8
   (`cuda_kernels.svcj_terminal`, csrc/svcj.cu) runs the same recursion on
   the card from an in-kernel generator. The twin draws its exponential as
   −log1p(−u), the kernel as −log(u): the same law on another stream.

2. `svcj_cf` / `svcj_cos_price`: the semi-analytic oracle, host complex128,
   copied (tests/test_torch_copies.py holds it equal to the JAX package's).
   The SVCJ characteristic function is the Heston "little trap" CF times a
   jump transform whose time integral ∫₀ᵀ(𝔐(u, B(u,s)) − 1)ds is evaluated by
   Gauss-Legendre quadrature. 𝔐 is the joint jump MGF:
   E[e^{iu Z_s + B Z_v}] = e^{iuμ_j − u²σ_j²/2} / (1 − μ_v B − iu ρ_J μ_v).

One Poisson clock drives both jumps; the jump is applied at the end of each
Euler step (the O(dt) timing convention of `_svj_step_core`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mcos_tpu_torch.models.params import SVCJParams
from mcos_tpu_torch.ops.cos_pricer import (
    _cumulant_range,
    cos_expansion_from_phi,
)
from mcos_tpu_torch.ops.simulate import _companion, _f32, _safe_sqrt


def _svcj_step_core(params: SVCJParams, dt, sqrt_dt, log_s, v,
                    z1, z2, u_jump, z_js, e_v):
    """One full-truncation log-Euler SVCJ step.

    `e_v` is a standard Exp(1) draw; the variance jump is Z_v = μ_v·e_v.
    Antithetic convention: normals (z1, z2, z_js) negate across branches,
    jump-occurrence uniforms and exponential magnitudes are shared.
    """
    p = params
    v_pos = torch.clamp(v, min=0.0)
    sqrt_v = _safe_sqrt(v_pos)

    k_bar = (torch.exp(_f32(p.mu_j + 0.5 * p.sigma_j**2, v.device))
             / (1.0 - p.rho_j * p.mu_v) - 1.0)
    drift_comp = p.r - p.q - p.lambda_j * k_bar

    dw1 = z1 * sqrt_dt
    rho_perp = float(np.sqrt(np.float32(1.0 - p.rho * p.rho)))
    dw2 = p.rho * dw1 + rho_perp * z2 * sqrt_dt

    jump_ind = u_jump < p.lambda_j * dt
    z_v = p.mu_v * e_v
    jump_s = torch.where(jump_ind, p.mu_j + p.rho_j * z_v + p.sigma_j * z_js,
                         torch.zeros_like(z_js))

    log_s = log_s + (drift_comp - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump_s
    v = (v_pos + p.kappa * (p.theta - v_pos) * dt + p.xi * sqrt_v * dw2
         + torch.where(jump_ind, z_v, torch.zeros_like(z_v)))
    v = torch.clamp(v, min=0.0)
    return log_s, v


def svcj_terminal(
    params: SVCJParams, spot, T, generator: Optional[torch.Generator],
    num_paths: int, num_steps: int, antithetic: bool = True,
    companion: bool = False, *,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Terminal (S, v, G) under SVCJ, each (n_branch, num_paths); mirrors
    `simulate.simulate_terminal`.

    The companion G is the same constant-vol GBM leg riding dW₁ (its
    expectation is the BS(√v0) price: variance jumps never touch it, so it
    stays a valid control variate).

    Randoms: `generator`'s (steps, 3, paths) normals (z1, z2, z_js) then
    (steps, 2, paths) uniforms (jump occurrence; the exponential's), all up
    front, or `draws=(z, u)` of those shapes. Differentiable in spot and in
    the fields of `params` given as tensors.
    """
    if draws is not None:
        z, u = draws
        device = z.device
    else:
        device = torch.device(device)
        z = torch.randn((num_steps, 3, num_paths), generator=generator,
                        device=device, dtype=torch.float32)
        u = torch.rand((num_steps, 2, num_paths), generator=generator,
                       device=device, dtype=torch.float32)
    if (tuple(z.shape) != (num_steps, 3, num_paths)
            or tuple(u.shape) != (num_steps, 2, num_paths)):
        raise ValueError("draws must be (steps, 3, paths) normals and "
                         "(steps, 2, paths) uniforms")
    n_branch = 2 if antithetic else 1
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]

    log_s = torch.zeros((n_branch, num_paths), dtype=torch.float32,
                        device=device)
    log_g = log_s
    v = _f32(params.v0, device).expand(n_branch, num_paths)
    sigma_cv, g_drift = _companion(params, dt, device)
    for t in range(num_steps):
        z1 = z[t, 0] * sign
        e_v = -torch.log1p(-u[t, 1])[None, :]     # Exp(1), shared in the pair
        log_s, v = _svcj_step_core(params, dt, sqrt_dt, log_s, v, z1,
                                   z[t, 1] * sign, u[t, 0][None, :],
                                   z[t, 2] * sign, e_v)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
    return (spot * torch.exp(log_s), v,
            spot * torch.exp(log_g) if companion else None)


# ─────────────────────────────────────────────────────────────────────────────
# Semi-analytic oracle (host complex128, same design as ops/cos_pricer.py)
# ─────────────────────────────────────────────────────────────────────────────
def svcj_cf(u: np.ndarray, params: SVCJParams, T: float, spot: float,
            n_quad: int = 128) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] of the SVCJ model.

    Heston part: Albrecher "little trap" (identical to cos_pricer.bates_cf).
    Jump part: λ∫₀ᵀ(𝔐(u,B(u,s)) − 1)ds − iuλk̄T with the integral by
    Gauss-Legendre. As μ_v → 0 the transform collapses to the Merton term
    and the CF reduces exactly to bates_cf.
    """
    p = params
    kappa, theta, xi = float(p.kappa), float(p.theta), float(p.xi)
    rho, v0 = float(p.rho), float(p.v0)
    lam, mu_j, sig_j = float(p.lambda_j), float(p.mu_j), float(p.sigma_j)
    mu_v, rho_j = float(p.mu_v), float(p.rho_j)
    r, q = float(p.r), float(p.q)
    if rho_j * mu_v >= 1.0:
        raise ValueError(f"rho_j*mu_v={rho_j * mu_v:.3f} >= 1: "
                         "jump compensator diverges")

    u = np.asarray(u, np.complex128)
    iu = 1j * u

    beta = kappa - rho * xi * iu
    d = np.sqrt(beta**2 + xi**2 * (iu + u**2))
    g2 = (beta - d) / (beta + d)
    exp_dt = np.exp(-d * T)
    log_term = np.log((1.0 - g2 * exp_dt) / (1.0 - g2))
    C = (kappa * theta / xi**2) * ((beta - d) * T - 2.0 * log_term)
    D = ((beta - d) / xi**2) * (1.0 - exp_dt) / (1.0 - g2 * exp_dt)

    k_bar = np.exp(mu_j + 0.5 * sig_j**2) / (1.0 - rho_j * mu_v) - 1.0

    # ∫₀ᵀ (𝔐(u, B(u,s)) − 1) ds on Gauss-Legendre nodes; B(u,s) is the
    # Heston D-function at horizon s (the variance jump decays through the
    # same CIR ODE the diffusion does).
    nodes, weights = np.polynomial.legendre.leggauss(n_quad)
    s = 0.5 * T * (nodes + 1.0)                      # (n_quad,)
    w = 0.5 * T * weights
    exp_ds = np.exp(-d[None, :] * s[:, None])        # (n_quad, n_u)
    B = ((beta - d) / xi**2)[None, :] * (1.0 - exp_ds) \
        / (1.0 - g2[None, :] * exp_ds)
    mgf = np.exp(iu * mu_j - 0.5 * u**2 * sig_j**2)[None, :] \
        / (1.0 - mu_v * B - (iu * rho_j * mu_v)[None, :])
    integral = np.sum(w[:, None] * (mgf - 1.0), axis=0)
    jump = lam * integral - iu * lam * k_bar * T

    drift = iu * (np.log(spot) + (r - q) * T)
    return np.exp(drift + C + D * v0 + jump)


def svcj_cos_price(params: SVCJParams, spot: float, strikes, T: float,
                   is_call: bool = True, n_terms: int = 1024,
                   L: float = 14.0) -> np.ndarray:
    """European SVCJ prices via the COS expansion of `svcj_cf`.

    Truncation range: the SVJ cumulant formulas on an effective parameter
    set (θ_eff = θ + λμ_v/κ absorbs the variance-jump lift of E[v] and
    σ_j,eff² = σ_j² + ρ_J²μ_v² the price-jump variance of the ρ_J·Z_v
    term) with a wider safety factor (L=14) and more terms than the pure
    Bates default to cover the fatter tails.
    """
    p = params
    svj_eff = p.svj_part().replace(
        theta=float(p.theta) + float(p.lambda_j) * float(p.mu_v)
        / max(float(p.kappa), 1e-8),
        sigma_j=float(np.sqrt(float(p.sigma_j)**2
                              + (float(p.rho_j) * float(p.mu_v))**2)),
    )
    a, b = _cumulant_range(svj_eff, T, spot, L=L)
    u = np.arange(n_terms) * np.pi / (b - a)
    phi = svcj_cf(u, params, T, spot)
    return cos_expansion_from_phi(phi, a, b, spot, strikes, T,
                                  float(p.r), float(p.q), is_call)
