"""SVJ path simulation as plain torch programs
(counterpart of `mcos_tpu/ops/simulate.py`).

These are the port's twins of the JAX package's `lax.scan` programs: a
Python loop over steps carrying (log S/S0, v[, log G]) tensors, the same
full-truncation log-Euler step (`_svj_step_core`), the same antithetic
convention (normals negated, jump uniforms shared) and float32 throughout.

The PRNG-driven programs take an explicit `torch.Generator` and draw all
their randoms up front; their stream differs from the JAX package's
threefry keys, so they are pinned to it by law only. The draws-driven
`simulate_terminal_from_draws` is deterministic and pinned to f32 noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mcos_tpu_torch.models.params import SVJParams


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """√x with a zero (not ∞) derivative at x ≤ 0 (the double-where)."""
    safe = torch.clamp(x, min=1e-20)
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def _svj_step_core(params: SVJParams, dt, sqrt_dt, log_s, v, z1, z2, u_jump,
                   z_js):
    """One full-truncation log-Euler SVJ step shared by all simulators:
    v⁺ = max(v,0); dW₂ = ρ·dW₁ + √(1−ρ²)·Z₂√dt; compensated drift
    (r − q − λk − v⁺/2)dt; Bernoulli jump 1{U < λ·dt} with lognormal size
    μ_J + σ_J·Z. `dt`, `sqrt_dt` are float32 0-d tensors."""
    p = params
    v_pos = torch.clamp(v, min=0.0)
    sqrt_v = _safe_sqrt(v_pos)

    k = torch.exp(_f32(p.mu_j + 0.5 * p.sigma_j**2, v.device)) - 1.0
    drift_comp = (p.r - p.q) - p.lambda_j * k

    dw1 = z1 * sqrt_dt
    rho_perp = float(np.sqrt(np.float32(1.0 - p.rho * p.rho)))
    dw2 = p.rho * dw1 + rho_perp * z2 * sqrt_dt

    jump = torch.where(u_jump < p.lambda_j * dt, p.mu_j + p.sigma_j * z_js,
                       torch.zeros_like(z_js))

    log_s = log_s + (drift_comp - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump
    v = v_pos + p.kappa * (p.theta - v_pos) * dt + p.xi * sqrt_v * dw2
    v = torch.clamp(v, min=0.0)
    return log_s, v


def _companion(params: SVJParams, dt, device):
    """(σ_cv, per-step drift) of the GBM companion leg, σ_cv = √v0."""
    sigma_cv = torch.sqrt(_f32(params.v0, device))
    return sigma_cv, (params.r - params.q - 0.5 * sigma_cv**2) * dt


def simulate_terminal(
    params: SVJParams, spot, T, generator: torch.Generator, num_paths: int,
    num_steps: int, antithetic: bool = True, companion: bool = False,
    *, device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Simulate SVJ paths with `generator`'s draws; terminal (S, v, G).

    Returns (n_branch, num_paths) tensors: row 0 base, row 1 antithetic;
    G (the σ=√v0 GBM companion on the same dW₁) only when `companion`.
    """
    device = torch.device(device)
    n_branch = 2 if antithetic else 1
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    z = torch.randn((num_steps, 3, num_paths), generator=generator,
                    device=device, dtype=torch.float32)
    u = torch.rand((num_steps, num_paths), generator=generator,
                   device=device, dtype=torch.float32)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]
    log_s = torch.zeros((n_branch, num_paths), dtype=torch.float32,
                        device=device)
    log_g = torch.zeros_like(log_s)
    v = torch.full_like(log_s, float(np.float32(params.v0)))
    sigma_cv, g_drift = _companion(params, dt, device)
    for t in range(num_steps):
        z1 = z[t, 0] * sign
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z1,
                                  z[t, 1] * sign, u[t][None, :],
                                  z[t, 2] * sign)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
    return (spot * torch.exp(log_s), v,
            spot * torch.exp(log_g) if companion else None)


def simulate_terminal_from_draws(
    params: SVJParams, spot, T, z1: torch.Tensor, z2: torch.Tensor,
    u_jump: torch.Tensor, z_js: torch.Tensor, companion: bool = False,
    steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Simulate with externally supplied randoms (QMC driver / CRN oracles).

    z1, z2, z_js, u_jump: (num_paths, num_steps), or (num_steps, num_paths)
    with `steps_major=True`. Returns (S, v, G or None), each (num_paths,).
    """
    if not steps_major:
        z1, z2, u_jump, z_js = z1.T, z2.T, u_jump.T, z_js.T
    num_steps, num_paths = z1.shape
    device = z1.device
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    log_s = torch.zeros(num_paths, dtype=torch.float32, device=device)
    log_g = torch.zeros_like(log_s)
    v = torch.full_like(log_s, float(np.float32(params.v0)))
    sigma_cv, g_drift = _companion(params, dt, device)
    for t in range(num_steps):
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z1[t], z2[t],
                                  u_jump[t], z_js[t])
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1[t] * sqrt_dt
    return (spot * torch.exp(log_s), v,
            spot * torch.exp(log_g) if companion else None)


def simulate_paths_recorded(
    params: SVJParams, spot, T, generator: torch.Generator, num_paths: int,
    num_steps: int, *, device="cpu",
) -> torch.Tensor:
    """Record full paths for visualization (≤ O(100) paths).

    Returns (num_paths, num_steps + 1) spots, column 0 = spot.
    """
    device = torch.device(device)
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    z = torch.randn((num_steps, 3, num_paths), generator=generator,
                    device=device, dtype=torch.float32)
    u = torch.rand((num_steps, num_paths), generator=generator,
                   device=device, dtype=torch.float32)
    log_s = torch.zeros(num_paths, dtype=torch.float32, device=device)
    v = torch.full_like(log_s, float(np.float32(params.v0)))
    rows = []
    for t in range(num_steps):
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z[t, 0],
                                  z[t, 1], u[t], z[t, 2])
        rows.append(log_s)
    paths = spot * torch.exp(torch.stack(rows, dim=1))
    return torch.cat([spot.expand(num_paths, 1), paths], dim=1)


def vanilla_payoff(s_final: torch.Tensor, strike, is_call: bool
                   ) -> torch.Tensor:
    """European payoff max(±(S−K), 0)."""
    if is_call:
        return torch.clamp(s_final - strike, min=0.0)
    return torch.clamp(strike - s_final, min=0.0)


def combine_antithetic(payoffs: torch.Tensor) -> torch.Tensor:
    """Average payoff branches pairwise: (n_branch, n_paths) → (n_paths,)."""
    return torch.mean(payoffs, dim=0)


def mc_mean_stderr(values: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and standard error over the path axis (population std / √n)."""
    n = values.shape[-1]
    mean = torch.mean(values, dim=-1)
    std = torch.std(values, dim=-1, correction=0)
    return mean, std / float(np.sqrt(np.float32(n), dtype=np.float32))
