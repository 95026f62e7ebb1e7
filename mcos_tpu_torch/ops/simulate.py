"""SVJ path simulation as plain torch programs
(counterpart of `mcos_tpu/ops/simulate.py`).

These are the port's twins of the JAX package's `lax.scan` programs: a
Python loop over steps carrying (log S/S0, v[, log G]) tensors, the same
full-truncation log-Euler step (`_svj_step_core`) and Andersen QE step
(`qe_variance_step`), the same antithetic convention (normals negated, uniforms
shared) and float32 throughout.

The PRNG-driven programs (`simulate_terminal`, `simulate_terminal_qe`,
`simulate_terminal_tilted`) take an explicit `torch.Generator` and draw
all their randoms up front; their stream differs from the JAX package's
threefry keys, so they are pinned to it by law only. The draws-driven
`simulate_terminal_from_draws` and `simulate_terminal_qe_from_draws` are
deterministic and pinned to f32 noise.

The two visualisation programs of `/api/price`, `simulate_paths_recorded`
and `simulate_terminal_samples`, draw the same way and then run their
whole step loop as one launch of `cuda_kernels.svj_viz` on a CUDA device;
on the CPU that wrapper runs the loops here (`recorded_from_draws`,
`simulate_terminal`).

`simulate_terminal_with_score` and `simulate_terminal_members` feed the
Greeks engine: they take a generator or the draws themselves, are
differentiable in every parameter given as a tensor (floats keep the
float32-rounded constants every other twin uses), and run under
`torch.utils.checkpoint` in chunks of REMAT_CHUNK steps when autograd
records them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
    if isinstance(p.rho, torch.Tensor):    # an autograd leaf: ∂/∂ρ flows
        rho_perp = torch.sqrt(1.0 - p.rho * p.rho)
    else:
        rho_perp = float(np.sqrt(np.float32(1.0 - p.rho * p.rho)))
    dw2 = p.rho * dw1 + rho_perp * z2 * sqrt_dt

    jump = torch.where(u_jump < p.lambda_j * dt, p.mu_j + p.sigma_j * z_js,
                       torch.zeros_like(z_js))

    log_s = log_s + (drift_comp - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump
    v = v_pos + p.kappa * (p.theta - v_pos) * dt + p.xi * sqrt_v * dw2
    v = torch.clamp(v, min=0.0)
    return log_s, v


def _v0_like(v0, like: torch.Tensor) -> torch.Tensor:
    """The variance carry's start: v0 over `like`'s shape. A tensor v0 (an
    autograd leaf, maybe with a leading member axis) broadcasts and keeps
    its graph; a float fills at its float32 rounding."""
    if isinstance(v0, torch.Tensor):
        return torch.zeros_like(like) + v0
    return torch.full_like(like, float(np.float32(v0)))


def _companion(params: SVJParams, dt, device):
    """(σ_cv, per-step drift) of the GBM companion leg, σ_cv = √v0."""
    sigma_cv = torch.sqrt(_f32(params.v0, device))
    return sigma_cv, (params.r - params.q - 0.5 * sigma_cv**2) * dt


#: Steps per `torch.utils.checkpoint` chunk of a differentiated step loop.
REMAT_CHUNK = 16


def _euler_draws(draws, generator, num_paths, num_steps, device):
    """(z, u): the supplied (steps, 3, paths) normals and (steps, paths)
    jump uniforms, else drawn from `generator` up front, normals first."""
    if draws is None:
        z = torch.randn((num_steps, 3, num_paths), generator=generator,
                        device=device, dtype=torch.float32)
        u = torch.rand((num_steps, num_paths), generator=generator,
                       device=device, dtype=torch.float32)
        return z, u
    z, u = draws
    steps, paths = u.shape
    if tuple(z.shape) != (steps, 3, paths):
        raise ValueError("draws must be (steps, 3, paths) normals and "
                         "(steps, paths) uniforms")
    if num_steps not in (None, steps) or num_paths not in (None, paths):
        raise ValueError(f"draws are {steps} steps x {paths} paths, not "
                         f"{num_steps} x {num_paths}")
    return z, u


def _step_draws(draws, generator, shape, num_steps: int, device):
    """A function of the step t → (z (3, *shape) normals, u (*shape) jump
    uniforms): row t of the supplied `draws`, (steps, 3, *shape) and
    (steps, *shape), else one step's fresh from `generator`, normals first,
    so no more than a step of randoms is ever held. Call it for t = 0, 1, …
    in order."""
    if draws is not None:
        z, u = draws
        if (tuple(u.shape) != (num_steps, *shape)
                or tuple(z.shape) != (num_steps, 3, *shape)):
            raise ValueError(f"draws must be ({num_steps}, 3, *{shape}) "
                             f"normals and ({num_steps}, *{shape}) uniforms")
        return lambda t: (z[t], u[t])

    def fresh(t):
        return (torch.randn((3, *shape), generator=generator, device=device,
                            dtype=torch.float32),
                torch.rand(shape, generator=generator, device=device,
                           dtype=torch.float32))
    return fresh


def _member_leaf(x, ndim: int):
    """A leaf with a leading (M,) member axis → (M, 1, ...) over `ndim`
    dimensions; scalars and 0-d tensors as they are."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape(-1, *([1] * (ndim - 1)))
    return x


def _differentiated(params: SVJParams, dt) -> bool:
    """Whether autograd records the step loop: grad mode is on and `dt` or
    a leaf of `params` requires grad."""
    leaves = (getattr(params, f.name) for f in dataclasses.fields(params))
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for x in (dt, *leaves))


def _svj_scan(params: SVJParams, dt, sqrt_dt, z, u, sign, companion: bool,
              prob=None):
    """The Euler step loop over draws (z, u): (log S/S0, v, log G, score).
    Each normal row is multiplied by `sign` (None: one branch, no
    multiply); a leaf of `params`, `dt` or `sqrt_dt` with leading member
    axes widens the carries to them. With `prob` (λ·dt clipped to
    (0, 1)), also the ∂/∂λ score of the per-step jump indicators,
    Σ (1{U < prob} − prob)/(prob(1 − prob))·dt, taken under no_grad: an
    estimator ingredient, not part of a price. When autograd records the
    loop, each chunk of REMAT_CHUNK steps runs under
    `torch.utils.checkpoint` (non-reentrant): autograd keeps only the chunk
    boundaries' carries and recomputes the inside on the backward pass,
    the same operations on the same inputs."""
    device = z.device
    num_steps = z.shape[0]
    sigma_cv, g_drift = _companion(params, dt, device)

    def run(log_s, v, log_g, score, start, stop):
        for t in range(start, stop):
            z1, z2, zjs = z[t] if sign is None else (z[t, 0] * sign,
                                                     z[t, 1] * sign,
                                                     z[t, 2] * sign)
            log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z1, z2,
                                      u[t], zjs)
            if companion:
                log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
            if prob is not None:
                with torch.no_grad():
                    jumped = (u[t] < prob).to(torch.float32)
                    score = score + (jumped - prob) / (prob * (1.0 - prob)) \
                        * dt
        return log_s, v, log_g, score

    shape = z[0, 0].shape if sign is None else (z[0, 0] * sign).shape
    log_s = torch.zeros(shape, dtype=torch.float32, device=device)
    carry = (log_s, _v0_like(params.v0, log_s), torch.zeros_like(log_s),
             torch.zeros((), dtype=torch.float32, device=device))
    if not _differentiated(params, dt):
        return run(*carry, 0, num_steps)
    for start in range(0, num_steps, REMAT_CHUNK):
        carry = checkpoint(run, *carry, start,
                           min(start + REMAT_CHUNK, num_steps),
                           use_reentrant=False)
    return carry


def _terminal(params: SVJParams, spot, T, z, u, antithetic: bool,
              companion: bool, with_score: bool):
    """(S, v, G or None, score or 0) of the Euler twin on draws (z, u)."""
    device = z.device
    n_branch = 2 if antithetic else 1
    spot = _f32(spot, device)
    dt = _f32(T, device) / z.shape[0]
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]
    prob = (torch.clamp(params.lambda_j * dt, 1e-7, 1.0 - 1e-7)
            if with_score else None)
    log_s, v, log_g, score = _svj_scan(params, dt, sqrt_dt, z, u, sign,
                                       companion, prob)
    return (spot * torch.exp(log_s), v,
            spot * torch.exp(log_g) if companion else None, score)


def simulate_terminal(
    params: SVJParams, spot, T, generator: torch.Generator, num_paths: int,
    num_steps: int, antithetic: bool = True, companion: bool = False,
    *, draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Simulate SVJ paths with `generator`'s draws, or with `draws` = (z,
    u), (steps, 3, paths) normals and (steps, paths) jump uniforms (a
    replayed stream); terminal (S, v, G).

    Returns (n_branch, num_paths) tensors: row 0 base, row 1 antithetic;
    G (the σ=√v0 GBM companion on the same dW₁) only when `companion`.
    """
    z, u = _euler_draws(draws, generator, num_paths, num_steps,
                        torch.device(device))
    return _terminal(params, spot, T, z, u, antithetic, companion,
                     False)[:3]


def simulate_terminal_with_score(
    params: SVJParams, spot, T, generator: Optional[torch.Generator] = None,
    num_paths: Optional[int] = None, num_steps: Optional[int] = None,
    antithetic: bool = True, companion: bool = True, *,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """`simulate_terminal` plus the jump-count likelihood-ratio score.

    The same dynamics on the same draws: `draws` = (z, u), (steps, 3,
    paths) normals and (steps, paths) jump uniforms, else drawn from
    `generator` as `simulate_terminal` draws them. Differentiable in
    spot, T and every tensor leaf of `params`. Extra output, under
    no_grad: score = Σ_t (1{U_t < λdt} − λdt)/(λdt(1 − λdt))·dt, shape
    (paths,), one row because both antithetic branches share the jump
    uniforms (engine/greeks.py:lambda_lr_estimate).

    Returns (S, v, G or None, score); S, v, G (n_branch, paths).
    """
    device = draws[0].device if draws is not None else torch.device(device)
    z, u = _euler_draws(draws, generator, num_paths, num_steps, device)
    return _terminal(params, spot, T, z, u, antithetic, companion, True)


def simulate_terminal_members(
    params_batch: SVJParams, spot, T,
    generator: Optional[torch.Generator] = None,
    num_paths: Optional[int] = None, num_steps: Optional[int] = None, *,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A batch of M members in one step loop with an explicit leading
    member axis: each leaf of `params_batch` is a float (shared) or an
    (M,) tensor, and so may `spot` and `T` be. Draws as in
    `simulate_terminal_with_score`, every member on the same ones (common
    random numbers, antithetic pairs included); or draws with a member
    axis, (steps, 3, M, paths) normals and (steps, M, paths) uniforms,
    each member on its own. Differentiable in every tensor leaf: the
    members are independent, so the gradient of the sum of member prices
    with respect to an (M,) leaf is each member's own derivative.

    Returns (S, G, score): (M, 2, paths), (M, 2, paths), (M, paths); the
    companion leg always on, the λ-score per member (λ_m·dt differs).
    Leaves that are all shared give M = 1 unless spot, T or the draws
    carry the member axis.
    """
    device = draws[0].device if draws is not None else torch.device(device)
    if draws is not None and draws[1].dim() == 3:
        z, u = draws
        if z.dim() != 4 or tuple(z.shape[:1] + z.shape[2:]) != (
                u.shape[0], u.shape[1], u.shape[2]) or z.shape[1] != 3:
            raise ValueError("member draws must be (steps, 3, M, paths) "
                             "normals and (steps, M, paths) uniforms")
        z, u = z.unsqueeze(3), u.unsqueeze(2)
    else:
        z, u = _euler_draws(draws, generator, num_paths, num_steps, device)
    p = params_batch.replace(**{
        f.name: _member_leaf(getattr(params_batch, f.name), 3)
        for f in dataclasses.fields(params_batch)})
    spot = _member_leaf(_f32(spot, device), 3)
    dt = _member_leaf(_f32(T, device), 3) / z.shape[0]
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[None, :, None]
    prob = torch.clamp(p.lambda_j * dt, 1e-7, 1.0 - 1e-7)
    log_s, _, log_g, score = _svj_scan(p, dt, sqrt_dt, z, u, sign, True,
                                       prob)
    s_final = spot * torch.exp(log_s)
    g_final = spot * torch.exp(log_g)
    m = max(s_final.shape[0] if s_final.dim() == 3 else 1,
            g_final.shape[0] if g_final.dim() == 3 else 1)
    s_final = s_final.expand(m, 2, -1)
    g_final = g_final.expand(m, 2, -1)
    return s_final, g_final, score.reshape(-1, u.shape[-1]).expand(m, -1)


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
    v = _v0_like(params.v0, log_s)
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
    num_steps: int, *, device="cuda",
) -> torch.Tensor:
    """Record full paths for visualization (≤ O(100) paths) on
    `generator`'s draws, drawn up front as `simulate_terminal` draws them:
    one `cuda_kernels.svj_viz` launch on a CUDA device, the step loop of
    `recorded_from_draws` (its plain version) on the CPU.

    Returns (num_paths, num_steps + 1) spots, column 0 = spot.
    """
    return _viz_program(params, spot, T, generator, num_paths, num_steps,
                        device, record=True)


def recorded_from_draws(params: SVJParams, spot, T, z: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """The recorder's step loop over draws (z, u), (steps, 3, paths)
    normals and (steps, paths) jump uniforms: (paths, steps + 1) spots,
    column 0 = spot."""
    device = z.device
    num_steps, _, num_paths = z.shape
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    log_s = torch.zeros(num_paths, dtype=torch.float32, device=device)
    v = _v0_like(params.v0, log_s)
    rows = []
    for t in range(num_steps):
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z[t, 0],
                                  z[t, 1], u[t], z[t, 2])
        rows.append(log_s)
    paths = spot * torch.exp(torch.stack(rows, dim=1))
    return torch.cat([spot.expand(num_paths, 1), paths], dim=1)


def simulate_terminal_samples(
    params: SVJParams, spot, T, generator: torch.Generator, num_paths: int,
    num_steps: int, *, device="cuda",
) -> torch.Tensor:
    """Terminal spots for a histogram, (num_paths,): one branch, no
    antithetic pair and no companion, on `generator`'s draws. Row 0 of
    `simulate_terminal(..., antithetic=False)` on the same generator, which
    is its plain version on the CPU; one `cuda_kernels.svj_viz` launch on a
    CUDA device."""
    return _viz_program(params, spot, T, generator, num_paths, num_steps,
                        device, record=False)


def _viz_program(params: SVJParams, spot, T, generator, num_paths: int,
                 num_steps: int, device, *, record: bool) -> torch.Tensor:
    """`generator`'s draws, then `cuda_kernels.svj_viz` on them."""
    from mcos_tpu_torch.ops.cuda_kernels import svj_viz  # imports this module

    z, u = _euler_draws(None, generator, num_paths, num_steps,
                        torch.device(device))
    return svj_viz(params, spot, T, z, u, record=record)


def _qe_constants(params: SVJParams, dt: torch.Tensor):
    """QE transition and log-spot constants (Andersen eqs. 33-35, γ = ½),
    float32 0-d tensors, as `simulate_terminal_qe` forms them."""
    p = params
    device = dt.device
    kappa, theta, xi, rho = (_f32(x, device)
                             for x in (p.kappa, p.theta, p.xi, p.rho))
    e_kdt = torch.exp(-kappa * dt)
    c_mean = 1.0 - e_kdt
    xi_safe = torch.clamp(xi, min=1e-12)
    k_over = kappa * rho / xi_safe - 0.5
    k34 = 0.5 * dt * (1.0 - rho**2)
    k_comp = torch.exp(_f32(p.mu_j + 0.5 * p.sigma_j**2, device)) - 1.0
    return dict(
        theta=theta, e_kdt=e_kdt,
        var1=xi**2 * e_kdt * c_mean / torch.clamp(kappa, min=1e-12),
        var2=theta * xi**2 * c_mean**2 / torch.clamp(2.0 * kappa, min=1e-12),
        k0=-rho * kappa * theta * dt / xi_safe,
        k1=0.5 * dt * k_over - rho / xi_safe,
        k2=0.5 * dt * k_over + rho / xi_safe,
        k3=k34, k4=k34,
        drift_dt=(p.r - p.q - p.lambda_j * k_comp) * dt)


def qe_variance_step(v: torch.Tensor, z_v: torch.Tensor, u_v: torch.Tensor,
                     c: dict) -> torch.Tensor:
    """Andersen QE variance transition v → v′: the quadratic branch
    a·(√b² + z_v)² for ψ ≤ 1.5, else the exponential branch (mass p at 0)
    on the uniform u_v. The twins pass z_v = `ndtri_safe(u_v)`, K5's
    plain version Acklam's inverse (K4's takes a transition of its own,
    in the same law: cuda_kernels.py:_qe_step_folded). One IEEE float32
    operation per operation of K5's csrc/svj_qe_draws.cu:qe_step_lazy,
    whose branch selects a ulp could flip; `c` holds theta, e_kdt, var1
    and var2."""
    m = c["theta"] + (v - c["theta"]) * c["e_kdt"]
    s2 = v * c["var1"] + c["var2"]
    psi = s2 / torch.clamp(m * m, min=1e-20)
    # A tensor divide: torch's scalar ÷ tensor multiplies by a reciprocal.
    two_over_psi = torch.full_like(psi, 2.0) / torch.clamp(psi, min=1e-12)
    b2 = torch.clamp(
        (two_over_psi - 1.0)
        + torch.sqrt(torch.clamp(two_over_psi, min=1e-12))
        * torch.sqrt(torch.clamp(two_over_psi - 1.0, min=0.0)), min=0.0)
    a = m / (1.0 + b2)
    x = torch.sqrt(b2) + z_v
    v_quad = a * (x * x)
    p_mass = torch.clamp((psi - 1.0) / (psi + 1.0), min=0.0, max=0.999)
    beta = (1.0 - p_mass) / torch.clamp(m, min=1e-20)
    # Python floats clamp a float32 tensor at their float32 roundings.
    u_clip = torch.clamp(u_v, 1e-7, 1.0 - 1e-7)
    v_exp = torch.where(
        u_v <= p_mass, torch.zeros_like(v),
        torch.log((1.0 - p_mass) / torch.clamp(1.0 - u_clip, min=1e-12))
        / torch.clamp(beta, min=1e-20))
    return torch.where(psi <= 1.5, v_quad, v_exp)


def _qe_paths(params: SVJParams, spot, T, draws, n_branch: int,
              num_paths: int, companion: bool, device):
    """The QE scan over `draws` = (z_x, u_v, u_jump, z_js) per step (each
    (num_paths,), steps-major stacks); antithetic negates z_x and z_js and
    shares u_v and u_jump, so the variance path is common to the pair."""
    z_x, u_v, u_jump, z_js = draws
    num_steps = z_x.shape[0]
    p = params
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    c = _qe_constants(p, dt)
    sigma_cv, g_drift = _companion(p, dt, device)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]
    log_s = torch.zeros((n_branch, num_paths), dtype=torch.float32,
                        device=device)
    log_g = torch.zeros_like(log_s)
    v = _v0_like(p.v0, log_s)
    for t in range(num_steps):
        zx_b = z_x[t][None, :] * sign
        zjs_b = z_js[t][None, :] * sign
        u_t = u_v[t][None, :]
        v_next = qe_variance_step(v, ndtri_safe(u_t), u_t, c)
        jump = torch.where(u_jump[t][None, :] < p.lambda_j * dt,
                           p.mu_j + p.sigma_j * zjs_b,
                           torch.zeros_like(zjs_b))
        diff_var = torch.clamp(c["k3"] * v + c["k4"] * v_next, min=0.0)
        log_s = (log_s + c["drift_dt"] + c["k0"] + c["k1"] * v
                 + c["k2"] * v_next + torch.sqrt(diff_var) * zx_b + jump)
        if companion:
            log_g = log_g + g_drift + sigma_cv * zx_b * sqrt_dt
        v = v_next
    return (spot * torch.exp(log_s), v,
            spot * torch.exp(log_g) if companion else None)


def simulate_terminal_qe(
    params: SVJParams, spot, T, generator: torch.Generator, num_paths: int,
    num_steps: int, antithetic: bool = True, companion: bool = False,
    *, draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Andersen (2008) quadratic-exponential Heston scheme + Merton jumps,
    with `generator`'s draws: per step two normals (z_x; z_js) and two
    uniforms (u_v, the variance transition's; u_jump), drawn up front; or
    with `draws` = (z, u), each (steps, 2, paths) in that order.

    Returns (S, v, G or None), each (n_branch, num_paths); the pair shares
    the variance path, so both v rows are equal.
    """
    if draws is not None:
        z, u = draws
        device = z.device
        if (tuple(z.shape) != (num_steps, 2, num_paths)
                or tuple(u.shape) != tuple(z.shape)):
            raise ValueError(f"draws must be two ({num_steps}, 2, "
                             f"{num_paths}) tensors")
    else:
        device = torch.device(device)
        z = torch.randn((num_steps, 2, num_paths), generator=generator,
                        device=device, dtype=torch.float32)
        u = torch.rand((num_steps, 2, num_paths), generator=generator,
                       device=device, dtype=torch.float32)
    return _qe_paths(params, spot, T, (z[:, 0], u[:, 0], u[:, 1], z[:, 1]),
                     2 if antithetic else 1, num_paths, companion, device)


def simulate_terminal_qe_from_draws(
    params: SVJParams, spot, T, z_x: torch.Tensor, u_v: torch.Tensor,
    u_jump: torch.Tensor, z_js: torch.Tensor, antithetic: bool = True,
    companion: bool = False, steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Andersen QE driven by supplied randoms (the QMC driver): z_x the
    log-spot normals, u_v the variance-transition uniforms, u_jump the jump
    uniforms, z_js the jump-size normals; (num_paths, num_steps), or
    (num_steps, num_paths) with `steps_major=True`.

    Returns (S, v, G or None), each (n_branch, num_paths).
    """
    if not steps_major:
        z_x, u_v, u_jump, z_js = z_x.T, u_v.T, u_jump.T, z_js.T
    return _qe_paths(params, spot, T, (z_x, u_v, u_jump, z_js),
                     2 if antithetic else 1, z_x.shape[1], companion,
                     z_x.device)


def simulate_terminal_tilted(
    params: SVJParams, spot, T, generator: torch.Generator, shift,
    num_paths: int, num_steps: int, antithetic: bool = True,
    companion: bool = False, *, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """`simulate_terminal` under an exponentially tilted spot Brownian.

    Each spot-driving normal is drawn as z̃ + shift (z̃ = ±z on the two
    antithetic branches); the variance Brownian, jump occurrences and jump
    sizes keep their law. Each branch carries its exact likelihood ratio
    log L = −shift·Σ z̃ − n·shift²/2, so E[L·f(path)] is the untilted
    expectation. The companion leg rides the same tilted dW₁.

    Returns (S, v, G or None, log_weight), each (n_branch, num_paths).
    """
    device = torch.device(device)
    n_branch = 2 if antithetic else 1
    spot = _f32(spot, device)
    shift = float(np.float32(shift))
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
    log_w = torch.zeros_like(log_s)
    v = _v0_like(params.v0, log_s)
    sigma_cv, g_drift = _companion(params, dt, device)
    half_sq = float(np.float32(0.5) * np.float32(shift) * np.float32(shift))
    for t in range(num_steps):
        z1_std = z[t, 0] * sign
        z1 = z1_std + shift
        log_w = log_w - shift * z1_std - half_sq
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z1,
                                  z[t, 1] * sign, u[t][None, :],
                                  z[t, 2] * sign)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
    return (spot * torch.exp(log_s), v,
            spot * torch.exp(log_g) if companion else None, log_w)


def optimal_tilt(params: SVJParams, spot, strike, T, num_steps: int) -> float:
    """Per-step drift shift that aims the σ = √v0 GBM proxy's terminal
    mean at the strike: shift = (log(K/S0) − (r − q − σ²/2)·T) / (σ√(nT)).
    Positive for OTM calls, negative for OTM puts; any fixed shift keeps
    the estimator unbiased."""
    sigma = float(np.sqrt(float(params.v0)))
    d = float(np.log(float(strike) / float(spot))
              - (float(params.r) - float(params.q) - 0.5 * sigma * sigma)
              * float(T))
    return d / max(sigma * float(np.sqrt(num_steps * float(T))), 1e-12)


def ndtri_safe(u: torch.Tensor) -> torch.Tensor:
    """Inverse normal CDF with clipped tails (float32-safe)."""
    return torch.special.ndtri(torch.clamp(u, 1e-7, 1.0 - 1e-7))


def vanilla_payoff(s_final: torch.Tensor, strike, is_call: bool
                   ) -> torch.Tensor:
    """European payoff max(±(S−K), 0)."""
    if is_call:
        return torch.clamp(s_final - strike, min=0.0)
    return torch.clamp(strike - s_final, min=0.0)


def combine_antithetic(payoffs: torch.Tensor) -> torch.Tensor:
    """Average payoff branches pairwise: (n_branch, n_paths) → (n_paths,)."""
    return torch.mean(payoffs, dim=0)


def _pair_payoffs(s: torch.Tensor, strikes: torch.Tensor, is_call: bool,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(2, paths) terminal spots → the antithetic pairs' mean vanilla
    payoffs at each strike, (paths, K); each path's payoff first times
    `weight` (a pathwise discount). The engines' European estimator and
    their mesh shards' payoffs alike."""
    phi = 1.0 if is_call else -1.0
    pay = torch.clamp(phi * (s[..., None] - strikes), min=0.0)
    if weight is not None:
        pay = pay * weight[..., None]
    return combine_antithetic(pay)


def mc_mean_stderr(values: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and standard error over the path axis (population std / √n)."""
    n = values.shape[-1]
    mean = torch.mean(values, dim=-1)
    std = torch.std(values, dim=-1, correction=0)
    return mean, std / float(np.sqrt(np.float32(n), dtype=np.float32))
