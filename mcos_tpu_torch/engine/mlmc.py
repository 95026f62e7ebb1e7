"""Multilevel Monte Carlo pricing (Giles 2008) for the SVJ model
(counterpart of `mcos_tpu/engine/mlmc.py`).

MLMC prices to a target RMS accuracy eps at O(eps^-2) cost instead of
single-level Euler's O(eps^-3):

    E[P_L] = E[P_0] + sum_{l=1..L} E[P_l - P_{l-1}]

with each correction estimated from coupled path pairs: the fine level
takes 2x the steps of the coarse level, and the coarse level consumes the
pairwise-summed Brownian increments of the fine level, so the corrections'
variances V_l fall with the level and need ever fewer paths.

Coupling:
- Brownian increments: z_coarse = (z_a + z_b)/sqrt(2), exact in law.
- Jumps are exact compound Poisson: per fine step mu*N + sigma*sqrt(N)*Z
  with N ~ Poisson(lambda*dt_f) (`torch.poisson`), and the coarse step
  takes the SUM of its two fine jumps. Poisson additivity makes the coarse
  marginal exactly Poisson(lambda*dt_c), and jumps never mismatch between
  levels.
- Antithetic branches share the counts and negate every normal.

Each level is a torch step loop on the device (no kernel of `csrc/`
computes these coupled pairs); the level loop (`giles_driver`) runs on the
host. Every (level, n) draws from its own seeded generator; a `draws=`
hook on each level replays given randoms instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.simulate import _f32, _safe_sqrt


def _diffusion_step(p: SVJParams, dt, sqrt_dt, log_s, v, z1, z2):
    """Full-truncation Heston Euler step + compensated drift (no jumps:
    MLMC applies exact compound-Poisson jumps separately)."""
    v_pos = torch.clamp(v, min=0.0)
    sqrt_v = _safe_sqrt(v_pos)
    device = v.device
    k = torch.exp(_f32(p.mu_j, device) + 0.5 * _f32(p.sigma_j, device)**2) \
        - 1.0
    drift = p.r - p.q - p.lambda_j * k
    rho = _f32(p.rho, device)
    dw1 = z1 * sqrt_dt
    dw2 = rho * dw1 + torch.sqrt(1.0 - rho * rho) * z2 * sqrt_dt
    log_s = log_s + (drift - 0.5 * v_pos) * dt + sqrt_v * dw1
    v = torch.clamp(v_pos + p.kappa * (p.theta - v_pos) * dt
                    + p.xi * sqrt_v * dw2, min=0.0)
    return log_s, v


def _compound_jump(p: SVJParams, n: torch.Tensor, z: torch.Tensor, sign):
    """Exact compound-Poisson jump for one step, mu*N + sigma*sqrt(N)*Z,
    from the (paths,) counts N and normals Z; exact for lognormal jump
    sizes. Antithetic branches share the count and negate Z."""
    return (p.mu_j * n)[None, :] + p.sigma_j * torch.sqrt(n)[None, :] \
        * (z[None, :] * sign)


def _jump_draws(generator, lam_dt, num_paths: int, device):
    """(counts, normals), (paths,) each: N ~ Poisson(lam_dt), then Z."""
    rate = torch.full((num_paths,), 1.0, dtype=torch.float32,
                      device=device) * lam_dt
    n = torch.poisson(rate, generator=generator)
    z = torch.randn((num_paths,), generator=generator, device=device,
                    dtype=torch.float32)
    return n, z


def _check_draws(draws, shapes, what: str):
    if any(tuple(d.shape) != s for d, s in zip(draws, shapes)) \
            or len(draws) != len(shapes):
        raise ValueError(f"{what} draws must have shapes {shapes}")


def _discounted_payoff(p: SVJParams, spot, strike, T, log_s,
                       is_call: bool):
    """(paths,) antithetic-combined discounted payoff of spot·exp(log_s)."""
    s = spot * torch.exp(log_s)
    phi = 1.0 if is_call else -1.0
    pay = torch.mean(torch.clamp(phi * (s - strike), min=0.0), dim=0)
    return torch.exp(-p.r * T) * pay


def _coupled_level(params: SVJParams, spot, strike, T,
                   generator: Optional[torch.Generator], *, num_paths: int,
                   num_coarse_steps: int, is_call: bool,
                   draws: Optional[Sequence[torch.Tensor]] = None,
                   device="cuda"):
    """One MLMC correction level: 0-d (mean, E[x^2]) of P_fine - P_coarse
    over the antithetic-combined pairs (discounted).

    Fine = 2 * num_coarse_steps Euler steps, each fine sub-step with its own
    exact jump; coarse = num_coarse_steps steps on the summed increments
    with the same total jump. Randoms per coarse step: z_a, z_b (2, paths)
    normals, then the sub-steps' jumps (counts, normals). `draws` =
    (z_a, z_b (steps, 2, paths), n_a, zj_a, n_b, zj_b (steps, paths))
    replays them; else they come from `generator` a step at a time.
    """
    p = params
    if draws is not None:
        device = draws[0].device
        s2, s1 = (num_coarse_steps, 2, num_paths), (num_coarse_steps,
                                                    num_paths)
        _check_draws(draws, (s2, s2, s1, s1, s1, s1), "coupled-level")
    device = torch.device(device)
    spot = _f32(spot, device)
    T = _f32(T, device)
    dt_f = T / (2 * num_coarse_steps)
    dt_c = T / num_coarse_steps
    sqrt_dt_f = torch.sqrt(dt_f)
    sqrt_dt_c = torch.sqrt(dt_c)
    inv_sqrt2 = float(np.float32(1.0 / np.sqrt(2.0)))
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[:, None]
    zeros = torch.zeros((2, num_paths), dtype=torch.float32, device=device)
    v0 = zeros + _f32(p.v0, device)
    lam_dt_f = _f32(p.lambda_j, device) * dt_f

    ls_f, v_f, ls_c, v_c = zeros, v0, zeros, v0
    for t in range(num_coarse_steps):
        if draws is not None:
            za, zb, n_a, zj_a, n_b, zj_b = (d[t] for d in draws)
        else:
            za = torch.randn((2, num_paths), generator=generator,
                             device=device, dtype=torch.float32)
            zb = torch.randn((2, num_paths), generator=generator,
                             device=device, dtype=torch.float32)
            n_a, zj_a = _jump_draws(generator, lam_dt_f, num_paths, device)
            n_b, zj_b = _jump_draws(generator, lam_dt_f, num_paths, device)
        jump_a = _compound_jump(p, n_a, zj_a, sign)
        jump_b = _compound_jump(p, n_b, zj_b, sign)
        # Fine: two diffusion sub-steps, each with its exact jump.
        ls_f, v_f = _diffusion_step(p, dt_f, sqrt_dt_f, ls_f, v_f,
                                    za[0] * sign, za[1] * sign)
        ls_f = ls_f + jump_a
        ls_f, v_f = _diffusion_step(p, dt_f, sqrt_dt_f, ls_f, v_f,
                                    zb[0] * sign, zb[1] * sign)
        ls_f = ls_f + jump_b
        # Coarse: one step on the summed increments + the same total jump.
        z1_c = (za[0] + zb[0]) * inv_sqrt2 * sign
        z2_c = (za[1] + zb[1]) * inv_sqrt2 * sign
        ls_c, v_c = _diffusion_step(p, dt_c, sqrt_dt_c, ls_c, v_c,
                                    z1_c, z2_c)
        ls_c = ls_c + jump_a + jump_b

    diff = (_discounted_payoff(p, spot, strike, T, ls_f, is_call)
            - _discounted_payoff(p, spot, strike, T, ls_c, is_call))
    return torch.mean(diff), torch.mean(diff * diff)


def _level_zero(params: SVJParams, spot, strike, T,
                generator: Optional[torch.Generator], *, num_paths: int,
                num_steps: int, is_call: bool,
                draws: Optional[Sequence[torch.Tensor]] = None,
                device="cuda"):
    """Base level: Euler diffusion + exact Poisson jumps on the coarse grid
    (the scheme family the corrections couple). 0-d (mean, E[x^2]).
    Randoms per step: z (2, paths), then (counts, normals); `draws` =
    (z (steps, 2, paths), n, zj (steps, paths)) replays them."""
    p = params
    if draws is not None:
        device = draws[0].device
        _check_draws(draws, ((num_steps, 2, num_paths),
                             (num_steps, num_paths), (num_steps, num_paths)),
                     "level-zero")
    device = torch.device(device)
    spot = _f32(spot, device)
    T = _f32(T, device)
    dt = T / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[:, None]
    lam_dt = _f32(p.lambda_j, device) * dt
    log_s = torch.zeros((2, num_paths), dtype=torch.float32, device=device)
    v = log_s + _f32(p.v0, device)
    for t in range(num_steps):
        if draws is not None:
            z, n, zj = (d[t] for d in draws)
        else:
            z = torch.randn((2, num_paths), generator=generator,
                            device=device, dtype=torch.float32)
            n, zj = _jump_draws(generator, lam_dt, num_paths, device)
        log_s, v = _diffusion_step(p, dt, sqrt_dt, log_s, v,
                                   z[0] * sign, z[1] * sign)
        log_s = log_s + _compound_jump(p, n, zj, sign)
    x = _discounted_payoff(p, spot, strike, T, log_s, is_call)
    return torch.mean(x), torch.mean(x * x)


def _level_seed(seed: int, tag: int) -> int:
    """The seed of one (level, n) stream: `seed` and the reference's tag
    level * 1000 + n % 997, mixed by numpy's SeedSequence."""
    return int(np.random.SeedSequence((int(seed), int(tag))).generate_state(
        1, np.uint32)[0])


def mlmc_price(
    params: SVJParams,
    spot: float,
    strike: float,
    T: float,
    is_call: bool = True,
    eps: float = 0.05,
    base_steps: int = 4,
    max_levels: int = 8,
    pilot_paths: int = 8_192,
    max_paths_per_level: int = 4_000_000,
    seed: int = 0,
    *,
    device="cuda",
) -> Dict:
    """Price a European option to RMS accuracy ~ eps by MLMC on `device`.

    The Giles driver: pilot runs estimate the per-level variances V_l and
    costs C_l ∝ 2^l, allocations N_l ∝ sqrt(V_l/C_l) target a sampling
    variance of eps^2/2, and levels are appended until the bias estimate
    |Y_L| is below eps/sqrt(2). Path counts are clamped to
    [256, max_paths_per_level] and rounded up to a power of two; each
    (level, n) runs on its own seeded generator.
    """
    device = torch.device(device)

    def run_level(level: int, n: int):
        n = int(min(max(n, 256), max_paths_per_level))
        n = 1 << int(np.ceil(np.log2(n)))
        gen = seeded_generator(_level_seed(seed, level * 1000 + n % 997),
                               device)
        if level == 0:
            m, m2 = _level_zero(params, spot, strike, T, gen, num_paths=n,
                                num_steps=base_steps, is_call=is_call,
                                device=device)
        else:
            m, m2 = _coupled_level(
                params, spot, strike, T, gen, num_paths=n,
                num_coarse_steps=base_steps * 2**(level - 1),
                is_call=is_call, device=device)
        m, m2 = torch.stack([m, m2]).cpu().tolist()
        return n, m, m2

    return giles_driver(run_level, eps=eps, base_steps=base_steps,
                        max_levels=max_levels, pilot_paths=pilot_paths)


def giles_driver(run_level, *, eps: float, base_steps: int,
                 max_levels: int, pilot_paths: int) -> Dict:
    """The Giles allocation/extension loop (host Python, copied):
    `run_level(level, n) -> (n_used, mean, mean_sq)`."""
    levels = []  # per level: dict(n, mean, var, cost)
    for level in (0, 1, 2):
        n, m, m2 = run_level(level, pilot_paths)
        levels.append({"level": level, "n": n, "mean": m,
                       "var": max(m2 - m * m, 1e-12),
                       "cost": base_steps * 2**level})

    target_var = 0.5 * eps * eps
    for _ in range(24):  # refinement rounds
        # Optimal allocation (Giles eq. 12): N_l ∝ √(V_l / C_l).
        lam = sum(np.sqrt(lv["var"] * lv["cost"]) for lv in levels)
        needs_more = False
        for lv in levels:
            n_opt = int(np.ceil(
                np.sqrt(lv["var"] / lv["cost"]) * lam / target_var))
            if n_opt > 2 * lv["n"]:
                n_new = max(n_opt, 2 * lv["n"])
                n, m, m2 = run_level(lv["level"], n_new)
                if n > lv["n"]:
                    lv.update(n=n, mean=m, var=max(m2 - m * m, 1e-12))
                    needs_more = True
        # Bias check on the finest correction (weak order α = 1 ⇒ the
        # remaining bias ≈ |Y_L|).
        y_last = abs(levels[-1]["mean"]) if len(levels) > 1 else np.inf
        if y_last > eps / np.sqrt(2.0) and len(levels) < max_levels:
            lvl = len(levels)
            n, m, m2 = run_level(lvl, pilot_paths)
            levels.append({"level": lvl, "n": n, "mean": m,
                           "var": max(m2 - m * m, 1e-12),
                           "cost": base_steps * 2**lvl})
            needs_more = True
        if not needs_more:
            break

    price = sum(lv["mean"] for lv in levels)
    stat_var = sum(lv["var"] / lv["n"] for lv in levels)
    bias = abs(levels[-1]["mean"]) if len(levels) > 1 else float("nan")
    return {
        "price": float(price),
        "std_error": float(np.sqrt(stat_var)),
        "bias_estimate": float(bias),
        "eps": eps,
        "num_levels": len(levels),
        "fine_steps": base_steps * 2 ** (len(levels) - 1),
        "total_path_steps": int(sum(2 * lv["n"] * lv["cost"]
                                    for lv in levels)),
        "levels": [{k: lv[k] for k in ("level", "n", "mean", "var")}
                   for lv in levels],
    }
