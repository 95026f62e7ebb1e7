"""Time-dependent SVJ (Bates) dynamics: piecewise-constant θ(t), ξ(t), λ(t)
(counterpart of `mcos_tpu/ops/tdsvj.py`).

    dS/S = (r − q − λ(t)·k̄) dt + √v dW₁ + (e^J − 1) dN(λ(t))
    dv   = κ(θ(t) − v) dt + ξ(t) √v dW₂,   d⟨W₁,W₂⟩ = ρ dt

with θ, ξ, λ piecewise-constant on a calendar-time segment grid (κ, ρ, μ_J,
σ_J stay global): one consistent process across all expiries.

1. Host float64 (copied; tests/test_torch_copies.py holds these equal to
   the JAX package's): the segment grid helpers, the exact variance-swap
   strike, and the exact oracle `cos_price_td`, the Bates CF chained across
   segments by the Mikhailov-Nögel (2003) time-dependent Heston recursion.
2. The differentiable torch twins `simulate_terminal_td` and
   `simulate_reset_td`: the step loop of `ops/simulate.py` with per-step
   (θ, ξ, λ) entering through `SVJParams.replace`, so the step is
   `_svj_step_core` itself. Kernel K9 (`cuda_kernels.svj_terminal_td`,
   csrc/svj_td.cu) runs the same recursion on the card from an in-kernel
   generator, with the jump count drawn once per path from the
   Poisson-binomial law.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mcos_tpu_torch.models.params import SVJParams, TermStructureSVJ
from mcos_tpu_torch.ops.cos_pricer import cos_expansion_from_phi
from mcos_tpu_torch.ops.simulate import _companion, _f32, _svj_step_core


# ─────────────────────────────────────────────────────────────────────────────
# Segment grid
# ─────────────────────────────────────────────────────────────────────────────
def normalize_segments(
    seg_ends: Sequence[float],
    thetas: Sequence[float],
    xis: Sequence[float],
    lams: Sequence[float],
    T: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Clip/extend a piecewise-constant segment spec to exactly cover [0, T].

    `seg_ends` are ascending right edges in calendar years. Segments past T
    are dropped; if the last edge falls short of T the final segment is
    extended (flat extrapolation).
    """
    ends = np.asarray(seg_ends, np.float64)
    th = np.asarray(thetas, np.float64)
    xi = np.asarray(xis, np.float64)
    lam = np.asarray(lams, np.float64)
    if not (ends.shape == th.shape == xi.shape == lam.shape):
        raise ValueError("segment arrays must share one length")
    if ends.size == 0:
        raise ValueError("need at least one segment")
    if np.any(np.diff(ends) <= 0) or ends[0] <= 0:
        raise ValueError("segment ends must be positive and ascending")
    keep = int(np.searchsorted(ends, T - 1e-12) + 1)
    keep = min(keep, ends.size)
    ends, th, xi, lam = ends[:keep].copy(), th[:keep], xi[:keep], lam[:keep]
    ends[-1] = T
    return ends, th, xi, lam


def segments_from_term_structure(
    ts: TermStructureSVJ, T: float, n_segments: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Discretize a `TermStructureSVJ`'s piecewise-linear *maturity* curves
    into piecewise-constant *calendar-time* segments via forward stripping.

    The TS curves give per-maturity aggregate levels; a consistent process
    needs instantaneous levels. θ(T) and λ(T) enter aggregate quantities
    ~linearly in time (∫θ, ∫λ), so strip forwards: inst_s = (c(t_s)·t_s −
    c(t_{s-1})·t_{s-1}) / τ_s. ξ(T) enters variance-of-variance ~as ∫ξ², so
    strip in ξ² space. Floors keep stripped values admissible when the input
    curve is steeply inverted (θ, λ ≥ 0; ξ ≥ 1e-4).
    """
    edges = np.linspace(0.0, T, n_segments + 1)
    mids_end = edges[1:]

    def curve(vals: dict, t: np.ndarray, default: float) -> np.ndarray:
        return np.array(
            [ts._interp(vals, float(x), default) for x in t], np.float64)

    th_agg = curve(ts.theta_curve, mids_end, 0.04)
    xi_agg = curve(ts.xi_curve, mids_end, 0.5)
    lam_agg = curve(ts.lambda_curve, mids_end, 1.0)

    tau = np.diff(edges)

    def strip_linear(agg: np.ndarray, floor: float) -> np.ndarray:
        cum = agg * mids_end
        inst = np.diff(np.concatenate([[0.0], cum])) / tau
        return np.maximum(inst, floor)

    th = strip_linear(th_agg, 1e-6)
    lam = strip_linear(lam_agg, 0.0)
    xi = np.sqrt(strip_linear(xi_agg**2, 1e-8))
    return mids_end, th, xi, lam


def step_param_arrays(
    seg_ends: np.ndarray,
    thetas: np.ndarray,
    xis: np.ndarray,
    lams: np.ndarray,
    T: float,
    num_steps: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step (θ, ξ, λ) arrays for an Euler grid of `num_steps` on [0, T].

    Step i covers [i·dt, (i+1)·dt] and takes the segment containing its
    midpoint — the piecewise-constant analogue of the left-point rule used
    everywhere else in the engine.
    """
    dt = T / num_steps
    mids = (np.arange(num_steps) + 0.5) * dt
    idx = np.minimum(np.searchsorted(seg_ends, mids), seg_ends.size - 1)
    return thetas[idx], xis[idx], lams[idx]


def _expected_integrals(kappa: float, v0: float, taus: np.ndarray,
                        thetas: np.ndarray, lams: np.ndarray):
    """(∫₀ᵀ E[v_t] dt, ∫₀ᵀ λ(t) dt) under piecewise-constant (θ, λ).

    E[v_t] solves a linear ODE per segment (dE[v]/dt = κ(θ_s − E[v])), so
    both the integral and the segment-end value are exact:
        ∫ = θ_s τ + (v_start − θ_s)(1 − e^{−κτ})/κ,
        v_end = θ_s + (v_start − θ_s) e^{−κτ}.
    """
    v = float(v0)
    int_v = 0.0
    int_lam = 0.0
    for s in range(len(taus)):
        tau, th, lam = float(taus[s]), float(thetas[s]), float(lams[s])
        if kappa > 1e-8:
            e_kt = np.exp(-kappa * tau)
            int_v += th * tau + (v - th) * (1.0 - e_kt) / kappa
            v = th + (v - th) * e_kt
        else:
            int_v += v * tau
        int_lam += lam * tau
    return int_v, int_lam


def td_variance_swap_fair_strike(
    params: SVJParams,
    seg_ends,
    thetas,
    xis,
    lams,
    T: float,
) -> dict:
    """Fair variance-swap strike under td dynamics — exact closed form.

    The td analogue of exotics.variance_swap_fair_strike (whose CIR mean
    integral it reproduces exactly in the constant-segment limit):
        QV/T = (1/T) ∫₀ᵀ E[v_t] dt            (piecewise-exact recursion)
             + (1/T) Σ_s λ_s τ_s (μ_J² + σ_J²)  (jump second moment)
    ξ(t) does not enter (E[v] is ξ-free); it only moves higher moments.
    Returns both legs and the total in variance units.
    """
    seg_ends, thetas, xis, lams = normalize_segments(
        seg_ends, thetas, xis, lams, T)
    taus = np.diff(np.concatenate([[0.0], seg_ends]))
    int_v, int_lam = _expected_integrals(
        float(params.kappa), float(params.v0), taus, thetas, lams)
    diffusion = int_v / T
    jumps = (int_lam / T) * (float(params.mu_j) ** 2
                             + float(params.sigma_j) ** 2)
    total = diffusion + jumps
    return {
        "fair_variance": total,
        "fair_vol_strike": float(np.sqrt(max(total, 0.0))),
        "diffusion_leg": diffusion,
        "jump_leg": jumps,
    }


# ─────────────────────────────────────────────────────────────────────────────
# Exact oracle: chained-Riccati Bates CF (Mikhailov-Nögel 2003)
# ─────────────────────────────────────────────────────────────────────────────
def td_bates_cf(
    u: np.ndarray,
    params: SVJParams,
    seg_ends: np.ndarray,
    thetas: np.ndarray,
    xis: np.ndarray,
    lams: np.ndarray,
    T: float,
    spot: float,
) -> np.ndarray:
    """CF E[e^{iu ln S_T}] under piecewise-constant (θ, ξ, λ) Bates dynamics.

    `params` supplies the global (κ, ρ, v0, μ_J, σ_J, r, q). Segments are
    processed in reverse calendar order; each Heston Riccati solve takes the
    accumulated D as its terminal condition:

        r± = (β ± d)/ξ²,  β = κ − ρξiu,  d = √(β² + ξ²(u² + iu))
        g  = (D₀ − r₋)/(D₀ − r₊)
        D(τ) = (r₋ − r₊ g e^{−dτ}) / (1 − g e^{−dτ})
        C(τ) = C₀ + κθ[r₋τ − (2/ξ²) ln((1 − g e^{−dτ})/(1 − g))]

    With D₀ = 0 this is exactly the little-trap form in `bates_cf`
    (cos_pricer.py:50-58), so a single segment reproduces it to rounding.
    The principal branch of √· keeps Re(d) ≥ 0, hence |e^{−dτ}| ≤ 1 — the
    same continuity argument as the little trap, segment by segment.

    Jumps: λ constant within a segment ⇒ the jump exponent is additive,
    Σ_s λ_s τ_s [(e^{iuμ_J − u²σ_J²/2} − 1) − iu k̄].
    """
    p = params
    kappa, rho = float(p.kappa), float(p.rho)
    v0, r, q = float(p.v0), float(p.r), float(p.q)
    mu_j, sig_j = float(p.mu_j), float(p.sigma_j)

    u = np.asarray(u, np.complex128)
    iu = 1j * u

    starts = np.concatenate([[0.0], seg_ends[:-1]])
    taus = seg_ends - starts

    C = np.zeros_like(u)
    D = np.zeros_like(u)
    jump_exp = np.zeros_like(u)
    k_bar = np.exp(mu_j + 0.5 * sig_j**2) - 1.0
    jump_factor = np.exp(iu * mu_j - 0.5 * u**2 * sig_j**2) - 1.0

    for s in range(len(taus) - 1, -1, -1):
        tau = float(taus[s])
        if tau <= 0.0:
            continue
        theta, xi, lam = float(thetas[s]), float(xis[s]), float(lams[s])
        xi2 = xi * xi
        beta = kappa - rho * xi * iu
        d = np.sqrt(beta**2 + xi2 * (u**2 + iu))
        r_minus = (beta - d) / xi2
        r_plus = (beta + d) / xi2
        g = (D - r_minus) / (D - r_plus)
        e_dt = np.exp(-d * tau)
        denom = 1.0 - g * e_dt
        D = (r_minus - r_plus * g * e_dt) / denom
        C = C + kappa * theta * (
            r_minus * tau - (2.0 / xi2) * np.log(denom / (1.0 - g)))
        jump_exp = jump_exp + lam * tau * (jump_factor - iu * k_bar)

    drift = iu * (np.log(spot) + (r - q) * T)
    return np.exp(drift + C + D * v0 + jump_exp)


def _cumulant_range_td(
    params: SVJParams,
    seg_ends: np.ndarray,
    thetas: np.ndarray,
    xis: np.ndarray,
    lams: np.ndarray,
    T: float,
    spot: float,
    L: float = 12.0,
) -> Tuple[float, float]:
    """Truncation interval for ln S_T: exact c1 via the segment recursion for
    E[∫v dt]; c2/c4 from the constant-param formulas at time-averaged levels
    (truncation only needs the right scale — L=12 is generous)."""
    p = params
    kappa = float(p.kappa)
    mu_j, sig_j = float(p.mu_j), float(p.sigma_j)
    r, q = float(p.r), float(p.q)
    k_bar = np.exp(mu_j + 0.5 * sig_j**2) - 1.0

    starts = np.concatenate([[0.0], seg_ends[:-1]])
    taus = seg_ends - starts

    int_v, int_lam = _expected_integrals(kappa, float(p.v0), taus, thetas,
                                         lams)

    c1 = (np.log(spot) + (r - q) * T - int_lam * k_bar - 0.5 * int_v
          + int_lam * mu_j)

    theta_bar = float(np.sum(thetas * taus) / T)
    xi_bar = float(np.sqrt(np.sum(xis**2 * taus) / T))
    lam_bar = float(int_lam / T)
    rho = float(p.rho)
    v0 = float(p.v0)
    if kappa * T > 0.01:
        # Same κT guard as ops/cos_pricer.py:_cumulant_range — the closed
        # form cancels catastrophically in f64 below it.
        ekt = np.exp(-kappa * T)
        xi_ = xi_bar
        c2_h = (xi_ * T * kappa * ekt * (v0 - theta_bar)
                * (8 * kappa * rho - 4 * xi_)
                + kappa * rho * xi_ * (1 - ekt) * (16 * theta_bar - 8 * v0)
                + 2 * theta_bar * kappa * T * (-4 * kappa * rho * xi_
                                               + xi_**2 + 4 * kappa**2)
                + xi_**2 * ((theta_bar - 2 * v0) * np.exp(-2 * kappa * T)
                            + theta_bar * (6 * ekt - 7) + 2 * v0)
                + 8 * kappa**2 * (v0 - theta_bar) * (1 - ekt)) / (8 * kappa**3)
    else:
        c2_h = (v0 * T + xi_bar**2 * v0 * T**3 / 12.0
                - rho * xi_bar * v0 * T**2 / 2.0)
    c2 = abs(c2_h) + lam_bar * T * (mu_j**2 + sig_j**2)
    c4 = lam_bar * T * (mu_j**4 + 6 * mu_j**2 * sig_j**2 + 3 * sig_j**4)
    half = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    return c1 - half, c1 + half


def cos_price_td(
    params: SVJParams,
    spot: float,
    strikes,
    T: float,
    seg_ends,
    thetas,
    xis,
    lams,
    is_call: bool = True,
    n_terms: int = 512,
    L: float = 12.0,
) -> np.ndarray:
    """European prices under piecewise-constant (θ, ξ, λ) Bates dynamics —
    the exact oracle the td MC simulator is pinned against."""
    seg_ends, thetas, xis, lams = normalize_segments(
        seg_ends, thetas, xis, lams, T)
    a, b = _cumulant_range_td(params, seg_ends, thetas, xis, lams, T, spot,
                              L=L)
    u = np.arange(n_terms) * np.pi / (b - a)
    phi = td_bates_cf(u, params, seg_ends, thetas, xis, lams, T, spot)
    return cos_expansion_from_phi(phi, a, b, spot, strikes, T,
                                  float(params.r), float(params.q), is_call)


# ─────────────────────────────────────────────────────────────────────────────
# MC simulators: the constant-parameter step loop with per-step (θ, ξ, λ)
# ─────────────────────────────────────────────────────────────────────────────
def _td_draws(generator, draws, num_steps: int, num_paths: int, device):
    """((steps, 3, paths) normals, (steps, paths) uniforms, device): the
    generator's, all up front, or the caller's `draws`."""
    if draws is not None:
        z, u = draws
        device = z.device
    else:
        device = torch.device(device)
        z = torch.randn((num_steps, 3, num_paths), generator=generator,
                        device=device, dtype=torch.float32)
        u = torch.rand((num_steps, num_paths), generator=generator,
                       device=device, dtype=torch.float32)
    if (tuple(z.shape) != (num_steps, 3, num_paths)
            or tuple(u.shape) != (num_steps, num_paths)):
        raise ValueError("draws must be (steps, 3, paths) normals and "
                         "(steps, paths) uniforms")
    return z, u, device


def _step_levels(theta_t, xi_t, lam_t, num_steps: int):
    """Per-step levels as lists of float32-rounded Python floats."""
    out = []
    for name, x in (("theta_t", theta_t), ("xi_t", xi_t), ("lam_t", lam_t)):
        arr = np.asarray(x, np.float32).reshape(-1)
        if arr.size != num_steps:
            raise ValueError(f"{name} has {arr.size} entries for "
                             f"{num_steps} steps")
        out.append([float(a) for a in arr])
    return out


def simulate_terminal_td(
    params: SVJParams, theta_t, xi_t, lam_t, spot, T,
    generator: Optional[torch.Generator], num_paths: int, num_steps: int,
    antithetic: bool = True, companion: bool = False, *,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Time-dependent twin of `simulate.simulate_terminal`.

    `theta_t/xi_t/lam_t` are (num_steps,) per-step levels (from
    `step_param_arrays`). Each step runs `_svj_step_core` with
    `params.replace(theta=θᵢ, xi=ξᵢ, lambda_j=λᵢ)`, so constant arrays
    reproduce the constant-parameter simulator. The companion control leg
    keeps σ = √v0. Randoms: `generator`'s, or `draws=(z, u_jump)`, (steps,
    3, paths) normals and (steps, paths) uniforms.

    Returns (S, v, G or None), each (n_branch, num_paths).
    """
    z, u_jump, device = _td_draws(generator, draws, num_steps, num_paths,
                                  device)
    th, xi, lam = _step_levels(theta_t, xi_t, lam_t, num_steps)
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
        p_i = params.replace(theta=th[t], xi=xi[t], lambda_j=lam[t])
        z1 = z[t, 0] * sign
        log_s, v = _svj_step_core(p_i, dt, sqrt_dt, log_s, v, z1,
                                  z[t, 1] * sign, u_jump[t][None, :],
                                  z[t, 2] * sign)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
    return (spot * torch.exp(log_s), v,
            spot * torch.exp(log_g) if companion else None)


def simulate_reset_td(
    params: SVJParams, theta_t, xi_t, lam_t, spot, T, reset_step: int,
    generator: Optional[torch.Generator], num_paths: int, num_steps: int,
    companion: bool = True, *,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, device="cuda",
):
    """`simulate_terminal_td` that also captures log S at a reset date.

    `reset_step` ∈ [1, num_steps−1]: the reset falls after that many Euler
    steps (t₁ = reset_step·dt). Returns (s_reset, s_T, g_reset, g_T), each
    (2, num_paths) antithetic (the g's None without `companion`): the
    inputs to forward-start and cliquet-leg payoffs, whose value depends on
    the path across expiries.
    """
    z, u_jump, device = _td_draws(generator, draws, num_steps, num_paths,
                                  device)
    th, xi, lam = _step_levels(theta_t, xi_t, lam_t, num_steps)
    reset_idx = int(reset_step) - 1
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[:, None]
    log_s = torch.zeros((2, num_paths), dtype=torch.float32, device=device)
    log_g = log_s_r = log_g_r = log_s
    v = _f32(params.v0, device).expand(2, num_paths)
    sigma_cv, g_drift = _companion(params, dt, device)
    for t in range(num_steps):
        p_i = params.replace(theta=th[t], xi=xi[t], lambda_j=lam[t])
        z1 = z[t, 0] * sign
        log_s, v = _svj_step_core(p_i, dt, sqrt_dt, log_s, v, z1,
                                  z[t, 1] * sign, u_jump[t][None, :],
                                  z[t, 2] * sign)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        if t == reset_idx:
            log_s_r, log_g_r = log_s, log_g
    return (spot * torch.exp(log_s_r), spot * torch.exp(log_s),
            spot * torch.exp(log_g_r) if companion else None,
            spot * torch.exp(log_g) if companion else None)
