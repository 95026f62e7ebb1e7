"""Plain reference dynamics and estimators, in any floating dtype: float64
for the reference, bfloat16 for the control.

- SVJ (Bates): Heston variance with full-truncation log-Euler steps and
  compensated lognormal Merton jumps, at most one a step, 1{U < lambda dt};
  antithetic pairs negate every normal and share the jump uniforms; the
  control leg is a GBM at sigma = sqrt(v0) on the same dW1.
- Lifted rough Heston (Abi Jaber & El Euch 2019): the fractional kernel
  as a sum of exponentials over a geometric partition of the mean-reversion
  axis, moment-matched cell by cell; one semi-implicit Euler step a step.
- Black-Scholes with a continuous dividend yield.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def ndtr(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def tensors(values: dict, dtype, device) -> dict:
    """Each value as a 0-d tensor of `dtype` on `device`; a tensor already
    so (an autograd leaf) is kept as it is."""
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in values.items()}


def safe_sqrt(v: torch.Tensor) -> torch.Tensor:
    """sqrt(v) for v >= 0, with a zero derivative at 0."""
    tiny = torch.finfo(v.dtype).tiny
    return torch.where(v > 0, torch.sqrt(torch.clamp(v, min=tiny)),
                       torch.zeros_like(v))


def black_scholes(spot, strike, T, r, q, sigma, is_call: bool):
    """European price with a continuous dividend yield; tensor arguments
    broadcast and set the dtype."""
    sd = sigma * torch.sqrt(T)
    d1 = (torch.log(spot / strike) + (r - q) * T) / sd + 0.5 * sd
    d2 = d1 - sd
    df_r, df_q = torch.exp(-r * T), torch.exp(-q * T)
    if is_call:
        return spot * df_q * ndtr(d1) - strike * df_r * ndtr(d2)
    return strike * df_r * ndtr(-d2) - spot * df_q * ndtr(-d1)


def svj_log_terminals(p: dict, T: torch.Tensor, z1, z2, u, zj):
    """Log-terminals (X, Xg) of the SVJ paths and their control leg, each
    (2, N) (base, antithetic), over steps-major draws (steps, N). `p`
    holds kappa, theta, xi, rho, v0, lambda_j, mu_j, sigma_j, r, q as 0-d
    tensors of the draws' dtype (`tensors`), T likewise; any of them may be
    an autograd leaf."""
    steps = z1.shape[0]
    sign = torch.tensor([[1.0], [-1.0]], dtype=z1.dtype, device=z1.device)
    dt = T / steps
    sdt = torch.sqrt(dt)
    comp = torch.exp(p["mu_j"] + 0.5 * p["sigma_j"] ** 2) - 1.0
    rho_perp = torch.sqrt(1.0 - p["rho"] ** 2)
    x = torch.zeros((2, z1.shape[1]), dtype=z1.dtype, device=z1.device)
    xg = x
    v = x + torch.clamp(p["v0"], min=0.0)
    sig_cv = torch.sqrt(p["v0"])
    for t in range(steps):
        a, b = sign * z1[t], sign * z2[t]
        sv = safe_sqrt(v)
        jump = torch.where(u[t] < p["lambda_j"] * dt,
                           p["mu_j"] + sign * (p["sigma_j"] * zj[t]),
                           torch.zeros_like(a))
        x = x + (p["r"] - p["q"] - p["lambda_j"] * comp - 0.5 * v) * dt \
            + sv * a * sdt + jump
        v = torch.clamp(v + p["kappa"] * (p["theta"] - v) * dt
                        + p["xi"] * sv * (p["rho"] * a + rho_perp * b) * sdt,
                        min=0.0)
        xg = xg + (p["r"] - p["q"] - 0.5 * p["v0"]) * dt + sig_cv * a * sdt
    return x, xg


def svj_recorded_log_paths(p: dict, T, z, u):
    """(N, steps) log-paths of the one-branch SVJ recorder, over draws z
    (steps, 3, N) (dW1, dW2, jump size) and u (steps, N)."""
    steps = z.shape[0]
    dt = T / steps
    sdt = dt ** 0.5
    comp = math.exp(p["mu_j"] + 0.5 * p["sigma_j"] ** 2) - 1.0
    rho_perp = (1.0 - p["rho"] ** 2) ** 0.5
    x = torch.zeros_like(z[0, 0])
    v = torch.full_like(x, max(p["v0"], 0.0))
    rows = []
    for t in range(steps):
        a, b, zj = z[t, 0], z[t, 1], z[t, 2]
        sv = torch.sqrt(v)
        jump = torch.where(u[t] < p["lambda_j"] * dt,
                           p["mu_j"] + p["sigma_j"] * zj, torch.zeros_like(a))
        x = x + (p["r"] - p["q"] - p["lambda_j"] * comp - 0.5 * v) * dt \
            + sv * a * sdt + jump
        v = torch.clamp(v + p["kappa"] * (p["theta"] - v) * dt
                        + p["xi"] * sv * (p["rho"] * a + rho_perp * b) * sdt,
                        min=0.0)
        rows.append(x)
    return torch.stack(rows, dim=1)


def cv_price(pay: torch.Tensor, ctrl: torch.Tensor, bs, disc):
    """Price and standard error of the beta = 1 control-variate estimator
    over per-path values (N,) (antithetic pairs already averaged)."""
    adj = pay - (ctrl - bs / disc)
    n = adj.shape[-1]
    price = disc * torch.mean(pay) - (disc * torch.mean(ctrl) - bs)
    se = disc * torch.sqrt(torch.mean((adj - torch.mean(adj)) ** 2) / n)
    return price, se


def payoff(s: torch.Tensor, strike, is_call: bool) -> torch.Tensor:
    return torch.clamp(s - strike if is_call else strike - s, min=0.0)


# ── Lifted rough Heston ─────────────────────────────────────────────────────
def lifted_nodes(hurst: float, T: float, n_factors: int,
                 res_steps: int = 256):
    """(c, x), float64 numpy: K(t) = t^(H-1/2)/Gamma(H+1/2) ~ sum c_i
    exp(-x_i t), from the kernel's measure mu(dx) = x^(-alpha) dx /
    (Gamma(alpha) Gamma(1-alpha)), alpha = H + 1/2, over the cells of
    [0, eta_1] and a geometric grid from 0.02/T to 20/resolution (the
    resolution T/256): c_i the cell's mass, x_i its mean."""
    alpha = hurst + 0.5
    eta = np.concatenate([[0.0], np.geomspace(0.02 / T, 20.0 * res_steps / T,
                                              n_factors)])
    norm = math.gamma(alpha) * math.gamma(1.0 - alpha)
    m0 = (eta[1:] ** (1 - alpha) - eta[:-1] ** (1 - alpha)) / (1 - alpha)
    m1 = (eta[1:] ** (2 - alpha) - eta[:-1] ** (2 - alpha)) / (2 - alpha)
    return m0 / norm, m1 / m0


def lifted_log_terminals(p: dict, T: float, steps: int, c, x, draw):
    """(X, Xg) of lifted rough Heston and its GBM control leg, each (2, N);
    `draw(t)` gives step t's (2, N) normals (dW1, the orthogonal part of
    dB). p: lam, theta, nu, rho, v0, r, q as floats."""
    z0 = draw(0)
    dtype, device = z0.dtype, z0.device
    n = z0.shape[1]
    sign = torch.tensor([[1.0], [-1.0]], dtype=dtype, device=device)
    dt = T / steps
    sdt = math.sqrt(dt)
    c = torch.as_tensor(np.asarray(c), dtype=dtype, device=device)
    damp = (1.0 / (1.0 + torch.as_tensor(np.asarray(x), dtype=dtype,
                                         device=device) * dt))[:, None, None]
    rho_perp = math.sqrt(1.0 - p["rho"] ** 2)
    factors = torch.zeros((c.shape[0], 2, n), dtype=dtype, device=device)
    xs = torch.zeros((2, n), dtype=dtype, device=device)
    xg = torch.zeros_like(xs)
    sig_cv = math.sqrt(p["v0"])
    for t in range(steps):
        z = z0 if t == 0 else draw(t)
        a = sign * z[0]
        zv = p["rho"] * a + rho_perp * (sign * z[1])
        v = torch.clamp(p["v0"] + torch.tensordot(c, factors, dims=1),
                        min=0.0)
        sv = torch.sqrt(v)
        shock = p["lam"] * (p["theta"] - v) * dt + p["nu"] * sv * zv * sdt
        factors = (factors + shock) * damp
        xs = xs + (p["r"] - p["q"] - 0.5 * v) * dt + sv * a * sdt
        xg = xg + (p["r"] - p["q"] - 0.5 * p["v0"]) * dt + sig_cv * a * sdt
    return xs, xg
