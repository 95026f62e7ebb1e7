r"""Rough Bergomi (rBergomi) simulation in torch (counterpart of
`mcos_tpu/ops/rough.py`).

The model of Bayer-Friz-Gatheral (2016):

    v_t = xi(t) * exp(eta * W~_t - eta^2/2 * t^{2H}),
    dS/S = (r - q) dt + sqrt(v_t) (rho dW_t + sqrt(1-rho^2) dW'_t),

with W~ the Riemann-Liouville fractional Brownian motion
W~_t = sqrt(2H) \int_0^t (t-u)^{H-1/2} dW_u, Hurst H in (0, 1/2].

Three parts:

1. Host float64 (copied; tests/test_torch_copies.py and
   tests/test_torch_rough.py hold them equal to the JAX package's): the
   Volterra covariances, the cached factors of the joint (W~, dW)
   covariance (Cholesky, PCA, and the truncated conditional factor), the
   forward-variance curve bootstrap, and the Markovian-lift tables.
2. The exact sampler: one matrix product z @ A^T of standard normals with
   the (2n, 2n) factor gives the exact joint law of (W~ on the grid, dW);
   the price leg never simulates S, the Romano-Touzi conditional estimator
   integrates the orthogonal noise out (a Black formula per path on
   F_eff = S0 e^{(r-q)T + rho I1 - rho^2/2 I2}, s^2 = (1-rho^2) I2 with
   I1 = sum sqrt(v_i) dW_i and I2 = sum v_i dt). The product is a plain
   `torch.matmul` in full float32 (TF32 off: it would put ~1e-3 relative
   noise into W~).
3. The Markovian lift twins: W~_t ~= sum_j c_j Y_j(t) with
   Y_j <- d_j Y_j + g_j dW, plus an independent per-step top-up normal
   that makes every Var[W~_t] exact; a Python loop over steps carrying the
   (m, branches, paths) factor state, differentiable, with
   `torch.utils.checkpoint` per chunk of steps for autograd callers.
   Kernels K10 and K11 (`cuda_kernels.rbergomi_lift_integrals`,
   `rbergomi_lift_stats`; csrc/rbergomi_lift.cu, csrc/rbergomi_stats.cu)
   run the same recursions on the card from an in-kernel generator.

Every function that draws its own normals takes an explicit
`torch.Generator` and accepts the normals instead (`z=`, `draws=`), so the
tests can replay the JAX package's draws. Antithetic branches negate every
normal.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from scipy.special import hyp2f1
from torch.utils.checkpoint import checkpoint

from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu_torch.ops.roughheston import lifted_kernel_nodes
from mcos_tpu_torch.ops.simulate import _f32

# Full-precision float32 products for the exact sampler's matmul.
torch.backends.cuda.matmul.allow_tf32 = False


# ─────────────────────────────────────────────────────────────────────────────
# Parameters
# ─────────────────────────────────────────────────────────────────────────────
@dataclasses.dataclass(frozen=True)
class RoughBergomiParams:
    """rBergomi parameters. `hurst` is static (it shapes the host-side
    covariance); the Greeks' autograd pass replaces xi, eta, rho and r by
    0-d tensors."""

    xi: float = 0.04        # flat forward-variance level xi(t) = xi
    eta: float = 1.9        # vol-of-vol of the Wick exponential
    rho: float = -0.9       # spot/vol correlation
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    hurst: float = dataclasses.field(default=0.07,
                                     metadata={"static": True})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """{field: 0-d float64 array}: how parameters cross packages."""
        return {f.name: np.asarray(float(getattr(self, f.name)), np.float64)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, values: Mapping[str, object]
                   ) -> "RoughBergomiParams":
        """Build from a {field: number or 0-d array} mapping (every field)."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = [n for n in names if n not in values]
        if missing:
            raise KeyError(f"missing rough Bergomi fields: {missing}")
        return cls(**{n: float(np.asarray(values[n])) for n in names})


# ─────────────────────────────────────────────────────────────────────────────
# Exact joint covariance of (W~ grid values, dW increments) — host, f64
# ─────────────────────────────────────────────────────────────────────────────
def volterra_cov(s: np.ndarray, t: np.ndarray, hurst: float) -> np.ndarray:
    """E[W~_s W~_t] for the Riemann-Liouville fBM, elementwise.

    For s <= t:  C = 2H/(H+1/2) * s^{H+1/2} t^{H-1/2}
                     * 2F1(1, 1/2-H; H+3/2; s/t),
    which reduces to min(s,t) at H = 1/2 and to s^{2H} on the diagonal.
    """
    s = np.asarray(s, np.float64)
    t = np.asarray(t, np.float64)
    lo, hi = np.minimum(s, t), np.maximum(s, t)
    ratio = np.where(hi > 0.0, lo / np.where(hi > 0.0, hi, 1.0), 0.0)
    h = float(hurst)
    pref = 2.0 * h / (h + 0.5) * lo ** (h + 0.5) * hi ** (h - 0.5)
    return pref * hyp2f1(1.0, 0.5 - h, h + 1.5, ratio)


def volterra_increment_cov(t_grid: np.ndarray, hurst: float,
                           dt: float) -> np.ndarray:
    """E[W~_{t_i} dW_j] for grid-aligned increments dW_j over
    (t_{j-1}, t_j]:  sqrt(2H)/(H+1/2) * [(t_i-t_{j-1})^{H+1/2}
    - (t_i-t_j)^{H+1/2}]  for j <= i, zero for j > i."""
    h = float(hurst)
    n = len(t_grid)
    ti = np.asarray(t_grid, np.float64)[:, None]          # (n, 1)
    tj = np.asarray(t_grid, np.float64)[None, :]          # (1, n) right ends
    tjm1 = tj - dt
    a = np.maximum(ti - tjm1, 0.0) ** (h + 0.5)
    b = np.maximum(ti - tj, 0.0) ** (h + 0.5)
    out = np.sqrt(2.0 * h) / (h + 0.5) * (a - b)
    out[np.broadcast_to(tj, (n, n)) > ti + 1e-14] = 0.0
    return out


@lru_cache(maxsize=32)
def _factor_cached(hurst: float, T: float, num_steps: int,
                   transform: str, rank: int = 0) -> np.ndarray:
    """Factor A (f32, A Aᵀ ≈ cov) of the joint (2n, 2n) covariance of
    [W~_{t_1..t_n}, dW_{1..n}] on the uniform grid t_i = i*T/n.

    transform="cholesky": triangular factor. transform="pca":
    U diag(sqrt(lambda)) with eigenvalues descending, so the first input
    dimensions carry the largest variance directions (the QMC
    construction). Truncated factors go through
    `rbergomi_conditional_factor`.
    """
    n = int(num_steps)
    dt = float(T) / n
    t = dt * np.arange(1, n + 1)
    cov_w = volterra_cov(t[:, None], t[None, :], hurst)
    cross = volterra_increment_cov(t, hurst, dt)
    cov = np.empty((2 * n, 2 * n), np.float64)
    cov[:n, :n] = cov_w
    cov[:n, n:] = cross
    cov[n:, :n] = cross.T
    cov[n:, n:] = dt * np.eye(n)
    # Tiny diagonal lift: the W~ block is ill-conditioned for small H at
    # fine grids; 1e-12 relative is far below the f32 sampling noise.
    cov[np.diag_indices(2 * n)] += 1e-12 * cov.diagonal().max()
    if transform == "pca":
        lam, u = np.linalg.eigh(cov)          # ascending
        lam = np.maximum(lam[::-1], 0.0)
        return (u[:, ::-1] * np.sqrt(lam)[None, :]).astype(np.float32)
    if rank:
        raise ValueError(
            "rank truncation: use rbergomi_conditional_factor (or "
            "rbergomi_chol(transform='conditional', rank=k))")
    return np.linalg.cholesky(cov).astype(np.float32)


@lru_cache(maxsize=32)
def _conditional_factor_cached(hurst: float, T: float, num_steps: int,
                               rank: int):
    """(factor (2n, n+k), diag_tail (n,)): the structured factorization

        dW  = √dt · z                     exact (n iid columns)
        W~  = (cross/dt)·dW               exact (dense n×n block)
            + B_k · ε                     rank-k PCA of the residual
            + √diag_tail ⊙ ζ              exact diagonal tail, O(n)

    so the dW marginals, the W~/dW cross-covariance and every Var[W~_t]
    are exact; only rank-truncated off-diagonal residual correlations are
    approximate. Pass both outputs to `rbergomi_core`.
    """
    n = int(num_steps)
    k = int(rank)
    dt = float(T) / n
    t = dt * np.arange(1, n + 1)
    cov_w = volterra_cov(t[:, None], t[None, :], hurst)
    cross = volterra_increment_cov(t, hurst, dt)
    a = cross / dt                         # regression W~ on dW
    res = cov_w - cross @ cross.T / dt     # conditional covariance W~|dW
    res[np.diag_indices(n)] += 1e-12 * max(res.diagonal().max(), 1e-30)
    lam, u = np.linalg.eigh(res)           # ascending
    lam = np.maximum(lam[::-1][:k], 0.0)
    b = u[:, ::-1][:, :k] * np.sqrt(lam)[None, :]
    diag_tail = np.maximum(res.diagonal() - np.sum(b * b, axis=1), 0.0)
    fac = np.zeros((2 * n, n + k))
    fac[:n, :n] = a * np.sqrt(dt)
    fac[n:, :n] = np.sqrt(dt) * np.eye(n)
    fac[:n, n:] = b
    return fac.astype(np.float32), diag_tail.astype(np.float32)


def rbergomi_conditional_factor(hurst: float, T: float, num_steps: int,
                                rank: int = 32):
    """Public cached accessor for the truncated factorization:
    (factor, diag_tail) — pass BOTH to rbergomi_core /
    rbergomi_conditional_payoffs."""
    if rank <= 0:
        raise ValueError("conditional factorization needs rank > 0")
    return _conditional_factor_cached(
        round(float(hurst), 10), round(float(T), 10), int(num_steps),
        int(rank))


def rbergomi_chol(hurst: float, T: float, num_steps: int,
                  transform: str = "cholesky",
                  rank: int = 0) -> np.ndarray:
    """Public cached accessor (host). Keyed on rounded floats so jitter in
    float(T) does not defeat the cache. transform="conditional" returns
    only the dense factor — prefer `rbergomi_conditional_factor`, which
    also returns the diagonal tail the sampler needs for exact Var[W~]."""
    if transform == "conditional":
        if not rank:
            raise ValueError("transform='conditional' needs rank > 0")
        return rbergomi_conditional_factor(hurst, T, num_steps, rank)[0]
    return _factor_cached(round(float(hurst), 10), round(float(T), 10),
                          int(num_steps), transform, int(rank))


@lru_cache(maxsize=32)
def _device_factor(hurst: float, T: float, num_steps: int, transform: str,
                   device: str) -> torch.Tensor:
    """`rbergomi_chol` copied to `device` once per (H, T, n, transform)."""
    return torch.as_tensor(rbergomi_chol(hurst, T, num_steps, transform),
                           device=device)


def rbergomi_chol_device(hurst: float, T: float, num_steps: int,
                         transform: str = "cholesky",
                         device="cuda") -> torch.Tensor:
    """`rbergomi_chol` as a float32 tensor on `device`, cached (the 512-step
    factor is 4 MB; the PCA one costs a float64 `eigh` on first use)."""
    return _device_factor(round(float(hurst), 10), round(float(T), 10),
                          int(num_steps), transform, str(torch.device(device)))


def xi_curve_from_variance_swaps(maturities, var_strikes):
    """Bootstrap the piecewise-constant forward-variance curve from
    variance-swap quotes: K_var(T)^2 T = \\int_0^T xi(u) du, so between
    quote maturities  xi_i = (W_{i+1} - W_i) / (T_{i+1} - T_i)  with
    W_i = K_i^2 T_i. Returns (edges (m+1,), values (m,)) with edges[0]=0.
    """
    mats = np.asarray(maturities, np.float64)
    ks = np.asarray(var_strikes, np.float64)
    if np.any(np.diff(mats) <= 0):
        raise ValueError("maturities must be strictly increasing")
    w = ks**2 * mats
    w = np.concatenate([[0.0], w])
    edges = np.concatenate([[0.0], mats])
    vals = np.diff(w) / np.diff(edges)
    if np.any(vals <= 0):
        raise ValueError("variance-swap quotes imply a negative forward "
                         "variance (calendar arbitrage)")
    return edges, vals


def sample_xi_curve(edges, vals, T: float, num_steps: int) -> np.ndarray:
    """(num_steps,) forward variance at the left grid endpoints of [0, T];
    flat extrapolation beyond the last quote."""
    t_left = float(T) / num_steps * np.arange(num_steps)
    idx = np.clip(np.searchsorted(edges, t_left, side="right") - 1, 0,
                  len(vals) - 1)
    return np.asarray(vals)[idx].astype(np.float32)


# ─────────────────────────────────────────────────────────────────────────────
# Markovian-lift tables — host
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=32)
def _lift_cached(hurst: float, T: float, num_steps: int, n_factors: int):
    """Host-side lift tables for `rbergomi_core_lifted` and kernels K10/K11.

    The Volterra kernel sqrt(2H)·τ^{H-1/2} is a Laplace mixture; the
    moment-matched exponential-sum nodes of
    `ops/roughheston.py:lifted_kernel_nodes`, rescaled by
    κ = sqrt(2H)·Γ(H+1/2), give

        W~_t ≈ Σ_j c_j Y_j(t),   Y_j(t_{i+1}) = e^{-x_j dt} Y_j(t_i)
                                              + e^{-x_j dt/2} ΔW_{i+1}.

    A memoryless top-up node (d = 0, g = 1) carries the same-step
    cross-covariance E[W~_t ΔW_t] the fit on [dt, T] misses, and
    `tail[i] = t_{i+1}^{2H} − Var[W~^lift]` is added as an independent
    per-grid-point normal, so every marginal Var[W~_t] is exact.

    Returns f32 (c (m,), d (m,), g (m,), tail (n,)); m = n_factors + 1
    with the top-up node, 1 at H = 1/2.
    """
    h = float(hurst)
    n = int(num_steps)
    dt = float(T) / n
    c, x = lifted_kernel_nodes(round(h, 10), round(float(T), 10), dt,
                               int(n_factors))
    c = np.asarray(c, np.float64)
    x = np.asarray(x, np.float64)
    kappa = math.sqrt(2.0 * h) * math.gamma(h + 0.5)
    c = kappa * c
    d = np.exp(-x * dt)
    g = np.exp(-0.5 * x * dt)
    # E[W~ ΔW]_exact = sqrt(2H)/(H+1/2)·dt^{H+1/2}; the top-up node carries
    # what the fitted nodes miss of it.
    cross_exact = math.sqrt(2.0 * h) / (h + 0.5) * dt ** (h + 0.5)
    c0 = cross_exact / dt - float(np.sum(c * g))
    if c0 > 1e-12:
        c = np.append(c, c0)
        d = np.append(d, 0.0)
        g = np.append(g, 1.0)
    # Delivered Var[W~_{t_i}] under the recursion: Cov_Y(i) = D∘Cov_Y(i-1)
    # + G with D = d dᵀ, G = dt·g gᵀ (common ΔW across factors).
    D = np.outer(d, d)
    G = np.outer(g, g) * dt
    S = np.zeros_like(D)
    var_deliv = np.empty(n)
    for i in range(n):
        S = D * S + G
        var_deliv[i] = float(c @ S @ c)
    t = dt * np.arange(1, n + 1)
    tail = np.maximum(t ** (2.0 * h) - var_deliv, 0.0)
    return (c.astype(np.float32), d.astype(np.float32),
            g.astype(np.float32), tail.astype(np.float32))


def rbergomi_lift(hurst: float, T: float, num_steps: int,
                  n_factors: int = 24):
    """Public cached accessor: (c, d, g, tail) for rbergomi_core_lifted."""
    return _lift_cached(round(float(hurst), 10), round(float(T), 10),
                        int(num_steps), int(n_factors))


# ─────────────────────────────────────────────────────────────────────────────
# Exact sampler — one matmul + elementwise
# ─────────────────────────────────────────────────────────────────────────────
def _wick_var_left(chol: torch.Tensor, n: int,
                   diag_tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Left-point Var[W~_t] read off the factor itself: row i of the W~
    block has variance Σ_k A[i,k]² (+ the diagonal tail of the
    conditional factorization). For a truncated factor this is the
    variance the sampler delivers, which keeps E[v_t] = ξ(t) exact."""
    row_var = torch.sum(chol[:n] ** 2, dim=1)
    if diag_tail is not None:
        row_var = row_var + diag_tail
    return torch.cat([torch.zeros(1, dtype=row_var.dtype,
                                  device=row_var.device), row_var[:-1]])


def _xi_vec(params: RoughBergomiParams, xi_t, n: int, device):
    if xi_t is None:
        return params.xi * torch.ones(n, dtype=torch.float32, device=device)
    return _f32(xi_t, device)


def _signs(antithetic: bool):
    return (1.0, -1.0) if antithetic else (1.0,)


def rbergomi_core(params: RoughBergomiParams, T, chol,
                  generator: Optional[torch.Generator], *, num_paths: int,
                  num_steps: int, antithetic: bool = True,
                  z: Optional[torch.Tensor] = None, xi_t=None,
                  diag_tail=None, zd: Optional[torch.Tensor] = None,
                  device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Simulate the W-conditional sufficient statistics of rBergomi.

    Returns (v_mean_t, I1, I2):
      v_mean_t : (n,) grid-mean of v (diagnostic / E[v]=xi tests),
      I1       : (branches, paths) = sum_i sqrt(v_{i-1}) dW_i,
      I2       : (branches, paths) = sum_i v_{i-1} dt,
    antithetic branches on axis 0 (z and -z share one draw set).

    `z` supplies the (num_paths, chol.shape[1]) standard normals (QMC
    points through the PCA factor, or replayed draws); None draws them
    from `generator`. `diag_tail` (the conditional factorization's) adds n
    more normals per path, `zd`, drawn after z when not given. `xi_t` is
    the (n,) forward-variance curve at the left grid points; None uses
    the flat params.xi. Differentiable in the fields of `params` given as
    tensors.
    """
    device = z.device if z is not None else torch.device(device)
    n = num_steps
    chol = _f32(chol, device)
    dt = _f32(T, device) / n
    tail = None if diag_tail is None else _f32(diag_tail, device)
    wick_var = _wick_var_left(chol, n, tail)
    if z is None:
        z = torch.randn((num_paths, chol.shape[1]), generator=generator,
                        device=device, dtype=torch.float32)
    if tail is not None:
        if zd is None:
            zd = torch.randn((num_paths, n), generator=generator,
                             device=device, dtype=torch.float32)
        sqrt_tail = torch.sqrt(tail)
    xi_vec = _xi_vec(params, xi_t, n, device)
    # (-z) @ Aᵀ is exactly -(z @ Aᵀ): one product serves both branches.
    g = z @ chol.T                                        # (paths, 2n)
    zeros = torch.zeros((num_paths, 1), dtype=torch.float32, device=device)
    i1s, i2s, v_means = [], [], []
    for sign in _signs(antithetic):
        w_tilde = sign * g[:, :n]
        dw = sign * g[:, n:]
        if tail is not None:
            w_tilde = w_tilde + (sign * zd) * sqrt_tail[None, :]
        # Left-point W~: W~_{t_0}=0, then the first n-1 grid values.
        w_left = torch.cat([zeros, w_tilde[:, :-1]], dim=1)
        v = xi_vec[None, :] * torch.exp(
            params.eta * w_left
            - 0.5 * params.eta ** 2 * wick_var[None, :])
        i1s.append(torch.sum(torch.sqrt(v) * dw, dim=1))
        i2s.append(torch.sum(v, dim=1) * dt)
        v_means.append(torch.mean(v, dim=0))
    return (torch.mean(torch.stack(v_means), dim=0),
            torch.stack(i1s), torch.stack(i2s))


def _black_on_forward(F, K, s, is_call):
    """Undiscounted Black price with total volatility s = sigma*sqrt(T),
    smooth in all inputs (the s -> 0 limit is handled by a floor far below
    any realistic conditional vol)."""
    s = torch.clamp(s, min=1e-6)
    d1 = torch.log(F / K) / s + 0.5 * s
    d2 = d1 - s
    call = F * torch.special.ndtr(d1) - K * torch.special.ndtr(d2)
    return call if is_call else call - (F - K)            # Black parity


def _conditional_black(params: RoughBergomiParams, spot, strikes, T,
                       i1, i2, is_call) -> torch.Tensor:
    """Romano-Touzi payoff assembly shared by the exact-covariance and
    lifted samplers: per-path Black on F_eff = S0 e^{(r-q)T + rho I1 -
    rho^2/2 I2}, s^2 = (1-rho^2) I2. (branches, paths, strikes)."""
    f_eff = spot * torch.exp((params.r - params.q) * T
                             + params.rho * i1
                             - 0.5 * params.rho ** 2 * i2)
    s_eff = torch.sqrt(torch.clamp((1.0 - params.rho ** 2) * i2, min=0.0))
    return _black_on_forward(f_eff[..., None], strikes[None, None, :],
                             s_eff[..., None], is_call)


def _strikes(strikes, device) -> torch.Tensor:
    return torch.atleast_1d(_f32(strikes, device))


def rbergomi_conditional_payoffs(params: RoughBergomiParams, spot, strikes,
                                 T, chol, generator, *, num_paths: int,
                                 num_steps: int, is_call,
                                 antithetic: bool = True,
                                 z: Optional[torch.Tensor] = None,
                                 xi_t=None, diag_tail=None,
                                 zd: Optional[torch.Tensor] = None,
                                 device="cuda") -> torch.Tensor:
    """(branches, paths, strikes) per-path conditional Black payoffs
    (undiscounted): exact in the orthogonal noise, smooth for autograd.
    `z`, `zd`, `xi_t` and `diag_tail` as in `rbergomi_core`."""
    device = z.device if z is not None else torch.device(device)
    T_f = _f32(T, device)
    _, i1, i2 = rbergomi_core(params, T_f, chol, generator,
                              num_paths=num_paths, num_steps=num_steps,
                              antithetic=antithetic, z=z, xi_t=xi_t,
                              diag_tail=diag_tail, zd=zd, device=device)
    return _conditional_black(params, _f32(spot, device),
                              _strikes(strikes, device), T_f, i1, i2,
                              is_call)


def rbergomi_terminal(params: RoughBergomiParams, spot, T, chol, generator,
                      *, num_paths: int, num_steps: int,
                      antithetic: bool = True, draws=None,
                      device="cuda") -> torch.Tensor:
    """(branches, paths) terminal spots S_T via the plain estimator
    (explicit orthogonal noise: conditional on v, ∫√v dW' ~ N(0, I2), one
    normal per path, antithetic too). `draws` = (z (paths, 2n), zp
    (paths,)), else both come from `generator`, z first."""
    if draws is not None:
        z, zp = draws
        device = z.device
    else:
        device = torch.device(device)
        z = torch.randn((num_paths, chol.shape[1]), generator=generator,
                        device=device, dtype=torch.float32)
        zp = torch.randn((num_paths,), generator=generator, device=device,
                         dtype=torch.float32)
    T_f = _f32(T, device)
    _, i1, i2 = rbergomi_core(params, T_f, chol, None, num_paths=num_paths,
                              num_steps=num_steps, antithetic=antithetic,
                              z=z)
    zp = torch.stack([zp, -zp])[: i1.shape[0]]
    growth = ((params.r - params.q) * T_f - 0.5 * i2 + params.rho * i1
              + torch.sqrt(torch.clamp((1.0 - params.rho ** 2) * i2,
                                       min=0.0)) * zp)
    return _f32(spot, device) * torch.exp(growth)


def _sheet_draws(chol, num_paths: int, n: int, generator, draws, device):
    """(z (paths, 2n), zp (paths, n)) for the path sheets: given, or from
    `generator`, z first."""
    if draws is not None:
        return draws
    z = torch.randn((num_paths, chol.shape[1]), generator=generator,
                    device=device, dtype=torch.float32)
    zp = torch.randn((num_paths, n), generator=generator, device=device,
                     dtype=torch.float32)
    return z, zp


def _log_sheet(params: RoughBergomiParams, T_f, chol, z, zp, n: int, sign,
               xi_vec, wick_var, g):
    """One branch's (paths, n) log(S_t/S_0) sheet on t_1..t_n."""
    dt = T_f / n
    w_tilde, dw = sign * g[:, :n], sign * g[:, n:]
    zeros = torch.zeros((z.shape[0], 1), dtype=torch.float32,
                        device=z.device)
    w_left = torch.cat([zeros, w_tilde[:, :-1]], dim=1)
    v = xi_vec[None, :] * torch.exp(
        params.eta * w_left - 0.5 * params.eta ** 2 * wick_var[None, :])
    rho = _f32(params.rho, z.device)
    orth = torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
    dz = rho * dw + orth * (sign * zp) * torch.sqrt(dt)
    dlog = (params.r - params.q - 0.5 * v) * dt + torch.sqrt(v) * dz
    return torch.cumsum(dlog, dim=1)


def rbergomi_log_paths(params: RoughBergomiParams, T, chol, generator, *,
                       num_paths: int, num_steps: int,
                       antithetic: bool = True, xi_t=None, draws=None,
                       device="cuda") -> torch.Tensor:
    """(branches, paths, n) log(S_t/S_0) sheet on the grid t_1..t_n: the
    full-path variant of the exact sampler (one cumsum over the steps).
    `draws` = (z (paths, 2n), zp (paths, n)), else from `generator`."""
    device = draws[0].device if draws is not None else torch.device(device)
    n = num_steps
    chol = _f32(chol, device)
    T_f = _f32(T, device)
    z, zp = _sheet_draws(chol, num_paths, n, generator, draws, device)
    wick_var = _wick_var_left(chol, n)
    xi_vec = _xi_vec(params, xi_t, n, device)
    g = z @ chol.T
    return torch.stack([
        _log_sheet(params, T_f, chol, z, zp, n, sign, xi_vec, wick_var, g)
        for sign in _signs(antithetic)])


def rbergomi_path_stats(params: RoughBergomiParams, spot, T, chol,
                        generator, *, num_paths: int, num_steps: int,
                        antithetic: bool = True, draws=None,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Path statistics for path-dependent payoffs: per-branch
    (branches, paths) terminal, arithmetic mean, max and min of S over the
    observation grid t_1..t_n (t_0 excluded, as ops/exotics.py's trackers).
    The orthogonal leg needs explicit per-step normals here. `draws` =
    (z (paths, 2n), zp (paths, n)), else from `generator`."""
    device = draws[0].device if draws is not None else torch.device(device)
    n = num_steps
    chol = _f32(chol, device)
    T_f = _f32(T, device)
    spot = _f32(spot, device)
    z, zp = _sheet_draws(chol, num_paths, n, generator, draws, device)
    wick_var = _wick_var_left(chol, n)
    xi_vec = _xi_vec(params, None, n, device)
    g = z @ chol.T
    outs = {"s_terminal": [], "s_mean": [], "s_max": [], "s_min": []}
    for sign in _signs(antithetic):
        s = spot * torch.exp(_log_sheet(params, T_f, chol, z, zp, n, sign,
                                        xi_vec, wick_var, g))
        outs["s_terminal"].append(s[:, -1])
        outs["s_mean"].append(torch.mean(s, dim=1))
        outs["s_max"].append(torch.max(s, dim=1).values)
        outs["s_min"].append(torch.min(s, dim=1).values)
    return {k: torch.stack(v) for k, v in outs.items()}


# ─────────────────────────────────────────────────────────────────────────────
# Markovian lift twins — O(n·m) step loops
# ─────────────────────────────────────────────────────────────────────────────
def _lift_left_tables(tail, T, num_steps: int, hurst: float, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(√tail at the left points, t_i^{2H} at the left points), float32
    (n,) each, t_0 row first: √tail shifted by one step, t^{2H} = 0 at
    t = 0 — the twins' tables, as the JAX scans build them."""
    dt = _f32(T, device) / num_steps
    tail = _f32(tail, device)
    sqrt_tail_left = torch.cat([torch.zeros(1, dtype=torch.float32,
                                            device=device),
                                torch.sqrt(tail)[:-1]])
    t_left = dt * torch.arange(num_steps, dtype=torch.float32, device=device)
    wick_left = torch.where(t_left > 0.0, t_left,
                            torch.ones_like(t_left)) ** float(
        np.float32(2.0 * float(hurst)))
    wick_left = torch.where(t_left > 0.0, wick_left,
                            torch.zeros_like(wick_left))
    return sqrt_tail_left, wick_left


def _lift_draws(draws, generator, k: int, num_steps: int, num_paths: int,
                device) -> torch.Tensor:
    if draws is None:
        draws = torch.randn((num_steps, k, num_paths), generator=generator,
                            device=device, dtype=torch.float32)
    if tuple(draws.shape) != (num_steps, k, num_paths):
        raise ValueError(f"draws must be (steps, {k}, paths) normals")
    return draws


def rbergomi_core_lifted(params: RoughBergomiParams, T, generator, c, d, g,
                         tail, *, num_paths: int, num_steps: int,
                         antithetic: bool = True, xi_t=None,
                         remat_chunk: int = 0,
                         draws: Optional[torch.Tensor] = None,
                         device="cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`rbergomi_core`'s contract — (v_mean_t, I1, I2) — through the
    Markovian lift: a step loop carrying the (m, branches, paths) factor
    state instead of the (paths, 2n) covariance matmul.

    Same left-point v convention, same ΔW drives v and I1, antithetic
    branches negate both normals (ΔW and the tail top-up ζ). The Wick
    compensator uses t^{2H} exactly: the tail top-up makes the delivered
    Var[W~_t] exact.

    Randoms: `draws` (steps, 2, paths) normals (row 0 drives ΔW, row 1 the
    tail), else drawn from `generator` up front. `remat_chunk` > 0 runs
    each chunk of that many steps under `torch.utils.checkpoint`
    (non-reentrant): autograd then keeps only the chunk boundaries' carries
    and recomputes the inside on the backward pass.
    """
    device = draws.device if draws is not None else torch.device(device)
    n = num_steps
    draws = _lift_draws(draws, generator, 2, n, num_paths, device)
    T_f = _f32(T, device)
    dt = T_f / n
    sqrt_dt = torch.sqrt(dt)
    nb = 2 if antithetic else 1
    sign = torch.tensor([1.0, -1.0][:nb], dtype=torch.float32,
                        device=device)[:, None]
    c_ = _f32(c, device)[:, None, None]
    d_ = _f32(d, device)[:, None, None]
    g_ = _f32(g, device)[:, None, None]
    sqrt_tail_left, wick_left = _lift_left_tables(tail, T_f, n,
                                                 params.hurst, device)
    xi_vec = _xi_vec(params, xi_t, n, device)
    eta = params.eta

    def run(y, i1, i2, z_chunk, start):
        v_means = []
        for k in range(z_chunk.shape[0]):
            i = start + k
            dw = (z_chunk[k, 0] * sign) * sqrt_dt          # (nb, paths)
            zeta = z_chunk[k, 1] * sign
            w_left = torch.sum(c_ * y, dim=0) + sqrt_tail_left[i] * zeta
            v = xi_vec[i] * torch.exp(eta * w_left
                                      - 0.5 * eta * eta * wick_left[i])
            i1 = i1 + torch.sqrt(v) * dw
            i2 = i2 + v * dt
            y = d_ * y + g_ * dw[None]
            v_means.append(torch.mean(v))
        return y, i1, i2, torch.stack(v_means)

    zeros = torch.zeros((nb, num_paths), dtype=torch.float32, device=device)
    y = torch.zeros((c_.shape[0], nb, num_paths), dtype=torch.float32,
                    device=device)
    i1 = i2 = zeros
    if remat_chunk:
        if n % remat_chunk:
            raise ValueError(f"num_steps={n} not a multiple of "
                             f"remat_chunk={remat_chunk}")
        parts = []
        for start in range(0, n, remat_chunk):
            y, i1, i2, vm = checkpoint(
                run, y, i1, i2, draws[start:start + remat_chunk], start,
                use_reentrant=False)
            parts.append(vm)
        v_means = torch.cat(parts)
    else:
        y, i1, i2, v_means = run(y, i1, i2, draws, 0)
    return v_means, i1, i2


def rbergomi_lifted_payoffs(params: RoughBergomiParams, spot, strikes, T,
                            generator, c, d, g, tail, *, num_paths: int,
                            num_steps: int, is_call,
                            antithetic: bool = True, xi_t=None,
                            remat_chunk: int = 0,
                            draws: Optional[torch.Tensor] = None,
                            device="cuda") -> torch.Tensor:
    """`rbergomi_conditional_payoffs` through the lift twin
    (`rbergomi_core_lifted`): the same (branches, paths, strikes)
    conditional Black payoffs, O(n·m) instead of O(n²)."""
    device = draws.device if draws is not None else torch.device(device)
    T_f = _f32(T, device)
    _, i1, i2 = rbergomi_core_lifted(
        params, T_f, generator, c, d, g, tail, num_paths=num_paths,
        num_steps=num_steps, antithetic=antithetic, xi_t=xi_t,
        remat_chunk=remat_chunk, draws=draws, device=device)
    return _conditional_black(params, _f32(spot, device),
                              _strikes(strikes, device), T_f, i1, i2,
                              is_call)


def rbergomi_path_stats_lifted(params: RoughBergomiParams, spot, T,
                               generator, c, d, g, tail, *, num_paths: int,
                               num_steps: int, antithetic: bool = True,
                               xi_t=None,
                               draws: Optional[torch.Tensor] = None,
                               device="cuda") -> Dict[str, torch.Tensor]:
    """`rbergomi_path_stats` through the Markovian lift: the same carry
    recursion as `rbergomi_core_lifted` plus the spot leg,
    dz = ρ dW + √(1−ρ²) dW' with an explicit orthogonal normal per step,
    carrying (log S, Σ S, max log S, min log S). Antithetic branches
    negate all three normals. `draws` (steps, 3, paths) (rows ΔW, tail,
    orthogonal), else from `generator`. Returns the dict of
    (branches, paths) statistics over t_1..t_n."""
    device = draws.device if draws is not None else torch.device(device)
    n = num_steps
    draws = _lift_draws(draws, generator, 3, n, num_paths, device)
    spot = _f32(spot, device)
    T_f = _f32(T, device)
    dt = T_f / n
    sqrt_dt = torch.sqrt(dt)
    nb = 2 if antithetic else 1
    sign = torch.tensor([1.0, -1.0][:nb], dtype=torch.float32,
                        device=device)[:, None]
    c_ = _f32(c, device)[:, None, None]
    d_ = _f32(d, device)[:, None, None]
    g_ = _f32(g, device)[:, None, None]
    sqrt_tail_left, wick_left = _lift_left_tables(tail, T_f, n,
                                                 params.hurst, device)
    xi_vec = _xi_vec(params, xi_t, n, device)
    eta = _f32(params.eta, device)
    rho = _f32(params.rho, device)
    orth = torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
    mu_dt = (_f32(params.r, device) - _f32(params.q, device)) * dt

    y = torch.zeros((c_.shape[0], nb, num_paths), dtype=torch.float32,
                    device=device)
    log_s = torch.zeros((nb, num_paths), dtype=torch.float32, device=device)
    sum_s = torch.zeros_like(log_s)
    max_ls = torch.full_like(log_s, -math.inf)
    min_ls = torch.full_like(log_s, math.inf)
    for i in range(n):
        z = draws[i]
        dw = (z[0] * sign) * sqrt_dt                       # (nb, paths)
        zeta = z[1] * sign
        w_left = torch.sum(c_ * y, dim=0) + sqrt_tail_left[i] * zeta
        v = xi_vec[i] * torch.exp(eta * w_left
                                  - 0.5 * eta * eta * wick_left[i])
        dz = rho * dw + orth * (z[2] * sign) * sqrt_dt
        log_s = log_s + (mu_dt - 0.5 * v * dt) + torch.sqrt(v) * dz
        sum_s = sum_s + torch.exp(log_s)
        max_ls = torch.maximum(max_ls, log_s)
        min_ls = torch.minimum(min_ls, log_s)
        y = d_ * y + g_ * dw[None]
    return {
        "s_terminal": spot * torch.exp(log_s),
        "s_mean": spot * sum_s / float(n),
        "s_max": spot * torch.exp(max_ls),
        "s_min": spot * torch.exp(min_ls),
    }
