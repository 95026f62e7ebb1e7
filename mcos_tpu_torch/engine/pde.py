r"""Finite-difference pricers (counterpart of `mcos_tpu/engine/pde.py`):
the 1-D Crank-Nicolson grid for Black-Scholes / Dupire local vol, and the
2-D ADI solve of the Heston PDE (the Bates/SVJ PIDE with jumps).

    V_t + 1/2 sig(x,t)^2 V_xx + (r - q - 1/2 sig^2) V_x - r V = 0,

in log-spot x, backward from the payoff. The grids are an independent
cross-check on every MC price (different discretization, different error
structure) and price American exercise without regression noise.

Design on the card: every tridiagonal system the time loop solves is
known before the loop starts. Its diagonals depend only on the grid, the
local variance row and θ (1 for the two Rannacher start-up steps, ½
after), so the systems are inverted once, up front, by one batched
`torch.linalg.inv_ex` of their dense form (an LU with partial pivoting,
as LAPACK's `gtsv` pivots), and each implicit stage of the loop is one
batched matrix product:

- CN: one inverse per distinct (σ² row, θ) pair, found on the host (two
  under flat σ, up to n_t + 2 under local vol);
- ADI: the x-direction systems differ per variance row (a batch of n_v),
  the v-direction system is the same for every x column (one matrix,
  n_x right-hand sides); two of each, one per θ.

So the loop's op count depends on n_t and not on n_x or n_v (a batched
`lu_solve` is not so: on the card its kernel count grows with the
matrices' size). The inverses hold n_v·n_x² floats per θ: about 33 MB at
the default 201 × 101 grid, about 2 GB at the schema's largest,
801 × 401. They are well conditioned (I − θ·dt·A with A's rows
diagonally dominant but for the drift), and the grids agree with the
reference's `gtsv` solves to float32 rounding (tests/test_torch_pde.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu_torch.ops.simulate import _f32

# The PIDE's jump integral is a float32 matmul: no TF32 in it.
torch.backends.cuda.matmul.allow_tf32 = False


def _tridiagonal_inverse(dl: torch.Tensor, d: torch.Tensor,
                         du: torch.Tensor) -> torch.Tensor:
    """Inverses of the batched tridiagonal matrices whose row i holds dl[i]
    at column i−1, d[i] at i and du[i] at i+1 (dl[0] and du[−1] are not
    read): `(..., n)` diagonals → `(..., n, n)` inverses. A singular
    matrix gives non-finite entries, not an error (no host sync)."""
    n = d.shape[-1]
    a = torch.zeros((*d.shape, n), dtype=d.dtype, device=d.device)
    a.diagonal(dim1=-2, dim2=-1).copy_(d)
    a.diagonal(offset=-1, dim1=-2, dim2=-1).copy_(dl[..., 1:])
    a.diagonal(offset=1, dim1=-2, dim2=-1).copy_(du[..., :-1])
    return _batched_inverse(a)


def _batched_inverse(a: torch.Tensor) -> torch.Tensor:
    """One batched `inv_ex` on the card. On the CPU one matrix a call:
    torch's batched CPU LU (MKL getrf under intra-op threads) can fail
    with a LASWP argument error and then hang; one matrix cannot."""
    if a.device.type == "cuda" or a.dim() == 2:
        return torch.linalg.inv_ex(a)[0]
    n = a.shape[-1]
    return torch.stack([torch.linalg.inv_ex(m)[0]
                        for m in a.reshape(-1, n, n)]).reshape(a.shape)


def _interp(xq: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """`jnp.interp(xq, xp, fp)`: linear, clamped to fp's end values
    outside [xp[0], xp[−1]]."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, xq, right=True), 1, n - 1)
    f = fp[i - 1] + ((xq - xp[i - 1]) / (xp[i] - xp[i - 1])) \
        * (fp[i] - fp[i - 1])
    f = torch.where(xq < xp[0], fp[0], f)
    return torch.where(xq > xp[-1], fp[-1], f)


def _cn_solve(sig2_grid, strike, T, r, q, x_grid, div_shift, *,
              n_x: int, n_t: int, is_call: bool, american: bool,
              device="cuda"):
    """Backward theta-scheme on the log-spot grid; returns (V(t=0, x),
    s_stars) as (n_x,) and (n_t,) float32 tensors on `device`.

    sig2_grid: (n_t, n_x) host array, the local variance at each
    (time-step, node) — a constant array for Black-Scholes, the Dupire
    table for local vol. Time index 0 is the step nearest maturity
    (backward order).

    div_shift: (n_t,) host array, per-step log-shift for discrete
    PROPORTIONAL dividends. When step k's interval contains an ex-date
    with fraction d, div_shift[k] = log(1 - d) and the jump condition
    V(t⁻, x) = V(t⁺, x + log(1-d)) is applied by linear interpolation on
    the grid (zero entries are a no-op, skipped on the host).
    """
    device = torch.device(device)
    sig2_host = np.asarray(sig2_grid, np.float32).reshape(n_t, n_x)
    div_host = np.asarray(div_shift, np.float32).reshape(n_t)
    x_grid = _f32(np.asarray(x_grid, np.float32), device)
    strike, r, q = (_f32(a, device) for a in (strike, r, q))
    dt = _f32(T, device) / n_t
    dx = x_grid[1] - x_grid[0]
    s_grid = torch.exp(x_grid)
    phi = 1.0 if is_call else -1.0
    intrinsic = torch.clamp(phi * (s_grid - strike), min=0.0)

    # The distinct (σ² row, θ) systems: θ = 1 on the two Rannacher steps.
    rows, row_of_step = np.unique(sig2_host, axis=0, return_inverse=True)
    keys = 2 * row_of_step.reshape(n_t) + (np.arange(n_t) < 2)
    sys_keys, sys_of_step = np.unique(keys, return_inverse=True)
    sig2_sys = _f32(rows[sys_keys // 2], device)             # (n_sys, n_x)
    theta_im = torch.where(torch.arange(n_t, device=device) < 2, 1.0,
                           0.5) * dt                           # (n_t,)
    theta_ex = dt - theta_im
    th_sys = _f32(np.where(sys_keys % 2 == 1, 1.0, 0.5), device) * dt

    # L's three coefficients per system: V_xx weight a, V_x weight b.
    a = 0.5 * sig2_sys / dx**2
    b = (r - q - 0.5 * sig2_sys) / (2.0 * dx)
    l_lo, l_mid, l_hi = a - b, -2.0 * a - r, a + b
    th = th_sys[:, None]
    sub, diag, sup = -(th * l_lo), 1.0 - th * l_mid, -(th * l_hi)
    # Dirichlet rows: identity on the first/last node.
    for t in (sub, diag, sup):
        t[:, 0] = 0.0
        t[:, -1] = 0.0
    diag[:, 0] = 1.0
    diag[:, -1] = 1.0
    inv = _tridiagonal_inverse(sub, diag, sup)

    # Dirichlet values at x_min / x_max from discounted asymptotics.
    tau = (torch.arange(n_t, dtype=torch.float32, device=device) + 1.0) * dt
    disc_r, disc_q = torch.exp(-r * tau), torch.exp(-q * tau)
    zero = torch.zeros_like(tau)
    if is_call:
        lo_bc, hi_bc = zero, s_grid[-1] * disc_q - strike * disc_r
    else:
        lo_bc, hi_bc = strike * disc_r - s_grid[0] * disc_q, zero

    v = intrinsic
    s_stars = []
    for k in range(n_t):
        j = int(sys_of_step[k])
        # (I + θ_ex·L) v with wrapped neighbours; the boundary rows are
        # overwritten by the Dirichlet values.
        lv = (l_lo[j] * torch.roll(v, 1) + l_mid[j] * v
              + l_hi[j] * torch.roll(v, -1))
        rhs = v + theta_ex[k] * lv
        rhs[0] = lo_bc[k]
        rhs[-1] = hi_bc[k]
        v_new = inv[j] @ rhs
        if div_host[k] != 0.0:
            # Crossing the ex-date backwards, V(t⁻, x) = V(t⁺, x + log(1-d)).
            v_new = _interp(x_grid + _f32(div_host[k], device), x_grid,
                            v_new)
        if american:
            # Early-exercise boundary at this time-to-maturity: the edge
            # of the region where continuation < intrinsic (projection
            # binding). Puts exercise below s*, calls above; ±inf encodes
            # "no exercise anywhere" (→ NaN on the host).
            binding = (v_new < intrinsic) & (intrinsic > 0.0)
            if is_call:
                s_stars.append(torch.amin(torch.where(
                    binding, s_grid, torch.inf)))
            else:
                s_stars.append(torch.amax(torch.where(
                    binding, s_grid, -torch.inf)))
            v_new = torch.maximum(v_new, intrinsic)
        v = v_new
    s_stars = (torch.stack(s_stars) if american else
               torch.full((n_t,), torch.nan, dtype=torch.float32,
                          device=device))
    return v, s_stars


def _proportional_shifts(dividends, T: float, n_t: int,
                         check: bool) -> np.ndarray:
    """(n_t,) per-step log-shifts of [(t_ex, fraction), ...]: backward step
    k covers calendar (T-(k+1)dt, T-k·dt]."""
    div_shift = np.zeros(n_t, np.float32)
    if dividends:
        dt = T / n_t
        for t_ex, frac in dividends:
            if not 0.0 < t_ex < T:
                continue
            if check and not 0.0 <= frac < 1.0:
                raise ValueError("dividend fraction must be in [0, 1)")
            k = min(int((T - t_ex) / dt), n_t - 1)
            div_shift[k] += np.log1p(-frac)
    return div_shift


class PDEEngine:
    """Crank-Nicolson pricer for European/American vanillas under
    Black-Scholes or a Dupire local-vol surface, on `device` (default the
    card)."""

    def __init__(self, sigma: Optional[float] = None, localvol=None,
                 r: float = RISK_FREE_RATE, q: float = DIVIDEND_YIELD,
                 n_x: int = 401, n_t: int = 256, x_span: float = 4.0,
                 device="cuda"):
        """Either a flat `sigma` or a local-vol surface: an object with
        `local_var`, `y_grid`, `r`, `q` and `step_tables(T, n_t)`, read on
        the host (engine/localvol.py's `LocalVolSurface` in the reference)."""
        if (sigma is None) == (localvol is None):
            raise ValueError("pass exactly one of sigma / localvol")
        self.sigma = None if sigma is None else float(sigma)
        self.localvol = localvol
        self.r = float(r if localvol is None else localvol.r)
        self.q = float(q if localvol is None else localvol.q)
        self.n_x = int(n_x)
        self.n_t = int(n_t)
        self.x_span = float(x_span)
        self.device = torch.device(device)

    def _grids(self, spot: float, strike: float, T: float):
        """(x (n_x,), sig2 (n_t, n_x)) host float32 arrays."""
        # Center the grid between spot and strike; span ±x_span vol-stds.
        sig0 = self.sigma if self.sigma is not None else float(
            np.sqrt(np.median(self.localvol.local_var)))
        center = 0.5 * (np.log(spot) + np.log(strike))
        half = max(self.x_span * sig0 * np.sqrt(max(T, 0.05)), 0.5)
        x = np.linspace(center - half, center + half, self.n_x)
        if self.sigma is not None:
            sig2 = np.full((self.n_t, self.n_x), sig0 ** 2, np.float32)
        else:
            # Dupire rows resampled at step midpoints (step_tables), then
            # interpolated onto this grid's y = x - log F_t coordinate.
            # Backward ordering: step k covers calendar time
            # t = T - (k + 1/2) * dt.
            rows, t_mid = self.localvol.step_tables(T, self.n_t)
            lv = self.localvol
            sig2 = np.empty((self.n_t, self.n_x), np.float32)
            for k in range(self.n_t):
                t = float(T - t_mid[k])                 # backward index
                ti = int(np.clip(np.searchsorted(t_mid, t), 0,
                                 self.n_t - 1))
                y = x - (np.log(spot) + (self.r - self.q) * max(t, 1e-4))
                sig2[k] = np.interp(y, lv.y_grid, rows[ti],
                                    left=rows[ti][0], right=rows[ti][-1])
        return x.astype(np.float32), sig2

    def _solve(self, spot, strike, T, is_call, american, div_shift):
        x, sig2 = self._grids(spot, strike, T)
        v, s_stars = _cn_solve(sig2, strike, T, self.r, self.q, x,
                               div_shift, n_x=self.n_x, n_t=self.n_t,
                               is_call=is_call, american=american,
                               device=self.device)
        v, s_stars = (a.cpu().numpy().astype(np.float64)
                      for a in (v, s_stars))
        return x.astype(np.float64), v, s_stars

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True, american: bool = False,
              dividends=None) -> Dict[str, float]:
        """`dividends`: optional [(t_ex, fraction), ...] discrete
        PROPORTIONAL dividends (S drops to S(1-frac) at t_ex); under
        flat vol the European price equals BS at S0·Π(1-frac_i) — the
        classic exact adjustment, used as the test oracle. American
        calls regain early-exercise value just before ex-dates."""
        div_shift = _proportional_shifts(dividends, T, self.n_t, True)
        xg, v, _ = self._solve(spot, strike, T, is_call, american,
                               div_shift)
        x0 = np.log(spot)
        price = float(np.interp(x0, xg, v))
        # Spatial Greeks from the grid: dV/dS = (dV/dx)/S etc.
        dvdx = np.gradient(v, xg)
        d2vdx2 = np.gradient(dvdx, xg)
        delta = float(np.interp(x0, xg, dvdx)) / spot
        gamma = (float(np.interp(x0, xg, d2vdx2))
                 - float(np.interp(x0, xg, dvdx))) / spot**2
        return {
            "price": price,
            "delta": delta,
            "gamma": gamma,
            "n_x": self.n_x,
            "n_t": self.n_t,
            "method": "crank-nicolson" + ("-projected" if american else ""),
        }

    def exercise_boundary(self, spot: float, strike: float, T: float,
                          is_call: bool = False,
                          dividends=None) -> Dict:
        """Early-exercise boundary S*(t) of the American contract.

        Extracted inside the same Crank–Nicolson loop that prices the
        option: at each backward step the projection's binding edge (where
        continuation < intrinsic meets intrinsic > 0) is the boundary node
        — no extra solve, no regression noise. Returned in calendar time,
        ascending; NaN where exercise is never optimal at that date (e.g.
        anywhere on a q=0 American call). The boundary converges to the
        strike (puts, q≤r) as t→T.
        """
        div_shift = _proportional_shifts(dividends, T, self.n_t, False)
        xg, v, s_stars = self._solve(spot, strike, T, is_call, True,
                                     div_shift)
        s_stars[~np.isfinite(s_stars)] = np.nan
        # Backward step k sits at time-to-maturity (k+1)·dt ⇒ calendar
        # t = T − (k+1)·dt; reverse into ascending calendar order.
        dt = T / self.n_t
        t_cal = T - (np.arange(self.n_t) + 1.0) * dt
        order = np.argsort(t_cal)
        price = float(np.interp(np.log(spot), xg, v))
        return {
            "t": t_cal[order].tolist(),
            "s_star": s_stars[order].tolist(),
            "price": price,
            "strike": float(strike),
            "is_call": bool(is_call),
        }


# ─────────────────────────────────────────────────────────────────────────────
# 2-D ADI Heston PDE: the second independent method for the flagship
# stochastic-vol model itself (the CN engine above covers BS / local vol).
# ─────────────────────────────────────────────────────────────────────────────


def _merton_jump_tables(x: np.ndarray, lam: float, mu_j: float,
                        sig_j: float):
    """Host-f64 discretization of the Merton jump operator on a UNIFORM
    log-spot grid, for the Bates PIDE's integral term

        lam * ( ∫ V(x+y) phi(y; mu_J, sig_J) dy  -  V(x) ).

    Cell-mass quadrature: W[i, j] = P(y ∈ cell_j - x_i) — exact Gaussian
    mass per cell, so each row plus its two tail probabilities sums to 1
    EXACTLY. Piecewise-constant-in-cell is midpoint-rule O(dx²) for the
    smooth post-smoothing V. The mass landing beyond the grid multiplies
    the same Dirichlet asymptotes the x-edge boundary conditions use, via
    the analytic partial moments

        p_hi_i = P(y > a_i),          e_hi_i = E[e^y; y > a_i],
        p_lo_i = P(y < b_i),          e_lo_i = E[e^y; y < b_i],

    with a_i / b_i the distance from node i to the grid's outer cell
    faces and E[e^y; y > a] = e^{mu+sig²/2} Phi((mu+sig² − a)/sig).
    Returns host float64 tables (lam, kbar, W, p_hi, p_lo, e_hi, e_lo)
    (`_adi_heston_solve` takes them to float32 on its device); kbar =
    E[e^J − 1] is the drift compensator."""
    from scipy.special import ndtr

    if sig_j <= 0.0:
        raise ValueError(
            "sigma_j must be > 0 when lambda_j > 0 for the PIDE grid "
            "(the Merton cell-mass quadrature divides by sigma_j)")

    x = np.asarray(x, np.float64)
    dx = x[1] - x[0]
    kbar = float(np.exp(mu_j + 0.5 * sig_j**2) - 1.0)
    dxx = x[None, :] - x[:, None]                    # y_ij = x_j - x_i
    W = (ndtr((dxx + 0.5 * dx - mu_j) / sig_j)
         - ndtr((dxx - 0.5 * dx - mu_j) / sig_j))    # (n_x, n_x) cell mass
    a_hi = x[-1] + 0.5 * dx - x                      # upper tail starts
    b_lo = x[0] - 0.5 * dx - x                       # lower tail ends
    m1 = np.exp(mu_j + 0.5 * sig_j**2)
    p_hi = ndtr((mu_j - a_hi) / sig_j)
    p_lo = ndtr((b_lo - mu_j) / sig_j)
    e_hi = m1 * ndtr((mu_j + sig_j**2 - a_hi) / sig_j)
    e_lo = m1 * ndtr((b_lo - mu_j - sig_j**2) / sig_j)
    return (float(lam), kbar, W, p_hi, p_lo, e_hi, e_lo)


def _adi_heston_solve(strike, T, r, q, kappa, theta, xi, rho,
                      x_grid, v_grid, rebate=0.0, jump=None, *,
                      n_x: int, n_v: int,
                      n_t: int, is_call: bool, american: bool,
                      scheme: str = "cs", x_lo_bc: str = "asym",
                      x_hi_bc: str = "asym", rebate_at_hit: bool = False,
                      device="cuda"):
    r"""Backward ADI solve of the 2-D Heston PDE in (x = ln S, v):

        V_t + 1/2 v V_xx + (r - q - v/2) V_x + rho xi v V_xv
            + 1/2 xi^2 v V_vv + kappa(theta - v) V_v - r V = 0,

    or, when `jump` carries the `_merton_jump_tables` tuple, the full
    Bates/SVJ partial integro-differential equation: the x-drift gains the
    compensator −lam·kbar, the reaction gains −lam·V, and the nonlocal
    integral lam·∫V(x+y)phi(y)dy enters as ONE (n_v, n_x)·(n_x, n_x)
    matmul per application. The integral is explicit (IMEX à la In 't
    Hout-Toivanen); the CS corrector sweep includes it.

    Operator split (In 't Hout & Foulon 2010): A0 = the mixed derivative
    (always explicit), A1 = the x-direction operator, A2 = the v-direction
    operator, each carrying half of the -rV reaction term. Each implicit
    stage is one batched product with inverses computed before the loop
    (module docstring). Schemes: "douglas" (one predictor + two
    implicit legs) or "cs" (Craig-Sneyd: a second corrector sweep restores
    second-order accuracy in time with the mixed term). The v = 0 edge uses
    the degenerate PDE (drift-only, one-sided V_v); v_max takes Neumann,
    the x edges the large-|x| Dirichlet asymptotics. American exercise by
    projection after each full step. Rannacher start-up: the first two
    steps run fully implicit with the mixed term off.

    Barrier variant: `x_lo_bc`/`x_hi_bc` = "barrier" makes that x edge an
    absorbing knock-out boundary sitting EXACTLY on the grid edge — the
    Dirichlet value is the `rebate` (paid at hit: R; at expiry:
    R·e^{-r·tau}). American projection skips the absorbing edges.

    x_grid, v_grid: host arrays. Returns (V(t=0) (n_v, n_x), s_stars
    (n_t, n_v)) float32 tensors on `device`.
    """
    device = torch.device(device)
    f = lambda a: _f32(a, device)  # noqa: E731
    strike, r, q, kappa, theta, xi, rho, rebate = (
        f(a) for a in (strike, r, q, kappa, theta, xi, rho, rebate))
    x_grid = f(np.asarray(x_grid, np.float32))
    v_grid = f(np.asarray(v_grid, np.float32))
    dt = f(T) / n_t
    dx = x_grid[1] - x_grid[0]
    dv = v_grid[1] - v_grid[0]
    s_grid = torch.exp(x_grid)                     # (n_x,)
    v_col = v_grid[:, None]                        # (n_v, 1)
    phi = 1.0 if is_call else -1.0
    intrinsic = torch.clamp(phi * (s_grid[None, :] - strike), min=0.0)

    if jump is not None:
        lam, kbar = f(jump[0]), f(jump[1])
        w_t = f(jump[2]).T.contiguous()
        p_hi, p_lo, e_hi, e_lo = (f(a) for a in jump[3:])
    # Jump compensator shifts the risk-neutral x-drift: r - q - lam*kbar.
    comp = 0.0 if jump is None else lam * kbar

    # A1 (x-direction) coefficients, (n_v, n_x); zero at the x edges
    # (Dirichlet). Central differencing throughout (exponential fitting
    # smears low-variance rows; the reference measured both).
    a = 0.5 * v_col / dx**2
    b = (r - q - comp - 0.5 * v_col) / (2.0 * dx)
    x_interior = torch.ones((n_x,), dtype=torch.float32, device=device)
    x_interior[0] = 0.0
    x_interior[-1] = 0.0
    a1_sub = (a - b) * x_interior[None, :]
    a1_diag = (-2.0 * a - 0.5 * r) * torch.ones(
        (n_v, n_x), dtype=torch.float32, device=device) * x_interior[None, :]
    a1_sup = (a + b) * x_interior[None, :]

    # A2 (v-direction) coefficients, one per v row (the same for every x
    # column); the v = 0 row is the degenerate drift-only PDE with
    # one-sided V_v, the v_max row is zero (Neumann, set in the solve).
    c = 0.5 * xi**2 * v_col / dv**2
    e = kappa * (theta - v_col) / (2.0 * dv)
    a2_sub, a2_diag, a2_sup = c - e, -2.0 * c - 0.5 * r, c + e
    e0 = kappa * theta / dv                        # forward difference at v=0
    a2_sub[0] = 0.0
    a2_sub[-1] = 0.0
    a2_diag[0] = -e0 - 0.5 * r
    a2_diag[-1] = 0.0
    a2_sup[0] = e0
    a2_sup[-1] = 0.0

    # Mixed-term coefficient rho*xi*v / (4 dx dv), interior only.
    v_interior = torch.ones((n_v,), dtype=torch.float32, device=device)
    v_interior[0] = 0.0
    v_interior[-1] = 0.0
    mix = (rho * xi * v_col / (4.0 * dx * dv)) \
        * v_interior[:, None] * x_interior[None, :]

    # The implicit systems, inverted once per θ: index 0 for th = dt (the
    # Rannacher steps), 1 for th = dt/2.
    x_inv, v_inv = [], []
    for th in (1.0 * dt, 0.5 * dt):
        x_inv.append(_tridiagonal_inverse(-th * a1_sub, 1.0 - th * a1_diag,
                                          -th * a1_sup))
        dl = (-th * a2_sub)[:, 0].clone()
        dl[-1] = -1.0                      # y[n_v-1] - y[n_v-2] = 0
        v_inv.append(_tridiagonal_inverse(dl, (1.0 - th * a2_diag)[:, 0],
                                          (-th * a2_sup)[:, 0]))

    def apply_a1(u):
        return (a1_sub * torch.roll(u, 1, 1) + a1_diag * u
                + a1_sup * torch.roll(u, -1, 1))

    def apply_a2(u):
        return (a2_sub * torch.roll(u, 1, 0) + a2_diag * u
                + a2_sup * torch.roll(u, -1, 0))

    def apply_a0(u):
        # V_xv by central differences of the four diagonal neighbours.
        upp = torch.roll(torch.roll(u, -1, 0), -1, 1)
        upm = torch.roll(torch.roll(u, -1, 0), 1, 1)
        ump = torch.roll(torch.roll(u, 1, 0), -1, 1)
        umm = torch.roll(torch.roll(u, 1, 0), 1, 1)
        return mix * (upp - upm - ump + umm)

    # Per-step edge values, all steps at once: tau_k = (k + 1)·dt.
    tau = (torch.arange(n_t, dtype=torch.float32, device=device)
           + 1.0)[:, None] * dt                    # (n_t, 1)
    disc_r, disc_q = torch.exp(-r * tau), torch.exp(-q * tau)
    zero = torch.zeros_like(tau)
    barrier_val = rebate + zero if rebate_at_hit else rebate * disc_r
    if is_call:
        x_lo, x_hi = zero, s_grid[-1] * disc_q - strike * disc_r
    else:
        x_lo, x_hi = strike * disc_r - s_grid[0] * disc_q, zero
    if x_lo_bc == "barrier":
        x_lo = barrier_val
    if x_hi_bc == "barrier":
        x_hi = barrier_val

    if jump is not None:
        # (n_t, n_x) value of the jump mass landing beyond the grid: the
        # SAME Dirichlet asymptotes as the edges, integrated against the
        # analytic tail moments of the jump law (barrier edges are the
        # knock-out value: a jump OVERSHOOTING the barrier kills the
        # contract).
        if x_hi_bc == "barrier":
            t_hi = barrier_val * p_hi
        elif is_call:
            t_hi = disc_q * s_grid * e_hi - strike * disc_r * p_hi
            if american:
                # Deep-ITM American value ~ max(European asymptote,
                # intrinsic), taken elementwise in expectation.
                t_hi = torch.maximum(t_hi, s_grid * e_hi - strike * p_hi)
        else:
            t_hi = torch.zeros((n_t, n_x), dtype=torch.float32,
                               device=device)
        if x_lo_bc == "barrier":
            t_lo = barrier_val * p_lo
        elif is_call:
            t_lo = torch.zeros((n_t, n_x), dtype=torch.float32,
                               device=device)
        else:
            t_lo = strike * disc_r * p_lo - disc_q * s_grid * e_lo
            if american:
                t_lo = torch.maximum(t_lo, strike * p_lo - s_grid * e_lo)
        tails = t_lo + t_hi

    def apply_jump(u, tails_k):
        # (Wu)_i = sum_j W[i,j] u_j per v-row: one matmul. Applying W to
        # u − δ²u/24 (δ² = the centered second difference) cancels the
        # midpoint rule's leading error term, restoring O(dx⁴). Edge cells
        # replicate the neighbour's curvature.
        d2 = torch.roll(u, -1, 1) - 2.0 * u + torch.roll(u, 1, 1)
        d2[:, 0] = d2[:, 1]
        d2[:, -1] = d2[:, -2]
        return lam * ((u - d2 / 24.0) @ w_t + tails_k[None, :] - u)

    def solve_x(rhs, i, k):
        """(I - th*A1) y = rhs with x-edge Dirichlet rows."""
        rhs[:, 0] = x_lo[k]
        rhs[:, -1] = x_hi[k]
        return (x_inv[i] @ rhs[:, :, None])[:, :, 0]

    def solve_v(rhs, i):
        """(I - th*A2) y = rhs with the Neumann v_max row
        (y[n_v-1] - y[n_v-2] = 0)."""
        rhs[-1, :] = 0.0
        return v_inv[i] @ rhs

    proj_mask = torch.ones((n_x,), dtype=torch.bool, device=device)
    u = intrinsic.expand(n_v, n_x).clone()
    if x_lo_bc == "barrier":
        u[:, 0] = rebate
        proj_mask[0] = False
    if x_hi_bc == "barrier":
        u[:, -1] = rebate
        proj_mask[-1] = False

    s_stars = []
    for k in range(n_t):
        startup = k < 2
        i = 0 if startup else 1
        th = dt if startup else 0.5 * dt
        a1_u = apply_a1(u)
        a2_u = apply_a2(u)
        total = a1_u + a2_u
        if not startup:
            a0_u = apply_a0(u)
            total = a0_u + a1_u + a2_u
        if jump is not None:
            aj_u = apply_jump(u, tails[k])
            total = total + aj_u
        y0 = u + dt * total
        y1 = solve_x(y0 - th * a1_u, i, k)
        y2 = solve_v(y1 - th * a2_u, i)
        if scheme == "cs":
            y0h = y0
            if not startup:
                y0h = y0h + 0.5 * dt * (apply_a0(y2) - a0_u)
            if jump is not None:
                y0h = y0h + 0.5 * dt * (apply_jump(y2, tails[k]) - aj_u)
            y1h = solve_x(y0h - th * a1_u, i, k)
            y2 = solve_v(y1h - th * a2_u, i)
        u_new = y2
        u_new[:, 0] = x_lo[k]
        u_new[:, -1] = x_hi[k]
        u_new[-1, :] = u_new[-2, :]        # Neumann: V_v = 0 at v_max
        if american:
            # Projection skips absorbing (knock-out) edges: dead there.
            # The binding edge per v-row is the exercise boundary S*(t, v).
            binding = (u_new < intrinsic) & (intrinsic > 0.0) \
                & proj_mask[None, :]
            if is_call:
                s_stars.append(torch.amin(torch.where(
                    binding, s_grid[None, :], torch.inf), dim=1))
            else:
                s_stars.append(torch.amax(torch.where(
                    binding, s_grid[None, :], -torch.inf), dim=1))
            u_new = torch.where(proj_mask[None, :],
                                torch.maximum(u_new, intrinsic), u_new)
        u = u_new
    s_stars = (torch.stack(s_stars) if american else
               torch.full((n_t, n_v), torch.nan, dtype=torch.float32,
                          device=device))
    return u, s_stars


class HestonPDEEngine:
    """ADI finite-difference pricer for the 2-D Heston PDE — and, with
    `params.lambda_j > 0`, the full Bates/SVJ PIDE (the flagship model,
    jumps included): the Merton integral term rides one matmul per
    application (`_merton_jump_tables`), cross-checkable against the COS
    oracle (`ops/cos_pricer.py:cos_price`, the exact Bates CF). On
    `device`, default the card.

    The third independent numerical route to the flagship model (after
    Monte Carlo and COS): a deterministic (x, v) grid with a different
    error structure, and the only one of the three that prices *American*
    exercise under stochastic volatility without regression noise.
    """

    def __init__(self, params, n_x: int = 201, n_v: int = 101,
                 n_t: int = 128, x_span: float = 4.0,
                 scheme: str = "cs", device="cuda"):
        if scheme not in ("cs", "douglas"):
            raise ValueError("scheme must be 'cs' or 'douglas'")
        self.params = params
        self.n_x = int(n_x)
        self.n_v = int(n_v)
        self.n_t = int(n_t)
        self.x_span = float(x_span)
        self.scheme = scheme
        self.jumps = float(params.lambda_j) != 0.0
        self.device = torch.device(device)

    def _jump_tables(self, x):
        if not self.jumps:
            return None
        p = self.params
        return _merton_jump_tables(np.asarray(x, np.float64),
                                   float(p.lambda_j), float(p.mu_j),
                                   float(p.sigma_j))

    def _resolution(self, width: float, T: float):
        """Effective (n_x, n_t) for one solve. Jump regimes need two
        guards the user-facing defaults can't know about:

        * the explicit IMEX jump stage is only conditionally stable —
          sub-step until λ·dt ≤ 0.5 (λ·dt ≈ 1 is the stability edge);
        * the cell-mass quadrature must resolve the jump law — refine x
          until dx ≤ 0.75·σ_J (capped at 801 nodes; with the δ²/24
          correction in `apply_jump` the error there is O(dx⁴)).

        Values are rounded up onto a coarse menu (multiples of 32 steps /
        100 nodes)."""
        n_x, n_t = self.n_x, self.n_t
        if self.jumps:
            p = self.params
            need_t = int(np.ceil(2.0 * float(p.lambda_j) * max(T, 0.0)))
            if need_t > n_t:
                n_t = int(32 * np.ceil(need_t / 32.0))
            need_x = int(np.ceil(
                width / max(0.75 * float(p.sigma_j), 1e-6))) + 1
            if need_x > n_x:
                n_x = min(int(100 * np.ceil((need_x - 1) / 100.0)) + 1,
                          801)
        return n_x, n_t

    def _grids(self, spot: float, strike: float, T: float):
        """(x, v) host float32 grids and the solve's (n_x, n_t)."""
        p = self.params
        v_char = max(float(p.v0), float(p.theta))
        # Jumps widen the terminal law: add the jump variance-per-year
        # lam*(mu_J² + sig_J²) to the diffusive v_char.
        jvar = float(p.lambda_j) * (float(p.mu_j)**2 + float(p.sigma_j)**2)
        sig0 = float(np.sqrt(v_char + jvar))
        center = 0.5 * (np.log(spot) + np.log(strike))
        half = max(self.x_span * sig0 * np.sqrt(max(T, 0.05)), 0.5)
        n_x, n_t = self._resolution(2.0 * half, T)
        x = np.linspace(center - half, center + half, n_x)
        # v-range: level + 5 stationary sd OR + 4 transient sd, whichever
        # is larger; floor at 2x level.
        sd_stat = float(p.xi) * np.sqrt(
            max(float(p.theta), 1e-6) / (2.0 * max(float(p.kappa), 1e-6)))
        sd_tran = float(p.xi) * np.sqrt(v_char * max(T, 0.05))
        v_max = max(v_char + 5.0 * sd_stat, v_char + 4.0 * sd_tran,
                    2.0 * v_char, 0.05)
        v = np.linspace(0.0, v_max, self.n_v)
        return x.astype(np.float32), v.astype(np.float32), n_x, n_t

    def _solve(self, x, v, n_x, n_t, strike, T, is_call, american,
               **kw):
        p = self.params
        return _adi_heston_solve(
            strike, T, p.r, p.q, p.kappa, p.theta, p.xi, p.rho, x, v,
            n_x=n_x, n_v=self.n_v, n_t=n_t, is_call=is_call,
            american=american, scheme=self.scheme, device=self.device,
            **kw)

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True, american: bool = False
              ) -> Dict[str, float]:
        x, v, n_x, n_t = self._grids(spot, strike, T)
        u, _ = self._solve(x, v, n_x, n_t, strike, T, is_call, american,
                           jump=self._jump_tables(x))
        return self._extract(u, x, v, spot, american, n_t)

    def _extract(self, u, x, v, spot: float,
                 american: bool, n_t: int = None) -> Dict[str, float]:
        """Price + grid Greeks at (ln spot, v0) from a solved (n_v, n_x)
        grid: bilinear price, x-gradient delta/gamma, v-gradient vega
        (conventions match engine/greeks.py: vega_per_vol_point =
        2σ·dP/dv0). Host float64."""
        p = self.params
        u = (u.cpu().numpy() if isinstance(u, torch.Tensor)
             else np.asarray(u)).astype(np.float64)
        xg = np.asarray(x, np.float64)
        vg = np.asarray(v, np.float64)
        x0 = float(np.log(spot))
        v0 = float(np.clip(float(p.v0), vg[0], vg[-1]))
        # Bilinear extraction at (x0, v0): interpolate the two bracketing
        # v rows in x, then linearly in v.
        n_v, n_x = u.shape
        j = int(np.clip(np.searchsorted(vg, v0) - 1, 0, n_v - 2))
        w = (v0 - vg[j]) / (vg[j + 1] - vg[j])
        row = (1.0 - w) * u[j] + w * u[j + 1]
        price = float(np.interp(x0, xg, row))
        dvdx = np.gradient(row, xg)
        d2vdx2 = np.gradient(dvdx, xg)
        delta = float(np.interp(x0, xg, dvdx)) / spot
        gamma = (float(np.interp(x0, xg, d2vdx2))
                 - float(np.interp(x0, xg, dvdx))) / spot**2
        lo, hi = max(j - 1, 0), min(j + 3, n_v)
        col = np.array([np.interp(x0, xg, u[jj]) for jj in range(lo, hi)])
        dv_dv0 = float(np.interp(v0, vg[lo:hi],
                                 np.gradient(col, vg[lo:hi])))
        sigma0 = float(np.sqrt(max(float(p.v0), 1e-12)))
        return {
            "price": price,
            "delta": delta,
            "gamma": gamma,
            "ad_vega_v0": dv_dv0,
            "vega_per_vol_point": dv_dv0 * 2.0 * sigma0,
            "n_x": int(n_x),
            "n_v": int(n_v),
            "n_t": int(n_t if n_t is not None else self.n_t),
            "method": f"adi-{self.scheme}"
                      + ("-pide" if self.jumps else "")
                      + ("-projected" if american else ""),
        }

    def price_barrier(self, spot: float, strike: float, T: float,
                      barrier: float, is_call: bool = True,
                      knock: str = "out", direction: str = "up",
                      barrier_lo: float = None, rebate: float = 0.0,
                      rebate_at_hit: bool = False,
                      american: bool = False) -> Dict[str, float]:
        """Continuously-monitored barrier option under full Heston — the
        absorbing edge sits EXACTLY on the grid boundary, so monitoring is
        continuous by construction (no BGK correction, no bridge
        approximation): the deterministic cross-check for the bridge-MC
        barrier engine under stochastic vol.

        `direction="up"`/"down" single barriers; `barrier_lo` makes it a
        double (corridor) KO with `barrier` as the upper level. Knock-in
        via in-out parity (rebates on KO only). `rebate_at_hit` pays R at
        the hit time (else at expiry).
        """
        p = self.params
        if knock == "in":
            if rebate != 0.0:
                raise ValueError("rebate is supported on knock-out only")
            if american:
                raise ValueError("American knock-in has no in-out parity; "
                                 "price the KO directly")
            vanilla = self.price(spot, strike, T, is_call)
            ko = self.price_barrier(spot, strike, T, barrier, is_call,
                                    "out", direction, barrier_lo)
            return {
                "price": vanilla["price"] - ko["price"],
                "vanilla": vanilla["price"],
                "knock_out": ko["price"],
                "n_x": self.n_x, "n_v": self.n_v, "n_t": self.n_t,
                "method": f"adi-{self.scheme}-parity",
            }
        if knock != "out":
            raise ValueError("knock must be 'out' or 'in'")

        v_char = max(float(p.v0), float(p.theta))
        jvar = float(p.lambda_j) * (float(p.mu_j)**2 + float(p.sigma_j)**2)
        sig0 = float(np.sqrt(v_char + jvar))
        half = max(self.x_span * sig0 * np.sqrt(max(T, 0.05)), 0.5)
        if barrier_lo is not None:
            if not barrier_lo < spot < barrier:
                raise ValueError("spot must sit inside (barrier_lo, "
                                 "barrier)")
            x_min, x_max = np.log(barrier_lo), np.log(barrier)
            lo_bc = hi_bc = "barrier"
        elif direction == "up":
            if not spot < barrier:
                raise ValueError("up-and-out needs spot < barrier")
            x_max = np.log(barrier)
            x_min = min(np.log(spot), np.log(strike)) - half
            lo_bc, hi_bc = "asym", "barrier"
        elif direction == "down":
            if not spot > barrier:
                raise ValueError("down-and-out needs spot > barrier")
            x_min = np.log(barrier)
            x_max = max(np.log(spot), np.log(strike)) + half
            lo_bc, hi_bc = "barrier", "asym"
        else:
            raise ValueError("direction must be 'up' or 'down'")
        n_x, n_t = self._resolution(float(x_max - x_min), T)
        x = np.linspace(x_min, x_max, n_x).astype(np.float32)
        _, v, _, _ = self._grids(spot, strike, T)
        u, _ = self._solve(x, v, n_x, n_t, strike, T, is_call, american,
                           rebate=rebate, jump=self._jump_tables(x),
                           x_lo_bc=lo_bc, x_hi_bc=hi_bc,
                           rebate_at_hit=rebate_at_hit)
        out = self._extract(u, x, v, spot, american, n_t)
        out["method"] += "-barrier"
        return out

    def exercise_boundary(self, spot: float, strike: float, T: float,
                          is_call: bool = False) -> Dict:
        """Early-exercise boundary SURFACE S*(t, v) of the American
        contract under full Heston, read off the ADI projection's binding
        edge per (backward step, variance row): no extra solve. Returned in
        ascending calendar time with the variance grid, plus the v0-row
        slice (the curve a desk plots). NaN where exercise is never optimal
        at that (t, v) — e.g. everywhere on a q=0 call, or at high variance
        where continuation always wins.
        """
        p = self.params
        x, v, n_x, n_t = self._grids(spot, strike, T)
        _, s_stars = self._solve(x, v, n_x, n_t, strike, T, is_call, True,
                                 jump=self._jump_tables(x))
        s_stars = s_stars.cpu().numpy().astype(np.float64)  # (n_t, n_v)
        s_stars[~np.isfinite(s_stars)] = np.nan
        dt = T / n_t
        t_cal = T - (np.arange(n_t) + 1.0) * dt          # backward order
        order = np.argsort(t_cal)
        surf = s_stars[order]
        vg = np.asarray(v, np.float64)
        v0 = float(np.clip(float(p.v0), vg[0], vg[-1]))
        j = int(np.clip(np.searchsorted(vg, v0) - 1, 0, self.n_v - 2))
        w = (v0 - vg[j]) / (vg[j + 1] - vg[j])
        slice_v0 = (1.0 - w) * surf[:, j] + w * surf[:, j + 1]
        return {
            "t": t_cal[order].tolist(),
            "v": vg.tolist(),
            "s_star": surf.tolist(),
            "s_star_at_v0": slice_v0.tolist(),
            "strike": float(strike),
            "is_call": bool(is_call),
        }
