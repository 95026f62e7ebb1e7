"""Dupire local volatility of the port (counterpart of
`mcos_tpu/engine/localvol.py`): surface construction and Monte Carlo.

The unique diffusion σ_loc(t, S) that reprices an arbitrage-free European
surface (Dupire 1994), from any implied-vol grid (market, SABR, SSVI).

- **Surface construction is host float64**, carried over from the JAX
  package (tests/test_torch_localvol.py holds it equal at rtol 1e-9): per
  maturity a natural cubic spline of w = σ²T in y = log(K/F_T), total
  variance linear in T, central differences, Dupire's formula in
  total-variance form

                             ∂_T w
      σ_loc²(y, T) = ─────────────────────────────────────────────────────
                     1 − (y/w)·∂_y w + ¼(−¼ − 1/w + y²/w²)(∂_y w)² + ½∂²_y w

- **Simulation is a torch step loop on the device** with a uniform-grid
  lookup: the (t, y) table is resampled at the step midpoints on the host
  (`step_tables`), so each step does one uniform 1-D interpolation in y
  (index arithmetic, an integer clamp, two gathers). The carry is
  log(S/S0).

`mesh=` shards antithetic `price_batch` calls through
`parallel/families.py:sharded_localvol_price`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mcos_tpu_torch.engine.pricer import (resolve_mesh, seeded_generator,
                                          to_host)
from mcos_tpu_torch.engine.surface import NaturalCubicSpline
from mcos_tpu_torch.ops.simulate import _pair_payoffs, mc_mean_stderr

# Local-variance clamps: keep the diffusion well-posed where the input
# surface is noisy / extrapolated (vols between ~3% and ~300%).
_VAR_FLOOR = 1e-3**2
_VAR_CAP = 3.0**2


def dupire_local_variance(
    y: np.ndarray, w: np.ndarray, wy: np.ndarray, wyy: np.ndarray,
    wt: np.ndarray,
) -> np.ndarray:
    """Dupire's formula in total-variance form (all inputs on one grid).

    Args:
        y: log-moneyness grid values (broadcastable to w's shape).
        w: total implied variance σ²T (must be > 0).
        wy, wyy: first/second y-derivatives of w.
        wt: T-derivative of w (calendar slope; ≥ 0 iff no calendar arbitrage).

    Returns local variance, clamped to a sane positive window wherever the
    denominator goes non-positive (butterfly-arbitrage pockets of a noisy
    input surface).
    """
    w_safe = np.maximum(w, 1e-12)
    denom = (1.0 - (y / w_safe) * wy
             + 0.25 * (-0.25 - 1.0 / w_safe + (y / w_safe) ** 2) * wy**2
             + 0.5 * wyy)
    local_var = np.where(denom > 1e-8, wt / np.maximum(denom, 1e-8),
                         np.maximum(wt, _VAR_FLOOR))
    return np.clip(local_var, _VAR_FLOOR, _VAR_CAP)


@dataclass
class LocalVolSurface:
    """Local-variance table σ_loc²(t, y) on a regular (t, y) grid.

    Attributes:
        t_grid: (n_t,) increasing times > 0.
        y_grid: (n_y,) uniform log-moneyness grid (y = log(S/F_t)).
        local_var: (n_t, n_y) local variance.
        r, q: carry rates the y-coordinate (forward) uses.
    """

    t_grid: np.ndarray
    y_grid: np.ndarray
    local_var: np.ndarray
    r: float
    q: float

    @classmethod
    def flat(cls, sigma: float, r: float = 0.065, q: float = 0.012,
             t_max: float = 2.0) -> "LocalVolSurface":
        """Constant-vol surface (the BS-oracle degenerate case)."""
        t = np.linspace(0.01, t_max, 16)
        y = np.linspace(-1.0, 1.0, 9)
        lv = np.full((t.size, y.size), float(sigma) ** 2)
        return cls(t, y, lv, float(r), float(q))

    @classmethod
    def from_ssvi(cls, ssvi, spot: float, r: float = 0.065,
                  q: float = 0.012, n_strikes: int = 21,
                  n_mats: int = 8, **kw) -> "LocalVolSurface":
        """Dupire table from a fitted SSVI surface (engine/ssvi.py).

        SSVI gives an arbitrage-aware parametric IV everywhere, which is
        exactly what the Dupire derivatives want — the smooth w(k, t)
        avoids the quote-noise amplification of raw-grid differentiation.
        Samples the SSVI surface on a (maturity, strike) grid spanning its
        fitted maturities and feeds `from_iv_points`.
        """
        t_lo = float(ssvi.maturities[0])
        t_hi = float(ssvi.maturities[-1])
        mats = np.linspace(t_lo, t_hi, n_mats)
        # Strike span: ±3 ATM sigmas at the longest maturity.
        sig = float(np.sqrt(ssvi.theta_at(t_hi) / t_hi))
        strikes = spot * np.exp(np.linspace(-3.0, 3.0, n_strikes)
                                * sig * np.sqrt(t_hi))
        iv = ssvi.iv_grid(spot, strikes, mats, r, q)
        return cls.from_iv_points(spot, strikes, mats, iv, r=r, q=q, **kw)

    @classmethod
    def from_iv_points(
        cls,
        spot: float,
        strikes: Sequence[float],
        maturities: Sequence[float],
        iv: np.ndarray,
        r: float = 0.065,
        q: float = 0.012,
        n_y: int = 101,
        n_t: int = 64,
        y_span: Optional[float] = None,
    ) -> "LocalVolSurface":
        """Build the Dupire table from an implied-vol grid.

        Args:
            iv: (n_maturities, n_strikes) implied vols (NaN = missing quote;
                slices need ≥ 4 live quotes).
            n_y, n_t: output grid resolution.
            y_span: half-width of the y grid; default = data span + margin.

        Pipeline (host f64): per-maturity natural cubic spline of w = σ²T in
        y → total-variance linear interpolation in T at fixed y (calendar-
        consistent, engine/surface.py:329-356 semantics; w ∝ t below the
        first maturity) → central finite differences → Dupire formula.
        """
        strikes = np.asarray(strikes, np.float64)
        maturities = np.asarray(maturities, np.float64)
        iv = np.asarray(iv, np.float64)
        if iv.shape != (maturities.size, strikes.size):
            raise ValueError("iv must be (n_maturities, n_strikes)")

        # Per-slice w(y) splines in forward log-moneyness.
        slices = []
        y_min, y_max = np.inf, -np.inf
        for i, T in enumerate(maturities):
            f_t = spot * np.exp((r - q) * T)
            y_pts = np.log(strikes / f_t)
            live = np.isfinite(iv[i]) & (iv[i] > 0)
            if live.sum() < 4:
                continue
            w_pts = iv[i, live] ** 2 * T
            order = np.argsort(y_pts[live])
            ys, ws = y_pts[live][order], w_pts[order]
            slices.append((float(T), NaturalCubicSpline(ys, ws),
                           ys[0], ys[-1]))
            y_min, y_max = min(y_min, ys[0]), max(y_max, ys[-1])
        if len(slices) < 2:
            raise ValueError("need ≥ 2 maturities with ≥ 4 live quotes each")

        if y_span is None:
            y_span = max(abs(y_min), abs(y_max))
        y_grid = np.linspace(-y_span, y_span, n_y)
        t_lo, t_hi = slices[0][0], slices[-1][0]
        t_grid = np.linspace(max(t_lo * 0.25, 1e-3), t_hi, n_t)

        # w(T_i, y) rows, flat-extrapolated in y beyond each slice's quotes
        # (constant-vol wings keep the Dupire denominator positive there).
        slice_t = np.array([s[0] for s in slices])
        slice_w = np.empty((len(slices), n_y))
        for i, (T, spl, lo, hi) in enumerate(slices):
            yq = np.clip(y_grid, lo, hi)
            slice_w[i] = np.maximum(spl(yq), 1e-10)

        def w_at(t: np.ndarray) -> np.ndarray:
            """(len(t), n_y) total variance, linear in T at fixed y."""
            out = np.empty((t.size, n_y))
            for j, tj in enumerate(t):
                if tj <= slice_t[0]:
                    out[j] = slice_w[0] * (tj / slice_t[0])  # w(0,·) = 0
                elif tj >= slice_t[-1]:
                    # Linear continuation of the last calendar segment.
                    w0, w1 = slice_w[-2], slice_w[-1]
                    t0, t1 = slice_t[-2], slice_t[-1]
                    out[j] = np.maximum(
                        w1 + (w1 - w0) * (tj - t1) / (t1 - t0), 1e-10)
                else:
                    k = np.searchsorted(slice_t, tj) - 1
                    lam = (tj - slice_t[k]) / (slice_t[k + 1] - slice_t[k])
                    out[j] = (1 - lam) * slice_w[k] + lam * slice_w[k + 1]
            return out

        dt_fd = 1e-4
        w_mid = w_at(t_grid)
        wt = (w_at(t_grid + dt_fd) - w_at(np.maximum(t_grid - dt_fd, 1e-5))) \
            / (dt_fd + np.minimum(t_grid - 1e-5, dt_fd))[:, None]
        wt = np.maximum(wt, 1e-8)  # calendar-arbitrage floor

        dy = y_grid[1] - y_grid[0]
        wy = np.gradient(w_mid, dy, axis=1)
        wyy = np.gradient(wy, dy, axis=1)

        local_var = dupire_local_variance(y_grid[None, :], w_mid, wy, wyy, wt)
        return cls(t_grid, y_grid, local_var, float(r), float(q))

    def local_vol(self, t: float, y: float) -> float:
        """Point lookup (bilinear), mostly for inspection/tests."""
        ti = np.clip(np.searchsorted(self.t_grid, t) - 1, 0,
                     self.t_grid.size - 2)
        lam = np.clip((t - self.t_grid[ti])
                      / (self.t_grid[ti + 1] - self.t_grid[ti]), 0.0, 1.0)
        row = (1 - lam) * self.local_var[ti] + lam * self.local_var[ti + 1]
        return float(np.sqrt(np.interp(y, self.y_grid, row)))

    def step_tables(self, T: float, num_steps: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Resample the table at step midpoints → ((steps, n_y) var, (steps,) t).

        Host-side prep for the step loop: the device then only does uniform
        1-D interpolation in y.
        """
        t_mid = (np.arange(num_steps) + 0.5) * (T / num_steps)
        rows = np.empty((num_steps, self.y_grid.size), np.float32)
        for k, t in enumerate(t_mid):
            ti = int(np.clip(np.searchsorted(self.t_grid, t) - 1, 0,
                             self.t_grid.size - 2))
            lam = float(np.clip(
                (t - self.t_grid[ti])
                / (self.t_grid[ti + 1] - self.t_grid[ti]), 0.0, 1.0))
            rows[k] = ((1 - lam) * self.local_var[ti]
                       + lam * self.local_var[ti + 1])
        return rows, t_mid.astype(np.float32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _local_var_lookup(row: torch.Tensor, y: torch.Tensor, y0: torch.Tensor,
                     dy: torch.Tensor) -> torch.Tensor:
    """Uniform-grid linear interpolation of one variance row at y.

    The index is clamped as an integer: a float clip to n_y − 1 − ε rounds
    back up to n_y − 1 in float32 once n_y ≳ 100, and i + 1 would then
    gather out of bounds."""
    n_y = row.shape[0]
    pos = torch.clamp((y - y0) / dy, 0.0, float(n_y - 1))
    i = torch.clamp(pos.to(torch.int64), max=n_y - 2)
    frac = pos - i.to(torch.float32)
    return row[i] * (1.0 - frac) + row[i + 1] * frac


def simulate_terminal_localvol(
    var_rows,             # (num_steps, n_y) local variance at step midpoints
    t_mid,                # (num_steps,) midpoint times
    y0: float,            # y_grid[0]
    dy: float,            # uniform y spacing
    spot,
    r,
    q,
    T,
    generator: Optional[torch.Generator] = None,
    num_paths: Optional[int] = None,
    num_steps: Optional[int] = None,
    antithetic: bool = True,
    *,
    normals: Optional[torch.Tensor] = None,
    device="cuda",
) -> torch.Tensor:
    """Terminal spots under d log S = (r − q − σ²/2)dt + σ(t, y) dW, float32
    on `device` (the device of `normals` when given).

    y = log(S_t / F_t) with F_t = S₀e^{(r−q)t}; σ² is a uniform-grid linear
    interpolation of the step's variance row. `normals`: an explicit
    (num_steps, num_paths) sheet, one row a step; else drawn from
    `generator` up front. Returns (n_branch, num_paths)."""
    if normals is None:
        device = torch.device(device)
        normals = torch.randn((num_steps, num_paths), generator=generator,
                              device=device, dtype=torch.float32)
    device = normals.device
    num_steps, num_paths = normals.shape
    n_branch = 2 if antithetic else 1
    rows = _f32(var_rows, device)
    t_mid = _f32(t_mid, device)
    spot, r, q, T, y0, dy = (_f32(x, device) for x in (spot, r, q, T, y0, dy))
    dt = T / num_steps
    sqrt_dt = torch.sqrt(dt)
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]
    log_s = torch.zeros((n_branch, num_paths), dtype=torch.float32,
                        device=device)       # log(S/S0) carry
    for k in range(num_steps):
        z = normals[k] * sign
        y = log_s - (r - q) * t_mid[k]
        v = _local_var_lookup(rows[k], y, y0, dy)
        sig = torch.sqrt(torch.clamp(v, _VAR_FLOOR, _VAR_CAP))
        log_s = log_s + (r - q - 0.5 * sig * sig) * dt + sig * sqrt_dt * z
    return spot * torch.exp(log_s)


class LocalVolEngine:
    """Monte Carlo pricer under Dupire local-vol dynamics on `device`.

    API mirrors `MonteCarloEngine.price/price_batch`. Each pricing call
    draws from `seeded_generator(seed, device)`: the same paths a call.
    mesh: None | "auto" | a `parallel.mesh.Mesh` (`resolve_mesh`); a
    resolved mesh shards antithetic `price_batch` calls
    (`parallel/families.py:sharded_localvol_price`).
    """

    def __init__(self, surface: LocalVolSurface, num_paths: int = 200_000,
                 num_steps: int = 100, seed: int = 42,
                 use_antithetic: bool = True, mesh=None, device="cuda"):
        self.mesh = mesh
        self.surface = surface
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_antithetic = bool(use_antithetic)
        self.device = torch.device(device)

    def _terminal(self, spot: float, T: float) -> torch.Tensor:
        steps = max(int(self.num_steps * T), 16)
        rows, t_mid = self.surface.step_tables(T, steps)
        return simulate_terminal_localvol(
            rows, t_mid, float(self.surface.y_grid[0]),
            float(self.surface.y_grid[1] - self.surface.y_grid[0]),
            spot, self.surface.r, self.surface.q, T,
            seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, num_steps=steps,
            antithetic=self.use_antithetic, device=self.device)

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True) -> Dict[str, float]:
        rows = self.price_batch(spot, [strike], T, is_call)
        return rows[0]

    def price_batch(self, spot: float, strikes: Sequence[float], T: float,
                    is_call: bool = True) -> list:
        """Price a strike chain off one shared local-vol path set."""
        mesh = resolve_mesh(self.mesh)
        if mesh is not None and self.use_antithetic:
            from mcos_tpu_torch.parallel.families import (
                sharded_localvol_price,
            )

            res = to_host(sharded_localvol_price(
                self.surface, spot, np.asarray(strikes, np.float32), T,
                self.seed, mesh=mesh, num_paths=self.num_paths,
                num_steps=max(int(self.num_steps * T), 16),
                is_call=is_call))
            return [
                {"strike": float(k), "price": float(p),
                 "std_error": float(s)}
                for k, p, s in zip(np.asarray(strikes, np.float64),
                                   np.atleast_1d(res["price"]),
                                   np.atleast_1d(res["std_error"]))]
        s_final = self._terminal(spot, T)
        strikes_arr = _f32(np.asarray(strikes, np.float32), self.device)
        mean, se = mc_mean_stderr(
            _pair_payoffs(s_final, strikes_arr, is_call).T)
        disc = float(np.exp(-self.surface.r * T))
        host = torch.stack([mean, se]).cpu().numpy().astype(np.float64)
        return [
            {"strike": float(k), "price": disc * float(m),
             "std_error": disc * float(s)}
            for k, m, s in zip(np.asarray(strikes, np.float64), host[0],
                               host[1])
        ]

    def implied_surface_error(self, spot: float, strikes: Sequence[float],
                              T: float, target_iv: Sequence[float]) -> float:
        """Max |model IV − target IV| over the chain — the round-trip metric
        (a perfect Dupire build reprices its input surface exactly)."""
        from mcos_tpu_torch.engine.surface import implied_vol

        rows = self.price_batch(spot, strikes, T, is_call=True)
        errs = []
        for row, iv_t in zip(rows, np.asarray(target_iv, np.float64)):
            iv_m = implied_vol(row["price"], spot, row["strike"], T,
                               self.surface.r, self.surface.q, is_call=True)
            if iv_m is not None and np.isfinite(iv_t):
                errs.append(abs(iv_m - iv_t))
        return float(max(errs)) if errs else float("nan")
