"""SSVI (surface SVI) volatility surface of the port (counterpart of
`mcos_tpu/engine/ssvi.py`): fit, evaluation, no-arbitrage report.

The Gatheral-Jacquier (2014) surface parameterization. Total implied
variance at log-moneyness k:

    w(k, theta_t) = theta_t/2 * [ 1 + rho*phi(theta_t)*k
                                  + sqrt((phi(theta_t)*k + rho)^2
                                         + 1 - rho^2) ],
    phi(theta) = eta * theta^(-gamma)          (power-law),

with one ATM total-variance node theta_t per maturity and three global
shape parameters (rho, eta, gamma).

The fit runs the port's differential evolution and Adam polish
(`utils/optim.py`) on `device`: the objective takes a (P, 3) population
and evaluates the whole (P, maturities, strikes) residual grid in one
broadcast expression. The no-arbitrage report takes Gatheral's butterfly
factor

    g(k) = (1 - k*w'/(2w))^2 - (w'^2/4)*(1/w + 1/4) + w''/2

with w' and w'' from `torch.func.vmap(torch.func.grad(...))` of the SSVI
formula itself, no finite differences; the calendar check verifies
dw/dt >= 0 on the grid. Surface evaluation is float32 on the host CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.utils.optim import adam_polish, differential_evolution

SSVI_BOUNDS = {
    "rho": (-0.999, 0.999),
    "eta": (0.01, 5.0),
    "gamma": (0.01, 0.99),
}


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def ssvi_total_variance(k, theta, rho, eta, gamma):
    """w(k, theta) in float32 — broadcasts over any k/theta shapes."""
    theta = torch.clamp(_f32(theta), min=1e-10)
    k = _f32(k, theta.device)
    phi = eta * theta ** (-gamma)
    pk = phi * k
    return 0.5 * theta * (1.0 + rho * pk
                          + torch.sqrt((pk + rho) ** 2 + 1.0 - rho ** 2))


def _ssvi_objective(x: torch.Tensor, data) -> torch.Tensor:
    """(P, 3) [ρ, η, γ] → (P,) weighted SSE in total variance over the
    (T, K) grid; rows are maturities with their own theta node."""
    rho, eta, gamma = (x[:, i, None, None] for i in range(3))
    w_model = ssvi_total_variance(data["k"], data["theta"][:, None],
                                  rho, eta, gamma)
    return torch.sum(data["weights"] * (w_model - data["w_mkt"]) ** 2,
                     dim=(-2, -1))


def butterfly_g(k, theta, rho, eta, gamma):
    """Gatheral's g(k) over a 1-D k grid: the smile is butterfly-
    arbitrage-free iff g(k) >= 0. w' and w'' by autograd of the SSVI
    formula, vectorized over the grid."""
    from torch.func import grad, vmap

    k = _f32(k)

    def w_of(kk):
        return ssvi_total_variance(kk, theta, rho, eta, gamma)

    w = w_of(k)
    wp = vmap(grad(w_of))(k)
    wpp = vmap(grad(grad(w_of)))(k)
    return ((1.0 - k * wp / (2.0 * w)) ** 2
            - 0.25 * wp ** 2 * (1.0 / w + 0.25) + 0.5 * wpp)


class SSVISurface:
    """Fitted SSVI surface: evaluate, interrogate, and export.

    `maturities` (m,) ascending; `theta` (m,) ATM total-variance nodes;
    global (rho, eta, gamma). Between maturities, theta interpolates
    linearly in t (total-variance interpolation; flat extrapolation of
    the ATM *variance rate* theta/t beyond the ends).
    """

    def __init__(self, maturities, theta, rho: float, eta: float,
                 gamma: float):
        self.maturities = np.asarray(maturities, np.float64)
        self.theta = np.asarray(theta, np.float64)
        self.rho = float(rho)
        self.eta = float(eta)
        self.gamma = float(gamma)

    # ── evaluation ───────────────────────────────────────────────────────
    def theta_at(self, T):
        T = np.asarray(T, np.float64)
        t, th = self.maturities, self.theta
        rate_lo = th[0] / t[0]
        rate_hi = th[-1] / t[-1]
        inner = np.interp(T, t, th)
        return np.where(T <= t[0], rate_lo * T,
                        np.where(T >= t[-1], rate_hi * T, inner))

    def total_variance(self, k, T):
        return ssvi_total_variance(
            _f32(np.asarray(k, np.float32)),
            _f32(np.asarray(self.theta_at(T), np.float32)),
            self.rho, self.eta, self.gamma).numpy().astype(np.float64)

    def vol(self, k, T):
        """Black-Scholes implied vol at log-moneyness k = ln(K/F)."""
        T = np.asarray(T, np.float64)
        return np.sqrt(self.total_variance(k, T) / np.maximum(T, 1e-12))

    def atm_skew(self, T) -> float:
        """d(sigma_imp)/dk at ATM, from the closed form
        d_k w(0) = rho*theta*phi (chain rule through sigma = sqrt(w/T))."""
        th = float(self.theta_at(T))
        phi = self.eta * th ** (-self.gamma)
        dw = self.rho * th * phi
        return dw / (2.0 * np.sqrt(th * float(T)))

    # ── no-arbitrage report ──────────────────────────────────────────────
    def arbitrage_report(self, k_grid: Optional[Sequence[float]] = None
                         ) -> Dict[str, object]:
        if k_grid is None:
            k_grid = np.linspace(-1.0, 1.0, 101)
        k = _f32(np.asarray(k_grid, np.float32))
        butterfly = []
        for th in self.theta:
            g = butterfly_g(k, float(th), self.rho, self.eta,
                            self.gamma)
            butterfly.append(float(g.min()))
        # Gatheral-Jacquier Thm 4.2 sufficient conditions per slice.
        phi = self.eta * self.theta ** (-self.gamma)
        cond1 = self.theta * phi * (1.0 + abs(self.rho))
        cond2 = self.theta * phi ** 2 * (1.0 + abs(self.rho))
        # Calendar: w(k, t) non-decreasing in t on the grid.
        w = np.stack([self.total_variance(np.asarray(k_grid), t)
                      for t in self.maturities])
        cal_min = float(np.diff(w, axis=0).min()) if len(
            self.maturities) > 1 else 0.0
        return {
            "butterfly_g_min": butterfly,
            "butterfly_free": bool(min(butterfly) >= -1e-10),
            "thm42_cond1_max": float(cond1.max()),   # sufficient if <= 4
            "thm42_cond2_max": float(cond2.max()),   # sufficient if <= 4
            "calendar_min_dw": cal_min,
            "calendar_free": bool(cal_min >= -1e-10),
        }

    # ── export ───────────────────────────────────────────────────────────
    def iv_grid(self, spot: float, strikes, maturities, r: float,
                q: float) -> np.ndarray:
        """(len(maturities), len(strikes)) IV grid, e.g. for the Dupire
        local-vol builder (engine/localvol.py)."""
        strikes = np.asarray(strikes, np.float64)
        out = np.empty((len(maturities), len(strikes)))
        for i, t in enumerate(maturities):
            f = spot * np.exp((r - q) * t)
            out[i] = self.vol(np.log(strikes / f), t)
        return out


def calibrate_ssvi(maturities, forwards, strikes, market_ivs,
                   weights=None, seed: int = 0, pop_size: int = 48,
                   iters: int = 150, polish_steps: int = 200,
                   device="cuda") -> Dict[str, object]:
    """Fit SSVI to an IV grid on `device`.

    Args:
        maturities: (m,) ascending year fractions.
        forwards: (m,) forward prices per maturity.
        strikes: (m, n) strike grid (row per maturity).
        market_ivs: (m, n) Black implied vols; NaN entries are skipped.
        weights: optional (m, n) quote weights (vega/spread weights).

    theta nodes are pinned to the market ATM total variance per maturity
    (interpolated in k from each row); DE (generator
    `seeded_generator(seed, device)`) + Adam fit the three globals.
    """
    device = torch.device(device)
    mats = np.asarray(maturities, np.float64)
    fwds = np.asarray(forwards, np.float64)
    strikes = np.asarray(strikes, np.float64)
    ivs = np.asarray(market_ivs, np.float64)
    k = np.log(strikes / fwds[:, None])
    w_mkt = ivs ** 2 * mats[:, None]
    mask = np.isfinite(w_mkt)
    if weights is None:
        weights = mask.astype(np.float64)
    else:
        weights = np.asarray(weights, np.float64) * mask
    weights = weights / weights.sum()

    # ATM theta per row: interpolate market total variance to k = 0.
    theta = np.empty(len(mats))
    for i in range(len(mats)):
        ki, wi = k[i][mask[i]], w_mkt[i][mask[i]]
        order = np.argsort(ki)
        theta[i] = np.interp(0.0, ki[order], wi[order])

    data = {"k": _f32(k.astype(np.float32), device),
            "w_mkt": _f32(np.nan_to_num(w_mkt).astype(np.float32), device),
            "weights": _f32(weights.astype(np.float32), device),
            "theta": _f32(theta.astype(np.float32), device)}
    bounds = np.array([SSVI_BOUNDS["rho"], SSVI_BOUNDS["eta"],
                       SSVI_BOUNDS["gamma"]], np.float32)

    def objective(x):
        return _ssvi_objective(x, data)

    with torch.no_grad():
        res = differential_evolution(objective, bounds,
                                     seeded_generator(seed, device),
                                     pop_size=pop_size, iters=iters)
    x, fun = adam_polish(objective, res.x, bounds, steps=polish_steps,
                         lr=0.02)
    x = x.detach().cpu().numpy()
    fun = float(fun)
    surf = SSVISurface(mats, theta, float(x[0]), float(x[1]), float(x[2]))
    return {
        "surface": surf,
        "rho": surf.rho, "eta": surf.eta, "gamma": surf.gamma,
        "theta": theta.tolist(),
        "objective": fun,
        # weights are normalized to sum 1, so the objective IS the
        # weighted mean-square total-variance error.
        "rmse_total_variance": float(np.sqrt(max(fun, 0.0))),
        "n_quotes": int(mask.sum()),
        "arbitrage": surf.arbitrage_report(),
    }
