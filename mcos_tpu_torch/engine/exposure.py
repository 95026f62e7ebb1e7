"""Counterparty exposure profiles and CVA/DVA — XVA layer
(counterpart of `mcos_tpu/engine/exposure.py`).

Simulate the market to a grid of future exposure dates, revalue the
netting set at each date, and reduce to the XVA quantities a desk carries:

    EE(t)  = E[V_t^+]           expected exposure
    ENE(t) = E[(-V_t)^+]        expected negative exposure (DVA side)
    EPE    = avg_t e^{-rt} EE(t)   (discounted running average)
    PFE_q(t) = quantile_q(V_t^+)   potential future exposure
    CVA = LGD * sum_i  e^{-r t_i} EE(t_i) * [PD(t_{i-1}, t_i)]

Where it runs: a torch loop over dates on `device`. Market states at the
exposure dates are sampled *exactly* — correlated lognormal increments
date to date (no Euler error, the dates are the only grid): the carry is
the (paths, assets) log-spot sheet, each date one `z @ chol.T`.
Revaluation at each date is the closed-form Black-Scholes of `ops/bs.py`
on the whole (paths, positions) sheet; each date keeps only its netted
and gross book values, (paths,) rows. No kernel: `cva_delta` is one
`torch.autograd.grad` through the whole loop.

Randoms: date i's (paths, assets) normals come from a generator seeded
with the engine's seed, one date at a time (`_date_normals`), so every
profile of one engine sees the same paths.

Exact oracles used by the tests:
  * a single long call position has V_t >= 0 and discounted-martingale
    value, so e^{-rt} EE(t) = C_0 for every t, and CVA = LGD * C_0 * PD(T);
  * a forward contract's EE(t) is the Black formula on its t-forward value;
  * netted exposure <= gross exposure pathwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu_torch.engine.pricer import seeded_generator, to_host
from mcos_tpu_torch.ops.bs import bs_price


def _positions_arrays(positions: Sequence[dict], n_assets: int):
    """Columnize a position list into f32 arrays (host, once per book).

    Each position: {"kind": "call"|"put"|"forward", "strike": K,
    "T": maturity_years, "qty": signed_quantity, "asset": index}.
    """
    kinds = {"call": 0, "put": 1, "forward": 2}
    kind = np.array([kinds[p.get("kind", "call")] for p in positions],
                    np.int32)
    strike = np.array([p["strike"] for p in positions], np.float32)
    mat = np.array([p["T"] for p in positions], np.float32)
    qty = np.array([p.get("qty", 1.0) for p in positions], np.float32)
    asset = np.array([int(p.get("asset", 0)) for p in positions], np.int32)
    if (asset < 0).any() or (asset >= n_assets).any():
        raise ValueError("position asset index out of range")
    return kind, strike, mat, qty, asset


def _book_value(s_row, t, kind, strike, mat, qty, asset, r, q_by_asset,
                sigma_by_asset):
    """(paths,) netted and gross book values at date t from (paths, assets)
    spots.

    Positions past maturity contribute zero (settled). Forwards value
    linearly; calls/puts by closed-form BS with the remaining life.
    """
    tau = torch.clamp(mat - t, min=1e-8)[None, :]          # (1, P)
    s = s_row[:, asset]                                    # (paths, P)
    sig = sigma_by_asset[asset][None, :]
    qq = q_by_asset[asset][None, :]
    k = strike[None, :]
    call = bs_price(s, k, tau, r, qq, sig, True)
    put = bs_price(s, k, tau, r, qq, sig, False)
    fwd = s * torch.exp(-qq * tau) - k * torch.exp(-r * tau)
    v = torch.where(kind[None, :] == 0, call,
                    torch.where(kind[None, :] == 1, put, fwd))
    # Alive through expiry itself: at t = T the floored tau collapses the
    # BS value to intrinsic — the unsettled payoff is still exposure, so a
    # date grid ending exactly at the book horizon keeps its last bucket.
    alive = (mat[None, :] - t >= -1e-7).to(s.dtype)
    per_pos = qty[None, :] * v * alive
    return (torch.sum(per_pos, dim=1),
            torch.sum(torch.clamp(per_pos, min=0.0), dim=1))


def _exposure_values(spots, sigmas, chol, r, q_by_asset, dates, normals,
                     kind, strike, mat, qty, asset, *, num_paths: int):
    """(dates, paths) netted and gross book values and asset 0's level
    ratio S_t/S_0 (what the wrong-way-risk intensity reads).

    Exact date-to-date lognormal stepping: the carry is the (paths, assets)
    log-spot sheet; `normals(i)` gives date i's (paths, assets) standard
    normals. Differentiable in `spots`."""
    log_s = torch.log(spots)[None, :].expand(num_paths, -1)
    dates_h = dates.tolist()
    prev = 0.0
    net, gross, s_ratio = [], [], []
    drift = r - q_by_asset - 0.5 * sigmas**2
    for i, t in enumerate(dates_h):
        d = float(np.float32(np.float32(t) - np.float32(prev)))
        prev = t
        z = normals(i) @ chol.T
        log_s = log_s + (drift * d + sigmas * float(np.sqrt(np.float32(d)))
                         * z)
        n_i, g_i = _book_value(torch.exp(log_s), dates[i], kind, strike,
                               mat, qty, asset, r, q_by_asset, sigmas)
        net.append(n_i)
        gross.append(g_i)
        s_ratio.append(torch.exp(log_s[:, 0]) / spots[0])
    return torch.stack(net), torch.stack(gross), torch.stack(s_ratio)


def _quantile_rows(x: torch.Tensor, q: float) -> torch.Tensor:
    """Row quantiles of (rows, n), numpy's default linear interpolation
    (`torch.quantile` refuses inputs above 2^24 elements)."""
    n = x.shape[1]
    pos = q * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    srt = torch.sort(x, dim=1).values
    frac = pos - lo
    return srt[:, lo] + (srt[:, hi] - srt[:, lo]) * frac


class ExposureEngine:
    """EE/ENE/PFE profiles, CVA/DVA, and CVA delta for a vanilla book, on
    `device`.

    Market model: correlated GBM per asset (flat vols — the model under
    which the closed-form revaluation is self-consistent). `positions` is
    a list of dicts (see `_positions_arrays`). A `corr` that is not
    positive definite raises `np.linalg.LinAlgError`, as in the JAX
    package.
    """

    def __init__(self, spots, sigmas, corr, positions: List[dict],
                 r: float = RISK_FREE_RATE,
                 q: Optional[Sequence[float]] = None,
                 num_paths: int = 65_536, seed: int = 42, *, device="cuda"):
        self.spots = np.atleast_1d(np.asarray(spots, np.float32))
        self.sigmas = np.atleast_1d(np.asarray(sigmas, np.float32))
        n = self.spots.shape[0]
        corr = np.atleast_2d(np.asarray(corr, np.float64))
        self.chol = np.linalg.cholesky(corr).astype(np.float32)
        self.q = (np.full(n, DIVIDEND_YIELD, np.float32) if q is None
                  else np.asarray(q, np.float32))
        self.r = float(r)
        self.positions = list(positions)
        self.pos_arrays = _positions_arrays(self.positions, n)
        self.num_paths = int(num_paths)
        self.seed = int(seed)
        self.device = torch.device(device)

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _date_normals(self):
        """date index → (paths, assets) standard normals: a generator seeded
        with the engine's seed, drawn in date order."""
        gen = seeded_generator(self.seed, self.device)
        shape = (self.num_paths, self.spots.shape[0])
        return lambda i: torch.randn(shape, generator=gen,
                                     dtype=torch.float32, device=self.device)

    def _values(self, dates: np.ndarray, spots=None):
        kind, strike, mat, qty, asset = self.pos_arrays
        return _exposure_values(
            self._t(self.spots) if spots is None else spots,
            self._t(self.sigmas), self._t(self.chol),
            float(np.float32(self.r)), self._t(self.q),
            self._t(dates), self._date_normals(),
            self._t(kind, torch.int32), self._t(strike), self._t(mat),
            self._t(qty), self._t(asset, torch.int64),
            num_paths=self.num_paths)

    def _dates(self, num_dates: int, horizon: Optional[float]) -> np.ndarray:
        horizon = float(horizon or self.pos_arrays[2].max())
        return np.linspace(horizon / num_dates, horizon,
                           num_dates).astype(np.float32)

    def profile(self, num_dates: int = 32,
                horizon: Optional[float] = None,
                quantile: float = 0.975,
                collateral_threshold: Optional[float] = None,
                margin_period: float = 10.0 / 252.0) -> Dict[str, object]:
        """Exposure profile on a uniform date grid up to the book horizon.

        `collateral_threshold` models a CSA: the counterparty posts
        variation margin above the threshold, but collateral lags by the
        margin period of risk — the held amount at t is what the call at
        t - MPR produced, C_t = max(V_{t-MPR} - threshold, 0), so the
        residual exposure max(V_t - C_t, 0)⁺ keeps the gap risk a real
        CSA leaves. Lag handling uses the nearest earlier grid date (C=0
        before the first); threshold=0 leaves pure gap risk,
        threshold→∞ recovers the uncollateralized profile.
        """
        dates = self._dates(num_dates, horizon)
        with torch.no_grad():
            net, gross, _ = self._values(dates)
            if collateral_threshold is not None:
                thr = float(np.float32(collateral_threshold))
                # index of the newest grid date <= t - MPR (-1: no call yet)
                lag_idx = np.searchsorted(
                    dates, dates - np.float32(margin_period),
                    side="right") - 1
                lagged = torch.where(
                    self._t(lag_idx >= 0, torch.bool)[:, None],
                    net[self._t(np.maximum(lag_idx, 0), torch.int64)],
                    torch.zeros_like(net))
                net = net - torch.clamp(lagged - thr, min=0.0)
            pos = torch.clamp(net, min=0.0)
            neg = torch.clamp(-net, min=0.0)
            host = to_host({
                "ee": torch.mean(pos, dim=1), "ene": torch.mean(neg, dim=1),
                "pfe": _quantile_rows(pos, quantile),
                "gross_ee": torch.mean(torch.clamp(gross, min=0.0), dim=1)})
        disc = np.exp(-self.r * dates)
        ee, ene, gross_ee = host["ee"], host["ene"], host["gross_ee"]
        return {
            "dates": dates.tolist(),
            "ee": ee.tolist(),
            "ene": ene.tolist(),
            "pfe": host["pfe"].tolist(),
            "pfe_quantile": quantile,
            "gross_ee": gross_ee.tolist(),
            "epe": float(np.mean(disc * ee)),
            "ene_avg": float(np.mean(disc * ene)),
            "netting_benefit": float(np.mean(disc * (gross_ee - ee))),
            "num_paths_used": self.num_paths,
        }

    def cva(self, hazard_rate: float = 0.02, lgd: float = 0.6,
            num_dates: int = 32, own_hazard: float = 0.0,
            horizon: Optional[float] = None) -> Dict[str, float]:
        """Unilateral CVA (and DVA when `own_hazard` > 0) with a flat
        hazard curve: PD(t_{i-1}, t_i) = e^{-h t_{i-1}} - e^{-h t_i}."""
        prof = self.profile(num_dates=num_dates, horizon=horizon)
        t = np.asarray(prof["dates"])
        disc = np.exp(-self.r * t)
        dpd = lambda h: (np.exp(-h * np.concatenate([[0.0], t[:-1]]))  # noqa: E731
                         - np.exp(-h * t))
        cva = lgd * float(np.sum(disc * np.asarray(prof["ee"])
                                 * dpd(hazard_rate)))
        out = {"cva": cva, "hazard_rate": hazard_rate, "lgd": lgd,
               "epe": prof["epe"], "pd_horizon":
               float(1.0 - np.exp(-hazard_rate * t[-1]))}
        if own_hazard > 0.0:
            out["dva"] = lgd * float(np.sum(
                disc * np.asarray(prof["ene"]) * dpd(own_hazard)))
            out["bcva"] = cva - out["dva"]
        return out

    def cva_wwr(self, hazard_rate: float = 0.02, lgd: float = 0.6,
                gamma: float = 1.0, num_dates: int = 32,
                horizon: Optional[float] = None) -> Dict[str, float]:
        """CVA with wrong-way risk: a spot-linked stochastic intensity

            lambda_t = h0 * (S_0 / S_t)^gamma        (asset 0's level),

        so default clusters when the market sells off. Pathwise Cox
        accounting: conditional on the path, the default probability in
        bucket i is exp(-Lambda_{i-1}) - exp(-Lambda_i) with Lambda the
        left-point intensity integral, and

            CVA = LGD * E[ sum_i disc_i * V_i^+ * dPD_i(path) ].

        gamma = 0 reduces EXACTLY to the independent-hazard `cva()`
        formula; gamma > 0 raises the CVA of books whose exposure grows as
        the market falls (short puts — wrong way) and lowers it for books
        long the market (right way).
        """
        dates = self._dates(num_dates, horizon)
        with torch.no_grad():
            net, _, s_ratio = self._values(dates)
            pos = torch.clamp(net, min=0.0)              # (dates, paths)
            lam = hazard_rate * s_ratio ** (-gamma)      # intensity per date
            deltas = self._t(np.diff(np.concatenate([[0.0], dates])))
            # Left-point integral: the first bucket's intensity from t = 0
            # is h0 (the S ratio is 1 there).
            lam_left = torch.cat(
                [torch.full((1, lam.shape[1]), float(np.float32(hazard_rate)),
                            dtype=torch.float32, device=self.device),
                 lam[:-1]], dim=0)
            big_lambda = torch.cumsum(lam_left * deltas[:, None], dim=0)
            surv = torch.exp(-big_lambda)                # S(t_i) per path
            surv_prev = torch.cat([torch.ones_like(surv[:1]), surv[:-1]],
                                  dim=0)
            dpd = surv_prev - surv
            disc = self._t(np.exp(-self.r * dates))[:, None]
            host = to_host({
                "cva": torch.mean(torch.sum(disc * pos * dpd, dim=0)),
                "pd": torch.mean(1.0 - surv[-1])})
        return {
            "cva": lgd * float(host["cva"]),
            "gamma": float(gamma),
            "hazard_rate": hazard_rate,
            "lgd": lgd,
            "mean_pd_horizon": float(host["pd"]),
        }

    def cva_delta(self, hazard_rate: float = 0.02, lgd: float = 0.6,
                  num_dates: int = 32) -> Dict[str, object]:
        """dCVA/dS0 per asset — ONE `torch.autograd.grad` pass through the
        exposure simulation (smooth a.e.; the hedge ratio for the CVA
        desk)."""
        dates = self._dates(num_dates, None)
        dates_t = self._t(dates)
        disc = torch.exp(-self.r * dates_t)
        t_prev = torch.cat([torch.zeros_like(dates_t[:1]), dates_t[:-1]])
        dpd = (torch.exp(-hazard_rate * t_prev)
               - torch.exp(-hazard_rate * dates_t))
        spots = self._t(self.spots).requires_grad_()
        net, _, _ = self._values(dates, spots=spots)
        ee = torch.mean(torch.clamp(net, min=0.0), dim=1)
        val = lgd * torch.sum(disc * ee * dpd)
        (grad,) = torch.autograd.grad(val, spots)
        host = to_host({"cva": val.detach(), "grad": grad})
        return {"cva": float(host["cva"]), "cva_delta": host["grad"].tolist()}
