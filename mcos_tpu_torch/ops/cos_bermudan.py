r"""Copy of `mcos_tpu/ops/cos_bermudan.py` (numpy only), the early-exercise
oracle of the port. tests/test_torch_levy.py holds the two equal.

Bermudan/American options by Fourier-cosine backward induction.

Fang & Oosterlee's early-exercise COS method: under exponential-Levy
dynamics (iid log-increments), the value function's cosine coefficients
propagate backward through exercise dates IN CLOSED FORM — the
continuation value is a CF-weighted cosine series, the early-exercise
point x*_m is a 1-D root-find, and the next coefficient vector splits
into an exact payoff part (chi/psi integrals on the exercise region) and
an exact continuation part (the e^{iu_j s} cos(u_k s) cross matrix on the
continuation region). No paths, no grids, no regression: this is the
EXACT Bermudan price up to spectral truncation, and the Richardson ladder
over date counts gives the American limit.

Role in the framework: the early-exercise ORACLE for the American stack.
The LSM engine (engine/american.py) is a lower bound, the Andersen-Broadie
dual an upper bound, the CRR tree and the Crank-Nicolson PDE are
discretized — this pricer pins all of them exactly under the dynamics it
covers (GBM, Merton jump-diffusion = the SVJ jump leg with the diffusion
frozen, Variance Gamma, NIG). Notably it prices American options UNDER
JUMPS semi-analytically, where no tree exists in the repo.

The reference has no American support at all (its engine is European-only,
reference engine/monte_carlo.py:249-471); this module is part of the
capability surface built beyond it.

Host numpy complex128 by design, same as ops/cos_pricer.py: the point is
exactness, the arrays are (n_terms,) and (n_terms, n_terms), and the
backward induction is a per-date data dependence — oracle work, not
device work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu_torch.ops.cos_pricer import _chi_psi

__all__ = [
    "LevyModel", "gbm_model", "merton_model", "vg_model", "nig_model",
    "bermudan_cos", "american_cos",
]


@dataclasses.dataclass(frozen=True)
class LevyModel:
    """An exponential-Levy model: increment CF + cumulants of ln S_T.

    cf(u, dt) = E[exp(iu (x_{t+dt} - x_t))] with x = ln S — spot-free and
    time-homogeneous (what makes the backward induction exact).
    c1/c2/c4 are cumulants of ln(S_T/S_0) used for the COS truncation
    interval (same L-window recipe as ops/cos_pricer.py:_cumulant_range).
    """

    cf: Callable[[np.ndarray, float], np.ndarray]
    c1: Callable[[float], float]
    c2: Callable[[float], float]
    c4: Callable[[float], float]
    r: float
    q: float


def gbm_model(sigma: float, r: float = RISK_FREE_RATE,
              q: float = DIVIDEND_YIELD) -> LevyModel:
    """Black-Scholes dynamics: x-increments N((r-q-sigma^2/2)dt, sigma^2 dt)."""
    mu = r - q - 0.5 * sigma * sigma

    def cf(u, dt):
        u = np.asarray(u, np.complex128)
        return np.exp(1j * u * mu * dt - 0.5 * sigma * sigma * u * u * dt)

    return LevyModel(cf=cf, c1=lambda T: mu * T,
                     c2=lambda T: sigma * sigma * T,
                     c4=lambda T: 0.0, r=float(r), q=float(q))


def merton_model(sigma: float, lambda_j: float, mu_j: float,
                 sigma_j: float, r: float = RISK_FREE_RATE,
                 q: float = DIVIDEND_YIELD) -> LevyModel:
    """Merton jump-diffusion: the SVJ jump leg on a frozen-variance
    diffusion (the xi -> 0, theta = v0 limit of ops/cos_pricer.bates_cf,
    which itself divides by xi^2 and cannot take that limit directly)."""
    k_bar = np.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    mu = r - q - 0.5 * sigma * sigma - lambda_j * k_bar

    def cf(u, dt):
        u = np.asarray(u, np.complex128)
        iu = 1j * u
        diff = iu * mu * dt - 0.5 * sigma * sigma * u * u * dt
        jump = lambda_j * dt * (
            np.exp(iu * mu_j - 0.5 * u * u * sigma_j * sigma_j) - 1.0)
        return np.exp(diff + jump)

    return LevyModel(
        cf=cf,
        c1=lambda T: (mu + lambda_j * mu_j) * T,
        c2=lambda T: (sigma * sigma
                      + lambda_j * (mu_j**2 + sigma_j**2)) * T,
        c4=lambda T: lambda_j * T * (mu_j**4 + 6 * mu_j**2 * sigma_j**2
                                     + 3 * sigma_j**4),
        r=float(r), q=float(q))


def vg_model(p) -> LevyModel:
    """Variance Gamma (ops/levy.py:VGParams); cumulants per vg_cos_price."""
    from mcos_tpu_torch.ops.levy import vg_cf

    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = np.log(1.0 - theta * nu - 0.5 * sigma * sigma * nu) / nu
    return LevyModel(
        cf=lambda u, dt: vg_cf(u, p, dt, 1.0),
        c1=lambda T: (r - q + omega + theta) * T,
        c2=lambda T: (sigma**2 + nu * theta**2) * T,
        c4=lambda T: 3.0 * (sigma**4 * nu + 2.0 * theta**4 * nu**3
                            + 4.0 * sigma**2 * theta**2 * nu**2) * T,
        r=r, q=q)


def nig_model(p) -> LevyModel:
    """Normal Inverse Gaussian (ops/levy.py:NIGParams)."""
    from mcos_tpu_torch.ops.levy import nig_cf

    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = (np.sqrt(1.0 - 2.0 * nu * (theta + 0.5 * sigma * sigma))
             - 1.0) / nu
    return LevyModel(
        cf=lambda u, dt: nig_cf(u, p, dt, 1.0),
        c1=lambda T: (r - q + omega + theta) * T,
        c2=lambda T: (sigma**2 + nu * theta**2) * T,
        c4=lambda T: 3.0 * (sigma**4 * nu + 2.0 * theta**4 * nu**3
                            + 4.0 * sigma**2 * theta**2 * nu**2) * T,
        r=r, q=q)


def _payoff_coef(a: float, b: float, x1: float, x2: float,
                 strike: float, is_call: bool, k: np.ndarray) -> np.ndarray:
    """Cosine coefficients (2/(b-a))∫ payoff(e^y) cos(u_k (y-a)) dy on
    [x1, x2] — closed form via the chi/psi primitives."""
    if x2 <= x1:
        return np.zeros_like(k, np.float64)
    chi, psi = _chi_psi(a, b, x1, x2, k)
    if is_call:
        return 2.0 / (b - a) * (chi - strike * psi)
    return 2.0 / (b - a) * (strike * psi - chi)


def _cont_matrix(a: float, b: float, x1: float, x2: float,
                 u: np.ndarray) -> np.ndarray:
    """M_kj = ∫_{x1}^{x2} e^{i u_j (y-a)} cos(u_k (y-a)) dy, closed form.

    Antiderivative for u_k != u_j:
        F(s) = e^{i u_j s} (i u_j cos(u_k s) + u_k sin(u_k s)) / (u_k^2 - u_j^2)
    Diagonal u_k = u_j = beta != 0:
        ∫ e^{i beta s} cos(beta s) ds = s/2 + sin(2 beta s)/(4 beta)
                                        - i cos(2 beta s)/(4 beta)
    and (d - c) at u_k = u_j = 0. All entries are outer products of
    n-vectors — O(n^2) multiplies, O(n) transcendentals.
    """
    c, d = x1 - a, x2 - a
    n = u.shape[0]
    beta = u[None, :]                      # columns: j (CF index)
    gam = u[:, None]                       # rows: k (output index)
    denom = gam * gam - beta * beta
    np.fill_diagonal(denom, 1.0)           # patched below

    def f_at(s):
        e = np.exp(1j * beta * s)
        return e * (1j * beta * np.cos(gam * s) + gam * np.sin(gam * s))

    m = (f_at(d) - f_at(c)) / denom

    def diag_at(s):
        with np.errstate(divide="ignore", invalid="ignore"):
            val = (s / 2.0 + np.sin(2.0 * u * s) / (4.0 * u)
                   - 1j * np.cos(2.0 * u * s) / (4.0 * u))
        val[0] = s                          # u_0 = 0 limit
        return val

    m[np.arange(n), np.arange(n)] = diag_at(d) - diag_at(c)
    return m


def bermudan_cos(model: LevyModel, spot: float, strike: float, T: float,
                 n_dates: int, is_call: bool = False,
                 n_terms: int = 256, L: float = 10.0) -> Dict:
    """Bermudan option with n_dates uniformly spaced exercise dates
    (t_1, ..., t_M = T) by COS backward induction.

    Returns price plus the early-exercise boundary S*(t_m) read off the
    root of continuation = payoff at each date (NaN where no exercise
    region exists, e.g. a call on a zero-dividend asset).
    """
    x0 = float(np.log(spot))
    r, q = model.r, model.q
    half = L * np.sqrt(model.c2(T) + np.sqrt(max(model.c4(T), 0.0)))
    a = x0 + model.c1(T) - half
    b = x0 + model.c1(T) + half
    lnk = float(np.log(strike))

    k = np.arange(n_terms)
    u = k * np.pi / (b - a)
    w = np.ones(n_terms)
    w[0] = 0.5
    dt = T / n_dates
    phi = model.cf(u, dt)
    disc = np.exp(-r * dt)

    def cont_value(x, v):
        """Continuation value c(x) from next-date coefficients v."""
        return disc * float(
            (w * np.real(phi * v * np.exp(1j * u * (x - a)))).sum())

    def find_xstar(v) -> float:
        """Root of c(x) - payoff(x) on the in-the-money side; returns the
        no-exercise sentinel (a for puts, b for calls) if continuation
        dominates everywhere."""
        if is_call:
            lo, hi = max(lnk, a), b
            if cont_value(hi, v) >= np.exp(hi) - strike:
                return b
        else:
            lo, hi = a, min(lnk, b)
            if cont_value(lo, v) >= (strike - np.exp(lo)):
                return a
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            pay = (np.exp(mid) - strike) if is_call else (strike - np.exp(mid))
            if cont_value(mid, v) > pay:
                # continuation wins at mid: exercise region is further ITM
                if is_call:
                    lo = mid
                else:
                    hi = mid
            else:
                if is_call:
                    hi = mid
                else:
                    lo = mid
        return 0.5 * (lo + hi)

    # Terminal coefficients: the payoff itself.
    if is_call:
        v = _payoff_coef(a, b, max(lnk, a), b, strike, True, k)
    else:
        v = _payoff_coef(a, b, a, min(lnk, b), strike, False, k)

    boundary: List[float] = [float(strike)]   # S*(T) = K for both sides
    # Model-free (Merton 1973): a call on a non-dividend-paying asset is
    # never exercised early — skip the root-find, which would otherwise
    # chase truncation-edge wiggle into a spurious sliver near b.
    no_early_call = is_call and q <= 0.0 <= r
    # Backward over t_{M-1}, ..., t_1 (early-exercise dates).
    for _ in range(n_dates - 1):
        xs = b if no_early_call else find_xstar(v)
        if is_call:
            no_ex = xs >= b - 1e-13
            g = _payoff_coef(a, b, xs, b, strike, True, k)
            m = _cont_matrix(a, b, a, xs, u)
        else:
            no_ex = xs <= a + 1e-13
            g = _payoff_coef(a, b, a, xs, strike, False, k)
            m = _cont_matrix(a, b, xs, b, u)
        boundary.append(np.nan if no_ex else float(np.exp(xs)))
        c_k = 2.0 / (b - a) * disc * np.real(m @ (w * phi * v))
        v = g + c_k

    price = disc * float(
        (w * np.real(phi * v * np.exp(1j * u * (x0 - a)))).sum())
    times = [dt * m for m in range(n_dates, 0, -1)]
    return {
        "price": max(price, 0.0),
        "n_dates": int(n_dates),
        "boundary_times": times,            # t_M = T first, then backward
        "boundary": boundary,               # S*(t_m), aligned with times
        "interval": (a, b),
    }


def american_cos(model: LevyModel, spot: float, strike: float, T: float,
                 is_call: bool = False, n_terms: int = 256,
                 L: float = 10.0, base_dates: int = 8,
                 levels: int = 4) -> Dict:
    """American price by Richardson extrapolation over the Bermudan date
    ladder M, 2M, 4M, ... (the Bermudan-to-American gap is O(1/M); the
    repeated-Richardson table removes successive powers).

    With the defaults the finest Bermudan has 64 dates and the 4-level
    table is exact through O(1/M^3) — ~1e-4-relative agreement with a
    5000-step CRR tree in tests.
    """
    ladder = [base_dates * 2**i for i in range(levels)]
    res = [bermudan_cos(model, spot, strike, T, m, is_call,
                        n_terms=n_terms, L=L) for m in ladder]
    tab = [float(r_["price"]) for r_ in res]
    for j in range(1, levels):
        tab = [tab[i + 1] + (tab[i + 1] - tab[i]) / (2.0**j - 1.0)
               for i in range(len(tab) - 1)]
    intrinsic = max(strike - spot, 0.0) if not is_call \
        else max(spot - strike, 0.0)
    return {
        "price": max(tab[0], intrinsic),
        "ladder_dates": ladder,
        "ladder_prices": [float(r_["price"]) for r_ in res],
        "boundary_times": res[-1]["boundary_times"],
        "boundary": res[-1]["boundary"],
    }
