"""Copy of `mcos_tpu/ops/cos_pricer.py` (numpy only); the SVJ oracle of the
port. tests/test_torch_copies.py holds the two equal.

Semi-analytic SVJ (Bates) pricing via the COS method.

The SVJ model (Heston + Merton lognormal jumps) *is* the Bates (1996) model,
which has a closed-form characteristic function — so European prices have a
semi-analytic expansion (Fang-Oosterlee COS method). The reference never
exploits this; it Monte-Carlos everything, including inside its calibration
objective (its scaling wall, SURVEY.md §3.3).

Here the COS pricer serves as:
1. **An exact oracle for the whole MC engine** — full-SVJ prices, not just
   the degenerate-BS limit the reference's smoke test uses (verify.py:29-30).
2. **A fast calibration objective** — one chain evaluation is a (strikes ×
   N-terms) matvec, ~10⁶× cheaper than a 100k-path MC per strike.

Host numpy complex128 by design: exactness is the point (the TPU engines
consume its outputs as references), the arrays are tiny, and complex support
on TPU is partial.

Heston CF uses the Albrecher et al. "little trap" formulation (no branch-cut
discontinuities in T). Truncation range from the first/second/fourth
cumulants with L=12.
"""

from __future__ import annotations

import numpy as np

from mcos_tpu_torch.models.params import SVJParams


def bates_cf(u: np.ndarray, params: SVJParams, T: float,
             spot: float) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] of the Bates/SVJ model."""
    p = params
    kappa = float(p.kappa)
    theta = float(p.theta)
    xi = float(p.xi)
    rho = float(p.rho)
    v0 = float(p.v0)
    lam = float(p.lambda_j)
    mu_j = float(p.mu_j)
    sig_j = float(p.sigma_j)
    r, q = float(p.r), float(p.q)

    u = np.asarray(u, np.complex128)
    iu = 1j * u

    # Heston part ("little trap": use g2 = 1/g to keep |g2 e^{-dT}| < 1).
    beta = kappa - rho * xi * iu
    d = np.sqrt(beta**2 + xi**2 * (iu + u**2))
    g2 = (beta - d) / (beta + d)
    exp_dt = np.exp(-d * T)
    log_term = np.log((1.0 - g2 * exp_dt) / (1.0 - g2))
    C = (kappa * theta / xi**2) * ((beta - d) * T - 2.0 * log_term)
    D = ((beta - d) / xi**2) * (1.0 - exp_dt) / (1.0 - g2 * exp_dt)

    # Merton jump part with the martingale compensator −iuλk̄T.
    k_bar = np.exp(mu_j + 0.5 * sig_j**2) - 1.0
    jump = lam * T * (np.exp(iu * mu_j - 0.5 * u**2 * sig_j**2) - 1.0) \
        - iu * lam * k_bar * T

    drift = iu * (np.log(spot) + (r - q) * T)
    return np.exp(drift + C + D * v0 + jump)


def _cumulant_range(params: SVJParams, T: float, spot: float,
                    L: float = 12.0):
    """Truncation interval [a, b] for ln S_T from cumulants (F&O eq. 49)."""
    p = params
    kappa, theta, xi = float(p.kappa), float(p.theta), float(p.xi)
    rho, v0 = float(p.rho), float(p.v0)
    lam, mu_j, sig_j = float(p.lambda_j), float(p.mu_j), float(p.sigma_j)
    r, q = float(p.r), float(p.q)
    k_bar = np.exp(mu_j + 0.5 * sig_j**2) - 1.0

    # c1: mean of ln S_T.
    ekt = np.exp(-kappa * T) if kappa > 1e-8 else 1.0 - kappa * T
    if kappa > 1e-8:
        int_v = theta * T + (v0 - theta) * (1.0 - ekt) / kappa
    else:
        int_v = v0 * T
    c1 = np.log(spot) + (r - q - lam * k_bar) * T - 0.5 * int_v \
        + lam * T * mu_j

    # c2: variance (Heston exact-ish + jump contribution). The closed form
    # divides by κ³ with terms ~ξ²/κ² that only cancel analytically — at
    # κT ≲ 0.01 f64 cancellation fails catastrophically (measured: a
    # κ=1e-6 degenerate-GBM interval 70 log-units wide instead of 0.7).
    # Small-κ branch: the exact κ=0 second moment by Itô isometry,
    #   Var(logS) = v₀T + ξ²v₀T³/12 − ρξv₀T²/2  (v_t = v₀ + ξ∫√v dW₂),
    # correct to O(κT) for the truncation's purposes.
    if kappa * T > 0.01:
        c2_h = (xi * T * kappa * ekt * (v0 - theta) * (8 * kappa * rho - 4 * xi)
                + kappa * rho * xi * (1 - ekt) * (16 * theta - 8 * v0)
                + 2 * theta * kappa * T * (-4 * kappa * rho * xi + xi**2
                                           + 4 * kappa**2)
                + xi**2 * ((theta - 2 * v0) * np.exp(-2 * kappa * T)
                           + theta * (6 * ekt - 7) + 2 * v0)
                + 8 * kappa**2 * (v0 - theta) * (1 - ekt)) / (8 * kappa**3)
    else:
        c2_h = (v0 * T + xi**2 * v0 * T**3 / 12.0
                - rho * xi * v0 * T**2 / 2.0)
    c2_j = lam * T * (mu_j**2 + sig_j**2)
    c2 = abs(c2_h) + c2_j

    # Fourth-cumulant padding from jumps (fat tails need wider truncation).
    c4 = lam * T * (mu_j**4 + 6 * mu_j**2 * sig_j**2 + 3 * sig_j**4)
    half_width = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    return c1 - half_width, c1 + half_width


def _chi_psi(a: float, b: float, c: float, d: float, k: np.ndarray):
    """COS payoff coefficients: χ = ∫ e^y cos(kπ(y−a)/(b−a)) dy on [c,d],
    ψ = ∫ cos(·) dy on [c,d] (Fang-Oosterlee eqs. 22-23)."""
    omega = k * np.pi / (b - a)
    chi = (np.cos(omega * (d - a)) * np.exp(d)
           - np.cos(omega * (c - a)) * np.exp(c)
           + omega * np.sin(omega * (d - a)) * np.exp(d)
           - omega * np.sin(omega * (c - a)) * np.exp(c)) / (1.0 + omega**2)
    psi = np.empty_like(chi)
    psi[1:] = (np.sin(omega[1:] * (d - a))
               - np.sin(omega[1:] * (c - a))) / omega[1:]
    psi[0] = d - c
    return chi, psi


def cos_expansion_from_phi(phi: np.ndarray, a: float, b: float,
                           spot: float, strikes, T: float, r: float,
                           q: float, is_call: bool) -> np.ndarray:
    """COS put expansion + parity, given CF values on the term grid.

    Shared by the Bates pricer below and every other model with a
    characteristic function (VG/NIG in ops/levy.py, SVCJ in ops/svcj.py).
    `phi` must be the CF of ln S_T evaluated at u_k = kπ/(b−a).
    """
    strikes = np.atleast_1d(np.asarray(strikes, np.float64))
    n_terms = phi.shape[0]
    k = np.arange(n_terms)
    u = k * np.pi / (b - a)
    prices = np.empty(strikes.shape, np.float64)
    weights = np.ones(n_terms)
    weights[0] = 0.5
    for i, K in enumerate(strikes):
        x_shift = np.exp(-1j * u * a)
        # Put payoff coefficients on [a, ln K]: V_k = 2K/(b−a)(−χ+ψ) with the
        # integrand in y = ln(S_T/K)… here y = ln S_T directly, payoff
        # (K − e^y)+ = K·1 − e^y on [a, ln K].
        lnK = np.log(K)
        c_lo, c_hi = a, min(lnK, b)
        if c_hi <= c_lo:
            put = 0.0
        else:
            chi, psi = _chi_psi(a, b, c_lo, c_hi, k)
            v_k = 2.0 / (b - a) * (K * psi - chi)
            put = np.exp(-r * T) * np.sum(
                weights * np.real(phi * x_shift) * v_k)
        if is_call:
            prices[i] = put + spot * np.exp(-q * T) - K * np.exp(-r * T)
        else:
            prices[i] = put
    return np.maximum(prices, 0.0)


def cos_price(params: SVJParams, spot: float, strikes, T: float,
              is_call: bool = True, n_terms: int = 512,
              L: float = 12.0) -> np.ndarray:
    """European SVJ/Bates prices for a strike vector via the COS expansion.

    Put prices are computed directly (the put payoff is bounded on the
    truncation interval, the numerically stable choice) and calls recovered
    by put-call parity — standard COS practice.
    """
    p = params
    r, q = float(p.r), float(p.q)
    a, b = _cumulant_range(params, T, spot, L=L)
    # CF of x = ln S_T; the strike enters via the payoff coefficients with
    # x normalized by ln K, so evaluate the CF once and phase-shift per K.
    u = np.arange(n_terms) * np.pi / (b - a)
    phi = bates_cf(u, params, T, spot)
    return cos_expansion_from_phi(phi, a, b, spot, strikes, T, r, q,
                                  is_call)


def heston_price(params: SVJParams, spot: float, strikes, T: float,
                 is_call: bool = True, n_terms: int = 512) -> np.ndarray:
    """Pure-Heston convenience wrapper (λ forced to 0)."""
    return cos_price(params.replace(lambda_j=0.0), spot, strikes, T,
                     is_call, n_terms=n_terms)


def cos_density(params: SVJParams, spot: float, T: float,
                s_grid=None, n_points: int = 201, n_terms: int = 512,
                L: float = 12.0):
    """Risk-neutral terminal density of S_T — exact Fourier inversion.

    The COS expansion of the density itself (Fang & Oosterlee's starting
    point): with x = ln S_T on [a, b] and u_k = kπ/(b−a),

        f_x(x) = (2/(b−a)) Σ'_k Re[φ(u_k) e^{−iu_k a}] cos(u_k (x − a)),
        f_S(s) = f_x(ln s)/s.

    This is the model-exact Breeden–Litzenberger density (e^{rT}·∂²C/∂K²,
    test-pinned against FD of `cos_price`) — what a desk plots to see where
    the smile puts the probability mass. Host f64, same CF/cumulant
    machinery as the pricer.

    Returns (s_grid, pdf). Default grid: log-spaced across an L=5 cumulant
    window (the central mass; the CF truncation interval itself stays at
    the wide L).
    """
    a, b = _cumulant_range(params, T, spot, L=L)
    u = np.arange(n_terms) * np.pi / (b - a)
    phi = bates_cf(u, params, T, spot)
    if s_grid is None:
        lo, hi = _cumulant_range(params, T, spot, L=5.0)
        s_grid = np.exp(np.linspace(lo, hi, int(n_points)))
    s_grid = np.asarray(s_grid, np.float64)
    x = np.log(s_grid)
    weights = np.ones(n_terms)
    weights[0] = 0.5
    coeff = weights * np.real(phi * np.exp(-1j * u * a))
    f_x = (2.0 / (b - a)) * (coeff @ np.cos(u[:, None] * (x - a)[None, :]))
    return s_grid, np.maximum(f_x, 0.0) / s_grid
