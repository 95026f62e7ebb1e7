r"""Variance Gamma and NIG: pure-jump Lévy models with EXACT terminal
samplers (counterpart of `mcos_tpu/ops/levy.py`).

The Madan-Carr-Chang Variance Gamma process, Brownian motion with drift
run on a gamma clock,

    ln S_T = ln S0 + (r - q + omega) T + theta*G + sigma*sqrt(G)*Z,
    G ~ Gamma(T/nu, nu),   omega = ln(1 - theta*nu - sigma^2 nu/2)/nu,

and the Normal Inverse Gaussian, the same Brownian motion on an inverse
Gaussian clock I ~ IG(mean=T, Var=nu*T).

The host parts (the characteristic functions, the COS prices and the
scipy calibrations) are copies of the JAX package's, numpy float64. The
terminal samplers and the Monte Carlo prices are torch programs: the gamma
clock from `torch._standard_gamma`, the IG clock from the Michael-Schucany-
Haas transform of one normal and one uniform, then one normal for the
Brownian leg. Each sampler draws from an explicit `torch.Generator`, or
takes its variates as `draws=` (tests/test_torch_levy.py replays the JAX
key's through them). Pricing is one elementwise expression over the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mcos_tpu_torch.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu_torch.ops.cos_pricer import _chi_psi
from mcos_tpu_torch.ops.simulate import _f32, _pair_payoffs


@dataclasses.dataclass(frozen=True)
class VGParams:
    """Variance Gamma parameters (risk-neutral).

    theta < 0 tilts the gamma-time Brownian motion down (negative skew);
    nu is the variance of the gamma clock per unit time (kurtosis);
    sigma the diffusion scale on the business clock.
    """

    sigma: float = 0.2
    nu: float = 0.2
    theta: float = -0.14
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def omega(self) -> float:
        """Martingale compensator: E[e^{omega T + theta G + ...}] = 1."""
        arg = 1.0 - self.theta * self.nu - 0.5 * self.sigma**2 * self.nu
        return float(np.log(arg) / self.nu)


def vg_cf(u: np.ndarray, p: VGParams, T: float, spot: float) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] (host complex128)."""
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = np.log(1.0 - theta * nu - 0.5 * sigma**2 * nu) / nu
    u = np.asarray(u, np.complex128)
    iu = 1j * u
    drift = iu * (np.log(spot) + (r - q + omega) * T)
    base = 1.0 - iu * theta * nu + 0.5 * sigma**2 * nu * u**2
    return np.exp(drift) * base ** (-T / nu)


def vg_cos_price(p: VGParams, spot: float, strikes, T: float,
                 is_call: bool = True, n_terms: int = 512,
                 L: float = 14.0) -> np.ndarray:
    """Semi-analytic VG prices (COS; the MC engine's exact oracle).

    Truncation from the VG cumulants of ln S_T:
        c1 = ln S0 + (r-q+omega)T + theta T
        c2 = (sigma^2 + nu theta^2) T
        c4 = 3 (sigma^4 nu + 2 theta^4 nu^3 + 4 sigma^2 theta^2 nu^2) T.
    """
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = np.log(1.0 - theta * nu - 0.5 * sigma**2 * nu) / nu
    strikes = np.atleast_1d(np.asarray(strikes, np.float64))

    c1 = np.log(spot) + (r - q + omega) * T + theta * T
    c2 = (sigma**2 + nu * theta**2) * T
    c4 = 3.0 * (sigma**4 * nu + 2.0 * theta**4 * nu**3
                + 4.0 * sigma**2 * theta**2 * nu**2) * T
    half = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    a, b = c1 - half, c1 + half

    k = np.arange(n_terms)
    u = k * np.pi / (b - a)
    phi = vg_cf(u, p, T, spot)
    weights = np.ones(n_terms)
    weights[0] = 0.5
    x_shift = np.exp(-1j * u * a)

    prices = np.empty(strikes.shape, np.float64)
    for i, K in enumerate(strikes):
        lnK = np.log(K)
        c_lo, c_hi = a, min(lnK, b)
        if c_hi <= c_lo:
            put = 0.0
        else:
            chi, psi = _chi_psi(a, b, c_lo, c_hi, k)
            v_k = 2.0 / (b - a) * (K * psi - chi)
            put = np.exp(-r * T) * np.sum(
                weights * np.real(phi * x_shift) * v_k)
        prices[i] = (put + spot * np.exp(-q * T) - K * np.exp(-r * T)
                     if is_call else put)
    return np.maximum(prices, 0.0)


def _clock_draws(draws, n: int, k: int, what: str):
    """The caller's `draws`: k (n,) float32 tensors, checked."""
    draws = tuple(draws)
    if len(draws) != k or any(tuple(d.shape) != (n,) for d in draws):
        raise ValueError(f"draws must be {k} ({n},) tensors: {what}")
    return draws


def _brownian_on_clock(p, spot, T, clock: torch.Tensor, z: torch.Tensor,
                       antithetic: bool) -> torch.Tensor:
    """(branches, paths) spots: spot·exp((r−q+ω)T + θ·C + σ√C·(±Z)) on the
    clock C; antithetic negates Z on the shared clock."""
    device = clock.device
    T = _f32(T, device)
    n_branch = 2 if antithetic else 1
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]
    growth = ((p.r - p.q + float(np.float32(p.omega))) * T
              + p.theta * clock[None, :]
              + p.sigma * torch.sqrt(clock)[None, :] * (sign * z[None, :]))
    return _f32(spot, device) * torch.exp(growth)


def vg_terminal(p: VGParams, spot, T,
                generator: Optional[torch.Generator] = None, *,
                num_paths: int, antithetic: bool = True,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                device="cuda") -> torch.Tensor:
    """(branches, paths) EXACT terminal spots — one gamma + one normal.

    Antithetic negates Z on the shared gamma clock (the clock itself has
    no useful antithetic pairing; sharing it keeps the pair's business
    time identical, which is what makes the variance reduction work).
    `draws` = (g, z): (num_paths,) standard Gamma(T/nu) variates and
    normals; else drawn from `generator`, the gamma variates first.
    """
    if draws is None:
        device = torch.device(device)
        shape = _f32(T, device) / p.nu
        g_std = torch._standard_gamma(shape.expand(num_paths).contiguous(),
                                      generator=generator)
        z = torch.randn((num_paths,), generator=generator, device=device,
                        dtype=torch.float32)
    else:
        g_std, z = _clock_draws(draws, num_paths, 2,
                                "standard gamma variates, normals")
    g = p.nu * g_std
    return _brownian_on_clock(p, spot, T, g, z, antithetic)


def _mc_price(p, s: torch.Tensor, strikes, T, is_call: bool):
    """(prices, std_errors) per strike from (branches, paths) spots:
    branch-averaged payoffs, population std / √paths."""
    device = s.device
    strikes = torch.atleast_1d(_f32(np.asarray(strikes, np.float32), device))
    comb = _pair_payoffs(s, strikes, is_call)
    disc = torch.exp(-_f32(p.r, device) * _f32(T, device))
    mean = disc * torch.mean(comb, dim=0)
    se = disc * torch.std(comb, dim=0, correction=0) / float(
        np.sqrt(np.float32(comb.shape[0]), dtype=np.float32))
    return mean, se


def vg_price_mc(p: VGParams, spot, strikes, T,
                generator: Optional[torch.Generator] = None, *,
                num_paths: int, is_call: bool, antithetic: bool = True,
                draws=None, device="cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prices, std_errors) per strike from the exact terminal sampler."""
    s = vg_terminal(p, spot, T, generator, num_paths=num_paths,
                    antithetic=antithetic, draws=draws, device=device)
    return _mc_price(p, s, strikes, T, is_call)


def nig_price_mc(p: "NIGParams", spot, strikes, T,
                 generator: Optional[torch.Generator] = None, *,
                 num_paths: int, is_call: bool, antithetic: bool = True,
                 draws=None, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prices, std_errors) per strike from the exact NIG terminal
    sampler — the vg_price_mc estimator verbatim on the IG clock."""
    s = nig_terminal(p, spot, T, generator, num_paths=num_paths,
                     antithetic=antithetic, draws=draws, device=device)
    return _mc_price(p, s, strikes, T, is_call)


def levy_price_mc(p, spot, strikes, T,
                  generator: Optional[torch.Generator] = None, *,
                  num_paths: int, is_call: bool = True, mesh=None,
                  draws=None, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-dispatched Lévy MC pricing (VGParams | NIGParams).

    mesh=None honours MCOS_AUTO_MESH=1; "auto" or a Mesh routes through
    the pooled driver (`parallel/families.py:sharded_levy_price`), which
    reproduces the single-device estimator on the pooled union sample.
    The shards take the generator's seed, not its state: shard 0 draws
    what `generator` draws, so it must not have drawn yet. Given one that
    has drawn (or none), an explicit mesh raises ValueError, and the
    toggle's mesh leaves the call on one device."""
    from mcos_tpu_torch.engine.pricer import has_not_drawn, resolve_mesh

    explicit = mesh is not None
    mesh = resolve_mesh(mesh)
    if mesh is not None:
        if generator is not None and has_not_drawn(generator):
            from mcos_tpu_torch.parallel.families import sharded_levy_price

            res = sharded_levy_price(p, spot, strikes, T,
                                     generator.initial_seed(), mesh=mesh,
                                     num_paths=num_paths, is_call=is_call)
            return res["price"], res["std_error"]
        if explicit:
            raise ValueError("a mesh seeds its shards from the seed of "
                             "`generator`: pass one that has not drawn")
    fn = vg_price_mc if isinstance(p, VGParams) else nig_price_mc
    return fn(p, spot, strikes, T, generator, num_paths=num_paths,
              is_call=is_call, draws=draws, device=device)


def calibrate_vg(spot: float, strikes, T: float, market_prices,
                 r: float = None, q: float = None, is_call: bool = True,
                 n_starts: int = 4, seed: int = 0) -> dict:
    """Fit (sigma, nu, theta) to a single-maturity price smile.

    The COS objective is host f64 and ~microseconds per evaluation, so a
    multi-start trust-region least squares (scipy) is the right tool —
    no MC noise, no device round-trips inside the optimizer. Round-trip
    recovery of generating parameters is test-pinned.
    """
    from scipy.optimize import least_squares

    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    lo = np.array([0.02, 0.01, -1.5])
    hi = np.array([2.00, 2.00, 0.5])

    def resid(x):
        sigma, nu, theta = x
        # Keep the omega log argument positive (hard model constraint).
        if 1.0 - theta * nu - 0.5 * sigma**2 * nu <= 1e-6:
            return np.full(market.shape, 1e3)
        p = VGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q)
        return vg_cos_price(p, spot, strikes, T, is_call) - market

    rng = np.random.default_rng(seed)
    best = None
    starts = [np.array([0.2, 0.2, -0.1])] + [
        lo + rng.random(3) * (hi - lo) for _ in range(n_starts - 1)]
    for x0 in starts:
        if 1.0 - x0[2] * x0[1] - 0.5 * x0[0]**2 * x0[1] <= 1e-3:
            continue
        try:
            res = least_squares(resid, x0, bounds=(lo, hi), xtol=1e-12)
        except Exception:  # noqa: BLE001 — a bad start must not kill the fit
            continue
        if best is None or res.cost < best.cost:
            best = res
    if best is None:
        raise RuntimeError("VG calibration failed from every start")
    sigma, nu, theta = (float(v) for v in best.x)
    rmse = float(np.sqrt(2.0 * best.cost / max(market.size, 1)))
    return {
        "params": VGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q),
        "sigma": sigma, "nu": nu, "theta": theta,
        "rmse_price": rmse, "n_quotes": int(market.size),
    }


# ─────────────────────────────────────────────────────────────────────────────
# Normal Inverse Gaussian: BM on an inverse-Gaussian clock
# ─────────────────────────────────────────────────────────────────────────────
@dataclasses.dataclass(frozen=True)
class NIGParams:
    """NIG in the time-change parametrization: X_T = theta*I + sigma*
    sqrt(I)*Z with I ~ InverseGaussian(mean=T, Var=nu*T) — the same
    (sigma, nu, theta) reading as VGParams but with semi-heavy
    (exponential-ish) tails instead of VG's heavier ones."""

    sigma: float = 0.2
    nu: float = 0.2
    theta: float = -0.14
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def omega(self) -> float:
        """Martingale compensator from the IG Laplace transform:
        E[e^{(theta + sigma^2/2) I}] = exp(T/nu (1 - sqrt(1 - 2 nu s)))."""
        s = self.theta + 0.5 * self.sigma**2
        return float((np.sqrt(1.0 - 2.0 * self.nu * s) - 1.0) / self.nu)


def nig_cf(u: np.ndarray, p: "NIGParams", T: float,
           spot: float) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] (host complex128)."""
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = (np.sqrt(1.0 - 2.0 * nu * (theta + 0.5 * sigma**2))
             - 1.0) / nu
    u = np.asarray(u, np.complex128)
    iu = 1j * u
    drift = iu * (np.log(spot) + (r - q + omega) * T)
    s = 0.5 * sigma**2 * u**2 - 1j * theta * u
    return np.exp(drift + (T / nu) * (1.0 - np.sqrt(1.0 + 2.0 * nu * s)))


def nig_cos_price(p: "NIGParams", spot: float, strikes, T: float,
                  is_call: bool = True, n_terms: int = 512,
                  L: float = 14.0) -> np.ndarray:
    """Semi-analytic NIG prices (COS; the exact-sampler's oracle)."""
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = (np.sqrt(1.0 - 2.0 * nu * (theta + 0.5 * sigma**2))
             - 1.0) / nu
    strikes = np.atleast_1d(np.asarray(strikes, np.float64))
    c1 = np.log(spot) + (r - q + omega) * T + theta * T
    c2 = (sigma**2 + nu * theta**2) * T
    c4 = 3.0 * (sigma**4 * nu + 2.0 * theta**4 * nu**3
                + 4.0 * sigma**2 * theta**2 * nu**2) * T
    half = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    a, b = c1 - half, c1 + half
    k = np.arange(n_terms)
    u = k * np.pi / (b - a)
    phi = nig_cf(u, p, T, spot)
    weights = np.ones(n_terms)
    weights[0] = 0.5
    x_shift = np.exp(-1j * u * a)
    prices = np.empty(strikes.shape, np.float64)
    for i, K in enumerate(strikes):
        c_lo, c_hi = a, min(np.log(K), b)
        if c_hi <= c_lo:
            put = 0.0
        else:
            chi, psi = _chi_psi(a, b, c_lo, c_hi, k)
            v_k = 2.0 / (b - a) * (K * psi - chi)
            put = np.exp(-r * T) * np.sum(
                weights * np.real(phi * x_shift) * v_k)
        prices[i] = (put + spot * np.exp(-q * T) - K * np.exp(-r * T)
                     if is_call else put)
    return np.maximum(prices, 0.0)


def _sample_inverse_gaussian(generator: Optional[torch.Generator], mu, lam,
                             shape, *, draws=None, device="cuda"
                             ) -> torch.Tensor:
    """Michael-Schucany-Haas IG(mean=mu, shape=lam) sampler — branchless
    (one normal + one uniform + a select). `draws` = (z, u), else drawn
    from `generator`, the normals first."""
    if draws is None:
        device = torch.device(device)
        z = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
    else:
        z, u = draws
    y = z * z
    x = (mu + 0.5 * mu * mu * y / lam
         - 0.5 * mu / lam * torch.sqrt(4.0 * mu * lam * y + (mu * y) ** 2))
    x = torch.clamp(x, min=1e-12)
    return torch.where(u <= mu / (mu + x), x, mu * mu / x)


def nig_terminal(p: "NIGParams", spot, T,
                 generator: Optional[torch.Generator] = None, *,
                 num_paths: int, antithetic: bool = True,
                 draws: Optional[Tuple[torch.Tensor, ...]] = None,
                 device="cuda") -> torch.Tensor:
    """(branches, paths) EXACT terminal spots — one IG draw + one normal
    (antithetic negates Z on the shared clock, as in VG). `draws` =
    (z_ig, u_ig, z): the IG sampler's normal and uniform, then the
    Brownian leg's normal, each (num_paths,); else drawn from `generator`
    in that order."""
    if draws is None:
        device = torch.device(device)
        ig_draws = None
    else:
        z_ig, u_ig, z = _clock_draws(draws, num_paths, 3,
                                     "IG normals, IG uniforms, normals")
        device = z.device
        ig_draws = (z_ig, u_ig)
    T_ = _f32(T, device)
    # I ~ IG(mean=T, Var=nu*T): Var = mu^3/lam with mu = T ⇒ lam = T^2/nu.
    ig = _sample_inverse_gaussian(generator, T_, T_ * T_ / p.nu,
                                  (num_paths,), draws=ig_draws,
                                  device=device)
    if draws is None:
        z = torch.randn((num_paths,), generator=generator, device=device,
                        dtype=torch.float32)
    return _brownian_on_clock(p, spot, T, ig, z, antithetic)


def calibrate_nig(spot: float, strikes, T: float, market_prices,
                  r: float = None, q: float = None, is_call: bool = True,
                  n_starts: int = 4, seed: int = 0) -> dict:
    """Fit NIG (sigma, nu, theta) to a single-maturity price smile —
    same multi-start trust-region recipe as `calibrate_vg` (the COS
    objective is host f64 microseconds). Round-trip recovery pinned."""
    from scipy.optimize import least_squares

    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    lo = np.array([0.02, 0.01, -1.5])
    hi = np.array([2.00, 2.00, 0.5])

    def resid(x):
        sigma, nu, theta = x
        # The IG Laplace sqrt argument must stay positive.
        if 1.0 - 2.0 * nu * (theta + 0.5 * sigma**2) <= 1e-6:
            return np.full(market.shape, 1e3)
        p = NIGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q)
        return nig_cos_price(p, spot, strikes, T, is_call) - market

    rng = np.random.default_rng(seed)
    best = None
    starts = [np.array([0.2, 0.2, -0.1])] + [
        lo + rng.random(3) * (hi - lo) for _ in range(n_starts - 1)]
    for x0 in starts:
        if 1.0 - 2.0 * x0[1] * (x0[2] + 0.5 * x0[0]**2) <= 1e-3:
            continue
        try:
            res = least_squares(resid, x0, bounds=(lo, hi), xtol=1e-12)
        except Exception:  # noqa: BLE001
            continue
        if best is None or res.cost < best.cost:
            best = res
    if best is None:
        raise RuntimeError("NIG calibration failed from every start")
    sigma, nu, theta = (float(v) for v in best.x)
    return {
        "params": NIGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q),
        "sigma": sigma, "nu": nu, "theta": theta,
        "rmse_price": float(np.sqrt(2.0 * best.cost
                                    / max(market.size, 1))),
        "n_quotes": int(market.size),
    }
