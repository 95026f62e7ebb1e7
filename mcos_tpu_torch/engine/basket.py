"""Multi-asset SVJ basket options (counterpart of
`mcos_tpu/engine/basket.py`).

Every asset follows its own SVJ dynamics (per-asset κ, θ, ξ, ρ, v₀, jumps)
while the spot-driving Brownian motions are correlated across assets
through a Cholesky factor. Variance processes stay asset-local (each v_i is
driven by its own dW₂, correlated only with its own dW₁), and jumps are
idiosyncratic.

Shape on the card: one Python step loop of torch ops with every per-asset
computation batched on an asset axis. The A-asset step (`_basket_step`) is
the single-asset step on (…, A, paths) tensors plus one (A × A)·(A, paths)
matmul for the spot-shock mixing. Antithetic pairs as usual: the sign
multiplies all three normals, the jump uniforms are shared. No kernel of
the repo computes correlated assets; the JAX package runs a `lax.scan`.

Randoms: a `torch.Generator`, one step's (3, A, paths) normals and (A,
paths) jump uniforms at a time (a 64-asset, 200 000-path sheet never holds
more than a step of randoms), or `draws=(z, u)`, (steps, 3, A, paths) and
(steps, A, paths). The draws do not depend on the correlation, only the
Cholesky mix does: the same seed gives every correlation the same normals,
which `implied_correlation`'s bisection needs (common random numbers).

Estimator: the basket payoff max(±(Σ wᵢ S_T,i − K), 0) with the geometric
basket of the GBM companion legs as its control, whose expectation is
Black-76 in closed form (`_geometric_basket_undiscounted`, host float64);
two-asset rainbows against Stulz and spreads against Margrabe
(`ops/rainbow.py`) on the companions.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import scaled_steps
from mcos_tpu_torch.engine.cliquet import _optimal_beta_adjust
from mcos_tpu_torch.engine.pricer import resolve_mesh, seeded_generator
from mcos_tpu_torch.models.params import SVJParams, _stack_params
from mcos_tpu_torch.ops.simulate import (
    _f32,
    _safe_sqrt,
    _step_draws,
    combine_antithetic,
    mc_mean_stderr,
)


def _cholesky_jittered(corr: np.ndarray) -> np.ndarray:
    """Float64 Cholesky factor of `corr`, retried with diagonal jitter 0,
    1e-10, 1e-8, 1e-6, so that PSD-singular matrices (ρ = 1 blocks)
    factor; ValueError if none does."""
    eye = np.eye(corr.shape[0])
    for jitter in (0.0, 1e-10, 1e-8, 1e-6):
        try:
            return np.linalg.cholesky(corr + jitter * eye)
        except np.linalg.LinAlgError:
            continue
    raise ValueError("correlation matrix is not PSD")


def _basket_cols(p: SVJParams, device) -> dict:
    """Per-asset scalar coefficients shaped (1, A, 1) for broadcasting
    against (..., A, paths) state blocks: one construction shared by every
    multi-asset simulator (terminal, observations/states, and the dual
    bound's nested inner transitions). `p` has (A,) leaves
    (`_stack_params`)."""
    leaf = {k: torch.as_tensor(np.asarray(getattr(p, k), np.float32),
                               device=device)
            for k in ("kappa", "theta", "xi", "rho", "v0", "lambda_j",
                      "mu_j", "sigma_j", "r", "q")}
    col = lambda x: x[None, :, None]  # noqa: E731
    rho = col(leaf["rho"])
    k_comp = torch.exp(leaf["mu_j"] + 0.5 * leaf["sigma_j"]**2) - 1.0
    return {
        "kappa": col(leaf["kappa"]), "theta": col(leaf["theta"]),
        "xi": col(leaf["xi"]), "rho": rho,
        "rho_perp": torch.sqrt(1.0 - rho * rho),
        "drift": col(leaf["r"]) - col(leaf["q"])
        - col(leaf["lambda_j"] * k_comp),
        "lam": col(leaf["lambda_j"]), "mu_j": col(leaf["mu_j"]),
        "sig_j": col(leaf["sigma_j"]), "v0": col(leaf["v0"]),
        "r": col(leaf["r"]), "q": col(leaf["q"]),
    }


def _basket_step(c: dict, dt, sqrt_dt, log_s, v, z1, z2, z_js, u_jump):
    """One correlated multi-asset SVJ step on (..., A, paths) blocks.

    `z1` is the ALREADY correlated and signed spot shock (chol @ z, ± for
    the antithetic branch); z2/z_js idiosyncratic signed normals; u_jump
    uniforms. One implementation of the step algebra."""
    v_pos = torch.clamp(v, min=0.0)
    sqrt_v = _safe_sqrt(v_pos)
    dw1 = z1 * sqrt_dt
    dw2 = c["rho"] * dw1 + c["rho_perp"] * z2 * sqrt_dt
    jump = torch.where(u_jump < c["lam"] * dt,
                       c["mu_j"] + c["sig_j"] * z_js,
                       torch.zeros((), dtype=torch.float32,
                                   device=z_js.device))
    log_s = log_s + (c["drift"] - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump
    v = torch.clamp(v_pos + c["kappa"] * (c["theta"] - v_pos) * dt
                    + c["xi"] * sqrt_v * dw2, min=0.0)
    return log_s, v


def _setup(params_batch, corr_chol, T, n_assets, num_paths, num_steps,
           generator, draws, device):
    """(device, step draws, cols, chol, dt, sqrt_dt) of a basket loop."""
    if draws is not None:
        device = draws[0].device
    device = torch.device(device)
    step_draws = _step_draws(draws, generator, (n_assets, num_paths),
                             num_steps, device)
    chol = torch.as_tensor(corr_chol, dtype=torch.float32, device=device)
    dt = _f32(T, device) / num_steps
    return (device, step_draws, _basket_cols(params_batch, device), chol,
            dt, torch.sqrt(dt))


def simulate_basket_terminal(
    params_batch: SVJParams, spots, corr_chol, T,
    generator: Optional[torch.Generator], *, num_paths: int,
    num_steps: int, antithetic: bool = True, companion: bool = True,
    draws=None, device="cuda",
):
    """Terminal spots of A correlated SVJ assets.

    Args:
        params_batch: SVJParams with (A,) leaves (`_stack_params`).
        spots: (A,) initial spots.
        corr_chol: (A, A) Cholesky factor of the spot-shock correlation.
    Returns:
        (S, G or None): S shaped (n_branch, A, num_paths); G the per-asset
        GBM companion legs on the same correlated dW₁ (σᵢ = √v₀ᵢ).
    """
    n_assets = len(spots)
    device, step_draws, cols, chol, dt, sqrt_dt = _setup(
        params_batch, corr_chol, T, n_assets, num_paths, num_steps,
        generator, draws, device)
    n_branch = 2 if antithetic else 1
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None, None]
    sigma_cv = torch.sqrt(cols["v0"])
    g_drift = (cols["r"] - cols["q"] - 0.5 * sigma_cv**2) * dt
    shape = (n_branch, n_assets, num_paths)
    log_s = log_g = torch.zeros(shape, dtype=torch.float32, device=device)
    v = cols["v0"].expand(shape)
    for t in range(num_steps):
        z, u = step_draws(t)
        # Cross-asset correlation on the SPOT shocks only (z1); the
        # variance and jump shocks stay idiosyncratic.
        z1 = (chol @ z[0])[None] * sign
        if companion:
            log_g = log_g + g_drift + sigma_cv * (z1 * sqrt_dt)
        log_s, v = _basket_step(cols, dt, sqrt_dt, log_s, v, z1,
                                z[1][None] * sign, z[2][None] * sign,
                                u[None])
    spots_c = _f32(np.asarray(spots, np.float32), device)[None, :, None]
    return (spots_c * torch.exp(log_s),
            spots_c * torch.exp(log_g) if companion else None)


def _observed(params_batch, n_assets, corr_chol, T, generator, *,
              num_paths, n_obs, steps_per_period, draws, device,
              keep_v: bool):
    """The period loop of `simulate_basket_states`: levels (and, with
    `keep_v`, variance states) at the observation dates."""
    n_steps = n_obs * steps_per_period
    device, step_draws, cols, chol, dt, sqrt_dt = _setup(
        params_batch, corr_chol, T, n_assets, num_paths, n_steps,
        generator, draws, device)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float32,
                        device=device)[:, None, None]
    shape = (2, n_assets, num_paths)
    log_s = torch.zeros(shape, dtype=torch.float32, device=device)
    v = cols["v0"].expand(shape)
    levels, v_states = [], []
    for t in range(n_steps):
        z, u = step_draws(t)
        z1 = (chol @ z[0])[None] * sign
        log_s, v = _basket_step(cols, dt, sqrt_dt, log_s, v, z1,
                                z[1][None] * sign, z[2][None] * sign,
                                u[None])
        if (t + 1) % steps_per_period == 0:
            levels.append(torch.exp(log_s))
            if keep_v:
                v_states.append(v)
    return (torch.stack(levels),
            torch.stack(v_states) if keep_v else None)


def simulate_basket_states(
    params_batch: SVJParams, spots, corr_chol, T,
    generator: Optional[torch.Generator], *, num_paths: int, n_obs: int,
    steps_per_period: int, draws=None, device="cuda",
):
    """(levels, v) of A correlated SVJ assets at the observation dates
    t_1..t_m: levels are S_{t_i}/S_0 ratios, v the variance states, each
    (m, 2, A, paths).

    A loop over observation periods, each over its steps (the cliquet
    construction, widened to the correlated multi-asset state); only the
    (log S, v) sheet crosses period boundaries. The variance states exist
    for the dual bound's nested restarts; the autocall and LSM read the
    levels only (`simulate_basket_observations`)."""
    return _observed(params_batch, len(spots), corr_chol, T, generator,
                     num_paths=num_paths, n_obs=n_obs,
                     steps_per_period=steps_per_period, draws=draws,
                     device=device, keep_v=True)


def simulate_basket_observations(
    params_batch: SVJParams, spots, corr_chol, T,
    generator: Optional[torch.Generator], *, num_paths: int, n_obs: int,
    steps_per_period: int, draws=None, device="cuda",
):
    """Gross return levels at the observation dates (m, 2, A, paths):
    `simulate_basket_states`'s loop without keeping the variance sheet."""
    return _observed(params_batch, len(spots), corr_chol, T, generator,
                     num_paths=num_paths, n_obs=n_obs,
                     steps_per_period=steps_per_period, draws=draws,
                     device=device, keep_v=False)[0]


def basket_payoff_and_control(s, g, weights, spots, strike, is_call: bool,
                              use_cv: bool):
    """(pay, ctrl_pay | None): antithetic-combined per-path payoffs.

    One implementation of the arithmetic-basket payoff and its
    geometric-companion control. `s`/`g` are the (n_branch, A, paths)
    terminal/companion sheets; `weights`/`spots` (A,) float32 tensors. The
    control is X = notional·Π(G_i/S_i)^w̃ with value weights w̃ ∝ wᵢSᵢ:
    lognormal, so its expectation is Black-76 in closed form
    (`_geometric_basket_undiscounted`)."""
    w = weights[None, :, None]
    basket = torch.sum(w * s, dim=1)             # (n_branch, paths)
    phi = 1.0 if is_call else -1.0
    pay = combine_antithetic(torch.clamp(phi * (basket - strike), min=0.0))
    if not use_cv:
        return pay, None
    wv = weights * spots
    w_tilde = (wv / torch.sum(wv))[None, :, None]
    notional = torch.sum(wv)
    geo = notional * torch.exp(
        torch.sum(w_tilde * torch.log(torch.clamp(g, min=1e-20)
                                      / spots[None, :, None]), dim=1))
    ctrl_pay = combine_antithetic(torch.clamp(phi * (geo - strike),
                                              min=0.0))
    return pay, ctrl_pay


def _geometric_basket_undiscounted(notional, w_tilde, drifts_T, vol2_T,
                                   strike, is_call):
    """E[max(±(X − K), 0)] for the lognormal geometric basket
    X = notional·exp(Σ w̃ᵢ(driftᵢT + σᵢWᵢ)): Black-76 on its forward.

    drifts_T: per-asset (rᵢ − qᵢ − σᵢ²/2)·T; vol2_T: w̃ᵀ(σσᵀ∘C)w̃·T.
    """
    from scipy.stats import norm

    m = float(np.sum(w_tilde * drifts_T))
    sd = float(np.sqrt(max(vol2_T, 1e-16)))
    fwd = notional * np.exp(m + 0.5 * vol2_T)
    d1 = (np.log(fwd / strike) + 0.5 * vol2_T) / sd
    d2 = d1 - sd
    phi = 1.0 if is_call else -1.0
    return phi * (fwd * norm.cdf(phi * d1) - strike * norm.cdf(phi * d2))


class BasketEngine:
    """European options on a weighted basket of correlated SVJ assets, on
    `device` (default the card). Generators: `seed` for the European
    payoffs, the Bermudan's price and its policy's training set,
    `seed + 1` for the bracket's evaluation set, `seed + 2` for the dual's
    outer and inner paths (the JAX package splits one key three ways).
    mesh: None | "auto" | a `parallel.mesh.Mesh` (`resolve_mesh`); a
    resolved mesh shards `price` (`parallel/families.py:
    sharded_basket_price`); the rainbow, spread and Bermudan payoffs stay
    on one device."""

    def __init__(self, params_list: Sequence[SVJParams], corr,
                 num_paths: int = 200_000, num_steps: int = 64,
                 seed: int = 42, use_control_variate: bool = True,
                 mesh=None, *, device="cuda"):
        self.mesh = mesh
        self.params_list = list(params_list)
        self.corr = np.asarray(corr, np.float64)
        a = len(self.params_list)
        if self.corr.shape != (a, a):
            raise ValueError(f"corr must be ({a},{a}), got {self.corr.shape}")
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_control_variate = bool(use_control_variate)
        self.device = torch.device(device)
        self._batch = _stack_params(self.params_list)
        # Accept PSD-singular correlation (e.g. rho=1 blocks): the float64
        # factor with escalating jitter, then float32.
        self._chol = torch.as_tensor(_cholesky_jittered(self.corr),
                                     dtype=torch.float32, device=self.device)

    def _generator(self, k: int = 0) -> torch.Generator:
        return seeded_generator(self.seed + k, self.device)

    def _draws(self, k: int, steps: int):
        """Replayed (z, u) of path set k for `steps` steps, or None: the
        simulators draw from `_generator(k)`. Tests override it."""
        return None

    def _terminal(self, spots, T, companion: bool):
        steps = scaled_steps(self.num_steps, T)
        s, g = simulate_basket_terminal(
            self._batch, spots, self._chol, T, self._generator(),
            num_paths=self.num_paths, num_steps=steps, antithetic=True,
            companion=companion, draws=self._draws(0, steps),
            device=self.device)
        return s, g, steps

    def price(self, spots: Sequence[float], weights: Sequence[float],
              strike: float, T: float, is_call: bool = True
              ) -> Dict[str, float]:
        """Price max(±(Σ wᵢ S_T,i − K), 0) with a geometric-basket control."""
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu_torch.parallel.families import sharded_basket_price

            return sharded_basket_price(self, spots, weights, strike, T,
                                        self.seed, mesh=mesh,
                                        is_call=is_call)
        spots = np.asarray(spots, np.float64)
        weights = np.asarray(weights, np.float64)
        s, g, steps = self._terminal(spots, T, self.use_control_variate)
        pay, ctrl_pay = basket_payoff_and_control(
            s, g, _f32(np.float32(weights), self.device),
            _f32(np.float32(spots), self.device), strike, is_call,
            self.use_control_variate)
        # Discount at the first asset's rate (the quote currency's; the
        # per-asset rates drive each asset's own carry).
        r_eff = float(self.params_list[0].r)
        discount = float(np.exp(-r_eff * T))
        mean, se = mc_mean_stderr(pay)
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "num_paths_used": self.num_paths,
            "num_steps": steps,
        }
        if self.use_control_variate:
            ctrl_exact = self._geo_ctrl_exact(spots, weights, strike, T,
                                              is_call)
            out = self._cv_adjust(out, pay, ctrl_pay, ctrl_exact, discount)
        return out

    def _geo_ctrl_exact(self, spots, weights, strike, T,
                        is_call: bool) -> float:
        """Closed-form (undiscounted) expectation of the geometric control
        (host float64)."""
        spots = np.asarray(spots, np.float64)
        weights = np.asarray(weights, np.float64)
        wv = weights * spots
        w_tilde = wv / wv.sum()
        sig = np.array([np.sqrt(float(p.v0)) for p in self.params_list])
        r_vec = np.array([float(p.r) for p in self.params_list])
        q_vec = np.array([float(p.q) for p in self.params_list])
        drifts_T = (r_vec - q_vec - 0.5 * sig**2) * T
        vol2_T = float(w_tilde @ (np.outer(sig, sig) * self.corr)
                       @ w_tilde) * T
        return _geometric_basket_undiscounted(
            float(wv.sum()), w_tilde, drifts_T, vol2_T, strike, is_call)

    def _companion_carry_qs(self, r_eff: float):
        """Effective dividend yields that express each companion leg's true
        carry b_i = r_i − q_i under the single quote-currency rate r_eff
        (Stulz/Margrabe take one r; heterogeneous per-asset rates fold into
        q_i' = r_eff − b_i exactly)."""
        return [r_eff - (float(p.r) - float(p.q)) for p in self.params_list]

    def _cv_adjust(self, out, pay, ctrl_pay, ctrl_exact, discount):
        """Optimal-β control-variate adjustment against the control's
        exact undiscounted mean (shared by all payoffs)."""
        out["cv_beta"], adj = _optimal_beta_adjust(pay, ctrl_pay, ctrl_exact,
                                                   1.0)
        mean_cv, se_cv = mc_mean_stderr(adj)
        out["price"] = discount * float(mean_cv)
        out["std_error"] = discount * float(se_cv)
        return out

    def price_american(self, spots: Sequence[float], strike: float,
                       T: float, kind: str = "max", is_call: bool = True,
                       weights: Sequence[float] = None, n_ex: int = 9,
                       steps_per_period: int = 8) -> Dict[str, float]:
        """Bermudan multi-asset option (max/min/basket underlier) by the
        multi-asset LSM (engine/basket_american.py)."""
        from mcos_tpu_torch.engine.basket_american import (
            price_basket_american,
        )

        return price_basket_american(
            self, spots, strike, T, kind=kind, is_call=is_call,
            weights=weights, n_ex=n_ex, steps_per_period=steps_per_period)

    def price_bounds_american(self, spots: Sequence[float], strike: float,
                              T: float, kind: str = "max",
                              is_call: bool = True,
                              weights: Sequence[float] = None,
                              n_ex: int = 9, steps_per_period: int = 1,
                              n_outer: int = 2048,
                              n_inner: int = 64) -> Dict[str, float]:
        """Bracket the multi-asset Bermudan price: out-of-sample LSM lower
        bound + Andersen-Broadie dual upper bound
        (engine/basket_american.py:price_bounds_basket)."""
        from mcos_tpu_torch.engine.basket_american import price_bounds_basket

        return price_bounds_basket(
            self, spots, strike, T, kind=kind, is_call=is_call,
            weights=weights, n_ex=n_ex, steps_per_period=steps_per_period,
            n_outer=n_outer, n_inner=n_inner)

    def price_rainbow(self, spots: Sequence[float], strike: float, T: float,
                      kind: str = "worst_of", is_call: bool = True
                      ) -> Dict[str, float]:
        """Rainbow vanilla on the best/worst performer:
        max(±(extremeᵢ S_T,i − K), 0).

        For two assets with the control variate on, the companion GBM legs'
        rainbow payoff has an exact Stulz (1982) closed form
        (`ops/rainbow.py`). For A > 2 the estimator runs plain antithetic.
        """
        if kind not in ("worst_of", "best_of"):
            raise ValueError(f"kind must be worst_of|best_of, got {kind!r}")
        spots = np.asarray(spots, np.float64)
        use_cv = self.use_control_variate and spots.shape[0] == 2
        s, g, steps = self._terminal(spots, T, use_cv)
        extreme = torch.amin if kind == "worst_of" else torch.amax
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(
            torch.clamp(phi * (extreme(s, dim=1) - strike), min=0.0))
        r_eff = float(self.params_list[0].r)
        discount = float(np.exp(-r_eff * T))
        mean, se = mc_mean_stderr(pay)
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "kind": kind,
            "num_paths_used": self.num_paths,
            "num_steps": steps,
        }
        if use_cv:
            from mcos_tpu_torch.ops.rainbow import rainbow_price

            ctrl_pay = combine_antithetic(
                torch.clamp(phi * (extreme(g, dim=1) - strike), min=0.0))
            q1e, q2e = self._companion_carry_qs(r_eff)
            sig = [float(np.sqrt(float(p.v0))) for p in self.params_list]
            # rainbow_price returns the r_eff-discounted value; the CV runs
            # on undiscounted payoffs.
            ctrl_exact = rainbow_price(
                float(spots[0]), float(spots[1]), float(strike), T, r_eff,
                q1e, q2e, sig[0], sig[1], float(self.corr[0, 1]),
                kind=kind, is_call=is_call) / discount
            out = self._cv_adjust(out, pay, ctrl_pay, ctrl_exact, discount)
        return out

    def price_spread(self, spots: Sequence[float], strike: float, T: float,
                     is_call: bool = True) -> Dict[str, float]:
        """Two-asset spread option max(±(S₁ − S₂ − K), 0).

        Control: the companion legs' EXCHANGE payoff max(G₁ − G₂, 0), whose
        expectation is exact Margrabe (1978); at K = 0 (call) the estimator
        is near exact.
        """
        if len(spots) != 2:
            raise ValueError("spread option needs exactly 2 assets")
        spots = np.asarray(spots, np.float64)
        s, g, steps = self._terminal(spots, T, self.use_control_variate)
        phi = 1.0 if is_call else -1.0
        spread = s[:, 0, :] - s[:, 1, :]
        pay = combine_antithetic(torch.clamp(phi * (spread - strike),
                                             min=0.0))
        r_eff = float(self.params_list[0].r)
        discount = float(np.exp(-r_eff * T))
        mean, se = mc_mean_stderr(pay)
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "num_paths_used": self.num_paths,
            "num_steps": steps,
        }
        if self.use_control_variate:
            from mcos_tpu_torch.ops.rainbow import margrabe_exchange

            ctrl_pay = combine_antithetic(
                torch.clamp(g[:, 0, :] - g[:, 1, :], min=0.0))
            q1e, q2e = self._companion_carry_qs(r_eff)
            sig = [float(np.sqrt(float(p.v0))) for p in self.params_list]
            ctrl_exact = margrabe_exchange(
                float(spots[0]), float(spots[1]), T, q1e, q2e,
                sig[0], sig[1], float(self.corr[0, 1])) / discount
            out = self._cv_adjust(out, pay, ctrl_pay, ctrl_exact, discount)
        return out


def implied_correlation(params_list: Sequence[SVJParams], spots, weights,
                        strike: float, T: float, market_price: float,
                        is_call: bool = True, num_paths: int = 200_000,
                        seed: int = 42, tol: float = 1e-3,
                        max_iter: int = 40, *, device="cuda"
                        ) -> Dict[str, float]:
    """Flat pairwise correlation implied by a basket option quote.

    The dispersion desk's inverse problem: with common random numbers (one
    seed, correlation entering only through the Cholesky mix) the basket
    price is smooth and monotone in the flat rho, so plain bisection on
    [-1/(A-1)+eps, 0.999] converges without Monte Carlo chatter.
    """
    a = len(params_list)
    lo = -1.0 / (a - 1) + 1e-3          # PSD boundary for the flat matrix
    hi = 0.999

    def price_at(rho: float) -> float:
        corr = np.full((a, a), rho)
        np.fill_diagonal(corr, 1.0)
        eng = BasketEngine(params_list, corr, num_paths=num_paths,
                           seed=seed, device=device)
        return eng.price(spots, weights, strike, T, is_call)["price"]

    p_lo, p_hi = price_at(lo), price_at(hi)
    sign = 1.0 if p_hi >= p_lo else -1.0     # calls ↑ in rho, puts too
    if not min(p_lo, p_hi) - tol <= market_price <= max(p_lo, p_hi) + tol:
        raise ValueError(
            f"market price {market_price:.4f} outside the attainable "
            f"range [{min(p_lo, p_hi):.4f}, {max(p_lo, p_hi):.4f}]")
    iters = 0
    for iters in range(1, max_iter + 1):
        mid = 0.5 * (lo + hi)
        p_mid = price_at(mid)
        if abs(p_mid - market_price) < tol:
            break
        if sign * (p_mid - market_price) < 0.0:
            lo = mid
        else:
            hi = mid
    return {
        "implied_correlation": float(0.5 * (lo + hi)),
        "model_price": float(p_mid),
        "market_price": float(market_price),
        "iterations": iters,
    }
