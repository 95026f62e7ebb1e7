"""Multi-asset American/Bermudan options: LSM on the correlated SVJ basket
(counterpart of `mcos_tpu/engine/basket_american.py`).

Bermudan rights on functions of several correlated SVJ assets: the
Broadie-Glasserman max-call (the standard high-dimensional early-exercise
benchmark), min-puts and weighted-basket puts/calls.

Design: the backward induction is `engine/american.py:
lsm_backward_cashflows`, the function the single-asset LSM uses, with its
payoff and basis given as callables on (A, paths) date slices. Two things
are multi-asset:

- the path sheet: `engine/basket.py:simulate_basket_observations` records
  the (dates, assets, paths) correlated-SVJ state at the exercise dates,
  antithetic branches joined on the path axis branch-major (pair i at [i]
  and [paths + i]); cashflows are pair-averaged before the standard error;
- the regression basis: polynomials in the top-two ORDER STATISTICS of
  normalized moneyness plus the basket mean and the normalized payoff
  (13 columns for the policy, 8 powers-only for the dual's value fit),
  symmetric under asset relabeling.

The bracket (`price_bounds_basket`) fits the policy on one path set,
evaluates it on a second (a true lower bound) and builds the Andersen-
Broadie dual on a third, with `n_inner` antithetic one-period transitions
from every outer state at every date. Torch ops throughout: a Python loop
over dates (and, in the dual, over each period's sub-steps), float32
normal equations solved on the device; no kernel of the repo.

Randoms: each program takes a `torch.Generator` or `draws=(z, u)` of its
outer sheet, (steps, 3, A, paths) and (steps, A, paths); the dual also
`inner_draws=(zh, uh)`, (n_ex, steps_per_period, 3, n_inner/2, A,
2·n_outer) and (n_ex, steps_per_period, n_inner/2, A, 2·n_outer): the
inner normals are [zh, −zh] within the inner axis, the uniforms [uh, uh].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mcos_tpu_torch.engine.american import (
    lsm_backward_cashflows,
    solve_normal_equations,
)
from mcos_tpu_torch.engine.basket import (
    _basket_cols,
    _basket_step,
    simulate_basket_observations,
    simulate_basket_states,
)
from mcos_tpu_torch.engine.pricer import to_host
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.simulate import _f32, mc_mean_stderr


def _ma_underlier_fn(kind: str, weights):
    """max / min / weighted-sum over the asset axis (−2, so the same
    function serves (A, paths) date slices AND the dual's nested
    (n_inner, A, paths) blocks)."""
    def under(s):
        if kind == "max":
            return torch.amax(s, dim=-2)
        if kind == "min":
            return torch.amin(s, dim=-2)
        return torch.sum(weights[:, None] * s, dim=-2)
    return under


def _ma_payoff_fn(strike, kind: str, is_call: bool, weights):
    """Payoff on an (..., A, paths) slice → (..., paths)."""
    phi = 1.0 if is_call else -1.0
    under = _ma_underlier_fn(kind, weights)

    def payoff(s):
        return torch.clamp(phi * (under(s) - strike), min=0.0)

    return payoff


def _ma_basis_fn(strike, kind: str, is_call: bool, weights):
    """Order-statistic regression basis on an (A, paths) slice →
    (paths, 13): 1, y1, y1², y1³, y2, y2², y2³, y1·y2, y1²·y2, y1·y2², m,
    payoff/K, payoff/K·y1, with y1 ≥ y2 the two largest normalized
    moneynesses and m the basket mean (relabeling-symmetric, as the
    continuation value is; the payoff regressor keeps the deep-ITM fit
    tight)."""
    payoff = _ma_payoff_fn(strike, kind, is_call, weights)

    def basis(s):
        y = torch.sort(s / strike - 1.0, dim=0, descending=True).values
        y1, y2 = y[0], y[1]
        m = torch.sum(weights[:, None] * s, dim=0) / strike - 1.0
        one = torch.ones_like(y1)
        pay = payoff(s) / strike
        return torch.stack([one, y1, y1 * y1, y1 * y1 * y1,
                            y2, y2 * y2, y2 * y2 * y2,
                            y1 * y2, y1 * y1 * y2, y1 * y2 * y2,
                            m, pay, pay * y1], dim=-1)

    return basis


def _ma_value_basis_fn(strike, weights):
    """Powers-only value basis (no payoff regressor: it is exactly collinear
    with the order statistics on all-ITM slices, harmless for the policy
    decision but fatal for the dual, which evaluates the fit everywhere).
    Works on any (..., A, paths) block (asset axis −2)."""
    def vbasis(s):
        y = torch.sort(s / strike - 1.0, dim=-2, descending=True).values
        y1, y2 = y[..., 0, :], y[..., 1, :]
        m = torch.sum(weights[:, None] * s, dim=-2) / strike - 1.0
        one = torch.ones_like(y1)
        return torch.stack([one, y1, y1 * y1, y1**3, y2, y2 * y2, y1 * y2,
                            m], dim=-1)
    return vbasis


def _prepare(spots, strike, weights, device):
    """(spots, strike, weights) as float32 on `device`; weights default to
    1/A each."""
    spots = _f32(np.asarray(spots, np.float32), device)
    n_assets = spots.shape[0]
    weights = (torch.full((n_assets,), 1.0 / n_assets, dtype=torch.float32,
                          device=device) if weights is None
               else _f32(np.asarray(weights, np.float32), device))
    return spots, _f32(strike, device), weights


def _device_of(draws, device):
    return draws[0].device if draws is not None else torch.device(device)


def _sheet(params_batch, spots, corr_chol, T, generator, *, num_paths,
           n_ex, steps_per_period, draws, device):
    """(n_ex, A, 2·num_paths) spot sheet at the exercise dates, antithetic
    branches joined branch-major on the path axis."""
    levels = simulate_basket_observations(
        params_batch, spots, corr_chol, T, generator, num_paths=num_paths,
        n_obs=n_ex, steps_per_period=steps_per_period, draws=draws,
        device=device)
    n_assets = spots.shape[0]
    return (spots[None, None, :, None] * levels).transpose(1, 2).reshape(
        n_ex, n_assets, 2 * num_paths)


def lsm_basket_price(params_batch: SVJParams, spots, corr_chol, strike, T,
                     r_num, generator: Optional[torch.Generator], *,
                     num_paths: int, n_ex: int, steps_per_period: int,
                     kind: str, is_call: bool, weights=None, draws=None,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Bermudan multi-asset LSM price with rights at t_1..t_{n_ex} (= T).

    `r_num` is the numéraire (quote-currency) rate used for discounting;
    per-asset rates in `params_batch` drive each asset's own carry.
    """
    device = _device_of(draws, device)
    spots, strike, weights = _prepare(spots, strike, weights, device)
    sheet = _sheet(params_batch, spots, corr_chol, T, generator,
                   num_paths=num_paths, n_ex=n_ex,
                   steps_per_period=steps_per_period, draws=draws,
                   device=device)
    payoff = _ma_payoff_fn(strike, kind, is_call, weights)
    basis = _ma_basis_fn(strike, kind, is_call, weights)
    dt_ex = _f32(T, device) / n_ex
    sdf = torch.exp(-_f32(r_num, device) * dt_ex).expand(n_ex)
    allowed = np.ones((n_ex - 1,), bool)
    cf = lsm_backward_cashflows(payoff(sheet[-1]), sheet, sheet, allowed,
                                sdf, payoff, basis)
    # Pair-average the antithetic halves before the standard error (the
    # two branches of one pair are negatively correlated by construction).
    price, se = mc_mean_stderr(0.5 * (cf[:num_paths] + cf[num_paths:]))
    intrinsic = payoff(spots[:, None])[0]
    return {
        "price": torch.maximum(price, intrinsic),
        "std_error": se,
        "mc_continuation": price,
        "intrinsic": intrinsic,
    }


def _check_kind(engine, kind: str, weights, hint: str = "") -> None:
    if kind not in ("max", "min", "basket"):
        raise ValueError("kind must be 'max', 'min', or 'basket'")
    if len(engine.params_list) < 2:
        raise ValueError("multi-asset LSM needs >= 2 assets" + hint)
    if kind == "basket" and weights is None:
        raise ValueError("kind='basket' needs weights")


def price_basket_american(engine, spots, strike: float, T: float, *,
                          kind: str = "max", is_call: bool = True,
                          weights=None, n_ex: int = 9,
                          steps_per_period: int = 8) -> Dict[str, float]:
    """Engine-convention wrapper over `lsm_basket_price`.

    `engine` is a `BasketEngine` (stacked params + jittered Cholesky);
    `kind`: "max" (best-of), "min" (worst-of), or "basket" (needs
    `weights`). `n_ex` exercise rights at t_1..T, `steps_per_period`
    simulation sub-steps between rights (1 is exact under GBM dynamics;
    stochastic vol/jumps need the sub-steps).
    """
    _check_kind(engine, kind, weights,
                " (single-asset: use AmericanEngine)")
    n_ex, spp = int(n_ex), int(steps_per_period)
    res = to_host(lsm_basket_price(
        engine._batch, spots, engine._chol, strike, T,
        float(engine.params_list[0].r), engine._generator(0),
        num_paths=engine.num_paths, n_ex=n_ex, steps_per_period=spp,
        kind=kind, is_call=is_call, weights=weights,
        draws=engine._draws(0, n_ex * spp), device=engine.device))
    out = {k: float(v) for k, v in res.items()}
    out.update(n_exercise=n_ex, steps_per_period=spp,
               num_paths_used=engine.num_paths, kind=kind)
    return out


def lsm_basket_train(params_batch: SVJParams, spots, corr_chol, strike, T,
                     r_num, generator: Optional[torch.Generator], *,
                     num_paths: int, n_ex: int, steps_per_period: int,
                     kind: str, is_call: bool, weights=None, draws=None,
                     device="cuda"):
    """Fit the per-date regressions on a training sheet: {"policy"
    ((n_ex−1, 13) masked stopping-rule fits), "value" ((n_ex−1, 8)
    unmasked continuation-value fits for the dual)}."""
    device = _device_of(draws, device)
    spots, strike, weights = _prepare(spots, strike, weights, device)
    sheet = _sheet(params_batch, spots, corr_chol, T, generator,
                   num_paths=num_paths, n_ex=n_ex,
                   steps_per_period=steps_per_period, draws=draws,
                   device=device)
    payoff = _ma_payoff_fn(strike, kind, is_call, weights)
    basis = _ma_basis_fn(strike, kind, is_call, weights)
    vbasis = _ma_value_basis_fn(strike, weights)
    df = torch.exp(-_f32(r_num, device) * _f32(T, device) / n_ex)
    cf = payoff(sheet[-1])
    coefs = torch.zeros((n_ex - 1, 13), dtype=torch.float32, device=device)
    coefs_v = torch.zeros((n_ex - 1, 8), dtype=torch.float32, device=device)
    for t in range(n_ex - 2, -1, -1):
        s_state = sheet[t]
        cf = cf * df
        pay = payoff(s_state)
        itm = pay > 0.0
        b = basis(s_state)
        bw = b * itm.to(torch.float32)[:, None]
        coefs[t] = solve_normal_equations(b.T @ bw, bw.T @ cf)
        cont = b @ coefs[t]
        bv = vbasis(s_state)
        coefs_v[t] = solve_normal_equations(bv.T @ bv, bv.T @ cf)
        cf = torch.where(itm & (pay > cont), pay, cf)
    return {"policy": coefs, "value": coefs_v}


def _lower_bound_pairs(params_batch: SVJParams, spots, corr_chol, strike, T,
                       r_num, generator: Optional[torch.Generator], coefs,
                       *, num_paths: int, n_ex: int, steps_per_period: int,
                       kind: str, is_call: bool, weights=None, draws=None,
                       device="cuda") -> torch.Tensor:
    """(num_paths,) antithetic-pair values of the FIXED stopping rule on
    fresh paths (the lower-bound estimator's per-pair samples)."""
    device = _device_of(draws, device)
    spots, strike, weights = _prepare(spots, strike, weights, device)
    sheet = _sheet(params_batch, spots, corr_chol, T, generator,
                   num_paths=num_paths, n_ex=n_ex,
                   steps_per_period=steps_per_period, draws=draws,
                   device=device)
    coefs = torch.as_tensor(coefs, dtype=torch.float32, device=device)
    payoff = _ma_payoff_fn(strike, kind, is_call, weights)
    basis = _ma_basis_fn(strike, kind, is_call, weights)
    dt_ex = _f32(T, device) / n_ex
    r_num = _f32(r_num, device)
    n_paths = sheet.shape[-1]
    stopped = torch.zeros((n_paths,), dtype=torch.bool, device=device)
    value = torch.zeros((n_paths,), dtype=torch.float32, device=device)
    for k in range(n_ex - 1):
        pay = payoff(sheet[k])
        cont = basis(sheet[k]) @ coefs[k]
        exercise = (~stopped) & (pay > 0.0) & (pay > cont)
        disc = torch.exp(-r_num * dt_ex * (k + 1.0))
        value = torch.where(exercise, disc * pay, value)
        stopped = stopped | exercise
    disc_T = torch.exp(-r_num * _f32(T, device))
    value = torch.where(stopped, value, disc_T * payoff(sheet[-1]))
    return 0.5 * (value[:num_paths] + value[num_paths:])


def lsm_basket_lower_bound(params_batch: SVJParams, spots, corr_chol,
                           strike, T, r_num,
                           generator: Optional[torch.Generator], coefs, *,
                           num_paths: int, n_ex: int, steps_per_period: int,
                           kind: str, is_call: bool, weights=None,
                           draws=None, device="cuda"
                           ) -> Dict[str, torch.Tensor]:
    """Evaluate the FIXED stopping rule on fresh paths → a true lower
    bound (any measurable rule under-prices the Bermudan)."""
    pair = _lower_bound_pairs(
        params_batch, spots, corr_chol, strike, T, r_num, generator, coefs,
        num_paths=num_paths, n_ex=n_ex, steps_per_period=steps_per_period,
        kind=kind, is_call=is_call, weights=weights, draws=draws,
        device=device)
    price, se = mc_mean_stderr(pair)
    return {"price": price, "std_error": se}


def _dual_pairs(params_batch: SVJParams, spots, corr_chol, strike, T, r_num,
                generator: Optional[torch.Generator], coefs_v, *,
                n_outer: int, n_inner: int, n_ex: int,
                steps_per_period: int, kind: str, is_call: bool,
                weights=None, draws=None, inner_draws=None,
                device="cuda") -> torch.Tensor:
    """Haugh-Kogan / Andersen-Broadie dual upper bound for the multi-asset
    Bermudan: M built from the trained value function V̂_k, conditional
    expectations by antithetic nested one-PERIOD simulations (each inner
    transition runs the same `_basket_step` sub-steps as the outer sheet).
    Returns the (n_outer,) antithetic-pair samples. `generator` draws the
    outer sheet first, then each date's inner blocks."""
    n_inner -= n_inner % 2
    half = n_inner // 2
    device = _device_of(draws, device)
    spots, strike, weights = _prepare(spots, strike, weights, device)
    n_assets = spots.shape[0]
    payoff = _ma_payoff_fn(strike, kind, is_call, weights)
    vbasis = _ma_value_basis_fn(strike, weights)
    under_fn = _ma_underlier_fn(kind, weights)
    cols = _basket_cols(params_batch, device)
    chol = torch.as_tensor(corr_chol, dtype=torch.float32, device=device)
    coefs_v = torch.as_tensor(coefs_v, dtype=torch.float32, device=device)

    levels, v_states = simulate_basket_states(
        params_batch, spots, chol, T, generator, num_paths=n_outer,
        n_obs=n_ex, steps_per_period=steps_per_period, draws=draws,
        device=device)
    P = 2 * n_outer
    s_sheet = (spots[None, None, :, None] * levels).transpose(1, 2) \
        .reshape(n_ex, n_assets, P)
    v_sheet = v_states.transpose(1, 2).reshape(n_ex, n_assets, P)
    s_prev = torch.cat([spots[:, None].expand(n_assets, P)[None],
                        s_sheet[:-1]])
    v_prev = torch.cat([cols["v0"][0].expand(n_assets, P)[None],
                        v_sheet[:-1]])

    dt_ex = _f32(T, device) / n_ex
    dt_sub = dt_ex / steps_per_period
    sqrt_dt = torch.sqrt(dt_sub)
    r_num = _f32(r_num, device)

    def vhat(s, k, coef_k):
        """Time-t_k value estimate; the terminal date is the pure payoff.
        The fit is clamped to the no-arbitrage window (cubic extrapolation
        runs wild where the outer paths wander)."""
        pay = payoff(s)
        if k >= n_ex:
            return pay
        cap = under_fn(s) if is_call else strike
        cont = torch.minimum(torch.clamp(vbasis(s) @ coef_k, min=0.0), cap)
        return torch.maximum(pay, cont)

    def inner_block(k, j):
        if inner_draws is not None:
            return inner_draws[0][k, j], inner_draws[1][k, j]
        return (torch.randn((3, half, n_assets, P), generator=generator,
                            device=device, dtype=torch.float32),
                torch.rand((half, n_assets, P), generator=generator,
                           device=device, dtype=torch.float32))

    def inner_transition(s_k, v_k, k):
        """n_inner antithetic one-period transitions from every outer
        state: (n_inner, A, P) blocks through the shared step."""
        log_s = torch.log(s_k).expand(n_inner, n_assets, P)
        v = v_k.expand(n_inner, n_assets, P)
        for j in range(steps_per_period):
            zh, uh = inner_block(k, j)
            z = torch.cat([zh, -zh], dim=1)
            u = torch.cat([uh, uh], dim=0)
            log_s, v = _basket_step(cols, dt_sub, sqrt_dt, log_s, v,
                                    torch.matmul(chol, z[0]), z[1], z[2], u)
        return torch.exp(log_s)

    coef_rows = torch.cat([coefs_v, torch.zeros(
        (1, coefs_v.shape[1]), dtype=torch.float32, device=device)])
    m = torch.zeros((P,), dtype=torch.float32, device=device)
    best = torch.full((P,), -np.inf, dtype=torch.float32, device=device)
    for k in range(n_ex):
        s_in = inner_transition(s_prev[k], v_prev[k], k)   # (n_inner, A, P)
        e_k = torch.mean(vhat(s_in, k + 1, coef_rows[k]), dim=0)
        disc_next = torch.exp(-r_num * dt_ex * (k + 1.0))
        m = m + disc_next * (vhat(s_sheet[k], k + 1, coef_rows[k]) - e_k)
        best = torch.maximum(best, disc_next * payoff(s_sheet[k]) - m)
    return 0.5 * (best[:n_outer] + best[n_outer:])


def dual_upper_bound_basket(params_batch: SVJParams, spots, corr_chol,
                            strike, T, r_num,
                            generator: Optional[torch.Generator], coefs_v,
                            *, n_outer: int, n_inner: int, n_ex: int,
                            steps_per_period: int, kind: str, is_call: bool,
                            weights=None, draws=None, inner_draws=None,
                            device="cuda") -> Dict[str, torch.Tensor]:
    """Price and standard error over `_dual_pairs` (see its docstring)."""
    pair = _dual_pairs(
        params_batch, spots, corr_chol, strike, T, r_num, generator, coefs_v,
        n_outer=n_outer, n_inner=n_inner, n_ex=n_ex,
        steps_per_period=steps_per_period, kind=kind, is_call=is_call,
        weights=weights, draws=draws, inner_draws=inner_draws,
        device=device)
    price, se = mc_mean_stderr(pair)
    return {"price": price, "std_error": se}


def price_bounds_basket(engine, spots, strike: float, T: float, *,
                        kind: str = "max", is_call: bool = True,
                        weights=None, n_ex: int = 9,
                        steps_per_period: int = 1, n_outer: int = 2048,
                        n_inner: int = 64) -> Dict[str, float]:
    """Bracket the multi-asset Bermudan: out-of-sample LSM lower bound +
    Andersen-Broadie dual upper bound, on three independent path sets
    (the engine's generators seed, seed + 1 and seed + 2).

    On the Broadie-Glasserman 2-asset max-call this bracket contains the
    published [13.892, 13.934] interval.
    """
    _check_kind(engine, kind, weights)
    n_ex, spp = int(n_ex), int(steps_per_period)
    r_num = float(engine.params_list[0].r)
    static = dict(n_ex=n_ex, steps_per_period=spp, kind=kind,
                  is_call=is_call, weights=weights, device=engine.device)
    args = (engine._batch, spots, engine._chol, strike, T, r_num)
    coefs = lsm_basket_train(*args, engine._generator(0),
                             num_paths=engine.num_paths,
                             draws=engine._draws(0, n_ex * spp), **static)
    lo = lsm_basket_lower_bound(*args, engine._generator(1),
                                coefs["policy"], num_paths=engine.num_paths,
                                draws=engine._draws(1, n_ex * spp), **static)
    hi = dual_upper_bound_basket(*args, engine._generator(2), coefs["value"],
                                 n_outer=int(n_outer), n_inner=int(n_inner),
                                 **static)
    spots_t, strike_t, w = _prepare(spots, strike, weights, engine.device)
    intrinsic = _ma_payoff_fn(strike_t, kind, is_call, w)(spots_t[:, None])
    host = to_host({"lo": lo["price"], "lo_se": lo["std_error"],
                    "hi": hi["price"], "hi_se": hi["std_error"],
                    "intrinsic": intrinsic[0]})
    lower = max(float(host["lo"]), float(host["intrinsic"]))
    upper = float(host["hi"])
    return {
        "lower_bound": lower,
        "lower_se": float(host["lo_se"]),
        "upper_bound": upper,
        "upper_se": float(host["hi_se"]),
        "duality_gap": upper - lower,
        "price": 0.5 * (lower + upper),
        "n_exercise": n_ex,
        "n_outer": int(n_outer),
        "n_inner": int(n_inner),
    }
