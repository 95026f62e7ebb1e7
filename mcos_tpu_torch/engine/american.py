"""American option pricing: Longstaff-Schwartz Monte Carlo (counterpart of
`mcos_tpu/engine/american.py`).

Design:
- Paths are recorded once into a (steps, paths) log-spot sheet by the SVJ
  Euler twin (`ops/simulate.py:_svj_step_core`, optionally under a
  per-step θ/ξ/λ table), then the backward induction runs as a reverse
  Python loop over the exercise dates.
- The continuation regression at each exercise date is a masked (ITM-only,
  the classic Longstaff-Schwartz restriction) polynomial least squares in
  normalized moneyness, solved via equilibrated ridge normal equations: a
  (paths × d)ᵀ(paths × d) matmul pair and one d × d `torch.linalg.solve_ex`
  per date, with no host read inside the loop (a singular system gives
  NaN coefficients, and NaN never exercises).
- Greeks are one autograd pass through the stopped-payoff loop with the
  stopping rule held fixed; gamma's two deltas are one backward of the
  summed prices against a (2,) spot leaf.
- No per-path Python anywhere, and no kernel of the repo's own: every step
  is a handful of torch ops on the whole path batch.

Randomness: each program takes a `torch.Generator` or its draws as
`draws=(z, u)`, (steps, 3, paths) normals and (steps, paths) jump
uniforms (the dual also takes its inner draws). `AmericanEngine` seeds its
generators with `seed` (the price, and the policy's training set),
`seed + 1` (the evaluation set of the lower bound and the Greeks) and
`seed + 2` (the dual's outer and inner paths) where the JAX engine splits
one key into `k_train`, `k_eval`, `k_dual`.

Validation oracle: `binomial_american_bs` (CRR tree, host numpy f64) — the
standard American-BS reference; LSM carries a small low bias (suboptimal
exercise) and MC noise, both bounded in tests.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mcos_tpu_torch.config import DEFAULT_NUM_PATHS, scaled_steps
from mcos_tpu_torch.engine.pricer import (resolve_mesh, seeded_generator,
                                          to_host)
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.dividends import DividendSchedule
from mcos_tpu_torch.ops.simulate import (
    _euler_draws,
    _f32,
    _svj_step_core,
    _v0_like,
    mc_mean_stderr,
)
from mcos_tpu_torch.ops.tdsvj import _step_levels

# The regressions are float32 normal equations: no TF32 in their matmuls.
torch.backends.cuda.matmul.allow_tf32 = False


def _as_f32(x, device) -> torch.Tensor:
    """A tensor (an autograd leaf stays as it is) or a float → float32."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x
    return _f32(x, device)


def _dividend_sheets(s_paths: torch.Tensor, div_grid: torch.Tensor,
                     div_kind: str, floor) -> tuple:
    """(dates, ..., paths) no-dividend spots → (s_ex, s_cum) adjusted sheets.

    ``s_ex`` is the tradable ex-dividend spot at each date (drives regression
    state, continuation dynamics and the terminal payoff); ``s_cum`` is the
    cum-dividend spot the holder captures by exercising *just before* the
    drop (s_cum = s_ex + D at ex-dates, = s_ex elsewhere) — the spot the
    early-exercise payoff must use, or the classic exercise-before-ex-date
    premium of an American call vanishes.

    cash: the exact compounded model (ops/dividends.py module docstring):
        s_ex(t_k) = S(t_k)·(1 − Σ_{j<=k} D_j/S(t_j)),  drop of exactly D_j.
    proportional: deterministic cumulative factors Π(1−d).
    Both are floored at a tiny positive level (huge dividends on a crashed
    path can exhaust the spot; the floor keeps payoffs/bases finite).
    """
    d = div_grid.reshape(-1, *([1] * (s_paths.dim() - 1)))
    if div_kind == "proportional":
        cum_ex = torch.exp(torch.cumsum(torch.log1p(-div_grid), 0)
                           ).reshape(d.shape)
        cum_cum = cum_ex / (1.0 - d)  # excludes the date's own drop
        s_ex = s_paths * cum_ex
        s_cum = s_paths * cum_cum
    else:
        a_ex = torch.cumsum(d / s_paths, dim=0)
        s_ex = s_paths * (1.0 - a_ex)
        s_cum = s_ex + d
    return torch.maximum(s_ex, floor), torch.maximum(s_cum, floor)


def _record_log_paths(params: SVJParams, spot, T,
                      generator: Optional[torch.Generator] = None, *,
                      num_paths: Optional[int] = None,
                      num_steps: Optional[int] = None,
                      td_table=None, draws=None,
                      device="cuda") -> torch.Tensor:
    """(num_steps, num_paths) log-spots at t_1..t_n (t_0 = log spot known).

    `td_table` (optional, (3, num_steps) host array: per-step θ/ξ/λ rows
    from ops/tdsvj.step_param_arrays) records the sheet under
    time-dependent dynamics; a constant table reproduces the
    constant-param sheet. `spot`, `T`, and `params.v0`/`params.r` may be
    float32 autograd leaves; an (M,) `spot` gives an (num_steps, M,
    num_paths) sheet on the same paths.
    """
    z, u = _euler_draws(draws, generator, num_paths, num_steps,
                        torch.device(device))
    device = z.device
    num_steps, num_paths = u.shape
    dt = _as_f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    # log(S/S0) carry (see ops/simulate.py on f32 drift quantization);
    # log(spot) is added back to the recorded sheet at the end.
    log_s = torch.zeros((num_paths,), dtype=torch.float32, device=device)
    v = _v0_like(params.v0, log_s)
    levels = (None if td_table is None else
              _step_levels(td_table[0], td_table[1], td_table[2], num_steps))
    rows = []
    for t in range(num_steps):
        p = (params if levels is None else params.replace(
            theta=levels[0][t], xi=levels[1][t], lambda_j=levels[2][t]))
        log_s, v = _svj_step_core(p, dt, sqrt_dt, log_s, v, z[t, 0], z[t, 1],
                                  u[t], z[t, 2])
        rows.append(log_s)
    log_paths = torch.stack(rows)
    log_spot = torch.log(_as_f32(spot, device))
    if log_spot.dim() == 1:
        return log_paths[:, None, :] + log_spot[:, None]
    return log_paths + log_spot


def _exercise_mask(num_steps: int, exercise_every: int) -> np.ndarray:
    """(num_steps-1,) bool: is exercise allowed at date t_k, k = 1..n-1?

    `exercise_every = 1` is the American schedule (every step);
    `exercise_every = m` keeps only dates t_m, t_2m, ... (a Bermudan
    schedule on the simulation grid); `exercise_every = num_steps` leaves
    no early date at all — the European degenerate case, a test oracle.
    Maturity t_n is always an exercise date (handled by the terminal
    payoff), and t_0 is never one (a just-written Bermudan cannot be
    struck same-day; the American engine keeps its intrinsic floor).
    """
    k = np.arange(1, num_steps)
    return (k % int(exercise_every)) == 0


def _sheets(params, spot, strike, T, generator, *, num_paths, num_steps,
            div_grid, div_kind, rate_offsets, td_table, draws, device):
    """(strike, s_ex, s_cum): the recorded sheet, curve-shifted, exponentiated
    and dividend-adjusted (s_ex is s_cum without dividends)."""
    log_paths = _record_log_paths(params, spot, T, generator,
                                  num_paths=num_paths, num_steps=num_steps,
                                  td_table=td_table, draws=draws,
                                  device=device)
    device = log_paths.device
    strike = _f32(strike, device)
    if rate_offsets is not None:
        off = _f32(rate_offsets, device)
        log_paths = log_paths + off.reshape(-1, *([1] * (log_paths.dim()
                                                         - 1)))
    s_paths = torch.exp(log_paths)  # (steps, [M,] paths), t_1..t_n
    if div_grid is not None:
        s_ex, s_cum = _dividend_sheets(s_paths, _f32(div_grid, device),
                                       div_kind, floor=1e-6 * strike)
    else:
        s_ex = s_cum = s_paths
    return strike, s_ex, s_cum


def _step_dfs(params, T, num_steps, rate_step_dfs, device) -> torch.Tensor:
    """Per-step discounts: sdf[m] covers [t_m, t_{m+1}] (constant when
    flat)."""
    if rate_step_dfs is not None:
        return _f32(rate_step_dfs, device)
    dt = _f32(T, device) / num_steps
    return torch.exp(-params.r * dt).expand(num_steps)


def lsm_price(params: SVJParams, spot, strike, T,
              generator: Optional[torch.Generator] = None, *,
              num_paths: Optional[int] = None,
              num_steps: Optional[int] = None, is_call: bool,
              basis_degree: int = 3,
              exercise_every: int = 1,
              div_grid=None,
              div_kind: str = "cash",
              rate_offsets=None,
              rate_step_dfs=None,
              td_table=None, draws=None,
              device="cuda") -> Dict[str, torch.Tensor]:
    """Longstaff-Schwartz American/Bermudan price under SVJ dynamics.

    `td_table` ((3, num_steps) per-step θ/ξ/λ) prices the American under
    time-dependent dynamics (ops/tdsvj.py) — early exercise against a vol
    term structure, e.g. a put across a known calm→stressed transition.

    `rate_offsets`/`rate_step_dfs` ((num_steps,) host-precomputed, see
    ops/curves.py) price off a deterministic rate curve exactly: the sheet
    simulated at the flat rate params.r is shifted by the cumulative drift
    correction, and the backward induction discounts with per-step factors.

    `div_grid` ((num_steps,) per-date discrete dividends snapped onto the
    simulation grid, see DividendSchedule.grid_amounts) prices American
    options on dividend-paying stocks: exercise payoffs read the
    cum-dividend spot, continuation state the ex-dividend spot
    (_dividend_sheets) — the configuration where early exercise of a call
    is actually optimal (just before a large ex-date)."""
    strike, s_ex, s_cum = _sheets(
        params, spot, strike, T, generator, num_paths=num_paths,
        num_steps=num_steps, div_grid=div_grid, div_kind=div_kind,
        rate_offsets=rate_offsets, td_table=td_table, draws=draws,
        device=device)
    device = s_ex.device
    num_steps = s_ex.shape[0]
    payoff = _payoff_fn(strike, is_call)
    basis = _basis_fn(strike, is_call, basis_degree)

    cf_terminal = payoff(s_ex[-1])
    allowed = _exercise_mask(num_steps, exercise_every)
    sdf = _step_dfs(params, T, num_steps, rate_step_dfs, device)

    cf = lsm_backward_cashflows(cf_terminal, s_cum, s_ex, allowed, sdf,
                                payoff, basis)
    price, se = mc_mean_stderr(cf)
    intrinsic = payoff(_f32(spot, device))
    # The t_0 intrinsic floor applies only when t_0-style exercise exists
    # (the American schedule); a Bermudan's first right is t_m.
    floored = torch.maximum(price, intrinsic) if exercise_every == 1 \
        else price
    return {
        "price": floored,
        "std_error": se,
        "mc_continuation": price,
        "intrinsic": intrinsic,
    }


def solve_normal_equations(gram: torch.Tensor, rhs: torch.Tensor, *,
                           ridge: float = 1e-5) -> torch.Tensor:
    """Equilibrated ridge solve of G·coef = rhs (G = XᵀWX, rhs = XᵀW y).

    G' = DGD with D = diag(G)^{-1/2} plus a RELATIVE ridge on the unit
    diagonal: raw polynomial Grams reach condition ~1e9 on wide-dispersion
    path sheets, and f32 normal equations square that. `solve_ex` checks
    nothing on the device (no host sync): a singular system yields
    non-finite coefficients, as the reference's solve does.
    """
    d_eq = torch.rsqrt(torch.clamp(torch.diagonal(gram), min=1e-12))
    gram_eq = gram * d_eq[:, None] * d_eq[None, :] \
        + ridge * torch.eye(gram.shape[0], dtype=gram.dtype,
                            device=gram.device)
    sol, _ = torch.linalg.solve_ex(gram_eq, (d_eq * rhs)[:, None])
    return d_eq * sol[:, 0]


def lsm_backward_cashflows(cf_terminal, s_cum, s_ex, allowed, sdf,
                           payoff, basis, *, ridge: float = 1e-5,
                           pool=None):
    """Backward LSM induction → per-path cashflows discounted to t₀.

    ONE implementation of the continuation-regression algebra. The pooling
    hook receives the stacked ``[gram | rhs]`` moment block: normal
    equations are linear in the per-path outer products, so sum-pooling
    them across devices reproduces EXACTLY the regression a single device
    would fit on the union path set — every device then solves the
    identical (d×d) system and applies the identical stopping rule to its
    local paths. Equilibration is applied AFTER pooling.

    `s_cum`/`s_ex` are the (steps, paths) cum-/ex-dividend sheets for dates
    t_1..t_n (equal when no dividends); `allowed` the (steps−1,) host bool
    schedule; `sdf[m]` discounts [t_m, t_{m+1}]. A date where exercise is
    not allowed only discounts (its regression could not change a
    cashflow).
    """
    dtype = cf_terminal.dtype
    cf = cf_terminal
    # Reverse induction over t_{n-1}..t_1 (terminal step handled by caller).
    for t in range(s_cum.shape[0] - 2, -1, -1):
        cf = cf * sdf[t + 1]  # continuation value discounted to time t
        if not allowed[t]:
            continue
        pay = payoff(s_cum[t])       # cum-dividend: what exercise captures
        itm = pay > 0.0
        w = itm.to(dtype)
        b = basis(s_ex[t])           # ex-dividend: what drives the future
        bw = b * w[:, None]
        block = torch.cat([b.T @ bw, (bw.T @ cf)[:, None]], dim=1)
        if pool is not None:
            block = pool(block)
        coef = solve_normal_equations(block[:, :-1], block[:, -1],
                                      ridge=ridge)
        cont = b @ coef
        exercise = itm & (pay > cont)
        cf = torch.where(exercise, pay, cf)
    return cf * sdf[0]  # discount t_1 → t_0


def _payoff_fn(strike, is_call: bool):
    def payoff(s):
        return torch.clamp(s - strike, min=0.0) if is_call \
            else torch.clamp(strike - s, min=0.0)
    return payoff


def _basis_fn(strike, is_call: bool, basis_degree: int):
    payoff = _payoff_fn(strike, is_call)

    def basis(s):
        # Centered moneyness powers + the normalized payoff itself, stacked
        # on the LAST axis so it broadcasts over any leading batch shape.
        # Raw x^k powers make the f32 Gram ill-conditioned enough to
        # trigger spurious exercise; centering at ATM and adding payoff/K
        # as a regressor keeps the deep-ITM fit tight.
        u = s / strike - 1.0
        cols = [torch.ones_like(u)]
        for d in range(1, basis_degree + 1):
            cols.append(u**d)
        cols.append(payoff(s) / strike)
        return torch.stack(cols, dim=-1)
    return basis


def _value_basis(strike):
    """Well-conditioned basis for the dual's value regression: centered
    moneyness powers only. The policy basis's payoff/K regressor is exactly
    collinear with u on an all-ITM put sample (payoff/K = −u there), which
    leaves the coefficient split arbitrary — harmless for the in-manifold
    policy decision, fatal for the dual, which evaluates the fit everywhere.
    """
    def basis(s):
        u = s / strike - 1.0
        return torch.stack([torch.ones_like(u), u, u**2, u**3], dim=-1)
    return basis


def lsm_train(params: SVJParams, spot, strike, T,
              generator: Optional[torch.Generator] = None, *,
              num_paths: Optional[int] = None,
              num_steps: Optional[int] = None, is_call: bool,
              basis_degree: int = 3,
              exercise_every: int = 1,
              div_grid=None,
              div_kind: str = "cash",
              rate_offsets=None,
              rate_step_dfs=None, draws=None,
              device="cuda") -> Dict[str, torch.Tensor]:
    """Fit the per-date continuation regressions on a training path set.

    Returns {"policy": (num_steps−1, n_basis), "value": (num_steps−1, 4)} —
    row k is the regression for exercise date t_{k+1} (dates t_1..t_{n−1};
    at t_n the value is the payoff). "policy" is the classic ITM-masked
    LSM fit driving the stopping rule; "value" is an *unmasked* fit of the
    continuation value on the powers-only basis, used by the dual bound
    (which needs a sane V̂ on every state the outer paths visit, not just
    ITM ones). Training is separated from evaluation so the stopping rule
    can be applied out of sample (Longstaff-Schwartz 2001 recommend the
    split). Every date is fitted, allowed or not: the dual reads them all.
    """
    strike, s_ex, s_cum = _sheets(
        params, spot, strike, T, generator, num_paths=num_paths,
        num_steps=num_steps, div_grid=div_grid, div_kind=div_kind,
        rate_offsets=rate_offsets, td_table=None, draws=draws, device=device)
    device = s_ex.device
    num_steps = s_ex.shape[0]
    dtype = s_ex.dtype
    payoff = _payoff_fn(strike, is_call)
    basis = _basis_fn(strike, is_call, basis_degree)
    vbasis = _value_basis(strike)
    cf = payoff(s_ex[-1])
    allowed = _exercise_mask(num_steps, exercise_every)
    sdf = _step_dfs(params, T, num_steps, rate_step_dfs, device)

    coefs, coefs_v = [None] * (num_steps - 1), [None] * (num_steps - 1)
    for t in range(num_steps - 2, -1, -1):
        cf = cf * sdf[t + 1]
        pay = payoff(s_cum[t])
        itm = pay > 0.0
        w = itm.to(dtype)
        b = basis(s_ex[t])
        bw = b * w[:, None]
        coef = solve_normal_equations(b.T @ bw, bw.T @ cf)
        cont = b @ coef
        bv = vbasis(s_ex[t])
        coefs_v[t] = solve_normal_equations(bv.T @ bv, bv.T @ cf)
        coefs[t] = coef
        if allowed[t]:
            cf = torch.where(itm & (pay > cont), pay, cf)
    return {"policy": torch.stack(coefs), "value": torch.stack(coefs_v)}


def _lower_bound_values(params: SVJParams, spot, strike, T, generator,
                        coefs, *, num_paths: Optional[int] = None,
                        num_steps: Optional[int] = None, is_call: bool,
                        basis_degree: int = 3,
                        exercise_every: int = 1,
                        div_grid=None,
                        div_kind: str = "cash",
                        rate_offsets=None,
                        rate_cum=None, draws=None,
                        device="cuda") -> torch.Tensor:
    """Per-path discounted payoffs at the FIXED stopping rule.

    Differentiable in (spot, params, T): the stop decision rides through
    boolean `torch.where` selects, so autograd differentiates the
    *realized* branch with the stopping time held fixed — exactly the
    policy-fixed pathwise estimator American Greeks need (the envelope
    theorem makes the ignored ∂policy term second-order at a near-optimal
    policy). An (M,) `spot` gives (M, paths) values on the same paths.
    """
    strike, s_ex, s_cum = _sheets(
        params, spot, strike, T, generator, num_paths=num_paths,
        num_steps=num_steps, div_grid=div_grid, div_kind=div_kind,
        rate_offsets=rate_offsets, td_table=None, draws=draws, device=device)
    device = s_ex.device
    num_steps = s_ex.shape[0]
    payoff = _payoff_fn(strike, is_call)
    basis = _basis_fn(strike, is_call, basis_degree)
    T = _as_f32(T, device)
    dt = T / num_steps

    # Discount to t_{k+1}: flat exp(−r·t) normally; with a curve, the
    # host-precomputed R(t) grid PLUS the parallel component
    # (params.r − R(T)/T)·t — zero at evaluation (the engine sets
    # params.r = r_eff), but it keeps ∂/∂r = −t·P alive so the policy-fixed
    # AD rho is the parallel-shift sensitivity under the curve too.
    t_grid = dt * torch.arange(1, num_steps + 1, dtype=torch.float32,
                               device=device)
    if rate_cum is not None:
        rate_cum = _f32(rate_cum, device)
        r_flat = rate_cum[-1] / T
        cum_disc = torch.exp(-(rate_cum + (params.r - r_flat) * t_grid))
    else:
        cum_disc = torch.exp(-params.r * t_grid)

    allowed = _exercise_mask(num_steps, exercise_every)
    stopped = torch.zeros(s_ex.shape[1:], dtype=torch.bool, device=device)
    value = torch.zeros(s_ex.shape[1:], dtype=s_ex.dtype, device=device)
    for t in range(num_steps - 1):
        if not allowed[t]:
            continue
        pay = payoff(s_cum[t])
        cont = basis(s_ex[t]) @ coefs[t]
        exercise = (~stopped) & (pay > 0.0) & (pay > cont)
        value = torch.where(exercise, cum_disc[t] * pay, value)
        stopped = stopped | exercise
    # Unstopped paths exercise (or expire) at maturity.
    return torch.where(stopped, value, cum_disc[-1] * payoff(s_ex[-1]))


def lsm_lower_bound(params: SVJParams, spot, strike, T,
                    generator: Optional[torch.Generator], coefs, *,
                    num_paths: Optional[int] = None,
                    num_steps: Optional[int] = None, is_call: bool,
                    basis_degree: int = 3,
                    exercise_every: int = 1,
                    div_grid=None,
                    div_kind: str = "cash",
                    rate_offsets=None,
                    rate_cum=None, draws=None,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Evaluate the FIXED stopping rule on fresh paths → a true lower bound.

    Any measurable stopping rule gives E[discounted payoff at stop] ≤ the
    American value; the LSM rule trained on an independent set qualifies.
    Forward pass: stop at the first date where payoff > fitted continuation
    (and ITM); collect the discounted payoff.
    """
    value = _lower_bound_values(params, spot, strike, T, generator, coefs,
                                num_paths=num_paths, num_steps=num_steps,
                                is_call=is_call, basis_degree=basis_degree,
                                exercise_every=exercise_every,
                                div_grid=div_grid, div_kind=div_kind,
                                rate_offsets=rate_offsets,
                                rate_cum=rate_cum, draws=draws,
                                device=device)
    price, se = mc_mean_stderr(value)
    return {"price": price, "std_error": se}


def _leaf(x, device) -> torch.Tensor:
    """A float32 autograd leaf on `device` holding `x`."""
    return torch.tensor(np.asarray(x, np.float32), device=device,
                        requires_grad=True)


def american_greeks_ad(params: SVJParams, spot, strike, T,
                       generator: Optional[torch.Generator], coefs, *,
                       num_paths: Optional[int] = None,
                       num_steps: Optional[int] = None, is_call: bool,
                       basis_degree: int = 3,
                       div_grid=None, div_kind: str = "cash",
                       rate_offsets=None, rate_cum=None, draws=None,
                       device="cuda"):
    """(price, (∂P/∂spot, ∂P/∂v₀, ∂P/∂T, ∂P/∂r)) of the policy-fixed
    American lower-bound estimator — ONE forward+backward pass.

    The regression coefficients are constants here (trained on an
    independent path set), so the gradient is the fixed-stopping-time
    pathwise derivative; at a near-optimal policy the neglected policy
    sensitivity is second-order (envelope theorem). T enters through the
    step size and the discount grid, r through the drift and the discount.
    """
    device = coefs.device
    spot_, v0_ = _leaf(spot, device), _leaf(params.v0, device)
    T_, r_ = _leaf(T, device), _leaf(params.r, device)
    with torch.enable_grad():
        value = _lower_bound_values(
            params.replace(v0=v0_, r=r_), spot_, strike, T_, generator,
            coefs, num_paths=num_paths, num_steps=num_steps,
            is_call=is_call, basis_degree=basis_degree, div_grid=div_grid,
            div_kind=div_kind, rate_offsets=rate_offsets, rate_cum=rate_cum,
            draws=draws, device=device)
        price = torch.mean(value)
        grads = torch.autograd.grad(price, (spot_, v0_, T_, r_))
    return price.detach(), grads


def _american_delta_batch(params: SVJParams, spots, strike, T,
                          generator: Optional[torch.Generator], coefs, *,
                          num_paths: Optional[int] = None,
                          num_steps: Optional[int] = None, is_call: bool,
                          basis_degree: int = 3,
                          div_grid=None, div_kind: str = "cash",
                          rate_offsets=None, rate_cum=None, draws=None,
                          device="cuda") -> torch.Tensor:
    """Policy-fixed AD delta at a batch of spots (CRN: the same draws and
    coefs) — one backward of the summed prices against an (M,) spot leaf:
    the spots share no graph, so entry m is spot m's own delta."""
    device = coefs.device
    spots_ = _leaf(np.asarray(spots, np.float32).reshape(-1), device)
    with torch.enable_grad():
        value = _lower_bound_values(
            params, spots_, strike, T, generator, coefs,
            num_paths=num_paths, num_steps=num_steps, is_call=is_call,
            basis_degree=basis_degree, div_grid=div_grid,
            div_kind=div_kind, rate_offsets=rate_offsets, rate_cum=rate_cum,
            draws=draws, device=device)
        (grad,) = torch.autograd.grad(torch.mean(value, dim=-1).sum(),
                                      spots_)
    return grad


def _dual_inner(draws, generator, k: int, half: int, n_outer: int, device):
    """Step k's antithetic inner draws: (3, n_inner, n_outer) normals
    [zh, −zh] and (n_inner, n_outer) uniforms [uh, uh]."""
    if draws is None:
        zh = torch.randn((3, half, n_outer), generator=generator,
                         device=device, dtype=torch.float32)
        uh = torch.rand((half, n_outer), generator=generator, device=device,
                        dtype=torch.float32)
    else:
        zh, uh = draws[0][k], draws[1][k]
    return torch.cat([zh, -zh], dim=1), torch.cat([uh, uh], dim=0)


def dual_upper_bound(params: SVJParams, spot, strike, T,
                     generator: Optional[torch.Generator], coefs, *,
                     n_outer: int, n_inner: int, num_steps: int,
                     is_call: bool, basis_degree: int = 3, draws=None,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Haugh-Kogan / Andersen-Broadie dual upper bound.

    For ANY martingale M with M₀ = 0,
        American price ≤ E[ max_k ( disc_k·h(S_k) − M_k ) ],
    with equality at the Doob martingale of the value process. M is built
    from the LSM value function V̂_k(s) = max(h(s), ĉ_k(s)):
        M_{k+1} = M_k + Ṽ_{k+1}(S_{k+1}) − Ê_k[Ṽ_{k+1}],
    where Ṽ is discounted to t₀ and the conditional expectation is a
    one-step nested simulation (n_inner fresh transitions from the outer
    state, one (inner × outer) batch a step). Zero-mean inner noise keeps
    M a martingale, so the bound stays valid (just looser) at small
    n_inner.

    Draws: `draws` = ((z, u), (zh, uh)), the outer paths' (num_steps, 3,
    n_outer) normals and (num_steps, n_outer) uniforms, and the inner
    halves (num_steps, 3, n_inner//2, n_outer) and (num_steps, n_inner//2,
    n_outer); else `generator` draws the outer set up front, then each
    step's inner halves in the loop.
    """
    # Antithetic inner draws are [half, −half]: an odd n_inner rounds down
    # to even (schemas allow any 16..2048).
    n_inner -= n_inner % 2
    half = n_inner // 2
    z, u = _euler_draws(None if draws is None else draws[0], generator,
                        n_outer, num_steps, torch.device(device))
    device = z.device
    strike = _f32(strike, device)
    spot = _f32(spot, device)
    dt = _f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    payoff = _payoff_fn(strike, is_call)
    vbasis = _value_basis(strike)

    # Outer paths: record (log S, v) at every date (v is needed to branch
    # the inner transitions off the true state), t_0 state first.
    log_s = torch.zeros((n_outer,), dtype=torch.float32, device=device)
    v = _v0_like(params.v0, log_s)
    log_path, v_path = [log_s], [v]
    for t in range(num_steps):
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v, z[t, 0],
                                  z[t, 1], u[t], z[t, 2])
        log_path.append(log_s)
        v_path.append(v)
    log_path = torch.stack(log_path) + torch.log(spot)

    def vhat(s, k, coef_k):
        """Time-t_k value estimate in t_k money (k = 1..num_steps).

        Continuation fit clamped to the no-arbitrage window [0, K] (put) /
        [0, S] (call) — the cubic extrapolates wildly outside the training
        cloud, and the dual evaluates it wherever the paths wander. At the
        terminal date the value IS the payoff.
        """
        pay = payoff(s)
        if k >= num_steps:
            return pay
        cap = s if is_call else strike
        cont = torch.minimum(torch.clamp(vbasis(s) @ coef_k, min=0.0), cap)
        return torch.maximum(pay, cont)

    # Walk k = 0..num_steps-1, accumulating M and the running max of
    # (disc_k·h_k − M_k). M_0 = 0; date-0 candidate is the intrinsic.
    m = torch.zeros((n_outer,), dtype=torch.float32, device=device)
    best = payoff(spot.expand(n_outer))
    inner_draws = None if draws is None else draws[1]
    for k in range(num_steps):
        coef_next = coefs[k] if k < num_steps - 1 else None
        s_next = torch.exp(log_path[k + 1])
        # Ê_k[Ṽ_{k+1}]: n_inner fresh one-step transitions from (s_k, v_k),
        # antithetic-paired (±z halves the estimator noise that directly
        # loosens the bound).
        zi, ui = _dual_inner(inner_draws, generator, k, half, n_outer,
                             device)
        log_si, _ = _svj_step_core(
            params, dt, sqrt_dt, log_path[k].expand(n_inner, n_outer),
            v_path[k].expand(n_inner, n_outer), zi[0], zi[1], ui, zi[2])
        e_k = torch.mean(vhat(torch.exp(log_si), k + 1, coef_next), dim=0)
        disc_next = torch.exp(-params.r * dt * (k + 1.0))
        m = m + disc_next * (vhat(s_next, k + 1, coef_next) - e_k)
        best = torch.maximum(best, disc_next * payoff(s_next) - m)
    price, se = mc_mean_stderr(best)
    return {"price": price, "std_error": se}


class AmericanEngine:
    """LSM American pricer with the framework's engine conventions, on
    `device` (default the card). Generators: `seed` for the price and the
    policy's training set, `seed + 1` for the evaluation set, `seed + 2`
    for the dual's paths."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 64, seed: int = 42, basis_degree: int = 3,
                 dividends: "DividendSchedule" = None,
                 rate_curve=None, mesh=None, device="cuda"):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.basis_degree = int(basis_degree)
        # Discrete dividends (ops/dividends.py): cash uses the exact
        # compounded-cash path model, proportional the exact factor model.
        # The continuous yield q should then hold only the non-discrete
        # remainder (double counting is the caller's to avoid).
        self.dividends = dividends
        # Deterministic rate term structure (ops/curves.RateCurve): paths
        # simulate at the flat-equivalent rate and the sheets/discounts are
        # corrected exactly (see lsm_price docstring). params.r is ignored
        # when a curve is set.
        self.rate_curve = rate_curve
        # None | "auto" | Mesh: price() routes through the distributed LSM
        # (parallel/mesh.py:sharded_american_price, pooled normal
        # equations) when a mesh resolves and neither dividends nor a rate
        # curve is set; greeks() and price_bounds() stay on one device.
        # None honours MCOS_AUTO_MESH=1.
        self.mesh = mesh
        self.device = torch.device(device)

    def _draws(self, k: int, steps: int):
        """(z, u) of generator `seed + k` for a sheet of `steps` steps."""
        gen = seeded_generator(self.seed + k, self.device)
        return _euler_draws(None, gen, self.num_paths, steps, self.device)

    def _params_T(self, T: float) -> SVJParams:
        if self.rate_curve is None:
            return self.params
        return self.params.replace(r=self.rate_curve.r_eff(float(T)))

    def _rate_args(self, T: float, steps: int, for_lb: bool = False) -> Dict:
        """lsm kwargs for the curve vectors (empty when flat)."""
        if self.rate_curve is None:
            return {}
        r_flat = self.rate_curve.r_eff(float(T))
        off = self.rate_curve.grid_log_offsets(float(T), steps, r_flat)
        if for_lb:
            return {"rate_offsets": off,
                    "rate_cum": self.rate_curve.grid_integrals(float(T),
                                                               steps)}
        return {"rate_offsets": off,
                "rate_step_dfs": self.rate_curve.grid_step_dfs(float(T),
                                                               steps)}

    def _div_args(self, T: float, steps: int) -> Dict:
        """kwargs for the dividend-adjusted path sheets (or empty)."""
        if self.dividends is None:
            return {}
        grid = self.dividends.grid_amounts(T, steps)
        if grid is None:
            return {}
        return {"div_grid": grid, "div_kind": self.dividends.kind}

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True,
              exercise_every: int = 1) -> Dict[str, float]:
        """American price; `exercise_every = m > 1` restricts exercise to
        every m-th simulation date — a Bermudan schedule (e.g. with the
        default 64 steps/yr, `exercise_every=16` ≈ quarterly rights).
        `exercise_every >= num_steps` degenerates to European (the test
        oracle)."""
        steps = scaled_steps(self.num_steps, T, floor=16)
        every = min(int(exercise_every), steps)
        mesh = (resolve_mesh(self.mesh) if self.dividends is None
                and self.rate_curve is None else None)
        if mesh is not None:
            from mcos_tpu_torch.parallel.mesh import sharded_american_price

            out = sharded_american_price(
                self.params, spot, strike, T, self.seed, mesh=mesh,
                num_paths=self.num_paths, num_steps=steps, is_call=is_call,
                basis_degree=self.basis_degree, exercise_every=every)
            out["num_steps"] = steps
            if exercise_every != 1:
                out["exercise_every"] = every
            return out
        res = to_host(lsm_price(
            self._params_T(T), spot, strike, T, exercise_every=every,
            is_call=is_call, basis_degree=self.basis_degree,
            draws=self._draws(0, steps),
            **self._div_args(T, steps), **self._rate_args(T, steps)))
        out = {k: float(v) for k, v in res.items()}
        out["num_paths_used"] = self.num_paths
        out["num_steps"] = steps
        if exercise_every != 1:
            out["exercise_every"] = every
        return out

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True, spot_bump: float = 0.01
               ) -> Dict[str, float]:
        """American Greeks: policy-fixed pathwise AD (see american_greeks_ad).

        delta/vega/theta/rho from ONE backward pass through the stopped-
        payoff loop; gamma = central CRN-FD of the AD delta. Early exercise
        shows up where it must: a deep-ITM American put's delta → −1 and
        theta → −rK side, which no European estimator reproduces.

        Key conventions mirror GreeksEngine.all_greeks (vega_per_vol_point
        = 2σ·∂P/∂v₀; the reference's theta_daily label holds the annualized
        rate).
        """
        steps = scaled_steps(self.num_steps, T, floor=16)
        params_T = self._params_T(T)
        base = dict(is_call=is_call, basis_degree=self.basis_degree,
                    **self._div_args(T, steps))
        coefs = lsm_train(params_T, spot, strike, T,
                          draws=self._draws(0, steps), **base,
                          **self._rate_args(T, steps))["policy"]
        kwargs = {**base, **self._rate_args(T, steps, for_lb=True),
                  "draws": self._draws(1, steps)}
        price, (d_s, d_v, d_T, d_r) = american_greeks_ad(
            params_T, spot, strike, T, None, coefs, **kwargs)
        s_up, s_dn = spot * (1 + spot_bump), spot * (1 - spot_bump)
        deltas = _american_delta_batch(params_T, [s_up, s_dn], strike, T,
                                       None, coefs, **kwargs)
        host = to_host({"price": price, "d_s": d_s, "d_v": d_v, "d_T": d_T,
                        "d_r": d_r, "deltas": deltas})
        deltas = host["deltas"]
        sigma = float(np.sqrt(float(self.params.v0)))
        theta_val = -float(host["d_T"])
        return {
            "price": float(host["price"]),
            "delta": float(host["d_s"]),
            "gamma": float((deltas[0] - deltas[1]) / (s_up - s_dn)),
            "ad_vega_v0": float(host["d_v"]),
            "vega_per_vol_point": float(host["d_v"]) * 2 * sigma,
            "theta_daily": theta_val,
            "theta_annual": theta_val * 252,
            "rho": float(host["d_r"]),
            "num_steps": steps,
        }

    def price_bounds(self, spot: float, strike: float, T: float,
                     is_call: bool = True, n_outer: int = 2048,
                     n_inner: int = 128) -> Dict[str, float]:
        """Bracket the American price: out-of-sample LSM lower bound +
        Haugh-Kogan/Andersen-Broadie dual upper bound, with the duality gap.

        Three independent path sets: policy training, lower-bound
        evaluation, and the dual's outer/inner simulation — so the lower
        bound is free of foresight bias and the bracket is honest.
        """
        steps = scaled_steps(self.num_steps, T, floor=16)
        if self.rate_curve is not None:
            raise ValueError(
                "price_bounds does not support rate curves; use price()/"
                "greeks() (exact curve-corrected LSM) instead")
        if self._div_args(T, steps):
            # The dual bound's nested one-step inner simulations would need
            # dividend-aware restarts at every (date, state); not wired yet.
            # Fail loudly instead of returning a silently-wrong bracket.
            raise ValueError(
                "price_bounds does not support discrete dividends; use "
                "price()/greeks() (exact compounded-cash LSM) instead")
        kwargs = dict(is_call=is_call, basis_degree=self.basis_degree)
        coefs = lsm_train(self.params, spot, strike, T,
                          draws=self._draws(0, steps), **kwargs)
        lo = lsm_lower_bound(self.params, spot, strike, T, None,
                             coefs["policy"], draws=self._draws(1, steps),
                             **kwargs)
        hi = dual_upper_bound(
            self.params, spot, strike, T,
            seeded_generator(self.seed + 2, self.device), coefs["value"],
            n_outer=n_outer, n_inner=n_inner, num_steps=steps,
            device=self.device, **kwargs)
        host = to_host({"lo": lo["price"], "lo_se": lo["std_error"],
                        "hi": hi["price"], "hi_se": hi["std_error"]})
        intrinsic = max(spot - strike, 0.0) if is_call \
            else max(strike - spot, 0.0)
        lower = max(float(host["lo"]), intrinsic)
        upper = float(host["hi"])
        return {
            "lower_bound": lower,
            "lower_se": float(host["lo_se"]),
            "upper_bound": upper,
            "upper_se": float(host["hi_se"]),
            "duality_gap": upper - lower,
            "price": 0.5 * (lower + upper),
            "num_steps": steps,
            "n_outer": n_outer,
            "n_inner": n_inner,
        }


def binomial_american_bs(S: float, K: float, T: float, r: float, q: float,
                         sigma: float, steps: int = 1000,
                         is_call: bool = True) -> float:
    """CRR binomial American price under Black-Scholes (host f64 oracle)."""
    dt = T / steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-r * dt)
    p = (np.exp((r - q) * dt) - d) / (u - d)
    if not (0.0 < p < 1.0):
        raise ValueError("unstable tree: reduce dt or vol")

    j = np.arange(steps + 1)
    prices = S * u ** (steps - j) * d ** j
    values = np.maximum(prices - K, 0.0) if is_call \
        else np.maximum(K - prices, 0.0)
    for n in range(steps - 1, -1, -1):
        j = np.arange(n + 1)
        prices = S * u ** (n - j) * d ** j
        values = disc * (p * values[:-1] + (1 - p) * values[1:])
        intrinsic = np.maximum(prices - K, 0.0) if is_call \
            else np.maximum(K - prices, 0.0)
        values = np.maximum(values, intrinsic)
    return float(values[0])


def american_cos_oracle(params: SVJParams, spot: float, strike: float,
                        T: float, is_call: bool = True) -> Dict:
    """Exact COS American under the Levy projection of `params`.

    Projection = Merton jump-diffusion with sigma = sqrt(v0) plus the SVJ
    jump leg — EXACT when xi = 0 and theta = v0 (frozen variance), the
    same desk convention as the CN exercise boundary's BS proxy
    (api/server.py handle_american with_boundary). Fourier-cosine backward
    induction + Richardson over the date ladder (ops/cos_bermudan.py):
    no paths, no regression — the oracle the LSM bounds are pinned to
    under jump dynamics."""
    from mcos_tpu_torch.ops.cos_bermudan import american_cos, merton_model

    m = merton_model(float(params.v0) ** 0.5, float(params.lambda_j),
                     float(params.mu_j), float(params.sigma_j),
                     float(params.r), float(params.q))
    out = american_cos(m, spot, strike, T, is_call=is_call)
    out["note"] = ("exact COS American under the Merton projection "
                   "sigma=sqrt(v0) + the SVJ jump leg; exact when xi=0 "
                   "and theta=v0, a proxy otherwise (like with_boundary)")
    return out
