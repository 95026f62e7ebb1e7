"""Mesh-sharded drivers for every moment-pooled model family
(counterpart of `mcos_tpu/parallel/families.py`, slice N1).

Each driver is a payoff function over `parallel/mesh.py:sharded_moments`:
the shards, their seeds and their pooling live there once. A payoff
function receives its `Shard` and runs the program the family's unsharded
engine runs, and reads its payoffs through that engine's own payoff
function. The three families with a kernel (K8 SVCJ, K7 Heston-Hull-White,
K9 time-dependent SVJ) take `backend`: "cuda" runs the kernel (its plain
version on a CPU shard), "torch" the step-loop twin. The others have one
program, the torch one, and no `backend`. Every driver takes
`shard_draws=`, a callable from the shard index to the draws its twin
replays (tests); without it each shard draws from its own generator.
Families covered: SVCJ, Lévy (VG + NIG), lifted rough Heston, Dupire
local vol, cliquet, quanto, worst-of autocallable notes, variance swaps,
rough Bergomi (the exact sampler), Heston-Hull-White, SLV particles,
time-dependent SVJ and multi-asset SVJ baskets. Each driver reproduces
on the pooled union sample the single-device estimator cited at its
payoff function.

The SLV is the one driver whose shards meet inside the step loop: its
leverage needs the bin statistics of the whole particle cloud, so its
shards run in lockstep (`mesh.run_lockstep`) and pool each step's
(n_bins + 2)-word vector through `mesh.pool_shards`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mcos_tpu_torch.engine.pricer import _companion_pairs
from mcos_tpu_torch.models.params import SVCJParams, SVJParams
from mcos_tpu_torch.ops import cuda_kernels
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.simulate import _pair_payoffs
from mcos_tpu_torch.parallel.mesh import (
    Mesh,
    Shard,
    _guards,
    _kernel_shard,
    beta_one_payoffs,
    mesh_shards,
    pool_moments,
    pool_shards,
    run_lockstep,
    shard_moments,
    sharded_moments,
)

Draws = Optional[Callable[[int], Any]]


def _ppd(mesh: Mesh, num_paths: int, axis_name: str) -> int:
    return -(-int(num_paths) // mesh.shape[axis_name])


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _strikes(strikes, device) -> torch.Tensor:
    return torch.atleast_1d(_f32(np.asarray(strikes, np.float32), device))


def _discount(r, T, device) -> torch.Tensor:
    return torch.exp(-_f32(r, device) * _f32(T, device))


def _companion_eff(params, spot, strikes, T, s, v, g, is_call: bool):
    """One shard's (K, paths) effective payoffs of `engine/svcj.py:
    _svcj_price_core` and `engine/roughheston.py:_rh_price_core`: their
    own `pricer._companion_pairs`, with the guards' diagnostics."""
    eff, _, _ = _companion_pairs(params, spot, _strikes(strikes, s.device),
                                 T, s, g, is_call)
    return eff.T, None, _guards(s, v)


# ─────────────────────────────────────────────────────────────────────────────
# SVCJ (correlated price/variance jumps)
# ─────────────────────────────────────────────────────────────────────────────
def _svcj_local_payoffs(shard: Shard, params: SVCJParams, spot, strikes, T,
                        *, ppd, num_steps, is_call):
    """One shard of `engine/svcj.py:_svcj_price_core`: K8 (or the twin)."""
    from mcos_tpu_torch.ops.svcj import svcj_terminal

    kw = dict(num_paths=ppd, num_steps=num_steps, antithetic=True,
              companion=True, device=shard.device)
    if _kernel_shard(shard):
        s, v, g = cuda_kernels.svcj_terminal(params, spot, T, shard.seed,
                                             **kw)
    else:
        s, v, g = svcj_terminal(params, spot, T, shard.generator(),
                                draws=shard.draws, **kw)
    return _companion_eff(params, spot, strikes, T, s, v, g, is_call)


def sharded_svcj_price(params: SVCJParams, spot, strikes, T, seed: int, *,
                       mesh: Mesh, num_paths: int, num_steps: int,
                       is_call: bool = True, axis_name: str = "paths",
                       backend: str = "cuda",
                       shard_draws: Draws = None) -> Dict[str, torch.Tensor]:
    """Mesh-sharded SVCJ pricing (pooled CV-effective moments)."""
    stats = sharded_moments(
        _svcj_local_payoffs, seed, (params, spot, strikes, T), mesh=mesh,
        axis_name=axis_name, backend=backend, shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps), ("is_call", is_call)))
    out = pool_moments(stats, _discount(params.r, T, stats["n"].device))
    out["frac_nonfinite"] = stats["nonfinite"] / (2.0 * stats["n"])
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Lévy: variance gamma + normal inverse Gaussian (exact terminal samplers)
# ─────────────────────────────────────────────────────────────────────────────
def _levy_local_payoffs(shard: Shard, p, spot, strikes, T, *, ppd, is_call):
    """One shard of `ops/levy.py:vg_price_mc` / `nig_price_mc`."""
    from mcos_tpu_torch.ops.levy import VGParams, nig_terminal, vg_terminal

    sampler = vg_terminal if isinstance(p, VGParams) else nig_terminal
    s = sampler(p, spot, T, shard.generator(), num_paths=ppd,
                draws=shard.draws, device=shard.device)        # (2, ppd)
    return _pair_payoffs(s, _strikes(strikes, s.device), is_call).T


def sharded_levy_price(p, spot, strikes, T, seed: int, *, mesh: Mesh,
                       num_paths: int, is_call: bool = True,
                       axis_name: str = "paths", shard_draws: Draws = None
                       ) -> Dict[str, torch.Tensor]:
    """Mesh-sharded Lévy pricing; the model is inferred from the params
    type (VGParams / NIGParams: single-shot exact samplers, so only the
    path axis scales)."""
    from mcos_tpu_torch.ops.levy import NIGParams, VGParams

    if not isinstance(p, (VGParams, NIGParams)):
        raise TypeError(f"unsupported Lévy params: {type(p).__name__}")
    stats = sharded_moments(
        _levy_local_payoffs, seed, (p, spot, strikes, T), mesh=mesh,
        axis_name=axis_name, shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("is_call", is_call)))
    return pool_moments(stats, _discount(p.r, T, stats["n"].device))


# ─────────────────────────────────────────────────────────────────────────────
# Lifted rough Heston (multi-factor Markovian lift MC)
# ─────────────────────────────────────────────────────────────────────────────
def _rheston_local_payoffs(shard: Shard, params, spot, strikes, T, c, x, *,
                           ppd, num_steps, is_call):
    """One shard of `engine/roughheston.py:_rh_price_core` (the lifted
    torch loop; `draws` (steps, 2, paths) normals)."""
    from mcos_tpu_torch.ops.roughheston import lifted_terminal

    s, v, g = lifted_terminal(params, spot, T, shard.generator(), c, x,
                              num_paths=ppd, num_steps=num_steps,
                              antithetic=True, companion=True,
                              draws=shard.draws, device=shard.device)
    return _companion_eff(params, spot, strikes, T, s, v, g, is_call)


def sharded_roughheston_price(params, spot, strikes, T, seed: int, *,
                              mesh: Mesh, num_paths: int, num_steps: int,
                              n_factors: int = 24, axis_name: str = "paths",
                              is_call: bool = True, shard_draws: Draws = None
                              ) -> Dict[str, torch.Tensor]:
    """Mesh-sharded lifted rough-Heston MC (the kernel nodes are host
    constants; the factor loop's paths are what scale)."""
    from mcos_tpu_torch.engine.roughheston import _nodes

    c, x = _nodes(params, float(T), n_factors)
    stats = sharded_moments(
        _rheston_local_payoffs, seed, (params, spot, strikes, T, c, x),
        mesh=mesh, axis_name=axis_name,
        shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps), ("is_call", is_call)))
    out = pool_moments(stats, _discount(params.r, T, stats["n"].device))
    out["frac_nonfinite"] = stats["nonfinite"] / (2.0 * stats["n"])
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Dupire local vol
# ─────────────────────────────────────────────────────────────────────────────
def _localvol_local_payoffs(shard: Shard, var_rows, t_mid, y0, dy, spot,
                            strikes, T, r, q, *, ppd, num_steps, is_call):
    """One shard of `engine/localvol.py:LocalVolEngine.price_batch`
    (antithetic pairs collapsed, no CV; `draws` (steps, paths) normals)."""
    from mcos_tpu_torch.engine.localvol import simulate_terminal_localvol

    s = simulate_terminal_localvol(
        var_rows, t_mid, y0, dy, spot, r, q, T, shard.generator(),
        num_paths=ppd, num_steps=num_steps, normals=shard.draws,
        device=shard.device)                                 # (2, ppd)
    return _pair_payoffs(s, _strikes(strikes, s.device), is_call).T


def sharded_localvol_price(surface, spot, strikes, T, seed: int, *,
                           mesh: Mesh, num_paths: int, num_steps: int,
                           is_call: bool = True, axis_name: str = "paths",
                           shard_draws: Draws = None
                           ) -> Dict[str, torch.Tensor]:
    """Mesh-sharded Dupire local-vol pricing. `surface` is a
    `LocalVolSurface`; its per-step variance tables are host constants
    and the path loop shards."""
    rows, t_mid = surface.step_tables(float(T), num_steps)
    stats = sharded_moments(
        _localvol_local_payoffs, seed,
        (rows, t_mid, float(surface.y_grid[0]),
         float(surface.y_grid[1] - surface.y_grid[0]), spot, strikes, T,
         surface.r, surface.q),
        mesh=mesh, axis_name=axis_name,
        shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps), ("is_call", is_call)))
    return pool_moments(stats, _discount(surface.r, T, stats["n"].device))


# ─────────────────────────────────────────────────────────────────────────────
# Cliquet (clipped-sum of period returns, optimal-β exact companion CV)
# ─────────────────────────────────────────────────────────────────────────────
def _cliquet_local_payoffs(shard: Shard, params, T, *, ppd, n_periods,
                           steps_per_period, local_floor, local_cap,
                           global_floor, global_cap, notional,
                           control_variate):
    """(pay, ctrl) of one shard: `engine/cliquet.py:price_cliquet`'s own
    `_cliquet_legs`."""
    from mcos_tpu_torch.engine.cliquet import (_cliquet_legs,
                                               simulate_period_log_returns)

    dlog_s, dlog_g = simulate_period_log_returns(
        params, T, shard.generator(), num_paths=ppd, n_periods=n_periods,
        steps_per_period=steps_per_period, companion=control_variate,
        draws=shard.draws, device=shard.device)
    pay, ctrl = _cliquet_legs(dlog_s, dlog_g, local_floor, local_cap,
                              global_floor, global_cap, notional,
                              control_variate)
    return pay, ctrl, {}


def sharded_cliquet_price(params: SVJParams, T, seed: int, *, mesh: Mesh,
                          num_paths: int, n_periods: int = 4,
                          steps_per_period: int = 16,
                          local_floor: float = 0.0,
                          local_cap: float = 0.08,
                          global_floor: float = 0.0,
                          global_cap: float = float("inf"),
                          notional: float = 1.0,
                          control_variate: bool = True,
                          axis_name: str = "paths",
                          shard_draws: Draws = None
                          ) -> Dict[str, torch.Tensor]:
    """Mesh-sharded cliquet pricing with the pooled optimal-β CV."""
    from mcos_tpu_torch.engine.cliquet import cliquet_bs

    stats = sharded_moments(
        _cliquet_local_payoffs, seed, (params, T), mesh=mesh,
        axis_name=axis_name, shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("n_periods", n_periods),
                 ("steps_per_period", steps_per_period),
                 ("local_floor", float(local_floor)),
                 ("local_cap", float(local_cap)),
                 ("global_floor", float(global_floor)),
                 ("global_cap", float(global_cap)),
                 ("notional", float(notional)),
                 ("control_variate", control_variate)))
    discount = float(np.exp(-float(params.r) * float(T)))
    ctrl_exact = None
    if control_variate:
        ctrl_exact = cliquet_bs(
            float(T), n_periods, float(params.r), float(params.q),
            float(np.sqrt(float(params.v0))), float(local_floor),
            float(local_cap), float(notional)) / discount
    return pool_moments(stats, discount, ctrl_exact=ctrl_exact)


# ─────────────────────────────────────────────────────────────────────────────
# Quanto (domestic-measure SVJ with FX drift tilt)
# ─────────────────────────────────────────────────────────────────────────────
def _quanto_local_payoffs(shard: Shard, params, spot, strike, T, r_d,
                          sigma_fx, rho_fx, *, ppd, num_steps, is_call,
                          control_variate):
    """(pay, ctrl) of one shard: `engine/quanto.py:QuantoEngine.price`'s
    estimator (the companion's exact expectation is the quanto-BS)."""
    from mcos_tpu_torch.engine.quanto import _quanto_payoffs, _quanto_terminal

    s, g = _quanto_terminal(params, spot, T, r_d, sigma_fx, rho_fx,
                            shard.generator(), num_paths=ppd,
                            num_steps=num_steps, draws=shard.draws,
                            device=shard.device)
    pay, ctrl = _quanto_payoffs(s, g, strike, is_call, control_variate)
    return pay, ctrl, {}


def sharded_quanto_price(params: SVJParams, r_domestic: float,
                         sigma_fx: float, rho_fx: float, spot, strike, T,
                         seed: int, *, mesh: Mesh, num_paths: int,
                         num_steps: int, is_call: bool = True,
                         control_variate: bool = True, fx_fixed: float = 1.0,
                         axis_name: str = "paths", shard_draws: Draws = None
                         ) -> Dict[str, torch.Tensor]:
    """Mesh-sharded quanto vanilla with the pooled optimal-β CV."""
    from mcos_tpu_torch.engine.quanto import quanto_bs

    stats = sharded_moments(
        _quanto_local_payoffs, seed,
        (params, spot, strike, T, r_domestic, sigma_fx, rho_fx), mesh=mesh,
        axis_name=axis_name, shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps), ("is_call", is_call),
                 ("control_variate", control_variate)))
    disc = float(np.exp(-float(r_domestic) * float(T)))
    ctrl_exact = None
    if control_variate:
        ctrl_exact = quanto_bs(
            float(spot), float(strike), float(T), float(r_domestic),
            float(params.r), float(params.q),
            float(np.sqrt(float(params.v0))), float(sigma_fx),
            float(rho_fx), is_call) / disc
    out = pool_moments(stats, disc, ctrl_exact=ctrl_exact)
    out["price"] = out["price"] * fx_fixed
    out["std_error"] = out["std_error"] * fx_fixed
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Worst-of autocallable note
# ─────────────────────────────────────────────────────────────────────────────
def _worstof_note_payoffs(shard: Shard, batch, chol, T, r, *, ppd, n_assets,
                          n_obs, steps_per_period, autocall_barrier,
                          coupon_barrier, protection_barrier, coupon,
                          final_coupon, notional):
    """One shard's discounted note values on the worst performer: the
    payoff algebra is `engine/autocallable.py:_note_path_values` itself,
    with the redemption accounting as pooled counts over the 2·n branch
    paths (`_note_value`'s one-hot means, exactly)."""
    from mcos_tpu_torch.engine.autocallable import _note_path_values
    from mcos_tpu_torch.engine.basket import simulate_basket_observations

    levels = simulate_basket_observations(
        batch, np.ones((n_assets,), np.float32), chol, T, shard.generator(),
        num_paths=ppd, n_obs=n_obs, steps_per_period=steps_per_period,
        draws=shard.draws, device=shard.device)
    worst = torch.amin(levels, dim=2)                   # (m, 2, ppd)
    pay, (ever, first, r_T, _) = _note_path_values(
        worst, T, r, n_obs, autocall_barrier, coupon_barrier,
        protection_barrier, coupon, final_coupon, notional)
    oh = (torch.nn.functional.one_hot(first.to(torch.int64), n_obs)
          .to(torch.float32) * ever[..., None])         # (2, ppd, m)
    aux = {"call_counts": torch.sum(oh, dim=(0, 1)),
           "loss_count": torch.sum((~ever & (r_T < protection_barrier))
                                   .to(torch.float32)),
           "branch_paths": _f32(2 * ever.shape[-1], pay.device)}
    return pay, None, aux


def sharded_worstof_autocall(engine, T, seed: int, *, mesh: Mesh,
                             num_paths=None, n_obs: int = 4,
                             autocall_barrier: float = 1.0,
                             coupon_barrier: float = 0.8,
                             protection_barrier: float = 0.7,
                             coupon: float = 0.02,
                             final_coupon=None, notional: float = 1.0,
                             axis_name: str = "paths",
                             shard_draws: Draws = None) -> Dict[str, Any]:
    """Mesh-sharded worst-of autocallable note value. `engine` is a
    `WorstOfAutocallableEngine` (its stacked params and correlation
    Cholesky)."""
    if final_coupon is None:
        final_coupon = n_obs * coupon
    n_total = int(num_paths if num_paths is not None else engine.num_paths)
    stats = sharded_moments(
        _worstof_note_payoffs, seed,
        (engine.params_batch, engine.corr_chol, float(T), float(engine.r)),
        mesh=mesh, axis_name=axis_name,
        shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, n_total, axis_name)),
                 ("n_assets", engine.n_assets), ("n_obs", n_obs),
                 ("steps_per_period", engine.steps_per_period),
                 ("autocall_barrier", float(autocall_barrier)),
                 ("coupon_barrier", float(coupon_barrier)),
                 ("protection_barrier", float(protection_barrier)),
                 ("coupon", float(coupon)),
                 ("final_coupon", float(final_coupon)),
                 ("notional", float(notional))))
    out = pool_moments(stats)          # note values are path-discounted
    bp = float(stats["branch_paths"])
    first_call = stats["call_counts"].cpu().numpy().astype(np.float64) / bp
    dts = float(T) / n_obs * np.arange(1, n_obs + 1, dtype=np.float64)
    out["call_prob_by_date"] = first_call.tolist()
    out["survival_prob"] = float(1.0 - first_call.sum())
    out["loss_prob"] = float(stats["loss_count"]) / bp
    out["expected_life"] = float((first_call * dts).sum()
                                 + (1.0 - first_call.sum()) * float(T))
    out["n_obs"] = n_obs
    out["n_assets"] = engine.n_assets
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Variance swap (realized-variance leg)
# ─────────────────────────────────────────────────────────────────────────────
def _varswap_local_payoffs(shard: Shard, params, T, *, ppd, num_steps):
    """One shard's annualized realized-variance pair means: the MC leg of
    `engine/volderivs.py:VolDerivsEngine.variance_swap` (pairs collapsed
    before the moments: branches share jump uniforms and z²)."""
    from mcos_tpu_torch.engine.volderivs import realized_variance_paths

    with torch.no_grad():
        rv = realized_variance_paths(params, T, shard.generator(),
                                     num_paths=ppd, num_steps=num_steps,
                                     draws=shard.draws, device=shard.device)
    return torch.mean(rv, dim=0)                                 # (ppd,)


def sharded_variance_swap(params: SVJParams, T, seed: int, *, mesh: Mesh,
                          num_paths: int, num_steps: int,
                          axis_name: str = "paths",
                          shard_draws: Draws = None) -> Dict[str, object]:
    """Mesh-sharded variance-swap fair strike (MC) + the closed form."""
    from mcos_tpu_torch.engine.exotics import variance_swap_fair_strike

    stats = sharded_moments(
        _varswap_local_payoffs, seed, (params, T), mesh=mesh,
        axis_name=axis_name, shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps)))
    pooled = pool_moments(stats)
    closed = variance_swap_fair_strike(params, float(T))
    mc = float(pooled["price"])
    se = float(pooled["std_error"])
    return {
        **closed,
        "mc_fair_variance": mc,
        "mc_std_error": se,
        "mc_vs_closed_sigmas": float(
            abs(mc - closed["fair_variance"]) / max(se, 1e-12)),
        "num_paths_used": float(pooled["num_paths_used"]),
    }


# ─────────────────────────────────────────────────────────────────────────────
# Rough Bergomi (the exact-covariance sampler)
# ─────────────────────────────────────────────────────────────────────────────
def _rough_local_payoffs(shard: Shard, params, spot, strikes, T, chol, *,
                         ppd, num_steps, is_call):
    """One shard's rough Bergomi conditional-Black payoffs, (K, ppd)
    (`draws`: the (paths, 2n) normals of the exact factor)."""
    from mcos_tpu_torch.ops.rough import rbergomi_conditional_payoffs

    pay = rbergomi_conditional_payoffs(
        params, spot, strikes, T, chol, shard.generator(), num_paths=ppd,
        num_steps=num_steps, is_call=is_call, z=shard.draws,
        device=shard.device)                     # (2, ppd, K)
    return torch.mean(pay, dim=0).T              # antithetic combine


def sharded_rough_price(params, spot, strikes, T, seed: int, *, mesh: Mesh,
                        num_paths: int, num_steps: int, is_call: bool = True,
                        axis_name: str = "paths", shard_draws: Draws = None
                        ) -> Dict[str, torch.Tensor]:
    """Mesh-sharded rough Bergomi pricing (conditional-Black estimator):
    each shard runs the exact-covariance sampler on its own stream (the
    Cholesky factor is a host constant; the per-path draws scale)."""
    from mcos_tpu_torch.ops.rough import rbergomi_chol

    chol = rbergomi_chol(float(params.hurst), float(T), num_steps)
    stats = sharded_moments(
        _rough_local_payoffs, seed, (params, spot, strikes, T, chol),
        mesh=mesh, axis_name=axis_name,
        shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps), ("is_call", is_call)))
    return pool_moments(stats, _discount(params.r, T, stats["n"].device))


# ─────────────────────────────────────────────────────────────────────────────
# Heston-Hull-White
# ─────────────────────────────────────────────────────────────────────────────
def _hhw_local_payoffs(shard: Shard, p, spot, strikes, T, *, ppd, num_steps,
                       is_call):
    """One shard's pathwise-discounted HHW payoffs, (K, ppd): K7 keyed on
    the shard's seed, or the twin (`draws` (steps, 3, paths) normals)."""
    from mcos_tpu_torch.ops.hhw import hhw_terminal

    kw = dict(num_paths=ppd, num_steps=num_steps, device=shard.device)
    if _kernel_shard(shard):
        s, d = cuda_kernels.hhw_terminal(p, spot, T, shard.seed, **kw)
    else:
        s, d = hhw_terminal(p, spot, T, shard.generator(),
                            draws=shard.draws, **kw)
    return _pair_payoffs(s, _strikes(strikes, s.device), is_call, d).T


def sharded_hhw_price(hhw_params, spot, strikes, T, seed: int, *,
                      mesh: Mesh, num_paths: int, num_steps: int,
                      is_call: bool = True, axis_name: str = "paths",
                      backend: str = "cuda", shard_draws: Draws = None
                      ) -> Dict[str, torch.Tensor]:
    """Mesh-sharded Heston-Hull-White pricing. Each shard runs the joint
    (S, v, r) loop (the left-point ∫r martingale scheme); the pathwise
    discount is inside each payoff, so the moments pool undiscounted."""
    stats = sharded_moments(
        _hhw_local_payoffs, seed, (hhw_params, spot, strikes, T), mesh=mesh,
        axis_name=axis_name, backend=backend, shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps), ("is_call", is_call)))
    return pool_moments(stats)


# ─────────────────────────────────────────────────────────────────────────────
# SLV particles (pooled inside the step loop)
# ─────────────────────────────────────────────────────────────────────────────
def sharded_slv_price(
    heston: SVJParams,
    var_rows,
    t_mid,
    y0,
    dy,
    spot,
    strikes,
    T,
    seed: int,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    n_bins: int = 101,
    is_call: bool = True,
    axis_name: str = "paths",
    shard_draws: Draws = None,
) -> Dict[str, torch.Tensor]:
    """Mesh-sharded SLV particle-method pricing.

    SLV is a McKean-Vlasov simulation: the leverage at each step depends
    on E[v | S] over the WHOLE particle cloud. The shards therefore step
    in lockstep, one thread each, and pool each step's bin statistics
    (sums, counts, the cloud's v sum and count: n_bins + 2 words) through
    `slv_terminal`'s `pool` hook, so n shards × ppd particles behave as
    ONE cloud of n·ppd particles, not n small clouds (small clouds
    noise-flatten the leverage). Terminal payoffs then pool as moments.
    `shard_draws(i)`: shard i's (steps, 2, paths) normals."""
    from mcos_tpu_torch.engine.slv import slv_terminal

    ppd = _ppd(mesh, num_paths, axis_name)

    def local(shard: Shard, pool):
        s = slv_terminal(heston, var_rows, t_mid, y0, dy, spot, T,
                         shard.generator(), num_paths=ppd,
                         num_steps=num_steps, n_bins=n_bins,
                         normals=shard.draws, pool=pool,
                         device=shard.device)                # (2, ppd)
        return shard_moments(
            _pair_payoffs(s, _strikes(strikes, s.device), is_call).T)

    stats = pool_shards(run_lockstep(local, mesh_shards(
        mesh, seed, axis_name=axis_name,
        shard_draws=shard_draws), mesh), mesh)
    return pool_moments(stats, _discount(heston.r, T, stats["n"].device))


# ─────────────────────────────────────────────────────────────────────────────
# Time-dependent SVJ (piecewise-constant θ/ξ/λ)
# ─────────────────────────────────────────────────────────────────────────────
def _td_local_payoffs(shard: Shard, params, th_t, xi_t, lam_t, spot, strikes,
                      T, *, ppd, num_steps, is_call, control_variate):
    """One shard's td-SVJ CV-effective payoffs (β = 1 companion folded
    in), (K, ppd), plus the guards' diagnostics: K9 keyed on the shard's
    seed, or the twin (`draws` = (z, u_jump))."""
    from mcos_tpu_torch.ops.tdsvj import simulate_terminal_td

    device = shard.device
    kw = dict(num_paths=ppd, num_steps=num_steps, antithetic=True,
              companion=control_variate, device=device)
    if _kernel_shard(shard):
        s, v, g = cuda_kernels.svj_terminal_td(params, th_t, xi_t, lam_t,
                                               spot, T, shard.seed, **kw)
    else:
        s, v, g = simulate_terminal_td(params, th_t, xi_t, lam_t, spot, T,
                                       shard.generator(), draws=shard.draws,
                                       **kw)
    return beta_one_payoffs(params, spot, strikes, T, s, v, g,
                            is_call=is_call, control_variate=control_variate)


def sharded_td_price(
    params: SVJParams,
    theta_t,
    xi_t,
    lam_t,
    spot,
    strikes,
    T,
    seed: int,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    control_variate: bool = True,
    axis_name: str = "paths",
    backend: str = "cuda",
    shard_draws: Draws = None,
) -> Dict[str, torch.Tensor]:
    """Mesh-sharded pricing under time-dependent (θ, ξ, λ) dynamics: the
    pooled moments of `sharded_price` (β = 1 companion CV); the per-step
    parameter arrays are host constants."""
    stats = sharded_moments(
        _td_local_payoffs, seed,
        (params, theta_t, xi_t, lam_t, spot, strikes, T), mesh=mesh,
        axis_name=axis_name, backend=backend, shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, num_paths, axis_name)),
                 ("num_steps", num_steps), ("is_call", is_call),
                 ("control_variate", control_variate)))
    device = stats["n"].device
    out = pool_moments(stats, _discount(params.r, T, device))
    out["frac_nonfinite"] = stats["nonfinite"] / (2.0 * stats["n"])
    if control_variate:
        out["bs_ref"] = bs_price(spot, _strikes(strikes, device), T,
                                 params.r, params.q,
                                 torch.sqrt(_f32(params.v0, device)),
                                 is_call, device=device)
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Multi-asset SVJ basket
# ─────────────────────────────────────────────────────────────────────────────
def _basket_local_payoffs(shard: Shard, batch, spots, chol, w, strike, T, *,
                          ppd, num_steps, is_call, use_cv):
    """One shard's basket (pay, ctrl): the engine's own
    `engine/basket.py:basket_payoff_and_control` on a correlated
    simulation of the shard's paths."""
    from mcos_tpu_torch.engine.basket import (basket_payoff_and_control,
                                              simulate_basket_terminal)

    device = shard.device
    s, g = simulate_basket_terminal(
        batch, spots, chol, T, shard.generator(), num_paths=ppd,
        num_steps=num_steps, antithetic=True, companion=use_cv,
        draws=shard.draws, device=device)
    pay, ctrl = basket_payoff_and_control(
        s, g, _f32(np.float32(w), device), _f32(np.float32(spots), device),
        strike, is_call, use_cv)
    return pay if ctrl is None else (pay, ctrl, {})


def sharded_basket_price(
    engine,
    spots,
    weights,
    strike,
    T,
    seed: int,
    *,
    mesh: Mesh,
    num_paths: Optional[int] = None,
    is_call: bool = True,
    axis_name: str = "paths",
    shard_draws: Draws = None,
) -> Dict[str, float]:
    """Mesh-sharded multi-asset SVJ basket pricing. `engine` is a
    `BasketEngine` (stacked per-asset params, correlation Cholesky); the
    optimal-β geometric-basket control comes from the pooled cross
    moments: the single-device estimator on the union sample."""
    from mcos_tpu_torch.config import scaled_steps

    n_total = int(num_paths if num_paths is not None else engine.num_paths)
    steps = scaled_steps(engine.num_steps, T)
    use_cv = engine.use_control_variate
    spots = np.asarray(spots, np.float64)
    weights = np.asarray(weights, np.float64)
    stats = sharded_moments(
        _basket_local_payoffs, seed,
        (engine._batch, spots, engine._chol, weights, strike, T),
        mesh=mesh, axis_name=axis_name,
        shard_draws=shard_draws,
        statics=(("ppd", _ppd(mesh, n_total, axis_name)),
                 ("num_steps", steps), ("is_call", is_call),
                 ("use_cv", use_cv)))
    ctrl_exact = (engine._geo_ctrl_exact(spots, weights, strike, T, is_call)
                  if use_cv else None)
    discount = float(np.exp(-float(engine.params_list[0].r) * T))
    pooled = pool_moments(stats, discount, ctrl_exact=ctrl_exact)
    out = {
        "price": float(pooled["price"]),
        "std_error": float(pooled["std_error"]),
        "num_paths_used": float(stats["n"]),
        "num_steps": steps,
        "num_devices": mesh.shape[axis_name],
    }
    if pooled.get("cv_beta") is not None:
        out["cv_beta"] = float(pooled["cv_beta"])
    return out
