"""Greeks engine of the port (counterpart of `mcos_tpu/engine/greeks.py`):
exact pathwise autograd plus common-random-number (CRN) finite-difference
cross-checks.

Every first-order Greek comes out of ONE backward pass: `torch.autograd.grad`
of the control-variate-adjusted MC price with respect to spot, T and every
`SVJParams` field at once, through the differentiable step-loop twins of
`ops/simulate.py` (the JAX package's `jax.value_and_grad` over its scans):

- delta = ∂P/∂S₀, vega = ∂P/∂v₀, rho = ∂P/∂r, theta = −∂P/∂T, and
  ∂P/∂{κ, θ, ξ, ρ, μ_J, σ_J} for the model-risk block;
- gamma is a central CRN difference of the AD delta (the second pathwise
  derivative of a kinked payoff loses the ∂1_ITM mass);
- λ: the jump indicator 1{U < λdt} has no pathwise derivative, so λ is a
  CRN central difference, with the likelihood-ratio score estimate beside
  it when λ > 1e-6; the AD value is `lambda_j_drift_only`;
- the four FD members (v₀±, λ±) run forward only, outside the backward.

A JAX `vmap` of `grad` becomes one `torch.autograd.grad` of the sum of the
member prices with respect to an (M,) leaf tensor: the members of
`simulate.simulate_terminal_members` are independent, so each slot of that
gradient is that member's own derivative.

Randoms: a program takes `draws` = (z, u), (steps, 3, paths) normals and
(steps, paths) jump uniforms, the torch counterpart of the JAX key; every
block of one engine reads the same draws (CRN). `GreeksEngine._draws` makes
them from a generator seeded with the engine's seed on its device. The
differentiated step loops run in checkpointed chunks of
`simulate.REMAT_CHUNK` steps (`torch.utils.checkpoint`), so autograd keeps
the chunk boundaries only.

Result keys mirror the JAX package's (and so the reference's), including
`theta_daily` holding the annualized decay rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import DEFAULT_NUM_PATHS, scaled_steps
from mcos_tpu_torch.engine.pricer import seeded_generator, to_host
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import simulate
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.utils import spans

# Shared FD bump defaults: vega() and jump_sensitivities() read ONE params
# batch per contract with these (the all_greeks path), so the bump pair is
# part of that batch's memo key.
DEFAULT_VEGA_BUMP = 0.01
DEFAULT_LAMBDA_BUMP = 0.1

#: Member-path elements (members × 2 branches × paths) one differentiated
#: member batch may carry; larger point batches run in chunks of members.
MEMBER_ELEMENTS = 1 << 23
#: Entries the per-engine result memo holds before it is cleared.
MEMO_MAX = 256

_FIELDS = tuple(f.name for f in dataclasses.fields(SVJParams))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _leaf(x, device) -> torch.Tensor:
    """A fresh float32 autograd leaf holding `x`."""
    return torch.tensor(np.asarray(x, np.float32), device=device,
                        requires_grad=True)


def _param_leaves(params: SVJParams, device) -> Dict[str, torch.Tensor]:
    return {n: _leaf(float(getattr(params, n)), device) for n in _FIELDS}


def _grad(out: torch.Tensor, inputs):
    return torch.autograd.grad(out, inputs, allow_unused=True,
                               materialize_grads=True)


def _lead(x, device, lead: int) -> torch.Tensor:
    """A float32 tensor of `x`; an (M,) leaf becomes (M, 1) under a leading
    member axis (`lead` = 1), so it broadcasts against (M, K) prices."""
    x = _f32(x, device)
    return simulate._member_leaf(x, 2) if lead else x


def _tables(s_final, g_final, strikes, is_call: bool):
    """Antithetic-combined payoff tables (..., K, paths) of the terminals
    (..., n_branch, paths) and of the companion (None without it)."""
    def table(x):
        pay = simulate.vanilla_payoff(x.unsqueeze(-3),
                                      strikes[:, None, None], is_call)
        return torch.mean(pay, dim=-2)
    return table(s_final), None if g_final is None else table(g_final)


def _mc_price(pp: SVJParams, s_final, g_final, spot, strikes, T,
              is_call: bool, control_variate: bool = True) -> torch.Tensor:
    """(..., K) prices by `mc_price_core`'s estimator (companion control,
    β = 1) on terminals (..., n_branch, paths); a leading member axis of
    the terminals matches (M,) leaves of `pp`, `spot` and `T`."""
    device = s_final.device
    lead = s_final.dim() - 2
    r, T = _lead(pp.r, device, lead), _lead(T, device, lead)
    pay, ctrl = _tables(s_final, g_final if control_variate else None,
                        strikes, is_call)
    discount = torch.exp(-r * T)
    price = discount * torch.mean(pay, dim=-1)
    if control_variate:
        bs_ref = bs_price(_lead(spot, device, lead), strikes, T, r,
                          _lead(pp.q, device, lead),
                          torch.sqrt(_lead(pp.v0, device, lead)), is_call)
        price = price - (discount * torch.mean(ctrl, dim=-1) - bs_ref)
    return price


def _strikes(strike, device) -> torch.Tensor:
    return torch.atleast_1d(_f32(strike, device))


def _check(draws, num_paths, num_steps) -> torch.device:
    z, u = draws
    if tuple(u.shape) != (num_steps, num_paths):
        raise ValueError(f"draws are {tuple(u.shape)}, not "
                         f"({num_steps}, {num_paths})")
    return z.device


# ─────────────────────────────────────────────────────────────────────────────
# Device programs
# ─────────────────────────────────────────────────────────────────────────────
def _price_scalar(params: SVJParams, spot, strike, T, draws, *,
                  num_paths: int, num_steps: int, is_call: bool,
                  control_variate: bool = True) -> torch.Tensor:
    """The CV price of one contract, a 0-d tensor, differentiable in spot,
    T and every tensor leaf of `params`."""
    device = _check(draws, num_paths, num_steps)
    s_final, _, g_final, _ = simulate.simulate_terminal_with_score(
        params, spot, T, draws=draws, companion=control_variate)
    return _mc_price(params, s_final, g_final, spot,
                     _strikes(strike, device), T, is_call,
                     control_variate)[0]


def price_and_greeks(params: SVJParams, spot, strike, T, draws, *,
                     num_paths: int, num_steps: int, is_call: bool,
                     control_variate: bool = True):
    """(price, ∂P/∂spot, ∂P/∂T, ∂P/∂params as an `SVJParams` of 0-d
    tensors) in one forward and one backward pass."""
    device = _check(draws, num_paths, num_steps)
    leaves = _param_leaves(params, device)
    spot_t, T_t = _leaf(spot, device), _leaf(T, device)
    with torch.enable_grad():
        price = _price_scalar(params.replace(**leaves), spot_t, strike, T_t,
                              draws, num_paths=num_paths,
                              num_steps=num_steps, is_call=is_call,
                              control_variate=control_variate)
        grads = _grad(price, [spot_t, T_t, *leaves.values()])
    return (price.detach(), grads[0], grads[1],
            SVJParams(**dict(zip(_FIELDS, grads[2:]))))


def _member_chunks(num_members: int, num_paths: int):
    """Slices of a point batch that keep each differentiated member batch
    within MEMBER_ELEMENTS path elements."""
    size = max(1, MEMBER_ELEMENTS // (2 * num_paths))
    return [slice(i, min(i + size, num_members))
            for i in range(0, num_members, size)]


def _ad_delta_vega_batch(params: SVJParams, spots, v0s, strike, T, draws, *,
                         num_paths: int, num_steps: int, is_call: bool):
    """(∂P/∂spot, ∂P/∂v₀ or None) at a batch of (spot, v₀, T) points, CRN:
    every point on the same draws and the base contract's step count, one
    backward pass per chunk of members (`_member_chunks`). Central
    differences of these exact first derivatives give gamma, vanna, volga
    and, with the maturity batched (`T` one per point: the JAX package's
    `_ad_dsdv_T_batch`), charm, color and veta, without the biased
    second-order pathwise AD of a kinked payoff. `v0s` None keeps the
    params' v₀ (and skips its gradient); `T` is one maturity or one per
    point."""
    device = _check(draws, num_paths, num_steps)
    strikes = _strikes(strike, device)
    spots = _f32(spots, device)
    per_point_T = np.ndim(T) > 0
    d_s, d_v = [], []
    for sl in _member_chunks(spots.shape[0], num_paths):
        spot_t = spots[sl].clone().requires_grad_(True)
        inputs, pb = [spot_t], params
        if v0s is not None:
            v0_t = _f32(v0s, device)[sl].clone().requires_grad_(True)
            pb = params.replace(v0=v0_t)
            inputs.append(v0_t)
        T_m = _f32(T, device)[sl] if per_point_T else T
        with torch.enable_grad():
            s_final, g_final, _ = simulate.simulate_terminal_members(
                pb, spot_t, T_m, draws=draws)
            prices = _mc_price(pb, s_final, g_final, spot_t, strikes, T_m,
                               is_call)[:, 0]
            grads = _grad(prices.sum(), inputs)
        d_s.append(grads[0])
        if v0s is not None:
            d_v.append(grads[1])
    return torch.cat(d_s), (torch.cat(d_v) if v0s is not None else None)


def _ad_delta_batch(params: SVJParams, spots, strike, T, draws, *,
                    num_paths: int, num_steps: int, is_call: bool):
    """Pathwise AD delta at several spots (gamma's central difference needs
    two) in one backward pass."""
    return _ad_delta_vega_batch(params, spots, None, strike, T, draws,
                                num_paths=num_paths, num_steps=num_steps,
                                is_call=is_call)[0]


def _params_batch_price(params_batch: SVJParams, spot, strike, T, draws, *,
                        num_paths: int, num_steps: int, is_call: bool):
    """CRN prices under a batch of parameterizations (leaves (M,) tensors or
    shared floats), forward only: the vega/λ FD bumps in one step loop."""
    device = _check(draws, num_paths, num_steps)
    with torch.no_grad():
        s_final, g_final, _ = simulate.simulate_terminal_members(
            params_batch, spot, T, draws=draws)
        return _mc_price(params_batch, s_final, g_final, spot,
                         _strikes(strike, device), T, is_call)[:, 0]


def lambda_lr_estimate(params: SVJParams, spot, strike, T, draws, *,
                       num_paths: int, num_steps: int, is_call: bool):
    """Likelihood-ratio (score-function) estimator of ∂P/∂λ on one branch:
    E[f·Σ_t (J_t − p)/(p(1 − p))·dt] with p = λ·dt and the payoff centred
    (a free baseline), plus the pathwise drift-compensator term. Requires
    λ > 0. Returns (estimate, its standard error), 0-d tensors."""
    device = _check(draws, num_paths, num_steps)
    z, u = draws
    with torch.no_grad():
        T_f = _f32(T, device)
        dt = T_f / num_steps
        prob = torch.clamp(params.lambda_j * dt, 1e-7, 1.0 - 1e-7)
        log_s, _, _, score = simulate._svj_scan(
            params, dt, torch.sqrt(dt), z, u, None, False, prob)
        s_final = _f32(spot, device) * torch.exp(log_s)
        pay = simulate.vanilla_payoff(s_final, strike, is_call)
        discount = torch.exp(-params.r * T_f)
        centered = pay - torch.mean(pay)
        vals = centered * score
        lr_term = discount * torch.mean(vals)
        se = (discount * torch.std(vals, correction=0)
              / torch.sqrt(_f32(num_paths, device)))
        k_comp = torch.exp(_f32(params.mu_j + 0.5 * params.sigma_j**2,
                                device)) - 1.0
        drift_term = discount * torch.mean(
            (pay > 0).to(torch.float32) * s_final * (-k_comp) * T_f) \
            * (1.0 if is_call else -1.0)
    return lr_term + drift_term, se


@spans.traced("program.greeks")
def _all_greeks_device(params: SVJParams, spot, strike, T, draws, *,
                       num_paths: int, num_steps: int, is_call: bool,
                       with_lr: bool, bump: float = 0.01,
                       v_bump: float = DEFAULT_VEGA_BUMP,
                       l_bump: float = DEFAULT_LAMBDA_BUMP
                       ) -> Dict[str, torch.Tensor]:
    """Every all_greeks ingredient off one simulation, on the device, with
    no host sync:

    - the base contract forward and ONE backward pass (delta, theta and
      ∂P/∂params), the λ score accumulated in the same step loop;
    - the four CRN FD members (v₀ ± v_bump, λ ± l_bump) in one forward-only
      member loop on the same draws, outside the backward;
    - spot-bump CRN prices by strike homogeneity on the base terminals
      (SVJ log-dynamics do not depend on S₀: P((1±b)S, K) =
      (1±b)·P(S, K/(1±b))), no extra simulation;
    - the AD deltas at spot(1 ± b) for gamma, differentiating only the
      payoff and control materialization on the frozen terminals;
    - with `with_lr`, the LR λ estimate off the base terminals.

    Returns {price, d_spot, d_T, d_params (10,) in field order,
    spot_bumped (2,), pbatch (4,), d_pair (2,)[, lr_raw, lr_se,
    lr_drift]}.
    """
    device = _check(draws, num_paths, num_steps)
    strike_arr = _strikes(strike, device)
    rel = _f32([1.0 + bump, 1.0 - bump], device)
    leaves = _param_leaves(params, device)
    spot_t, T_t = _leaf(spot, device), _leaf(T, device)
    with torch.enable_grad():
        pp = params.replace(**leaves)
        s0, _, g0, score = simulate.simulate_terminal_with_score(
            pp, spot_t, T_t, draws=draws, companion=True)
        price = _mc_price(pp, s0, g0, spot_t, strike_arr, T_t, is_call)[0]
        grads = _grad(price, [spot_t, T_t, *leaves.values()])
    s0, g0 = s0.detach(), g0.detach()
    spot_f, T_f = spot_t.detach(), T_t.detach()
    fp = params.replace(**{n: t.detach() for n, t in leaves.items()})

    with torch.no_grad():
        v0, lam = fp.v0, fp.lambda_j
        batch4 = params.replace(
            v0=torch.stack([v0 + v_bump, torch.clamp(v0 - v_bump, min=0.001),
                            v0, v0]),
            lambda_j=torch.stack([lam, lam, lam + l_bump,
                                  torch.clamp(lam - l_bump, min=0.0)]))
        s4, g4, _ = simulate.simulate_terminal_members(batch4, spot_f, T_f,
                                                       draws=draws)
        prices4 = _mc_price(batch4, s4, g4, spot_f, strike_arr, T_f,
                            is_call)[:, 0]
        spot_bumped = _mc_price(fp, s0, g0, spot_f, strike_arr[0] / rel,
                                T_f, is_call)

    sp = (spot_f * rel).requires_grad_()
    with torch.enable_grad():
        scale = (sp / spot_f)[:, None, None]
        p_pair = _mc_price(fp, s0 * scale, g0 * scale, sp, strike_arr, T_f,
                           is_call)[:, 0]
        (d_pair,) = _grad(p_pair.sum(), [sp])

    out = {"price": price.detach(), "d_spot": grads[0], "d_T": grads[1],
           "d_params": torch.stack(list(grads[2:])),
           "spot_bumped": spot_bumped, "pbatch": prices4, "d_pair": d_pair}
    if with_lr:
        with torch.no_grad():
            # The score is shared by the antithetic pair, so each pair's
            # mean payoff is one iid value: the same point estimate as over
            # 2n values and an honest standard error over n.
            discount = torch.exp(-fp.r * T_f)
            pay_b = simulate.vanilla_payoff(s0, strike_arr[0], is_call)
            pair_pay = torch.mean(pay_b, dim=0)
            vals = (pair_pay - torch.mean(pair_pay)) * score
            out["lr_raw"] = discount * torch.mean(vals)
            out["lr_se"] = (discount * torch.std(vals, correction=0)
                            / torch.sqrt(_f32(vals.shape[0], device)))
            k_comp = torch.exp(fp.mu_j + 0.5 * fp.sigma_j**2) - 1.0
            out["lr_drift"] = discount * torch.mean(
                (pay_b.reshape(-1) > 0).to(torch.float32) * s0.reshape(-1)
                * (-k_comp) * T_f) * (1.0 if is_call else -1.0)
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Stateful engine (reference API surface)
# ─────────────────────────────────────────────────────────────────────────────
class GreeksEngine:
    """Counterpart of `mcos_tpu.engine.greeks.GreeksEngine` on `device`."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 252, seed: int = 42, *, device="cuda"):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.device = torch.device(device)
        # Result memo: within one all_greeks call every first-order block
        # reads the same backward pass, and the delta/gamma FD cross-checks
        # share their CRN bump prices. Keys carry the whole engine state.
        self._memo: Dict[tuple, object] = {}
        self._draw_cache: tuple = (None, None)

    # -- internals -------------------------------------------------------------
    def _draws(self, steps: int):
        """The engine's (z, u) for `steps` steps: a generator seeded with
        the engine's seed on its device; one set cached."""
        key = (steps, self.num_paths, self.seed, str(self.device))
        if self._draw_cache[0] != key:
            gen = seeded_generator(self.seed, self.device)
            z = torch.randn((steps, 3, self.num_paths), generator=gen,
                            device=self.device, dtype=torch.float32)
            u = torch.rand((steps, self.num_paths), generator=gen,
                           device=self.device, dtype=torch.float32)
            self._draw_cache = (key, (z, u))
        return self._draw_cache[1]

    def _steps(self, T: float) -> int:
        return scaled_steps(self.num_steps, T)

    def _kw(self, T: float, is_call: bool) -> dict:
        return dict(num_paths=self.num_paths, num_steps=self._steps(T),
                    is_call=bool(is_call))

    def _state_key(self, params) -> tuple:
        return (self.num_paths, self.num_steps, self.seed, str(self.device),
                tuple(sorted(params.as_dict().items())))

    def _remember(self, k, value) -> None:
        if len(self._memo) >= MEMO_MAX:
            self._memo.clear()
        self._memo[k] = value

    def _grads(self, spot, strike, T, is_call):
        k = ("grads", float(spot), float(strike), float(T), bool(is_call),
             self._state_key(self.params))
        if k not in self._memo:
            price, d_spot, d_T, d_params = price_and_greeks(
                self.params, spot, strike, T, self._draws(self._steps(T)),
                **self._kw(T, is_call))
            host = to_host({"price": price, "d_spot": d_spot, "d_T": d_T,
                            "d_params": torch.stack(
                                [getattr(d_params, n) for n in _FIELDS])})
            self._remember(k, (float(host["price"]), float(host["d_spot"]),
                               float(host["d_T"]),
                               _params_of(host["d_params"])))
        return self._memo[k]

    def _spot_bump_prices(self, spot, strike, T, is_call, bump):
        """(P(spot(1+b), K), P(spot(1−b), K)) off one strike-vectorized CRN
        pricing: P((1±b)S, K) = (1±b)·P(S, K/(1±b))."""
        k = ("spot2", float(spot), float(strike), float(T), bool(is_call),
             float(bump), self._state_key(self.params))
        if k not in self._memo:
            rel = np.array([1.0 + bump, 1.0 - bump])
            draws = self._draws(self._steps(T))
            with torch.no_grad():
                s_final, _, g_final, _ = \
                    simulate.simulate_terminal_with_score(
                        self.params, spot, T, draws=draws, companion=True)
                prices = _mc_price(self.params, s_final, g_final, spot,
                                   _f32(strike / rel, self.device), T,
                                   is_call)
            pr = prices.cpu().numpy().astype(np.float64) * rel
            self._remember(k, (float(pr[0]), float(pr[1])))
        return self._memo[k]

    def _param_bump_prices(self, spot, strike, T, is_call, v_bump, l_bump):
        """CRN prices at (v0±b_v, λ±b_λ): one member batch."""
        k = ("pbatch", float(spot), float(strike), float(T), bool(is_call),
             float(v_bump), float(l_bump), self._state_key(self.params))
        if k not in self._memo:
            p = self.params
            v0, lam = float(p.v0), float(p.lambda_j)
            v0_up, v0_dn = v0 + v_bump, max(v0 - v_bump, 0.001)
            lam_up, lam_dn = lam + l_bump, max(lam - l_bump, 0.0)
            batch = p.replace(
                v0=_f32([v0_up, v0_dn, v0, v0], self.device),
                lambda_j=_f32([lam, lam, lam_up, lam_dn], self.device))
            arr = _params_batch_price(
                batch, spot, strike, T, self._draws(self._steps(T)),
                **self._kw(T, is_call)).cpu().numpy().astype(np.float64)
            self._remember(k, {
                "v0_up": (v0_up, float(arr[0])),
                "v0_dn": (v0_dn, float(arr[1])),
                "lam_up": (lam_up, float(arr[2])),
                "lam_dn": (lam_dn, float(arr[3])),
            })
        return self._memo[k]

    def _ad_delta_pair(self, spot, strike, T, is_call, bump):
        """AD deltas at spot(1±b), one backward pass."""
        k = ("adpair", float(spot), float(strike), float(T), bool(is_call),
             float(bump), self._state_key(self.params))
        if k not in self._memo:
            d = _ad_delta_batch(
                self.params, [spot * (1 + bump), spot * (1 - bump)], strike,
                T, self._draws(self._steps(T)), **self._kw(T, is_call))
            d = d.cpu().numpy().astype(np.float64)
            self._remember(k, (float(d[0]), float(d[1])))
        return self._memo[k]

    # -- reference API -----------------------------------------------------------
    def delta(self, spot: float, strike: float, T: float,
              is_call: bool = True, bump: float = 0.01) -> Dict[str, float]:
        """AD pathwise delta + CRN-FD cross-check."""
        _, d_spot, _, _ = self._grads(spot, strike, T, is_call)
        pathwise = float(d_spot)
        p_up, p_dn = self._spot_bump_prices(spot, strike, T, is_call, bump)
        fd = (p_up - p_dn) / (2 * spot * bump)
        return {
            "pathwise": pathwise,
            "finite_diff": float(fd),
            "diff_pct": float(abs(pathwise - fd) / max(abs(fd), 1e-10) * 100),
        }

    def vega(self, spot: float, strike: float, T: float,
             is_call: bool = True,
             bump: float = DEFAULT_VEGA_BUMP) -> Dict[str, float]:
        """Exact ∂P/∂v₀ by AD; ×2σ per vol point; CRN-FD cross-check."""
        _, _, _, d_params = self._grads(spot, strike, T, is_call)
        ad_vega = float(d_params.v0)
        v0 = float(self.params.v0)
        pb = self._param_bump_prices(spot, strike, T, is_call,
                                     v_bump=bump, l_bump=DEFAULT_LAMBDA_BUMP)
        (v0_up, p_up), (v0_dn, p_dn) = pb["v0_up"], pb["v0_dn"]
        fd = (p_up - p_dn) / (v0_up - v0_dn)
        sigma = v0 ** 0.5
        return {
            "fd_vega_v0": float(fd),
            "ad_vega_v0": ad_vega,
            "vega_per_vol_point": ad_vega * 2 * sigma,
            "diff_pct": float(abs(ad_vega - fd) / max(abs(fd), 1e-10) * 100),
        }

    def gamma(self, spot: float, strike: float, T: float,
              is_call: bool = True, bump: float = 0.01) -> Dict[str, float]:
        """Central CRN difference of the AD delta, with the spot-bumped
        prices of the same CRN stream."""
        h = spot * bump
        s_up, s_dn = spot * (1 + bump), spot * (1 - bump)
        d_up, d_dn = self._ad_delta_pair(spot, strike, T, is_call, bump)
        gamma = (d_up - d_dn) / (s_up - s_dn)
        p_base = self._grads(spot, strike, T, is_call)[0]
        p_up, p_dn = self._spot_bump_prices(spot, strike, T, is_call, bump)
        return {
            "gamma": float(gamma),
            "gamma_fd2": float((p_up - 2 * p_base + p_dn) / (h * h)),
            "price_up": p_up,
            "price_base": p_base,
            "price_down": p_dn,
        }

    def theta(self, spot: float, strike: float, T: float,
              is_call: bool = True, dt: float = 1 / 252) -> Dict[str, float]:
        """Exact −∂P/∂T by AD, under the reference's key `theta_daily`
        (an annualized decay rate, as the reference labels it)."""
        del dt  # AD needs no step size
        _, _, d_T, _ = self._grads(spot, strike, T, is_call)
        theta_val = -float(d_T)
        return {"theta_daily": theta_val, "theta_annual": theta_val * 252}

    def rho(self, spot: float, strike: float, T: float,
            is_call: bool = True, bump: float = 0.0001) -> Dict[str, float]:
        """Exact ∂P/∂r by AD."""
        del bump
        _, _, _, d_params = self._grads(spot, strike, T, is_call)
        rho_val = float(d_params.r)
        return {"rho": rho_val, "rho_per_rate_point": rho_val / 100}

    def jump_sensitivities(self, spot: float, strike: float, T: float,
                           is_call: bool = True,
                           bump: float = DEFAULT_LAMBDA_BUMP
                           ) -> Dict[str, float]:
        """μ_J, σ_J by AD; λ by CRN central difference (and by the LR score
        when λ > 1e-6); the AD λ value (drift compensator only) beside."""
        _, _, _, d_params = self._grads(spot, strike, T, is_call)
        pb = self._param_bump_prices(spot, strike, T, is_call,
                                     v_bump=DEFAULT_VEGA_BUMP, l_bump=bump)
        (lam_up, p_up), (lam_dn, p_dn) = pb["lam_up"], pb["lam_dn"]
        denom = max(lam_up - lam_dn, 1e-12)
        out = {
            "lambda_j": float((p_up - p_dn) / denom),
            "lambda_j_drift_only": float(d_params.lambda_j),
            "mu_j": float(d_params.mu_j),
            "sigma_j": float(d_params.sigma_j),
        }
        if float(self.params.lambda_j) > 1e-6:
            klr = ("lr", float(spot), float(strike), float(T), bool(is_call),
                   self._state_key(self.params))
            if klr not in self._memo:
                lr, lr_se = lambda_lr_estimate(
                    self.params, spot, strike, T,
                    self._draws(self._steps(T)), **self._kw(T, is_call))
                host = to_host({"lr": lr, "se": lr_se})
                self._remember(klr, (float(host["lr"]), float(host["se"])))
            out["lambda_j_lr"], out["lambda_j_lr_se"] = self._memo[klr]
        return out

    def min_variance_delta(self, spot: float, strike: float, T: float,
                           is_call: bool = True) -> Dict[str, float]:
        """Minimum-variance hedge ratio (Hull & White 2017):
        Δ + (∂P/∂v₀)·ρξ/S, off the same backward pass as delta and vega."""
        _, d_spot, _, d_params = self._grads(spot, strike, T, is_call)
        p = self.params
        adjustment = (float(d_params.v0) * float(p.rho) * float(p.xi)
                      / float(spot))
        return {
            "delta": float(d_spot),
            "dP_dv0": float(d_params.v0),
            "adjustment": float(adjustment),
            "mv_delta": float(d_spot + adjustment),
        }

    def cross_greeks(self, spot: float, strike: float, T: float,
                     is_call: bool = True, spot_bump: float = 0.01,
                     vol_bump: float = 0.02) -> Dict[str, float]:
        """Vanna and volga: central CRN differences of exact AD first
        derivatives at a 4-point (spot, v₀) batch, one backward pass. The
        vol axis is bumped multiplicatively in σ, and volga differences
        the σ-vega 2σ·∂P/∂v₀ directly (no cancelling v₀-space terms)."""
        p = self.params
        v0 = float(p.v0)
        sigma = float(np.sqrt(v0))
        sig_up, sig_dn = sigma * (1 + vol_bump), sigma * (1 - vol_bump)
        v_up, v_dn = sig_up**2, sig_dn**2
        s_up, s_dn = spot * (1 + spot_bump), spot * (1 - spot_bump)
        k = ("cross", float(spot), float(strike), float(T), bool(is_call),
             float(spot_bump), float(vol_bump), self._state_key(p))
        if k not in self._memo:
            d_s, d_v = _ad_delta_vega_batch(
                p, [s_up, s_dn, spot, spot], [v0, v0, v_up, v_dn], strike, T,
                self._draws(self._steps(T)), **self._kw(T, is_call))
            host = to_host({"s": d_s, "v": d_v})
            self._remember(k, (host["s"].astype(np.float64),
                               host["v"].astype(np.float64)))
        d_s, d_v = self._memo[k]
        d_sig = sig_up - sig_dn
        # vanna two ways off the same batch: ∂delta/∂σ and ∂(σ-vega)/∂S.
        vanna = (d_s[2] - d_s[3]) / d_sig
        vanna_alt = 2 * sigma * (d_v[0] - d_v[1]) / (s_up - s_dn)
        volga = (2 * sig_up * d_v[2] - 2 * sig_dn * d_v[3]) / d_sig
        return {
            "vanna": float(vanna),
            "vanna_cross_check": float(vanna_alt),
            "volga": float(volga),
            "vanna_v0": float(vanna / (2 * sigma)),
        }

    def second_order_greeks(self, spot: float, strike: float, T: float,
                            is_call: bool = True, spot_bump: float = 0.01,
                            vol_bump: float = 0.02,
                            t_bump: float = 1 / 252) -> Dict[str, float]:
        """Charm, speed, zomma, color and veta: central CRN differences of
        exact AD first derivatives at a 12-point (spot, v₀, T) batch.
        Annualized (*_daily = /252): charm = −∂Δ/∂T, speed = ∂Γ/∂S,
        zomma = ∂Γ/∂σ, color = −∂Γ/∂T, veta = −∂(2σ·∂P/∂v₀)/∂T."""
        p = self.params
        v0 = float(p.v0)
        sigma = float(np.sqrt(v0))
        sig_up, sig_dn = sigma * (1 + vol_bump), sigma * (1 - vol_bump)
        v_up, v_dn = sig_up**2, sig_dn**2
        s_up, s_dn = spot * (1 + spot_bump), spot * (1 - spot_bump)
        h = spot * spot_bump
        ht = min(t_bump, T / 4)  # keep T−ht well inside (0, T)
        t_up, t_dn = T + ht, T - ht
        k = ("second", float(spot), float(strike), float(T), bool(is_call),
             float(spot_bump), float(vol_bump), float(ht),
             self._state_key(p))
        if k not in self._memo:
            pts = [
                (s_up, v0, T), (s_dn, v0, T),          # 0,1  gamma/speed
                (spot, v0, t_up), (spot, v0, t_dn),    # 2,3  charm/veta
                (s_up, v_up, T), (s_dn, v_up, T),      # 4,5  zomma (σ↑)
                (s_up, v_dn, T), (s_dn, v_dn, T),      # 6,7  zomma (σ↓)
                (s_up, v0, t_up), (s_dn, v0, t_up),    # 8,9  color (T↑)
                (s_up, v0, t_dn), (s_dn, v0, t_dn),    # 10,11 color (T↓)
            ]
            d_s, d_v = _ad_delta_vega_batch(
                p, [x[0] for x in pts], [x[1] for x in pts], strike,
                [x[2] for x in pts], self._draws(self._steps(T)),
                **self._kw(T, is_call))
            host = to_host({"s": d_s, "v": d_v})
            self._remember(k, (host["s"].astype(np.float64),
                               host["v"].astype(np.float64)))
        d_s, d_v = self._memo[k]

        # Base delta off the memoized backward pass (CRN: the same draws).
        _, delta0, _, _ = self._grads(spot, strike, T, is_call)

        def gam(i_up, i_dn):
            return (d_s[i_up] - d_s[i_dn]) / (s_up - s_dn)

        d_sig = sig_up - sig_dn
        gamma0 = gam(0, 1)
        charm_dT = (d_s[2] - d_s[3]) / (2 * ht)
        speed = (d_s[0] - 2 * delta0 + d_s[1]) / (h * h)
        zomma = (gam(4, 5) - gam(6, 7)) / d_sig
        color_dT = (gam(8, 9) - gam(10, 11)) / (2 * ht)
        veta_dT = 2 * sigma * (d_v[2] - d_v[3]) / (2 * ht)
        return {
            "charm": float(-charm_dT),
            "charm_daily": float(-charm_dT / 252),
            "speed": float(speed),
            "zomma": float(zomma),
            "color": float(-color_dT),
            "color_daily": float(-color_dT / 252),
            "veta": float(-veta_dT),
            "veta_daily": float(-veta_dT / 252),
            "gamma_check": float(gamma0),
            "dDelta_dT": float(charm_dT),
            "dGamma_dT": float(color_dT),
        }

    def model_sensitivities(self, spot: float, strike: float, T: float,
                            is_call: bool = True) -> Dict[str, float]:
        """∂P/∂{κ, θ, ξ, ρ}: exact AD model-risk sensitivities."""
        _, _, _, d = self._grads(spot, strike, T, is_call)
        return {"kappa": float(d.kappa), "theta": float(d.theta),
                "xi": float(d.xi), "rho_corr": float(d.rho)}

    def _device_out(self, spot: float, strike: float, T: float,
                    is_call: bool, with_lr: bool) -> Dict[str, torch.Tensor]:
        return _all_greeks_device(
            self.params, spot, strike, T, self._draws(self._steps(T)),
            with_lr=with_lr, **self._kw(T, is_call))

    def _store_device_out(self, out, spot: float, strike: float, T: float,
                          is_call: bool, with_lr: bool) -> None:
        """Fill every block's memo from a host copy of an
        `_all_greeks_device` result (cleared first if it would outgrow
        MEMO_MAX)."""
        if len(self._memo) > MEMO_MAX - 5:
            self._memo.clear()
        state = self._state_key(self.params)
        p = self.params
        bump = 0.01
        v0, lam = float(p.v0), float(p.lambda_j)
        v0_up = v0 + DEFAULT_VEGA_BUMP
        v0_dn = max(v0 - DEFAULT_VEGA_BUMP, 0.001)
        lam_up = lam + DEFAULT_LAMBDA_BUMP
        lam_dn = max(lam - DEFAULT_LAMBDA_BUMP, 0.0)
        rel = np.array([1.0 + bump, 1.0 - bump])
        args = (float(spot), float(strike), float(T), bool(is_call))
        self._memo[("grads", *args, state)] = (
            float(out["price"]), float(out["d_spot"]), float(out["d_T"]),
            _params_of(out["d_params"]))
        pr = np.asarray(out["spot_bumped"], np.float64) * rel
        self._memo[("spot2", *args, float(bump), state)] = \
            (float(pr[0]), float(pr[1]))
        pb = np.asarray(out["pbatch"], np.float64)
        self._memo[("pbatch", *args, float(DEFAULT_VEGA_BUMP),
                    float(DEFAULT_LAMBDA_BUMP), state)] = {
            "v0_up": (v0_up, float(pb[0])), "v0_dn": (v0_dn, float(pb[1])),
            "lam_up": (lam_up, float(pb[2])),
            "lam_dn": (lam_dn, float(pb[3])),
        }
        dp = np.asarray(out["d_pair"], np.float64)
        self._memo[("adpair", *args, float(bump), state)] = \
            (float(dp[0]), float(dp[1]))
        if with_lr:
            self._memo[("lr", *args, state)] = (
                float(out["lr_raw"]) + float(out["lr_drift"]),
                float(out["lr_se"]))

    def _prefetch_all(self, spot: float, strike: float, T: float,
                      is_call: bool) -> None:
        """Fill every block's memo from ONE fused device program and ONE
        device→host copy (`_all_greeks_device`)."""
        kg = ("grads", float(spot), float(strike), float(T), bool(is_call),
              self._state_key(self.params))
        if kg in self._memo:
            return
        with_lr = float(self.params.lambda_j) > 1e-6
        out = to_host(self._device_out(spot, strike, T, is_call, with_lr))
        self._store_device_out(out, spot, strike, T, is_call, with_lr)

    def _blocks(self, spot: float, strike: float, T: float,
                is_call: bool) -> Dict[str, Dict]:
        return {
            "delta": self.delta(spot, strike, T, is_call),
            "vega": self.vega(spot, strike, T, is_call),
            "gamma": self.gamma(spot, strike, T, is_call),
            "theta": self.theta(spot, strike, T, is_call),
            "rho": self.rho(spot, strike, T, is_call),
            "jumps": self.jump_sensitivities(spot, strike, T, is_call),
            "model": self.model_sensitivities(spot, strike, T, is_call),
        }

    def all_greeks(self, spot: float, strike: float, T: float,
                   is_call: bool = True) -> Dict[str, Dict]:
        """All Greeks (the reference's key layout): one fused device
        program and one host copy feed all seven blocks."""
        self._prefetch_all(spot, strike, T, is_call)
        return self._blocks(spot, strike, T, is_call)

    def all_greeks_dividends(self, spot: float, strike: float, T: float,
                             is_call: bool, dividends) -> Dict[str, Dict]:
        """all_greeks under a discrete dividend schedule: the Greeks of the
        effective process (spot·Π(1−d) for proportional dividends, the
        escrowed S − PV_r(divs) for cash), chain-ruled back to the raw spot:
        Δ = f·Δ_eff, Γ = f²·Γ_eff (f = ∂S_eff/∂S), and for escrowed cash
        ρ = ρ_eff + Δ_eff·Σ t_i D_i e^{−r t_i}. The other blocks pass
        through."""
        from mcos_tpu_torch.ops.dividends import effective_spot, pv_cash

        r = float(self.params.r)
        eff, f = effective_spot(spot, dividends, r, float(T))
        out = self.all_greeks(eff, strike, T, is_call)
        if f != 1.0:
            for key in ("pathwise", "finite_diff"):
                out["delta"][key] *= f
            for key in ("gamma", "gamma_fd2"):
                out["gamma"][key] *= f * f
        if dividends is not None and dividends.kind == "cash" \
                and dividends.before(float(T)):
            sub = dividends.before(float(T))
            ds_dr = sum(t * a * math.exp(-r * t)
                        for t, a in zip(sub.times, sub.amounts))
            rho_extra = out["delta"]["pathwise"] * ds_dr
            out["rho"]["rho"] += rho_extra
            out["rho"]["rho_per_rate_point"] += rho_extra / 100
            out["dividends"] = {"model": "escrowed",
                                "spot_effective": eff,
                                "pv": pv_cash(dividends, r, float(T))}
        elif dividends is not None and dividends.before(float(T)):
            out["dividends"] = {"model": "proportional-exact",
                                "spot_effective": eff,
                                "chain_factor": f}
        return out

    def all_greeks_chain(self, spot: float, strikes: Sequence[float],
                         T: float, is_call: bool = True) -> list:
        """All Greeks for a strike chain: every contract's fused program is
        queued on the device first, then ONE device→host copy for the whole
        chain. Returns a list of per-contract all_greeks dicts."""
        with_lr = float(self.params.lambda_j) > 1e-6
        ks = [float(k) for k in strikes]
        queued = {}
        for i, k in enumerate(ks):
            for name, v in self._device_out(spot, k, T, is_call,
                                            with_lr).items():
                queued[(i, name)] = v
        host = to_host(queued)               # ONE synchronization
        results = []
        for i, k in enumerate(ks):
            out = {name: v for (j, name), v in host.items() if j == i}
            self._store_device_out(out, spot, k, T, is_call, with_lr)
            results.append({"strike": k, **self._blocks(spot, k, T, is_call)})
        return results


def _params_of(values) -> SVJParams:
    """An `SVJParams` of floats from a (10,) array in field order."""
    return SVJParams(**{n: float(v) for n, v in zip(_FIELDS, values)})
