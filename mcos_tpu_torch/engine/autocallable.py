"""Autocallable (Express) notes under SVJ dynamics (counterpart of
`mcos_tpu/engine/autocallable.py`).

At observation dates t_1..t_m the note redeems early at notional + accrued
coupon if S_{t_i} >= autocall_barrier·S_0; if it survives to maturity it
pays notional + final coupon above the coupon barrier, notional between
the protection barrier and the coupon barrier, and notional·S_T/S_0 below
the protection barrier (the embedded down-and-in short put).

Shape on the card: `AutocallableEngine` reads the cliquet's period loop
(`simulate_period_log_returns`, no companion), `WorstOfAutocallableEngine`
the correlated basket's observation loop (`simulate_basket_observations`,
unit spots), and both reduce the (m, branches, paths) level cube with a
first-crossing argmax: no per-path Python, no early-exit control flow, no
kernel of the repo.

Oracles (host float64, GBM limit): with the autocall barrier unreachable
the note is a European digital structure with a closed form from
cash-or-nothing and asset-or-nothing pieces (`no_call_note_bs`, copied;
tests/test_torch_copies.py holds it equal to the JAX package's).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from scipy.stats import norm

from mcos_tpu_torch.config import DEFAULT_NUM_PATHS
from mcos_tpu_torch.engine.basket import (
    _cholesky_jittered,
    simulate_basket_observations,
)
from mcos_tpu_torch.engine.cliquet import simulate_period_log_returns
from mcos_tpu_torch.engine.pricer import resolve_mesh, seeded_generator
from mcos_tpu_torch.models.params import SVJParams, _stack_params


def no_call_note_bs(T: float, r: float, q: float, sigma: float,
                    coupon_barrier: float, protection_barrier: float,
                    final_coupon: float, notional: float = 1.0) -> float:
    """GBM closed form for the never-called terminal structure.

    Payoff on the gross return R = S_T/S_0:
        R >= cb:  1 + c
        pb <= R < cb:  1
        R < pb:  R
    Priced from digitals: P(R >= x) = Phi(d2(x)) and the partial
    expectation E[R 1{R < x}] = e^{(r-q)T} Phi(-d1(x)).
    """
    st = sigma * np.sqrt(T)
    mu = (r - q - 0.5 * sigma**2) * T

    def d2(x):
        return (mu - np.log(x)) / st

    def d1(x):
        return d2(x) + st

    p_above_cb = norm.cdf(d2(coupon_barrier))
    p_above_pb = norm.cdf(d2(protection_barrier))
    e_r_below_pb = np.exp((r - q) * T) * norm.cdf(-d1(protection_barrier))
    value = ((1.0 + final_coupon) * p_above_cb
             + (p_above_pb - p_above_cb)
             + e_r_below_pb)
    return float(notional * np.exp(-r * T) * value)


class AutocallableEngine:
    """Express/Phoenix note pricing with early-redemption accounting, on
    `device` (default the card); the paths come from a generator seeded
    with `seed`."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 steps_per_period: int = 16, seed: int = 42, *,
                 device="cuda"):
        self.params = params
        self.num_paths = int(num_paths)
        self.steps_per_period = int(steps_per_period)
        self.seed = int(seed)
        self.device = torch.device(device)

    def _draws(self, steps: int):
        """Replayed (z, u) for `steps` steps, or None: the simulator draws
        from the seeded generator. Tests override it."""
        return None

    def price(self, T: float, n_obs: int = 4,
              autocall_barrier: float = 1.0,
              coupon_barrier: float = 0.8,
              protection_barrier: float = 0.7,
              coupon: float = 0.02,
              final_coupon: float = None,
              notional: float = 1.0) -> Dict[str, object]:
        """Price the note; barriers are fractions of S_0, `coupon` accrues
        per observation period (paid on call: i-th call pays 1 + i*c).

        `final_coupon` defaults to n_obs * coupon (full accrual at
        maturity above the coupon barrier).
        """
        p = self.params
        if final_coupon is None:
            final_coupon = n_obs * coupon
        dlog_s, _ = simulate_period_log_returns(
            p, T, seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, n_periods=n_obs,
            steps_per_period=self.steps_per_period, companion=False,
            draws=self._draws(n_obs * self.steps_per_period),
            device=self.device)
        # Gross return level at each observation date: (m, 2, paths).
        ratio = torch.exp(torch.cumsum(dlog_s, dim=0))
        return _note_value(ratio, T, float(p.r), n_obs, autocall_barrier,
                           coupon_barrier, protection_barrier, coupon,
                           final_coupon, notional, self.num_paths)

    def solve_par_coupon(self, T: float, target: float = 1.0,
                         **terms) -> Dict[str, object]:
        """Coupon that prices the note at `target` (default par): exact
        from two evaluations on the same paths (`_solve_par_coupon`);
        `terms` are the `price` kwargs except `coupon`."""
        terms.pop("coupon", None)
        return _solve_par_coupon(
            lambda c: self.price(T, coupon=c, **terms), target)


def _note_path_values(ratio: torch.Tensor, T, r, n_obs, autocall_barrier,
                      coupon_barrier, protection_barrier, coupon,
                      final_coupon, notional):
    """(paths,) per-path discounted note values from (m, branches, paths)
    driving performance levels, antithetic branches collapsed; second
    return is (ever_called, first_index, r_T, dts) for the redemption
    accounting."""
    device = ratio.device
    called = ratio >= autocall_barrier                 # (m, 2, paths)
    ever = torch.any(called, dim=0)
    # First crossing index: argmax returns the first maximal index (torch
    # has no argmax of a bool tensor).
    first = torch.argmax(called.to(torch.int32), dim=0)    # (2, paths)

    obs = torch.arange(1, n_obs + 1, dtype=torch.float32, device=device)
    dts = T / n_obs * obs
    df = torch.exp(-torch.as_tensor(r, dtype=torch.float32,
                                    device=device) * dts)   # (m,)
    call_pay = df * (1.0 + coupon * obs)
    pay_called = call_pay[first]                       # (2, paths)

    r_T = ratio[-1]
    pay_final = torch.where(
        r_T >= coupon_barrier, torch.tensor(1.0 + final_coupon,
                                            device=device),
        torch.where(r_T >= protection_barrier,
                    torch.tensor(1.0, device=device), r_T)) * df[-1]
    pay = torch.where(ever, pay_called, pay_final)
    pay = notional * torch.mean(pay, dim=0)            # antithetic
    return pay, (ever, first, r_T, dts)


def _note_value(ratio: torch.Tensor, T, r, n_obs, autocall_barrier,
                coupon_barrier, protection_barrier, coupon, final_coupon,
                notional, num_paths) -> Dict[str, object]:
    """Reduce (m, branches, paths) driving performance levels to the note
    value + redemption accounting (shared by single-asset and worst-of)."""
    pay, (ever, first, r_T, dts) = _note_path_values(
        ratio, T, r, n_obs, autocall_barrier, coupon_barrier,
        protection_barrier, coupon, final_coupon, notional)
    # Redemption accounting: P(call at t_i), P(survive), P(loss).
    oh = (torch.nn.functional.one_hot(first.to(torch.int64), n_obs)
          .to(torch.float32) * ever[..., None])        # (2, paths, m)
    first_call = torch.mean(oh, dim=(0, 1))            # (m,)
    p_loss = torch.mean((~ever & (r_T < protection_barrier))
                        .to(torch.float32))
    life = torch.sum(first_call * dts) + (1.0 - first_call.sum()) * T
    stats = torch.cat([torch.stack([torch.mean(pay),
                                    torch.std(pay, correction=0), p_loss,
                                    life]), first_call]).cpu().numpy()
    mean, std, p_loss, life = (float(x) for x in stats[:4])
    first_call = np.asarray(stats[4:], np.float64)
    return {
        "price": mean,
        "std_error": std / np.sqrt(pay.shape[0]),
        "call_prob_by_date": first_call.tolist(),
        "survival_prob": float(1.0 - first_call.sum()),
        "loss_prob": p_loss,
        "expected_life": life,
        "n_obs": n_obs,
        "num_paths_used": num_paths,
    }


def _solve_par_coupon(price_fn, target: float = 1.0) -> Dict[str, object]:
    """The issuance question: which coupon prices the note at par?

    On a FIXED path set the note value is exactly linear in the coupon
    (every coupon cashflow scales with c, everything else is constant),
    so two evaluations on the same paths solve it in closed form. Each
    `price_fn` call seeds its own generator: the three calls see the same
    paths.
    """
    p0 = price_fn(0.0)
    p1 = price_fn(0.10)
    slope = (p1["price"] - p0["price"]) / 0.10
    if slope <= 1e-9:
        raise ValueError("note value does not increase in the coupon "
                         "(no feasible par coupon)")
    coupon = (target - p0["price"]) / slope
    check = price_fn(coupon)
    return {
        "par_coupon": float(coupon),
        "price_at_par_coupon": check["price"],
        "std_error": check["std_error"],
        "coupon_sensitivity": float(slope),
        **{k: check[k] for k in ("call_prob_by_date", "survival_prob",
                                 "loss_prob", "expected_life")},
    }


class WorstOfAutocallableEngine:
    """Worst-of autocallable on a correlated multi-asset SVJ basket: the
    trigger, coupon and capital-at-risk legs all read the WORST performer
    min_i S_i(t)/S_i(0). On `device` (default the card). mesh: None |
    "auto" | a `parallel.mesh.Mesh` (`resolve_mesh`); a resolved mesh
    shards `price` (`parallel/families.py:sharded_worstof_autocall`)."""

    def __init__(self, params_list: Sequence[SVJParams], corr,
                 num_paths: int = DEFAULT_NUM_PATHS,
                 steps_per_period: int = 16, seed: int = 42, mesh=None, *,
                 device="cuda"):
        self.mesh = mesh
        self.device = torch.device(device)
        self.params_batch = _stack_params(list(params_list))
        self.n_assets = len(params_list)
        corr = np.asarray(corr, np.float64)
        if corr.shape != (self.n_assets, self.n_assets):
            raise ValueError("corr must be (A, A)")
        # PSD-singular correlations (rho=1 blocks, the degenerate test
        # oracle) factor with escalating diagonal jitter, as BasketEngine.
        self.corr_chol = torch.as_tensor(_cholesky_jittered(corr),
                                         dtype=torch.float32,
                                         device=self.device)
        # One payoff currency ⇒ one discount rate: reject mixed r inputs
        # rather than silently discounting at asset 0's rate.
        rates = {float(np.asarray(p.r)) for p in params_list}
        if len(rates) > 1:
            raise ValueError("all basket assets must share the discount "
                             f"rate r; got {sorted(rates)}")
        self.r = rates.pop()
        self.num_paths = int(num_paths)
        self.steps_per_period = int(steps_per_period)
        self.seed = int(seed)

    def _draws(self, steps: int):
        """Replayed (z, u) for `steps` steps, or None: the simulator draws
        from the seeded generator. Tests override it."""
        return None

    def price(self, T: float, n_obs: int = 4,
              autocall_barrier: float = 1.0,
              coupon_barrier: float = 0.8,
              protection_barrier: float = 0.7,
              coupon: float = 0.02,
              final_coupon: float = None,
              notional: float = 1.0) -> Dict[str, object]:
        if final_coupon is None:
            final_coupon = n_obs * coupon
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu_torch.parallel.families import (
                sharded_worstof_autocall,
            )

            res = sharded_worstof_autocall(
                self, T, self.seed, mesh=mesh, n_obs=n_obs,
                autocall_barrier=autocall_barrier,
                coupon_barrier=coupon_barrier,
                protection_barrier=protection_barrier, coupon=coupon,
                final_coupon=final_coupon, notional=notional)
            res["price"] = float(res["price"])
            res["std_error"] = float(res["std_error"])
            res["num_paths_used"] = int(res["num_paths_used"])
            return res
        levels = simulate_basket_observations(
            self.params_batch, np.ones((self.n_assets,), np.float32),
            self.corr_chol, T, seeded_generator(self.seed, self.device),
            num_paths=self.num_paths, n_obs=n_obs,
            steps_per_period=self.steps_per_period,
            draws=self._draws(n_obs * self.steps_per_period),
            device=self.device)
        worst = torch.amin(levels, dim=2)        # (m, 2, paths)
        out = _note_value(worst, T, self.r, n_obs, autocall_barrier,
                          coupon_barrier, protection_barrier, coupon,
                          final_coupon, notional, self.num_paths)
        out["n_assets"] = self.n_assets
        return out

    def solve_par_coupon(self, T: float, target: float = 1.0,
                         **terms) -> dict:
        """Worst-of par coupon: exact from two evaluations on the same
        paths."""
        terms.pop("coupon", None)
        return _solve_par_coupon(
            lambda c: self.price(T, coupon=c, **terms), target)
