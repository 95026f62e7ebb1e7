"""Monte Carlo pricing runtime of the port
(counterpart of `mcos_tpu/engine/pricer.py`, serving slice).

- `mc_price_from_draws` prices European strikes off one draw set with the
  same estimator as the JAX package: antithetic pairs, the companion GBM
  control variate against `bs_price`, population-std standard errors, and
  the terminal-state diagnostics the post-price guards read.
  backend="cuda" runs kernel K1 (`ops/cuda_kernels.svj_terminal_from_draws`:
  the kernel for CUDA draws, its plain version for CPU draws);
  backend="torch" runs the step-loop twin `simulate_terminal_from_draws`.
- `MonteCarloEngine` is the stateful wrapper the HTTP layer builds per
  request, with the process-wide Sobol-draw LRU (keyed on the device too).

Every engine takes an explicit `device`. Only the Sobol driver with the
Euler scheme is ported; the PRNG driver, QE, importance sampling, RQMC and
sharding raise `NotImplementedError` naming their ROADMAP.md item.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import (
    DEFAULT_NUM_PATHS,
    DEFAULT_NUM_STEPS,
    scaled_steps,
)
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels, simulate
from mcos_tpu_torch.ops.bs import bs_price

#: Not yet ported: ROADMAP.md queue 1 item that will port each option.
NOT_PORTED = {
    "use_sobol=false": "ROADMAP.md queue 1, item 1 (PRNG price path)",
    "scheme=qe": "ROADMAP.md queue 1, item 2 (QE scheme)",
    "use_importance": "ROADMAP.md queue 1, item 1 (PRNG price path)",
    "rqmc_randomizations": "ROADMAP.md queue 1, item 1 (PRNG price path)",
    "mesh": "ROADMAP.md queue 1, item 7 (sharding over NCCL)",
}


def not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to mcos_tpu_torch yet: {NOT_PORTED[option]}")


# ─────────────────────────────────────────────────────────────────────────────
# Functional core
# ─────────────────────────────────────────────────────────────────────────────
def _payoff_table(s_final: torch.Tensor, strikes: torch.Tensor,
                  is_call: bool) -> torch.Tensor:
    """(n_branch, paths) terminal spots → antithetic-combined (K, paths)."""
    pay = simulate.vanilla_payoff(s_final[None], strikes[:, None, None],
                                  is_call)
    return simulate.combine_antithetic(pay.transpose(0, 1))


def _finalize_price(
    params: SVJParams, spot, strikes: torch.Tensor, T, discount,
    pay: torch.Tensor, s_final: torch.Tensor,
    g_final: Optional[torch.Tensor], is_call: bool, control_variate: bool,
    cv_mode: str, cv_beta: str = "one",
) -> Dict[str, torch.Tensor]:
    """Price/stderr/CV arithmetic (cv_beta "one" or per-strike "optimal")."""
    raw_mean, raw_se = simulate.mc_mean_stderr(pay)
    raw_price = discount * raw_mean
    out: Dict[str, torch.Tensor] = {
        "price": raw_price,
        "std_error": discount * raw_se,
        "raw_mc_price": raw_price,
    }
    if control_variate:
        device = pay.device
        sigma_bs = torch.sqrt(torch.tensor(params.v0, dtype=torch.float32,
                                           device=device))
        bs_ref = bs_price(spot, strikes, T, params.r, params.q, sigma_bs,
                          is_call, device=device)
        if cv_mode == "companion":
            ctrl = _payoff_table(g_final, strikes, is_call)
        elif cv_mode == "reference":
            ctrl = simulate.vanilla_payoff(s_final[0][None],
                                           strikes[:, None], is_call)
        else:
            raise ValueError(f"unknown cv_mode: {cv_mode!r}")

        if cv_beta == "optimal":
            ctrl_c = ctrl - torch.mean(ctrl, dim=-1, keepdim=True)
            var_c = torch.mean(ctrl_c**2, dim=-1)
            cov = torch.mean(
                (pay - torch.mean(pay, dim=-1, keepdim=True)) * ctrl_c, dim=-1)
            beta = torch.where(var_c > 1e-12,
                               cov / torch.clamp(var_c, min=1e-12),
                               torch.zeros_like(var_c))
            out["cv_beta"] = beta
        elif cv_beta == "one":
            beta = torch.ones_like(raw_price)
        else:
            raise ValueError(f"unknown cv_beta: {cv_beta!r}")

        ctrl_mc = discount * torch.mean(ctrl, dim=-1)
        out["price"] = raw_price - beta * (ctrl_mc - bs_ref)
        out["bs_cv_adjustment"] = ctrl_mc - bs_ref
        out["bs_ref"] = bs_ref
        cv_pay = pay - beta[:, None] * (ctrl - bs_ref[:, None] / discount)
        _, cv_se = simulate.mc_mean_stderr(cv_pay)
        out["std_error"] = discount * cv_se
    return out


def mc_price_from_draws(
    params: SVJParams, spot, strikes, T, z1: torch.Tensor, z2: torch.Tensor,
    u_jump: Optional[torch.Tensor], z_js: torch.Tensor, *, seed: int = 0,
    is_call: bool = True, antithetic: bool = True,
    control_variate: bool = True, cv_mode: str = "companion",
    cv_beta: str = "one", backend: str = "cuda", steps_major: bool = False,
    scheme: str = "euler",
) -> Dict[str, torch.Tensor]:
    """QMC / CRN pricing from externally supplied draws (on their device).

    backend="cuda": kernel K1, whose u_jump=None mode draws the jump
    uniforms in-kernel from Philox keyed on `seed`. backend="torch": the
    step-loop twin on (±z1, ±z2, u_jump, ±z_js); u_jump=None takes the same
    Philox stream (`cuda_kernels.philox_jump_uniforms`), so both backends
    price the same paths.

    Returns a dict of float32 tensors: price, std_error, raw_mc_price and,
    with the control variate, bs_ref and bs_cv_adjustment, each (K,); plus
    the scalars s_mean, v_mean, v_max and frac_nonfinite.
    """
    if scheme == "qe":
        raise not_ported("scheme=qe")
    if scheme != "euler":
        raise ValueError(f"unknown scheme: {scheme!r}")
    device = z1.device
    strikes = torch.atleast_1d(torch.as_tensor(strikes, dtype=torch.float32,
                                               device=device))
    want_g = control_variate and cv_mode == "companion"
    if backend == "cuda":
        s_final, v_all, g_final = cuda_kernels.svj_terminal_from_draws(
            params, spot, T, z1, z2, u_jump, z_js, seed=seed,
            antithetic=antithetic, companion=want_g, steps_major=steps_major)
        v_base = v_all[0]
    elif backend == "torch":
        if u_jump is None:
            num_steps, num_paths = (z1.shape if steps_major
                                    else z1.shape[::-1])
            u_jump = cuda_kernels.philox_jump_uniforms(num_steps, num_paths,
                                                       seed, device)
            if not steps_major:
                u_jump = u_jump.T
        s_base, v_base, g_base = simulate.simulate_terminal_from_draws(
            params, spot, T, z1, z2, u_jump, z_js, companion=want_g,
            steps_major=steps_major)
        if antithetic:
            s_anti, _, g_anti = simulate.simulate_terminal_from_draws(
                params, spot, T, -z1, -z2, u_jump, -z_js, companion=want_g,
                steps_major=steps_major)
            s_final = torch.stack([s_base, s_anti])
            g_final = torch.stack([g_base, g_anti]) if want_g else None
        else:
            s_final = s_base[None]
            g_final = g_base[None] if want_g else None
    else:
        raise ValueError(f"unknown backend: {backend!r}")
    discount = torch.exp(-params.r * torch.tensor(T, dtype=torch.float32,
                                                  device=device))
    pay = _payoff_table(s_final, strikes, is_call)
    out = _finalize_price(params, spot, strikes, T, discount, pay, s_final,
                          g_final, is_call, control_variate, cv_mode, cv_beta)
    out["s_mean"] = torch.mean(s_final)
    out["v_mean"] = torch.mean(v_base)
    out["v_max"] = torch.max(v_base)
    out["frac_nonfinite"] = torch.mean((~torch.isfinite(s_final)).float())
    return out


def to_host(res: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device→host copy for a whole result dict (one sync, not one per
    key)."""
    if not res:
        return {}
    flat = torch.cat([v.reshape(-1).float() for v in res.values()]).cpu()
    out, i = {}, 0
    for k, v in res.items():
        n = v.numel()
        out[k] = flat[i:i + n].numpy().reshape(tuple(v.shape))
        i += n
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Stateful wrapper (reference API surface)
# ─────────────────────────────────────────────────────────────────────────────
# Sobol draw sets shared across engine instances: the HTTP layer builds a
# fresh engine per request, and serving re-hits the same few
# (paths, steps, seed, device) shapes. Each slot holds 3 (steps, paths)
# float32 tensors on its device (~378 MB at 500k × 63). Guarded for the
# threaded HTTP server.
_SOBOL_DRAWS_CACHE: "OrderedDict" = OrderedDict()
_SOBOL_DRAWS_CACHE_MAX = 12
_SOBOL_DRAWS_LOCK = threading.Lock()


class MonteCarloEngine:
    """Counterpart of `mcos_tpu.engine.pricer.MonteCarloEngine` on `device`.

    backend: "cuda" (kernel K1 on CUDA draws, its plain version on CPU
    draws) or "torch" (the step-loop twin).
    """

    def __init__(
        self,
        params: SVJParams,
        num_paths: int = DEFAULT_NUM_PATHS,
        num_steps: int = DEFAULT_NUM_STEPS,
        seed: int = 42,
        use_sobol: bool = True,
        use_antithetic: bool = True,
        use_control_variate: bool = True,
        cv_mode: str = "companion",
        cv_beta: str = "one",
        scheme: str = "euler",
        backend: str = "cuda",
        mesh=None,
        dividends=None,
        rate_curve=None,
        *,
        device="cuda",
    ):
        if mesh is not None:
            raise not_ported("mesh")
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_sobol = bool(use_sobol)
        self.use_antithetic = bool(use_antithetic)
        self.use_control_variate = bool(use_control_variate)
        self.cv_mode = cv_mode
        self.cv_beta = cv_beta
        self.scheme = scheme
        self.backend = backend
        self.rate_curve = rate_curve
        self.dividends = dividends
        self.device = torch.device(device)

    # -- internals ------------------------------------------------------------
    def _sobol_draws(self, steps: int):
        key = (self.scheme, steps, self.num_paths, self.seed, str(self.device))
        with _SOBOL_DRAWS_LOCK:
            hit = _SOBOL_DRAWS_CACHE.get(key)
            if hit is not None:
                _SOBOL_DRAWS_CACHE.move_to_end(key)
                return hit
        from mcos_tpu_torch.ops.sobol import sobol_svj_draws

        draws = sobol_svj_draws(self.num_paths, steps, seed=self.seed,
                                layout="steps", jump_uniforms=False,
                                device=self.device)
        with _SOBOL_DRAWS_LOCK:
            _SOBOL_DRAWS_CACHE[key] = draws
            while len(_SOBOL_DRAWS_CACHE) > _SOBOL_DRAWS_CACHE_MAX:
                _SOBOL_DRAWS_CACHE.popitem(last=False)
        return draws

    def _steps(self, T: float) -> int:
        return scaled_steps(self.num_steps, T)

    def _params_T(self, T: float) -> SVJParams:
        """Per-maturity params: r replaced by the curve's flat equivalent
        (exact for terminal payoffs)."""
        if self.rate_curve is None:
            return self.params
        return self.params.replace(r=self.rate_curve.r_eff(float(T)))

    def _spot_eff(self, spot: float, T: float) -> float:
        """Dividend-adjusted spot for European pricing (raw spot if no
        schedule); ValueError when the dividend PV exceeds the spot."""
        if self.dividends is None:
            return float(spot)
        from mcos_tpu_torch.ops.dividends import effective_spot

        disc = (self.rate_curve.discount
                if self.rate_curve is not None else None)
        eff, _ = effective_spot(spot, self.dividends, float(self.params.r),
                                float(T), discount=disc)
        return eff

    def _price_result(self, spot, strikes, T,
                      is_call: bool) -> Dict[str, torch.Tensor]:
        if not self.use_sobol:
            raise not_ported("use_sobol=false")
        spot = self._spot_eff(spot, T)
        params = self._params_T(T)
        steps = self._steps(T)
        z1, z2, u_jump, z_js = self._sobol_draws(steps)
        return mc_price_from_draws(
            params, spot, strikes, T, z1, z2, u_jump, z_js, seed=self.seed,
            is_call=is_call, antithetic=self.use_antithetic,
            control_variate=self.use_control_variate, cv_mode=self.cv_mode,
            cv_beta=self.cv_beta, backend=self.backend,
            steps_major=True, scheme=self.scheme)

    # -- reference API ----------------------------------------------------------
    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True) -> Dict[str, float]:
        """Price one European option (one device→host copy)."""
        return self.format_price(
            to_host(self.price_device(spot, strike, T, is_call)), T)

    def price_device(self, spot: float, strike: float, T: float,
                     is_call: bool = True) -> Dict[str, torch.Tensor]:
        """Enqueue the price program; return the on-device result dict."""
        return self._price_result(spot, np.array([strike], np.float32), T,
                                  is_call)

    def format_price(self, res: Dict, T: float) -> Dict[str, float]:
        """Host-side formatting of a fetched `price_device` result."""
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "num_paths_used": self.num_paths,
            "num_steps": self._steps(T),
        }
        if self.use_control_variate:
            for key in ("bs_cv_adjustment", "bs_ref", "raw_mc_price"):
                if key in res:
                    out[key] = float(res[key][0])
        if self.dividends is not None:
            out["dividend_model"] = ("proportional-exact"
                                     if self.dividends.kind == "proportional"
                                     else "escrowed")
        for key in ("v_max", "frac_nonfinite"):
            if key in res:
                out[key] = float(res[key])
        return out

    def price_batch(self, spot: float, strikes: Sequence[float], T: float,
                    is_call: bool = True) -> list:
        """Price many strikes off one shared path set."""
        strikes = np.asarray(strikes, np.float32)
        res = to_host(self._price_result(spot, strikes, T, is_call))
        results = []
        for i, k in enumerate(strikes):
            row = {"strike": float(k), "price": float(res["price"][i]),
                   "std_error": float(res["std_error"][i])}
            if self.use_control_variate:
                row["bs_ref"] = float(res["bs_ref"][i])
            results.append(row)
        return results

    def _generator(self, offset: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + offset)
        return gen

    def sample_paths_device(self, spot: float, T: float,
                            num_samples: int = 50) -> torch.Tensor:
        """The viz-path recorder (≥ 50 steps), on device, unsynced."""
        steps = max(int(self.num_steps * T), 50)
        return simulate.simulate_paths_recorded(
            self._params_T(T), self._spot_eff(spot, T), T,
            self._generator(999), num_paths=int(num_samples),
            num_steps=steps, device=self.device)

    def terminal_samples_device(self, spot: float, T: float,
                                num_samples: int = 1024) -> torch.Tensor:
        """A small sample of terminal spots for the histogram, unsynced."""
        s_final, _, _ = simulate.simulate_terminal(
            self._params_T(T), self._spot_eff(spot, T), T,
            self._generator(1234), num_paths=int(num_samples),
            num_steps=self._steps(T), antithetic=False, device=self.device)
        return s_final[0]
