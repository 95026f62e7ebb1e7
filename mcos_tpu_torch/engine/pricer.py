"""Monte Carlo pricing runtime of the port
(counterpart of `mcos_tpu/engine/pricer.py`, serving slice).

Every pricer uses the JAX package's estimator: antithetic pairs, the
companion GBM control variate against `bs_price`, population-std standard
errors, and the terminal-state diagnostics the post-price guards read.

- `mc_price_from_draws` prices off one supplied draw set (the Sobol
  driver). backend="cuda" runs a kernel wrapper (the kernel for CUDA
  draws, its plain version for CPU draws): K1 `svj_terminal_from_draws`
  for scheme="euler", K5 `svj_terminal_qe_from_draws` for scheme="qe";
  backend="torch" runs the step-loop twins.
- `population_prices_from_draws` prices P parameter sets off one draw
  set with one K1 launch (the calibration's differential-evolution
  generations; the JAX package vmaps its objective over them).
- `mc_price_cuda` (counterpart of `mc_price_pallas`) prices off the
  in-kernel generator: K3 `svj_terminal` (Euler) or K4 `svj_terminal_qe`.
  `mc_price_core` is the same estimator on the torch twins and a
  `torch.Generator`.
- `mc_price_importance` (exponentially tilted dW₁) and `_convergence_core`
  (prefix-mean series) run as torch ops on the device, as the JAX package
  runs them as XLA scans: no kernel sits under them.
- `MonteCarloEngine` is the stateful wrapper the HTTP layer builds per
  request, with the process-wide Sobol-draw LRU (keyed on the device too).
- `price_term_structure` prices a strikes × maturities grid under a
  `TermStructureSVJ`, one PRNG engine (K3) per maturity.

Every engine takes an explicit `device`. `mesh=` (None, "auto" or a
`parallel.mesh.Mesh`, resolved by `resolve_mesh`) routes the serving
default estimator through `parallel/mesh.py`: the Sobol driver (Euler,
antithetic) through `sharded_sobol_price`, one K1 launch a shard on its
slice of the net, and the PRNG driver through `sharded_price`.
"""

from __future__ import annotations

import copy
import logging
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mcos_tpu_torch.config import (
    DEFAULT_NUM_PATHS,
    DEFAULT_NUM_STEPS,
    DEFAULT_TOLERANCE,
    MAX_PATHS,
    scaled_steps,
)
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels, simulate
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.utils import spans

# ─────────────────────────────────────────────────────────────────────────────
# Functional core
# ─────────────────────────────────────────────────────────────────────────────
def _payoff_table(s_final: torch.Tensor, strikes: torch.Tensor,
                  is_call: bool) -> torch.Tensor:
    """(..., n_branch, paths) terminal spots → antithetic-combined
    (..., K, paths)."""
    pay = simulate.vanilla_payoff(s_final[..., None, :, :],
                                  strikes[:, None, None], is_call)
    return simulate.combine_antithetic(pay.movedim(-2, 0))


def _control(params: SVJParams, spot, strikes: torch.Tensor, T,
             s_final: torch.Tensor, g_final: Optional[torch.Tensor],
             is_call: bool, cv_mode: str):
    """The control's (K, paths) payoffs and their exact value, the
    Black-Scholes price at √v0, (K,): the companion's payoffs, or with
    cv_mode="reference" the base branch's (biased; parity only)."""
    device = s_final.device
    # as_tensor keeps a tensor v0's graph (the Greeks' ∂/∂v0).
    sigma_bs = torch.sqrt(torch.as_tensor(params.v0, dtype=torch.float32,
                                          device=device))
    bs_ref = bs_price(spot, strikes, T, params.r, params.q, sigma_bs,
                      is_call, device=device)
    if cv_mode == "companion":
        ctrl = _payoff_table(g_final, strikes, is_call)
    elif cv_mode == "reference":
        ctrl = simulate.vanilla_payoff(s_final[0][None], strikes[:, None],
                                       is_call)
    else:
        raise ValueError(f"unknown cv_mode: {cv_mode!r}")
    return ctrl, bs_ref


def _cv_payoffs(pay: torch.Tensor, ctrl: torch.Tensor, bs_ref: torch.Tensor,
                discount, beta: torch.Tensor) -> torch.Tensor:
    """The CV-adjusted (K, paths) payoffs pay − β·(ctrl − BS/discount):
    what the standard error reads, and what a mesh shard pools."""
    return pay - beta[:, None] * (ctrl - bs_ref[:, None] / discount)


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
        ctrl, bs_ref = _control(params, spot, strikes, T, s_final, g_final,
                                is_call, cv_mode)
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
        _, cv_se = simulate.mc_mean_stderr(
            _cv_payoffs(pay, ctrl, bs_ref, discount, beta))
        out["std_error"] = discount * cv_se
    return out


def _companion_pairs(params, spot, strikes: torch.Tensor, T,
                     s_final: torch.Tensor, g_final: torch.Tensor,
                     is_call: bool):
    """β = 1 companion-CV payoffs of (2, paths) terminals with the pairs
    collapsed, (paths, K), with the Black-Scholes value and the discount:
    the estimator of the SVCJ and rough-Heston cores and of their mesh
    shards. Pairs collapse before the moments: the branches share jump
    draws and z² magnitudes, so their 2n values are not iid."""
    device = s_final.device
    discount = torch.exp(-params.r * torch.as_tensor(T, dtype=torch.float32,
                                                     device=device))
    sign = 1.0 if is_call else -1.0
    pay = torch.clamp(sign * (s_final[..., None] - strikes), min=0.0)
    g_pay = torch.clamp(sign * (g_final[..., None] - strikes), min=0.0)
    bs_ref = bs_price(spot, strikes, T, params.r, params.q,
                      torch.sqrt(torch.as_tensor(params.v0,
                                                 dtype=torch.float32,
                                                 device=device)),
                      is_call, device=device)
    eff = torch.mean(pay - g_pay, dim=0) + bs_ref / discount
    return eff, bs_ref, discount


def _check_scheme(scheme: str) -> None:
    if scheme not in ("euler", "qe"):
        raise ValueError(f"unknown scheme: {scheme!r}")


def _price_terminal(
    params: SVJParams, spot, strikes, T, s_final: torch.Tensor,
    v_final: torch.Tensor, g_final: Optional[torch.Tensor], is_call: bool,
    control_variate: bool, cv_mode: str, cv_beta: str,
) -> Dict[str, torch.Tensor]:
    """The estimator over terminal spots (n_branch, paths), plus the
    terminal-state diagnostics over `v_final`."""
    device = s_final.device
    strikes = torch.atleast_1d(torch.as_tensor(strikes, dtype=torch.float32,
                                               device=device))
    discount = torch.exp(-params.r * torch.as_tensor(T, dtype=torch.float32,
                                                     device=device))
    pay = _payoff_table(s_final, strikes, is_call)
    out = _finalize_price(params, spot, strikes, T, discount, pay, s_final,
                          g_final, is_call, control_variate, cv_mode, cv_beta)
    out["s_mean"] = torch.mean(s_final)
    out["v_mean"] = torch.mean(v_final)
    out["v_max"] = torch.max(v_final)
    out["frac_nonfinite"] = torch.mean((~torch.isfinite(s_final)).float())
    return out


def mc_price_core(
    params: SVJParams, spot, strikes, T, generator: torch.Generator, *,
    num_paths: int, num_steps: int, is_call: bool = True,
    antithetic: bool = True, control_variate: bool = True,
    cv_mode: str = "companion", cv_beta: str = "one", scheme: str = "euler",
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """European prices at one or many strikes off one path set of the torch
    twins (`simulate_terminal`, or `simulate_terminal_qe` for scheme="qe")
    driven by `generator`. Returns the keys of `mc_price_from_draws`."""
    _check_scheme(scheme)
    sim = (simulate.simulate_terminal_qe if scheme == "qe"
           else simulate.simulate_terminal)
    s_final, v_final, g_final = sim(
        params, spot, T, generator, num_paths, num_steps,
        antithetic=antithetic,
        companion=control_variate and cv_mode == "companion", device=device)
    return _price_terminal(params, spot, strikes, T, s_final, v_final,
                           g_final, is_call, control_variate, cv_mode,
                           cv_beta)


def mc_price_cuda(
    params: SVJParams, spot, strikes, T, seed: int, *, num_paths: int,
    num_steps: int, is_call: bool = True, antithetic: bool = True,
    control_variate: bool = True, cv_mode: str = "companion",
    cv_beta: str = "one", scheme: str = "euler", device="cuda",
) -> Dict[str, torch.Tensor]:
    """`mc_price_core` with terminal spots from the in-kernel generator
    (counterpart of `mc_price_pallas`): kernel K3 `svj_terminal`, or K4
    `svj_terminal_qe` for scheme="qe", keyed on `seed`. A CUDA `device`
    launches the kernel, the CPU runs its plain version."""
    _check_scheme(scheme)
    sim = (cuda_kernels.svj_terminal_qe if scheme == "qe"
           else cuda_kernels.svj_terminal)
    s_final, v_final, g_final = sim(
        params, spot, T, seed, num_paths=num_paths, num_steps=num_steps,
        antithetic=antithetic,
        companion=control_variate and cv_mode == "companion", device=device)
    return _price_terminal(params, spot, strikes, T, s_final, v_final,
                           g_final, is_call, control_variate, cv_mode,
                           cv_beta)


def mc_price_from_draws(
    params: SVJParams, spot, strikes, T, z1: torch.Tensor, z2: torch.Tensor,
    u_jump: Optional[torch.Tensor], z_js: torch.Tensor, *, seed: int = 0,
    is_call: bool = True, antithetic: bool = True,
    control_variate: bool = True, cv_mode: str = "companion",
    cv_beta: str = "one", backend: str = "cuda", steps_major: bool = False,
    scheme: str = "euler",
) -> Dict[str, torch.Tensor]:
    """QMC / CRN pricing from externally supplied draws (on their device).

    scheme="qe" reads the draw tuple as the QE layout (z1 slot = z_x
    log-spot normals, z2 slot = u_v variance-transition uniforms, see
    `ops/sobol.sobol_qe_draws`). backend="cuda": kernel K1 (Euler) or K5
    (QE), whose u_jump=None mode draws the jump uniforms in-kernel from
    Philox keyed on `seed`. backend="torch": the step-loop twins;
    u_jump=None takes the same Philox stream
    (`cuda_kernels.philox_jump_uniforms`), so both backends price the same
    paths.

    Returns a dict of float32 tensors: price, std_error, raw_mc_price and,
    with the control variate, bs_ref and bs_cv_adjustment, each (K,); plus
    the scalars s_mean, v_mean, v_max and frac_nonfinite.
    """
    _check_scheme(scheme)
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend: {backend!r}")
    want_g = control_variate and cv_mode == "companion"
    if backend == "cuda":
        kernel = (cuda_kernels.svj_terminal_qe_from_draws if scheme == "qe"
                  else cuda_kernels.svj_terminal_from_draws)
        s_final, v_all, g_final = kernel(
            params, spot, T, z1, z2, u_jump, z_js, seed=seed,
            antithetic=antithetic, companion=want_g, steps_major=steps_major)
    else:
        if u_jump is None:
            num_steps, num_paths = (z1.shape if steps_major
                                    else z1.shape[::-1])
            u_jump = cuda_kernels.philox_jump_uniforms(num_steps, num_paths,
                                                       seed, z1.device)
            if not steps_major:
                u_jump = u_jump.T
        if scheme == "qe":
            s_final, v_all, g_final = \
                simulate.simulate_terminal_qe_from_draws(
                    params, spot, T, z1, z2, u_jump, z_js,
                    antithetic=antithetic, companion=want_g,
                    steps_major=steps_major)
        else:
            s_final, v_all, g_final = _euler_twin_pair(
                params, spot, T, z1, z2, u_jump, z_js, antithetic, want_g,
                steps_major)
    return _price_terminal(params, spot, strikes, T, s_final, v_all[0],
                           g_final, is_call, control_variate, cv_mode,
                           cv_beta)


#: Device memory the population tail may hold at once: the payoff and
#: companion tables ((K, 2, paths) before the branch mean, two (K, paths)
#: after it: 16·K·paths bytes a member) of as many members as fit, and at
#: least one. At `/api/calibrate`'s default (11 strikes × 100 000 paths,
#: 17.6 MB a member) a generation of 24 is one chunk; at the schema's
#: largest (256 strikes × 2 000 000 paths, 8.2 GB a member) one member a
#: chunk, the one-member peak.
POPULATION_TAIL_BUDGET = 1 << 30


def population_prices_from_draws(
    members: Sequence[SVJParams], spot, strikes, T, z1: torch.Tensor,
    z2: torch.Tensor, u_jump: Optional[torch.Tensor], z_js: torch.Tensor,
    *, is_call: bool = True,
) -> torch.Tensor:
    """European prices of P parameter sets off one draw set, (P, K): the
    `price` of `mc_price_from_draws` (backend="cuda", antithetic, the
    companion control variate with β = 1) for every member at once, as the
    JAX package's vmapped calibration objective prices a generation.

    The draws are steps-major (num_steps, num_paths) with u_jump given, as
    the calibration stages them. One K1 launch for the population
    (`cuda_kernels.svj_terminal_from_draws_population`; its plain version
    for CPU draws), then the estimator over the last axis of (P, K, paths)
    tables, `bs_price` at σ = √v0 as a (P, 1) column. Only the price: no
    standard error and no diagnostics. The tables are built a chunk of
    members at a time within `POPULATION_TAIL_BUDGET`; the chunking does
    not change a bit.
    """
    s_all, _, g_all = cuda_kernels.svj_terminal_from_draws_population(
        members, spot, T, z1, z2, u_jump, z_js, antithetic=True,
        companion=True, steps_major=True)
    device = s_all.device
    strikes = torch.atleast_1d(torch.as_tensor(strikes, dtype=torch.float32,
                                               device=device))

    def column(name):
        return torch.as_tensor([getattr(p, name) for p in members],
                               dtype=torch.float32, device=device)[:, None]

    r, q, v0 = column("r"), column("q"), column("v0")
    T_t = torch.as_tensor(T, dtype=torch.float32, device=device)
    discount = torch.exp(-r * T_t)
    bs_ref = bs_price(spot, strikes, T, r, q, torch.sqrt(v0), is_call,
                      device=device)
    per_member = 16 * strikes.numel() * s_all.shape[-1]
    chunk = max(1, POPULATION_TAIL_BUDGET // per_member)
    prices = []
    for lo in range(0, s_all.shape[0], chunk):
        part = slice(lo, lo + chunk)
        raw_mc = discount[part] * torch.mean(
            _payoff_table(s_all[part], strikes, is_call), dim=-1)
        ctrl_mc = discount[part] * torch.mean(
            _payoff_table(g_all[part], strikes, is_call), dim=-1)
        prices.append(raw_mc - (ctrl_mc - bs_ref[part]))
    return torch.cat(prices)


def _euler_twin_pair(params, spot, T, z1, z2, u_jump, z_js, antithetic,
                     want_g, steps_major):
    """The Euler draws twin on (±z1, ±z2, u_jump, ±z_js), stacked as the
    kernel's (n_branch, paths) outputs."""
    branches = [simulate.simulate_terminal_from_draws(
        params, spot, T, z1, z2, u_jump, z_js, companion=want_g,
        steps_major=steps_major)]
    if antithetic:
        branches.append(simulate.simulate_terminal_from_draws(
            params, spot, T, -z1, -z2, u_jump, -z_js, companion=want_g,
            steps_major=steps_major))
    s_final, v_all, g_rows = (list(x) for x in zip(*branches))
    return (torch.stack(s_final), torch.stack(v_all),
            torch.stack(g_rows) if want_g else None)


def mc_price_importance(
    params: SVJParams, spot, strikes, T, generator: torch.Generator, shift,
    *, num_paths: int, num_steps: int, is_call: bool = True,
    antithetic: bool = True, control_variate: bool = True, device="cuda",
) -> Dict[str, torch.Tensor]:
    """Importance-sampled European pricing (exponentially tilted dW₁,
    `simulate.simulate_terminal_tilted`), likelihood-ratio weighted. The
    companion control variate is taken on the weighted legs with the
    per-strike optimal β. Extra output `ess`, the Kish effective sample
    size (Σw)²/Σw² of the weights."""
    s_final, v_final, g_final, log_w = simulate.simulate_terminal_tilted(
        params, spot, T, generator, shift, num_paths, num_steps,
        antithetic=antithetic, companion=control_variate, device=device)
    device = s_final.device
    strikes = torch.atleast_1d(torch.as_tensor(strikes, dtype=torch.float32,
                                               device=device))
    w = torch.exp(log_w)
    discount = torch.exp(-params.r * torch.tensor(T, dtype=torch.float32,
                                                  device=device))

    def weighted_table(terminal):
        pay = simulate.vanilla_payoff(terminal[None],
                                      strikes[:, None, None], is_call)
        return simulate.combine_antithetic((w[None] * pay).transpose(0, 1))

    wpay = weighted_table(s_final)
    raw_mean, raw_se = simulate.mc_mean_stderr(wpay)
    out: Dict[str, torch.Tensor] = {
        "price": discount * raw_mean,
        "std_error": discount * raw_se,
        "raw_mc_price": discount * raw_mean,
    }
    if control_variate:
        sigma_bs = torch.sqrt(torch.tensor(params.v0, dtype=torch.float32,
                                           device=device))
        bs_ref = bs_price(spot, strikes, T, params.r, params.q, sigma_bs,
                          is_call, device=device)
        ctrl = weighted_table(g_final)
        ctrl_c = ctrl - torch.mean(ctrl, dim=-1, keepdim=True)
        var_c = torch.mean(ctrl_c**2, dim=-1)
        cov = torch.mean(
            (wpay - torch.mean(wpay, dim=-1, keepdim=True)) * ctrl_c, dim=-1)
        beta = torch.where(var_c > 1e-12,
                           cov / torch.clamp(var_c, min=1e-12),
                           torch.zeros_like(var_c))
        ctrl_mc = discount * torch.mean(ctrl, dim=-1)
        out["price"] = out["raw_mc_price"] - beta * (ctrl_mc - bs_ref)
        out["bs_ref"] = bs_ref
        out["cv_beta"] = beta
        cv_pay = wpay - beta[:, None] * (ctrl - bs_ref[:, None] / discount)
        _, cv_se = simulate.mc_mean_stderr(cv_pay)
        out["std_error"] = discount * cv_se
    w_flat = w.reshape(-1)
    out["ess"] = (torch.sum(w_flat) ** 2
                  / torch.clamp(torch.sum(w_flat**2), min=1e-30))
    out["v_max"] = torch.max(v_final)
    out["frac_nonfinite"] = torch.mean((~torch.isfinite(s_final)).float())
    return out


def _convergence_core(
    params: SVJParams, spot, strike, T, generator: torch.Generator, *,
    num_paths: int, num_steps: int, is_call: bool, antithetic: bool,
    counts: Sequence[int], device="cuda",
):
    """Prefix-mean convergence series on the device: checkpoint k reports
    the mean and standard error of the first counts[k] payoffs. Payoffs are
    centred on the full-sample mean before the float32 cumulative sums, so
    the running sums stay O(√n·σ). Returns (prices, errors), (len(counts),)."""
    s_final, _, _ = simulate.simulate_terminal(
        params, spot, T, generator, num_paths, num_steps,
        antithetic=antithetic, device=device)
    pay = simulate.combine_antithetic(
        simulate.vanilla_payoff(s_final, strike, is_call))
    discount = torch.exp(torch.tensor(-params.r * T, dtype=torch.float32,
                                      device=pay.device))
    center = torch.mean(pay)
    c = pay - center
    csum = torch.cumsum(c, dim=0)
    csum_sq = torch.cumsum(c * c, dim=0)
    idx = torch.as_tensor(np.asarray(counts, np.int64) - 1,
                          device=pay.device)
    n = torch.as_tensor(np.asarray(counts, np.float32), device=pay.device)
    mean_c = csum[idx] / n
    var = torch.clamp(csum_sq[idx] / n - mean_c**2, min=0.0)
    return discount * (center + mean_c), discount * torch.sqrt(var / n)


def seeded_generator(seed: int, device) -> torch.Generator:
    """A `torch.Generator` on `device` seeded with `seed`: what drives a
    torch twin where a kernel takes the seed itself."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def has_not_drawn(generator: torch.Generator) -> bool:
    """Whether `generator` is still where its seed put it: a mesh seeds its
    shards from the seed, so only such a generator can be sharded."""
    return torch.equal(generator.get_state(), seeded_generator(
        generator.initial_seed(), generator.device).get_state())


@spans.traced("host.sync")
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


# One process-wide auto mesh (largest power-of-two prefix of the CUDA
# devices), built at the first sharded price. [None] = "computed, one
# device".
_AUTO_MESH: list = []


def _auto_mesh():
    if not _AUTO_MESH:
        from mcos_tpu_torch.parallel import mesh as pmesh

        devs = pmesh._cuda_devices()
        n = 1 << (len(devs).bit_length() - 1) if devs else 0
        _AUTO_MESH.append(pmesh.make_mesh(devs[:n]) if n >= 2 else None)
    return _AUTO_MESH[0]


def resolve_mesh(mesh):
    """None | "auto" | Mesh → Mesh | None (one device).

    Shared by every engine that honours the MCOS_AUTO_MESH=1 serving
    toggle: None consults the toggle; "auto" resolves to the process-wide
    mesh over the largest power-of-two prefix of the CUDA devices, or None
    with fewer than two (one H100: None)."""
    import os

    if mesh is None and os.environ.get("MCOS_AUTO_MESH") == "1":
        mesh = "auto"
    if mesh == "auto":
        mesh = _auto_mesh()
    return mesh


class MonteCarloEngine:
    """Counterpart of `mcos_tpu.engine.pricer.MonteCarloEngine` on `device`.

    backend: "cuda" (the kernels: K1/K5 on the Sobol draws, K3/K4 with
    use_sobol=False; their plain versions on the CPU) or "torch" (the
    step-loop twins). mesh: None (one device; MCOS_AUTO_MESH=1 makes it
    "auto"), "auto" or a `parallel.mesh.Mesh` with a "paths" axis; a
    resolved mesh shards the Sobol and PRNG drivers over its devices.
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
        self.mesh = mesh
        self.device = torch.device(device)

    # -- internals ------------------------------------------------------------
    def _resolved_mesh(self):
        """The pricing mesh, or None for the single-device path."""
        return resolve_mesh(self.mesh)

    def _sobol_draws(self, steps: int):
        key = (self.scheme, steps, self.num_paths, self.seed, str(self.device))
        with _SOBOL_DRAWS_LOCK:
            hit = _SOBOL_DRAWS_CACHE.get(key)
            if hit is not None:
                _SOBOL_DRAWS_CACHE.move_to_end(key)
        if hit is not None:
            spans.count("sobol_cache_hits")
            return hit
        spans.count("sobol_cache_misses")
        from mcos_tpu_torch.ops.sobol import sobol_qe_draws, sobol_svj_draws

        with spans.span("sobol.build"):
            if self.scheme == "qe":
                draws = sobol_qe_draws(self.num_paths, steps,
                                       seed=self.seed, jump_uniforms=False,
                                       device=self.device)
            else:
                draws = sobol_svj_draws(self.num_paths, steps,
                                        seed=self.seed, layout="steps",
                                        jump_uniforms=False,
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
        spot = self._spot_eff(spot, T)
        params = self._params_T(T)
        steps = self._steps(T)
        mesh = self._resolved_mesh()
        if mesh is not None and self.cv_beta == "one" \
                and self.cv_mode == "companion":
            # Path-sharded pricing, routed as the reference routes it: the
            # serving-default estimator only; other configurations (optimal
            # β, reference-parity CV, QE × Sobol, no antithetic Sobol) fall
            # through to the single-device drivers below.
            from mcos_tpu_torch.parallel import mesh as pmesh

            if self.use_sobol and self.scheme != "qe" \
                    and self.use_antithetic:
                return pmesh.sharded_sobol_price(
                    params, spot, strikes, T, mesh=mesh,
                    num_paths=self.num_paths, num_steps=steps,
                    seed=self.seed, is_call=is_call,
                    control_variate=self.use_control_variate,
                    backend=self.backend)
            if not self.use_sobol:
                return pmesh.sharded_price(
                    params, spot, strikes, T, self.seed, mesh=mesh,
                    num_paths=self.num_paths, num_steps=steps,
                    is_call=is_call, antithetic=self.use_antithetic,
                    control_variate=self.use_control_variate,
                    cv_mode=self.cv_mode, scheme=self.scheme,
                    backend=self.backend)
        if self.use_sobol:
            z1, z2, u_jump, z_js = self._sobol_draws(steps)
            return mc_price_from_draws(
                params, spot, strikes, T, z1, z2, u_jump, z_js,
                seed=self.seed, is_call=is_call,
                antithetic=self.use_antithetic,
                control_variate=self.use_control_variate,
                cv_mode=self.cv_mode, cv_beta=self.cv_beta,
                backend=self.backend, steps_major=True, scheme=self.scheme)
        return self._prng_price(params, spot, strikes, T, self.seed,
                                self.num_paths, steps, is_call)

    def _prng_price(self, params, spot, strikes, T, seed: int,
                    num_paths: int, steps: int,
                    is_call: bool) -> Dict[str, torch.Tensor]:
        """The PRNG driver: K3/K4 keyed on `seed` (backend="cuda"), or the
        torch twins on a generator seeded with it (backend="torch")."""
        kwargs = dict(num_paths=num_paths, num_steps=steps, is_call=is_call,
                      antithetic=self.use_antithetic,
                      control_variate=self.use_control_variate,
                      cv_mode=self.cv_mode, cv_beta=self.cv_beta,
                      scheme=self.scheme, device=self.device)
        if self.backend == "cuda":
            return mc_price_cuda(params, spot, strikes, T, seed, **kwargs)
        if self.backend == "torch":
            return mc_price_core(params, spot, strikes, T,
                                 self._seeded(seed), **kwargs)
        raise ValueError(f"unknown backend: {self.backend!r}")

    # -- reference API ----------------------------------------------------------
    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True) -> Dict[str, float]:
        """Price one European option (one device→host copy)."""
        return self.format_price(
            to_host(self.price_device(spot, strike, T, is_call)), T)

    @spans.traced("program.price")
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
            "num_paths_used": int(np.asarray(
                res.get("num_paths_used", self.num_paths))),
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

    def price_to_tolerance(self, spot: float, strike: float, T: float,
                           is_call: bool = True,
                           tolerance: float = DEFAULT_TOLERANCE,
                           max_paths: int = MAX_PATHS,
                           batch_paths: int = 250_000) -> Dict[str, float]:
        """Adaptive pricing: add path batches until stderr/price ≤ tolerance.

        Batches double in size (powers of two from `batch_paths`) up to
        `max_paths` and combine by exact moment pooling. Each batch runs the
        PRNG driver with its own seed, (seed·1 000 003 + 7919·batch) mod 2³¹,
        so batches are independent; a Sobol net chopped into batches loses
        its equidistribution, so use_sobol=True is logged and ignored here.
        One device→host copy per batch: the loop reads each batch's error.
        """
        if self.use_sobol:
            logging.getLogger("mcos_tpu_torch.pricer").info(
                "price_to_tolerance uses independent PRNG batches; the "
                "engine's Sobol driver does not batch soundly")
        spot = self._spot_eff(spot, T)
        params = self._params_T(T)
        steps = self._steps(T)
        strikes = np.array([strike], np.float32)
        total_n, batches = 0, 0
        sum_mean = sum_sq = 0.0     # Σ nᵢ·meanᵢ, Σ nᵢ·E[x²]ᵢ
        price = se = 0.0
        bs_ref = None
        n_next = 1 << max(int(np.ceil(np.log2(max(batch_paths, 1024)))), 10)
        while total_n < max_paths:
            n_batch = min(n_next, max_paths - total_n)
            n_next *= 2
            batch_seed = (self.seed * 1_000_003 + 7919 * batches) \
                & 0x7FFFFFFF
            res = self._prng_price(params, spot, strikes, T, batch_seed,
                                   n_batch, steps, is_call)
            res = to_host({k: res[k] for k in ("price", "std_error",
                                               "bs_ref") if k in res})
            p_i, se_i = float(res["price"][0]), float(res["std_error"][0])
            if bs_ref is None and "bs_ref" in res:
                bs_ref = float(res["bs_ref"][0])
            sum_mean += n_batch * p_i
            sum_sq += n_batch * (n_batch * se_i**2 + p_i**2)
            total_n += n_batch
            batches += 1
            price = sum_mean / total_n
            se = (max(sum_sq / total_n - price**2, 0.0) / total_n) ** 0.5
            if price > 0 and se / price <= tolerance:
                break
        out = {
            "price": price,
            "std_error": se,
            "num_paths_used": total_n,
            "num_steps": steps,
            "num_batches": batches,
            "tolerance_met": bool(price > 0 and se / price <= tolerance),
        }
        if bs_ref is not None:
            out["bs_ref"] = bs_ref
        return out

    def price_importance_device(self, spot: float, strike: float, T: float,
                                is_call: bool = True,
                                shift: Optional[float] = None):
        """Enqueue the importance-sampled price program (tilt toward the
        strike, `shift=None` aims it with `simulate.optimal_tilt`); returns
        (the on-device result dict, the shift used)."""
        spot = self._spot_eff(spot, T)
        params = self._params_T(T)
        steps = self._steps(T)
        if shift is None:
            shift = simulate.optimal_tilt(params, spot, strike, T, steps)
        res = mc_price_importance(
            params, spot, np.array([strike], np.float32), T,
            self._seeded(self.seed), float(shift), num_paths=self.num_paths,
            num_steps=steps, is_call=is_call, antithetic=self.use_antithetic,
            control_variate=self.use_control_variate, device=self.device)
        return res, float(shift)

    def format_importance(self, res: Dict, T: float,
                          shift: float) -> Dict[str, float]:
        """Host-side formatting of a fetched importance result."""
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "num_paths_used": self.num_paths,
            "num_steps": self._steps(T),
            "tilt_shift": float(shift),
            "ess": float(res["ess"]),
        }
        if self.use_control_variate:
            out["bs_ref"] = float(res["bs_ref"][0])
            out["cv_beta"] = float(res["cv_beta"][0])
        return out

    def price_importance(self, spot: float, strike: float, T: float,
                         is_call: bool = True,
                         shift: Optional[float] = None) -> Dict[str, float]:
        """Importance-sampled price for far-from-the-money strikes: the
        spot Brownian is tilted so the path cloud lands near the strike and
        every path is reweighted by the exact likelihood ratio. Honors the
        engine's antithetic and control-variate settings."""
        res, shift = self.price_importance_device(spot, strike, T, is_call,
                                                  shift)
        return self.format_importance(to_host(res), T, shift)

    def price_rqmc_device(self, spot: float, strike: float, T: float,
                          is_call: bool = True,
                          randomizations: int = 8) -> Dict[str, torch.Tensor]:
        """Enqueue R independently Owen-scrambled Sobol prices (seeds
        seed + 7919·r, the engine's scheme: K1 or K5 on the card); returns
        {"price": (R,)[, "bs_ref": (1,)]} on device."""
        if randomizations < 2:
            raise ValueError("randomizations must be ≥ 2 for an error bar")
        prices, bs_ref = [], None
        for rep in range(randomizations):
            eng = copy.copy(self)
            eng.seed = self.seed + 7919 * rep
            eng.use_sobol = True
            res = eng.price_device(spot, strike, T, is_call)
            prices.append(res["price"][0])
            bs_ref = res.get("bs_ref", bs_ref)
        out = {"price": torch.stack(prices)}
        if bs_ref is not None:
            out["bs_ref"] = bs_ref
        return out

    def format_rqmc(self, res: Dict) -> Dict[str, float]:
        """The replicates' mean, with their spread / √R as the standard
        error (the honest QMC error bar)."""
        arr = np.asarray(res["price"], np.float64)
        r = arr.size
        out = {
            "price": float(arr.mean()),
            "std_error": float(arr.std(ddof=1) / np.sqrt(r)),
            "randomizations": r,
            "num_paths_used": self.num_paths * r,
            "price_min": float(arr.min()),
            "price_max": float(arr.max()),
        }
        if "bs_ref" in res:
            out["bs_ref"] = float(res["bs_ref"][0])
        return out

    def price_rqmc(self, spot: float, strike: float, T: float,
                   is_call: bool = True,
                   randomizations: int = 8) -> Dict[str, float]:
        """Randomized-QMC price: R independent Owen scrambles of the same
        Sobol net give R iid unbiased estimates; one host copy for all."""
        return self.format_rqmc(to_host(self.price_rqmc_device(
            spot, strike, T, is_call, randomizations)))

    def convergence(self, spot: float, strike: float, T: float,
                    is_call: bool = True,
                    num_checkpoints: int = 12) -> Dict[str, list]:
        """The estimate at geometrically spaced path counts, from prefix
        means of ONE path set of the Euler twin (checkpoint k uses the
        first n_k paths), reduced on the device; one host copy."""
        counts = np.unique(np.geomspace(
            max(self.num_paths // (2 ** (num_checkpoints - 1)), 64),
            self.num_paths, num_checkpoints).astype(int))
        prices, errors = _convergence_core(
            self._params_T(T), self._spot_eff(spot, T), strike, T,
            self._seeded(self.seed), num_paths=self.num_paths,
            num_steps=self._steps(T), is_call=is_call,
            antithetic=self.use_antithetic,
            counts=tuple(int(n) for n in counts), device=self.device)
        host = to_host({"price": prices, "std_error": errors})
        return {
            "num_paths": counts.tolist(),
            "price": [float(x) for x in host["price"]],
            "std_error": [float(x) for x in host["std_error"]],
        }

    def _seeded(self, seed: int) -> torch.Generator:
        return seeded_generator(seed, self.device)

    @spans.traced("program.viz_paths")
    def sample_paths_device(self, spot: float, T: float,
                            num_samples: int = 50) -> torch.Tensor:
        """The viz-path recorder (≥ 50 steps), on device, unsynced."""
        steps = max(int(self.num_steps * T), 50)
        return simulate.simulate_paths_recorded(
            self._params_T(T), self._spot_eff(spot, T), T,
            self._seeded(self.seed + 999), num_paths=int(num_samples),
            num_steps=steps, device=self.device)

    def get_sample_paths(self, spot: float, T: float,
                         num_samples: int = 50) -> np.ndarray:
        """A few full paths for visualization, on the host
        (`sample_paths_device`: the PRNG twin, at least 50 steps)."""
        return self.sample_paths_device(spot, T, num_samples).cpu().numpy()

    def terminal_samples(self, spot: float, T: float,
                         num_samples: int = 1024) -> np.ndarray:
        """A small sample of terminal spots for a histogram, on the host."""
        return self.terminal_samples_device(spot, T,
                                            num_samples).cpu().numpy()

    @spans.traced("program.viz_terms")
    def terminal_samples_device(self, spot: float, T: float,
                                num_samples: int = 1024) -> torch.Tensor:
        """A small sample of terminal spots for the histogram (one branch,
        the engine's step count), on device, unsynced."""
        return simulate.simulate_terminal_samples(
            self._params_T(T), self._spot_eff(spot, T), T,
            self._seeded(self.seed + 1234), num_paths=int(num_samples),
            num_steps=self._steps(T), device=self.device)


def price_term_structure(ts, spot: float, strikes, maturities,
                         is_call: bool = True, num_paths: int = 100_000,
                         num_steps: int = 252, seed: int = 42, *,
                         device="cuda") -> list:
    """Price a strikes × maturities grid under a `TermStructureSVJ`: the
    maturity-interpolated `SVJParams` per expiry, each slice batch-priced
    off one shared path set of the PRNG driver (`use_sobol=False`), so one
    K3 `svj_terminal` launch per maturity on a CUDA device. Returns one
    dict per maturity with the strike rows."""
    out = []
    for T in maturities:
        params_t = ts.get_params_at_maturity(float(T))
        eng = MonteCarloEngine(params_t, num_paths=num_paths,
                               num_steps=num_steps, seed=seed,
                               use_sobol=False, device=device)
        out.append({
            "maturity": float(T),
            "params": params_t.as_dict(),
            "chain": eng.price_batch(spot, strikes, float(T), is_call),
        })
    return out
