"""Where a warm `/api/price` (or `/api/exotic`, `/api/hhw`, `/api/svcj`,
`/api/termsvj`, `/api/rough`, `/api/greeks`, `/api/smile`, `/api/stress`,
`/api/hedge`, `/api/var`, `/api/american`, `/api/pde`, `/api/calibrate`,
`/api/surface`, `/api/quotegreeks`, `/api/localvol`, `/api/slv`,
`/api/book`, `/api/pnl`, `/api/margin`, `/api/replicate`, `/api/exposure`,
`/api/volderivs`, `/api/modelrisk`, `/api/basket`, `/api/cliquet`,
`/api/quanto`, `/api/autocall`, `/api/roughheston`) or an `mlmc_price`
call spends its time on one CUDA device.

    python -m mcos_tpu_torch.profile_price
        [--route price|exotic|hhw|svcj|termsvj|rough|greeks|smile|stress|hedge|var|american|pde|calibrate|surface|quotegreeks|localvol|slv|book|pnl|margin|replicate|exposure|volderivs|modelrisk|basket|cliquet|quanto|autocall|roughheston]
        [--options JSON] [--reps N] [--out FILE] [--mlmc]

Calls the port's `handle_price` in process (coalescing off, so each call is
the solo path) on the default body (500k paths, T = 0.25 → 63 steps), with
the request fields in `--options` merged in (for example
'{"use_sobol": false}' or '{"scheme": "qe"}'), and prints one JSON object:

- `wall_ms`: median host wall time of a warm call (every call ends in a
  device→host copy, so the device work is inside it);
- `parts_ms`: the same call's pieces run alone and synchronised: a Sobol
  net for a new seed (direction numbers cached; only when the request uses
  the Sobol driver), the price program (the request's kernel + payoff
  table + control variate), the 50-path recorder and the 1024-path
  terminal sampler;
- `profile`: from `torch.profiler` over 5 warm calls, the device time
  per call summed over kernels, the number of kernel launches per call,
  the busy share (device time / wall time) and the top kernels by device
  time. If the profiler reports no device time, those fields say
  "not measured".

With `--route exotic` it calls `handle_exotic` on an arithmetic Asian at
the schema's default width (200k pairs, T = 0.25 → 63 steps; `--options`
merges in, for example '{"kind": "double_no_touch", "barrier": 24750,
"barrier_lo": 20250}'); `parts_ms` is then the whole handler and, for the
Asian body, the price program alone (kernel K6 + payoff + control variate +
the one device→host copy).

With `--route hhw`, `svcj`, `termsvj` or `rough` it calls that route's
handler on its schema defaults (`hhw`: 200k pairs × 128 steps, T = 1;
`svcj`: 200k pairs, T = 0.25 → 63 steps; `termsvj`: 200k pairs × 512
steps, T = 0.25, three segments; `rough`: 131 072 pairs × 128 steps,
T = 0.25, the exact sampler), mode "price" unless `--options` says
otherwise (for example '{"mode": "greeks"}', or '{"num_steps": 512,
"mode": "asian"}' for kernel K11); the handler is timed whole
(`wall_ms` over 4 × `--reps` calls, `profile` over `--reps`, default 5)
with one warm call's peak device memory, without `parts_ms`. A call of
many launches (a Greeks strike chain) wants fewer: the profiler's summary
takes time for every launch it recorded.
`--route greeks` and `--route smile` do the same for `handle_greeks`
(200k paths, T = 0.25 → 63 steps, every block of `all_greeks`; for
example '{"with_second_order": true, "T": 1.0}', or a strike chain,
'{"strike": 0, "strikes": [...]}') and `handle_smile`
(method "mc": 50k paths on the Sobol net, kernel K1; '{"method": "cos",
"with_density": true}' for the host COS smile).
`--route stress`, `hedge` and `var` do the same for the risk desk at the
schema defaults: `handle_stress` (100k pairs, T = 0.25 → 63 steps, the
report: one K3 launch for the spot axis and one a shocked vol member;
'{"mode":
"matrix"}' for the scenario cube), `handle_hedge` (500 scenarios, T = 0.25
→ 63 days, the gbm world and the BS delta; the premium one K3 launch at
50k pairs; for example '{"dynamics": "svj", "hedge": "mv_delta"}') and
`handle_var` (500k paths, a three-asset book at T = 0.05, the Gaussian
copula with Euler contributions, 32 steps; '{"copula": "student_t"}' for
the t-copula and its float64 betainc).
`--route american` and `pde` do the same for slice H at the schema
defaults: `handle_american` (a put, 200k paths, T = 1 → 64 steps, the
in-sample LSM; '{"with_bounds": true}' adds the training and evaluation
sheets and the 2048 × 128 dual, '{"with_greeks": true}' the autograd pass)
and `handle_pde` (the Heston ADI at 201 × 101 × 128, Craig-Sneyd;
'{"model": "bs"}' for the 1-D Crank-Nicolson grid, '{"american": true,
"with_boundary": true}' for the projected solve and its boundary surface).
No kernel of the repo runs on either: they are torch ops throughout.
`--route calibrate|surface|quotegreeks|localvol|slv` do the same for slice
I at the schema defaults on synthetic market data (`slice_i_body`):
`handle_calibrate` on an 11-strike call chain at 0.8-1.2 × the forward,
T = 0.5, priced by COS at `CHAIN_PARAMS` (100k paths × 50 steps, 24
members: one K1 launch a generation, then the Adam polish on the twin
under autograd), with `phases`: the differential evolution's and the
polish's wall time, launches and device time apart (`_calibrate_phases`);
`handle_surface` on a Black-Scholes chain of a known
smile (9 strikes × 3 maturities, SABR slice fits; '{"fit_ssvi": true}' adds
the SSVI fit); `handle_quotegreeks` (host float64; an 11-strike chain and
an ATM vanilla); `handle_localvol` (200k paths, 100 steps a year) and
`handle_slv` (200k paths × 128 steps, '{"mode": "barrier", "barrier":
120}' or '{"mode": "forward_start", "t1": 0.2}') on the smile's IV grid.
A default calibrate takes seconds: give it `--reps 1`.
`--route book|pnl|margin|replicate|exposure|volderivs|modelrisk` do the
same for the desk tools (slice J) at the schema defaults (`ROUTE_BODIES`):
`handle_book` (8 positions, 100k paths × 64 steps, the member twin under
autograd, no kernel), `handle_pnl` (host COS only), `handle_margin` (a
4-position book over two maturities, 200k pairs, 252 steps a year: three
K3 launches a maturity), `handle_replicate` (a digital at 200k pairs, T =
0.25 → 63 steps: one K6 launch, then the host lstsq), `handle_exposure`
(a two-asset netting set, 65 536 paths × 32 dates; '{"with_cva_delta":
true}' adds the autograd pass), `handle_volderivs` (a one-year variance
swap, 200k pairs × 252 steps; '{"kind": "vix_future", "T": 0.5,
"with_mc_check": true}' for the one K4 launch) and `handle_modelrisk` (an
OTM put under six models: one K7 launch, the rough exact sampler).
`--route basket|cliquet|quanto|autocall` do the same for the multi-asset
and path products (slice K; torch step loops, no kernel) at the schema
defaults (`ROUTE_BODIES`): `handle_basket` (a two-asset basket call,
200k paths × 64 steps, the geometric control; '{"american": true,
"payoff": "best_of"}' for the Bermudan's 9 rights × 8 sub-steps, with
'"with_bounds": true' for its bracket, 2048 outer × 64 inner paths),
`handle_cliquet` (4 periods × 16 steps), `handle_quanto` (64 steps) and
`handle_autocall` (4 observations × 16 steps; '{"params_list": [...],
"corr": [...]}' for a worst-of note).
`--route roughheston` does the same for rough Heston (slice L) at the
schema defaults (200k pairs, 24 factors, 8192 steps a year → 2048 steps at
T = 0.25, the lifted loop as torch ops, no kernel): the price, or
'{"mode": "greeks"}' for the AD delta pass and the six-member FD pass,
'{"mode": "smile"}' / '"skew"' / '"calibrate"' for the host COS oracle.
`--mlmc` profiles `mlmc_price` instead of a route: at eps = 1 on the
Bates parameters of `MLMC_SVJ` with up to 2^20 pairs a level (wall time,
levels and their paths; launches, device time and busy share under the
profiler), then a default call (eps = 0.05, up to 4 000 000 pairs a
level: wall time, levels and paths; its launches are not profiled).

Without a CUDA device it fails: no CPU number is reported as a device one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

BODY = {"spot": 22500.0, "strike": 22500.0, "T": 0.25}
EXOTIC_BODY = dict(BODY, kind="asian")
ROUTE_BODIES = {
    "hhw": {"spot": 22500.0, "strike": 22500.0, "T": 1.0},
    "svcj": {"spot": 22500.0, "T": 0.25},
    "termsvj": {"spot": 22500.0, "T": 0.25, "segments": [
        {"t_end": 0.08, "theta": 0.04, "xi": 0.5, "lambda_j": 1.0},
        {"t_end": 0.16, "theta": 0.06, "xi": 0.7, "lambda_j": 2.0},
        {"t_end": 0.25, "theta": 0.09, "xi": 0.9, "lambda_j": 4.0}]},
    "rough": {"spot": 22500.0, "T": 0.25},
    "greeks": {"spot": 22500.0, "strike": 22500.0, "T": 0.25},
    "smile": {"spot": 22500.0, "T": 0.25},
    "stress": {"spot": 22500.0, "strike": 22500.0, "T": 0.25},
    "hedge": {"spot": 22500.0, "strike": 22500.0, "T": 0.25},
    "var": {"spots": [100.0, 100.0, 100.0], "sigmas": [0.2, 0.35, 0.15],
            "weights": [0.4, 0.35, 0.25],
            "corr": [[1.0, 0.5, 0.1], [0.5, 1.0, 0.3], [0.1, 0.3, 1.0]],
            "T": 0.05},
    "american": {"spot": 100.0, "strike": 100.0, "T": 1.0, "is_call": False},
    "pde": {"spot": 100.0, "strike": 100.0, "T": 1.0},
    # The desk tools (slice J), each at its schema's widths.
    "book": {"spots": [22500.0] * 8,
             "strikes": [21000.0, 22000.0, 22500.0, 23000.0, 24000.0,
                         22500.0, 21500.0, 23500.0],
             "Ts": [0.1, 0.25, 0.25, 0.5, 1.0, 0.05, 0.5, 0.25],
             "is_calls": [True, True, False, True, True, False, False, True],
             "quantities": [1.0, -2.0, 1.0, 3.0, -1.0, 2.0, -1.0, 1.0]},
    "pnl": {"strike": 22500.0, "spot_old": 22500.0, "spot_new": 22275.0,
            "T_old": 0.25, "T_new": 0.25 - 1.0 / 252.0,
            "params_new": {"v0": 0.045, "theta": 0.042}},
    "margin": {"spot": 22500.0,
               "strikes": [21500.0, 22500.0, 23500.0, 22500.0],
               "Ts": [0.25, 0.25, 0.25, 0.5],
               "is_calls": [False, True, True, False],
               "quantities": [-2.0, -1.0, 1.0, -1.0]},
    "replicate": {"spot": 22500.0, "T": 0.25, "kind": "digital",
                  "strike": 22500.0},
    "exposure": {"spots": [22500.0, 1500.0], "sigmas": [0.18, 0.3],
                 "corr": [[1.0, 0.6], [0.6, 1.0]],
                 "positions": [{"kind": "call", "strike": 22500.0, "T": 1.0},
                               {"kind": "put", "strike": 1400.0, "T": 0.5,
                                "qty": -10.0, "asset": 1},
                               {"kind": "forward", "strike": 22000.0,
                                "T": 0.75, "qty": -0.5}]},
    "volderivs": {"kind": "variance_swap", "T": 1.0},
    "modelrisk": {"spot": 22500.0, "strike": 21500.0, "T": 0.25,
                  "is_call": False},
    # Multi-asset and path products (slice K), each at its schema's
    # widths: 200 000 paths, the basket's 64 steps a year (a two-asset
    # call at T = 1), the cliquet's and the autocall's 4 periods of 16
    # steps, the quanto's 64 steps.
    "basket": {"spots": [100.0, 100.0], "weights": [0.5, 0.5],
               "strike": 100.0, "T": 1.0,
               "corr": [[1.0, 0.5], [0.5, 1.0]]},
    "cliquet": {"T": 1.0},
    "quanto": {"spot": 100.0, "strike": 100.0, "T": 1.0},
    "autocall": {"T": 1.0},
    # Rough Heston (slice L) at its schema's widths.
    "roughheston": {"spot": 22500.0, "T": 0.25},
}
#: The Bates parameters of `--mlmc` (the JAX package's MLMC test's).
MLMC_SVJ = dict(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)


#: The SVJ model behind `/api/calibrate`'s synthetic chain.
CHAIN_PARAMS = dict(kappa=2.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.045,
                    lambda_j=0.8, mu_j=-0.08, sigma_j=0.12, r=0.065,
                    q=0.012)
SMILE_STRIKES = (80.0, 85.0, 90.0, 95.0, 100.0, 105.0, 110.0, 115.0, 120.0)
SMILE_MATS = (0.25, 0.5, 1.0)
SLICE_I_ROUTES = ("calibrate", "surface", "quotegreeks", "localvol", "slv")


def smile_iv(strikes=SMILE_STRIKES, mats=SMILE_MATS, spot: float = 100.0):
    """A skewed, convex IV grid (maturities × strikes)."""
    k = np.log(np.asarray(strikes, np.float64) / spot)
    t = np.asarray(mats, np.float64)
    return 0.2 - 0.12 * k[None, :] + 0.15 * k[None, :] ** 2 \
        + 0.02 * np.sqrt(t)[:, None]


def slice_i_body(route: str) -> dict:
    """The request body of a slice I route on synthetic market data (its
    other fields at the schema defaults)."""
    from mcos_tpu_torch.engine.surface import _bs_price_np
    from mcos_tpu_torch.models.params import SVJParams
    from mcos_tpu_torch.ops.cos_pricer import cos_price

    spot, r, q = 100.0, CHAIN_PARAMS["r"], CHAIN_PARAMS["q"]
    if route in ("calibrate", "quotegreeks"):
        strikes = spot * np.exp((r - q) * 0.5) * np.linspace(0.8, 1.2, 11)
        if route == "quotegreeks":
            return {"spot": spot, "T": 0.5, "strikes": strikes.tolist(),
                    "product": {"kind": "vanilla", "T": 0.5}}
        market = cos_price(SVJParams(**CHAIN_PARAMS), spot, strikes, 0.5)
        return {"spot": spot, "strikes": strikes.tolist(), "T": 0.5,
                "market_prices": np.asarray(market).tolist(), "r": r,
                "q": q}
    strikes = np.asarray(SMILE_STRIKES)
    iv = smile_iv()
    if route == "surface":
        mats = np.asarray(SMILE_MATS)[:, None]
        return {"spot": spot, "strikes": strikes.tolist(),
                "maturities": list(SMILE_MATS), "r": r, "q": q,
                "call_prices": _bs_price_np(spot, strikes, mats, r, q, iv,
                                            True).tolist(),
                "put_prices": _bs_price_np(spot, strikes, mats, r, q, iv,
                                           False).tolist()}
    return {"spot": spot, "strikes": strikes.tolist(),
            "maturities": list(SMILE_MATS), "iv": iv.tolist(),
            "price_strikes": [90.0, 95.0, 100.0, 105.0, 110.0], "T": 0.5,
            "r": r, "q": q}


def _wall_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(options: dict) -> dict:
    from mcos_tpu_torch.api import coalesce, schemas, server
    from mcos_tpu_torch.engine.pricer import MonteCarloEngine

    reps = 5
    device = torch.device("cuda", 0)
    body = dict(BODY, **options)
    coalesce.coalescer.window_s = 0.0
    server.warm(device)
    call = lambda: server.handle_price(dict(body), device=device)  # noqa
    call()
    out = {"device": torch.cuda.get_device_name(device), "body": body,
           "wall_ms": _wall_ms(call, 2 * reps)}

    req = schemas.PriceRequest(**body)
    params = req.params.to_params()
    kw = dict(num_paths=req.num_paths, use_sobol=req.use_sobol,
              scheme=req.scheme, device=device)
    eng = MonteCarloEngine(params, **kw)
    steps = eng._steps(req.T)
    seeds = iter(range(1000, 1000 + 4 * reps))

    def new_net():
        MonteCarloEngine(params, **dict(kw, seed=next(seeds)))._sobol_draws(
            steps)

    out["parts_ms"] = {
        "sobol_net_new_seed": (_wall_ms(new_net, reps) if req.use_sobol
                               else "not used"),
        "price_program": _wall_ms(
            lambda: eng.price_device(req.spot, req.strike, req.T), reps),
        "sample_paths_50": _wall_ms(
            lambda: eng.sample_paths_device(req.spot, req.T, 50), reps),
        "terminal_samples_1024": _wall_ms(
            lambda: eng.terminal_samples_device(req.spot, req.T), reps),
    }

    out["profile"] = _profiled(call, reps)
    return out


def profile_exotic(options: dict) -> dict:
    from mcos_tpu_torch.api import schemas, server
    from mcos_tpu_torch.engine.exotics import ExoticEngine

    reps = 5
    device = torch.device("cuda", 0)
    body = dict(EXOTIC_BODY, **options)
    server.warm(device)
    call = lambda: server.handle_exotic(dict(body), device=device)  # noqa
    call()
    out = {"device": torch.cuda.get_device_name(device), "body": body,
           "wall_ms": _wall_ms(call, 4 * reps), "parts_ms": {}}
    if body["kind"] == "asian":
        req = schemas.ExoticRequest(**body)
        eng = ExoticEngine(req.params.to_params(), num_paths=req.num_paths,
                           device=device)
        out["parts_ms"]["price_program"] = _wall_ms(
            lambda: eng.price_asian(req.spot, req.strike, req.T, req.is_call,
                                    averaging=req.averaging), 4 * reps)
    out["profile"] = _profiled(call, reps)
    return out


def profile_route(route: str, options: dict, reps: int = 5) -> dict:
    """A route handler other than `/api/price` and `/api/exotic`: the whole
    handler (median of 4 × `reps` calls, then
    `reps` under the profiler), and one call's peak device memory."""
    from mcos_tpu_torch.api import server

    device = torch.device("cuda", 0)
    body = dict(slice_i_body(route) if route in SLICE_I_ROUTES
                else ROUTE_BODIES[route], **options)
    handler = getattr(server, f"handle_{route}")
    server.warm(device)
    call = lambda: handler(dict(body), device=device)  # noqa
    call()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    call()
    torch.cuda.synchronize(device)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    out = {"device": torch.cuda.get_device_name(device), "body": body,
           "wall_ms": _wall_ms(call, 4 * reps),
           "peak_device_memory_gib": peak_gib}
    if route == "calibrate":
        out["phases"] = _calibrate_phases(call)
    out["profile"] = _profiled(call, reps)
    return out


def _calibrate_phases(call) -> dict:
    """A calibrate's differential evolution (both stages) and its Adam
    polish apart: each phase's wall ms, synchronised at its ends, over one
    call, and its kernel launches and device ms from a second call with
    the profiler around each phase alone; "other" is the rest of the
    first call's wall time (the chain's host work, the handler)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from mcos_tpu_torch.engine import calibration as cal

    real = {"de": cal.differential_evolution, "polish": cal.adam_polish}
    out = {k: {"calls": 0, "wall_ms": 0.0, "launches": 0,
               "device_ms": 0.0} for k in real}

    def timed(key, profiled):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not profiled:
                res = real[key](*a, **kw)
                torch.cuda.synchronize()
                out[key]["calls"] += 1
                out[key]["wall_ms"] += (time.perf_counter() - t0) * 1e3
                return res
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                res = real[key](*a, **kw)
                torch.cuda.synchronize()
            dev_ms, launches, _ = _kernel_stats(prof)
            out[key]["launches"] += launches
            out[key]["device_ms"] += dev_ms
            return res
        return run

    try:
        for profiled in (False, True):
            cal.differential_evolution = timed("de", profiled)
            cal.adam_polish = timed("polish", profiled)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            if not profiled:
                out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        cal.differential_evolution = real["de"]
        cal.adam_polish = real["polish"]
    out["other_wall_ms"] = (out["wall_ms"] - out["de"]["wall_ms"]
                            - out["polish"]["wall_ms"])
    return out


def _kernel_stats(prof):
    """(device ms, kernel launches, [(name, device ms, launches)] by device
    time) over a profile: its device-side events (kernels, copies,
    memsets) read straight from the trace. The profiler's own summary
    (`key_averages`) builds an event tree first, minutes for a few hundred
    thousand launches."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        ns = e.duration_ns()
        if ns > 0:
            row = by_name.setdefault(e.name(), [0.0, 0])
            row[0] += ns / 1e6
            row[1] += 1
    kernels = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                     key=lambda k: k[1], reverse=True)
    return (sum(k[1] for k in kernels), sum(k[2] for k in kernels),
            kernels)


def _profiled(call, reps: int) -> dict:
    """Device time, launches and busy share per call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    dev_ms, launches, kernels = _kernel_stats(prof)
    dev_ms, launches = dev_ms / reps, launches / reps
    return {
        "profiled_wall_ms": wall,
        "device_ms_per_call": dev_ms if kernels else "not measured",
        "kernel_launches_per_call": launches if kernels else "not measured",
        "busy_share": dev_ms / wall if kernels else "not measured",
        "top_kernels": [{"name": name[:90], "device_ms_per_call": ms / reps,
                         "launches_per_call": count / reps}
                        for name, ms, count in kernels[:8]],
    }


def profile_mlmc(reps: int = 1) -> dict:
    """`mlmc_price` at eps = 1 (profiled) and at its defaults (timed)."""
    from mcos_tpu_torch.engine.mlmc import mlmc_price
    from mcos_tpu_torch.models.params import SVJParams
    from mcos_tpu_torch.ops.cos_pricer import cos_price

    device = torch.device("cuda", 0)
    params = SVJParams(**MLMC_SVJ)
    spot, T = 22500.0, 0.25
    out = {"device": torch.cuda.get_device_name(device),
           "cos": float(cos_price(params, spot, [spot], T)[0])}
    for name, kw in (("eps_1", {"eps": 1.0, "max_paths_per_level": 1 << 20,
                                "seed": 3}),
                     ("default", {})):
        call = lambda kw=kw: mlmc_price(params, spot, spot, T,  # noqa
                                        device=device, **kw)
        if name == "eps_1":
            call()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize(device)
        out[name] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                     "kwargs": kw, **res,
                     "paths": [lv["n"] for lv in res["levels"]]}
        if name == "eps_1":
            out[name]["profile"] = _profiled(call, reps)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", default="price",
                        choices=("price", "exotic", *ROUTE_BODIES,
                                 *SLICE_I_ROUTES))
    parser.add_argument("--options", default="{}",
                        help="JSON object of request fields to merge into "
                             "the default body")
    parser.add_argument("--reps", type=int, default=5,
                        help="profiled calls of a route handler (its wall "
                             "time takes 4x as many)")
    parser.add_argument("--out", default=None, help="also write JSON here")
    parser.add_argument("--mlmc", action="store_true",
                        help="profile mlmc_price instead of a route")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_price needs a CUDA device")
    options = json.loads(args.options)
    if args.mlmc:
        res = profile_mlmc(args.reps)
    elif args.route in ROUTE_BODIES or args.route in SLICE_I_ROUTES:
        res = profile_route(args.route, options, args.reps)
    else:
        res = (profile if args.route == "price" else profile_exotic)(options)
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
