"""Reference for `POST /api/roughheston` in `price` mode: the lifted rough
Heston paths on the engine's seeded normals (one step's (2, paths) at a
time), antithetic pairs collapsed before the moments, the beta = 1 GBM
control at sigma = sqrt(v0), recomputed in plain torch. Every request of
one maturity shares the paths, so each maturity is simulated once."""

from __future__ import annotations

import math
from collections import defaultdict

import torch

from perfbench.reference import models


PARAMS = ("hurst", "lam", "theta", "nu", "rho", "v0", "r", "q")


def _steps(cfg: dict, T: float, per_year) -> int:
    n = max(max(int((per_year or cfg["steps_per_year"]) * T), 10),
            cfg["min_steps"])
    return -(-n // cfg["step_multiple"]) * cfg["step_multiple"]


def reference(cfg: dict, bodies: list, device, dtype=torch.float64) -> list:
    """`cfg`: the configuration's `engine` block. One dict per body:
    price, std_error."""
    by_T = defaultdict(list)
    for i, b in enumerate(bodies):
        by_T[(float(b["T"]), int(b["num_paths"]), int(b["n_factors"]),
              b.get("num_steps") or 0,
              tuple(float(b[k]) for k in PARAMS))].append(i)
    out = [None] * len(bodies)
    for (T, n, n_factors, per_year, values), idx in sorted(by_T.items()):
        p = dict(zip(PARAMS, values))
        steps = _steps(cfg, T, per_year)
        c, x = models.lifted_nodes(p["hurst"], T, n_factors,
                                   cfg["kernel_res_steps"])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(cfg["engine_seed"]))

        def draw(_t):
            return torch.randn((2, n), generator=gen, device=device,
                               dtype=torch.float32).to(dtype)

        xs, xg = models.lifted_log_terminals(p, T, steps, c, x, draw)
        Tt = torch.tensor(T, dtype=dtype, device=device)
        disc = math.exp(-p["r"] * T)
        for i in idx:
            b = bodies[i]
            spot = torch.tensor(float(b["spot"]), dtype=dtype, device=device)
            strike = torch.tensor(float(b["strike"]), dtype=dtype,
                                  device=device)
            call = bool(b.get("is_call", True))
            bs = models.black_scholes(
                spot, strike, Tt, torch.tensor(p["r"], dtype=dtype,
                                               device=device),
                torch.tensor(p["q"], dtype=dtype, device=device),
                torch.tensor(math.sqrt(p["v0"]), dtype=dtype, device=device),
                call)
            eff = torch.mean(models.payoff(spot * torch.exp(xs), strike, call)
                             - models.payoff(spot * torch.exp(xg), strike,
                                             call), dim=0) + bs / disc
            mean = torch.mean(eff)
            se = disc * torch.sqrt(torch.mean((eff - mean) ** 2) / n)
            out[i] = {"price": float(disc * mean), "std_error": float(se)}
    return out


def served(response: dict) -> dict:
    """The compared parts of a `/api/roughheston` price response."""
    return {k: response[k] for k in ("price", "std_error")}


def compare(served: list, ref: list) -> dict:
    """The widest gaps over the requests: price in reference standard
    errors, the standard error relative."""
    price_gap = se_gap = 0.0
    for got, want in zip(served, ref):
        se = want["std_error"]
        price_gap = max(price_gap, abs(got["price"] - want["price"]) / se)
        se_gap = max(se_gap, abs(got["std_error"] - se) / se)
    return {"price_gap_se": price_gap, "se_gap": se_gap}
