"""Reference for `POST /api/price` at the deployment's defaults: the Sobol
driver (antithetic, beta = 1 companion control), the 50-path viz recorder
and the 1 024-sample terminal histogram, recomputed in plain torch.

Every request of one maturity shares the engine's paths (the engine seed is
fixed; the log-spot process does not depend on the spot), so the reference
simulates each maturity once and prices every request from it.
"""

from __future__ import annotations

import json
import math
from collections import defaultdict

import numpy as np
import torch

from perfbench.reference import models, qmc


def _steps(cfg: dict, body: dict, T: float) -> int:
    per_year = body.get("num_steps") or cfg["steps_per_year"]
    return max(int(per_year * T), cfg["min_steps"])


def _viz_steps(cfg: dict, body: dict, T: float) -> int:
    per_year = body.get("num_steps") or cfg["steps_per_year"]
    return max(int(per_year * T), cfg["viz_min_steps"])


def _torch_draws(seed: int, steps: int, paths: int, device):
    """The (steps, 3, paths) normals and (steps, paths) uniforms a seeded
    torch generator draws on `device`, normals first."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.randn((steps, 3, paths), generator=gen, device=device,
                    dtype=torch.float32)
    u = torch.rand((steps, paths), generator=gen, device=device,
                   dtype=torch.float32)
    return z, u


def _maturity(cfg: dict, body: dict, T: float, device, dtype):
    """Log-terminals and log-paths shared by every request at maturity T
    (and the model parameters of `body`)."""
    p = body["params"]
    seed = cfg["engine_seed"]
    n = int(body["num_paths"])
    steps = _steps(cfg, body, T)
    z1, z2, zj = qmc.svj_sobol_draws(n, steps, seed, device, dtype)
    u = torch.as_tensor(qmc.jump_uniforms(steps, n, seed), device=device,
                        dtype=dtype)
    pt = models.tensors(p, dtype, device)
    Tt = torch.tensor(T, dtype=dtype, device=device)
    x, xg = models.svj_log_terminals(pt, Tt, z1, z2, u, zj)
    del z1, z2, zj, u
    z, uv = _torch_draws(seed + cfg["viz_seed_offset"],
                         _viz_steps(cfg, body, T), cfg["viz_paths"], device)
    viz = models.svj_recorded_log_paths(p, T, z.to(dtype), uv.to(dtype))
    z, uv = _torch_draws(seed + cfg["terminal_seed_offset"], steps,
                         cfg["terminal_samples"], device)
    zt = z.to(dtype)
    term, _ = models.svj_log_terminals(pt, Tt, zt[:, 0], zt[:, 1],
                                       uv.to(dtype), zt[:, 2])
    # The histogram is the base branch of one-branch paths.
    return {"x": x, "xg": xg, "viz": viz, "term": term[0], "pt": pt, "T": Tt}


def reference(cfg: dict, bodies: list, device, dtype=torch.float64) -> list:
    """`cfg`: the configuration's `engine` block. One dict per body:
    price, std_error, sample_paths (viz, steps + 1), terminal_samples (n,),
    the arrays float64 numpy."""
    by_T = defaultdict(list)
    for i, b in enumerate(bodies):
        by_T[(float(b["T"]), int(b["num_paths"]), b.get("num_steps") or 0,
              json.dumps(b["params"], sort_keys=True))].append(i)
    out = [None] * len(bodies)
    for (T, _, _, _), idx in sorted(by_T.items()):
        m = _maturity(cfg, bodies[idx[0]], T, device, dtype)
        pt = m["pt"]
        disc = torch.exp(-pt["r"] * m["T"])
        for i in idx:
            b = bodies[i]
            spot = torch.tensor(float(b["spot"]), dtype=dtype, device=device)
            strike = torch.tensor(float(b["strike"]), dtype=dtype,
                                  device=device)
            call = bool(b.get("is_call", True))
            pay = torch.mean(models.payoff(spot * torch.exp(m["x"]), strike,
                                           call), dim=0)
            ctrl = torch.mean(models.payoff(spot * torch.exp(m["xg"]), strike,
                                            call), dim=0)
            bs = models.black_scholes(spot, strike, m["T"], pt["r"], pt["q"],
                                      torch.sqrt(pt["v0"]), call)
            price, se = models.cv_price(pay, ctrl, bs, disc)
            paths = spot * torch.exp(m["viz"])
            paths = torch.cat([spot.expand(paths.shape[0], 1), paths], dim=1)
            out[i] = {
                "price": float(price), "std_error": float(se),
                "sample_paths": paths.double().cpu().numpy(),
                "terminal_samples": (spot * torch.exp(m["term"])).double()
                .cpu().numpy()}
        del m
    return out


def served(response: dict) -> dict:
    """The compared parts of a `/api/price` response."""
    return {k: response[k] for k in ("price", "std_error", "sample_paths",
                                      "terminal_samples")}


def compare(served: list, ref: list) -> dict:
    """The widest gaps over the requests: price in reference standard
    errors, the standard error relative, every viz and histogram value
    relative."""
    price_gap = se_gap = paths_gap = 0.0
    for got, want in zip(served, ref):
        se = want["std_error"]
        price_gap = max(price_gap, abs(got["price"] - want["price"]) / se)
        se_gap = max(se_gap, abs(got["std_error"] - se) / se)
        for key in ("sample_paths", "terminal_samples"):
            a = np.asarray(got[key], np.float64)
            b = want[key]
            if a.shape != b.shape:
                return {"price_gap_se": math.inf, "se_gap": math.inf,
                        "paths_gap": math.inf}
            paths_gap = max(paths_gap, float(np.max(np.abs(a - b) / b)))
    return {"price_gap_se": price_gap, "se_gap": se_gap,
            "paths_gap": paths_gap}
