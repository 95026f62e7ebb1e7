"""Reference for `POST /api/greeks` in single-contract mode: every
first-order block off the engine's seeded normals, recomputed in plain
torch with reverse-mode autograd, path block by path block.

- the control-variate price and its derivatives in spot (delta), maturity
  (theta = -dP/dT), v0 (vega), r (rho), sigma_J and mu_J, and the model
  block's kappa, theta, xi and rho (model risk);
- gamma: the central difference of the pathwise deltas at spot (1 +- 1 %)
  on the base paths;
- lambda: the central difference of prices at lambda +- 0.1 on the same
  draws.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import models

#: Path block of one forward and backward pass (memory, not arithmetic).
BLOCK = 1 << 18
#: (response block, key) pairs compared, the reference's name beside each.
FIELDS = (("gamma", "price_base", "price"), ("delta", "pathwise", "delta"),
          ("gamma", "gamma", "gamma"), ("vega", "ad_vega_v0", "vega"),
          ("theta", "theta_daily", "theta"), ("rho", "rho", "rho"),
          ("jumps", "sigma_j", "sigma_j"), ("jumps", "lambda_j", "lambda_j"))
#: (response block, key, name, model parameter) of the model-risk Greeks.
#: dP/dkappa, dxi and drho cross zero within the strikes a mix sends, so a
#: gap relative to their own value means nothing; each of these five is
#: held by its gap over the largest |reference| of that Greek among the
#: compared requests.
FLAT = (("model", "kappa", "d_kappa", "kappa"), ("model", "xi", "d_xi", "xi"),
        ("model", "rho_corr", "d_rho", "rho"),
        ("model", "theta", "d_theta", "theta"),
        ("jumps", "mu_j", "d_mu_j", "mu_j"))


def _draws(seed: int, steps: int, paths: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.randn((steps, 3, paths), generator=gen, device=device,
                    dtype=torch.float32)
    u = torch.rand((steps, paths), generator=gen, device=device,
                   dtype=torch.float32)
    return z, u


def _one(cfg: dict, body: dict, device, dtype) -> dict:
    T = float(body["T"])
    n = int(body["num_paths"])
    steps = max(int(cfg["steps_per_year"] * T), cfg["min_steps"])
    z, u = _draws(cfg["engine_seed"], steps, n, device)
    call = bool(body.get("is_call", True))
    strike = torch.tensor(float(body["strike"]), dtype=dtype, device=device)

    def leaf(x):
        return torch.tensor(float(x), dtype=dtype, device=device,
                            requires_grad=True)

    spot, Tt = leaf(body["spot"]), leaf(T)
    params = body["params"]
    p = models.tensors(params, dtype, device)
    for k in ("v0", "r", "sigma_j") + tuple(f[3] for f in FLAT):
        p[k] = leaf(params[k])
    wrt = [spot, Tt, p["v0"], p["r"], p["sigma_j"]] + [
        p[f[3]] for f in FLAT]
    grads = [torch.zeros((), dtype=dtype, device=device) for _ in wrt]
    price = torch.zeros((), dtype=dtype, device=device)
    xs, xgs = [], []
    bumped = {}
    for lo in range(0, n, BLOCK):
        blk = slice(lo, min(lo + BLOCK, n))
        zb = z[:, :, blk].to(dtype)
        ub = u[:, blk].to(dtype)
        with torch.enable_grad():
            x, xg = models.svj_log_terminals(p, Tt, zb[:, 0], zb[:, 1], ub,
                                             zb[:, 2])
            disc = torch.exp(-p["r"] * Tt)
            part = disc * (torch.sum(torch.mean(models.payoff(
                spot * torch.exp(x), strike, call), dim=0))
                - torch.sum(torch.mean(models.payoff(
                    spot * torch.exp(xg), strike, call), dim=0))) / n
            for i, g in enumerate(torch.autograd.grad(part, wrt,
                                                      allow_unused=True)):
                if g is not None:
                    grads[i] = grads[i] + g
        price = price + part.detach()
        xs.append(x.detach())
        xgs.append(xg.detach())
        with torch.no_grad():
            for lam in (params["lambda_j"] + 0.1,
                        max(params["lambda_j"] - 0.1, 0.0)):
                pl = dict(p, lambda_j=torch.tensor(lam, dtype=dtype,
                                                   device=device))
                xl, xgl = models.svj_log_terminals(
                    pl, Tt.detach(), zb[:, 0], zb[:, 1], ub, zb[:, 2])
                s0 = spot.detach()
                bumped[lam] = bumped.get(lam, 0.0) + disc.detach() * (
                    torch.sum(torch.mean(models.payoff(
                        s0 * torch.exp(xl), strike, call), dim=0))
                    - torch.sum(torch.mean(models.payoff(
                        s0 * torch.exp(xgl), strike, call), dim=0))) / n
    with torch.enable_grad():
        bs = models.black_scholes(spot, strike, Tt, p["r"], p["q"],
                                  torch.sqrt(p["v0"]), call)
        for i, g in enumerate(torch.autograd.grad(bs, wrt,
                                                  allow_unused=True)):
            if g is not None:
                grads[i] = grads[i] + g
    price = price + bs.detach()
    x, xg = torch.cat(xs, dim=1), torch.cat(xgs, dim=1)

    def delta_at(s):
        s = torch.tensor(s, dtype=dtype, device=device, requires_grad=True)
        with torch.enable_grad():
            disc = torch.exp(-p["r"].detach() * Tt.detach())
            val = disc * (torch.mean(models.payoff(s * torch.exp(x), strike,
                                                   call))
                          - torch.mean(models.payoff(s * torch.exp(xg),
                                                     strike, call))) \
                + models.black_scholes(s, strike, Tt.detach(),
                                       p["r"].detach(), p["q"],
                                       torch.sqrt(p["v0"].detach()), call)
            return torch.autograd.grad(val, [s])[0]

    s0 = float(body["spot"])
    gamma = (delta_at(s0 * 1.01) - delta_at(s0 * 0.99)) / (0.02 * s0)
    lam_up, lam_dn = sorted(bumped, reverse=True)
    d_lambda = (bumped[lam_up] - bumped[lam_dn] + 0.0) / (lam_up - lam_dn)
    vals = {"price": price, "delta": grads[0], "theta": -grads[1],
            "vega": grads[2], "rho": grads[3], "sigma_j": grads[4],
            "gamma": gamma, "lambda_j": d_lambda}
    for f, g in zip(FLAT, grads[5:]):
        vals[f[2]] = g
    return {k: float(v) for k, v in vals.items()}


def reference(cfg: dict, bodies: list, device, dtype=torch.float64) -> list:
    return [_one(cfg, b, device, dtype) for b in bodies]


def served(response: dict) -> dict:
    """The compared numbers of an `/api/greeks` response, reference names."""
    return {f[2]: response[f[0]][f[1]] for f in FIELDS + FLAT}


def compare(served: list, ref: list) -> dict:
    """greeks_gap: the widest relative gap over the Greeks of FIELDS of
    every request; flat_greeks_gap: the widest gap of a Greek of FLAT over
    the largest |reference| of that Greek among the requests."""
    for got in served:
        if any(got.get(f[2]) is None or not math.isfinite(float(got[f[2]]))
               for f in FIELDS + FLAT):
            return {"greeks_gap": math.inf, "flat_greeks_gap": math.inf}
    gap = max((abs(float(got[f[2]]) - want[f[2]]) / abs(want[f[2]])
               if want[f[2]] != 0.0 else math.inf
               for f in FIELDS for got, want in zip(served, ref)),
              default=0.0)
    flat = 0.0
    for f in FLAT:
        scale = max((abs(w[f[2]]) for w in ref), default=0.0)
        for got, want in zip(served, ref):
            flat = max(flat, abs(float(got[f[2]]) - want[f[2]]) / scale
                       if scale > 0.0 else math.inf)
    return {"greeks_gap": gap, "flat_greeks_gap": flat}
