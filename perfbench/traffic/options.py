"""Generator `options`: single-contract option requests, drawn from the
seed. A mix (`perfbench/traffic/<mix>.json`) names this generator and gives
its parameters; the harness finds the module by that name.

The requests come in blocks whose make-up is fixed (`expiry_per_block` of
each of `expiry_days`, `calls_per_block` calls), shuffled within the block
by the seed, so every seed offers the same work in another order; spots and
strikes are drawn per request:

- spot: the configuration's spot times 1 + U(spot_rel), to the cent;
- strike: uniform over the strike grid's points within strike_rel of spot;
- T: expiry days over the day count.

The body is the configuration's fixed body of the route, the mix's
`request` fields over it, then the contract.
"""

from __future__ import annotations

import math

import numpy as np


def _block(mix: dict) -> tuple:
    days = [d for d, k in zip(mix["expiry_days"], mix["expiry_per_block"])
            for _ in range(k)]
    calls = mix["calls_per_block"]
    if not 0 <= calls <= len(days):
        raise ValueError("calls_per_block must lie in [0, block size]")
    return days, [True] * calls + [False] * (len(days) - calls)


def contract(rng: np.random.Generator, market: dict, mix: dict, days: int,
             is_call: bool) -> dict:
    lo, hi = mix["spot_rel"]
    spot = round(market["spot"] * (1.0 + rng.uniform(lo, hi)), 2)
    grid = market["strike_grid"]
    k_lo, k_hi = mix["strike_rel"]
    first = math.ceil(spot * (1.0 + k_lo) / grid)
    last = math.floor(spot * (1.0 + k_hi) / grid)
    strike = float(grid * rng.integers(first, last + 1))
    return {"spot": spot, "strike": strike, "T": days / market["day_count"],
            "is_call": bool(is_call)}


def body(config: dict, mix: dict, terms: dict) -> dict:
    out = dict(config["requests"][mix["route"]])
    out.update(mix.get("request", {}))
    out.update(terms)
    return out


def generate(config: dict, mix: dict, seed: int) -> list:
    """The run's request bodies, in the order the clients take them."""
    rng = np.random.default_rng(int(seed))
    days, calls = _block(mix)
    bodies = []
    for _ in range(mix["blocks"]):
        perm = rng.permutation(len(days))
        flags = rng.permutation(calls)
        for i, j in enumerate(perm):
            bodies.append(body(config, mix, contract(
                rng, config["market"], mix, days[j], flags[i])))
    return bodies


def warm_bodies(config: dict, mix: dict) -> list:
    """One at-the-money request of each expiry, a call and a put in turn:
    every shape the mix's requests take (a put's program is a call's)."""
    spot = config["market"]["spot"]
    grid = config["market"]["strike_grid"]
    atm = float(grid * round(spot / grid))
    return [body(config, mix, {"spot": spot, "strike": atm,
                               "T": d / config["market"]["day_count"],
                               "is_call": i % 2 == 0})
            for i, d in enumerate(sorted(set(mix["expiry_days"])))]


def length(body: dict) -> float:
    """A request's length, for the checked sample's longest: its maturity."""
    return float(body["T"])
