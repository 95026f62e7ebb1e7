"""Drive one run of a cell on the CPU at a small size, past the harness's
look for a card, optionally with the timed path broken underneath; print
the result line. Tests start it as a child process, so that no test
process's modules can trip the run's check for JAX.

    python3 perfbench/tests/cpu_run.py <workload> <seed> [--fault <fault>] \
        [--root <checkout>]

`--root` reads `BENCHMARK.json` and the cell's files from another checkout.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

#: Small sizes a CPU run can hold, per cell.
SMALL = {
    "svj_nifty.quote_c8": {"request": {"num_paths": 4096}, "clients": 3,
                           "blocks": 30},
    "rough_heston_lift.price_c2": {
        "request": {"num_paths": 2048, "num_steps": 2048}, "blocks": 6},
    "svj_nifty.greeks_wide_c2": {"request": {"num_paths": 8192},
                                 "blocks": 10},
}


def half_batch() -> None:
    """Every estimator takes its mean over the first half of the paths."""
    import torch

    from mcos_tpu_torch.engine import greeks, pricer, roughheston

    table = pricer._payoff_table
    pricer._payoff_table = lambda s, k, c: table(
        s, k, c)[..., : s.shape[-1] // 2]
    pairs = roughheston._companion_pairs

    def half_pairs(*args):
        eff, bs, disc = pairs(*args)
        return eff[: eff.shape[0] // 2], bs, disc

    roughheston._companion_pairs = half_pairs
    tables = greeks._tables

    def half_tables(s, g, k, c):
        pay, ctrl = tables(s, g, k, c)
        n = pay.shape[-1] // 2
        return pay[..., :n], None if ctrl is None else ctrl[..., :n]

    greeks._tables = half_tables
    del torch


def altered_answer() -> None:
    """Each engine's answer moved where it is made: a price by one of its
    standard errors, the pathwise delta by a thousandth."""
    from mcos_tpu_torch.engine import greeks, pricer, roughheston

    fmt = pricer.MonteCarloEngine.format_price

    def moved(self, res, T):
        out = fmt(self, res, T)
        out["price"] += out["std_error"]
        return out

    pricer.MonteCarloEngine.format_price = moved
    price = roughheston.RoughHestonEngine.price

    def moved_rh(self, *args, **kw):
        out = price(self, *args, **kw)
        out["price"] += out["std_error"]
        return out

    roughheston.RoughHestonEngine.price = moved_rh
    delta = greeks.GreeksEngine.delta

    def moved_delta(self, *args, **kw):
        out = delta(self, *args, **kw)
        out["pathwise"] *= 1.001
        return out

    greeks.GreeksEngine.delta = moved_delta


def zero_kappa_greek() -> None:
    """dP/dkappa returned as 0 where the model block is made, as a kappa
    cut off from the autograd graph would give."""
    from mcos_tpu_torch.engine import greeks

    model = greeks.GreeksEngine.model_sensitivities

    def zeroed(self, *args, **kw):
        out = model(self, *args, **kw)
        out["kappa"] = 0.0
        return out

    greeks.GreeksEngine.model_sensitivities = zeroed


FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer,
          "zero_kappa_greek": zero_kappa_greek}


def main() -> int:
    from perfbench import harness

    parser = argparse.ArgumentParser()
    parser.add_argument("workload")
    parser.add_argument("seed", type=int)
    parser.add_argument("--fault", choices=sorted(FAULTS))
    parser.add_argument("--root", default=harness.ROOT)
    args = parser.parse_args()
    if args.fault:
        FAULTS[args.fault]()
    result = harness.run_cell(args.workload, args.seed, 3.0, False,
                              root=args.root, device="cpu",
                              mix_overrides=SMALL.get(args.workload))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
