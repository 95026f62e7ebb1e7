"""Command-line interface for batch pricing, Greeks, and benchmarks
(counterpart of `mcos_tpu/cli.py`). Usage:

    python -m mcos_tpu_torch.cli price --spot 22500 --strike 22500 --T 0.04
    python -m mcos_tpu_torch.cli greeks --spot 22500 --strike 22500 --T 0.04
    python -m mcos_tpu_torch.cli smile --spot 22500 --T 0.1
    python -m mcos_tpu_torch.cli rough --spot 22500 --T 0.25 --mode smile
    python -m mcos_tpu_torch.cli bench
    python -m mcos_tpu_torch.cli smoke

Every pricing command runs the port's engine on `--device` (default cuda;
`--device cpu` runs the kernels' plain versions on the host). `bench` runs
`mcos_tpu_torch.bench`, `smoke` the repo's `chip_smoke.py` (it needs a
CUDA card). All commands print JSON to stdout (one document), so output
pipes into jq.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def _add_contract_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--spot", type=float, required=True)
    p.add_argument("--strike", type=float, required=True)
    p.add_argument("--T", type=float, required=True)
    p.add_argument("--put", action="store_true", help="price a put")
    p.add_argument("--num-paths", type=int, default=500_000)
    p.add_argument("--num-steps", type=int, default=252)
    p.add_argument("--seed", type=int, default=42)
    _add_param_args(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to price on (default: cuda)")


def _add_param_args(p: argparse.ArgumentParser) -> None:
    for name, default in (("kappa", 3.0), ("theta", 0.04), ("xi", 0.5),
                          ("rho", -0.7), ("v0", 0.04), ("lambda-j", 1.0),
                          ("mu-j", -0.05), ("sigma-j", 0.10),
                          ("r", 0.065), ("q", 0.012)):
        p.add_argument(f"--{name}", type=float, default=default)
    _add_device_arg(p)


def _params_from(args) -> "SVJParams":
    from mcos_tpu_torch.models.params import SVJParams

    return SVJParams(kappa=args.kappa, theta=args.theta, xi=args.xi,
                     rho=args.rho, v0=args.v0, lambda_j=args.lambda_j,
                     mu_j=args.mu_j, sigma_j=args.sigma_j, r=args.r, q=args.q)


def cmd_price(args) -> dict:
    from mcos_tpu_torch.engine.pricer import MonteCarloEngine

    eng = MonteCarloEngine(_params_from(args), num_paths=args.num_paths,
                           num_steps=args.num_steps, seed=args.seed,
                           device=args.device)
    return eng.price(args.spot, args.strike, args.T, not args.put)


def cmd_greeks(args) -> dict:
    from mcos_tpu_torch.engine.greeks import GreeksEngine

    eng = GreeksEngine(_params_from(args), num_paths=args.num_paths,
                       num_steps=args.num_steps, seed=args.seed,
                       device=args.device)
    return eng.all_greeks(args.spot, args.strike, args.T, not args.put)


def cmd_smile(args) -> dict:
    from mcos_tpu_torch.engine.pricer import MonteCarloEngine
    from mcos_tpu_torch.engine.surface import implied_vol

    params = _params_from(args)
    eng = MonteCarloEngine(params, num_paths=args.num_paths, seed=args.seed,
                           device=args.device)
    strikes = np.linspace(args.spot * 0.7, args.spot * 1.3, args.points)
    rows = eng.price_batch(args.spot, strikes, args.T)
    for row in rows:
        iv = implied_vol(row["price"], args.spot, row["strike"], args.T,
                         float(params.r), float(params.q), True)
        row["iv"] = iv if iv is not None else 0.0
    return {"smile": rows}


def cmd_stress(args) -> dict:
    from mcos_tpu_torch.engine.risk import StressTestEngine

    eng = StressTestEngine(_params_from(args), num_paths=args.num_paths,
                           seed=args.seed, device=args.device)
    return eng.full_stress_report(args.spot, args.strike, args.T,
                                  not args.put)


def cmd_exotic(args) -> dict:
    from mcos_tpu_torch.engine.exotics import ExoticEngine

    eng = ExoticEngine(_params_from(args), num_paths=args.num_paths,
                       num_steps=args.num_steps, seed=args.seed,
                       device=args.device)
    if args.kind == "asian":
        return eng.price_asian(args.spot, args.strike, args.T, not args.put,
                               averaging=args.averaging)
    if args.kind == "barrier":
        return eng.price_barrier(args.spot, args.strike, args.T, args.barrier,
                                 not args.put, knock=args.knock)
    return eng.price_lookback(args.spot, args.T, not args.put,
                              strike=args.strike if args.fixed else None)


def cmd_american(args) -> dict:
    from mcos_tpu_torch.engine.american import AmericanEngine

    eng = AmericanEngine(_params_from(args), num_paths=args.num_paths,
                         num_steps=args.num_steps, seed=args.seed,
                         device=args.device)
    return eng.price(args.spot, args.strike, args.T, not args.put)


def cmd_calibrate(args) -> dict:
    from mcos_tpu_torch.engine.calibration import CalibrationEngine

    eng = CalibrationEngine(device=args.device)
    try:
        result = eng.calibrate_from_chain(
            args.chain, args.spot, args.T,
            is_call=not args.put,
            exercise="american" if args.american else "european",
            r=args.r, q=args.q, seed=args.seed)
    except ValueError as e:
        raise SystemExit(str(e))
    result["params"] = result["params"].as_dict()
    return result


def cmd_rough(args) -> dict:
    from mcos_tpu_torch.engine.rough import RoughBergomiEngine
    from mcos_tpu_torch.ops.rough import RoughBergomiParams

    p = RoughBergomiParams(xi=args.xi, eta=args.eta, rho=args.rho,
                           r=args.r, q=args.q, hurst=args.hurst)
    eng = RoughBergomiEngine(p, num_paths=args.num_paths,
                             num_steps=args.num_steps, seed=args.seed,
                             device=args.device)
    strike = args.strike or args.spot
    if args.mode == "price":
        return eng.price(args.spot, strike, args.T, not args.put)
    if args.mode == "greeks":
        return eng.greeks(args.spot, strike, args.T, not args.put)
    if args.mode == "smile":
        return eng.smile(args.spot, args.T)
    return eng.atm_skew(args.spot, args.T)


def cmd_exposure(args) -> dict:
    from mcos_tpu_torch.engine.exposure import ExposureEngine

    eng = ExposureEngine(
        [args.spot], [args.sigma], [[1.0]],
        [{"kind": "put" if args.put else "call",
          "strike": args.strike, "T": args.T}],
        r=args.r, q=[args.q], num_paths=args.num_paths, seed=args.seed,
        device=args.device)
    out = eng.profile(num_dates=args.num_dates)
    out["credit"] = eng.cva(hazard_rate=args.hazard, lgd=args.lgd,
                            num_dates=args.num_dates)
    return out


def cmd_bench(_args) -> dict:
    from mcos_tpu_torch import bench  # prints its own JSON line

    bench.main()
    return {}


def cmd_smoke(_args) -> dict:
    """The port's smoke run on a CUDA card: the repo's `chip_smoke.py` in a
    process of its own, from the repo root; its exit code is this
    command's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = subprocess.call([sys.executable, "chip_smoke.py"], cwd=root)
    if code != 0:
        sys.exit(code)
    return {}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mcos_tpu_torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("price", help="price a European option")
    _add_contract_args(p)
    p.set_defaults(fn=cmd_price)

    p = sub.add_parser("greeks", help="all Greeks (AD)")
    _add_contract_args(p)
    p.set_defaults(fn=cmd_greeks)

    p = sub.add_parser("smile", help="vol smile over a strike range")
    p.add_argument("--spot", type=float, required=True)
    p.add_argument("--T", type=float, required=True)
    p.add_argument("--num-paths", type=int, default=100_000)
    p.add_argument("--points", type=int, default=21)
    p.add_argument("--seed", type=int, default=42)
    _add_param_args(p)
    p.set_defaults(fn=cmd_smile)

    p = sub.add_parser("stress", help="stress-test ladders")
    _add_contract_args(p)
    p.set_defaults(fn=cmd_stress)

    p = sub.add_parser("exotic", help="Asian/barrier/lookback pricing")
    _add_contract_args(p)
    p.add_argument("--kind", choices=["asian", "barrier", "lookback"],
                   required=True)
    p.add_argument("--averaging", default="arithmetic",
                   choices=["arithmetic", "geometric"])
    p.add_argument("--barrier", type=float, default=0.0)
    p.add_argument("--knock", default="out", choices=["out", "in"])
    p.add_argument("--fixed", action="store_true",
                   help="fixed-strike lookback (default floating)")
    p.set_defaults(fn=cmd_exotic)

    p = sub.add_parser("american", help="Longstaff-Schwartz American pricing")
    _add_contract_args(p)
    p.set_defaults(fn=cmd_american)

    p = sub.add_parser("calibrate",
                       help="fast two-stage SVJ calibration from a chain CSV")
    p.add_argument("--chain", required=True, help="option-chain CSV path")
    p.add_argument("--spot", type=float, required=True)
    p.add_argument("--T", type=float, required=True)
    p.add_argument("--r", type=float, default=0.065)
    p.add_argument("--q", type=float, default=0.012)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--put", action="store_true",
                   help="calibrate the put side of the chain")
    p.add_argument("--american", action="store_true",
                   help="de-Americanize quotes through the CRR tree first "
                        "(NSE single-stock chains)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("rough", help="rough Bergomi price/greeks/smile/skew")
    p.add_argument("--spot", type=float, required=True)
    p.add_argument("--strike", type=float, default=0.0, help="0 = ATM")
    p.add_argument("--T", type=float, required=True)
    p.add_argument("--mode", default="price",
                   choices=["price", "greeks", "smile", "skew"])
    p.add_argument("--put", action="store_true")
    p.add_argument("--hurst", type=float, default=0.07)
    p.add_argument("--xi", type=float, default=0.04)
    p.add_argument("--eta", type=float, default=1.9)
    p.add_argument("--rho", type=float, default=-0.9)
    p.add_argument("--r", type=float, default=0.065)
    p.add_argument("--q", type=float, default=0.012)
    p.add_argument("--num-paths", type=int, default=131_072)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--seed", type=int, default=42)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_rough)

    p = sub.add_parser("exposure",
                       help="EE/PFE profile + CVA for one option position")
    p.add_argument("--spot", type=float, required=True)
    p.add_argument("--strike", type=float, required=True)
    p.add_argument("--T", type=float, required=True)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--put", action="store_true")
    p.add_argument("--hazard", type=float, default=0.02)
    p.add_argument("--lgd", type=float, default=0.6)
    p.add_argument("--num-dates", type=int, default=24)
    p.add_argument("--r", type=float, default=0.065)
    p.add_argument("--q", type=float, default=0.012)
    p.add_argument("--num-paths", type=int, default=65_536)
    p.add_argument("--seed", type=int, default=42)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_exposure)

    p = sub.add_parser("bench", help="headline throughput benchmark")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("smoke", help="the port's smoke run on a CUDA card")
    p.set_defaults(fn=cmd_smoke)

    args = parser.parse_args(argv)
    out = args.fn(args)
    if out:
        print(json.dumps(out, indent=2, default=float))


if __name__ == "__main__":
    main()
